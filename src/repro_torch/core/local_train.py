"""Local-training helpers shared by the engines.

``cyclic_batches`` is the reference's batch schedule, copied verbatim (a
numpy ``RandomState`` permutation per epoch), so the port draws the same
batches bit for bit.  ``evaluate`` runs full-dataset evaluation on the
parameters' device with one device-to-host transfer at the end.  The
per-client sequential training loop is ROADMAP M4.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.small import FLModel
from repro_torch.utils.tree import tree_leaves


def cyclic_batches(n: int, batch_size: int, seed: int):
    """Full-shape batch index arrays covering all n samples (last batch wraps)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    n_batches = max(1, -(-n // batch_size))
    padded = np.concatenate([idx, idx[: (-len(idx)) % batch_size or 0]])
    if len(padded) < n_batches * batch_size:   # n < batch_size: cycle
        reps = -(-n_batches * batch_size // n)
        padded = np.tile(idx, reps)[: n_batches * batch_size]
    return padded.reshape(n_batches, batch_size)


@torch.no_grad()
def evaluate(model: FLModel, params, data_x, data_y,
             batch_size: int = 256) -> Dict[str, float]:
    """Sample-weighted full-dataset eval.  ``data_x``/``data_y`` may be
    numpy arrays or tensors; they are moved to the parameters' device.
    The last partial batch is padded with copies of its first sample (as
    in the reference) and weighted by its true size."""
    device = tree_leaves(params)[0].device
    x = torch.as_tensor(data_x, device=device)
    y = torch.as_tensor(data_y, device=device)
    losses, accs, weights = [], [], []
    for s in range(0, len(x), batch_size):
        xb, yb = x[s: s + batch_size], y[s: s + batch_size]
        if len(xb) < batch_size:  # pad to the full batch, weight by true size
            pad = batch_size - len(xb)
            xb = torch.cat([xb, xb[:1].expand((pad,) + xb.shape[1:])])
            yb = torch.cat([yb, yb[:1].expand((pad,) + yb.shape[1:])])
        _, m = model.loss_and_metrics(params, {"x": xb, "y": yb})
        losses.append(m["loss"])
        accs.append(m["accuracy"])
        weights.append(min(batch_size, len(x) - s))
    # one transfer for the whole evaluation, after every batch is enqueued
    fetched = torch.stack(losses + accs).cpu().numpy()
    w = np.asarray(weights, dtype=np.float64)
    n = len(losses)
    return {"loss": float(np.average(fetched[:n], weights=w)),
            "accuracy": float(np.average(fetched[n:], weights=w))}
