"""Local training, shared by the engines.

:func:`client_grads` is one client's loss, FedProx term and gradient
clipping — the same code for the batched engine (per-client scalars under
``vmap``) and the sequential engine (:func:`make_client_step`,
:func:`local_train`).  ``cyclic_batches`` is the reference's batch
schedule, copied verbatim (a numpy ``RandomState`` permutation per epoch),
so the port draws the same batches bit for bit.  ``local_train`` and
``evaluate`` keep their per-batch metrics on the device and fetch them in
one device-to-host transfer at the end.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.small import FLModel
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_map


def client_grads(model: FLModel, params, xb, yb, global_params, mu,
                 max_norm, use_prox: bool, use_clip: bool):
    """One client's gradient of its loss on a batch, with the FedProx term
    ``mu/2 ||w - w_global||^2`` (``use_prox``) and global-norm clipping to
    ``max_norm`` where ``max_norm > 0`` (``use_clip``).  ``mu`` and
    ``max_norm`` are f32 tensors: 0-d, or per-client scalars under
    ``vmap``.  -> (grads, loss, accuracy)."""
    def loss_fn(p):
        loss, metrics = model.loss_and_metrics(p, {"x": xb, "y": yb})
        if use_prox:
            prox = sum(
                torch.sum(torch.square(a.to(torch.float32)
                                       - g.to(torch.float32)))
                for a, g in zip(tree_leaves(p), tree_leaves(global_params)))
            loss = loss + 0.5 * mu * prox
        return loss, (loss, metrics["accuracy"])

    grads, (loss, acc) = torch.func.grad(loss_fn, has_aux=True)(params)
    if use_clip:
        clipped, _ = clip_by_global_norm(grads, max_norm)
        grads = tree_map(lambda c, g: torch.where(max_norm > 0.0, c, g),
                         clipped, grads)
    return grads, loss, acc


@lru_cache(maxsize=64)
def make_client_step(model: FLModel, optimizer: Optimizer,
                     proximal_mu: float = 0.0, max_grad_norm: float = 0.0):
    """(params, opt_state, batch, global_params) -> (params, opt_state,
    metrics), one eager step of the sequential engine."""
    consts: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(params, opt_state, batch, global_params):
        x = batch["x"]
        if x.device not in consts:     # fills on the device, no host sync
            consts[x.device] = tuple(
                torch.full((), v, dtype=torch.float32, device=x.device)
                for v in (proximal_mu, max_grad_norm))
        mu, max_norm = consts[x.device]
        grads, loss, acc = client_grads(
            model, params, x, batch["y"], global_params, mu, max_norm,
            proximal_mu > 0.0, max_grad_norm > 0.0)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (apply_updates(params, updates), opt_state,
                {"loss": loss, "accuracy": acc})

    return step


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


def local_train(model: FLModel, params, data_x, data_y, *,  # flcheck: hot
                epochs: int, batch_size: int, optimizer: Optimizer,
                proximal_mu: float = 0.0, max_grad_norm: float = 0.0,
                seed: int = 0, global_params=None):
    """Run E local epochs on the parameters' device; returns (new_params,
    mean metrics).  The client's data and the whole batch schedule upload
    once; per-batch metrics stay on the device and come back in one
    transfer after every step is enqueued."""
    step = make_client_step(model, optimizer, proximal_mu, max_grad_norm)
    opt_state = optimizer.init(params)
    gp = global_params if global_params is not None else params
    device = tree_leaves(params)[0].device
    x = torch.as_tensor(data_x, device=device)
    y = torch.as_tensor(data_y, device=device)
    idx = torch.as_tensor(np.concatenate(
        [cyclic_batches(len(data_x), batch_size, seed + e)
         for e in range(epochs)]).astype(np.int64), device=device)
    losses, accs = [], []
    for bidx in idx:
        params, opt_state, metrics = step(
            params, opt_state, {"x": x[bidx], "y": y[bidx]}, gp)
        losses.append(metrics["loss"])
        accs.append(metrics["accuracy"])
    fetched = torch.stack(losses + accs).cpu().numpy()  # flcheck: ignore[FLC101]  -- single end-of-loop fetch
    n = len(losses)
    return params, {"loss": float(np.mean(fetched[:n])),
                    "accuracy": float(np.nanmean(fetched[n:])),
                    "batches": float(len(losses))}


@torch.no_grad()
def evaluate(model: FLModel, params, data_x, data_y,  # flcheck: hot
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
    fetched = torch.stack(losses + accs).cpu().numpy()  # flcheck: ignore[FLC101]  -- single end-of-loop fetch
    w = np.asarray(weights, dtype=np.float64)
    n = len(losses)
    return {"loss": float(np.average(fetched[:n], weights=w)),
            "accuracy": float(np.average(fetched[n:], weights=w))}
