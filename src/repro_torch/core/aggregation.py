"""Aggregation stage (paper Fig. 3, server side).

FedAvg [McMahan et al., AISTATS'17]: sample-count-weighted average of client
updates applied to the global model.  The heavy inner loop — a weighted sum
over N client update vectors — has a hand-written CUDA kernel
(``repro_torch.kernels.fedavg_agg``); ``use_kernel`` switches it in, the
``torch.einsum`` path computes the same sum.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any


def fedavg_weights(num_samples: Sequence[int]) -> np.ndarray:
    w = np.asarray(num_samples, dtype=np.float64)
    return (w / w.sum()).astype(np.float32)


def weighted_train_loss(results: List[Dict]) -> float:
    """num_samples-weighted cohort loss — FedAvg semantics (an unweighted
    mean over-counts tiny clients under unbalanced cohorts)."""
    counts = np.asarray([r.get("num_samples", 1) for r in results],
                        np.float64)
    losses = np.asarray([r["metrics"]["loss"] for r in results], np.float64)
    if counts.sum() <= 0:
        return float(np.mean(losses))
    return float(losses @ (counts / counts.sum()))


def weighted_average(updates: List[PyTree], weights: np.ndarray,
                     use_kernel: bool = False, topology: str = "flat",
                     fanout: int = 0) -> PyTree:
    """Weighted mean over a list of trees of equal structure.

    ``topology="hierarchical"`` reduces the stacked (N, D) matrix through
    the edge -> region -> global tree
    (``kernels.fedavg_agg.fedavg_aggregate_tree``, grouped K1 launches
    under ``use_kernel``) with ``fanout`` children per node — bit-equal to
    flat when ``fanout >= len(updates)``."""
    leaves0, treedef = tree_flatten(updates[0])
    device = leaves0[0].device
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    if use_kernel or topology == "hierarchical":
        from repro_torch.kernels import ops as kops
        flat = torch.stack([
            torch.cat([leaf.reshape(-1).to(torch.float32)
                       for leaf in tree_flatten(u)[0]]) for u in updates])
        if topology == "hierarchical":
            delta = kops.fedavg_aggregate_tree(flat, w, fanout=fanout,
                                               use_kernel=use_kernel)
        else:
            delta = kops.fedavg_aggregate(flat, w)
        out, off = [], 0
        for leaf in leaves0:
            out.append(delta[off: off + leaf.numel()].reshape(leaf.shape))
            off += leaf.numel()
        return tree_unflatten(treedef, out)

    def avg(*leaves):
        stacked = torch.stack([leaf.to(torch.float32) for leaf in leaves])
        return torch.einsum("n,n...->...", w, stacked)

    return tree_map(avg, *updates)


def staleness_weighted_delta(updates: List[PyTree],
                             num_samples: Sequence[int],
                             staleness: Sequence[float],
                             power: float = 0.5,
                             use_kernel: bool = False,
                             topology: str = "flat",
                             fanout: int = 0) -> PyTree:
    """FedBuff aggregate (Nguyen et al., AISTATS'22): the sample-weighted
    mean with each update discounted by ``1/(1+s)^power``, ``staleness[i]``
    the server aggregations between update i's dispatch and now.  The
    discount only transforms the weights
    (``kernels.fedavg_agg.fold_staleness``), so K1, the tree and the einsum
    run unchanged."""
    from repro_torch.kernels.fedavg_agg import fold_staleness
    w = fold_staleness(torch.as_tensor(fedavg_weights(num_samples)),
                       torch.as_tensor(np.asarray(staleness, np.float32)),
                       power).numpy()
    return weighted_average(updates, w, use_kernel=use_kernel,
                            topology=topology, fanout=fanout)


def apply_delta(global_params: PyTree, delta: PyTree,
                server_lr: float = 1.0) -> PyTree:
    """Apply an aggregated update delta to the global params."""
    return tree_map(
        lambda p, d: (p.to(torch.float32) + server_lr * d).to(p.dtype),
        global_params, delta)


def fedavg(global_params: PyTree, updates: List[PyTree],
           num_samples: Sequence[int], use_kernel: bool = False,
           server_lr: float = 1.0, topology: str = "flat",
           fanout: int = 0) -> PyTree:
    """Apply the weighted-average *update* (delta) to the global params."""
    delta = weighted_average(updates, fedavg_weights(num_samples), use_kernel,
                             topology=topology, fanout=fanout)
    return apply_delta(global_params, delta, server_lr)


AGGREGATORS = {"fedavg": fedavg}


def get_aggregator(name: str):
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}")
    return AGGREGATORS[name]
