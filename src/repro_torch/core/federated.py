"""The cross-pod federated round for the LLM architectures.

The reference's ``repro.core.federated``: the paper's FL mapped onto LLM
training, each **pod one FL silo**.  A round

  1. trains every pod E local optimizer steps on its own data — the state
     carries a leading ``pod`` dimension, and the pods are independent by
     construction;
  2. syncs the round's parameter deltas across pods: FedAvg, a mean over
     the pod dimension (``skip_nonfinite``: over the pods whose delta is
     finite everywhere);
  3. optionally compresses the synced delta (STC ternary or int8, with
     error feedback carried in the round state), the paper's compression
     stage on the inter-pod hop; or, under ``int8_sync``, quantizes each
     pod's delta to int8 with a per-pod residual before the mean.

On one card (the reference's ``vmap(..., spmd_axis_name="pod")`` has no
mesh to map onto) the pods train one after another in a Python loop, each
on its own slice of the pod-stacked state, which computes the same
function without P sets of activations at once.  The sync then runs leaf
by leaf — delta, mean, EF-corrected compression through
``core/compression.compress`` / ``decompress`` (STC on the STC kernel as
one ``(1, n)`` row a leaf, int8 on the row-max and round-trip kernels),
apply — so it holds at most one leaf's temporaries beyond the state.  To
fit a full-width model on one card the round **updates the pod-stacked
params, optimizer state and residual in place** and returns them in the
new :class:`FedState`.  ``int8_sync`` takes the reference's one-device
route (a per-pod scale, the residual carried per pod, no kernel), and the
pod mean is a plain ``mean``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import compression as comp
from repro_torch.models.kvcache import spec
from repro_torch.models.model import Model, TrainState, make_train_step
from repro_torch.optim import Optimizer
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FedRoundConfig:
    local_steps: int = 4            # E: local steps per pod per round
    # none | stc | int8           : paper-style compression of the aggregated
    #                               delta (models the WAN message size)
    # int8_sync                   : per-pod int8 quantization with error
    #                               feedback before the mean
    compression: str = "none"
    stc_sparsity: float = 0.01
    server_lr: float = 1.0
    # zero-weight pods whose round delta contains NaN/Inf during the
    # cross-pod sync (survivors-only FedAvg at pod granularity, mirroring
    # the simulation engines' update guard)
    skip_nonfinite: bool = False


@dataclasses.dataclass(frozen=True)
class FedState:
    """Round-carried state: per-pod train state + error-feedback residual."""
    train: TrainState                # leaves have a leading pod dim
    residual: Any                    # same structure as params (or ())


def _replicate(tree, num_pods: int):
    return tree_map(lambda x: x.unsqueeze(0).expand(
        (num_pods,) + tuple(x.shape)).clone(), tree)


def replicate_for_pods(state: TrainState, num_pods: int) -> TrainState:
    """Give every leaf a leading pod dimension (initially identical
    copies)."""
    return TrainState(_replicate(state.params, num_pods),
                      _replicate(state.opt_state, num_pods),
                      _replicate(state.step, num_pods))


def init_fed_state(state: TrainState, num_pods: int,
                   fed_cfg: FedRoundConfig) -> FedState:
    pod_state = replicate_for_pods(state, num_pods)
    residual = ()
    if fed_cfg.compression == "int8_sync":
        # per-pod error feedback: residual carries a pod dimension
        residual = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                            pod_state.params)
    elif fed_cfg.compression != "none":
        residual = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                            state.params)
    return FedState(pod_state, residual)


def _pod_ok(deltas) -> torch.Tensor:
    """(P,) bool: the pods whose every leaf of ``deltas`` is finite."""
    ok = None
    for d in deltas:
        leaf_ok = torch.isfinite(d.reshape(d.shape[0], -1)).all(dim=1)
        ok = leaf_ok if ok is None else ok & leaf_ok
    return ok


def _masked_mean(d, w, denom):
    """Mean of ``d`` over the pods with weight 1 in ``w``; bad rows are
    zeroed with ``where`` because ``0 * nan == nan``."""
    wr = w.reshape((-1,) + (1,) * (d.dim() - 1))
    return torch.where(wr > 0, d, 0.0).sum(dim=0) / denom


def finite_pod_mean(delta: Any) -> Any:
    """Mean over the leading pod axis, zero-weighting non-finite pods.

    A pod is invalid when ANY leaf of its round delta contains NaN/Inf;
    the mean then covers the surviving pods only, and when no pod survives
    it is a zero delta (params unchanged)."""
    leaves, treedef = tree_flatten(delta)
    w = _pod_ok(leaves).to(torch.float32)
    denom = torch.clamp_min(w.sum(), 1.0)
    return tree_unflatten(treedef, [_masked_mean(d, w, denom)
                                    for d in leaves])


def _int8_sync_leaf(d, r):
    """One leaf of the reference's one-device int8 pod sync: a per-pod
    scale, the pods' dequantized values averaged -> (agg (P, ...), the new
    per-pod residual)."""
    corrected = d + r
    dims = tuple(range(1, d.dim()))
    amax = (torch.amax(corrected.abs(), dim=dims, keepdim=True) if dims
            else corrected.abs())
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127)
    deq = q * scale
    agg = deq.mean(dim=0, keepdim=True).expand(d.shape)
    return agg, corrected - deq


def sync_leaf(fed_cfg: FedRoundConfig, delta, residual, w=None,
              denom=None):
    """One leaf of the cross-pod sync: the pods' f32 round delta (P, ...)
    and the leaf's residual -> (the aggregated delta, broadcastable to
    (P, ...), the new residual or None).  ``w``/``denom``: the
    ``skip_nonfinite`` pod weights and their clamped sum."""
    method = fed_cfg.compression
    if method == "int8_sync":
        return _int8_sync_leaf(delta, residual)
    agg = (delta.mean(dim=0) if w is None
           else _masked_mean(delta, w, denom))
    del delta
    if method == "none":
        return agg[None], None
    # mean over pods first: the compression operates on the aggregated
    # delta the server re-distributes (server-side STC / int8)
    corrected = agg + residual
    del agg
    sent = comp.decompress(comp.compress(corrected, method,
                                         fed_cfg.stc_sparsity))
    return sent[None], corrected - sent


def make_fed_round_step(model: Model, optimizer: Optimizer,
                        fed_cfg: FedRoundConfig, num_pods: int,
                        remat: bool = True):
    """Build the federated round ``(fed, batch) -> (fed, metrics)``.

    batch: {"tokens": (P, E, B_local, S), ...} — P pods x E local steps.
    metrics: ``loss`` (the mean local loss) and ``local_losses`` (E,), the
    pods' mean a local step.  The reference's ``params_pspec`` (shardings
    over a mesh) has no counterpart on one card."""
    if fed_cfg.compression not in ("none", "stc", "int8", "int8_sync"):
        raise ValueError(f"unknown compression {fed_cfg.compression!r}")
    step_fn = make_train_step(model, optimizer, remat=remat)

    def local_steps(fed: FedState, batch, p_leaves, o_leaves, p_def, o_def):
        """Pod after pod, E steps each; every step's new params and
        optimizer state are written back into the pod's slice -> (P, E)
        losses."""
        P, E = num_pods, fed_cfg.local_steps
        losses = []
        for p in range(P):
            for e in range(E):
                st = TrainState(tree_unflatten(p_def, [t[p] for t in p_leaves]),
                                tree_unflatten(o_def, [t[p] for t in o_leaves]),
                                fed.train.step[p])
                micro = {k: v[p, e] for k, v in batch.items()}
                st, metrics = step_fn(st, micro)
                with torch.no_grad():
                    for slot, new in zip(p_leaves, tree_flatten(st.params)[0]):
                        slot[p].copy_(new)
                    for slot, new in zip(o_leaves,
                                         tree_flatten(st.opt_state)[0]):
                        slot[p].copy_(new)
                    fed.train.step[p].copy_(st.step)
                del st
                losses.append(metrics["loss"])
        return torch.stack(losses).view(P, E)

    @torch.no_grad()
    def sync(p_leaves, start, residual):
        """The cross-pod sync, leaf by leaf, in place."""
        r_leaves = tree_flatten(residual)[0] or [None] * len(p_leaves)
        w = denom = None
        if fed_cfg.skip_nonfinite and fed_cfg.compression != "int8_sync":
            w = _pod_ok(cur.to(torch.float32) - s0.to(torch.float32)
                        for cur, s0 in zip(p_leaves, start)).to(torch.float32)
            denom = torch.clamp_min(w.sum(), 1.0)
        for cur, s0, r in zip(p_leaves, start, r_leaves):
            agg, new_r = sync_leaf(
                fed_cfg, cur.to(torch.float32) - s0.to(torch.float32), r, w,
                denom)
            if new_r is not None:
                r.copy_(new_r)
                del new_r
            cur.copy_((s0.to(torch.float32)
                       + fed_cfg.server_lr * agg).to(s0.dtype))
            del agg

    def fed_round(fed: FedState, batch) -> Tuple[FedState, Dict]:
        p_leaves, p_def = tree_flatten(fed.train.params)
        o_leaves, o_def = tree_flatten(fed.train.opt_state)
        with torch.no_grad():
            start = [t.clone() for t in p_leaves]          # (P, ...)
        # 1) independent local training per pod
        losses = local_steps(fed, batch, p_leaves, o_leaves, p_def, o_def)
        # 2)-3) the cross-pod sync, then FedAvg: every pod applies the
        # same aggregated delta to its own start params
        sync(p_leaves, start, fed.residual)
        del start
        metrics = {"loss": losses.mean(), "local_losses": losses.mean(dim=0)}
        return FedState(fed.train, fed.residual), metrics

    return fed_round


def fed_input_specs(model: Model, shape, num_pods: int,
                    fed_cfg: FedRoundConfig):
    """Meta-tensor batch for the federated round from a global
    ``InputShape``: the global batch is split as (P, E, B/(P*E), S)."""
    specs = model.input_specs(shape)
    E = fed_cfg.local_steps
    local_b = max(shape.global_batch // (num_pods * E), 1)
    return tree_map(lambda s: spec((num_pods, E, local_b)
                                   + tuple(s.shape[1:]), s.dtype), specs)
