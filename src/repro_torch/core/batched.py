"""Batched client execution engine: the whole cohort in one round program.

The selected clients' params, optimizer states and cyclic-batch indices are
stacked along a leading client dimension and all E local epochs of the
cohort run together: ``torch.func.vmap`` over clients of one ``grad`` step,
inside a Python loop over the bucketed local steps — the PyTorch form of
the reference's ``jax.vmap`` around ``jax.lax.scan``.

:func:`make_round_program` fuses the rest of the round behind that
training: per-leaf error-feedback (EF) correction, in-program STC or int8
compression with the EF residual update (hand-written CUDA kernels,
``repro_torch.kernels``), the flat (N_b, D) update matrix, under faults
the survival mask and the NaN/norm guard (:func:`_fault_block`), FedAvg (the
streaming CUDA kernel with ``resources.aggregation_kernel``, else
``torch.einsum``; the hierarchical tree of grouped K1 launches under
``resources.aggregation_topology="hierarchical"``) and the server apply
``p + server_lr * delta``.  :meth:`BatchedExecutor.run_round_fused`
dispatches it and performs the round's ONE device-to-host transfer (loss,
accuracy and every per-leaf STC count, stacked together) — at once, or
later through a ``fetch`` closure (``tracking.round_sync=False``).  The
program runs eagerly; CUDA-graph capture per bucket is ROADMAP M5.3.

The staged path (``round_fusion="off"``, or a round the fused program
cannot take) runs the same arithmetic in three stages —
:meth:`~BatchedExecutor.run_cohort_stacked`,
:meth:`~BatchedExecutor.compress_stacked`,
:meth:`~BatchedExecutor.aggregate_stacked` — through the helpers the fused
program uses, so the two agree bit for bit.  The gathering path
(:meth:`~BatchedExecutor.run_cohort`) hands back per-client
``Client.train``-shaped results for the clients' own post-train stages.

``resources.distributed = "data"`` (the sharded cohort) splits the cohort
dimension over a 1-D client mesh (:func:`build_client_mesh`: one shard
for each entry of ``repro_torch.get_devices()``, the counterpart of the
reference's mesh over ``jax.devices()``; a device may repeat).  The whole
round stays in one process: each shard's N_b / k rows train on its device
with their own copy of the global params, compress there (the sharded K2
/ K3 routes) and pass the fault block's row checks there, and FedAvg is
the sharded K1 route (each shard reduces its own rows; the partials are
summed in shard order), whatever ``aggregation_kernel`` says, as in the
reference.  The bucket is at least the mesh size.  What moves between
devices each round, where a shard's device is not the first one: to the
shard, its rows of the gathered cohort data (the data pool and its
gather stay on the first device; the reference re-shards the gathered
cohort the same way), its batch indices, step counts and optimizer
vectors, a copy of the global params and its clients' EF residual rows;
back to the first device, the new residual rows, the (D,) K1 partial and
the shard's (N_b / k,) loss, accuracy, nnz and guard verdicts.  Update
rows never cross.  Shards that repeat the first device copy nothing.

Under ``client.finetune = "lora"`` the model is the LoRA wrapper
(``repro_torch.models.lora``): the stacked leaves are the adapter factors
only, and the frozen base is closed over by the wrapper's ``apply`` — one
set of tensors on the device, read by every vmapped client and never
copied per client.  Nothing below knows about LoRA.  Sequence models feed
int32 token rows through the same data pool; with the flash flag on, the
attention of the whole cohort goes to the flash kernels in one launch per
layer and pass (their vmap rule folds the client dimension into BH).

Shape discipline: cohort size N, per-client step count S and per-client
sample count are each padded up to power-of-two buckets.  Padded clients
run 0 active steps (their update is exactly 0, their weight 0); padded
steps are masked with ``torch.where`` so params and optimizer state stay
frozen once ``step >= n_steps[client]``.

Per-client FedProx ``mu``, the grad-clip threshold and the optimizer
hyperparameters ride along as (N_b,) vectors in one :class:`CohortVectors`
struct, mapped to per-client scalars by ``vmap``.  Only mixed optimizer
*families* cannot share one program and raise, naming the clients.

The cohort's data comes from a device-resident per-client pool
(:class:`repro_torch.core.tiered_store.TieredRowStore`, ``spill="drop"``);
the EF residuals live in a second store (``spill="host"``) whose hot rows
the round program reads and updates in place.
"""
from __future__ import annotations

import time
import warnings
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.local_train import client_grads, cyclic_batches
from repro_torch.kernels.mesh import ClientMesh, current, gather_rows
from repro_torch.models.small import FLModel
from repro_torch.optim import (
    Optimizer, TracedOptimizer, adamw_traced, apply_updates,
    hparams_from_config, sgd_traced,
)
from repro_torch.utils.tree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

PyTree = Any


class CohortVectors(NamedTuple):
    """All per-client (N_bucket,) vectors of the cohort program: the
    FedProx proximal coefficient, the grad-clip threshold, and the
    optimizer hyperparameter struct (``SGDHParams`` / ``AdamWHParams`` of
    (N_bucket,) vectors — or ``()`` when the cohort shares one hand-built
    uniform :class:`Optimizer` instance)."""

    mu: Any
    max_norm: Any
    hp: Any


_round_builds = 0
_dispatches = 0
_host_syncs = 0


def round_trace_count() -> int:
    """How many round programs (:func:`make_round_program`) this process
    has built — the eager analogue of the reference's trace count: one per
    distinct (model, optimizer, bucket, method, ...) key, flat across
    rounds at fixed bucket shapes."""
    return _round_builds


def dispatch_count() -> int:
    """Executor-level program dispatches this process: each stage handed to
    the device — 1 per fused round; on the staged path cohort training,
    compression and aggregation one each, as the reference counts them."""
    return _dispatches


def host_sync_count() -> int:
    """Device->host synchronization points of the round pipeline this
    process: 1 per fused round (its single batched fetch); on the staged
    path the cohort's metric fetch, plus one for the STC counts."""
    return _host_syncs


def _note_dispatch(n: int = 1) -> None:
    global _dispatches
    _dispatches += n


def _note_host_sync(n: int = 1) -> None:
    global _host_syncs
    _host_syncs += n


@lru_cache(maxsize=32)
def _wrap_uniform(optimizer: Optimizer) -> TracedOptimizer:
    """Adapt a hand-built, cohort-uniform closure :class:`Optimizer` to the
    traced interface (hyperparam struct ignored — it is ``()``)."""
    return TracedOptimizer(
        init=lambda p, hp: optimizer.init(p),
        update=lambda g, s, p, hp: optimizer.update(g, s, p),
        name=f"uniform({optimizer.name})")


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


def _per_client(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View an (N_b,) vector so it broadcasts over ``like``'s trailing dims."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _one_client_fn(model: FLModel, optimizer: TracedOptimizer, steps: int,
                   use_prox: bool, use_clip: bool):
    """The cohort's local training: ``vmap`` over clients of one grad step,
    a loop over ``steps`` bucketed steps, padded steps masked.

    Returns ``cohort(params, x, y, idx, n_steps, vec, global_params) ->
    (updates, loss_mean, acc_mean)``, every argument and result stacked
    along the client dimension except ``global_params``.  The batch of
    step ``s`` is gathered with the client dimension explicit
    (``x[client, idx[client, s]]``) outside ``vmap``."""

    def client_step(params, opt_state, xb, yb, vec, global_params):
        grads, loss, acc = client_grads(model, params, xb, yb, global_params,
                                        vec.mu, vec.max_norm, use_prox,
                                        use_clip)
        updates, new_opt = optimizer.update(grads, opt_state, params, vec.hp)
        return apply_updates(params, updates), new_opt, loss, acc

    step_all = torch.func.vmap(client_step, in_dims=(0, 0, 0, 0, 0, None))
    init_all = torch.func.vmap(optimizer.init)

    def cohort(params, x, y, idx, n_steps, vec, global_params):
        nb = x.shape[0]
        rows = torch.arange(nb, device=x.device)[:, None]
        opt_state = init_all(params, vec.hp)
        loss_sum = torch.zeros((nb,), dtype=torch.float32, device=x.device)
        acc_sum = torch.zeros_like(loss_sum)
        for s in range(steps):
            bidx = idx[:, s]                        # (N_b, B)
            new_p, new_opt, loss, acc = step_all(
                params, opt_state, x[rows, bidx], y[rows, bidx], vec,
                global_params)
            active = s < n_steps                    # padded steps: frozen
            params = tree_map(
                lambda nw, od: torch.where(_per_client(active, nw), nw, od),
                new_p, params)
            opt_state = tree_map(
                lambda nw, od: torch.where(_per_client(active, nw), nw, od),
                new_opt, opt_state)
            af = active.to(torch.float32)
            loss_sum = loss_sum + af * loss
            acc_sum = acc_sum + af * acc
        updates = tree_map(
            lambda n, g: n.to(torch.float32) - g.to(torch.float32),
            params, global_params)
        denom = torch.clamp_min(n_steps.to(torch.float32), 1.0)
        return updates, loss_sum / denom, acc_sum / denom

    return cohort


def _row_blocks(mesh, nb: int, device) -> List[Tuple[int, int, Any]]:
    """``(lo, hi, device)`` of each shard's cohort rows: one block on
    ``device`` without a mesh, else N_b / k rows a shard on its device."""
    if mesh is None:
        return [(0, nb, device)]
    r = nb // mesh.size
    return [(s * r, (s + 1) * r, d) for s, d in enumerate(mesh.devices)]


def _train_blocks(cohort, blocks, global_params, x, y, idx, n_steps, vec):
    """Cohort training, one call of ``cohort`` a row block on the block's
    device, each with its own copy of the global params (the block's rows
    of the cohort data, indices and vectors are copied there when its
    device is not theirs).  -> one ``(updates, loss, acc)`` a block."""
    out = []
    for lo, hi, dev in blocks:
        def take(t, lo=lo, hi=hi, dev=dev):
            return t[lo:hi].to(dev)
        with current(dev):
            gp = tree_map(lambda p, dev=dev: p.to(dev), global_params)
            stacked = tree_map(
                lambda p, n=hi - lo: p.unsqueeze(0).expand(
                    (n,) + tuple(p.shape)), gp)
            out.append(cohort(stacked, take(x), take(y), take(idx),
                              take(n_steps), tree_map(take, vec), gp))
    return out


def _compress_rows(corrected: List[torch.Tensor], method: str,
                   stc_sparsity: float, mesh=None):
    """One error-corrected leaf as row blocks (one block, or one a shard
    under ``mesh``) -> (sent blocks, STC counts per block or None): K2, or
    K3a + K3b, through the sharded route under ``mesh``.  Leaves under
    ``DENSE_MIN_ELEMS`` elements stay dense."""
    from repro_torch.core.compression import DENSE_MIN_ELEMS
    from repro_torch.kernels import ops as kops

    if corrected[0].shape[1] < DENSE_MIN_ELEMS:
        return corrected, None
    x = corrected if mesh is not None else corrected[0]
    if method == "stc":
        sent, nnz = kops.stc_compress_batched(x, stc_sparsity, mesh=mesh)
    else:
        sent, nnz = kops.int8_roundtrip_batched(x, mesh=mesh)[0], None
    if mesh is None:
        return [sent], None if nnz is None else [nnz]
    return sent, nnz


def _error_feedback(flats: List[torch.Tensor], res: torch.Tensor,
                    method: str, stc_sparsity: float, mesh=None):
    """One leaf's compression stage with error feedback over row blocks:
    ``flats`` the blocks' (r, size) f32 update rows, ``res`` the (N, size)
    stored residuals of the N real clients (the rows past N — bucket
    padding, always the last — correct by 0).  Each block corrects and
    compresses on its own device.  -> (sent blocks, the (N_b,) STC counts
    or None, the (N, size) new residuals ``corrected - sent`` on
    ``res``'s device)."""
    n = res.shape[0]
    corrected, real, lo = [], [], 0
    for f in flats:
        r = f.shape[0]
        m = min(max(n - lo, 0), r)
        blk = F.pad(res[lo:lo + m], (0, 0, 0, r - m)).to(f.device)
        corrected.append((f + blk).contiguous())
        real.append(m)
        lo += r
    sent, nnz = _compress_rows(corrected, method, stc_sparsity, mesh)
    new = [(c - s)[:m].to(res.device) for c, s, m in zip(corrected, sent,
                                                         real)]
    return (sent, None if nnz is None else gather_rows(nnz),
            new[0] if len(new) == 1 else torch.cat(new))


def _per_block(t: torch.Tensor, flats: List[torch.Tensor]):
    """``t``'s rows cut like the row blocks ``flats``, each on its block's
    device."""
    out, lo = [], 0
    for f in flats:
        out.append(t[lo:lo + f.shape[0]].to(f.device))
        lo += f.shape[0]
    return out


def _fault_block(flats: List[torch.Tensor], weights: torch.Tensor,
                 mask: Optional[torch.Tensor], guard: bool,
                 max_update_norm: float):
    """The fault block ahead of FedAvg, in the reference's op order, over
    the update matrix's row blocks: zero-weight the failed clients
    (``mask``), reject rows that are not finite or whose L2 norm exceeds
    ``max_update_norm`` (> 0; f32 ``sqrt(sum(square))``) when ``guard`` —
    each block on its own device —, zero the rejected rows in the data too
    (0 x NaN is NaN) and renormalize the survivors' weights; the rows stay
    on their devices and only the (N_b,) verdicts are gathered onto the
    weights' device.  A round in which every
    client failed applies a zero delta.
    -> (row blocks, weights, (N_b,) verdict or None)."""
    wj = weights if mask is None else weights * mask
    ok = None
    if guard:
        oks = []
        for i, flat in enumerate(flats):
            okb = torch.isfinite(flat).all(dim=1)
            if max_update_norm > 0:
                norms = torch.sqrt(torch.sum(torch.square(flat), dim=1))
                okb = okb & (norms <= max_update_norm)
            flats[i] = torch.where(okb[:, None], flat, 0.0)
            oks.append(okb)
        ok = gather_rows(oks, weights.device)
        wj = wj * ok.to(torch.float32)
    wsum = torch.sum(wj)
    return flats, torch.where(wsum > 0, wj / wsum, 0.0), ok


def _aggregate(flats: List[torch.Tensor], weights: torch.Tensor,
               use_kernel: bool, topology: str, fanout: int,
               mesh=None) -> torch.Tensor:
    """FedAvg of the (N_b, D) update matrix's row blocks.  Under ``mesh``
    always the sharded K1 route — each shard's partial, flat or (under
    ``hierarchical``) a tree of fanout ``fanout or ceil(sqrt(N_b))``, then
    their sum — whatever ``use_kernel`` says, as the reference; else the
    tree of grouped K1 launches (``hierarchical``), K1 (``use_kernel``) or
    one einsum."""
    from repro_torch.kernels import ops as kops

    if mesh is not None:
        nb = sum(f.shape[0] for f in flats)
        return kops.fedavg_aggregate_sharded(
            flats, weights, mesh,
            fanout=(fanout or int(np.ceil(np.sqrt(nb))))
            if topology == "hierarchical" else 0)
    (flat,) = flats
    if topology == "hierarchical":
        return kops.fedavg_aggregate_tree(flat, weights, fanout=fanout,
                                          use_kernel=use_kernel)
    if use_kernel:
        return kops.fedavg_aggregate(flat, weights)
    return torch.einsum("n,nd->d", weights, flat)


def _unflatten_delta(delta: torch.Tensor, leaves, treedef) -> PyTree:
    """Cut the (D,) delta into the stacked leaves' per-client shapes."""
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(delta[off: off + size].reshape(leaf.shape[1:]))
        off += size
    return tree_unflatten(treedef, out)


def _flat_blocks(blocks: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Each block's per-leaf (r, size) rows side by side: its rows of the
    flat (N_b, D) update matrix."""
    return [(b[0] if len(b) == 1 else torch.cat(b, dim=1)).contiguous()
            for b in blocks]


@lru_cache(maxsize=16)
def make_round_program(model: FLModel, optimizer: TracedOptimizer,
                       steps: int, use_prox: bool, use_clip: bool,
                       method: str = "none", stc_sparsity: float = 0.01,
                       use_faults: bool = False,
                       max_update_norm: float = 0.0, topology: str = "flat",
                       fanout: int = 0, use_kernel: bool = False,
                       server_lr: float = 1.0, mesh=None):
    """The whole round as one function (``resources.round_fusion="auto"``).

    Signature of the returned function (N_b = bucketed cohort dim):

        (global_params, x, y, idx, n_steps, vec, weights, mask, nan_mask,
         ef_leaves, ef_rows)
            -> (new_global_params, loss, acc, guard_ok, nnz)

    * ``weights`` — (N_b,) f32 normalized FedAvg weights (0 beyond N).
    * ``mask`` / ``nan_mask`` — (N_b,) fault survival mask (f32 0/1) and
      the rows to poison with NaN after compression (bool).  Both are
      tensors, so a new fault pattern builds no new program; they are read
      only when ``use_faults``, and then the fault block
      (:func:`_fault_block`) runs ahead of FedAvg and ``guard_ok`` is
      the (N_b,) bool verdict of its NaN/norm guard (None otherwise).
    * ``ef_leaves`` / ``ef_rows`` — the EF store's hot-tier
      ``(alloc, leaf_size)`` matrices, updated in place, and the (N,) rows
      of the N real clients.  Padded clients are always the last N_b - N
      rows of the cohort, so they read a zero residual and are never
      written back — the reference reaches the same with an out-of-bounds
      sentinel row.  ``()`` and unused under ``method="none"``.
    * ``topology`` / ``fanout`` — flat FedAvg, or the hierarchical tree
      (``kernels.fedavg_agg.fedavg_aggregate_tree``).
    * ``nnz`` — per-STC-leaf (N_b,) non-zero counts (empty otherwise).
    * ``mesh`` — the client mesh of ``resources.distributed="data"``
      (:func:`build_client_mesh`): each shard trains its N_b / k rows on
      its device with its own copy of the params, corrects and compresses
      them there (the sharded K2 / K3 routes; the EF rows move to the
      shard and back), runs the fault block's row checks there, and
      FedAvg is always the sharded K1 route (:func:`_aggregate`); the
      weights, the server apply and every output live on the params'
      device.
    """
    global _round_builds
    _round_builds += 1
    cohort = _one_client_fn(model, optimizer, steps, use_prox, use_clip)

    def round_fn(global_params, x, y, idx, n_steps, vec, weights, mask,
                 nan_mask, ef_leaves, ef_rows):
        home = weights.device
        parts = _train_blocks(cohort, _row_blocks(mesh, x.shape[0], x.device),
                              global_params, x, y, idx, n_steps, vec)
        per_block = [tree_flatten(u)[0] for u, _, _ in parts]
        leaves, treedef = tree_flatten(parts[0][0])
        blocks: List[List[torch.Tensor]] = [[] for _ in parts]
        nnz_list = []
        for li, leaf in enumerate(leaves):
            size = leaf[0].numel()
            flats = [b[li].reshape(b[li].shape[0], size).to(torch.float32)
                     for b in per_block]
            if method != "none":
                ef = ef_leaves[li]
                flats, nnz, new = _error_feedback(
                    flats, ef.index_select(0, ef_rows), method,
                    stc_sparsity, mesh)
                if nnz is not None:
                    nnz_list.append(nnz.to(home))
                ef.index_copy_(0, ef_rows, new)
            for b, f in zip(blocks, flats):
                b.append(f)
        flats = _flat_blocks(blocks)
        ok = None
        if use_faults:
            # poison AFTER compression (the residuals stay clean), then
            # the staged path's fault block on the sent values
            flats = [torch.where(m[:, None], float("nan"), f)
                     for f, m in zip(flats, _per_block(nan_mask, flats))]
            flats, weights, ok = _fault_block(flats, weights, mask, True,
                                              max_update_norm)
        delta = _aggregate(flats, weights, use_kernel, topology, fanout,
                           mesh).to(home)
        delta_tree = _unflatten_delta(delta, leaves, treedef)
        # the server apply (aggregation.apply_delta), in-program
        new_global = tree_map(
            lambda p, d: (p.to(torch.float32) + server_lr * d).to(p.dtype),
            global_params, delta_tree)
        loss = gather_rows([p[1] for p in parts], home)
        acc = gather_rows([p[2] for p in parts], home)
        return new_global, loss, acc, ok, tuple(nnz_list)

    return round_fn


def build_client_mesh(devices: Optional[Sequence] = None) -> ClientMesh:
    """1-D client mesh over the largest power-of-two prefix of ``devices``
    (default: :func:`repro_torch.kernels.ops.get_devices`), one shard an
    entry; a device may repeat.  The cohort dimension is bucket-padded to
    powers of two, so a power-of-two mesh always divides it.  Raises
    ``ValueError`` on an empty list."""
    from repro_torch.kernels.ops import get_devices

    devices = [torch.device(d) for d in
               (get_devices() if devices is None else devices)]
    if not devices:
        raise ValueError(
            'resources.distributed="data" needs at least one jax device to '
            "build the client mesh, but none are available")
    n = 1
    while n * 2 <= len(devices):
        n *= 2
    if n < len(devices):
        warnings.warn(
            f"client mesh uses {n} of {len(devices)} devices (largest "
            f"power of two); {len(devices) - n} device(s) stay idle",
            stacklevel=2)
    return ClientMesh(tuple(devices[:n]))


class BatchedExecutor:
    """Runs a cohort of :class:`repro_torch.core.client.Client` objects on
    ``device``: as one round program (:meth:`run_round_fused`), as the
    staged path's three stages, or as per-client ``Client.train``-shaped
    results for the clients' own post-train stages (:meth:`run_cohort`).

    ``distributed="data"`` shards the cohort over a client mesh
    (:func:`build_client_mesh` of ``devices``, default
    ``repro_torch.get_devices()``): each shard trains, compresses and
    guards its rows on its device and FedAvg takes the sharded K1 route.
    Under a mesh the staged path's stacked ``updates`` are a list of
    per-shard trees (``st["sharded"]``); :meth:`run_cohort` gathers each
    client's rows from its shard."""

    #: bound on the *device-resident* tier of the per-client data pool
    #: (rows); evicted rows are recomputed from ``c.data``
    DATA_POOL_MAX_CLIENTS = 1024
    #: bound on the device-resident tier of the error-feedback residual
    #: store; evicted residuals spill to pinned host copies and reload
    #: bit-identically
    EF_MAX_CLIENTS = 1024

    def __init__(self, model: FLModel, device: torch.device,
                 distributed: str = "none",
                 devices: Optional[Sequence] = None):
        if distributed not in ("none", "data"):
            raise ValueError(
                f"unknown distributed {distributed!r}; expected 'none' or "
                f"'data'")
        self.model = model
        self.device = device
        self.distributed = distributed
        self.mesh = (build_client_mesh(devices)
                     if distributed == "data" else None)
        self._pool = None              # lazily-built TieredRowStore
        self._pool_maxn = 0
        self._pool_sig = None          # (x tail shape/dtype, y ditto)
        self._ef = None                # lazily-built TieredRowStore

    # ------------------------------------------------------------------
    def _batch_indices(self, client, round_id: int) -> np.ndarray:
        """Replicates the reference's per-client epoch/seed schedule."""
        from repro_torch.core.client import _stable_hash
        seed = round_id * 9973 + _stable_hash(client.client_id)
        rows = [cyclic_batches(len(client.data), client._batch_size(), seed + e)
                for e in range(client.cfg.local_epochs)]
        return np.concatenate(rows).astype(np.int64)

    # ------------------------------------------------------------------
    def invalidate_data(self, client_id: Optional[str] = None) -> None:
        """Drop cached device data so the next round re-reads ``c.data``:
        one client's rows, or (no argument) the whole pool.  The pool
        assumes static client datasets; code that swaps a client's data
        mid-run calls this."""
        if self._pool is None:
            return
        if client_id is None:
            self._pool = None
        else:
            self._pool.drop(client_id)

    # ------------------------------------------------------------------
    def _stacked_data(self, clients: Sequence, n_bucket: int, maxn: int):
        """Stacked (N_bucket, maxn, ...) cohort x/y from the tiered pool:
        each client's padded rows upload once while hot, cohorts assemble
        by one device-side row gather, padded clients get zero rows.  Client
        datasets are assumed static (true for every built-in dataset)."""
        from repro_torch.core.tiered_store import TieredRowStore

        x0 = np.asarray(clients[0].data.x)
        y0 = np.asarray(clients[0].data.y)
        sig = (x0.shape[1:], x0.dtype, y0.shape[1:], y0.dtype)
        if self._pool is not None and self._pool_sig != sig:
            self._pool = None          # dataset/shape changed: reset
        if self._pool is None:
            self._pool = TieredRowStore(self.DATA_POOL_MAX_CLIENTS,
                                        spill="drop", device=self.device,
                                        name="data-pool")
            self._pool_sig = sig
            self._pool_maxn = maxn
        if maxn > self._pool_maxn:
            self._pool.pad_dim1(maxn)
            self._pool_maxn = maxn
        by_id = {c.client_id: c for c in clients}
        width = self._pool_maxn

        def make_row(cid):             # recompute path: re-pad from c.data
            c = by_id[cid]
            n = len(c.data)
            nx = np.zeros((width,) + x0.shape[1:], x0.dtype)
            ny = np.zeros((width,) + y0.shape[1:], y0.dtype)
            nx[:n] = c.data.x
            ny[:n] = c.data.y
            return [nx, ny]

        xd, yd = self._pool.gather([c.client_id for c in clients], make_row)
        padn = n_bucket - len(clients)
        if padn:                       # bucket padding: all-zero rows
            xd = torch.cat([xd, xd.new_zeros((padn,) + tuple(xd.shape[1:]))])
            yd = torch.cat([yd, yd.new_zeros((padn,) + tuple(yd.shape[1:]))])
        return xd, yd

    # ------------------------------------------------------------------
    @staticmethod
    def _cohort_optimizer(clients: Sequence):
        """Resolve the cohort's traced optimizer + per-client hp rows.

        Every per-client hyperparameter within one family is vectorized.
        Mixed optimizer *families*, and per-client hand-assigned optimizer
        objects that differ from the client configs, raise ``ValueError``
        naming the clients (a cohort-wide *uniform* hand-built instance is
        honored via a traced wrapper)."""
        from repro_torch.optim import get_optimizer

        # name equality: the name encodes every hyperparameter
        from_cfg = all(
            c.optimizer.name == get_optimizer(
                c.cfg.optimizer, c.cfg.lr, c.cfg.momentum,
                c.cfg.weight_decay, c.cfg.nesterov, c.cfg.adam_b1,
                c.cfg.adam_b2, c.cfg.adam_eps).name
            for c in clients)
        if not from_cfg:
            if len({id(c.optimizer) for c in clients}) == 1:
                return _wrap_uniform(clients[0].optimizer), [()] * len(clients)
            raise ValueError(
                "batched execution cannot vectorize hand-assigned "
                "per-client optimizer objects "
                f"({sorted({c.optimizer.name for c in clients})}); keep "
                "optimizers in the client configs or use "
                "resources.execution='sequential'")
        families: Dict[str, List[str]] = {}
        rows = []
        for c in clients:
            family, hp = hparams_from_config(c.cfg)
            families.setdefault(family, []).append(c.client_id)
            rows.append(hp)
        if len(families) > 1:
            detail = "; ".join(f"{fam}: {ids}"
                               for fam, ids in sorted(families.items()))
            raise ValueError(
                "batched execution cannot mix optimizer families in one "
                "cohort (per-client hyperparameters within one family are "
                f"vectorized) — got {detail}; use "
                "resources.execution='sequential' or partition the "
                "federation by family")
        if "sgd" in families:
            opt = sgd_traced(
                use_momentum=any(r.momentum != 0.0 for r in rows),
                use_nesterov=any(r.nesterov for r in rows))
        else:
            opt = adamw_traced()
        return opt, rows

    # ------------------------------------------------------------------
    @staticmethod
    def cohort_vectors(clients: Sequence, n_bucket: int):
        """Build the cohort's :class:`CohortVectors` (host numpy) + traced
        optimizer.  Padded rows: mu and max_norm 0, hyperparams the first
        client's row (inert: padded clients run 0 active steps)."""
        opt, rows = BatchedExecutor._cohort_optimizer(clients)
        n = len(clients)

        def stack(values, pad):
            a = np.full((n_bucket,), pad, np.float32)
            a[:n] = values
            return a

        mu = stack([c.cfg.proximal_mu for c in clients], 0.0)
        max_norm = stack([c.cfg.max_grad_norm for c in clients], 0.0)
        if rows[0] == ():            # cohort-uniform hand-built optimizer
            hp = ()
        else:
            hp_cls = type(rows[0])
            hp = hp_cls(*(stack([getattr(r, f) for r in rows],
                                getattr(rows[0], f))
                          for f in hp_cls._fields))
        return CohortVectors(mu=mu, max_norm=max_norm, hp=hp), opt

    # ------------------------------------------------------------------
    def _cohort_inputs(self, clients: Sequence, round_id: int):
        """Host-side round prep: bucketed shapes, cohort vectors + traced
        optimizer, pooled device data, batch indices, step counts."""
        batch_sizes = {c._batch_size() for c in clients}
        if len(batch_sizes) != 1:
            raise ValueError(
                f"batched execution needs a uniform batch size, got "
                f"{sorted(batch_sizes)}")
        B = batch_sizes.pop()

        N = len(clients)
        Nb = bucket_pow2(N)
        if self.mesh is not None:
            Nb = max(Nb, self.mesh.size)   # equal shards: k divides Nb
        vec, optimizer = self.cohort_vectors(clients, Nb)
        idx_list = [self._batch_indices(c, round_id) for c in clients]
        S = bucket_pow2(max(len(ix) for ix in idx_list))
        maxn = bucket_pow2(max(len(c.data) for c in clients))

        xd, yd = self._stacked_data(clients, Nb, maxn)
        idx = np.zeros((Nb, S, B), dtype=np.int64)
        n_steps = np.zeros((Nb,), dtype=np.int64)
        for i, c in enumerate(clients):
            idx[i, : len(idx_list[i])] = idx_list[i]
            n_steps[i] = len(idx_list[i])
        return Nb, S, vec, optimizer, xd, yd, idx, n_steps

    # ------------------------------------------------------------------
    def _ef_store(self, sizes: List[int]):
        """The EF residual store (built at first use), checked against the
        update's leaf sizes."""
        if self._ef is None:
            self._ef = self._new_ef_store()
        if self._ef.leaves and \
                [m.shape[1] for m in self._ef.leaves] != sizes:
            raise ValueError(
                "error-feedback store leaf sizes "
                f"{[m.shape[1] for m in self._ef.leaves]} do not match "
                f"the update structure {sizes}; one executor serves one "
                f"model")
        return self._ef

    def _new_ef_store(self):
        from repro_torch.core.tiered_store import TieredRowStore

        return TieredRowStore(
            self.EF_MAX_CLIENTS, spill="host", device=self.device,
            name="ef-store")

    def _put(self, a):
        return torch.as_tensor(a, device=self.device)

    def _vec(self, vec: CohortVectors) -> CohortVectors:
        return CohortVectors(self._put(vec.mu), self._put(vec.max_norm),
                             tree_map(self._put, vec.hp))

    # ------------------------------------------------------------------
    def run_cohort_stacked(self, clients: Sequence, global_params: PyTree,
                           round_id: int) -> Dict[str, Any]:
        """Train the cohort and return the *stacked* results: ``updates``
        (a tree of (N_b, ...) f32 device tensors; under a mesh a list of
        per-shard trees on the shards' devices, with ``sharded`` True),
        host ``loss`` / ``acc`` / ``n_steps`` (N_b,), ``num_samples`` (N,)
        and ``wall``, the blocking training time, which ends with the one
        fetch of loss and accuracy (one dispatch, one host sync)."""
        Nb, S, vec, optimizer, xd, yd, idx, n_steps = self._cohort_inputs(
            clients, round_id)
        # the fused program's own training body
        cohort = _one_client_fn(self.model, optimizer, S,
                                use_prox=bool((vec.mu > 0).any()),
                                use_clip=bool((vec.max_norm > 0).any()))
        t0 = time.perf_counter()
        parts = _train_blocks(cohort, _row_blocks(self.mesh, Nb, self.device),
                              global_params, xd, yd, self._put(idx),
                              self._put(n_steps), self._vec(vec))
        _note_dispatch()
        # the timing boundary: ``wall`` feeds the virtual clock
        stacked = torch.stack([gather_rows([p[i] for p in parts],
                                           self.device) for i in (1, 2)])
        fetched = stacked.cpu().numpy()  # flcheck: ignore[FLC101]  -- the staged cohort's one fetch, the timing boundary
        _note_host_sync()
        wall = time.perf_counter() - t0
        sharded = self.mesh is not None
        return {
            "updates": [p[0] for p in parts] if sharded else parts[0][0],
            "sharded": sharded,
            "loss": fetched[0],
            "acc": fetched[1],
            "n_steps": n_steps,
            "num_samples": np.asarray([len(c.data) for c in clients],
                                      dtype=np.int64),
            "wall": wall,
        }

    # ------------------------------------------------------------------
    def run_round_fused(self, clients: Sequence, global_params: PyTree,
                        round_id: int, *, method: str = "none",
                        stc_sparsity: float = 0.01, use_kernel: bool = False,
                        topology: str = "flat", fanout: int = 0,
                        use_faults: bool = False,
                        mask: Optional[np.ndarray] = None,
                        nan_rows: Sequence[int] = (),
                        max_update_norm: float = 0.0,
                        server_lr: float = 1.0, sync: bool = True):
        """Run the whole round as ONE dispatch (:func:`make_round_program`).

        Returns ``(st, new_global_params, fetch)``.  ``st`` holds
        ``n_steps``, ``num_samples`` and the per-leaf sizes; the round's
        single batched device->host transfer fills in host numpy ``loss``
        / ``acc`` (N_b,), the per-leaf STC ``nnz`` layout and, with
        ``use_faults``, the guard's (N_b,) bool ``guard_ok``.  ``mask`` is
        the (N,) survival mask of the cohort (dropped and crashed clients
        0) and ``nan_rows`` the cohort rows whose upload is poisoned; they
        enter the program as tensors.  With
        ``sync=True`` that fetch has happened, ``fetch`` is None and
        ``wall`` is the blocking round time (the virtual clock's
        boundary).  With ``sync=False`` (``tracking.round_sync``) the call
        returns after submission: ``wall`` is the submission time and the
        caller runs ``fetch()`` later, typically after dispatching the next
        round.  The EF residual store is updated in place."""
        Nb, S, vec, optimizer, xd, yd, idx, n_steps = self._cohort_inputs(
            clients, round_id)
        from repro_torch.core.aggregation import fedavg_weights
        from repro_torch.core.compression import DENSE_MIN_ELEMS

        N = len(clients)
        num_samples = np.asarray([len(c.data) for c in clients],
                                 dtype=np.int64)
        w = np.zeros((Nb,), np.float32)
        w[:N] = fedavg_weights(num_samples)
        m = nanm = None                 # the fault-free round copies none
        if use_faults:
            m = np.zeros((Nb,), np.float32)
            m[:N] = 1.0 if mask is None else np.asarray(mask, np.float32)
            nanm = np.zeros((Nb,), bool)
            if len(nan_rows):
                nanm[np.asarray(nan_rows, np.int64)] = True
            m, nanm = self._put(m), self._put(nanm)

        sizes = [int(leaf.numel()) for leaf in tree_leaves(global_params)]
        if method != "none":
            ef = self._ef_store(sizes)
            rows = ef.ensure([c.client_id for c in clients],
                             zero_shapes=[(s,) for s in sizes])
            ef_leaves = tuple(ef.leaves)
        else:
            ef_leaves, rows = (), np.zeros((0,), np.int64)

        program = make_round_program(
            self.model, optimizer, S,
            use_prox=bool((vec.mu > 0).any()),
            use_clip=bool((vec.max_norm > 0).any()),
            method=method, stc_sparsity=float(stc_sparsity),
            use_faults=use_faults, max_update_norm=float(max_update_norm),
            topology=topology, fanout=int(fanout), use_kernel=use_kernel,
            server_lr=float(server_lr), mesh=self.mesh)

        t0 = time.perf_counter()
        new_global, loss, acc, ok, nnz = program(
            global_params, xd, yd, self._put(idx), self._put(n_steps),
            self._vec(vec), self._put(w), m, nanm, ef_leaves,
            self._put(rows))
        _note_dispatch()
        st: Dict[str, Any] = {
            "n_steps": n_steps,
            "num_samples": num_samples,
            "compression": method,
            "comp_sizes": sizes,
        }

        def fetch():
            # the round's ONE batched device->host transfer
            guard = [] if ok is None else [ok.to(loss.dtype)]
            fetched = torch.stack([loss, acc, *guard, *nnz]).cpu().numpy()  # flcheck: ignore[FLC101]  -- the fused round's single batched fetch
            _note_host_sync()
            counts = iter(fetched[2 + len(guard):])
            st["loss"], st["acc"] = fetched[0], fetched[1]
            if guard:
                st["guard_ok"] = fetched[2] > 0
            # one entry per leaf, None for leaves without an STC count
            st["nnz"] = [next(counts) if method == "stc"
                         and s >= DENSE_MIN_ELEMS else None for s in sizes]

        if sync:
            fetch()        # it also blocks on the whole round: the boundary
            st["wall"] = time.perf_counter() - t0
            return st, new_global, None
        st["wall"] = time.perf_counter() - t0      # submission time
        return st, new_global, fetch

    # ------------------------------------------------------------------
    def run_cohort(self, clients: Sequence, global_params: PyTree,
                   round_id: int) -> List[Dict[str, Any]]:
        """Train ``clients`` as one cohort; one ``Client.train``-shaped
        dict per client (``update``, ``num_samples``, ``metrics``,
        ``train_time``), in cohort order — the gathering path, ready for
        each client's compression / encryption / upload stages."""
        if not clients:
            return []
        st = self.run_cohort_stacked(clients, global_params, round_id)
        return self.per_client_results(clients, st)

    # ------------------------------------------------------------------
    def _ef_gather(self, clients: Sequence, leaves: List[torch.Tensor]):
        """The cohort's EF residual rows, one (N, leaf_size) f32 device
        tensor per update leaf, keyed by client id: hot rows gather on the
        device, spilled rows reload from pinned host copies, new clients
        start from device zeros.  -> (rows per leaf, client ids)."""
        sizes = [leaf[0].numel() for leaf in leaves]
        ids = [c.client_id for c in clients]
        res = self._ef_store(sizes).gather(
            ids, zero_shapes=[(s,) for s in sizes])
        return res, ids

    # ------------------------------------------------------------------
    def ef_state(self) -> Dict[str, Any]:
        """Checkpoint snapshot of the EF residual store (format 2): every
        client's rows as host tensors, from both tiers (hot rows leave the
        device in one batched fetch per leaf), so a resume reproduces each
        residual bit for bit whichever tier held it.  Client ids are
        sorted, so the snapshot does not depend on which slot or tier held
        a row."""
        if self._ef is None:
            return {"format": 2, "clients": {}}
        return {"clients": dict(sorted(self._ef.state()["clients"].items())),
                "format": 2}

    def load_ef_state(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`ef_state` into the warm tier (rows re-heat onto
        the device at their next gather).  Takes the legacy dense
        ``{"rows", "store"}`` snapshot too."""
        self._ef = self._new_ef_store()
        if "clients" in state:
            self._ef.load_state(state)
            return
        rows = {str(k): int(v)  # flcheck: ignore[FLC102]  -- checkpoint dict holds host ints
                for k, v in state.get("rows", {}).items()}
        store = [np.asarray(m, np.float32) for m in state.get("store", [])]
        self._ef.load_state(
            {"clients": {cid: [m[r] for m in store]
                         for cid, r in rows.items()}})

    # ------------------------------------------------------------------
    def compress_stacked(self, st: Dict[str, Any], clients: Sequence,
                         method: str,
                         stc_sparsity: float = 0.01) -> Dict[str, Any]:
        """The staged compression stage: each stacked leaf, flattened to
        (N_b, size) and error-corrected by the client's stored residual,
        goes through the batched kernel (K2 for STC, K3a + K3b for int8;
        each shard's rows on its device, the sharded route, under a mesh;
        leaves under ``DENSE_MIN_ELEMS`` stay dense); the new residual
        (corrected - sent) is scattered back to the store.  Returns a copy
        of ``st`` whose ``updates`` are the sent values, with ``nnz`` (one
        (N_b,) device count per STC leaf, else None), ``comp_sizes`` and
        ``compression``.  Same arithmetic as the fused program."""
        if method not in ("stc", "int8"):
            raise ValueError(
                f"unknown in-program compression {method!r}; expected "
                f"'stc' or 'int8'")
        per_block = [tree_flatten(u)[0] for u in self._blocks(st)]
        leaves, treedef = tree_flatten(self._blocks(st)[0])
        residuals, ids = self._ef_gather(clients, leaves)
        sent_blocks: List[List[torch.Tensor]] = [[] for _ in per_block]
        new_res, nnz_list, sizes = [], [], []
        for li, res in enumerate(residuals):
            size = leaves[li][0].numel()
            sizes.append(size)
            flats = [b[li].reshape(b[li].shape[0], size).to(torch.float32)
                     for b in per_block]
            sent, nnz, new = _error_feedback(flats, res, method, stc_sparsity,
                                             self.mesh)
            new_res.append(new)
            for out_b, b, x in zip(sent_blocks, per_block, sent):
                out_b.append(x.reshape(b[li].shape))
            nnz_list.append(nnz)
        self._ef.scatter(ids, new_res)
        _note_dispatch()               # the staged compression stage
        out = dict(st)
        out["updates"] = self._unblocks(
            st, [tree_unflatten(treedef, b) for b in sent_blocks])
        out["nnz"] = nnz_list
        out["comp_sizes"] = sizes
        out["compression"] = method
        return out

    # ------------------------------------------------------------------
    def aggregate_stacked(self, st: Dict[str, Any], use_kernel: bool = False,
                          mask: Optional[np.ndarray] = None,
                          guard: bool = False, max_update_norm: float = 0.0,
                          topology: str = "flat",
                          fanout: int = 0) -> PyTree:
        """The staged aggregation stage: FedAvg of the stacked updates as
        one (N_b, D) matrix — flat (K1 under ``use_kernel``, else one
        einsum) or the hierarchical tree; under a mesh each shard's rows
        on its device through the sharded K1 route — with no per-client
        slicing.
        Returns the (f32) delta as a tree shaped like the global params.

        Faults (``cfg.faults``): ``mask`` zero-weights failed or
        deadline-missing clients ((N,) 0/1 host array), ``guard`` adds the
        NaN/Inf row check (and the ``max_update_norm`` bound when > 0),
        and the survivors' weights renormalize (:func:`_fault_block`, the
        fused program's fault block); the guard's (N_b,) bool device
        verdict lands in ``st["guard_ok"]``.  With both left at their
        defaults the stage is the fault-free one."""
        from repro_torch.core.aggregation import fedavg_weights

        blocks = self._blocks(st)
        flats = [torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                            for leaf in tree_leaves(b)], dim=1).contiguous()
                 for b in blocks]
        nb = sum(f.shape[0] for f in flats)
        num_samples = st["num_samples"]
        w = np.zeros((nb,), np.float32)
        w[: len(num_samples)] = fedavg_weights(num_samples)
        w = self._put(w)
        if mask is not None or guard:
            m = None
            if mask is not None:
                m = np.zeros((nb,), np.float32)
                m[: len(mask)] = np.asarray(mask, np.float32)
                m = self._put(m)
            flats, w, ok = _fault_block(flats, w, m, guard, max_update_norm)
            if guard:
                st["guard_ok"] = ok
        delta = _aggregate(flats, w, use_kernel, topology, fanout,
                           self.mesh).to(self.device)
        _note_dispatch()               # the staged aggregation stage
        return _unflatten_delta(delta, *tree_flatten(blocks[0]))

    # ------------------------------------------------------------------
    @staticmethod
    def _blocks(st: Dict[str, Any]) -> List[PyTree]:
        """The stacked updates as row blocks: the per-shard trees under a
        mesh, else the one tree."""
        return st["updates"] if st.get("sharded") else [st["updates"]]

    @staticmethod
    def _unblocks(st: Dict[str, Any], blocks: List[PyTree]):
        return blocks if st.get("sharded") else blocks[0]

    @staticmethod
    def _client_update(st: Dict[str, Any], i: int) -> PyTree:
        """Cohort row ``i``'s update, gathered from its shard onto the first
        shard's device under a mesh."""
        if not st.get("sharded"):
            return tree_map(lambda a: a[i], st["updates"])
        blocks = st["updates"]
        first = tree_leaves(blocks[0])[0]
        r = first.shape[0]
        return tree_map(lambda a: a[i % r].to(first.device), blocks[i // r])

    @staticmethod
    def poison_rows(st: Dict[str, Any], rows: Sequence[int]) -> None:
        """Poison the stacked updates of cohort ``rows`` with NaN in place
        of ``st["updates"]`` (NaN uploads, after compression)."""
        blocks, lo = [], 0
        for b in BatchedExecutor._blocks(st):
            first = tree_leaves(b)[0]
            local = [i - lo for i in rows if lo <= i < lo + first.shape[0]]
            if local:
                idx = torch.as_tensor(local, device=first.device)
                b = tree_map(lambda a: a.index_fill(0, idx, float("nan")), b)
            blocks.append(b)
            lo += first.shape[0]
        st["updates"] = BatchedExecutor._unblocks(st, blocks)

    # ------------------------------------------------------------------
    @staticmethod
    def per_client_payload_bytes(st: Dict[str, Any]) -> List[int]:
        """Wire sizes of a compressed round: STC leaves from the per-client
        nnz (device counts of the staged path fetched in one transfer, one
        host sync; the fused round's are fetched already), int8 leaves 1
        byte/element + scale, tiny dense leaves (< ``DENSE_MIN_ELEMS``) raw
        f32 bytes."""
        from repro_torch.core.compression import (
            DENSE_MIN_ELEMS, stc_leaf_bytes,
        )

        method = st["compression"]
        n = len(st["num_samples"])
        base = 0
        for size in st["comp_sizes"]:
            if size < DENSE_MIN_ELEMS:
                base += size * 4                      # dense f32 leaf
            elif method == "int8":
                base += size + 4                      # int8 + scale
        totals = np.full((n,), base, np.int64)
        stc_nnz = [a for a in st["nnz"] if a is not None]
        if any(isinstance(a, torch.Tensor) for a in stc_nnz):
            stc_nnz = list(torch.stack(stc_nnz).cpu().numpy())  # flcheck: ignore[FLC101]  -- one batched nnz fetch
            _note_host_sync()
        for counts in stc_nnz:
            totals += stc_leaf_bytes(np.asarray(counts)[:n].astype(np.int64))
        return totals.tolist()  # flcheck: ignore[FLC101]  -- a numpy array, already on the host

    # ------------------------------------------------------------------
    @staticmethod
    def per_client_results(clients: Sequence, st: Dict[str, Any],
                           include_update: bool = True
                           ) -> List[Dict[str, Any]]:
        """Slice stacked results into ``Client.train``-shaped dicts; the
        shared wall time becomes per-client base times by step share (the
        virtual clock).  ``include_update=False`` leaves the updates out
        (the staged path aggregates them stacked)."""
        n_steps, wall = st["n_steps"], st["wall"]
        total_steps = max(int(n_steps.sum()), 1)
        loss, acc = st["loss"].tolist(), st["acc"].tolist()  # flcheck: ignore[FLC101]  -- numpy arrays of the cohort's one fetch
        steps_f = n_steps.astype(np.float64).tolist()  # flcheck: ignore[FLC101]  -- a numpy array, already on the host
        results = []
        for i, c in enumerate(clients):
            res = {
                "num_samples": len(c.data),
                "metrics": {"loss": loss[i], "accuracy": acc[i],
                            "batches": steps_f[i]},
                "train_time": wall * steps_f[i] / total_steps,
            }
            if include_update:
                res["update"] = BatchedExecutor._client_update(st, i)
            results.append(res)
        return results
