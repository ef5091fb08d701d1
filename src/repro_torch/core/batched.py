"""Batched client execution engine: the whole cohort in one round program.

The selected clients' params, optimizer states and cyclic-batch indices are
stacked along a leading client dimension and all E local epochs of the
cohort run together: ``torch.func.vmap`` over clients of one ``grad`` step,
inside a Python loop over the bucketed local steps — the PyTorch form of
the reference's ``jax.vmap`` around ``jax.lax.scan``.

:func:`make_round_program` fuses the rest of the round behind that
training: per-leaf error-feedback (EF) correction, in-program STC or int8
compression with the EF residual update (hand-written CUDA kernels,
``repro_torch.kernels``), the flat (N_b, D) update matrix, FedAvg (the
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
from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.local_train import client_grads, cyclic_batches
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


def _compress_rows(corrected: torch.Tensor, method: str,
                   stc_sparsity: float):
    """One error-corrected (N_b, size) leaf -> (sent, STC counts or None).
    Leaves under ``DENSE_MIN_ELEMS`` elements stay dense."""
    from repro_torch.core.compression import DENSE_MIN_ELEMS
    from repro_torch.kernels import ops as kops

    if corrected.shape[1] < DENSE_MIN_ELEMS:
        return corrected, None
    if method == "stc":
        return kops.stc_compress_batched(corrected, stc_sparsity)
    return kops.int8_roundtrip_batched(corrected)[0], None


def _aggregate(flat: torch.Tensor, weights: torch.Tensor, use_kernel: bool,
               topology: str, fanout: int) -> torch.Tensor:
    """FedAvg of the (N_b, D) update matrix: the tree of grouped K1
    launches (``hierarchical``), K1 (``use_kernel``) or one einsum."""
    from repro_torch.kernels import ops as kops

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


@lru_cache(maxsize=16)
def make_round_program(model: FLModel, optimizer: TracedOptimizer,
                       steps: int, use_prox: bool, use_clip: bool,
                       method: str = "none", stc_sparsity: float = 0.01,
                       topology: str = "flat", fanout: int = 0,
                       use_kernel: bool = False, server_lr: float = 1.0):
    """The whole round as one function (``resources.round_fusion="auto"``).

    Signature of the returned function (N_b = bucketed cohort dim):

        (global_params, x, y, idx, n_steps, vec, weights, ef_leaves,
         ef_rows)
            -> (new_global_params, loss, acc, nnz)

    * ``weights`` — (N_b,) f32 normalized FedAvg weights (0 beyond N).
    * ``ef_leaves`` / ``ef_rows`` — the EF store's hot-tier
      ``(alloc, leaf_size)`` matrices, updated in place, and the (N,) rows
      of the N real clients.  Padded clients are always the last N_b - N
      rows of the cohort, so they read a zero residual and are never
      written back — the reference reaches the same with an out-of-bounds
      sentinel row.  ``()`` and unused under ``method="none"``.
    * ``topology`` / ``fanout`` — flat FedAvg, or the hierarchical tree
      (``kernels.fedavg_agg.fedavg_aggregate_tree``).
    * ``nnz`` — per-STC-leaf (N_b,) non-zero counts (empty otherwise).
    """
    global _round_builds
    _round_builds += 1
    cohort = _one_client_fn(model, optimizer, steps, use_prox, use_clip)

    def round_fn(global_params, x, y, idx, n_steps, vec, weights, ef_leaves,
                 ef_rows):
        nb = x.shape[0]
        stacked = tree_map(
            lambda p: p.unsqueeze(0).expand((nb,) + tuple(p.shape)),
            global_params)
        updates, loss, acc = cohort(stacked, x, y, idx, n_steps, vec,
                                    global_params)

        leaves, treedef = tree_flatten(updates)
        flat_leaves, nnz_list = [], []
        for li, leaf in enumerate(leaves):
            flat = leaf.reshape(nb, leaf[0].numel()).to(torch.float32)
            if method != "none":
                ef = ef_leaves[li]
                # error-correct by the stored residual (0 for padded rows)
                res = F.pad(ef.index_select(0, ef_rows),
                            (0, 0, 0, nb - ef_rows.shape[0]))
                corrected = (flat + res).contiguous()
                sent, nnz = _compress_rows(corrected, method, stc_sparsity)
                if nnz is not None:
                    nnz_list.append(nnz)
                ef.index_copy_(0, ef_rows,
                               (corrected - sent)[: ef_rows.shape[0]])
                flat = sent
            flat_leaves.append(flat)
        flat = (flat_leaves[0] if len(flat_leaves) == 1
                else torch.cat(flat_leaves, dim=1)).contiguous()
        delta = _aggregate(flat, weights, use_kernel, topology, fanout)
        delta_tree = _unflatten_delta(delta, leaves, treedef)
        # the server apply (aggregation.apply_delta), in-program
        new_global = tree_map(
            lambda p, d: (p.to(torch.float32) + server_lr * d).to(p.dtype),
            global_params, delta_tree)
        return new_global, loss, acc, tuple(nnz_list)

    return round_fn


class BatchedExecutor:
    """Runs a cohort of :class:`repro_torch.core.client.Client` objects on
    ``device``: as one round program (:meth:`run_round_fused`), as the
    staged path's three stages, or as per-client ``Client.train``-shaped
    results for the clients' own post-train stages (:meth:`run_cohort`)."""

    #: bound on the *device-resident* tier of the per-client data pool
    #: (rows); evicted rows are recomputed from ``c.data``
    DATA_POOL_MAX_CLIENTS = 1024
    #: bound on the device-resident tier of the error-feedback residual
    #: store; evicted residuals spill to pinned host copies and reload
    #: bit-identically
    EF_MAX_CLIENTS = 1024

    def __init__(self, model: FLModel, device: torch.device,
                 distributed: str = "none"):
        if distributed != "none":
            raise NotImplementedError(
                "resources.distributed='data' (the sharded cohort) is not "
                "ported to repro_torch yet (ROADMAP M5.7)")
        self.model = model
        self.device = device
        self.distributed = distributed
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
        from repro_torch.core.tiered_store import TieredRowStore

        if self._ef is None:
            self._ef = TieredRowStore(self.EF_MAX_CLIENTS, spill="host",
                                      device=self.device, name="ef-store")
        if self._ef.leaves and \
                [m.shape[1] for m in self._ef.leaves] != sizes:
            raise ValueError(
                "error-feedback store leaf sizes "
                f"{[m.shape[1] for m in self._ef.leaves]} do not match "
                f"the update structure {sizes}; one executor serves one "
                f"model")
        return self._ef

    def _put(self, a):
        return torch.as_tensor(a, device=self.device)

    def _vec(self, vec: CohortVectors) -> CohortVectors:
        return CohortVectors(self._put(vec.mu), self._put(vec.max_norm),
                             tree_map(self._put, vec.hp))

    # ------------------------------------------------------------------
    def run_cohort_stacked(self, clients: Sequence, global_params: PyTree,
                           round_id: int) -> Dict[str, Any]:
        """Train the cohort and return the *stacked* results: ``updates``
        (a tree of (N_b, ...) f32 device tensors), host ``loss`` / ``acc``
        / ``n_steps`` (N_b,), ``num_samples`` (N,) and ``wall``, the
        blocking training time, which ends with the one fetch of loss and
        accuracy (one dispatch, one host sync)."""
        Nb, S, vec, optimizer, xd, yd, idx, n_steps = self._cohort_inputs(
            clients, round_id)
        # the fused program's own training body
        cohort = _one_client_fn(self.model, optimizer, S,
                                use_prox=bool((vec.mu > 0).any()),
                                use_clip=bool((vec.max_norm > 0).any()))
        stacked = tree_map(
            lambda p: p.unsqueeze(0).expand((Nb,) + tuple(p.shape)),
            global_params)
        t0 = time.perf_counter()
        updates, loss, acc = cohort(stacked, xd, yd, self._put(idx),
                                    self._put(n_steps), self._vec(vec),
                                    global_params)
        _note_dispatch()
        # the timing boundary: ``wall`` feeds the virtual clock
        fetched = torch.stack([loss, acc]).cpu().numpy()
        _note_host_sync()
        wall = time.perf_counter() - t0
        return {
            "updates": updates,
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
                        server_lr: float = 1.0, sync: bool = True):
        """Run the whole round as ONE dispatch (:func:`make_round_program`).

        Returns ``(st, new_global_params, fetch)``.  ``st`` holds
        ``n_steps``, ``num_samples`` and the per-leaf sizes; the round's
        single batched device->host transfer fills in host numpy ``loss``
        / ``acc`` (N_b,) and the per-leaf STC ``nnz`` layout.  With
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
            topology=topology, fanout=int(fanout), use_kernel=use_kernel,
            server_lr=float(server_lr))

        t0 = time.perf_counter()
        new_global, loss, acc, nnz = program(
            global_params, xd, yd, self._put(idx), self._put(n_steps),
            self._vec(vec), self._put(w), ef_leaves, self._put(rows))
        _note_dispatch()
        st: Dict[str, Any] = {
            "n_steps": n_steps,
            "num_samples": num_samples,
            "compression": method,
            "comp_sizes": sizes,
        }

        def fetch():
            # the round's ONE batched device->host transfer
            fetched = torch.stack([loss, acc, *nnz]).cpu().numpy()
            _note_host_sync()
            counts = iter(fetched[2:])
            st["loss"], st["acc"] = fetched[0], fetched[1]
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
    def compress_stacked(self, st: Dict[str, Any], clients: Sequence,
                         method: str,
                         stc_sparsity: float = 0.01) -> Dict[str, Any]:
        """The staged compression stage: each stacked leaf, flattened to
        (N_b, size) and error-corrected by the client's stored residual,
        goes through the batched kernel (K2 for STC, K3a + K3b for int8;
        leaves under ``DENSE_MIN_ELEMS`` stay dense); the new residual
        (corrected - sent) is scattered back to the store.  Returns a copy
        of ``st`` whose ``updates`` are the sent values, with ``nnz`` (one
        (N_b,) device count per STC leaf, else None), ``comp_sizes`` and
        ``compression``.  Same arithmetic as the fused program."""
        if method not in ("stc", "int8"):
            raise ValueError(
                f"unknown in-program compression {method!r}; expected "
                f"'stc' or 'int8'")
        leaves, treedef = tree_flatten(st["updates"])
        nb = leaves[0].shape[0]
        n = len(clients)
        residuals, ids = self._ef_gather(clients, leaves)
        sent_leaves, new_res, nnz_list, sizes = [], [], [], []
        for leaf, res in zip(leaves, residuals):
            size = leaf[0].numel()
            sizes.append(size)
            flat = leaf.reshape(nb, size).to(torch.float32)
            corrected = (flat + F.pad(res, (0, 0, 0, nb - n))).contiguous()
            sent, nnz = _compress_rows(corrected, method, stc_sparsity)
            new_res.append((corrected - sent)[:n])
            sent_leaves.append(sent.reshape(leaf.shape))
            nnz_list.append(nnz)
        self._ef.scatter(ids, new_res)
        _note_dispatch()               # the staged compression stage
        out = dict(st)
        out["updates"] = tree_unflatten(treedef, sent_leaves)
        out["nnz"] = nnz_list
        out["comp_sizes"] = sizes
        out["compression"] = method
        return out

    # ------------------------------------------------------------------
    def aggregate_stacked(self, st: Dict[str, Any], use_kernel: bool = False,
                          topology: str = "flat",
                          fanout: int = 0) -> PyTree:
        """The staged aggregation stage: FedAvg of the stacked updates as
        one (N_b, D) matrix — flat (K1 under ``use_kernel``, else one
        einsum) or the hierarchical tree — with no per-client slicing.
        Returns the (f32) delta as a tree shaped like the global params."""
        from repro_torch.core.aggregation import fedavg_weights

        leaves, treedef = tree_flatten(st["updates"])
        nb = leaves[0].shape[0]
        num_samples = st["num_samples"]
        w = np.zeros((nb,), np.float32)
        w[: len(num_samples)] = fedavg_weights(num_samples)
        flat = torch.cat([leaf.reshape(nb, -1).to(torch.float32)
                          for leaf in leaves], dim=1).contiguous()
        delta = _aggregate(flat, self._put(w), use_kernel, topology, fanout)
        _note_dispatch()               # the staged aggregation stage
        return _unflatten_delta(delta, leaves, treedef)

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
            stc_nnz = list(torch.stack(stc_nnz).cpu().numpy())
            _note_host_sync()
        for counts in stc_nnz:
            totals += stc_leaf_bytes(np.asarray(counts)[:n].astype(np.int64))
        return totals.tolist()

    # ------------------------------------------------------------------
    @staticmethod
    def per_client_results(clients: Sequence, st: Dict[str, Any],
                           include_update: bool = True
                           ) -> List[Dict[str, Any]]:
        """Slice stacked results into ``Client.train``-shaped dicts; the
        shared wall time becomes per-client base times by step share (the
        virtual clock).  ``include_update=False`` leaves the updates out
        (the staged path aggregates them stacked)."""
        updates, n_steps, wall = st["updates"], st["n_steps"], st["wall"]
        total_steps = max(int(n_steps.sum()), 1)
        loss, acc = st["loss"].tolist(), st["acc"].tolist()
        steps_f = n_steps.astype(np.float64).tolist()
        results = []
        for i, c in enumerate(clients):
            res = {
                "num_samples": len(c.data),
                "metrics": {"loss": loss[i], "accuracy": acc[i],
                            "batches": steps_f[i]},
                "train_time": wall * steps_f[i] / total_steps,
            }
            if include_update:
                res["update"] = tree_map(lambda a, i=i: a[i], updates)
            results.append(res)
        return results
