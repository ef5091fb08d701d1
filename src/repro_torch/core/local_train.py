"""Local training, shared by the engines.

:func:`client_grads` is one client's loss, FedProx term and gradient
clipping — the same code for the batched engine (per-client scalars under
``vmap``) and the sequential engine (:func:`make_client_step`,
:func:`local_train`).  ``cyclic_batches`` is the reference's batch
schedule, copied verbatim (a numpy ``RandomState`` permutation per epoch),
so the port draws the same batches bit for bit.  ``local_train`` and
``evaluate`` keep their per-batch metrics on the device and fetch them in
one device-to-host transfer at the end.

On a card the sequential engine's two steps run as CUDA graphs, the
port's counterparts of the reference's jitted ``make_client_step`` and
``make_eval_step``, which every client of a hyperparameter set shares:
:class:`ClientStep` and :class:`EvalStep`, one graph a shapes key through
``utils/capture.py::CapturedGraph``.  ``local_train`` and ``evaluate``
hold the device's :func:`~repro_torch.utils.capture.device_lock` around
their work on the device, so that threads (the remote client services)
take turns on a step's buffers and graph.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.small import FLModel
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.utils.capture import (
    CaptureCounts, CapturedGraph, device_lock, traced_flags,
)
from repro_torch.utils.tree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)


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


# ---------------------------------------------------------------------------
# the steps as CUDA graphs
# ---------------------------------------------------------------------------

_client_graphs = CaptureCounts()
_eval_graphs = CaptureCounts()


def client_step_capture_count() -> int:
    """CUDA-graph captures of a client step this process (every
    :class:`ClientStep`'s, recaptures included)."""
    return _client_graphs.captures


def client_step_replay_count() -> int:
    """CUDA-graph replays of a client step this process: one a captured
    local step (the capturing call included)."""
    return _client_graphs.replays


def eval_step_capture_count() -> int:
    """CUDA-graph captures of an eval step this process."""
    return _eval_graphs.captures


def eval_step_replay_count() -> int:
    """CUDA-graph replays of an eval step this process: one a batch."""
    return _eval_graphs.replays


def _spec(tree):
    """The structure, shape and dtype of every leaf of ``tree``."""
    leaves, treedef = tree_flatten(tree)
    return repr(treedef), tuple((tuple(t.shape), t.dtype) for t in leaves)


class _Slot:
    """One shapes key's static buffers (leaf lists and their tree
    structures) and its graph."""

    def __init__(self, params, state=(), anchor=False):
        p, self.ptree = tree_flatten(params)
        s, self.stree = tree_flatten(state)
        self.params = [t.clone() for t in p]
        self.state = [t.clone() for t in s]
        self.anchor = [t.clone() for t in p] if anchor else None
        self.graph: Optional[CapturedGraph] = None
        self.warm = False           # the eager warm-up ran

    def load(self, bufs, tree):
        for buf, t in zip(bufs, tree_leaves(tree)):
            buf.copy_(t)


class _GraphedStep:
    """What the client step and the eval step share: a slot of static
    buffers and one CUDA graph a shapes key, the warm-up, the capture and
    the replays, and the counters.

    At a key the first step runs eagerly on the slot's buffers (the
    warm-up: cuBLAS's and cuDNN's first use, the allocator's growth), the
    second captures (:class:`CapturedGraph`, counted by the class's
    ``_counts``) and replays, every later one replays.  The key holds the
    flags the model reads as it runs (``utils.capture.traced_flags``), so
    a flag flipped since a capture selects another key.  The graphs of a
    step share one memory pool a device: they replay one at a time, under
    the device's lock, and their outputs are copied out at once.  A
    capture or replay that fails raises; nothing falls back to an eager
    step.  Steps run eagerly on devices not in ``graph_device_types``: the
    CPU, where no graph exists; setting it to ``()`` runs every step
    eagerly (the eager side of an A/B on a card).

    ``captures``, ``recaptures`` (captures beyond one a key), ``replays``
    and ``eager_steps`` count this object's graphed steps; :meth:`keys`
    lists its shapes keys."""

    #: device types whose steps run as a graph (the CPU tests stand a
    #: recording graph in for the CUDA one on "cpu")
    graph_device_types = ("cuda",)
    _counts: CaptureCounts

    def __init__(self):
        self._slots: Dict[Any, _Slot] = {}
        self._pools: Dict[torch.device, Any] = {}
        self.captures = self.replays = self.eager_steps = 0

    @property
    def recaptures(self) -> int:
        return self.captures - sum(s.graph is not None
                                   for s in self._slots.values())

    def graphed(self, device: torch.device) -> bool:
        """Whether this step runs as a graph on ``device``."""
        return device.type in self.graph_device_types

    def keys(self) -> List[Any]:
        return list(self._slots)

    def _body(self, slot: _Slot, batch):
        raise NotImplementedError

    def _step(self, slot: _Slot, batch, device: torch.device):
        """One step on ``slot``'s buffers with ``batch`` ``(x, y)`` ->
        (loss, accuracy)."""
        if slot.graph is not None:
            self.replays += 1
            return slot.graph(batch)
        if not slot.warm:
            slot.warm = True
            self.eager_steps += 1
            return self._body(slot, batch)
        slot.graph = CapturedGraph(lambda s: self._body(slot, s), batch,
                                   device, self._counts,
                                   pool=self._pools.get(device))
        self._pools.setdefault(device, slot.graph.pool())
        self.captures += 1
        self.replays += 1
        return slot.graph(batch)


class ClientStep(_GraphedStep):
    """``(params, opt_state, batch, global_params) -> (params, opt_state,
    metrics)``: one eager local step of the sequential engine; :meth:`run`
    runs a client's local steps.  The port's counterpart of the
    reference's jitted ``make_client_step`` (no donation: the caller's
    input trees stay valid).

    On a graph device :meth:`run` keeps the params, the optimizer state
    and — under FedProx — the global params in the static buffers of the
    run's shapes key (every param and state leaf's structure, shape and
    dtype, the batch's shape and dtypes, the device, the traced flags): it
    copies the params (and the anchor) in once, resets the state in place
    to what ``optimizer.init`` gives, then for each batch gathers ``x[b]``,
    ``y[b]`` and steps (:meth:`_GraphedStep._step`: the graph copies the
    batch into its static batch and replays).  The graph computes the
    eager step and writes the new params and state back into the buffers
    with ``copy_``, returning the loss and accuracy.  The params come back
    as fresh copies: the next client overwrites the buffers, so nothing
    the caller keeps aliases them."""

    _counts = _client_graphs

    def __init__(self, model: FLModel, optimizer: Optimizer,
                 proximal_mu: float = 0.0, max_grad_norm: float = 0.0):
        super().__init__()
        self.model = model
        self.optimizer = optimizer
        self.proximal_mu = proximal_mu
        self.max_grad_norm = max_grad_norm
        self._consts: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, params, opt_state, batch, global_params):
        x = batch["x"]
        if x.device not in self._consts:  # fills on the device, no sync
            self._consts[x.device] = tuple(
                torch.full((), v, dtype=torch.float32, device=x.device)
                for v in (self.proximal_mu, self.max_grad_norm))
        mu, max_norm = self._consts[x.device]
        grads, loss, acc = client_grads(
            self.model, params, x, batch["y"], global_params, mu, max_norm,
            self.proximal_mu > 0.0, self.max_grad_norm > 0.0)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        return (apply_updates(params, updates), opt_state,
                {"loss": loss, "accuracy": acc})

    def _body(self, slot: _Slot, batch):
        params = tree_unflatten(slot.ptree, slot.params)
        gp = (params if slot.anchor is None
              else tree_unflatten(slot.ptree, slot.anchor))
        params, state, metrics = self(
            params, tree_unflatten(slot.stree, slot.state),
            {"x": batch[0], "y": batch[1]}, gp)
        slot.load(slot.params, params)
        slot.load(slot.state, state)
        return metrics["loss"], metrics["accuracy"]

    def run(self, params, x, y, idx, global_params=None):
        """The local steps on the batches ``x[b]``, ``y[b]`` for each row
        ``b`` of ``idx`` from ``params`` and a fresh optimizer state; the
        FedProx anchor is ``global_params``, else the initial params.
        -> (new params, the per-step losses and accuracies as 0-d tensors
        on the device)."""
        opt_state = self.optimizer.init(params)
        gp = params if global_params is None else global_params
        losses, accs = [], []
        if not self.graphed(x.device):
            for bidx in idx:
                params, opt_state, m = self(
                    params, opt_state, {"x": x[bidx], "y": y[bidx]}, gp)
                losses.append(m["loss"])
                accs.append(m["accuracy"])
            return params, losses, accs
        key = (_spec(params), _spec(opt_state),
               (idx.shape[1],) + tuple(x.shape[1:]), x.dtype,
               tuple(y.shape[1:]), y.dtype, x.device, traced_flags())
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(params, opt_state,
                                            anchor=self.proximal_mu > 0.0)
        slot.load(slot.params, params)
        slot.load(slot.state, opt_state)
        if slot.anchor is not None:
            slot.load(slot.anchor, gp)
        for bidx in idx:
            loss, acc = self._step(slot, (x[bidx], y[bidx]), x.device)
            losses.append(loss)
            accs.append(acc)
        params = tree_unflatten(slot.ptree, [t.clone() for t in slot.params])
        return params, losses, accs


class EvalStep(_GraphedStep):
    """``(params, batch) -> metrics``: one eager eval step without
    autograd; :meth:`run` evaluates a list of equal-shape batches.  The
    port's counterpart of the reference's jitted ``make_eval_step``.

    On a graph device :meth:`run` copies the params into the static
    params of the batches' shapes key once, then steps each batch
    (:meth:`_GraphedStep._step`).  ``Server.test`` passes new params every
    round: copying them in keeps the graph from round to round, where a
    graph keyed on their storage would capture again every round."""

    _counts = _eval_graphs

    def __init__(self, model: FLModel):
        super().__init__()
        self.model = model

    def __call__(self, params, batch):
        with torch.no_grad():
            _, metrics = self.model.loss_and_metrics(params, batch)
        return metrics

    def _body(self, slot: _Slot, batch):
        m = self(tree_unflatten(slot.ptree, slot.params),
                 {"x": batch[0], "y": batch[1]})
        return m["loss"], m["accuracy"]

    def run(self, params, batches):
        """``batches``: ``(x, y)`` pairs of one shape -> the per-batch
        losses and accuracies as 0-d tensors on the device."""
        xb, yb = batches[0]
        if not self.graphed(xb.device):
            ms = [self(params, {"x": x, "y": y}) for x, y in batches]
            return [m["loss"] for m in ms], [m["accuracy"] for m in ms]
        key = (_spec(params), tuple(xb.shape), xb.dtype, tuple(yb.shape),
               yb.dtype, xb.device, traced_flags())
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(params)
        slot.load(slot.params, params)
        out = [self._step(slot, b, xb.device) for b in batches]
        return [o[0] for o in out], [o[1] for o in out]


@lru_cache(maxsize=64)
def make_client_step(model: FLModel, optimizer: Optimizer,
                     proximal_mu: float = 0.0,
                     max_grad_norm: float = 0.0) -> ClientStep:
    """(params, opt_state, batch, global_params) -> (params, opt_state,
    metrics): the sequential engine's :class:`ClientStep`, one a model and
    hyperparameter set (the optimizer is cached by its hyperparameters
    too), so every client of a task shares its graphs."""
    return ClientStep(model, optimizer, proximal_mu, max_grad_norm)


@lru_cache(maxsize=64)
def make_eval_step(model: FLModel) -> EvalStep:
    """(params, batch) -> metrics: the :class:`EvalStep` of ``model``."""
    return EvalStep(model)


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
    device = tree_leaves(params)[0].device
    with device_lock(device):
        x = torch.as_tensor(data_x, device=device)
        y = torch.as_tensor(data_y, device=device)
        idx = torch.as_tensor(np.concatenate(
            [cyclic_batches(len(data_x), batch_size, seed + e)
             for e in range(epochs)]).astype(np.int64), device=device)
        params, losses, accs = step.run(params, x, y, idx, global_params)
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
    in the reference) and weighted by its true size, so one shape serves
    the whole set."""
    step = make_eval_step(model)
    device = tree_leaves(params)[0].device
    with device_lock(device):
        x = torch.as_tensor(data_x, device=device)
        y = torch.as_tensor(data_y, device=device)
        batches, weights = [], []
        for s in range(0, len(x), batch_size):
            xb, yb = x[s: s + batch_size], y[s: s + batch_size]
            if len(xb) < batch_size:  # pad to the full batch
                pad = batch_size - len(xb)
                xb = torch.cat([xb, xb[:1].expand((pad,) + xb.shape[1:])])
                yb = torch.cat([yb, yb[:1].expand((pad,) + yb.shape[1:])])
            batches.append((xb, yb))
            weights.append(min(batch_size, len(x) - s))
        losses, accs = step.run(params, batches)
        # one transfer for the whole evaluation, after every batch is enqueued
        fetched = torch.stack(losses + accs).cpu().numpy()  # flcheck: ignore[FLC101]  -- single end-of-loop fetch
    w = np.asarray(weights, dtype=np.float64)
    n = len(losses)
    return {"loss": float(np.average(fetched[:n], weights=w)),
            "accuracy": float(np.average(fetched[n:], weights=w))}
