"""Model facade: ties an ArchConfig to its parameter defs, forward, loss,
decode steps, input specs and the train step.

The layer the drivers program against: ``repro_torch.launch.train``
(:class:`TrainStep` over ``Model.loss``), ``repro_torch.core.federated``
(the cross-pod round) and ``repro_torch.launch.serve`` (``make_prefill_step``
and ``make_serve_step``, both under ``torch.no_grad()``, so an RWKV6 model's
prefill and decode take the WKV6 kernel: ``models/transformer``).  On a
card the serve step is one CUDA graph for every position (:class:`ServeStep`),
as the reference compiles ``make_serve_step`` once with a traced position;
the prefill step stays eager, as the reference compiles it only in the dry
run.

A train step is ``(state, batch) -> (state, metrics)`` as in the reference:
autograd takes the gradients of ``Model.loss`` with respect to every
parameter leaf, then the ported optimizer's ``update`` and
``apply_updates``.  :func:`make_train_step` makes a new :class:`TrainState`
(the input state is not modified): the federated round (per-pod views of
its pod-stacked state) and the dry run (fake tensors) call it.
:class:`TrainStep`, which ``launch.train`` drives, is the reference's
``jax.jit(make_train_step(...), donate_argnums=(0,))``: it writes the new
state into the old state's storage and, on a card, is one CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.core.config import ArchConfig
from repro_torch.models import kvcache as kvc
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.utils.capture import (
    CaptureCounts, CapturedGraph, traced_flags,
)
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _default_device(device):
    if device is None:
        from repro_torch.kernels.ops import get_device
        device = get_device()
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- parameters -------------------------------------------------
    def defs(self):
        return tfm.model_defs(self.cfg)

    def init(self, gen: torch.Generator,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` on its own device, then moved to
        ``device`` (default: :func:`repro_torch.get_device`)."""
        return init_params(self.defs(), gen, _default_device(device))

    # ---- compute ----------------------------------------------------
    def forward(self, params, tokens, frames=None, remat=False):
        """``(logits, aux)``."""
        return tfm.forward(self.cfg, params, tokens, frames=frames,
                           remat=remat)

    def loss(self, params, batch, remat=True):
        """``(loss, {"nll", "aux"})``."""
        return tfm.loss_fn(self.cfg, params, batch, remat=remat)

    def decode_step(self, params, cache, tokens, pos, ring=False):
        """``(logits, cache)``, the cache updated in place; ``pos`` a 0-d
        integer tensor on the cache's device or a Python int."""
        return tfm.decode_step(self.cfg, params, cache, tokens, pos,
                               ring=ring)

    def init_cache(self, batch, length, ring=False, device=None):
        return tfm.init_cache(self.cfg, batch, length, ring,
                              _default_device(device))

    def cache_specs(self, batch, length, ring=False):
        return tfm.cache_specs(self.cfg, batch, length, ring)

    # ---- input specs ------------------------------------------------
    def text_len(self, shape: InputShape) -> int:
        # VLM: patch stubs occupy part of the global sequence budget
        if self.cfg.family == "vlm" and shape.kind != "decode":
            return max(shape.seq_len - self.cfg.n_frames, 16)
        return shape.seq_len

    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Meta-tensor stand-ins (shape and dtype, no storage) for every
        model input, with the reference's shapes and dtypes."""
        cfg = self.cfg
        B = shape.global_batch
        dt = getattr(torch, cfg.dtype)
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": kvc.spec((B, self.text_len(shape)),
                                        torch.int32)}
            if cfg.family in ("vlm", "audio"):
                specs["frames"] = kvc.spec((B, cfg.n_frames, cfg.d_model),
                                           dt)
            return specs
        # decode: one new token + cache of seq_len capacity
        ring = shape.seq_len > 65_536  # long-context uses windowed cache
        return {
            "tokens": kvc.spec((B, 1), torch.int32),
            "pos": kvc.spec((), torch.int32),
            "cache": self.cache_specs(B, shape.seq_len, ring=ring),
        }

    def make_inputs(self, shape: InputShape, gen: torch.Generator,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Concrete inputs matching :meth:`input_specs`: tokens and frames
        drawn from ``gen`` (on its own device), the cache zeros, all on
        ``device`` (default: :func:`repro_torch.get_device`)."""
        device = _default_device(device)
        specs = self.input_specs(shape)
        out: Dict[str, Any] = {}
        if "tokens" in specs:
            out["tokens"] = torch.randint(
                0, self.cfg.vocab, specs["tokens"].shape, generator=gen,
                device=gen.device, dtype=torch.int32).to(device)
        if "frames" in specs:
            out["frames"] = torch.randn(
                specs["frames"].shape, generator=gen,
                device=gen.device).to(device, specs["frames"].dtype)
        if "cache" in specs:
            out["cache"] = kvc.zeros_like_specs(specs["cache"], device)
            out["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                      device=device)
        return out


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: Any        # 0-d int32 tensor


class _OneGraphStep:
    """What :class:`ServeStep` and :class:`TrainStep` share: one CUDA graph
    a step object (:class:`repro_torch.utils.capture.CapturedGraph`,
    counted by the class's ``_counts``), valid for a ``(shapes, storage)``
    key.  The first call at a ``shapes`` key runs eagerly (the warm-up:
    cuBLAS's, cuDNN's and the allocator's first use), the next one
    captures and replays, every later one replays; a call whose
    ``storage`` moved captures again at once, after the old graph and its
    private pool are freed.  A capture or replay that fails raises;
    nothing falls back to an eager step.  Steps run eagerly on devices not
    in ``graph_device_types`` (the CPU, where no graph exists) and with
    ``capture=False`` (the eager side of an A/B).

    ``captures``, ``recaptures`` (captures after the first), ``replays``
    and ``eager_steps`` count this object's calls."""

    #: device types whose steps run as a graph (the CPU tests stand a
    #: recording graph in for the CUDA one on "cpu")
    graph_device_types = ("cuda",)
    _counts: CaptureCounts

    def __init__(self, capture: bool):
        self.capture = capture
        self._graph = None          # (shapes, storage, CapturedGraph)
        self._warm = set()          # shapes keys that ran their warm-up
        self.captures = self.recaptures = self.replays = 0
        self.eager_steps = 0

    def graphed(self, device: torch.device) -> bool:
        """Whether this step runs as a graph on ``device``."""
        return self.capture and device.type in self.graph_device_types

    def _graph_step(self, key, run, inputs, device, static=None):
        """``run(inputs)`` at ``key`` = ``(shapes, storage)``: eagerly (the
        key's warm-up), or by the graph of ``run`` (captured from
        ``static``, default ``inputs``: its static buffers' first values)
        with ``inputs`` copied into its static buffers."""
        held = self._graph
        if held is not None and held[:2] == key:
            self.replays += 1
            return held[2](inputs)
        if key[0] not in self._warm:
            self._warm.add(key[0])
            self.eager_steps += 1
            return run(inputs)                          # the warm-up
        if held is not None:
            self.recaptures += 1
        # the old graph and its private pool go first
        self._graph = held = None
        graph = CapturedGraph(run, inputs if static is None else static,
                              device, self._counts)
        self.captures += 1
        self._graph = (*key, graph)
        self.replays += 1
        return graph(inputs)


def _step_updates(model: Model, optimizer: Optimizer, remat: bool):
    """(state, batch) -> (updates, new optimizer state, metrics): one
    step's gradients and optimizer update, what both train steps share."""

    def updates_of(state: TrainState, batch):
        leaves, treedef = tree_flatten(state.params)
        live = [t.detach().requires_grad_() for t in leaves]
        loss, metrics = model.loss(tree_unflatten(treedef, live), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = tree_unflatten(treedef, [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)])
        del live
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return updates, opt_state, metrics

    return updates_of


def make_train_step(model: Model, optimizer: Optimizer, remat: bool = True):
    """(state, batch) -> (state, metrics), ``metrics`` = the loss's
    ``{"nll", "aux"}`` plus ``"loss"``, all detached 0-d tensors; a new
    :class:`TrainState`, eager (:class:`TrainStep` is the donating,
    captured form)."""
    updates_of = _step_updates(model, optimizer, remat)

    def step(state: TrainState, batch):
        updates, opt_state, metrics = updates_of(state, batch)
        with torch.no_grad():
            params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


_train_graphs = CaptureCounts()


def train_capture_count() -> int:
    """CUDA-graph captures of a train step this process (every
    :class:`TrainStep`'s, recaptures included)."""
    return _train_graphs.captures


def train_replay_count() -> int:
    """CUDA-graph replays of a train step this process: one a captured
    step (the capturing call included)."""
    return _train_graphs.replays


def train_key(state: TrainState, batch, remat: bool):
    """``(shapes, storage)``: what a captured train step is valid for.
    ``shapes``: ``remat``, the tree structure, shape and dtype of every
    state leaf and batch leaf, and the flags the step reads as it runs
    (:func:`~repro_torch.utils.capture.traced_flags`); ``storage``: the
    address and strides of every state leaf, which the graph reads and
    writes in place."""
    s, stree = tree_flatten((state.params, state.opt_state, state.step))
    b, btree = tree_flatten(batch)
    shapes = (remat, repr(stree), repr(btree),
              tuple((tuple(t.shape), t.dtype) for t in s + b),
              traced_flags())
    storage = tuple((t.data_ptr(), t.stride()) for t in s)
    return shapes, storage


class TrainStep(_OneGraphStep):
    """``(state, batch) -> (state, metrics)``: :func:`make_train_step`'s
    step with the state donated, the port's ``jax.jit(make_train_step(
    model, opt), donate_argnums=(0,))``.  The new params, optimizer state
    and step count are written into the input state's own tensors — the
    params by adding the optimizer's updates in place (``p + u`` as
    ``apply_updates`` computes it), the optimizer state and the step by
    one ``torch._foreach_copy_`` — and the same :class:`TrainState` comes
    back: the same values as :func:`make_train_step`'s, bit for bit, in
    the same storage every step.

    On a CUDA device (the tokens') with ``capture`` on, the step is one
    CUDA graph (:class:`_OneGraphStep`, keyed by :func:`train_key`).  Only
    the batch is copied into the graph's static buffers; the graph reads
    and writes the state in its storage, so a state in other storage
    captures again at once.  The metrics come back as copies.
    Process-wide counts: :func:`train_capture_count`,
    :func:`train_replay_count`."""

    _counts = _train_graphs

    def __init__(self, model: Model, optimizer: Optimizer,
                 remat: bool = True, capture: bool = True):
        super().__init__(capture)
        self.model = model
        self.remat = remat
        self._updates = _step_updates(model, optimizer, remat)

    def _donated(self, state: TrainState, batch):
        """One step written into ``state``'s tensors -> metrics."""
        updates, opt_state, metrics = self._updates(state, batch)
        with torch.no_grad():
            params = tree_flatten(state.params)[0]
            torch._foreach_add_(params, [
                u.to(p.dtype) for p, u in zip(params,
                                              tree_flatten(updates)[0])])
            del updates
            torch._foreach_copy_(
                tree_flatten((state.opt_state, state.step))[0],
                tree_flatten((opt_state, state.step + 1))[0])
        return metrics

    def __call__(self, state: TrainState, batch):
        device = batch["tokens"].device
        if not self.graphed(device):
            self.eager_steps += 1
            return state, self._donated(state, batch)
        return state, self._graph_step(
            train_key(state, batch, self.remat),
            lambda b: self._donated(state, b), batch, device)


def make_prefill_step(model: Model):
    """(params, batch) -> logits, the full-sequence forward without
    autograd."""
    def step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch["tokens"],
                                      frames=batch.get("frames"))
        return logits
    return step


_serve_graphs = CaptureCounts()


def serve_capture_count() -> int:
    """CUDA-graph captures of a serve step this process (every
    :class:`ServeStep`'s, recaptures included)."""
    return _serve_graphs.captures


def serve_replay_count() -> int:
    """CUDA-graph replays of a serve step this process: one a captured
    decode step (the capturing call included)."""
    return _serve_graphs.replays


def serve_key(params, cache, tokens, ring: bool):
    """``(shapes, storage)``: what a captured decode step is valid for.
    ``shapes``: ``ring``, the token batch's shape and dtype, the tree
    structure, shape and dtype of every param and cache leaf, and the
    flags the step reads as it runs
    (:func:`~repro_torch.utils.capture.traced_flags`); ``storage``:
    the address and strides of every param and cache leaf, which the graph
    reads (the params) and writes (the cache) in place."""
    p, ptree = tree_flatten(params)
    c, ctree = tree_flatten(cache)
    leaves = p + c
    shapes = (ring, tuple(tokens.shape), tokens.dtype, repr(ptree),
              repr(ctree), tuple((tuple(t.shape), t.dtype) for t in leaves),
              traced_flags())
    storage = tuple((t.data_ptr(), t.stride()) for t in leaves)
    return shapes, storage


class ServeStep(_OneGraphStep):
    """``(params, cache, tokens, pos) -> (logits, cache)``: one decode step
    without autograd, the cache updated in place and returned as the same
    object; the port's ``jax.jit(make_serve_step(model, ring=...),
    donate_argnums=(1,))``.

    On a CUDA device (``tokens``' device) with ``capture`` on, the step is
    one CUDA graph that serves every position (:class:`_OneGraphStep`,
    keyed by :func:`serve_key`).  Only ``tokens`` and ``pos`` are copied
    into the graph's static buffers (a Python ``pos`` by a device
    ``fill_``, a tensor by a device copy: no host sync either way); the
    graph reads the caller's params and writes the caller's cache in their
    own storage — the counterpart of donating the cache — so a new cache
    or new params (another ``storage`` key) recapture at once.  The logits
    come back as a copy.  Process-wide counts: :func:`serve_capture_count`,
    :func:`serve_replay_count`."""

    _counts = _serve_graphs

    def __init__(self, model: Model, ring: bool = False,
                 capture: bool = True):
        super().__init__(capture)
        self.model = model
        self.ring = ring

    def _decode(self, params, cache, tokens, pos):
        with torch.no_grad():
            return self.model.decode_step(params, cache, tokens, pos,
                                          ring=self.ring)

    def __call__(self, params, cache, tokens, pos):
        device = tokens.device
        if not self.graphed(device):
            self.eager_steps += 1
            return self._decode(params, cache, tokens, pos)
        if isinstance(pos, torch.Tensor) and pos.device != device:
            pos = int(pos)              # a host value: filled, not copied
        logits = self._graph_step(
            serve_key(params, cache, tokens, self.ring),
            lambda s: self._decode(params, cache, s[0], s[1])[0],
            (tokens, pos), device, static=(tokens, kvc.as_pos(pos, device)))
        return logits, cache


def make_serve_step(model: Model, ring: bool = False,
                    capture: bool = True) -> ServeStep:
    """(params, cache, tokens, pos) -> (logits, cache), one decode step
    without autograd (the cache is updated in place): a
    :class:`ServeStep`, one CUDA graph for every position on a card."""
    return ServeStep(model, ring, capture)


def init_train_state(model: Model, optimizer: Optimizer, gen: torch.Generator,
                     device: Optional[torch.device] = None) -> TrainState:
    params = model.init(gen, device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_flatten(params)[0][0].device)
    return TrainState(params, optimizer.init(params), step)

