"""Functional optimizers over parameter dicts.

An :class:`Optimizer` is an (init, update) pair over parameter trees;
``update`` maps (grads, state, params) -> (updates, state); apply with
``apply_updates``.  SGD with momentum 0.9 is the paper's default (§VIII-B).

:class:`TracedOptimizer` is the *vectorizable* twin used by the batched
cohort engine: hyperparameters are not closure constants but a per-client
scalar struct (:class:`SGDHParams` / :class:`AdamWHParams`) passed to
``init``/``update`` as tensors.  Stacked to (N,) vectors and mapped over the
client dimension with ``torch.func.vmap``, one program serves a cohort whose
clients carry *different* momentum / weight decay / nesterov / betas / eps,
with the same operation sequence as the reference's traced optimizers.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    name: str = "optimizer"


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm) -> Tuple[PyTree, torch.Tensor]:
    """``(tree * min(1, max_norm / (norm + 1e-9)), norm)``.  ``max_norm`` is
    a float or an f32 tensor (a per-client scalar under ``vmap``); either
    way the division is tensor by tensor, an IEEE division as in the
    reference (a float divided by a tensor multiplies by its reciprocal)."""
    norm = global_norm(tree)
    if not isinstance(max_norm, torch.Tensor):
        max_norm = torch.full_like(norm, max_norm)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, tree), norm


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (momentum * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(
        init, update,
        f"sgd(lr={lr},m={momentum},wd={weight_decay},nesterov={nesterov})")


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params),
                         torch.zeros((), dtype=torch.int32))

    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, grads)
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(step.dtype)
            return -lr * step

        return tree_map(upd, mu, nu, params), AdamState(mu, nu, count)

    return Optimizer(
        init, update,
        f"adamw(lr={lr},b1={b1},b2={b2},eps={eps},wd={weight_decay})")


# ---------------------------------------------------------------------------
# Traced-hyperparameter variants (per-client vectorization)
# ---------------------------------------------------------------------------


class SGDHParams(NamedTuple):
    """SGD hyperparameters as per-client scalars (or (N,) vectors before
    ``vmap``).  ``nesterov`` is a 0.0/1.0 float so a cohort can mix
    nesterov and plain momentum clients (selected with ``torch.where``)."""

    lr: Any
    momentum: Any
    weight_decay: Any
    nesterov: Any


class AdamWHParams(NamedTuple):
    lr: Any
    b1: Any
    b2: Any
    eps: Any
    weight_decay: Any


@dataclass(frozen=True)
class TracedOptimizer:
    """(init, update) pair whose hyperparameters are tensor arguments.

    ``init(params, hp)`` and ``update(grads, state, params, hp)`` mirror
    :class:`Optimizer` with a trailing hyperparameter struct whose leaves
    are scalars under ``vmap`` (stacked (N,) vectors outside)."""

    init: Callable[[PyTree, Any], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], Tuple[PyTree, PyTree]]
    name: str = "traced_optimizer"


@lru_cache(maxsize=16)
def sgd_traced(use_momentum: bool = True,
               use_nesterov: bool = True) -> TracedOptimizer:
    """SGD with per-client lr / momentum / weight_decay / nesterov.

    ``use_momentum=False`` (every client has momentum 0) drops the momentum
    buffer; ``use_nesterov=False`` skips the nesterov blend."""

    def init(params, hp):
        if not use_momentum:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, hp: SGDHParams):
        grads = tree_map(lambda g, p: g + hp.weight_decay * p.to(g.dtype),
                         grads, params)
        if not use_momentum:
            return tree_map(lambda g: -hp.lr * g, grads), state
        new_m = tree_map(lambda m, g: hp.momentum * m + g, state, grads)
        if use_nesterov:
            upd = tree_map(
                lambda m, g: -hp.lr * torch.where(
                    hp.nesterov > 0, hp.momentum * m + g, m),
                new_m, grads)
        else:
            upd = tree_map(lambda m: -hp.lr * m, new_m)
        return upd, new_m

    return TracedOptimizer(
        init, update,
        f"sgd_traced(momentum={use_momentum},nesterov={use_nesterov})")


@lru_cache(maxsize=16)
def adamw_traced() -> TracedOptimizer:
    """AdamW with per-client lr / b1 / b2 / eps / weight_decay."""

    def init(params, hp):
        return AdamState(tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params),
                         torch.zeros((), dtype=torch.int32,
                                     device=hp.lr.device))

    def update(grads, state, params, hp: AdamWHParams):
        count = state.count + 1
        mu = tree_map(lambda m, g: hp.b1 * m + (1 - hp.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: hp.b2 * v + (1 - hp.b2) * torch.square(g),
                      state.nu, grads)
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(hp.b1, cf)
        bc2 = 1 - torch.pow(hp.b2, cf)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
            step = step + hp.weight_decay * p.to(step.dtype)
            return -hp.lr * step

        return tree_map(upd, mu, nu, params), AdamState(mu, nu, count)

    return TracedOptimizer(init, update, "adamw_traced")


def hparams_from_config(cfg) -> Tuple[str, NamedTuple]:
    """(family, hyperparam struct of Python floats) for a ``ClientConfig``."""
    family = normalize_family(cfg.optimizer)
    if family == "sgd":
        return family, SGDHParams(
            lr=float(cfg.lr), momentum=float(cfg.momentum),
            weight_decay=float(cfg.weight_decay),
            nesterov=1.0 if cfg.nesterov else 0.0)
    return family, AdamWHParams(
        lr=float(cfg.lr), b1=float(cfg.adam_b1), b2=float(cfg.adam_b2),
        eps=float(cfg.adam_eps), weight_decay=float(cfg.weight_decay))


def normalize_family(name: str) -> str:
    if name == "sgd":
        return "sgd"
    if name in ("adam", "adamw"):
        return "adamw"
    raise ValueError(f"unknown optimizer {name!r}")


@lru_cache(maxsize=128)  # shared instance per hyperparameter set
def get_optimizer(name: str, lr: float, momentum: float = 0.9,
                  weight_decay: float = 0.0, nesterov: bool = False,
                  b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Optimizer:
    family = normalize_family(name)
    if family == "sgd":
        return sgd(lr, momentum=momentum, weight_decay=weight_decay,
                   nesterov=nesterov)
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
