"""Mixture-of-Experts FFN with sort-based (dropping) dispatch.

The reference's ``repro.models.moe``: tokens are sorted by destination
expert (a stable sort) and written into a dense ``(E, C, d)`` buffer, so
the expert FFN is one batched GEMM per projection; an expert's tokens past
its capacity ``C = ceil(T * k * 1.25 / E)`` (rounded up to a multiple of
8) are dropped, and their residual stream passes through.  Router: softmax
-> top-k -> renormalized combine weights (the DeepSeek-V2 / Qwen3
convention); the Switch Transformer's load-balance loss is the ``aux``.
Shared experts are fused into one wide dense FFN.

The expert products are plain ``torch.bmm``: the reference runs them
outside any Pallas kernel too.  ``moe_ffn_expert_parallel`` takes the
reference's expert-parallel route under an ambient mesh with a "model"
axis (``models.sharding``; the dry run's meshes) and :func:`moe_ffn`
without one, as on one card.

**Under vmap.**  The batched engine runs each client's step under
``torch.func.vmap``, so the dispatch uses only ops with batching rules:
the per-expert counts are a one-hot sum over the fixed E (``bincount``
has none), the inverse permutation is ``argsort`` of the sort order (an
in-place write of a batched value into a fresh tensor is refused), and
the buffer is filled with the out-of-place ``index_put``.  For one
client every value equals, bit for bit, what ``bincount`` and an in-place
inverse give (``tests/test_torch_moe_lm.py``).

**Deterministic combine.**  The reference adds each kept (token, expert)
output into its token with a scatter-add, in the sorted (expert-ascending)
order.  On the card ``index_add_`` adds with atomics, in an order that
changes from run to run, so the port gathers a token's k contributions
into a ``(T, k, d)`` tensor in that same expert-ascending order and adds
them one after another.  The dispatch's backward likewise sums each
token's k gradients as a reduction over k (an ``expand``), never with
atomics.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import ParamDef, normal_init
from repro_torch.models.mlp import GATED_ACTS, _act, mlp, mlp_defs


def moe_defs(cfg: ArchConfig):
    m = cfg.moe
    d = cfg.d_model
    de = m.d_expert or cfg.d_ff
    defs = {
        "router": ParamDef((d, m.n_experts), init=normal_init(0.02),
                           axes=("embed", None)),
        "w_up": ParamDef((m.n_experts, d, de),
                         axes=("expert", "embed", "mlp")),
        "w_down": ParamDef((m.n_experts, de, d),
                           axes=("expert", "mlp", "embed")),
    }
    if cfg.act in GATED_ACTS:
        defs["w_gate"] = ParamDef((m.n_experts, d, de),
                                  axes=("expert", "embed", "mlp"))
    if m.n_shared:
        # shared experts fused into one wide FFN (equivalent compute)
        defs["shared"] = mlp_defs(cfg, d_ff=m.n_shared * de)
    return defs


def _router(cfg: ArchConfig, p, x_flat):
    """x_flat: (T, d) -> top-k (weights, ids), probs for the aux loss.

    ``torch.topk`` orders ties arbitrarily on the card (the reference's
    ``top_k`` puts the lower index first); softmax probabilities of random
    activations are vanishingly unlikely to tie."""
    logits = torch.einsum("td,de->te", x_flat.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)   # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_w, top_ids, probs


def load_balance_loss(cfg: ArchConfig, probs, top_ids):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    m = cfg.moe
    T = probs.shape[0]
    counts = _expert_counts(top_ids.reshape(-1), m.n_experts)
    f = counts.to(torch.float32) / (T * m.top_k)  # dispatch fraction
    P_e = probs.mean(dim=0)
    return m.n_experts * torch.sum(f * P_e)


def _expert_counts(flat_e, E: int):
    """Assignments per expert, ``bincount(flat_e, minlength=E)``, as a
    one-hot sum over the fixed E (``bincount`` has no ``vmap`` rule)."""
    return (flat_e.unsqueeze(-1)
            == torch.arange(E, device=flat_e.device)).sum(0)


def capacity(cfg: ArchConfig, n_tokens: int, factor: float = 1.25) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def _dispatch_local(cfg: ArchConfig, x_flat, top_w, top_ids, C: int):
    """Sort-based dispatch of (T, d) tokens into an (E, C, d) buffer.
    Returns (buf, combine_meta); ``combine_meta`` re-gathers the outputs."""
    m = cfg.moe
    T, d = x_flat.shape
    k, E = m.top_k, m.n_experts
    dev = x_flat.device
    flat_e = top_ids.reshape(T * k)                   # destination expert
    flat_w = top_w.reshape(T * k).to(x_flat.dtype)
    order = torch.argsort(flat_e, stable=True)
    sorted_e, sorted_w = flat_e[order], flat_w[order]
    counts = _expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                 # dropped -> slot C
    # the source token of sorted entry i is order[i] // k: gather it from
    # the k-fold expanded tokens (a permutation, so the backward sums the
    # k copies as a reduction, not with atomics)
    src = x_flat.unsqueeze(1).expand(T, k, d).reshape(T * k, d)[order]
    buf = x_flat.new_zeros((E, C + 1, d)).index_put((sorted_e, pos_c), src)
    return buf[:, :C], (order, sorted_e, sorted_w, pos_c, keep)


def _combine_local(meta, out_buf, T: int):
    """(E, C, d) expert outputs -> (T, d): each token's kept outputs,
    weighted, added in ascending expert order (the reference's
    scatter-add order), one after another."""
    order, sorted_e, sorted_w, pos_c, keep = meta
    E, C, d = out_buf.shape
    k = order.numel() // T
    gathered = out_buf[sorted_e, torch.clamp_max(pos_c, C - 1)]
    gathered = gathered * (sorted_w * keep.to(out_buf.dtype))[:, None]
    # sorted position of each (token, slot); sorted along the slots, a
    # token's entries come in ascending expert order
    inv = torch.argsort(order)             # the inverse permutation
    per_token = gathered[inv.view(T, k).sort(dim=1).values]   # (T, k, d)
    out = per_token[:, 0]
    for j in range(1, k):
        out = out + per_token[:, j]
    return out


def _experts(cfg: ArchConfig, p, buf):
    """The expert FFN on an (E, C, d) dispatch buffer: batched GEMMs."""
    dt = buf.dtype
    up = torch.bmm(buf, p["w_up"].to(dt))
    gate = None
    if cfg.act in GATED_ACTS:
        gate = torch.bmm(buf, p["w_gate"].to(dt))
    h = _act(cfg.act, gate, up)
    return torch.bmm(h, p["w_down"].to(dt))


def moe_ffn(cfg: ArchConfig, p, x, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out, aux_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    top_w, top_ids, probs = _router(cfg, p, x_flat)
    aux = load_balance_loss(cfg, probs, top_ids)
    C = capacity(cfg, T, capacity_factor)
    buf, meta = _dispatch_local(cfg, x_flat, top_w, top_ids, C)
    out = _combine_local(meta, _experts(cfg, p, buf), T)
    if m.n_shared:
        out = out + mlp(cfg, p["shared"], x).reshape(T, d)
    return out.reshape(B, S, d), aux


def moe_ffn_expert_parallel(cfg: ArchConfig, p, x,
                            capacity_factor: float = 1.25):
    """The reference's expert-parallel MoE.

    Without an ambient mesh that has a "model" axis (one card), or when
    the experts do not divide over it, this is :func:`moe_ffn`.  Under
    such a mesh (``repro_torch.models.sharding.use_mesh``) it computes
    what the reference's ``shard_map`` body computes on each device: the
    batch split over the ``pod`` / ``data`` axes (whole when it does not
    divide), each shard's tokens padded and split over ``model``, and
    every such group routed on its own, with its own capacity
    ``C_my = ceil(T_my * k * factor / E)`` rounded up to a multiple of 8
    and its own aux loss (their mean is the aux).  The all-to-alls move
    buffers between devices and change no value, so one process runs the
    groups one after another with every expert at hand."""
    from repro_torch.models.sharding import current_mesh

    mesh = current_mesh()
    m = cfg.moe
    sizes = mesh.shape if mesh is not None else {}
    n_model = sizes.get("model", 1)
    if n_model <= 1 or m.n_experts % n_model:
        return moe_ffn(cfg, p, x, capacity_factor)
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    n_batch = 1
    for a in ("pod", "data"):
        n_batch *= sizes.get(a, 1)
    if B % n_batch:
        n_batch = 1                   # tiny decode batches: replicate
    B_loc = B // n_batch
    T_loc = B_loc * S
    T_my = -(-T_loc // n_model)       # ceil; pad if needed
    pad = T_my * n_model - T_loc
    C_my = max(8, -(-int(math.ceil(T_my * k * capacity_factor / E)) // 8)
               * 8)
    outs, auxes = [], []
    for b in range(n_batch):
        xf = x[b * B_loc:(b + 1) * B_loc].reshape(T_loc, d)
        if pad:
            xf = torch.cat([xf, xf.new_zeros((pad, d))])
        ys = []
        for mi in range(n_model):
            x_my = xf[mi * T_my:(mi + 1) * T_my]
            top_w, top_ids, probs = _router(cfg, p, x_my)
            auxes.append(load_balance_loss(cfg, probs, top_ids))
            buf, meta = _dispatch_local(cfg, x_my, top_w, top_ids, C_my)
            ys.append(_combine_local(meta, _experts(cfg, p, buf), T_my))
        outs.append(torch.cat(ys)[:T_loc].reshape(B_loc, S, d))
    out = torch.cat(outs)
    if m.n_shared:
        out = out + mlp(cfg, p["shared"], x)
    return out, torch.stack(auxes).mean()


# impl switch: "global" (baseline) | "expert_parallel"
_IMPL = os.environ.get("REPRO_MOE_IMPL", "global")


def set_moe_impl(name: str) -> None:
    global _IMPL
    assert name in ("global", "expert_parallel"), name
    _IMPL = name


def moe_apply(cfg: ArchConfig, p, x, capacity_factor: float = 1.25):
    if _IMPL == "expert_parallel":
        return moe_ffn_expert_parallel(cfg, p, x, capacity_factor)
    return moe_ffn(cfg, p, x, capacity_factor)
