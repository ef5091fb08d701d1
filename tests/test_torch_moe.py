"""The port's MoE FFN (``repro_torch.models.moe``) against the reference.

* The five cases of ``tests/test_moe.py`` on the port: the sort-based
  capacity dispatch equals a dense per-expert computation when capacity
  does not bind (SwiGLU, GELU, a shared expert); a tight capacity drops
  tokens; the Switch aux loss is 1 for balanced routing and E for a
  collapsed one; gradients reach the experts and the router.
* ``test_expert_parallel.py::test_expert_parallel_falls_back_without_mesh``:
  without a mesh (one card) the expert-parallel route is ``moe_ffn``.
* ``moe_ffn`` against the reference's on the same parameters and inputs:
  outputs and aux within 1e-6, with the same routing, capacity and dropped
  assignments at the default capacity factor and at a tight one; the
  combine adds a token's contributions in the reference's order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core.config import ArchConfig as RefArch  # noqa: E402
from repro.core.config import MoEConfig as RefMoE  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import init_params as ref_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.config import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.mlp import GATED_ACTS, _act, mlp  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (small tensors; a loaded
    parallel run made torch's default pool much slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_experts=4, top_k=2, n_shared=0, act="swiglu", cls=(ArchConfig,
                                                              MoEConfig)):
    arch, moe = cls
    return arch(
        name="moe-test", family="moe", n_layers=1, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64, act=act,
        moe=moe(n_experts=n_experts, top_k=top_k, n_shared=n_shared,
                d_expert=64))


def _pair(seed=0, **kw):
    """(ref cfg, port cfg, numpy params drawn by the reference)."""
    rc = _cfg(cls=(RefArch, RefMoE), **kw)
    p = jax.tree_util.tree_map(np.asarray, ref_init(
        ref_moe.moe_defs(rc), jax.random.PRNGKey(seed)))
    return rc, _cfg(**kw), p


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _dense_reference(cfg, p, x):
    """Compute every expert densely, combine by renormalized top-k."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    top_w, top_ids, _ = moe_mod._router(cfg, p, xf)
    outs = []
    for e in range(m.n_experts):
        up = xf @ p["w_up"][e]
        gate = xf @ p["w_gate"][e] if cfg.act in GATED_ACTS else None
        outs.append(_act(cfg.act, gate, up) @ p["w_down"][e])
    outs = torch.stack(outs, dim=1)         # (T, E, d)
    y = torch.zeros((T, d))
    for slot in range(m.top_k):
        y = y + top_w[:, slot][:, None] * torch.gather(
            outs, 1, top_ids[:, slot][:, None, None].expand(T, 1, d))[:, 0]
    if m.n_shared:
        y = y + mlp(cfg, p["shared"], x).reshape(T, d)
    return y.reshape(B, S, d)


@pytest.mark.parametrize("act,n_shared", [("swiglu", 0), ("gelu", 0),
                                          ("swiglu", 1)])
def test_moe_matches_dense_reference(act, n_shared):
    _, cfg, p = _pair(act=act, n_shared=n_shared)
    tp = convert.params_from_jax(p)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    out, aux = moe_mod.moe_ffn(cfg, tp, x, capacity_factor=8.0)
    torch.testing.assert_close(out, _dense_reference(cfg, tp, x), rtol=2e-3,
                               atol=2e-4)


def test_moe_capacity_drops_overflow_tokens():
    _, cfg, p = _pair()
    tp = convert.params_from_jax(p)
    x = torch.from_numpy(_x((2, 64, cfg.d_model)))
    full, _ = moe_mod.moe_ffn(cfg, tp, x, capacity_factor=8.0)
    tight, _ = moe_mod.moe_ffn(cfg, tp, x, capacity_factor=0.25)
    assert bool(torch.isfinite(tight).all())
    assert float(torch.linalg.norm(tight)) < float(torch.linalg.norm(full))


def test_router_aux_loss_uniform_when_balanced():
    cfg = _cfg(n_experts=8, top_k=2)
    T, E = 4096, 8
    probs = torch.full((T, E), 1.0 / E)
    ids = torch.stack([torch.arange(T) % E, (torch.arange(T) + 1) % E], 1)
    aux = moe_mod.load_balance_loss(cfg, probs, ids)
    assert float(aux) == pytest.approx(1.0, rel=1e-3)


def test_router_aux_loss_penalizes_collapse():
    cfg = _cfg(n_experts=8, top_k=1)
    T = 1024
    probs = torch.zeros((T, 8))
    probs[:, 0] = 1.0
    aux = moe_mod.load_balance_loss(cfg, probs,
                                    torch.zeros((T, 1), dtype=torch.int64))
    assert float(aux) == pytest.approx(8.0, rel=1e-3)   # E * 1 * 1


def test_moe_gradients_flow_to_experts_and_router():
    _, cfg, p = _pair()
    tp = {k: v.requires_grad_() for k, v in convert.params_from_jax(
        p).items()}
    x = torch.from_numpy(_x((1, 32, cfg.d_model)))
    out, aux = moe_mod.moe_ffn(cfg, tp, x)
    (out.square().sum() + aux).backward()
    assert float(tp["router"].grad.abs().max()) > 0
    assert float(tp["w_up"].grad.abs().max()) > 0


def test_expert_parallel_falls_back_without_mesh():
    _, cfg, p = _pair(n_experts=8)
    tp = convert.params_from_jax(p)
    x = torch.from_numpy(_x((2, 8, 32)))
    ref, _ = moe_mod.moe_ffn(cfg, tp, x)
    out, _ = moe_mod.moe_ffn_expert_parallel(cfg, tp, x)
    assert torch.equal(out, ref)
    moe_mod.set_moe_impl("expert_parallel")
    try:
        out, _ = moe_mod.moe_apply(cfg, tp, x)
    finally:
        moe_mod.set_moe_impl("global")
    assert torch.equal(out, ref)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_reference(factor, n_shared):
    """Outputs and aux within 1e-6 of the reference's; the same routing
    and the same assignments dropped at capacity (at 0.5 some are)."""
    rc, cfg, p = _pair(n_experts=8, top_k=2, n_shared=n_shared, seed=2)
    x = _x((2, 24, 32), seed=3)
    ref_out, ref_aux = ref_moe.moe_ffn(rc, p, jnp.asarray(x), factor)
    tp = convert.params_from_jax(p)
    out, aux = moe_mod.moe_ffn(cfg, tp, torch.from_numpy(x), factor)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=1e-6)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    # routing and drops
    T = 48
    rw, rids, _ = ref_moe._router(rc, p, jnp.asarray(x.reshape(T, 32)))
    w, ids, _ = moe_mod._router(cfg, tp, torch.from_numpy(x.reshape(T, 32)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-7)
    C = moe_mod.capacity(cfg, T, factor)
    assert C == ref_moe.capacity(rc, T, factor)
    _, (_, _, _, _, keep) = moe_mod._dispatch_local(
        cfg, torch.from_numpy(x.reshape(T, 32)), w, ids, C)
    _, (_, _, _, _, ref_keep) = ref_moe._dispatch_local(
        rc, jnp.asarray(x.reshape(T, 32)), rw, rids, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    assert factor >= 1 or not bool(keep.all())
