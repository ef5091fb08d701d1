"""Flash attention and the transformer of the port against the reference.

* The plain versions of the three ported kernels (forward; dQ and dK/dV)
  against the reference's Pallas flash attention in interpret mode (as
  ``tests/test_attention_kernel.py`` runs it): forward within 1e-5,
  gradients within 1e-4 (fp32, different summation order).
* The ``torch.library`` ops through ``torch.func.vmap(torch.func.grad(...))``
  equal autograd through the plain function, and the vmap rule folds the
  vmapped dimension into BH (one call serves the whole cohort).
* ``transformer.forward`` logits (1e-5) and parameter gradients (1e-4)
  against the reference for ``tiny_lm`` and the reduced GLM-4-9B (GQA with
  G = 2, head_dim 32), with the flash flag on and off.

The CUDA kernels themselves are checked on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import attention as flash  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")


def _qkv(bh, s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 20, 32])
@pytest.mark.parametrize("s", [16, 70, 128])
@pytest.mark.parametrize("bh", [2, 6])
def test_flash_plain_matches_reference_kernel(bh, s, d, causal):
    q, k, v = _qkv(bh, s, d, seed=bh * 1000 + s * 10 + d + causal)

    def ref_loss(q, k, v):
        out = ref_ops.flash_attention(q[None], k[None], v[None],
                                      causal=causal)[0]
        return jnp.sum(jnp.sin(out)), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray,
                                                        (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash.flash_fwd_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-5)
    grads = flash.flash_bwd_plain(tq, tk, tv, o, lse, torch.cos(o), causal)
    for g, e, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("k_batched", [True, False])
def test_flash_op_under_vmap_grad_folds_clients(monkeypatch, causal,
                                                k_batched):
    n, b, h, s, d = 3, 2, 2, 70, 20
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.standard_normal((n, b, h, s, d))
                                .astype(np.float32)) for _ in range(3))
    if not k_batched:
        k = k[0]
    seen = []
    plain_fwd = flash.flash_fwd_plain
    monkeypatch.setattr(flash, "flash_fwd_plain", lambda *a: (
        seen.append(tuple(a[0].shape)), plain_fwd(*a))[1])

    def loss(attend):
        return lambda q, k, v: torch.sin(attend(q, k, v)).sum()

    def materialized(q, k, v):
        qf, kf, vf = (x.reshape(b * h, s, d) for x in (q, k, v))
        return plain_fwd(qf, kf, vf, causal)[0].reshape(b, h, s, d)

    in_dims = (0, 0 if k_batched else None, 0)
    got = torch.func.vmap(torch.func.grad(
        loss(lambda q, k, v: flash.flash_attention(q, k, v, causal)),
        argnums=(0, 1, 2)), in_dims=in_dims)(q, k, v)
    exp = torch.func.vmap(torch.func.grad(loss(materialized),
                                          argnums=(0, 1, 2)),
                          in_dims=in_dims)(q, k, v)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5)
    assert seen == [(n * b * h, s, d)]        # one call for the cohort
    # plain autograd (no transforms) goes through the same backward op
    qa = q[0].clone().requires_grad_()
    torch.sin(flash.flash_attention(qa, k if not k_batched else k[0], v[0],
                                    causal)).sum().backward()
    torch.testing.assert_close(qa.grad, got[0][0], rtol=1e-5, atol=1e-5)


def test_flash_op_fake_shapes_and_lse_is_not_differentiable():
    q = torch.empty((4, 70, 20), device="meta")
    o, lse = flash.flash_fwd(q, q, q, True)
    assert o.shape == (4, 70, 20) and lse.shape == (4, 70)
    x = torch.randn(2, 3, 16, 8, requires_grad=True)
    out = flash.flash_attention(x, x, x)
    assert out.requires_grad and out.shape == x.shape


# ---------------------------------------------------------------------------
# the CUDA kernels' 3xTF32 precision scheme, emulated on the CPU
# ---------------------------------------------------------------------------


def _tf32_nearest(x):
    """x rounded to TF32 to nearest, ties away from zero: add half a TF32
    ulp (1 << 12) to the fp32 bit pattern and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """x truncated to TF32, as an MMA reads an fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    """einsum with each operand split as the kernels split it: big = x
    rounded to TF32, small = x - big (exact) truncated to TF32 by the MMA;
    small.big + big.small, then big.big (small.small is dropped).  Products
    of TF32 values are exact in fp32."""
    a_big, b_big = _tf32_nearest(a), _tf32_nearest(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return ((torch.einsum(eq, a_small, b_big)
             + torch.einsum(eq, a_big, b_small))
            + torch.einsum(eq, a_big, b_big))


def _mm_1xtf32(eq, a, b):
    """One TF32 product: what the tensor cores give without the split."""
    return torch.einsum(eq, _tf32_nearest(a), _tf32_nearest(b))


def _flash_fwd_emulated(q, k, v, causal, mm, tile=64):
    """The forward kernel's algebra: an online softmax over key tiles
    (``tile`` keys each), the running max and denominator, every product
    through ``mm``."""
    bh, s, d = q.shape
    scale = 1.0 / np.sqrt(d)
    visible = flash._mask(s, causal, q.device)
    m = torch.full((bh, s), flash.NEG_INF)
    l = torch.zeros((bh, s))
    acc = torch.zeros((bh, s, d))
    for k0 in range(0, s, tile):
        kk, vv = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        ok = visible[:, k0:k0 + tile]
        sc = mm("bqd,bkd->bqk", q, kk) * scale
        m_new = torch.maximum(m, torch.where(ok, sc, flash.NEG_INF)
                              .amax(dim=-1))
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm("bqk,bkd->bqd", p, vv)
        m = m_new
    li = torch.clamp_min(l, flash._TINY)
    return acc / li[..., None], m + torch.log(li)


def _flash_bwd_emulated(q, k, v, do, lse, delta, causal, mm):
    """The backward kernels' algebra: P = exp(s - LSE), dS = P (dP - delta)
    scale, dQ = dS K, dK = dS^T Q, dV = P^T dO, every product through
    ``mm``."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    visible = flash._mask(q.shape[1], causal, q.device)
    p = torch.where(visible, torch.exp(
        mm("bqd,bkd->bqk", q, k) * scale - lse[..., None]), 0.0)
    ds = p * (mm("bqd,bkd->bqk", do, v) - delta[..., None]) * scale
    return (mm("bqk,bkd->bqd", ds, k), mm("bqk,bqd->bkd", ds, q),
            mm("bqk,bqd->bkd", p, do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [20, 128])
@pytest.mark.parametrize("s", [70, 200])
def test_3xtf32_products_keep_the_flash_kernels_within_their_bars(s, d,
                                                                  causal):
    """The 3xTF32 scheme — operands split as the kernels split them, bit
    for bit — stays within chip_smoke phase 3b's bars of the plain fp32
    versions (1e-5 on O and LSE, 1e-4 on dQ, dK, dV); one TF32 product
    alone misses the forward bar at D 128, which is why the operands are
    split.  The three products are summed by fp32 einsum: this checks the
    scheme, not the kernels' accumulation (their separate small-term and
    per-tile accumulators, the tensor core's own rounding), which the card
    tests and chip_smoke phase 3b hold."""
    rs = np.random.RandomState(s + d + causal)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((2, s, d))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = _flash_fwd_emulated(q, k, v, causal, _mm_3xtf32)
    po, plse = flash.flash_fwd_plain(q, k, v, causal)
    assert (o - po).abs().max().item() <= 1e-5
    assert (lse - plse).abs().max().item() <= 1e-5
    delta = (do * po).sum(dim=-1)
    grads = _flash_bwd_emulated(q, k, v, do, plse, delta, causal, _mm_3xtf32)
    want = (flash.flash_dq_plain(q, k, v, do, plse, delta, causal),
            *flash.flash_dkv_plain(q, k, v, do, plse, delta, causal))
    for got, exp in zip(grads, want):
        assert (got - exp).abs().max().item() <= 1e-4
    if d == 128:
        o1, _ = _flash_fwd_emulated(q, k, v, causal, _mm_1xtf32)
        assert (o1 - po).abs().max().item() > 1e-5


def _mm_3xtf32_pair(eq, a, b):
    """``_mm_3xtf32`` with the head-dim products (S = Q K^T, dP = dO V^T)
    taken as the three pair kernels take them above D 128 (the forward's
    S, dQ's S and dP, dK/dV's S^T and dP^T): each warp of a pair over its
    half of the padded head dim (DP / 2 = 96 or 128 columns, the second
    half ragged below DP), the two partials added, lo + hi, by either warp
    (the same sum bit for bit: fp32 addition commutes)."""
    if eq != "bqd,bkd->bqk":
        return _mm_3xtf32(eq, a, b)
    dc = (192 if a.shape[-1] <= 192 else 256) // 2
    lo = _mm_3xtf32(eq, a[..., :dc], b[..., :dc])
    hi = _mm_3xtf32(eq, a[..., dc:], b[..., dc:])
    assert torch.equal(lo + hi, hi + lo)
    return lo + hi


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [136, 193, 200, 256])
@pytest.mark.parametrize("s", [70, 200])
def test_3xtf32_pair_split_keeps_the_wide_flash_kernels_within_their_bars(
        s, d, causal):
    """Above D 128 the forward, dQ and dK/dV kernels split each score
    product's head dim between the two warps of a pair and add the
    partials: with 3xTF32 operands that stays within the bars of the plain
    fp32 versions (1e-5 on O and LSE, 1e-4 on dQ, dK, dV), at a ragged
    second half (D 136, 200; D 193, one column past DP 256's first half)
    and a full one (256)."""
    rs = np.random.RandomState(s + d + causal)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((2, s, d))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = _flash_fwd_emulated(q, k, v, causal, _mm_3xtf32_pair)
    po, plse = flash.flash_fwd_plain(q, k, v, causal)
    assert (o - po).abs().max().item() <= 1e-5
    assert (lse - plse).abs().max().item() <= 1e-5
    delta = (do * po).sum(dim=-1)
    grads = _flash_bwd_emulated(q, k, v, do, plse, delta, causal,
                                _mm_3xtf32_pair)
    want = (flash.flash_dq_plain(q, k, v, do, plse, delta, causal),
            *flash.flash_dkv_plain(q, k, v, do, plse, delta, causal))
    for got, exp in zip(grads, want):
        assert (got - exp).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# transformer forward and gradients against the reference
# ---------------------------------------------------------------------------


def _models(name):
    if name == "tiny_lm":
        from repro.models.llm import tiny_lm as ref_tiny
        from repro_torch.models.llm import tiny_lm as port_tiny
        return ref_tiny(), port_tiny()
    from repro.configs import get_arch as ref_arch
    from repro.models.llm import transformer_lm as ref_lm
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models.llm import transformer_lm as port_lm
    return (ref_lm(ref_arch(name, reduced=True)),
            port_lm(port_arch(name, reduced=True)))


def _params(model, d_model, seed):
    """numpy parameters at a well-conditioned scale: matrices with std
    1/sqrt(d_model), vectors (norm scales) with std 0.1.  (The default
    init of the (d, H, hd) projections has fan-in H, which makes attention
    scores of order 1e3 and the comparison a test of softmax saturation.)"""
    from repro.models.layers import is_paramdef_leaf
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map(draw, model.defs, is_leaf=is_paramdef_leaf)


@pytest.mark.parametrize("flash_on", [False, True])
@pytest.mark.parametrize("name", ["tiny_lm", "glm4-9b"])
def test_transformer_matches_reference(name, flash_on):
    ref_model, port_model = _models(name)
    d_model = ref_model.defs["embed"].shape[1]
    params = _params(ref_model, d_model, seed=3)
    tokens = np.random.RandomState(4).randint(
        0, ref_model.num_classes, (2, 24)).astype(np.int32)
    batch = {"x": tokens, "y": tokens}
    ref_attention.set_flash_attention(flash_on)
    port_attention.set_flash_attention(flash_on)
    try:
        ref_logits = ref_model.apply(params, jnp.asarray(tokens))
        ref_grads = jax.grad(
            lambda p: ref_model.loss_and_metrics(
                p, jax.tree_util.tree_map(jnp.asarray, batch))[0])(params)
        tp = convert.params_from_jax(params)
        logits = port_model.apply(tp, torch.from_numpy(tokens))
        grads = torch.func.grad(lambda p: port_model.loss_and_metrics(
            p, {k: torch.from_numpy(v) for k, v in batch.items()})[0])(tp)
    finally:
        ref_attention.set_flash_attention(None)
        port_attention.set_flash_attention(None)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(ref_leaves) == len(tree_leaves(grads))
    for g, e in zip(tree_leaves(grads), ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-4)


def test_chunked_attention_matches_reference_beyond_one_chunk():
    """S > q_chunk: the query-blocked path (no flash) against the
    reference's, with grouped heads."""
    rs = np.random.RandomState(5)
    q = rs.standard_normal((2, 48, 2, 3, 8)).astype(np.float32)
    k, v = (rs.standard_normal((2, 48, 2, 8)).astype(np.float32)
            for _ in range(2))
    ref = ref_attention.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), q_chunk=16)
    got = port_attention.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["nemotron-4-340b", "paligemma-3b",
                                  "deepseek-v2-lite-16b"])
def test_unported_archs_raise_naming_m9(name):
    """These ids once raised naming M9; ported since, they resolve with the
    reference's fields, and the reduced model's logits, flash flag on (the
    kernels' plain versions here), match the reference's."""
    import dataclasses
    import types

    from repro.configs import get_arch as ref_arch
    from repro.models.model import Model as RefModel
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(ref_arch(name))
    rc, pc = ref_arch(name, reduced=True), get_arch(name, reduced=True)
    params = _params(types.SimpleNamespace(defs=RefModel(rc).defs()),
                     rc.d_model, seed=3)
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, rc.vocab, (2, 24)).astype(np.int32)
    frames = (rs.standard_normal((2, rc.n_frames, rc.d_model)).astype(
        np.float32) if rc.family == "vlm" else None)
    ref_attention.set_flash_attention(True)
    port_attention.set_flash_attention(True)
    try:
        ref_logits, _ = RefModel(rc).forward(
            params, jnp.asarray(tokens),
            None if frames is None else jnp.asarray(frames))
        logits, _ = Model(pc).forward(
            convert.params_from_jax(params), torch.from_numpy(tokens),
            None if frames is None else torch.from_numpy(frames))
    finally:
        ref_attention.set_flash_attention(None)
        port_attention.set_flash_attention(None)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
