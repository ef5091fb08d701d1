"""bf16 products with a float32 result, against the reference.

The reference computes three products on bf16 operands with a float32
result (``preferred_element_type=jnp.float32``): the unembedding
(``repro.models.transformer.unembed``), the attention scores
(``repro.models.attention._grouped_scores``) and the decode scores
(``repro.models.transformer._decode_layer``).  The port computes them with
``models.layers.einsum_f32``; until it did, it rounded each product to bf16
before casting it to float32.  At the reduced ``glm4-9b`` set to
``dtype="bfloat16"`` (every other CPU test runs the reduced configs in
float32, where nothing changed):

* each product, on the inputs the port's own forward or decode step hands
  it (spied), within 1e-5 of the largest value of the reference's product;
  the old bf16-rounded product on the same inputs lands farther than 1e-3
  of it;
* ``forward`` logits and decode-step logits through the entry points at
  the same bar, on the zero-depth model (embedding, final norm,
  unembedding).  With layers, other bf16 operations (the SwiGLU MLP's
  bf16 products) round one bf16 ulp apart in XLA and in PyTorch on the
  CPU and put the logits ~1% apart with or without the repair, so depth
  measures those roundings, not the products;
* ``_plain_attention`` on bf16 q, k, v: the output equal within 1e-5 of
  its largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import make_serve_step as ref_serve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as port_tfm  # noqa: E402
from repro_torch.models.model import Model, make_serve_step  # noqa: E402

repro_torch.set_device("cpu")
BAR = 1e-5          # of the largest |value|: the products' own f32 bar
OLD_GAP = 1e-3      # the old bf16-rounded product lands farther than this


def _old(eq, a, b):
    """The port's product before the repair: rounded to bf16 first."""
    return torch.einsum(eq, a, b).to(torch.float32)


def _cfgs(n_layers=None):
    change = {"dtype": "bfloat16"}
    if n_layers is not None:
        change["n_layers"] = n_layers
    return (dataclasses.replace(ref_arch("glm4-9b", reduced=True), **change),
            dataclasses.replace(port_arch("glm4-9b", reduced=True), **change))


def _params(cfg, seed=3, unembed_scale=12.0):
    """numpy parameters at a well-conditioned scale (matrices 1/sqrt(d),
    vectors 0.1), the unembedding scaled up so that |logits| reach ~30-60,
    as the issue's measurement had them."""
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = cfg.d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    p = jax.tree_util.tree_map(draw, RefModel(cfg).defs(),
                               is_leaf=is_paramdef_leaf)
    p["unembed"] = p["unembed"] * unembed_scale
    return p


def _gap(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def test_unembed_keeps_the_float32_product():
    rc, pc = _cfgs()
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 16, rc.d_model)).astype(np.float32)
    w = (rs.standard_normal((rc.d_model, rc.vocab)) * 0.15).astype(
        np.float32)
    ref = np.asarray(ref_tfm.unembed(rc, {"unembed": jnp.asarray(w)},
                                     jnp.asarray(x, jnp.bfloat16)))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w)
    got = port_tfm.unembed(pc, {"unembed": wt}, xt)
    assert got.dtype == torch.float32
    assert _gap(got.numpy(), ref) <= BAR
    old = _old("bsd,dv->bsv", xt, wt.bfloat16()).numpy()
    assert _gap(old, ref) > OLD_GAP


def _spy(monkeypatch, module):
    """Record every (eq, a, b, result) ``module.einsum_f32`` computes."""
    seen = []

    def spy(eq, a, b):
        out = layers.einsum_f32(eq, a, b)
        seen.append((eq, a.detach().clone(), b.detach().clone(),
                     out.detach().clone()))
        return out
    monkeypatch.setattr(module, "einsum_f32", spy)
    return seen


def _hold_products(seen, what):
    assert seen, f"no {what} product was computed"
    for eq, a, b, out in seen:
        ref = np.asarray(jnp.einsum(
            eq, *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (a, b)),
            preferred_element_type=jnp.float32))
        assert _gap(out.numpy(), ref) <= BAR, (what, eq)
        assert _gap(_old(eq, a, b).numpy(), ref) > OLD_GAP, (what, eq)


def test_forward_scores_and_unembed_products_on_the_forwards_inputs(
        monkeypatch):
    rc, pc = _cfgs()
    tp = convert.params_from_jax(_params(rc), "cpu")
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, rc.vocab, (2, 24)))
    seen_attn = _spy(monkeypatch, port_attn)
    seen_tfm = _spy(monkeypatch, port_tfm)
    Model(pc).forward(tp, tokens)
    assert len(seen_attn) == rc.n_layers and len(seen_tfm) == 1
    _hold_products(seen_attn, "attention scores")
    _hold_products(seen_tfm, "unembedding")


def test_decode_scores_product_on_the_decode_steps_inputs(monkeypatch):
    rc, pc = _cfgs()
    tp = convert.params_from_jax(_params(rc), "cpu")
    model = Model(pc)
    cache = model.init_cache(2, 8)
    step = make_serve_step(model)
    tok = np.random.RandomState(5).randint(0, rc.vocab, (2, 4))
    seen = _spy(monkeypatch, port_tfm)
    for t in range(4):
        step(tp, cache, torch.from_numpy(tok[:, t:t + 1]), t)
    scores = [s for s in seen if s[0] == "bqkgd,bskd->bkgqs"]
    assert len(scores) == 4 * rc.n_layers
    _hold_products(scores[-rc.n_layers:], "decode scores")


def test_zero_depth_forward_and_decode_logits_match_the_reference():
    rc, pc = _cfgs(n_layers=0)
    params = _params(rc)
    tp = convert.params_from_jax(params, "cpu")
    tok = np.random.RandomState(4).randint(0, rc.vocab, (2, 24)).astype(
        np.int32)
    ref = np.asarray(ref_tfm.forward(rc, params, jnp.asarray(tok),
                                     remat=False)[0])
    got = port_tfm.forward(pc, tp, torch.from_numpy(tok))[0]
    assert got.dtype == torch.float32 and np.abs(ref).max() > 30
    assert _gap(got.numpy(), ref) <= BAR

    rcache = RefModel(rc).init_cache(2, 8)
    pmodel = Model(pc)
    pcache = pmodel.init_cache(2, 8)
    rstep, pstep = jax.jit(ref_serve(RefModel(rc))), make_serve_step(pmodel)
    for t in range(3):
        rl, rcache = rstep(params, rcache, jnp.asarray(tok[:, t:t + 1]),
                           jnp.asarray(t, jnp.int32))
        pl, pcache = pstep(tp, pcache, torch.from_numpy(tok[:, t:t + 1]), t)
        assert _gap(pl.numpy(), rl) <= BAR, t


def test_plain_attention_at_bf16_matches_the_reference():
    rs = np.random.RandomState(6)
    q = rs.standard_normal((2, 24, 2, 2, 32)).astype(np.float32)
    k, v = (rs.standard_normal((2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    mask = np.tril(np.ones((24, 24), bool))
    ref = ref_attn._plain_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask))
    got = port_attn._plain_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert _gap(got.float().numpy(), np.asarray(ref, np.float32)) <= BAR
    scores = layers.einsum_f32(
        "bqkgd,bskd->bkgqs", *(torch.from_numpy(a).bfloat16() for a in (q, k)))
    want = ref_attn._grouped_scores(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k)))
    assert _gap(scores.numpy(), want) <= BAR


def test_float32_operands_take_the_plain_einsum_bit_for_bit():
    rs = np.random.RandomState(7)
    a = torch.from_numpy(rs.standard_normal((2, 5, 8)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((8, 11)).astype(np.float32))
    assert torch.equal(layers.einsum_f32("bsd,dv->bsv", a, b),
                       torch.einsum("bsd,dv->bsv", a, b))


@pytest.mark.parametrize("eq,sa,sb", [
    ("bsd,dv->bsv", (2, 5, 8), (8, 11)),
    ("bqkgd,bskd->bkgqs", (2, 3, 2, 4, 8), (2, 6, 2, 8)),
])
def test_card_route_layout_and_backward_equations(monkeypatch, eq, sa, sb):
    """The card's route without the card: ``_bmm_f32`` permutes and
    reshapes to one batched product and back (``bmm.dtype`` replaced by a
    float32 ``bmm`` of the upcast operands, which is what it computes),
    and ``_BF16ProductF32``'s backward equals autograd through the upcast
    product, rounded to bf16."""
    real_bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: real_bmm(
        a.float(), b.float()))
    rs = np.random.RandomState(8)
    a = torch.from_numpy(rs.standard_normal(sa).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.standard_normal(sb).astype(np.float32)).bfloat16()
    want = torch.einsum(eq, a.float(), b.float())
    assert torch.equal(layers._bmm_f32(eq, a, b), want)
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = layers._BF16ProductF32.apply(eq, ar, br)
    g = torch.from_numpy(rs.standard_normal(tuple(out.shape)).astype(
        np.float32))
    ga, gb = torch.autograd.grad(out, (ar, br), g)
    a32, b32 = a.float().requires_grad_(), b.float().requires_grad_()
    wa, wb = torch.autograd.grad(torch.einsum(eq, a32, b32), (a32, b32), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa.bfloat16()) and torch.equal(gb, wb.bfloat16())
