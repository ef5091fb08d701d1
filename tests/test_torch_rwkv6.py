"""The port's RWKV6 against the reference (``repro.models.rwkv6``,
``repro.kernels``), on the same numpy-seeded inputs with the reference's
parameters injected (``repro_torch.convert.params_from_jax``).

* ``rwkv_defs`` / ``model_defs`` trees: the same leaf paths and shapes.
* The WKV6 kernel's plain version (what ``ops.wkv6`` runs on a CPU tensor)
  against the reference's Pallas kernel in interpret mode and against the
  sequential ``ref.wkv6_ref``, at the reference's own bar (1e-3); the
  port's copy of the sequential oracle against the reference's.  The plain
  version is the CUDA kernel's sub-chunked arithmetic: against the port's
  exact pairwise ``wkv6_chunked`` (1e-5 of the scale); its serial f32
  cumsum against a float64 run beside the exact form's; and with its
  products emulated in 3xTF32 (operands, and the MMAs' accumulation)
  against a float64 run.
* ``time_mix`` (both ``use_kernel`` values), ``time_mix_decode`` and
  ``channel_mix`` at the reduced config: f32 within 1e-4; bf16 within 2e-3
  plus one bf16 ulp of the output's largest magnitude (2^-7 of it) — the
  reference's bf16 sigmoid rounds its intermediates to bf16 on XLA's CPU
  backend and lands up to 2^-8 from the correctly rounded sigmoid on about
  a third of the elements
  (``test_reference_bf16_sigmoid_is_not_correctly_rounded``), so no
  correctly rounded bf16 program meets 2e-3 alone at outputs of magnitude
  ~1.  The f32 recurrence state is held at 1e-4 at either dtype.
* The whole reduced ``rwkv6-1.6b`` (f32, B 2, S 70): ``Model.forward``
  logits within 1e-4; the no-grad forward (WKV6 kernel) and the grad-mode
  forward (``wkv6_chunked``) agree, and the routing is what the
  ``models/transformer`` docstring says.

The CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import rwkv6 as ref_rwkv  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.layers import init_params as ref_init  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.kernels import ops, rwkv6_scan  # noqa: E402
from repro_torch.models import rwkv6 as port_rwkv  # noqa: E402
from repro_torch.models import transformer as port_tfm  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, TrainState, make_prefill_step, make_train_step,
)
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

repro_torch.set_device("cpu")

BF16_ULP = 2.0 ** -7           # one bf16 ulp, relative, at a binade's bottom


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return dict(zip(tree_paths(tree), (tuple(d.shape)
                                        for d in tree_leaves(tree))))


def _ref_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=is_paramdef_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(d.shape) for path, d in flat}


@pytest.mark.parametrize("reduced", [True, False])
def test_rwkv_defs_match_reference(reduced):
    ref = _ref_shapes(ref_rwkv.rwkv_defs(ref_arch("rwkv6-1.6b", reduced)))
    port = _shapes(port_rwkv.rwkv_defs(port_arch("rwkv6-1.6b", reduced)))
    assert port == ref


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b"])
def test_model_defs_match_reference(arch, reduced):
    ref = _ref_shapes(ref_tfm.model_defs(ref_arch(arch, reduced)))
    port = _shapes(port_tfm.model_defs(port_arch(arch, reduced)))
    assert port == ref


def test_published_rwkv6_size():
    """1.6 B parameters at the published width and depth, nothing cut."""
    cfg = port_arch("rwkv6-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.rwkv_head_dim) == (24, 2048, 7168, 65536, 64)
    n = sum(int(np.prod(s)) for s in _shapes(port_tfm.model_defs(cfg))
            .values())
    assert 1.5e9 < n < 1.7e9


def _wkv_inputs(B, T, H, hd, seed, nonzero_s0):
    rs = np.random.RandomState(seed)
    r, k, v = (rs.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    # the model's decay: -exp(clip(w0 + lora, -8, 6)) around w0 = -0.6
    logw = -np.exp(np.clip(rs.standard_normal((B, T, H, hd)) - 0.6,
                           -8.0, 6.0)).astype(np.float32)
    u = (0.3 * rs.standard_normal((H, hd))).astype(np.float32)
    s0 = (rs.standard_normal((B, H, hd, hd)).astype(np.float32)
          if nonzero_s0 else np.zeros((B, H, hd, hd), np.float32))
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("nonzero_s0", [False, True])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("T", [64, 192])
def test_wkv6_plain_matches_reference_kernel_and_oracle(T, hd, nonzero_s0):
    args = _wkv_inputs(2, T, 2, hd, seed=T + hd + nonzero_s0,
                       nonzero_s0=nonzero_s0)
    jargs = [jnp.asarray(a) for a in args]
    ky, ks = ref_ops.wkv6(*jargs, interpret=True)
    oy, os_ = ref_oracles.wkv6_ref(*jargs)
    y, s = ops.wkv6(*map(torch.from_numpy, args))          # plain (CPU)
    for got, want in ((y, ky), (s, ks), (y, oy), (s, os_)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)
    qy, qs = rwkv6_scan.wkv6_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(qy.numpy(), np.asarray(oy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(qs.numpy(), np.asarray(os_), rtol=1e-4,
                               atol=1e-4)


def test_wkv6_plain_stays_finite_under_strong_decay():
    """log w at the clip (-exp(6)) and near 0 in turn: the log-space gates
    never overflow.  (Under such decays the f32 cumulative sums lose the
    small steps' digits, so the chunked results — the reference's as the
    port's — move by up to ~1e-2 with the summation order; only
    finiteness is a property of the algorithm here.)"""
    r, k, v, _, u, s0 = _wkv_inputs(1, 128, 2, 16, seed=3, nonzero_s0=True)
    logw = np.full_like(r, -np.exp(6.0))
    logw[:, ::3] = -np.exp(-8.0)
    y, s = rwkv6_scan.wkv6_plain(*map(torch.from_numpy,
                                      (r, k, v, logw, u, s0)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def _scaled_err(got, want):
    """max |got - want| over max(1, max |want|), in float64."""
    want = want.double()
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("nonzero_s0", [False, True])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("T", [64, 192])
def test_wkv6_subchunked_plain_matches_exact_chunked_form(T, hd, nonzero_s0):
    """The plain version (the CUDA kernel's sub-chunked arithmetic: exact
    gates within a 16-step sub-chunk, factored products across them, cw
    added serially in f32) against the model's exact pairwise
    ``wkv6_chunked`` at the model's decays: within 1e-5 of each output's
    scale (both take cwx = cw - log w; they differ by the factored blocks'
    f32 rounding, ~2e-7, and, on the CPU, by the cumsum's: torch.cumsum
    adds in double there, ~2e-6)."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(
        2, T, 3, hd, seed=7 * T + hd + nonzero_s0, nonzero_s0=nonzero_s0)]
    y, s = rwkv6_scan.wkv6_plain(*args)
    cy, cs = port_rwkv.wkv6_chunked(*args)
    assert _scaled_err(y, cy) <= 1e-5
    assert _scaled_err(s, cs) <= 1e-5


@pytest.mark.parametrize("B,T,H,hd", [(2, 512, 4, 64), (2, 192, 3, 16)])
def test_wkv6_serial_cumsum_keeps_the_plain_version_near_float64(B, T, H,
                                                                 hd):
    """The plain version (and the kernel) add cw serially in f32, so each
    gate's exponent cw[t-1] - cw[s] carries only the roundings of the steps
    between s and t.  Against a float64 run it is no farther than the exact
    form, whose ``torch.cumsum`` on the CPU rounds each cw once from a
    double sum — an error of half an ulp of |cw| on every difference,
    however short."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(
        B, T, H, hd, seed=3 * T + hd, nonzero_s0=True)]
    ey, es = port_rwkv.wkv6_chunked(*(a.double() for a in args))
    cy, cs = port_rwkv.wkv6_chunked(*args)
    py, ps = rwkv6_scan.wkv6_plain(*args)
    assert _scaled_err(py, ey) <= _scaled_err(cy, ey)
    assert _scaled_err(ps, es) <= _scaled_err(cs, es)


def _rz32(x64):
    """float64 -> float32 rounded toward zero."""
    x = x64.float()
    return torch.where(x.double().abs() > x64.abs(),
                       torch.nextafter(x, torch.zeros_like(x)), x)


def _matmul_3xtf32_mma(a, b):
    """The kernel's 3xTF32 products as its MMAs accumulate them: k-steps of
    8, each step's products summed exactly, the small terms into an
    accumulator of their own and big.big into another, each rounded toward
    zero per MMA (the tensor core's accumulation does not round to
    nearest), the two added in fp32 at the end.  (The kernel chains y's
    two products into one accumulator; here each is its own chain.)"""
    from test_torch_attention import _tf32_nearest, _tf32_truncated
    ab, bb = _tf32_nearest(a), _tf32_nearest(b)
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    lo = torch.zeros_like(acc)
    for k0 in range(0, a.shape[-1], 8):
        def step(x, y):
            return x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
        lo = _rz32(lo + step(as_, bb) + step(ab, bs)).double()
        acc = _rz32(acc + step(ab, bb)).double()
    return acc.float() + lo.float()


def _matmul_3xtf32(a, b):
    from test_torch_attention import _mm_3xtf32
    return _mm_3xtf32("...ij,...jk->...ik", a, b)


def _check_3xtf32(B, T, H, hd, mm):
    args = [torch.from_numpy(a) for a in _wkv_inputs(
        B, T, H, hd, seed=T + hd, nonzero_s0=True)]
    ey, es = port_rwkv.wkv6_chunked(*(a.double() for a in args))
    cy, cs = port_rwkv.wkv6_chunked(*args)
    my, ms = rwkv6_scan.wkv6_plain(*args, matmul=mm)
    assert _scaled_err(my, ey) <= 2 * _scaled_err(cy, ey)
    assert _scaled_err(ms, es) <= 2 * _scaled_err(cs, es)
    logw = torch.full_like(args[3], -float(np.exp(6.0)))
    logw[:, ::3] = -float(np.exp(-8.0))
    args[3] = logw
    my, ms = rwkv6_scan.wkv6_plain(*args, matmul=mm)
    assert torch.isfinite(my).all() and torch.isfinite(ms).all()


@pytest.mark.parametrize("B,T,H,hd", [(2, 512, 4, 64), (2, 192, 3, 16)])
def test_wkv6_3xtf32_products_keep_the_kernel_at_fp32_accuracy(B, T, H, hd):
    """The sub-chunked form with its four products in 3xTF32 as the kernel
    splits its operands (``tests/test_torch_attention.py``'s emulation,
    summed in fp32 einsum: the operand split only) against a float64 run
    of the exact form: within twice the f32 exact form's own distance from
    float64, output by output; finite at the clip."""
    _check_3xtf32(B, T, H, hd, _matmul_3xtf32)


@pytest.mark.parametrize("B,T,H,hd", [(2, 512, 4, 64), (2, 192, 3, 16)])
def test_wkv6_3xtf32_mma_accumulation_keeps_the_kernel_at_fp32_accuracy(
        B, T, H, hd):
    """As above with the MMAs' accumulation modelled too
    (``_matmul_3xtf32_mma``: k-steps of 8, rounded toward zero)."""
    _check_3xtf32(B, T, H, hd, _matmul_3xtf32_mma)


def _time_params(dtype_name):
    rc = dataclasses.replace(ref_arch("rwkv6-1.6b", reduced=True),
                             dtype=dtype_name)
    pc = dataclasses.replace(port_arch("rwkv6-1.6b", reduced=True),
                             dtype=dtype_name)
    params = _np_tree(ref_init(ref_rwkv.rwkv_defs(rc), jax.random.PRNGKey(0)))
    return rc, pc, params, convert.params_from_jax(params, "cpu")


def _mixer_inputs(cfg, S, seed=1):
    rs = np.random.RandomState(seed)
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    x = (0.5 * rs.standard_normal((2, S, D))).astype(np.float32)
    x_prev = (0.5 * rs.standard_normal((2, D))).astype(np.float32)
    s0 = (0.1 * rs.standard_normal(
        (2, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim))).astype(np.float32)
    return x, x_prev, s0


def _close(got, want, dtype_name):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-3 + BF16_ULP * np.abs(want).max(), err


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [64, 70])
def test_time_mix_matches_reference(S, use_kernel, dtype_name):
    rc, pc, params, tp = _time_params(dtype_name)
    x, x_prev, s0 = _mixer_inputs(rc, S)
    jdt, tdt = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    ro, rl, rs = ref_rwkv.time_mix(
        rc, params["time"], jnp.asarray(x).astype(jdt),
        jnp.asarray(x_prev).astype(jdt), jnp.asarray(s0),
        use_kernel=use_kernel)
    po, pl, ps = port_rwkv.time_mix(
        pc, tp["time"], torch.from_numpy(x).to(tdt),
        torch.from_numpy(x_prev).to(tdt), torch.from_numpy(s0),
        use_kernel=use_kernel)
    _close(po, ro, dtype_name)
    np.testing.assert_array_equal(pl.float().numpy(),
                                  np.asarray(rl, np.float32))
    # the recurrence runs in f32 at either activation dtype
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_time_mix_decode_and_channel_mix_match_reference(dtype_name):
    rc, pc, params, tp = _time_params(dtype_name)
    x, x_prev, s0 = _mixer_inputs(rc, 5, seed=2)
    jdt, tdt = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    jx, jp = jnp.asarray(x).astype(jdt), jnp.asarray(x_prev).astype(jdt)
    tx, tpv = torch.from_numpy(x).to(tdt), torch.from_numpy(x_prev).to(tdt)
    ro, _, rS = ref_rwkv.time_mix_decode(rc, params["time"], jx[:, :1], jp,
                                         jnp.asarray(s0))
    po, _, pS = port_rwkv.time_mix_decode(pc, tp["time"], tx[:, :1], tpv,
                                          torch.from_numpy(s0))
    _close(po, ro, dtype_name)
    np.testing.assert_allclose(pS.numpy(), np.asarray(rS), rtol=1e-4,
                               atol=1e-4)
    ro, rl = ref_rwkv.channel_mix(rc, params["channel"], jx, jp)
    po, pl = port_rwkv.channel_mix(pc, tp["channel"], tx, tpv)
    _close(po, ro, dtype_name)
    np.testing.assert_array_equal(pl.float().numpy(),
                                  np.asarray(rl, np.float32))


def test_reference_bf16_sigmoid_is_not_correctly_rounded():
    """Why the bf16 bar carries one bf16 ulp: the reference's bf16 sigmoid
    (XLA on the CPU) rounds exp(-x) and 1 + exp(-x) to bf16 before the
    division, and so lands up to 2^-8 from the correctly rounded sigmoid —
    the port's — on about a third of the elements."""
    x = (2.0 * np.random.RandomState(0).standard_normal(4096)).astype(
        np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jax.nn.sigmoid(jnp.asarray(x).astype(jnp.bfloat16)),
                     np.float32)

    def bf16(t):
        return t.to(torch.bfloat16).float()
    stepwise = bf16(1.0 / bf16(1.0 + bf16(torch.exp(-xb.float()))))
    np.testing.assert_array_equal(stepwise.numpy(), ref)
    port = torch.sigmoid(xb).float().numpy()
    np.testing.assert_array_equal(port, bf16(torch.sigmoid(xb.float())))
    gap = np.abs(port - ref)
    assert (gap > 0).mean() > 0.2 and gap.max() <= 2.0 ** -8


def _model_pair(arch, seed=0):
    rc = ref_arch(arch, reduced=True)
    pc = port_arch(arch, reduced=True)
    params = _np_tree(RefModel(rc).init(jax.random.PRNGKey(seed)))
    return RefModel(rc), Model(pc), params, convert.params_from_jax(
        params, "cpu")


def test_rwkv6_forward_matches_reference():
    ref_model, model, params, tp = _model_pair("rwkv6-1.6b")
    tokens = np.random.RandomState(4).randint(
        0, model.cfg.vocab, (2, 70)).astype(np.int32)
    ref_logits, _ = ref_model.forward(params, jnp.asarray(tokens))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, aux = model.forward(tp, t)           # WKV6 kernel path
    with torch.enable_grad():
        chunked, _ = model.forward(tp, t)            # wkv6_chunked path
    assert logits.shape == (2, 70, model.cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(chunked.detach().numpy(), logits.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_prefill_routes_through_the_wkv6_kernel_and_training_does_not(
        monkeypatch):
    _, model, _, tp = _model_pair("rwkv6-1.6b")
    calls = []
    real = ops.wkv6

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return real(*args)
    monkeypatch.setattr(ops, "wkv6", spy)
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, model.cfg.vocab, (1, 20)))
    make_prefill_step(model)(tp, {"tokens": tokens})
    assert calls == [False] * model.cfg.n_layers
    tp["embed"].requires_grad_()
    logits, _ = model.forward(tp, tokens)
    logits.sum().backward()
    assert calls == [False] * model.cfg.n_layers      # no kernel with grad
    assert torch.isfinite(tp["embed"].grad).all()


def test_training_entry_points_raise_naming_m9():
    """The train step and input specs are ported (ROADMAP M9's first zoo
    items): an RWKV6 train step runs and moves the params.  A family with a
    ``frames`` input once raised naming M9 here; it is ported since, and
    the VLM's frame prefix and text-region loss now match the
    reference's."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.optim import sgd
    model = Model(port_arch("rwkv6-1.6b", reduced=True))
    opt = sgd(0.1)
    params = model.init(torch.Generator().manual_seed(0))
    state, metrics = make_train_step(model, opt)(
        TrainState(params, opt.init(params), torch.zeros((),
                                                         dtype=torch.int32)),
        {"tokens": torch.from_numpy(np.random.RandomState(1).randint(
            0, model.cfg.vocab, (2, 16)))})
    assert torch.isfinite(metrics["loss"]) and int(state.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(state.params)))
    assert tuple(model.input_specs(SHAPES["train_4k"])["tokens"].shape) == \
        (256, 4096)
    ref_vlm = RefModel(dataclasses.replace(ref_arch("glm4-9b", reduced=True),
                                           family="vlm", n_frames=4))
    vlm = Model(dataclasses.replace(port_arch("glm4-9b", reduced=True),
                                    family="vlm", n_frames=4))
    vparams = _np_tree(ref_vlm.init(jax.random.PRNGKey(2)))
    rs = np.random.RandomState(3)
    batch = {"tokens": rs.randint(0, vlm.cfg.vocab, (1, 6)).astype(np.int32),
             "frames": rs.standard_normal((1, 4, 256)).astype(np.float32)}
    ref_logits, _ = ref_vlm.forward(vparams, jnp.asarray(batch["tokens"]),
                                    jnp.asarray(batch["frames"]))
    tp = convert.params_from_jax(vparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = vlm.forward(tp, tb["tokens"], frames=tb["frames"])
    assert logits.shape == (1, 4 + 6, vlm.cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-4, atol=1e-4)
    ref_loss, _ = ref_vlm.loss(vparams, jax.tree_util.tree_map(jnp.asarray,
                                                               batch))
    loss, _ = vlm.loss(tp, tb)
    assert abs(float(loss) - float(ref_loss)) <= 1e-4
