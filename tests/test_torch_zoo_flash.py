"""Flash attention at the zoo's head dims above 128 against the reference.

* The plain versions of K6/K7 (what the ops run on a CPU tensor, and what
  ``chip_smoke.py`` phase 3b holds the CUDA kernels to on the card) against
  the reference's Pallas kernels in interpret mode at D 192 (Nemotron-4),
  200 (a ragged D padded to 256) and 256 (PaliGemma, RecurrentGemma), S 40
  and 130, causal and not: forward within 1e-5, gradients within 1e-4 —
  the bars ``tests/test_torch_attention.py`` holds D <= 128 to.
* The CUDA wrappers' shape check takes D <= 256 and refuses 257 by name.
* ``_flash_gqa`` routes the reduced Nemotron-4's and PaliGemma's grouped
  attention into the flash op with the reference's shapes and the same
  logits; MLA (DeepSeek-V2-Lite) and windowed attention (RecurrentGemma's
  ``local_attn``) never reach it, in either package.
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
from repro.models import attention as ref_attention  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.kernels import attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.model import Model, make_prefill_step  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (see tests/test_torch_zoo.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [192, 200, 256])
@pytest.mark.parametrize("s", [40, 130])
def test_flash_plain_matches_reference_kernel_above_d128(s, d, causal):
    rs = np.random.RandomState(s * 10 + d + causal)
    q, k, v = (rs.standard_normal((2, s, d)).astype(np.float32)
               for _ in range(3))

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


@pytest.mark.parametrize("d", [128, 192, 256, 257])
def test_the_kernels_take_head_dims_up_to_256(d):
    """The shape check comes first: up to 256 a meta tensor passes it and
    is refused only for its device; 257 is refused by name."""
    q = torch.empty((2, 8, d), device="meta")
    if d <= flash.MAX_HEAD_DIM:
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            flash._check("flash_fwd", q, q, q)
    else:
        with pytest.raises(ValueError, match="D <= 256"):
            flash._check("flash_fwd", q, q, q)
    assert flash.MAX_HEAD_DIM == 256


def scaled_params(cfg, seed=3):
    """numpy parameters at a well-conditioned scale (matrices 1/sqrt(
    d_model), vectors 0.1; tests/test_torch_zoo.py)."""
    from repro.models.layers import is_paramdef_leaf
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = cfg.d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map(draw, RefModel(cfg).defs(),
                                  is_leaf=is_paramdef_leaf)


def _spy(monkeypatch, module, calls):
    real = module.flash_attention

    def spy(q, k, v, *args, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, *args, **kw)
    monkeypatch.setattr(module, "flash_attention", spy)


@pytest.mark.parametrize("arch,layers,flashed", [
    ("nemotron-4-340b", 0, True), ("paligemma-3b", 0, True),
    ("deepseek-v2-lite-16b", 0, False), ("recurrentgemma-9b", 3, False)])
def test_flash_gqa_routes_as_the_reference(arch, layers, flashed,
                                           monkeypatch):
    rc, pc = ref_arch(arch, reduced=True), port_arch(arch, reduced=True)
    if layers:
        rc, pc = (dataclasses.replace(c, n_layers=layers) for c in (rc, pc))
    params = scaled_params(rc)
    rs = np.random.RandomState(1)
    S = 80 if layers else 24       # past RecurrentGemma's window of 64
    tokens = rs.randint(0, rc.vocab, (2, S)).astype(np.int32)
    frames = (rs.standard_normal((2, rc.n_frames, rc.d_model)).astype(
        np.float32) if rc.family == "vlm" else None)
    ref_calls, port_calls = [], []
    _spy(monkeypatch, ref_ops, ref_calls)
    _spy(monkeypatch, ops, port_calls)
    ref_attention.set_flash_attention(True)
    port_attention.set_flash_attention(True)
    try:
        rl, _ = RefModel(rc).forward(params, jnp.asarray(tokens),
                                     None if frames is None
                                     else jnp.asarray(frames))
        batch = {"tokens": torch.from_numpy(tokens)}
        if frames is not None:
            batch["frames"] = torch.from_numpy(frames)
        logits = make_prefill_step(Model(pc))(
            convert.params_from_jax(params), batch)
    finally:
        ref_attention.set_flash_attention(None)
        port_attention.set_flash_attention(None)
    # the reference traces a segment's scan body once; the port calls the
    # op once a layer
    assert set(port_calls) == set(ref_calls)
    assert len(port_calls) == (pc.n_layers if flashed else 0)
    scale = float(np.abs(np.asarray(rl)).max())
    assert float(np.abs(np.asarray(rl) - logits.numpy()).max()) <= \
        1e-5 * scale
