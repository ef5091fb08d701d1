"""The rest of the model zoo in the port against the reference: Nemotron-4
(squared ReLU, LayerNorm, head dim 192), PaliGemma (GeGLU, tied embeddings,
the ``frames`` prefix and its text-region loss), DeepSeek-V2-Lite (MLA and
its latent cache, the MoE with shared experts after a ``dense0`` layer),
RecurrentGemma (RG-LRU, local attention and its ring cache) and Whisper
(encoder, cross-attention, learned positions).

* ``model_defs`` paths and shapes equal the reference's for all ten ids at
  full size (shapes only: nothing is materialized).
* Per new arch at ``reduced()`` size (RecurrentGemma also at 3 layers, so
  that ``local_attn`` is present, at a sequence past its window), f32, the
  reference's parameters injected at a well-conditioned scale (matrices
  1/sqrt(d_model), vectors 0.1; the default init of the (d, H, hd)
  projections saturates the softmax): forward logits within 1e-5 of max
  |logit|, loss and aux within 1e-4; 12 decode steps against the
  reference's ``decode_step`` on the same cache (logits and the final
  caches within 1e-4; linear and ring caches, MLA's latent cache, the
  RG-LRU state, Whisper with a non-zero ``enc_kv``); one SGD-momentum
  train step, params within 1e-5.
* ``rglru_block`` / ``rglru_decode`` against the reference's.  The port's
  scan doubles over S (Hillis-Steele) where the reference's
  ``associative_scan`` recurses over odd and even positions: the same
  products in another order, held within 2e-6 of the output's scale
  (float32 rounding of up to log2(S) composed decays), and both within
  that of a float64 sequential recurrence.
* ``chunked_causal_attention(window=...)`` against the reference at the
  cases of ``tests/test_attention.py::test_chunked_equals_plain``; MLA's
  absorbed decode against its decompressed form
  (``tests/test_attention.py::test_mla_absorbed_decode_matches_training_form``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.core.config import ArchConfig as RefArch  # noqa: E402
from repro.core.config import MLAConfig as RefMLA  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models.layers import init_params as ref_init  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import TrainState as RefState  # noqa: E402
from repro.models.model import make_serve_step as ref_serve_step  # noqa: E402
from repro.models.model import make_train_step as ref_step  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core.config import ArchConfig, MLAConfig  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import rglru as port_rglru  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, TrainState, make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

repro_torch.set_device("cpu")

NEW = ["nemotron-4-340b", "paligemma-3b", "deepseek-v2-lite-16b",
       "recurrentgemma-9b", "recurrentgemma-9b+local", "whisper-small"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made such runs some 20x
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **changes):
    """(reference, port) reduced configs; ``+local``: RecurrentGemma at 3
    layers (rglru, rglru, local_attn)."""
    base = arch.split("+")[0]
    rc, pc = ref_arch(base, reduced=True), port_arch(base, reduced=True)
    if arch.endswith("+local"):
        changes = {"n_layers": 3, **changes}
    return (dataclasses.replace(rc, **changes),
            dataclasses.replace(pc, **changes))


def scaled_params(cfg, seed=3):
    """numpy parameters at a well-conditioned scale: matrices with std
    1/sqrt(d_model), vectors with std 0.1."""
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = cfg.d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map(draw, RefModel(cfg).defs(),
                                  is_leaf=is_paramdef_leaf)


def _inputs(cfg, B, S, seed):
    """tokens (B, S) and, for the VLM and audio families, frames (B, F,
    d_model) from a numpy seed."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        out["frames"] = rs.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _seq(arch):
    # RecurrentGemma at 3 layers: past its reduced window of 64
    return 80 if arch.endswith("+local") else 24


def _max_diff(ref_tree, port_tree):
    ref = jax.tree_util.tree_leaves(ref_tree)
    port = tree_leaves(port_tree)
    assert len(ref) == len(port)
    return max(float(np.abs(np.asarray(a, np.float32)
                            - b.detach().float().numpy()).max())
               for a, b in zip(ref, port))


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=is_paramdef_leaf)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


@pytest.mark.parametrize("arch", list_archs())
def test_model_defs_match_reference_at_full_size(arch):
    """Tree paths and shapes for every id at its published size, and the
    config field for field the reference's."""
    assert dataclasses.asdict(port_arch(arch)) == \
        dataclasses.asdict(ref_arch(arch))
    ref_defs = RefModel(ref_arch(arch)).defs()
    port_defs = Model(port_arch(arch)).defs()
    assert tree_paths(port_defs) == _ref_paths(ref_defs)
    assert [tuple(d.shape) for d in tree_leaves(port_defs)] == [
        tuple(d.shape) for d in jax.tree_util.tree_leaves(
            ref_defs, is_leaf=is_paramdef_leaf)]


@pytest.mark.parametrize("arch", NEW)
def test_forward_and_loss_match_reference(arch):
    rc, pc = _cfgs(arch)
    params = scaled_params(rc)
    batch = _inputs(rc, 2, _seq(arch), 1)
    rlogits, raux = jax.jit(lambda p, b: RefModel(rc).forward(
        p, b["tokens"], b.get("frames")))(params, batch)
    tp = convert.params_from_jax(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = make_prefill_step(Model(pc))(tp, tb)
    scale = float(np.abs(np.asarray(rlogits)).max())
    assert float(np.abs(np.asarray(rlogits) - logits.numpy()).max()) <= \
        1e-5 * scale
    rl, rm = jax.jit(lambda p, b: RefModel(rc).loss(p, b))(params, batch)
    pl, pm = Model(pc).loss(tp, tb)
    assert abs(float(rl) - float(pl)) <= 1e-4
    for k in ("nll", "aux"):
        assert abs(float(rm[k]) - float(pm[k])) <= 1e-4, k
    if rc.family == "vlm":       # the loss reads the text region only
        assert logits.shape[1] == rc.n_frames + batch["tokens"].shape[1]


DECODE = {  # id -> (arch, ring, config changes)
    "nemotron": ("nemotron-4-340b", False, {}),
    "paligemma": ("paligemma-3b", False, {}),
    "deepseek-linear": ("deepseek-v2-lite-16b", False, {}),
    "deepseek-ring": ("deepseek-v2-lite-16b", True, {"decode_window": 8}),
    # a window of 8 makes local attention's ring cache wrap in 12 steps
    "recurrentgemma": ("recurrentgemma-9b+local", False, {"window": 8}),
    "whisper": ("whisper-small", False, {}),
}


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_steps_match_reference(case):
    arch, ring, changes = DECODE[case]
    rc, pc = _cfgs(arch, **changes)
    params = scaled_params(rc)
    B, steps, length = 2, 12, 16
    toks = _inputs(rc, B, steps, 2)["tokens"]
    ref_cache = RefModel(rc).init_cache(B, length, ring=ring)
    if rc.encoder_layers:        # a non-zero enc_kv, the same in both
        rs = np.random.RandomState(5)
        ref_cache["enc_kv"] = {k: jnp.asarray(rs.standard_normal(
            v.shape).astype(np.float32)) for k, v in ref_cache["enc_kv"].items()}
    cache = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_cache))
    ref_step_fn = jax.jit(ref_serve_step(RefModel(rc), ring=ring))
    step = make_serve_step(Model(pc), ring=ring)
    tp = convert.params_from_jax(params)
    for t in range(steps):
        rl, ref_cache = ref_step_fn(params, ref_cache, toks[:, t:t + 1],
                                    jnp.asarray(t, jnp.int32))
        lg, cache = step(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
    assert _max_diff(ref_cache, cache) <= 1e-4


@pytest.mark.parametrize("arch", NEW)
def test_train_step_matches_reference(arch):
    rc, pc = _cfgs(arch)
    params = scaled_params(rc)
    batch = _inputs(rc, 2, _seq(arch), 4)
    ropt, popt = ref_opt.sgd(0.05, momentum=0.9), port_opt.sgd(0.05,
                                                               momentum=0.9)
    rstate = RefState(params, ropt.init(params), jnp.zeros((), jnp.int32))
    rstate, rmetrics = jax.jit(ref_step(RefModel(rc), ropt))(
        rstate, jax.tree_util.tree_map(jnp.asarray, batch))
    tp = convert.params_from_jax(params)
    state = TrainState(tp, popt.init(tp), torch.zeros((), dtype=torch.int32))
    state, metrics = make_train_step(Model(pc), popt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - float(rmetrics["loss"])) <= 1e-4
    assert _max_diff(rstate.params, state.params) <= 1e-5


# ---------------------------------------------------------------------------
# the modules on their own
# ---------------------------------------------------------------------------


def _rglru_pair(width=48):
    rc = dataclasses.replace(ref_arch("recurrentgemma-9b", reduced=True),
                             d_model=32, lru_width=width)
    pc = dataclasses.replace(port_arch("recurrentgemma-9b", reduced=True),
                             d_model=32, lru_width=width)
    p = jax.tree_util.tree_map(np.asarray, ref_init(
        ref_rglru.rglru_defs(rc), jax.random.PRNGKey(7)))
    return rc, pc, p, convert.params_from_jax(p)


@pytest.mark.parametrize("S", [1, 7, 200])
def test_rglru_block_matches_reference(S):
    """The full-sequence block from a non-zero state, then decode steps from
    its state, against the reference; the scan's order differs (module
    docstring): 2e-6 of the output's scale."""
    rc, pc, p, tp = _rglru_pair()
    rs = np.random.RandomState(S)
    x = rs.standard_normal((2, S, 32)).astype(np.float32)
    state = {"h": rs.standard_normal((2, 48)).astype(np.float32),
             "conv": rs.standard_normal((2, 3, 48)).astype(np.float32)}
    rout, rstate = jax.jit(lambda p, x, s: ref_rglru.rglru_block(
        rc, p, x, s))(p, x, state)
    out, st = port_rglru.rglru_block(pc, tp, torch.from_numpy(x),
                                     convert.params_from_jax(state))
    scale = max(1.0, float(np.abs(np.asarray(rout)).max()))
    assert float(np.abs(np.asarray(rout) - out.numpy()).max()) <= 2e-6 * scale
    assert _max_diff(rstate, st) <= 2e-6
    xs = rs.standard_normal((2, 5, 32)).astype(np.float32)
    for t in range(5):
        rout, rstate = ref_rglru.rglru_decode(rc, p, xs[:, t:t + 1], rstate)
        out, st = port_rglru.rglru_decode(pc, tp,
                                          torch.from_numpy(xs[:, t:t + 1]), st)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-5,
                                   atol=1e-5)
    assert _max_diff(rstate, st) <= 1e-5


def test_linear_scan_matches_a_float64_recurrence():
    rs = np.random.RandomState(9)
    a = rs.uniform(0.5, 1.0, (2, 300, 6))
    b = rs.standard_normal((2, 300, 6))
    h, want = np.zeros((2, 6)), []
    for t in range(300):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    want = np.stack(want, 1)
    A, B = port_rglru.linear_scan(torch.from_numpy(a).float(),
                                  torch.from_numpy(b).float())
    ra, rb = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)), axis=1)
    scale = np.abs(want).max()
    for got in (B.numpy(), np.asarray(rb)):
        assert np.abs(got - want).max() <= 2e-6 * scale
    np.testing.assert_allclose(A.numpy(), np.asarray(ra), rtol=1e-5,
                               atol=1e-30)   # products that underflow


@pytest.mark.parametrize("S,window", [(256, 0), (512, 0), (512, 128),
                                      (384, 96)])
def test_windowed_chunked_attention_matches_reference(S, window):
    rs = np.random.RandomState(S + window)
    q = rs.standard_normal((2, S, 2, 3, 16)).astype(np.float32)
    k, v = (rs.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    ref = ref_attention.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), window=window, q_chunk=128)
    got = port_attention.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), window=window, q_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_mla_absorbed_decode_matches_decompressed_form(q_lora_rank):
    """The last token decoded in the absorbed form against the latent cache
    equals the decompressed training attention there (the reference test's
    bar), and both forms equal the reference's."""
    kw = dict(name="mla-test", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=128)
    mla = dict(kv_lora_rank=32, q_lora_rank=q_lora_rank, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16)
    rc = RefArch(**kw, mla=RefMLA(**mla))
    pc = ArchConfig(**kw, mla=MLAConfig(**mla))
    p = jax.tree_util.tree_map(np.asarray, ref_init(
        ref_attention.mla_defs(rc), jax.random.PRNGKey(5)))
    tp = convert.params_from_jax(p)
    B, S = 2, 12
    x = (np.random.RandomState(6).standard_normal((B, S, 64)) * 0.5).astype(
        np.float32)
    tx = torch.from_numpy(x)
    positions = torch.arange(S)[None, :]
    out_train, (c, kr) = port_attention.mla_attention(pc, tp, tx, positions)
    ref_train, _ = ref_attention.mla_attention(rc, p, jnp.asarray(x),
                                               jnp.arange(S)[None, :])
    np.testing.assert_allclose(out_train.numpy(), np.asarray(ref_train),
                               rtol=1e-5, atol=1e-5)
    c_cache, kr_cache = c.clone(), kr.clone()
    pos_last = torch.full((B, 1), S - 1)
    c_new, kr_new = port_attention._mla_latent(pc, tp, tx[:, S - 1:],
                                               pos_last)
    c_cache[:, S - 1:], kr_cache[:, S - 1:] = c_new, kr_new
    mask = torch.ones((B, S), dtype=torch.bool)
    out_dec, _ = port_attention.mla_decode(pc, tp, tx[:, S - 1:], c_cache,
                                           kr_cache, mask, pos_last)
    np.testing.assert_allclose(out_dec[:, 0].numpy(),
                               out_train[:, -1].numpy(), rtol=2e-3, atol=2e-4)
    ref_dec, _ = ref_attention.mla_decode(
        rc, p, jnp.asarray(x[:, S - 1:]), jnp.asarray(c_cache.numpy()),
        jnp.asarray(kr_cache.numpy()), jnp.asarray(mask.numpy()),
        jnp.full((B, 1), S - 1))
    np.testing.assert_allclose(out_dec.numpy(), np.asarray(ref_dec),
                               rtol=1e-5, atol=1e-5)


def test_train_main_feeds_a_deep_vlm_frames_that_keep_it_finite():
    """``launch.train`` draws the VLM's frames N(0, 1), where the
    reference's driver feeds zeros: zero patches stay zeros through every
    layer, RMSNorm's backward scales by 1/sqrt(eps) a layer, and from 14
    layers on the reference's own gradients are non-finite (the witness
    below).  The port's driver at 14 layers trains finite."""
    from repro_torch.launch import train as port_train
    rc = dataclasses.replace(ref_arch("paligemma-3b", reduced=True),
                             n_layers=14)
    tokens = jnp.asarray(_inputs(rc, 1, 8, 6)["tokens"])
    grads = jax.grad(lambda p: RefModel(rc).loss(p, {
        "tokens": tokens, "frames": jnp.zeros((1, rc.n_frames, rc.d_model))
    })[0])(RefModel(rc).init(jax.random.PRNGKey(0)))
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree_util.tree_leaves(grads))
    losses = port_train.main(["--arch", "paligemma-3b", "--layers", "14",
                              "--steps", "2", "--batch", "1", "--seq", "8",
                              "--lr", "1e-3", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
