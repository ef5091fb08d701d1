"""The port's decode path and serving driver against the reference.

* ``decode_step`` token by token against the reference's
  ``make_serve_step`` (same parameters, same tokens): logits and the final
  caches within 1e-4, for the reduced ``rwkv6-1.6b`` (recurrent state) and
  the reduced ``glm4-9b`` with a linear and a ring cache (the ring narrowed
  to 16 slots so that 24 tokens wrap it); a reference cache taken
  mid-stream loads into the port and decoding continues from it.
* The port's own stepwise decode against its full-sequence forward at the
  reference's bar (``tests/test_decode_consistency.py``: 0.05).
* Cache specs and helpers; ``launch.serve.main`` end to end on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import kvcache as ref_kvc  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import make_serve_step as ref_serve_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, make_prefill_step, make_serve_step,
)
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

repro_torch.set_device("cpu")

CASES = {  # id -> (arch, ring, decode_window)
    "rwkv6": ("rwkv6-1.6b", False, None),
    "glm4-linear": ("glm4-9b", False, None),
    "glm4-ring": ("glm4-9b", True, 16),
}


def _pair(arch, window=None, dtype=None):
    rc, pc = ref_arch(arch, reduced=True), port_arch(arch, reduced=True)
    changes = {k: v for k, v in (("decode_window", window), ("dtype", dtype))
               if v is not None}
    rc, pc = (dataclasses.replace(c, **changes) for c in (rc, pc))
    params = jax.tree_util.tree_map(
        np.asarray, RefModel(rc).init(jax.random.PRNGKey(0)))
    return RefModel(rc), Model(pc), params, convert.params_from_jax(
        params, "cpu")


def _tokens(vocab, B, S, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_reference(case):
    arch, ring, window = CASES[case]
    ref_model, model, params, tp = _pair(arch, window)
    B, S, length = 2, 24, 32
    toks = _tokens(model.cfg.vocab, B, S)
    ref_step = jax.jit(ref_serve_step(ref_model, ring=ring))
    step = make_serve_step(model, ring=ring)
    ref_cache = ref_model.init_cache(B, length, ring=ring)
    cache = model.init_cache(B, length, ring=ring, device="cpu")
    for t in range(S):
        rl, ref_cache = ref_step(params, ref_cache, toks[:, t:t + 1],
                                 jnp.asarray(t, jnp.int32))
        lg, cache = step(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
    ref_leaves = jax.tree_util.tree_leaves(ref_cache)
    assert len(ref_leaves) == len(tree_leaves(cache))
    for got, want in zip(tree_leaves(cache), ref_leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b"])
def test_reference_cache_loads_mid_stream(arch):
    """Decode 8 tokens in the reference, carry its cache into the port,
    decode 8 more in both."""
    ref_model, model, params, tp = _pair(arch)
    toks = _tokens(model.cfg.vocab, 2, 16, seed=2)
    ref_step = jax.jit(ref_serve_step(ref_model))
    ref_cache = ref_model.init_cache(2, 16)
    for t in range(8):
        _, ref_cache = ref_step(params, ref_cache, toks[:, t:t + 1],
                                jnp.asarray(t, jnp.int32))
    cache = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_cache), "cpu")
    step = make_serve_step(model)
    for t in range(8, 16):
        rl, ref_cache = ref_step(params, ref_cache, toks[:, t:t + 1],
                                 jnp.asarray(t, jnp.int32))
        lg, cache = step(tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b"])
def test_stepwise_decode_matches_forward(arch):
    """The port's decode against its own prefill, on its own init."""
    model = Model(port_arch(arch, reduced=True))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(model.cfg.vocab, B, S, seed=3))
    full = make_prefill_step(model)(params, {"tokens": toks})
    step = make_serve_step(model)
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b"])
def test_cache_specs_match_reference(arch, ring):
    ref_model, model, _, _ = _pair(arch, dtype="bfloat16")
    ref = jax.tree_util.tree_leaves(ref_model.cache_specs(3, 40, ring=ring))
    port = model.cache_specs(3, 40, ring=ring)
    assert all(t.device.type == "meta" for t in tree_leaves(port))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(port)] == [
        (tuple(s.shape), str(s.dtype)) for s in ref]
    # a bf16 reference cache (numpy's ml_dtypes) loads with its dtype
    ref_zeros = jax.tree_util.tree_map(
        np.asarray, ref_model.init_cache(3, 40, ring=ring))
    loaded = convert.params_from_jax(ref_zeros, "cpu")
    zeros = model.init_cache(3, 40, ring=ring, device="cpu")
    assert tree_paths(loaded) == tree_paths(zeros)
    for a, b in zip(tree_leaves(loaded), tree_leaves(zeros)):
        assert a.dtype == b.dtype and a.shape == b.shape and not a.any()


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 15, 16, 40])
def test_cache_slot_and_mask_match_reference(pos, ring, as_tensor):
    """The slot and the mask from a Python int and from a 0-d int32 tensor
    (the serve step's device position)."""
    p = torch.tensor(pos, dtype=torch.int32) if as_tensor else pos
    assert int(kvc.cache_slot(p, 16, ring)) == int(
        ref_kvc.cache_slot(jnp.asarray(pos), 16, ring))
    np.testing.assert_array_equal(
        kvc.cache_mask(2, p, 16, ring).numpy(),
        np.asarray(ref_kvc.cache_mask(2, jnp.asarray(pos), 16, ring)))


def test_mla_cache_specs_match_reference():
    """MLA's latent cache specs equal the reference's at full and reduced
    size."""
    for reduced in (False, True):
        cfg = port_arch("deepseek-v2-lite-16b", reduced=reduced)
        ref = ref_kvc.mla_cache_defs(
            ref_arch("deepseek-v2-lite-16b", reduced=reduced), 3, 40,
            jnp.bfloat16)
        port = kvc.mla_cache_defs(cfg, 3, 40, torch.bfloat16)
        assert sorted(port) == sorted(ref) == ["c", "kr"]
        for key in port:
            assert port[key].device.type == "meta"
            assert tuple(port[key].shape) == tuple(ref[key].shape)
            assert port[key].dtype == torch.bfloat16


@pytest.mark.parametrize("extra", [[], ["--ring"]])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b", "nemotron-4-340b",
                                  "paligemma-3b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_serve_main_runs_on_cpu(arch, extra, capsys):
    ops.reset_launch_counts()
    gen = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6",
                      "--gen", "5", "--cache-len", "16", *extra])
    vocab = port_arch(arch, reduced=True).vocab
    assert gen.shape == (2, 5) and (gen >= 0).all() and (gen < vocab).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"arch={arch}-smoke batch=2 prompt=6 gen=5 "
                        f"ring={bool(extra)}")
    assert lines[1].startswith("prefill ") and "tok/s aggregate" in lines[1]
    assert sum(ops.launch_counts().values()) == 0     # CPU: plain versions


def test_serve_main_is_deterministic_in_its_seed():
    args = ["--arch", "rwkv6-1.6b", "--batch", "2", "--prompt-len", "4",
            "--gen", "6"]
    a = serve.main(args + ["--seed", "3"])
    np.testing.assert_array_equal(a, serve.main(args + ["--seed", "3"]))
