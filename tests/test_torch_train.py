"""LLM training in the port against the reference: ``Model.loss``,
``make_train_step``, ``launch.train`` and the model facade's input specs.

* ``Model.loss`` against ``repro.models.transformer.loss_fn`` for the
  reduced ``glm4-9b``, ``internlm2-20b``, ``phi3-medium-14b``,
  ``qwen3-moe-30b-a3b`` (also with a leading dense layer and a shared
  expert) and ``rwkv6-1.6b`` from the reference's own init: loss within
  1e-4, ``nll`` / ``aux`` within 1e-5.
* ``make_train_step``: 3 steps, SGD with momentum and AdamW, on the dense
  and the MoE arch, params within 1e-5 of the reference's; remat on
  equals remat off bit for bit in the port; flash on (the kernels' plain
  versions on the CPU) against off within 1e-5.  AdamW runs with eps 1e-3:
  Adam divides each gradient element by its own magnitude plus eps, so at
  the default 1e-8 an element whose gradient is a cancellation of ~1e-8
  (summation-order noise, different in any two programs, and in the
  reference from a 1e-7-perturbed start) steps by up to the learning rate
  with either sign — 7.9e-3 apart after 3 steps of the dense arch — which
  would test the noise floor, not the step.  The dense arch starts from a
  well-conditioned draw (matrices 1/sqrt(d_model)): the default init of the
  (d, H, hd) projections takes the head count as the fan-in, saturates the
  softmax and makes three steps chaotic (a 1.6e-4 gap in the first step's
  gradients grows to 0.12 in the params), which would test the saturation,
  not the step.
* ``launch.train``: ``synthetic_lm_batches`` equal to the reference's bit
  for bit; ``main`` at the reduced ``glm4-9b`` (``--steps 6 --batch 2
  --seq 32``) from the same injected params: losses within 1e-4, and a
  ``--ckpt-dir`` checkpoint that the reference's ``load_checkpoint`` reads,
  within 1e-5 of the reference's own.
* ``input_specs`` shapes and dtypes for all four ``SHAPES``, and
  ``make_inputs``; the ported architecture ids carry the published
  hyperparameters and parameter counts (the ports of
  ``tests/test_models_smoke.py``'s two config tests), with model trees of
  the reference's shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import TrainState as RefState  # noqa: E402
from repro.models.model import make_train_step as ref_step  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import PORTED  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, TrainState, init_train_state, make_train_step,
)
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

repro_torch.set_device("cpu")
ARCHS = ["glm4-9b", "internlm2-20b", "phi3-medium-14b", "qwen3-moe-30b-a3b",
         "rwkv6-1.6b"]


def _variant(cfg, name):
    """``+dense0``: the MoE arch with a leading dense-FFN layer and a
    shared expert (DeepSeek's layout: the ``dense0`` segment and the
    fused shared FFN, which qwen3 itself leaves at 0)."""
    if not name.endswith("+dense0"):
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=1, dense_d_ff=192, n_shared=1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made such runs some 20x
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _tokens(vocab, shape, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _max_diff(ref_tree, port_tree):
    ref = jax.tree_util.tree_leaves(ref_tree)
    port = tree_leaves(port_tree)
    assert len(ref) == len(port)
    return max(float(np.abs(np.asarray(a, np.float32)
                            - b.detach().float().numpy()).max())
               for a, b in zip(ref, port))


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-30b-a3b+dense0"])
def test_loss_matches_reference(arch):
    base = arch.split("+")[0]
    rc = _variant(ref_arch(base, reduced=True), arch)
    pc = _variant(port_arch(base, reduced=True), arch)
    params = jax.tree_util.tree_map(
        np.asarray, RefModel(rc).init(jax.random.PRNGKey(0)))
    tok = _tokens(rc.vocab, (2, 32), 1)
    rl, rm = RefModel(rc).loss(params, {"tokens": jnp.asarray(tok)})
    pl, pm = Model(pc).loss(convert.params_from_jax(params),
                            {"tokens": torch.from_numpy(tok)})
    assert abs(float(rl) - float(pl)) <= 1e-4
    for k in ("nll", "aux"):
        assert abs(float(rm[k]) - float(pm[k])) <= 1e-5, k
    if rc.moe is not None:
        assert float(pm["aux"]) > 0


def _optimizers(name):
    if name == "sgd":
        return ref_opt.sgd(0.05, momentum=0.9), port_opt.sgd(0.05,
                                                             momentum=0.9)
    return ref_opt.adamw(3e-3, eps=1e-3), port_opt.adamw(3e-3, eps=1e-3)


def _port_state(tp, opt):
    return TrainState(tp, opt.init(tp), torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_train_steps_match_reference_with_remat_on_and_off(arch, opt_name):
    rc, pc = ref_arch(arch, reduced=True), port_arch(arch, reduced=True)
    params = scaled_params(rc)
    ropt, popt = _optimizers(opt_name)
    rstate = RefState(params, ropt.init(params), jnp.zeros((), jnp.int32))
    rstep = jax.jit(ref_step(RefModel(rc), ropt))
    batches = [_tokens(rc.vocab, (2, 32), 10 + i) for i in range(3)]
    for b in batches:
        rstate, rmetrics = rstep(rstate, {"tokens": jnp.asarray(b)})
    finals = {}
    for remat in (True, False):
        state = _port_state(convert.params_from_jax(params), popt)
        step = make_train_step(Model(pc), popt, remat=remat)
        for b in batches:
            state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        assert int(state.step) == 3 and state.step.dtype == torch.int32
        assert abs(float(metrics["loss"]) - float(rmetrics["loss"])) <= 1e-4
        assert _max_diff(rstate.params, state.params) <= 1e-5
        finals[remat] = state.params
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(finals[True]),
                                                 tree_leaves(finals[False])))


def test_train_step_with_flash_on_matches_flash_off():
    """The flash kernels' plain versions (what the ops run on a CPU tensor)
    inside the train step, remat on: K6 in the forward and again in the
    recompute, K7 in the backward."""
    from repro_torch.kernels import ops
    pc = port_arch("glm4-9b", reduced=True)
    params = convert.params_from_jax(scaled_params(
        ref_arch("glm4-9b", reduced=True)))
    opt = port_opt.sgd(0.05, momentum=0.9)
    out = {}
    for flash in (False, True):
        port_attention.set_flash_attention(flash)
        ops.reset_launch_counts()
        try:
            state = _port_state(params, opt)
            step = make_train_step(Model(pc), opt)
            for i in range(2):
                state, _ = step(state, {"tokens": torch.from_numpy(
                    _tokens(pc.vocab, (2, 32), 20 + i))})
        finally:
            port_attention.set_flash_attention(None)
        out[flash] = state.params
        counts = ops.launch_counts()
        assert counts["flash_fwd"] == counts["flash_dq"] == 0   # CPU
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(out[True]), tree_leaves(out[False]))) <= 1e-5


def test_synthetic_lm_batches_match_reference_bit_for_bit():
    ref = ref_train.synthetic_lm_batches(97, 3, 17, seed=5)
    port = port_train.synthetic_lm_batches(97, 3, 17, seed=5)
    for _ in range(3):
        r, p = next(ref)["tokens"], next(port)["tokens"]
        assert p.dtype == torch.int64 and p.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


def test_train_main_matches_reference_and_writes_its_checkpoint(
        monkeypatch, tmp_path, capsys):
    rc = ref_arch("glm4-9b", reduced=True)
    params = scaled_params(rc)

    def ref_init(model, opt, key):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        return RefState(p, opt.init(p), jnp.zeros((), jnp.int32))

    def port_init(model, opt, gen, device=None):
        return _port_state(convert.params_from_jax(params, device), opt)

    monkeypatch.setattr(ref_train, "init_train_state", ref_init)
    monkeypatch.setattr(port_train, "init_train_state", port_init)
    argv = ["--arch", "glm4-9b", "--steps", "6", "--batch", "2", "--seq",
            "32", "--log-every", "3"]
    ref_losses = ref_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    capsys.readouterr()
    losses = port_train.main(argv + ["--ckpt-dir", str(tmp_path / "port")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=glm4-9b-smoke params=")
    assert lines[0].endswith("devices=1 device=cpu (cpu)")
    assert [ln.split("(")[0] for ln in lines[1:3]] == \
        [f"step {s:5d} loss {np.mean(losses[s - 3:s]):.4f} " for s in (3, 6)]
    assert lines[-1].startswith("loss ") and ("LEARNED" in lines[-1]
                                              or "check lr" in lines[-1])
    assert len(losses) == 6 and all(isinstance(x, float) for x in losses)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    got = ref_load(str(tmp_path / "port"))
    want = ref_load(str(tmp_path / "ref"))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b",
                                  "rwkv6-1.6b"])
def test_input_specs_match_reference(arch, shape):
    rc, pc = ref_arch(arch, reduced=True), port_arch(arch, reduced=True)
    assert SHAPES[shape] == InputShape(*dataclasses.astuple(
        REF_SHAPES[shape]))
    ref = RefModel(rc).input_specs(REF_SHAPES[shape])
    port = Model(pc).input_specs(SHAPES[shape])
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert tree_paths(port) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [(tuple(t.shape), _dtype_name(t)) for t in tree_leaves(port)] == \
        [(tuple(s.shape), s.dtype.name) for s in ref_leaves]
    assert all(t.device.type == "meta" for t in tree_leaves(port))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_make_inputs_fill_the_specs_and_feed_the_model(kind):
    pc = port_arch("glm4-9b", reduced=True)
    model = Model(pc)
    shape = InputShape("small", 16, 2, kind)
    gen = torch.Generator().manual_seed(0)
    inputs = model.make_inputs(shape, gen)
    specs = model.input_specs(shape)
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(inputs)] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(specs)]
    assert int(inputs["tokens"].max()) < pc.vocab
    params = model.init(torch.Generator().manual_seed(1))
    if kind == "train":
        loss, _ = model.loss(params, inputs)
        assert torch.isfinite(loss)
    else:
        assert int(inputs["pos"]) == 15
        logits, _ = model.decode_step(params, inputs["cache"],
                                      inputs["tokens"], inputs["pos"])
        assert logits.shape == (2, 1, pc.vocab)


def test_init_train_state_draws_on_the_generators_device():
    pc = port_arch("qwen3-moe-30b-a3b", reduced=True)
    opt = port_opt.sgd(0.1, momentum=0.9)
    a = init_train_state(Model(pc), opt, torch.Generator().manual_seed(2))
    b = Model(pc).init(torch.Generator().manual_seed(2), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b)))
    assert a.step.dtype == torch.int32 and int(a.step) == 0
    assert all(torch.equal(m, torch.zeros_like(m))
               for m in tree_leaves(a.opt_state))


def test_exact_assigned_hyperparameters():
    """Full configs carry the exact assigned numbers, field for field the
    reference's, for every ported id."""
    c = port_arch("internlm2-20b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (48, 6144, 48, 8, 16384, 92544)
    c = port_arch("phi3-medium-14b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (40, 5120, 40, 10, 17920, 100352)
    c = port_arch("qwen3-moe-30b-a3b")
    assert (c.moe.n_experts, c.moe.top_k, c.moe.d_expert) == (128, 8, 768)
    assert c.qk_norm and c.moe.n_shared == 0
    c = port_arch("glm4-9b")
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == \
        (4096, 32, 2, 13696, 151552)
    for key in PORTED:
        assert dataclasses.asdict(port_arch(key)) == \
            dataclasses.asdict(ref_arch(key)), key


@pytest.mark.parametrize("arch,billions", [
    ("rwkv6-1.6b", 1.6), ("internlm2-20b", 20), ("glm4-9b", 9.4),
    ("phi3-medium-14b", 14), ("qwen3-moe-30b-a3b", 30.5)])
def test_param_counts_match_published_sizes(arch, billions):
    """Published sizes within 25% (the reference's test), and the model
    tree's leaf shapes — no storage — the reference's, at full width."""
    cfg = port_arch(arch)
    n = cfg.param_count() / 1e9
    assert abs(n - billions) / billions < 0.25, (arch, n)
    assert cfg.param_count() == ref_arch(arch).param_count()
    port = [d.shape for d in tree_leaves(Model(cfg).defs())]
    ref = [d.shape for d in jax.tree_util.tree_leaves(
        RefModel(ref_arch(arch)).defs(), is_leaf=is_paramdef_leaf)]
    assert [tuple(s) for s in port] == [tuple(s) for s in ref]


def test_tree_utilities_and_the_train_step_leave_no_reference_cycles():
    """A leaf passed through ``tree_flatten`` / ``tree_unflatten`` /
    ``tree_map`` / ``tree_paths`` is freed as soon as its last reference
    goes, with the cycle collector off; and a steady train step (remat on)
    leaves no tensor in cyclic garbage.  Nested self-calling closures in
    the tree utilities once kept every flattened leaf alive until the
    collector ran: on the card, the train step's grads, updates and old
    params (a 2-layer glm4-9b step peaked at 42.2 GiB instead of 30.8)."""
    import gc
    import weakref

    from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten
    gc.collect()
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        leaves, treedef = tree_flatten({"a": [t, (t,)], "b": t})
        tree_unflatten(treedef, leaves)
        tree_map(lambda x: x + 1, {"a": t})
        tree_paths({"a": t})
        del t, leaves, treedef
        assert ref() is None

        pc = port_arch("glm4-9b", reduced=True)
        opt = port_opt.sgd(0.05, momentum=0.9)
        state = init_train_state(Model(pc), opt,
                                 torch.Generator().manual_seed(0))
        step = make_train_step(Model(pc), opt, remat=True)
        batch = {"tokens": torch.from_numpy(_tokens(pc.vocab, (2, 16), 3))}
        state, _ = step(state, batch)          # first use
        gc.collect()
        gc.set_debug(gc.DEBUG_SAVEALL)
        state, _ = step(state, batch)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert leaked == []
