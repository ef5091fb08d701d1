"""The port's cross-pod federated round (``repro_torch.core.federated``)
against the reference (``repro.core.federated``), at the reduced
``glm4-9b`` from a well-conditioned parameter draw (see
``tests/test_torch_train.py``), 2 pods x 2 local steps of 2 x 32 tokens,
SGD lr 0.05 with momentum 0.9.

* The cases of ``tests/test_federated_round.py`` and
  ``test_expert_parallel.py::test_int8_sync_fed_round_learns_and_bounds_error``
  on the port: the round equals each pod trained separately and FedAvg-ed
  by hand; the pods end bit for bit equal; STC and ``int8_sync`` rounds
  learn with a non-trivial, finite residual.
* The round against the reference's over 2 rounds: under ``none`` params
  within 1e-5; under ``stc``, ``int8`` and ``int8_sync`` within
  max(1e-5, 2 x how far the reference itself moves from a 1e-7-perturbed
  start) — the pods' trained deltas differ from the reference's by
  ~1e-8, which flips the few elements that sit at an STC threshold (a
  whole +-mean, ~5e-3) or an int8 rounding boundary (one quantization
  step, ~1e-4), and a 1e-7 perturbation flips the reference the same way
  — with fewer than 0.1% of the elements beyond 1e-5.  On equal deltas the
  sync stage itself (``sync_leaf``) gives the reference's: STC masks and
  nnz equal and values within 2 ulp (the STC-mean deviation, ROADMAP queue
  3), int8 and ``int8_sync`` within 1e-7.
* ``skip_nonfinite`` with one NaN pod (the survivor's delta, as in the
  reference) and with every pod NaN (a zero delta: params bit for bit
  unchanged); ``finite_pod_mean`` as ``tests/test_faults.py`` holds it.
* ``fed_input_specs`` shapes against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core import federated as ref_fed  # noqa: E402
from repro.models.layers import is_paramdef_leaf  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import TrainState as RefState  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, TrainState, make_train_step,
)
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

repro_torch.set_device("cpu")
PODS, E = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (small tensors; a loaded
    parallel run made torch's default pool much slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=3, perturb=None):
    rc = ref_arch("glm4-9b", reduced=True)
    rs = np.random.RandomState(seed)

    def draw(d):
        lead = 1 if d.axes and d.axes[0] == "layers" else 0
        std = rc.d_model ** -0.5 if len(d.shape) - lead >= 2 else 0.1
        return (rs.standard_normal(d.shape) * std).astype(np.float32)
    p = jax.tree_util.tree_map(draw, RefModel(rc).defs(),
                               is_leaf=is_paramdef_leaf)
    if perturb is not None:
        prs = np.random.RandomState(perturb)
        p = jax.tree_util.tree_map(lambda a: (a * (1 + 1e-7 * prs.standard_normal(
            a.shape))).astype(np.float32), p)
    return p


def _tokens(vocab, seed=1):
    return np.random.RandomState(seed).randint(
        0, vocab, (PODS, E, 2, 32)).astype(np.int32)


def _port(params, compression="none", **kw):
    pc = port_arch("glm4-9b", reduced=True)
    opt = port_opt.sgd(0.05, momentum=0.9)
    tp = convert.params_from_jax(params)
    state = TrainState(tp, opt.init(tp), torch.zeros((), dtype=torch.int32))
    cfg = fed.FedRoundConfig(local_steps=E, compression=compression,
                             stc_sparsity=0.25, **kw)
    return (Model(pc), opt, state, cfg, fed.init_fed_state(state, PODS, cfg),
            fed.make_fed_round_step(Model(pc), opt, cfg, PODS))


def _ref_run(params, compression, rounds, tokens, **kw):
    rc = ref_arch("glm4-9b", reduced=True)
    opt = ref_opt.sgd(0.05, momentum=0.9)
    state = RefState(params, opt.init(params), jnp.zeros((), jnp.int32))
    cfg = ref_fed.FedRoundConfig(local_steps=E, compression=compression,
                                 stc_sparsity=0.25, **kw)
    f = ref_fed.init_fed_state(state, PODS, cfg)
    step = jax.jit(ref_fed.make_fed_round_step(RefModel(rc), opt, cfg, PODS))
    losses = []
    for _ in range(rounds):
        f, m = step(f, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
    return f, losses


def _pods_equal(params):
    return all(torch.equal(t[0], t[1]) for t in tree_leaves(params))


def test_fed_round_equals_manual_fedavg():
    model, opt, state, cfg, f, step = _port(_params())
    batch = torch.from_numpy(_tokens(model.cfg.vocab))
    new, metrics = step(f, {"tokens": batch})
    train = make_train_step(model, opt, remat=True)
    deltas = []
    for p in range(PODS):
        s = state
        for e in range(E):
            s, _ = train(s, {"tokens": batch[p, e]})
        deltas.append(tree_map(lambda n, o: n - o, s.params, state.params))
    agg = tree_map(lambda *ds: sum(ds) / len(ds), *deltas)
    expected = tree_map(lambda s, a: s + a, state.params, agg)
    for e, g in zip(tree_leaves(expected), tree_leaves(new.train.params)):
        torch.testing.assert_close(g[0], e, rtol=0, atol=1e-6)
    assert new.train.step.tolist() == [E] * PODS
    assert metrics["local_losses"].shape == (E,)


def test_fed_round_pods_stay_synced():
    model, _, _, _, f, step = _port(_params())
    new, _ = step(f, {"tokens": torch.from_numpy(_tokens(model.cfg.vocab))})
    assert _pods_equal(new.train.params)


@pytest.mark.parametrize("compression", ["stc", "int8_sync"])
def test_compressed_fed_round_learns_with_error_feedback(compression):
    model, _, _, _, f, step = _port(_params(), compression)
    batch = {"tokens": torch.from_numpy(_tokens(model.cfg.vocab))}
    losses = []
    for _ in range(4):
        f, metrics = step(f, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert _pods_equal(f.train.params)
    res = tree_leaves(f.residual)
    assert all(bool(torch.isfinite(r).all()) for r in res)
    assert sum(float(r.abs().sum()) for r in res) > 0
    if compression == "int8_sync":
        assert all(r.shape[0] == PODS for r in res)


@pytest.mark.parametrize("compression", ["none", "stc", "int8",
                                         "int8_sync"])
def test_fed_round_matches_reference(compression):
    params = _params()
    tokens = _tokens(ref_arch("glm4-9b", reduced=True).vocab)
    ref, ref_losses = _ref_run(params, compression, 2, tokens)
    bar = 1e-5
    if compression != "none":
        moved, _ = _ref_run(_params(perturb=7), compression, 2, tokens)
        bar = max(bar, 2 * max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(jax.tree_util.tree_leaves(ref.train.params),
                            jax.tree_util.tree_leaves(moved.train.params))))
    _, _, _, _, f, step = _port(params, compression)
    losses = []
    for _ in range(2):
        f, m = step(f, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    assert _pods_equal(f.train.params)
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(jax.tree_util.tree_leaves(ref.train.params),
                    tree_leaves(f.train.params)):
        d = np.abs(np.asarray(a) - b.numpy())
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-5).sum())
        total += d.size
    assert worst <= bar, (worst, bar)
    assert beyond <= 1e-3 * total, (beyond, total)
    if compression != "none":
        for a, b in zip(jax.tree_util.tree_leaves(ref.residual),
                        tree_leaves(f.residual)):
            assert tuple(b.shape) == a.shape


@pytest.mark.parametrize("compression", ["stc", "int8", "int8_sync"])
def test_sync_stage_matches_reference_on_equal_deltas(compression):
    rs = np.random.RandomState(11)
    delta = (rs.standard_normal((PODS, 3, 8195)) * 1e-2).astype(np.float32)
    shape = delta.shape if compression == "int8_sync" else delta.shape[1:]
    residual = (rs.standard_normal(shape) * 1e-3).astype(np.float32)
    cfg = fed.FedRoundConfig(compression=compression, stc_sparsity=0.01)
    agg, new_r = fed.sync_leaf(cfg, torch.from_numpy(delta),
                               torch.from_numpy(residual))
    d, r = jnp.asarray(delta), jnp.asarray(residual)
    if compression == "int8_sync":       # the reference's one-device route
        corrected = d + r
        scale = jnp.maximum(jnp.max(jnp.abs(corrected), axis=(1, 2),
                                    keepdims=True), 1e-12) / 127.0
        deq = jnp.clip(jnp.round(corrected / scale), -127, 127) * scale
        want = jnp.broadcast_to(deq.mean(axis=0, keepdims=True), d.shape)
        want_r = corrected - deq
    else:
        corrected = d.mean(axis=0) + r
        want = ref_comp.decompress(ref_comp.compress(corrected, compression,
                                                     0.01))
        want_r = corrected - want
        want = want[None]
    got = agg.expand(delta.shape).numpy()
    want = np.broadcast_to(np.asarray(want), delta.shape)
    if compression == "stc":
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        assert int((got[0] != 0).sum()) == int((want[0] != 0).sum())
        spacing = np.spacing(np.abs(want).astype(np.float32))
        assert float((np.abs(got - want) / spacing).max()) <= 2.0
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(new_r.numpy(), np.asarray(want_r), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("bad_pods", [[1], [0, 1]])
def test_skip_nonfinite_drops_nan_pods(bad_pods):
    """A NaN in a pod's momentum makes its round delta NaN; the sync then
    averages the surviving pods (the reference's result) or, with every
    pod NaN, applies a zero delta (params unchanged bit for bit)."""
    params = _params()
    tokens = _tokens(ref_arch("glm4-9b", reduced=True).vocab)
    _, _, _, _, f, step = _port(params, skip_nonfinite=True)
    start = [t.clone() for t in tree_leaves(f.train.params)]
    for p in bad_pods:
        f.train.opt_state["embed"][p, 0, 0] = float("nan")
    f, m = step(f, {"tokens": torch.from_numpy(tokens)})
    if len(bad_pods) == PODS:
        assert all(torch.equal(a, b) for a, b in zip(
            start, tree_leaves(f.train.params)))
        return
    assert _pods_equal(f.train.params)
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(
        f.train.params))
    # the reference: the same poisoned momentum
    rc = ref_arch("glm4-9b", reduced=True)
    opt = ref_opt.sgd(0.05, momentum=0.9)
    state = RefState(params, opt.init(params), jnp.zeros((), jnp.int32))
    cfg = ref_fed.FedRoundConfig(local_steps=E, skip_nonfinite=True)
    rf = ref_fed.init_fed_state(state, PODS, cfg)
    mom = rf.train.opt_state
    mom["embed"] = mom["embed"].at[bad_pods[0], 0, 0].set(jnp.nan)
    rf = dataclasses.replace(rf, train=RefState(rf.train.params, mom,
                                                rf.train.step))
    rf, _ = jax.jit(ref_fed.make_fed_round_step(RefModel(rc), opt, cfg,
                                                PODS))(
        rf, {"tokens": jnp.asarray(tokens)})
    for a, b in zip(jax.tree_util.tree_leaves(rf.train.params),
                    tree_leaves(f.train.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_finite_pod_mean_zero_weights_bad_pods():
    good = np.arange(12, dtype=np.float32).reshape(4, 3)
    tree = {"w": torch.from_numpy(good.copy()), "b": torch.ones((4, 2))}
    tree["w"][1] = float("nan")               # pod 1 diverged
    out = fed.finite_pod_mean(tree)
    np.testing.assert_allclose(out["w"].numpy(), good[[0, 2, 3]].mean(0))
    np.testing.assert_allclose(out["b"].numpy(), np.ones(2))
    allbad = {"w": torch.full((2, 3), float("nan"))}
    assert torch.equal(fed.finite_pod_mean(allbad)["w"], torch.zeros(3))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_fed_input_specs_match_reference(shape):
    rc, pc = ref_arch("glm4-9b", reduced=True), port_arch("glm4-9b",
                                                         reduced=True)
    for local_steps in (1, 4):
        ref = ref_fed.fed_input_specs(
            RefModel(rc), REF_SHAPES[shape], 2,
            ref_fed.FedRoundConfig(local_steps=local_steps))
        port = fed.fed_input_specs(Model(pc), SHAPES[shape], 2,
                                   fed.FedRoundConfig(local_steps=local_steps))
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in port.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in ref.items()}


def test_unknown_compression_raises():
    with pytest.raises(ValueError, match="unknown compression"):
        fed.make_fed_round_step(Model(port_arch("glm4-9b", reduced=True)),
                                port_opt.sgd(0.1), fed.FedRoundConfig(
                                    compression="topk"), PODS)
