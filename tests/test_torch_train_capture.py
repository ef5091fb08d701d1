"""The train step with its state donated, as a CUDA graph: the port's
counterpart of the reference's ``jax.jit(make_train_step(model, opt),
donate_argnums=(0,))`` (``models/model.py::TrainStep``, which
``launch/train.py`` drives).

* One graph a step object: the first call at a shapes key eager (the
  warm-up), the second captures, later calls replay; a new batch shape or
  flash flag is a new key (warmed up, then captured in place of the old
  graph), a state in other storage captures again at once.
* The state is updated in place: the same tensors, in the same storage,
  every step; the values bit for bit :func:`make_train_step`'s, captured
  or eager, and within ``tests/test_torch_train.py``'s tolerances of the
  reference's jitted step (the dense and the MoE arch, SGD and AdamW).
* No op of the step makes the host wait (``HostSyncMode``); the metrics
  returned alias no buffer of the graph; the remat recompute without a
  saved RNG state is bit for bit the one with it.
* The federated round, the dry run and the plain ``make_train_step`` stay
  eager.

The capture logic runs here with a recording graph in place of the CUDA
one (``_RecordedGraph``); ``tests/test_torch_cuda.py`` runs the real graph
on a card.
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.models.model import TrainState as RefState  # noqa: E402
from repro.models.model import make_train_step as ref_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.contracts import HostSyncMode  # noqa: E402
from repro_torch.configs import get_arch as port_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model, TrainState, TrainStep, make_train_step,
)
from repro_torch.optim import optimizers as port_opt  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)
from test_torch_train import (  # noqa: E402
    _max_diff, _optimizers, _tokens, scaled_params,
)

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made such runs many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RecordedGraph:
    """Stands in for ``utils.capture.CapturedGraph`` on the CPU: keeps a
    static copy of the batch and runs nothing at capture (a capture
    records); each call copies the call's batch into it, runs the captured
    step on it (a replay: the step writes the state in its storage) and
    returns a copy of the metrics."""
    made = []

    def __init__(self, run, inputs, device, counts, pool=None):
        leaves, self.treedef = tree_flatten(inputs)
        self.static = [t.clone() for t in leaves]
        self.run = run
        self.calls = 0
        self.counts = counts
        self.outs = []
        counts.captures += 1
        _RecordedGraph.made.append(self)

    def __call__(self, inputs):
        for buf, t in zip(self.static, tree_leaves(inputs)):
            buf.copy_(t)
        self.calls += 1
        self.counts.replays += 1
        out = self.run(tree_unflatten(self.treedef, self.static))
        self.outs.append(out)
        return tree_map(lambda t: t.clone(), out)


@pytest.fixture()
def recorded(monkeypatch):
    """The recording graph, on the CPU."""
    monkeypatch.setattr(model_mod, "CapturedGraph", _RecordedGraph)
    monkeypatch.setattr(_RecordedGraph, "made", [])
    monkeypatch.setattr(TrainStep, "graph_device_types", ("cpu",))
    return _RecordedGraph.made


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _counts():
    return model_mod.train_capture_count(), model_mod.train_replay_count()


def _state_tree(state):
    return (state.params, state.opt_state, state.step)


def _ptrs(state):
    return [t.data_ptr() for t in tree_leaves(_state_tree(state))]


def _state(params, opt):
    tp = convert.params_from_jax(params)
    return TrainState(tp, opt.init(tp), torch.zeros((), dtype=torch.int32))


def _batches(vocab, n, shape=(2, 32), seed=10):
    return [{"tokens": torch.from_numpy(_tokens(vocab, shape, seed + i))}
            for i in range(n)]


# ---------------------------------------------------------------------------
# (a) launch/train through the captured step
# ---------------------------------------------------------------------------


def test_train_main_captures_once_and_equals_the_eager_run(recorded,
                                                           monkeypatch):
    """``launch.train.main`` (the reduced glm4-9b, 5 steps) runs its step
    through a :class:`TrainStep`: one warm-up, one capture, no recapture,
    a replay every later step; its losses equal the eager run's bit for
    bit."""
    made = []
    real = port_train.TrainStep

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(port_train, "TrainStep", Spy)
    argv = ["--arch", "glm4-9b", "--steps", "5", "--batch", "2", "--seq",
            "16", "--log-every", "5"]
    n0 = _counts()
    losses = port_train.main(argv)
    counts = tuple(b - a for a, b in zip(n0, _counts()))
    monkeypatch.setattr(TrainStep, "graph_device_types", ())
    eager = port_train.main(argv)
    step, twin = made
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (1, 1, 0, 4)
    assert counts == (1, 4) and len(recorded) == 1
    assert (twin.eager_steps, twin.captures, twin.replays) == (5, 0, 0)
    assert losses == eager and len(losses) == 5


# ---------------------------------------------------------------------------
# (b) donation in place; captured = eager = plain; the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_captured_step_keeps_its_storage_and_matches_plain_and_reference(
        recorded, arch, opt_name):
    """Three steps (warm-up, capture, replay) of the captured step: the
    same state object and the same storage every step; state and metrics
    bit for bit :func:`make_train_step`'s; params within 1e-5 and loss
    within 1e-4 of the reference's jitted step."""
    rc, pc = ref_arch(arch, reduced=True), port_arch(arch, reduced=True)
    params = scaled_params(rc)
    ropt, popt = _optimizers(opt_name)
    rstate = RefState(params, ropt.init(params), jnp.zeros((), jnp.int32))
    rstep = jax.jit(ref_step(RefModel(rc), ropt))
    batches = _batches(rc.vocab, 3)
    for b in batches:
        rstate, rmetrics = rstep(rstate, {"tokens": jnp.asarray(
            b["tokens"].numpy())})
    plain_state = _state(params, popt)
    plain = make_train_step(Model(pc), popt)
    state = _state(params, popt)
    ptrs = _ptrs(state)
    step = TrainStep(Model(pc), popt)
    for b in batches:
        plain_state, want = plain(plain_state, b)
        out, got = step(state, b)
        assert out is state and _ptrs(state) == ptrs
        assert _same_bits(got, want) and sorted(got) == sorted(want)
        assert _same_bits(_state_tree(state), _state_tree(plain_state))
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 2)
    assert int(state.step) == 3
    assert abs(float(got["loss"]) - float(rmetrics["loss"])) <= 1e-4
    assert _max_diff(rstate.params, state.params) <= 1e-5


def test_new_shapes_flags_or_storage_select_a_new_graph(recorded):
    """The key: a new batch shape warms up and captures in place of the
    old graph (one graph a step object), the flash flag flipped likewise,
    and a state in other storage captures again at once; every step bit
    for bit the plain step's."""
    pc = port_arch("glm4-9b", reduced=True)
    params = scaled_params(ref_arch("glm4-9b", reduced=True))
    opt = port_opt.sgd(0.05, momentum=0.9)
    state, plain_state = _state(params, opt), _state(params, opt)
    step, plain = TrainStep(Model(pc), opt), make_train_step(Model(pc), opt)
    keys = []
    script = ([((2, 32), False)] * 3 + [((2, 16), False)] * 2
              + [((2, 16), True)] * 2 + ["moved"] + [((2, 16), True)])
    try:
        for i, what in enumerate(script):
            if what == "moved":             # the same values elsewhere
                state = TrainState(*tree_map(torch.clone,
                                             _state_tree(state)))
                continue
            shape, flash = what
            port_attention.set_flash_attention(flash)
            (b,) = _batches(pc.vocab, 1, shape, seed=30 + i)
            keys.append(model_mod.train_key(state, b, True))
            plain_state, want = plain(plain_state, b)
            _, got = step(state, b)
            assert _same_bits(got, want)
            assert _same_bits(_state_tree(state), _state_tree(plain_state))
    finally:
        port_attention.set_flash_attention(None)
    shapes = [k[0] for k in keys]
    assert len(set(shapes)) == 3 and shapes[0] != shapes[3] != shapes[5]
    assert keys[6][0] == keys[7][0] and keys[6][1] != keys[7][1]
    # (2, 32): warm-up, capture, replay; (2, 16) and flash on: warm-up,
    # capture each; the moved state: a capture at once
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (3, 4, 3, 5)
    assert [g.calls for g in recorded] == [2, 1, 1, 1]


# ---------------------------------------------------------------------------
# (c) no host sync, no aliasing, the remat recompute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_the_train_step_makes_no_host_wait(recorded, arch):
    """Warm-up, capture and two replays (the MoE router and dispatch under
    autograd included) with nothing that waits on the device: no scalar
    read, no data-dependent shape, no copy to the host."""
    pc = port_arch(arch, reduced=True)
    opt = port_opt.adamw(3e-3, eps=1e-3)
    state = _state(scaled_params(ref_arch(arch, reduced=True)), opt)
    step = TrainStep(Model(pc), opt)
    batches = _batches(pc.vocab, 4, (2, 16))
    with HostSyncMode() as mode:
        for b in batches:
            step(state, b)
    assert mode.found == []
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 3)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


def test_returned_metrics_alias_no_graph_buffer(recorded):
    """Each step's metrics stay as returned after later replays, and share
    no storage with the graph's batch or its outputs."""
    pc = port_arch("glm4-9b", reduced=True)
    opt = port_opt.sgd(0.05, momentum=0.9)
    state = _state(scaled_params(ref_arch("glm4-9b", reduced=True)), opt)
    step = TrainStep(Model(pc), opt)
    out = [step(state, b)[1] for b in _batches(pc.vocab, 4, (2, 16))]
    kept = [tree_map(torch.clone, m) for m in out]
    graph = recorded[0]
    held = _storages(graph.static) | _storages(graph.outs)
    for m, k in zip(out, kept):
        assert _same_bits(m, k)
        assert not _storages(m) & held
    assert not _same_bits(out[2], out[3])


def test_the_remat_recompute_needs_no_saved_rng_state(monkeypatch):
    """The layers draw from no generator: the train step with each layer's
    recompute restoring the saved RNG state (``torch.utils.checkpoint``'s
    default) equals the step without it (``models.transformer._remat``)
    bit for bit."""
    pc = port_arch("qwen3-moe-30b-a3b", reduced=True)
    params = scaled_params(ref_arch("qwen3-moe-30b-a3b", reduced=True))
    opt = port_opt.sgd(0.05, momentum=0.9)
    out = {}
    for preserve in (False, True):
        if preserve:
            real = tfm.checkpoint

            def saving(fn, *args, **kw):
                kw["preserve_rng_state"] = True
                return real(fn, *args, **kw)
            monkeypatch.setattr(tfm, "checkpoint", saving)
        state = _state(params, opt)
        step = make_train_step(Model(pc), opt, remat=True)
        for b in _batches(pc.vocab, 2, (2, 16)):
            state, metrics = step(state, b)
        out[preserve] = (_state_tree(state), metrics)
    assert _same_bits(out[False], out[True])


# ---------------------------------------------------------------------------
# (d) the callers that stay eager
# ---------------------------------------------------------------------------


def test_the_federated_round_the_dry_run_and_the_plain_step_stay_eager(
        recorded):
    """The federated round (pods in turn on per-pod views of the
    pod-stacked state), the dry run (fake tensors) and the plain
    :func:`make_train_step` run eagerly even where a train step would be
    captured: no graph is made and no train-step capture is counted."""
    pc = port_arch("glm4-9b", reduced=True)
    model = Model(pc)
    opt = port_opt.sgd(0.05, momentum=0.9)
    params = scaled_params(ref_arch("glm4-9b", reduced=True))
    n0 = _counts()
    plain = make_train_step(model, opt)
    assert not isinstance(plain, TrainStep)
    state = _state(params, opt)
    for b in _batches(pc.vocab, 3, (2, 16)):
        state, _ = plain(state, b)
    cfg = fed.FedRoundConfig(local_steps=2)
    f = fed.init_fed_state(_state(params, opt), 2, cfg)
    round_step = fed.make_fed_round_step(model, opt, cfg, 2)
    tokens = torch.from_numpy(_tokens(pc.vocab, (2, 2, 2, 16), 5))
    for _ in range(2):
        f, _ = round_step(f, {"tokens": tokens})
    counts = dryrun.trace_step(model, InputShape("t", 16, 2, "train"),
                               "train")
    assert counts["flops"] > 0
    assert recorded == [] and _counts() == n0
