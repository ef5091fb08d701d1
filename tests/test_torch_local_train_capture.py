"""The sequential engine's client step and eval step as CUDA graphs: the
port's counterparts of the reference's jitted ``make_client_step`` and
``make_eval_step`` (``core/local_train.py``), which every client of a
hyperparameter set shares and which compile once a batch shape.

* The reference's contract: after a sequential ``run()`` of 3 rounds x 4
  clients of one batch size the reference's jitted client step and eval
  step have each compiled once (``_cache_size() == 1``); the port's steps,
  on a recording graph, warm up once, capture once, never recapture and
  replay every later step, and the run equals the eager run bit for bit.
* ``local_train`` and ``evaluate`` through the graph equal their eager
  path bit for bit (SGD-momentum and AdamW, FedProx and clipping on, a
  partial last eval batch) and the reference's ``local_train`` within its
  engine-parity tolerance (1e-5).
* No op of either step makes the host wait (``HostSyncMode``); no
  returned tensor aliases a step's static buffers; four remote client
  services training at once take turns on the step (the device lock) and
  end at the serial run's params; ``reset()`` empties both caches.
* A step's graphs share one memory pool; the flash-attention flag is part
  of every captured program's key (the steps', the round's, the serve
  step's).

The capture logic runs here with a recording graph in place of the CUDA
one (``_RecordedGraph``); ``tests/test_torch_cuda.py`` runs the real
graph on a card.
"""
import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro.core import local_train as ref_lt  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.optim import get_optimizer as ref_get_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.contracts import HostSyncMode  # noqa: E402
from repro_torch.core import api as pt_api  # noqa: E402
from repro_torch.core import local_train as lt  # noqa: E402
from repro_torch.core.config import Config as PortConfig  # noqa: E402
from repro_torch.data.fed_data import build_federated_data  # noqa: E402
from repro_torch.deploy import Registry  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

pt.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made such runs many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    ref.reset()
    pt.reset()
    yield
    ref.reset()
    pt.reset()


LINEAR = {
    "model": "linear",
    "data": {"dataset": "synthetic", "num_clients": 8, "batch_size": 64},
    "server": {"rounds": 3, "clients_per_round": 4},
    "client": {"local_epochs": 1, "lr": 0.1},
}


class _RecordedGraph:
    """Stands in for ``utils.capture.CapturedGraph`` on the CPU: keeps
    static copies of the inputs and runs nothing at capture (a capture
    records); each call copies the call's inputs into them, runs the
    captured function on them (a replay) and returns a copy of its
    output.  ``captured_with`` holds, for each capture, how many threads
    were inside a step's run meanwhile; ``pool_in`` the pool it was asked
    to share."""
    made = []
    captured_with = []

    def __init__(self, run, inputs, device, counts, pool=None):
        self.pool_in = pool
        leaves, self.treedef = tree_flatten(inputs)
        self.static = [t.clone() for t in leaves]
        self.run = run
        self.calls = 0
        self.counts = counts
        counts.captures += 1
        _RecordedGraph.made.append(self)
        _RecordedGraph.captured_with.append(_Inside.now)

    def pool(self):
        return ("pool", id(self))

    def __call__(self, inputs):
        for buf, t in zip(self.static, tree_leaves(inputs)):
            buf.copy_(t)
        self.calls += 1
        self.counts.replays += 1
        out = self.run(tree_unflatten(self.treedef, self.static))
        return tree_map(lambda t: t.clone(), out)


class _Inside:
    """How many threads are inside ``ClientStep.run`` now, and the most at
    once."""
    now = 0
    most = 0
    lock = threading.Lock()


@pytest.fixture()
def recorded(monkeypatch):
    """The recording graph, on the CPU."""
    monkeypatch.setattr(lt, "CapturedGraph", _RecordedGraph)
    monkeypatch.setattr(_RecordedGraph, "made", [])
    monkeypatch.setattr(_RecordedGraph, "captured_with", [])
    monkeypatch.setattr(lt._GraphedStep, "graph_device_types", ("cpu",))
    return _RecordedGraph.made


@contextlib.contextmanager
def _eager():
    """Every step runs eagerly inside (the eager side of an A/B)."""
    kept = lt._GraphedStep.graph_device_types
    lt._GraphedStep.graph_device_types = ()
    try:
        yield
    finally:
        lt._GraphedStep.graph_device_types = kept


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _ref_init(cfg):
    rcfg = RefConfig.make(cfg)
    return jax.tree_util.tree_map(np.asarray, ref_get_model(rcfg.model).init(
        jax.random.PRNGKey(rcfg.seed)))


def _steps_of_run(cfg):
    """The client steps a sequential run of ``cfg`` takes (the port's
    tracker's selections, each client's batches) and its eval batches."""
    pcfg = PortConfig.make(cfg)
    data = build_federated_data(pcfg.data)
    task = pt.tracker().get_task(pcfg.task_id)
    bs, ep = pcfg.data.batch_size, pcfg.client.local_epochs
    steps = sum(-(-len(data.clients[c]) // bs) * ep
                for r in range(pcfg.server.rounds)
                for c in task.rounds[r].clients)
    evals = -(-len(data.test) // pcfg.data.test_batch_size)
    return steps, evals * pcfg.server.rounds


def _port_steps(cfg):
    """The port's cached client and eval steps of the active context."""
    ctx = pt_api._ctx
    c = ctx.config.client
    opt = get_optimizer(c.optimizer, c.lr, c.momentum, c.weight_decay,
                        c.nesterov, c.adam_b1, c.adam_b2, c.adam_eps)
    return (lt.make_client_step(ctx.model, opt, c.proximal_mu,
                                c.max_grad_norm),
            lt.make_eval_step(ctx.model))


# ---------------------------------------------------------------------------
# (a) the reference's contract
# ---------------------------------------------------------------------------


def test_sequential_run_compiles_each_step_once_as_the_reference(recorded):
    """3 rounds x 4 clients of one batch size: the reference's jitted
    client step and eval step each compile once; the port's steps warm up
    once, capture once, never recapture, replay every later step, and the
    run equals the eager run bit for bit."""
    from repro.core import api as ref_api

    p0 = _ref_init(LINEAR)
    ref.init(LINEAR)
    ref.run()
    rc = ref_api._ctx.config.client
    ref_opt = ref_get_optimizer(rc.optimizer, rc.lr, rc.momentum,
                                rc.weight_decay, rc.nesterov, rc.adam_b1,
                                rc.adam_b2, rc.adam_eps)
    assert ref_lt.make_client_step(ref_api._ctx.model, ref_opt,
                                   rc.proximal_mu,
                                   rc.max_grad_norm)._cache_size() == 1
    assert ref_lt.make_eval_step(ref_api._ctx.model)._cache_size() == 1

    out = {}
    for capture in (True, False):
        pt.reset()
        pt.init(LINEAR)
        with contextlib.nullcontext() if capture else _eager():
            ctx = pt_api._ctx
            from repro_torch.core.rounds import Trainer
            trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                              tracker=ctx.tracker)
            trainer.server.params = convert.params_from_jax(p0)
            n0 = (lt.client_step_capture_count(),
                  lt.client_step_replay_count(),
                  lt.eval_step_capture_count(), lt.eval_step_replay_count())
            res = trainer.run()
            n1 = (lt.client_step_capture_count(),
                  lt.client_step_replay_count(),
                  lt.eval_step_capture_count(), lt.eval_step_replay_count())
            step, ev = _port_steps(LINEAR)
            out[capture] = (res, step, ev, [b - a for a, b in zip(n0, n1)],
                            _steps_of_run(LINEAR))
    (res, step, ev, counts, (steps, evals)), (eres, estep, eev, ecounts, _) \
        = out[True], out[False]
    assert steps > 12 and evals > 3      # several batches a client, a set
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (1, 1, 0, steps - 1)
    assert (ev.eager_steps, ev.captures, ev.recaptures,
            ev.replays) == (1, 1, 0, evals - 1)
    assert len(step.keys()) == 1 and len(ev.keys()) == 1
    assert counts == [1, steps - 1, 1, evals - 1]
    assert len(recorded) == 2
    # the eager twin: every step eager, nothing captured
    assert (estep.captures, estep.replays, estep.eager_steps) == \
        (0, 0, 0) and ecounts == [0, 0, 0, 0]
    assert _same_bits(res["params"], eres["params"])
    for key in ("train_loss", "loss", "accuracy"):
        assert [h[key] for h in res["history"]] == \
            [h[key] for h in eres["history"]], key


def test_a_new_batch_size_or_flash_flag_is_a_new_key_in_one_pool(
        recorded):
    """Clients of two batch sizes share the step: a key each, each warmed
    up and captured once; the flash-attention flag flipped selects a third
    key, warmed up and captured once as well (no recapture); the three
    graphs share the first one's memory pool; every run equals the same
    step run eagerly."""
    from repro_torch.models import attention

    model = get_model("linear")
    opt = get_optimizer("sgd", 0.1, 0.9)
    rs = np.random.RandomState(0)
    x = rs.randn(40, 64).astype(np.float32)
    y = rs.randint(0, 10, 40).astype(np.int32)
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    step = lt.make_client_step(model, opt, 0.0, 0.0)
    try:
        for i, (bs, seed) in enumerate([(8, 0), (16, 1), (8, 2), (16, 3),
                                        (8, 4), (8, 5)]):
            if i == 4:
                attention.set_flash_attention(True)
            kw = dict(epochs=1, batch_size=bs, optimizer=opt, seed=seed)
            got = lt.local_train(model, p0, x, y, **kw)
            with _eager():
                want = lt.local_train(model, p0, x, y, **kw)
            assert got[1] == want[1]
            assert _same_bits(got[0], want[0])
    finally:
        attention.set_flash_attention(None)
    assert len(step.keys()) == 3
    # 8: warm-up, capture; 16: warm-up, capture; 8 with flash on: warm-up,
    # capture
    assert (step.captures, step.recaptures, step.eager_steps) == (3, 0, 3)
    assert step.replays == 4 * 5 + 2 * 3 - 3  # 5 steps at 8, 3 at 16
    assert len(recorded) == 3 and recorded[0].pool_in is None
    assert [g.pool_in for g in recorded[1:]] == [recorded[0].pool()] * 2


def test_every_capture_key_holds_the_flash_flag():
    """The round's and the serve step's keys change with the
    flash-attention flag and come back with it, as the steps' do."""
    from repro_torch.core import batched
    from repro_torch.models import attention
    from repro_torch.models import model as pt_model

    t = torch.zeros(2, 3)
    keys = []
    for flag in (False, True, False):
        attention.set_flash_attention(flag)
        try:
            keys.append((
                pt_model.serve_key({"w": t}, {"k": t}, t.long(), False)[0],
                batched.capture_key("program", (t, None), [t])[1]))
        finally:
            attention.set_flash_attention(None)
    assert keys[0] == keys[2]
    assert keys[0][0] != keys[1][0] and keys[0][1] != keys[1][1]


# ---------------------------------------------------------------------------
# (b), (c) the captured path against the eager path and the reference
# ---------------------------------------------------------------------------


def _client_data(n=37, seed=0):
    data = build_federated_data(PortConfig.make(LINEAR).data)
    c = data.clients["client_0000"]
    return c.x[:n], c.y[:n]


@pytest.mark.parametrize("prox,clip", [(0.0, 0.0), (0.1, 0.3)],
                         ids=["plain", "prox-clip"])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_captured_local_train_and_evaluate_equal_the_eager_path(
        recorded, optimizer, prox, clip):
    """Three clients in turn through the shared step (the first warms up
    and captures, the others replay from their first step), then the
    evaluation of a set whose last batch is partial: params, loss and
    accuracy bit for bit the eager path's."""
    model = get_model("linear")
    opt = get_optimizer(optimizer, 0.05, 0.9)
    x, y = _client_data()
    p0 = model.init(torch.Generator().manual_seed(1), "cpu")
    anchor = tree_map(lambda t: t + 0.05, p0)
    step = lt.make_client_step(model, opt, prox, clip)
    ev = lt.make_eval_step(model)
    for i in range(3):
        kw = dict(epochs=2, batch_size=8, optimizer=opt, proximal_mu=prox,
                  max_grad_norm=clip, seed=11 + i, global_params=anchor)
        got = lt.local_train(model, p0, x, y, **kw)
        with _eager():
            want = lt.local_train(model, p0, x, y, **kw)
            ev_want = lt.evaluate(model, want[0], x, y, batch_size=16)
        ev_got = lt.evaluate(model, got[0], x, y, batch_size=16)
        assert got[1] == want[1] and ev_got == ev_want
        assert _same_bits(got[0], want[0])
    n = 2 * 5                              # 2 epochs of ceil(37 / 8)
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (1, 1, 0, 3 * n - 1)
    assert (ev.eager_steps, ev.captures, ev.replays) == (1, 1, 3 * 3 - 1)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_captured_local_train_matches_the_reference(recorded, optimizer):
    """The captured path (FedProx and clipping on, a distinct anchor, the
    second client of the step: a replay from its first step) against the
    reference's ``local_train``: params within 1e-5, loss and accuracy as
    ``tests/test_torch_sequential.py`` holds them; the evaluation with a
    partial last batch against the reference's ``evaluate``."""
    cfg = dict(LINEAR, client={"optimizer": optimizer})
    rc = RefConfig.make(cfg).client
    hp = (rc.optimizer, 0.05, rc.momentum, rc.weight_decay, rc.nesterov,
          rc.adam_b1, rc.adam_b2, rc.adam_eps)
    x, y = _client_data()
    p0 = _ref_init(LINEAR)
    gp = jax.tree_util.tree_map(lambda a: a + np.float32(0.05), p0)
    kw = dict(epochs=2, batch_size=8, proximal_mu=0.1, max_grad_norm=0.3,
              seed=11)
    ref_p, ref_m = ref_lt.local_train(
        ref_get_model("linear"), jax.tree_util.tree_map(jnp.asarray, p0),
        x, y, optimizer=ref_get_optimizer(*hp),
        global_params=jax.tree_util.tree_map(jnp.asarray, gp), **kw)
    model = get_model("linear")
    port = dict(model=model, optimizer=get_optimizer(*hp),
                global_params=convert.params_from_jax(gp), **kw)
    lt.local_train(data_x=x[::-1].copy(), data_y=y[::-1].copy(),
                   params=convert.params_from_jax(p0), **port)
    port_p, port_m = lt.local_train(
        data_x=x, data_y=y, params=convert.params_from_jax(p0), **port)
    step = lt.make_client_step(model, port["optimizer"], 0.1, 0.3)
    assert step.captures == 1 and step.replays == 2 * 10 - 1
    for a, b in zip(jax.tree_util.tree_leaves(ref_p), tree_leaves(port_p)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert ref_m["batches"] == port_m["batches"]
    np.testing.assert_allclose(port_m["loss"], ref_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(port_m["accuracy"], ref_m["accuracy"],
                               rtol=1e-6)
    for _ in range(2):                 # warm-up, then capture and replays
        port_e = lt.evaluate(model, port_p, x, y, batch_size=16)
    ref_e = ref_lt.evaluate(ref_get_model("linear"), ref_p, x, y,
                            batch_size=16)
    assert lt.make_eval_step(model).captures == 1
    np.testing.assert_allclose(port_e["loss"], ref_e["loss"], rtol=1e-5)
    np.testing.assert_allclose(port_e["accuracy"], ref_e["accuracy"],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# (d) no host sync, (e) no aliasing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_neither_step_makes_the_host_wait(recorded, optimizer):
    """The client step's local run (warm-up, capture, replays; FedProx and
    clipping on) and the eval step's batches, with nothing that waits on
    the device: no scalar read, no data-dependent shape, no copy to the
    host."""
    model = get_model("linear")
    opt = get_optimizer(optimizer, 0.05, 0.9)
    x, y = (torch.from_numpy(a) for a in _client_data())
    idx = torch.from_numpy(lt.cyclic_batches(len(x), 8, 0))
    p0 = model.init(torch.Generator().manual_seed(1), "cpu")
    step = lt.make_client_step(model, opt, 0.1, 0.3)
    ev = lt.make_eval_step(model)
    batches = [(x[s:s + 8], y[s:s + 8]) for s in range(0, 32, 8)]
    with HostSyncMode() as mode:
        for _ in range(2):
            params, losses, accs = step.run(p0, x, y, idx, p0)
            ev.run(params, batches)
    assert mode.found == []
    assert step.captures == 1 and ev.captures == 1 and ev.replays == 7


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


def test_returned_params_alias_no_static_buffer(recorded):
    """Client A's params stay as returned after clients B and C train
    through the same step, and no returned tensor (params, per-step
    metrics) shares storage with a slot's buffers or the graph's."""
    model = get_model("femnist_cnn")
    opt = get_optimizer("sgd", 0.01, 0.9)
    rs = np.random.RandomState(3)
    x = rs.rand(24, 784).astype(np.float32)
    y = rs.randint(0, 62, 24).astype(np.int32)
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    step = lt.make_client_step(model, opt, 0.0, 0.0)
    idx = torch.from_numpy(lt.cyclic_batches(24, 8, 0))
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    out_a, la, aa = step.run(p0, xs, ys, idx)
    kept = tree_map(torch.clone, out_a)
    others = [step.run(out_a, xs, ys, idx.flip(0)) for _ in range(2)]
    assert _same_bits(out_a, kept)
    slot = step._slots[step.keys()[0]]
    static = _storages(slot.params + slot.state) | _storages(
        recorded[0].static)
    for params, losses, accs in [(out_a, la, aa)] + others:
        assert not (_storages(params) | _storages(losses + accs)) & static
    assert not _same_bits(others[0][0], out_a)


# ---------------------------------------------------------------------------
# (f) threads: remote client services, (g) reset
# ---------------------------------------------------------------------------


def test_remote_services_take_turns_on_the_step(recorded, monkeypatch):
    """Four client services of one process train at once (a request each
    a round, threads of their RPC servers) through the recording graph:
    no two threads are ever inside the step's run, no capture happens
    while another thread is inside it, and the run ends at the serial
    ``init(); run()`` run's params, losses and accuracy bit for bit."""
    cfg = dict(LINEAR, data=dict(LINEAR["data"], num_clients=4),
               server={"rounds": 2, "clients_per_round": 4})
    pt.init(cfg)
    seq = pt.run()
    pt.reset()
    _RecordedGraph.captured_with.clear()

    run = lt.ClientStep.run

    def counted(self, *args, **kw):
        with _Inside.lock:
            _Inside.now += 1
            _Inside.most = max(_Inside.most, _Inside.now)
        try:
            return run(self, *args, **kw)
        finally:
            with _Inside.lock:
                _Inside.now -= 1

    monkeypatch.setattr(lt.ClientStep, "run", counted)
    monkeypatch.setattr(_Inside, "most", 0)
    pt.init(cfg)
    reg = Registry()
    ids = sorted(pt_api._ctx.fed_data.clients)
    clients = [pt.start_client({"client_id": c, "registry": reg,
                                "latency": 0.01}) for c in ids]
    srv = pt.start_server({"registry": reg})
    try:
        hist = srv.run(2)
    finally:
        srv.stop()
        for c in clients:
            c.stop()
    step, _ = _port_steps(cfg)
    assert (step.captures, step.recaptures) == (1, 0)
    # the eval step's capture on the server's thread, nobody inside a
    # client's run; the client step's with only its own thread inside
    assert sorted(_RecordedGraph.captured_with) == [0, 1]
    assert _Inside.most == 1 and _Inside.now == 0
    assert _same_bits(srv.server.params, seq["params"])
    for key in ("train_loss", "accuracy", "loss"):
        assert [h[key] for h in hist] == \
            [h[key] for h in seq["history"]], key


def test_reset_empties_both_step_caches(recorded):
    pt.init(dict(LINEAR, server={"rounds": 1, "clients_per_round": 2}))
    pt.run()
    assert lt.make_client_step.cache_info().currsize == 1
    assert lt.make_eval_step.cache_info().currsize == 1
    pt.reset()
    assert lt.make_client_step.cache_info().currsize == 0
    assert lt.make_eval_step.cache_info().currsize == 0
