"""The cohort program as CUDA graphs: the port's counterpart of the
reference's ``jax.jit(make_cohort_program(...), donate_argnums=(0,))``
(``core/batched.py::BatchedExecutor.run_cohort_stacked`` →
``_train_cohort``), which carries the staged path and every async wave.

* One graph a (program, shapes) key: the first call eager (the warm-up),
  the second captures, later calls replay, nothing recaptures; a new
  bucket, batch shape or flash flag is a new key; the graphs of an
  executor share one memory pool; under a mesh and with ``capture=False``
  the program runs eagerly.
* Captured equals eager bit for bit: the staged run, the async run with
  the measured wall pinned, and the executor's calls one by one.  The
  staged and the async run equal the reference's within 1e-5 on params
  and 1e-4 on loss (``tests/test_lora.py:231``).
* The program makes the host wait nowhere (``HostSyncMode``); nothing
  returned aliases a graph's buffers; ``reset()`` drops the graphs.

The capture logic runs here with a recording graph in place of the CUDA
one (``_RecordedGraph``); ``tests/test_torch_cuda.py`` runs the real graph
on a card.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as pt  # noqa: E402
from repro_torch.analysis.contracts import HostSyncMode  # noqa: E402
from repro_torch.core import api as pt_api  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.batched import BatchedExecutor  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.config import ClientConfig  # noqa: E402
from repro_torch.data.fed_data import ClientData  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.small import linear_model  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)
from test_torch_async import (  # noqa: E402
    _assert_params, _make_trainer, _pin_wall, _ref_trainer,
)
from test_torch_sequential import (  # noqa: E402
    LINEAR, _assert_trajectory, _init_params, _merge, _run_port, _run_ref,
)

pt.set_device("cpu")
CPU = torch.device("cpu")


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
    pt.reset()
    yield
    pt.reset()


class _RecordedGraph:
    """Stands in for ``utils.capture.CapturedGraph`` on the CPU: keeps
    static copies of the inputs and runs nothing at capture (a capture
    records); each call copies the call's inputs into them, runs the
    captured function on them (a replay) and returns a copy of its
    output.  ``pool_in``: the pool it was asked to share."""
    made = []

    def __init__(self, run, inputs, device, counts, pool=None):
        self.pool_in = pool
        leaves, self.treedef = tree_flatten(inputs)
        self.static = [None if t is None else t.clone() for t in leaves]
        self.run = run
        self.calls = 0
        self.counts = counts
        counts.captures += 1
        _RecordedGraph.made.append(self)

    def pool(self):
        return ("pool", id(self))

    def __call__(self, inputs):
        for buf, t in zip(self.static, tree_leaves(inputs)):
            if buf is not None:
                buf.copy_(t)
        self.calls += 1
        self.counts.replays += 1
        out = self.run(tree_unflatten(self.treedef, self.static))
        return tree_map(lambda t: None if t is None else t.clone(), out)


@pytest.fixture()
def recorded(monkeypatch):
    """The recording graph, on the CPU: executors built inside capture
    their cohorts (never a fused round: these tests take the staged and
    the async paths)."""
    monkeypatch.setattr(batched, "CapturedGraph", _RecordedGraph)
    monkeypatch.setattr(_RecordedGraph, "made", [])
    monkeypatch.setattr(BatchedExecutor, "graph_device_types", ("cpu",))
    return _RecordedGraph.made


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _counts():
    return batched.cohort_capture_count(), batched.cohort_replay_count()


def _since(n0):
    return tuple(b - a for a, b in zip(n0, _counts()))


MODEL = linear_model(din=16, classes=4)


def _clients(n, start=0, seed=0, batch_size=8, rows=32):
    rs = np.random.RandomState(seed)
    return [Client(f"c{start + i}", MODEL,
                   ClientData(rs.randn(rows, 16).astype(np.float32),
                              rs.randint(0, 4, rows).astype(np.int32)),
                   ClientConfig(lr=0.1, local_epochs=1, momentum=0.9),
                   batch_size=batch_size)
            for i in range(n)]


def _params(seed=0):
    return MODEL.init(torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# (a) one graph a key, the shared pool, eager where the fused round is
# ---------------------------------------------------------------------------


def test_a_new_bucket_batch_shape_or_flash_flag_is_a_new_key_in_one_pool(
        recorded):
    """Cohorts of 4 clients (bucket 4) three times, 6 clients (bucket 8)
    twice, 4 clients at batch size 16 twice, then 4 at batch size 8 with
    the flash-attention flag on twice: four keys, each warmed up once and
    captured once (nothing recaptures), every later call a replay, the
    four graphs in the first one's pool; every call's updates, loss and
    accuracy bit for bit the eager executor's."""
    ex = BatchedExecutor(MODEL, CPU)
    eager = BatchedExecutor(MODEL, CPU, capture=False)
    assert ex.capture and not eager.capture
    script = ([(_clients(4), False)] * 3 + [(_clients(6, seed=1), False)] * 2
              + [(_clients(4, seed=2, batch_size=16), False)] * 2
              + [(_clients(4, seed=3), True)] * 2)
    n0 = _counts()
    try:
        for r, (cohort, flash) in enumerate(script):
            attention.set_flash_attention(flash)
            params = _params(r)
            got = ex.run_cohort_stacked(cohort, params, r)
            want = eager.run_cohort_stacked(cohort, params, r)
            assert _same_bits(got["updates"], want["updates"])
            assert np.array_equal(got["loss"], want["loss"])
            assert np.array_equal(got["acc"], want["acc"])
    finally:
        attention.set_flash_attention(None)
    assert len(ex._cohorts) == 4 and len(recorded) == 4
    assert [g.calls for g in recorded] == [2, 1, 1, 1]
    assert _since(n0) == (4, 5)
    assert recorded[0].pool_in is None
    assert [g.pool_in for g in recorded[1:]] == [recorded[0].pool()] * 3
    assert eager._cohorts == {}


def test_the_cohort_runs_eagerly_under_a_mesh_and_with_capture_off(
        recorded):
    """The fused round's rules: ``capture=False`` and a client mesh (the
    cohort spans the mesh's devices) run every call eagerly."""
    clients = _clients(4)
    n0 = _counts()
    for ex in (BatchedExecutor(MODEL, CPU, capture=False),
               BatchedExecutor(MODEL, CPU, distributed="data",
                               devices=[CPU, CPU])):
        assert not ex.capture
        for r in range(3):
            ex.run_cohort_stacked(clients, _params(), r)
        assert ex._cohorts == {}
    assert _since(n0) == (0, 0) and recorded == []


# ---------------------------------------------------------------------------
# (b) the staged and the async run: captured = eager, and the reference
# ---------------------------------------------------------------------------

STAGED = _merge(LINEAR, {"server": {"rounds": 4, "clients_per_round": 4},
                         "data": {"num_clients": 4},
                         "resources": {"execution": "batched",
                                       "round_fusion": "off",
                                       "aggregation_kernel": True}})


def _staged_run(cfg, p0, capture):
    kept = BatchedExecutor.graph_device_types
    if not capture:
        BatchedExecutor.graph_device_types = ()
    try:
        n0 = _counts()
        trainer, res = _run_port(cfg, p0)
        return trainer, res, _since(n0)
    finally:
        BatchedExecutor.graph_device_types = kept


@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_staged_run_captures_once_and_matches_eager_and_the_reference(
        recorded, compression):
    """4 rounds of the same 4 clients on the staged path: round 0 warms
    up, round 1 captures, rounds 1-3 replay; params, losses and wire bytes
    bit for bit the eager run's, and within 1e-5 / 1e-4 of the
    reference's staged run.  Under int8 the reference's own staged run
    lands one int8 rounding flip (7.8e-4 in one element from round 2 on)
    from its fused run, whose program rounds its sums differently, while
    the port's staged run equals its fused run bit for bit (``tests/
    test_torch_batched_paths.py``) and lands 2.4e-7 from the reference's
    fused run: under int8 the port is held against that one."""
    cfg = _merge(STAGED, {"client": {"compression": compression}})
    p0 = _init_params(cfg)
    ref, ref_res = _run_ref(cfg if compression != "int8" else _merge(
        cfg, {"resources": {"round_fusion": "auto"}}))
    port, res, counts = _staged_run(cfg, p0, True)
    _, eres, ecounts = _staged_run(cfg, p0, False)
    assert counts == (1, 3) and ecounts == (0, 0)
    assert len(port.engine._cohorts) == 1 and len(recorded) == 1
    assert _same_bits(res["params"], eres["params"])
    for key in ("train_loss", "comm_up_bytes"):
        assert [h[key] for h in res["history"]] == \
            [h[key] for h in eres["history"]], key
    _assert_trajectory(ref, ref_res, port, res, rounds=4)


@pytest.mark.parametrize("comp", ["none", "stc"])
def test_async_run_with_pinned_wall_matches_eager_and_the_reference(
        recorded, monkeypatch, tmp_path, comp):
    """The async engine, K 3 of 8 in flight at a 4x speed spread, the
    measured wall pinned in both packages: waves of several buckets, each
    bucket's cohort warmed up once and captured once; the virtual clock,
    staleness and params bit for bit the eager run's, and the reference's
    within 1e-5 on params and 1e-4 on loss."""
    _pin_wall(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = {"execution": "async", "buffer_size": 3, "max_concurrency": 8}
    kw = dict(server_over={"rounds": 5, "clients_per_round": 4},
              ratios=(1.0, 4.0), comp=comp)
    out = {}
    for capture in (True, False):
        if not capture:
            monkeypatch.setattr(BatchedExecutor, "graph_device_types", ())
        n0 = _counts()
        trainer = _make_trainer(res, **kw)
        out[capture] = (trainer.run(), _since(n0), trainer.engine)
    (got, counts, ex), (want, ecounts, _) = out[True], out[False]
    keys = len(ex._cohorts)
    assert keys >= 1 and counts[0] == keys == len(recorded)
    assert sum(g.calls for g in recorded) == counts[1] > keys
    assert ecounts == (0, 0)
    assert _same_bits(got["params"], want["params"])
    for key in ("round_time", "virtual_time", "staleness_mean",
                "staleness_max", "train_loss", "comm_up_bytes"):
        assert [h[key] for h in got["history"]] == \
            [h[key] for h in want["history"]], key
    rr = _ref_trainer(res, **kw).run()
    _assert_params(rr["params"], got["params"])
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in rr["history"]],
                               rtol=1e-4, atol=1e-4)
    assert max(h["staleness_max"] for h in got["history"]) > 0


# ---------------------------------------------------------------------------
# (c) no host sync, no aliasing, reset
# ---------------------------------------------------------------------------


def _program_and_inputs(ex, clients, r):
    nb, s, vec, opt, xd, yd, idx, n_steps = ex._cohort_inputs(clients, r)
    cohort = batched.make_cohort_program(MODEL, opt, s, use_prox=False,
                                         use_clip=False)
    return cohort, nb, (_params(), xd, yd, ex._put(idx), ex._put(n_steps),
                        ex._vec(vec))


def test_the_cohort_program_makes_no_host_wait(recorded):
    """The warm-up, the capture and two replays with nothing that waits
    on the device: no scalar read, no data-dependent shape, no copy to the
    host (the staged path's one fetch comes after, outside)."""
    ex = BatchedExecutor(MODEL, CPU)
    clients = _clients(4)
    calls = [_program_and_inputs(ex, clients, r) for r in range(4)]
    with HostSyncMode() as mode:
        for cohort, nb, inputs in calls:
            ex._train_cohort(cohort, nb, inputs)
    assert mode.found == []
    assert len(recorded) == 1 and recorded[0].calls == 3


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


def test_returned_updates_alias_no_static_buffer(recorded):
    """A cohort's stacked updates stay as returned after two more cohorts
    replay the same graph, and share no storage with its buffers."""
    ex = BatchedExecutor(MODEL, CPU)
    clients = _clients(4)
    ex.run_cohort_stacked(clients, _params(0), 0)        # warm-up
    first = ex.run_cohort_stacked(clients, _params(1), 1)
    kept = tree_map(torch.clone, first["updates"])
    later = [ex.run_cohort_stacked(clients, _params(2 + r), 2 + r)
             for r in range(2)]
    assert _same_bits(first["updates"], kept)
    assert not _same_bits(later[0]["updates"], kept)
    static = _storages([t for t in recorded[0].static if t is not None])
    for st in [first] + later:
        assert not _storages(st["updates"]) & static


def test_reset_drops_the_cohort_graphs(recorded):
    """``reset()`` drops the context's trainer, and with it its executor's
    cohort graphs and their pool."""
    pt.init({"model": "linear", "dataset": "synthetic",
             "data": {"num_clients": 4, "batch_size": 32},
             "server": {"rounds": 2, "clients_per_round": 4},
             "client": {"local_epochs": 1, "lr": 0.1},
             "resources": {"execution": "batched", "round_fusion": "off"}})
    pt.run()
    ex = pt_api._ctx.trainer.engine
    assert len(ex._cohorts) == 1 and ex._cohort_pool is not None
    graph = weakref.ref(recorded[0])
    held = weakref.ref(ex)
    del ex
    recorded.clear()
    pt.reset()
    gc.collect()
    assert held() is None and graph() is None


class _RecordedRound(_RecordedGraph):
    """``batched.CapturedRound``'s stand-in: the recording graph with the
    round's counts."""

    def __init__(self, run, inputs, device):
        super().__init__(run, inputs, device, batched._round_graphs)


def test_the_contracts_gate_counts_the_staged_cohorts_graphs(recorded,
                                                             monkeypatch):
    """``check_contracts`` where the executor captures (the recording
    graph in place of the card's): the staged cohort's call 0 eager, then
    1 capture, 0 recaptures and 1 replay a call, as the fused round's
    rounds; one dispatch and one host sync a call."""
    from repro_torch.analysis import contracts

    monkeypatch.setattr(batched, "CapturedRound", _RecordedRound)
    report = contracts.check_contracts(device=CPU)
    assert report.ok, report.format()
    assert (report.cohort_dispatches_per_call,
            report.cohort_host_syncs_per_call) == (1, 1)
    assert (report.cohort_captures, report.cohort_recaptures,
            report.cohort_replays_per_call) == (1, 0, 1)
    assert (report.fused_captures, report.fused_recaptures,
            report.fused_replays_per_round) == (1, 0, 1)
    assert "staged cohort CUDA graph captures=1, recaptures=0, " \
        "replays/call=1" in report.format()
