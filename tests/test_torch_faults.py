"""Fault-tolerant rounds of ``repro_torch`` (``cfg.faults``,
``resources.round_deadline``): the synchronous cases of the reference's
``tests/test_faults.py`` on the port, and the port against the reference
on every path.

Sizes are the reference's ``_make_trainer``: ``linear`` / ``synthetic``, 8
clients, 5 a round, 2 local epochs (2 rounds a run where the reference
takes 3), the reference's initial params injected through
``convert.params_from_jax``.  Bars against the reference:
per-round fault accounting identical, params within 1e-5, losses within
1e-4; EF stores after each faulty round with the same client ids, values
within 1e-5, and a residual that a path must leave untouched bitwise
untouched.  Deadlines are decided by the virtual clock by wide margins
(1e-12 s, a 10x straggler), never by measured wall time."""
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.core.rounds import _poison_update as ref_poison  # noqa: E402
from repro.core.rounds import update_is_valid as ref_valid  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro.data.fed_data import build_federated_data as ref_build  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.simulation.heterogeneity import FaultInjector as RefInjector  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import batched as port_batched  # noqa: E402
from repro_torch.core.client import Client as PortClient  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    Config, FaultConfig, validate_fault_config,
)
from repro_torch.core.rounds import Trainer, _poison_update, update_is_valid  # noqa: E402
from repro_torch.core.server import Server  # noqa: E402
from repro_torch.data.fed_data import build_federated_data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.simulation.heterogeneity import FaultInjector  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and under
    a loaded parallel test run torch's thread pool made these runs some 20x
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: every fault kind at least once in rounds 0-1, and residuals of earlier
#: rounds that round 1 must leave untouched (seed chosen for that coverage)
FAULTS = {"dropout_prob": 0.2, "crash_prob": 0.2, "straggler_prob": 0.3,
          "nan_update_prob": 0.2, "seed": 8}
ACCOUNTING = ("dropped", "crashed", "straggled", "rejected",
              "deadline_missed", "reselections", "survivors", "clients")


def _cfg(execution, faults=None, resources=None, ckpt=None, comp="none",
         rounds=2, tracking=False):
    return {
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 8, "batch_size": 32},
        "server": {"rounds": rounds, "clients_per_round": 5,
                   "test_every": 0},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": comp},
        "resources": {"execution": execution, **(resources or {})},
        "tracking": {"enabled": tracking},
        "faults": faults or {},
        "checkpoint": ckpt or {},
    }


_P0 = {}


def _p0():
    """The reference's initial params of the linear model (seed 0)."""
    if not _P0:
        _P0["p"] = jax.tree_util.tree_map(np.asarray, ref_get_model(
            "linear").init(jax.random.PRNGKey(0)))
    return _P0["p"]


def _make_trainer(execution, faults=None, resources=None, ckpt=None,
                  comp="none", rounds=2, server_cls=Server,
                  client_cls=PortClient, tracking=False):
    cfg = Config.make(_cfg(execution, faults, resources, ckpt, comp, rounds,
                           tracking))
    model = get_model("linear")
    fed = build_federated_data(cfg.data)
    trainer = Trainer(cfg, model, fed, server=server_cls(model, cfg, fed.test),
                      client_cls=client_cls)
    trainer.server.params = convert.params_from_jax(_p0())
    return trainer


def _ref_trainer(execution, faults=None, resources=None, comp="none",
                 rounds=2, client_cls=RefClient, ckpt=None):
    cfg = RefConfig.make(_cfg(execution, faults, resources, ckpt, comp,
                              rounds))
    model = ref_get_model("linear")
    fed = ref_build(cfg.data)
    trainer = RefTrainer(cfg, model, fed, server=RefServer(model, cfg,
                                                           fed.test),
                         client_cls=client_cls)
    trainer.server.params = jax.tree_util.tree_map(jax.numpy.asarray, _p0())
    return trainer


def _bits(tree):
    return [t.clone() for t in tree_leaves(tree)]


def _params_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# parity: faults disabled is bit-identical to no faults block at all
# ---------------------------------------------------------------------------


def _counted_run(trainer):
    ops.reset_launch_counts()
    b0 = port_batched.round_trace_count()
    d0 = port_batched.dispatch_count()
    h0 = port_batched.host_sync_count()
    res = trainer.run()
    return res, (port_batched.round_trace_count() - b0,
                 port_batched.dispatch_count() - d0,
                 port_batched.host_sync_count() - h0, ops.launch_counts())


@pytest.mark.parametrize("execution,resources,comp", [
    ("sequential", None, "stc"),
    ("batched", None, "int8"),
    ("batched", {"round_fusion": "off"}, "stc"),
    ("batched", {"aggregation_topology": "hierarchical"}, "none"),
])
def test_faults_all_zero_is_bit_identical(execution, resources, comp):
    repro_torch.reset()           # no cached program: equal build counts
    r0, n0 = _counted_run(_make_trainer(execution, resources=resources,
                                        comp=comp))
    repro_torch.reset()
    r1, n1 = _counted_run(_make_trainer(
        execution, resources=resources, comp=comp,
        faults={"dropout_prob": 0.0, "crash_prob": 0.0,
                "straggler_prob": 0.0, "nan_update_prob": 0.0,
                "max_update_norm": 0.0, "seed": 7}))
    assert _params_equal(r0["params"], r1["params"])
    assert n0 == n1                  # programs, dispatches, syncs, launches
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert set(h0) == set(h1)
        assert "dropped" not in h1 and "survivors" not in h1
        assert h0["train_loss"] == h1["train_loss"]


@pytest.mark.parametrize("comp", ["none", "stc"])
def test_batched_faults_build_no_new_program_and_sync_once(comp):
    """Failures live in the mask and NaN-row tensors of the fused round:
    the program never changes, and a round makes exactly one host sync."""
    t = _make_trainer("batched", comp=comp,
                      faults={"dropout_prob": 0.4, "nan_update_prob": 0.2,
                              "seed": 1})
    t.run_round(0)
    built = port_batched.round_trace_count()
    h0 = port_batched.host_sync_count()
    for r in range(1, 4):
        t.run_round(r)
    assert port_batched.round_trace_count() == built
    assert port_batched.host_sync_count() - h0 == 3
    assert sum(h["dropped"] for h in t.history) > 0
    assert sum(h["rejected"] for h in t.history) > 0


# ---------------------------------------------------------------------------
# graceful degradation: survivors-only FedAvg
# ---------------------------------------------------------------------------


def test_dropout_survivors_match_hand_computed_fedavg():
    """Zero-weighting == plain FedAvg over the survivors: a twin trainer
    trains only the survivors and aggregates them (bit-identical)."""
    faults = {"dropout_prob": 0.5, "seed": 11}
    tA = _make_trainer("sequential", faults=faults)
    tB = _make_trainer("sequential")
    mA = tA.run_round(0)
    selected = tB.server.selection(tB.fed_data.client_ids, 0)
    plans = {c: tA.faults.plan(c, 0) for c in selected}
    survivors = [c for c in selected if not plans[c].dropout]
    assert 0 < len(survivors) < len(selected)  # the draw actually drops
    assert mA["dropped"] == len(selected) - len(survivors)
    assert mA["survivors"] == len(survivors)
    payload = tB.server.distribution(selected)
    results = [tB.client(c).run_round(payload, 0) for c in survivors]
    tB.server.aggregation(results)
    assert _params_equal(tA.server.params, tB.server.params)


def test_batched_matches_sequential_under_faults():
    faults = {"dropout_prob": 0.3, "crash_prob": 0.2, "seed": 4}
    rs = _make_trainer("sequential", faults=faults).run()
    rb = _make_trainer("batched", faults=faults).run()
    for a, b in zip(tree_leaves(rs["params"]), tree_leaves(rb["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for hs, hb in zip(rs["history"], rb["history"]):
        for k in ("dropped", "crashed", "straggled", "survivors", "clients"):
            assert hs[k] == hb[k], k


@pytest.mark.parametrize("execution,resources", [
    ("sequential", None), ("batched", None),
    ("batched", {"round_fusion": "off"})])
def test_nan_injected_updates_never_reach_params(execution, resources):
    t = _make_trainer(execution, resources=resources,
                      faults={"nan_update_prob": 1.0})
    p0 = _bits(t.server.params)
    r = t.run()
    assert _params_equal(p0, t.server.params)   # zero delta, not NaN
    for h in r["history"]:
        assert h["rejected"] == h["clients"]
        assert h["survivors"] == 0
        assert np.isnan(h["train_loss"])


@pytest.mark.parametrize("execution,resources", [
    ("sequential", None), ("batched", None),
    ("batched", {"round_fusion": "off"})])
def test_norm_outlier_guard_rejects_everything_at_tiny_bound(execution,
                                                             resources):
    t = _make_trainer(execution, resources=resources,
                      faults={"max_update_norm": 1e-12})
    p0 = _bits(t.server.params)
    r = t.run()
    assert _params_equal(p0, t.server.params)
    assert all(h["rejected"] == h["clients"] for h in r["history"])


def test_crash_drops_update_but_elapses_partial_time():
    # floor 0: with crash_prob=1 no cohort meets the default floor of 1
    t = _make_trainer("sequential", faults={"crash_prob": 1.0,
                                            "min_clients_per_round": 0})
    p0 = _bits(t.server.params)
    m = t.run_round(0)
    assert m["crashed"] == m["clients"] and m["survivors"] == 0
    assert m["round_time"] > 0.0          # partial virtual time elapsed
    assert _params_equal(p0, t.server.params)


def test_straggler_slowdown_stretches_simulated_time():
    """Every client straggles by 10x: each one's simulated time is the
    heterogeneity simulation of 10x its measured training time (the
    virtual clock, not a comparison of two measured runs)."""
    t = _make_trainer("sequential", faults={"straggler_prob": 1.0,
                                            "straggler_slowdown": 10.0},
                      tracking=True)
    slow = t.run_round(0)
    assert slow["straggled"] == slow["clients"]
    assert slow["survivors"] == slow["clients"]   # slow, but not failed
    task = t.tracker.get_task(t.cfg.task_id)
    for cid, c in task.rounds[0].clients.items():
        m = c.metrics
        assert m["simulated_time"] == t.het.simulate_time(
            cid, m["train_time"] * 10.0)
    assert slow["round_time"] > 0.0


@pytest.mark.parametrize("execution,resources", [
    ("sequential", None), ("batched", None),
    ("batched", {"round_fusion": "off"})])
def test_round_deadline_zero_weights_misses_without_fault_probs(execution,
                                                                 resources):
    """A deadline alone (no fault probabilities) takes the degradation
    path: every client misses 1e-12 s, so no client survives and the
    params stay bit for bit as they were; the makespan caps there."""
    t = _make_trainer(execution, resources={"round_deadline": 1e-12,
                                            **(resources or {})})
    p0 = _bits(t.server.params)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = t.run_round(0)
    assert m["deadline_missed"] == m["clients"] and m["survivors"] == 0
    assert m["round_time"] <= 1e-12 * m["clients"]
    assert _params_equal(p0, t.server.params)
    hits = [str(w.message) for w in caught if "round_fusion" in str(w.message)]
    if execution == "batched" and not resources:
        # the deadline keeps the round off the fused program, loudly
        assert len(hits) == 1 and ("resources.round_deadline > 0 (deadline "
                                   "masking needs the measured round time)"
                                   ) in hits[0]
    else:
        assert hits == []


# ---------------------------------------------------------------------------
# min_clients_per_round floor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_min_clients_floor_triggers_reselection_and_survives(execution):
    t = _make_trainer(execution, faults={"dropout_prob": 0.5, "seed": 2,
                                         "min_clients_per_round": 3})
    ref = _ref_trainer(execution, faults={"dropout_prob": 0.5, "seed": 2,
                                          "min_clients_per_round": 3})
    m, mr = t.run_round(0), ref.run_round(0)
    assert m["survivors"] >= 3
    assert [m[k] for k in ACCOUNTING] == [mr[k] for k in ACCOUNTING]


def test_min_clients_floor_unreachable_raises():
    t = _make_trainer("sequential",
                      faults={"dropout_prob": 0.98, "seed": 0,
                              "min_clients_per_round": 5})
    with pytest.raises(ValueError, match="min_clients_per_round"):
        t.run_round(0)


def test_min_clients_floor_above_cohort_size_rejected_at_init():
    with pytest.raises(ValueError, match="can never be met"):
        _make_trainer("sequential", faults={"dropout_prob": 0.1,
                                            "min_clients_per_round": 6})


# ---------------------------------------------------------------------------
# deterministic sampling + validation
# ---------------------------------------------------------------------------


def test_fault_injector_is_deterministic_and_equals_the_reference():
    kw = dict(dropout_prob=0.4, crash_prob=0.3, straggler_prob=0.5,
              nan_update_prob=0.2, seed=9)
    inj = FaultInjector(FaultConfig(**kw))
    a = [inj.plan(f"c{i}", r) for i in range(20) for r in range(5)]
    b = [inj.plan(f"c{i}", r) for i in range(20) for r in range(5)]
    assert a == b
    other = FaultInjector(FaultConfig(**dict(kw, seed=10)))
    assert [other.plan(f"c{i}", r) for i in range(20)
            for r in range(5)] != a
    for p in a:
        assert p.dropout + p.crash + p.nan_update <= 1
        assert 0.0 <= p.crash_fraction <= 1.0
    from repro.core.config import FaultConfig as RefFaultConfig
    ref = RefInjector(RefFaultConfig(**kw))
    assert [vars(p) for p in a] == [
        vars(ref.plan(f"c{i}", r)) for i in range(20) for r in range(5)]


@pytest.mark.parametrize("bad,match", [
    ({"dropout_prob": 1.5}, "dropout_prob"),
    ({"crash_prob": -0.1}, "crash_prob"),
    ({"straggler_slowdown": 0.5}, "straggler_slowdown"),
    ({"max_update_norm": float("inf")}, "max_update_norm"),
    ({"min_clients_per_round": -1}, "min_clients_per_round"),
    ({"max_retries": -2}, "max_retries"),
    ({"retry_backoff": float("nan")}, "retry_backoff"),
])
def test_fault_config_validation_is_loud(bad, match):
    with pytest.raises(ValueError, match=match):
        validate_fault_config(FaultConfig(**bad))


def test_poison_and_guard_helpers_match_the_reference():
    from repro.core import compression as ref_comp
    from repro_torch.core import compression as port_comp

    clean = {"w": np.ones((3, 2), np.float32), "b": np.zeros(2, np.float32)}
    port = {k: torch.from_numpy(v) for k, v in clean.items()}
    assert update_is_valid(port)
    bad = _poison_update(port)
    assert not update_is_valid(bad)
    # norm bound: a clean update of norm sqrt(6) fails a bound of 1.0
    assert not update_is_valid(port, max_norm=1.0)
    assert update_is_valid(port, max_norm=10.0)
    for norm in (0.0, 1.0, 2.449, 2.45, 10.0):
        assert update_is_valid(port, norm) == ref_valid(clean, norm)
    # compressed leaves keep their structure; int8 through the scale
    u = {"w": torch.linspace(-1, 1, 128)}
    for method in ("stc", "int8"):
        c = port_comp.compress(u, method, 0.1)
        p = _poison_update(c)["w"]
        assert isinstance(p, port_comp.CompressedTensor) and p.kind == method
        assert not update_is_valid({"w": p})
        rc = ref_comp.compress({"w": jax.numpy.asarray(u["w"].numpy())},
                               method, 0.1)
        assert not ref_valid(ref_poison(rc))
        if method == "int8":
            assert torch.equal(p.data, c["w"].data)
            assert bool(torch.isnan(p.scale))


# ---------------------------------------------------------------------------
# against the reference, path by path
# ---------------------------------------------------------------------------


class _RefTaggedUpload(RefClient):
    """Built-in compression, then an upload stage of its own: the
    gathering path."""

    def upload(self, result):
        return dict(result, uploaded=True)


class _PortTaggedUpload(PortClient):
    def upload(self, result):
        return dict(result, uploaded=True)


PATHS = {
    "sequential": ("sequential", {}, {}, {}),
    "fused": ("batched", {}, {}, {}),
    "staged": ("batched", {"round_fusion": "off"}, {}, {}),
    "gathering": ("batched", {"round_fusion": "off"},
                  {"client_cls": _RefTaggedUpload},
                  {"client_cls": _PortTaggedUpload}),
    "fused-tree": ("batched", {"aggregation_topology": "hierarchical",
                               "aggregation_kernel": True}, {}, {}),
}


def _ef_store(trainer):
    """client id -> flat residual leaves, from either engine's store."""
    if trainer.engine is not None and trainer.engine._ef is not None:
        rows = trainer.engine.ef_state()["clients"]
        return {c: [np.asarray(r) for r in v] for c, v in rows.items()}
    return {cid: [np.asarray(x).reshape(-1) for x in tree_leaves(c._residual)]
            for cid, c in trainer.clients.items() if c._residual is not None}


@pytest.mark.parametrize("path,comp", [
    (path, comp) for path in PATHS if path != "fused-tree"
    for comp in ("none", "stc", "int8")] + [("fused-tree", "stc")])
def test_fault_accounting_params_and_ef_match_the_reference(path, comp):
    execution, resources, ref_kw, port_kw = PATHS[path]
    ref = _ref_trainer(execution, FAULTS, resources, comp, rounds=2, **ref_kw)
    port = _make_trainer(execution, FAULTS, resources, comp=comp, rounds=2,
                         **port_kw)
    cohorts = []
    select = port.server.selection

    def recording(ids, round_id):       # the round's (last) selection
        cohorts.append(select(ids, round_id))
        return cohorts[-1]
    port.server.selection = recording
    seen, untouched = set(), set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(2):
            before = _ef_store(port)
            mr, mp = ref.run_round(r), port.run_round(r)
            assert [mp[k] for k in ACCOUNTING] == \
                [mr[k] for k in ACCOUNTING], (r, mp, mr)
            np.testing.assert_allclose(mp["train_loss"], mr["train_loss"],
                                       rtol=1e-4, atol=1e-4)
            assert mp["comm_up_bytes"] == mr["comm_up_bytes"]
            for a, b in zip(jax.tree_util.tree_leaves(ref.server.params),
                            tree_leaves(port.server.params)):
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           rtol=1e-5, atol=1e-5)
            ef_r, ef_p = _ef_store(ref), _ef_store(port)
            assert sorted(ef_p) == sorted(ef_r)
            for cid in ef_p:
                for a, b in zip(ef_r[cid], ef_p[cid]):
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
            # residuals the round must leave untouched: clients outside the
            # cohort on every path, and failed clients where the post-train
            # stages are skipped (sequential, gathering)
            cohort = set(cohorts[-1])
            for cid, rows in before.items():
                skipped = path in ("sequential", "gathering") and \
                    cid in cohort and port.faults.plan(cid, r).fails
                if cid not in cohort or skipped:
                    untouched.add(cid)
                    assert all(np.array_equal(x, y) for x, y in
                               zip(rows, ef_p[cid])), (r, cid)
            seen |= {k for k in ("dropped", "crashed", "straggled",
                                 "rejected") if mp[k]}
    assert seen == {"dropped", "crashed", "straggled", "rejected"}
    if comp != "none":
        assert untouched
