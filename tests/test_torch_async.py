"""The async engine of the port (``resources.execution = "async"``, FedBuff
on a virtual-clock event loop) against the reference's.

* the degenerate case (K = cohort size, uniform speeds) equals the port's
  synchronous batched rounds and the reference's async run;
* with the measured wall pinned in both packages and the device classes
  assigned by hand, the port's event loop is the reference's: the same
  params, virtual times, staleness and cohorts, also under faults;
* the staleness fold and the staleness-weighted delta against the
  reference, on the plain K1 route;
* the knobs' defaults, the validation and refusal texts, ``run_round``
  refused, the FedBuff buffer, retries, the NaN guard, the failure cap
  and resume of the remaining aggregations;
* async LoRA: FedBuff waves of adapters, as the reference's.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref_api  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import batched as ref_batched  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro.core.strategies.fedbuff import FedBuffServer as RefFedBuff  # noqa: E402
from repro.data.fed_data import build_federated_data as ref_build  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import batched as port_batched  # noqa: E402
from repro_torch.core.async_engine import AsyncEngine  # noqa: E402
from repro_torch.core.config import Config  # noqa: E402
from repro_torch.core.rounds import Trainer  # noqa: E402
from repro_torch.core.server import Server  # noqa: E402
from repro_torch.core.strategies.fedbuff import FedBuffServer  # noqa: E402
from repro_torch.data.fed_data import build_federated_data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

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


def _pin_wall(monkeypatch):
    """Pin the measured training time of every wave, in both packages, to
    1e-4 s a local step: the virtual clocks become deterministic."""
    for mod in (ref_batched, port_batched):
        orig = mod.BatchedExecutor.run_cohort_stacked

        def fixed_wall(self, clients, params, round_id, orig=orig):
            st = orig(self, clients, params, round_id)
            st["wall"] = float(st["n_steps"].sum()) * 1e-4
            return st
        monkeypatch.setattr(mod.BatchedExecutor, "run_cohort_stacked",
                            fixed_wall)


_P0 = {}


def _p0():
    if not _P0:
        _P0["p"] = jax.tree_util.tree_map(np.asarray, ref_get_model(
            "linear").init(jax.random.PRNGKey(0)))
    return _P0["p"]


def _cfg(resources, server_over=None, ratios=None, num_clients=8,
         faults=None, ckpt=None, comp="none", tracking=False):
    return {
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": num_clients,
                 "batch_size": 32},
        "server": {"clients_per_round": num_clients, "test_every": 0,
                   **(server_over or {})},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": comp},
        "system_heterogeneity": {"enabled": ratios is not None},
        "resources": resources,
        "tracking": {"enabled": tracking},
        "faults": faults or {},
        "checkpoint": ckpt or {},
    }


def _assign(trainer, fed, ratios):
    """Deterministic device classes (the hash-based assignment is
    process-randomized): alternate the ratios over the sorted pool."""
    if ratios is not None:
        for i, cid in enumerate(sorted(fed.client_ids)):
            trainer.het.assignment[cid] = ratios[i % len(ratios)]


def _make_trainer(resources, server_over=None, ratios=None, num_clients=8,
                  server_cls=Server, **kw):
    cfg = Config.make(_cfg(resources, server_over, ratios, num_clients,
                           **kw))
    model = get_model("linear")
    fed = build_federated_data(cfg.data)
    trainer = Trainer(cfg, model, fed, server=server_cls(model, cfg, fed.test))
    trainer.server.params = convert.params_from_jax(_p0())
    _assign(trainer, fed, ratios)
    return trainer


def _ref_trainer(resources, server_over=None, ratios=None, num_clients=8,
                 server_cls=RefServer, **kw):
    cfg = RefConfig.make(_cfg(resources, server_over, ratios, num_clients,
                              **kw))
    model = ref_get_model("linear")
    fed = ref_build(cfg.data)
    trainer = RefTrainer(cfg, model, fed,
                         server=server_cls(model, cfg, fed.test))
    trainer.server.params = jax.tree_util.tree_map(jax.numpy.asarray, _p0())
    _assign(trainer, fed, ratios)
    return trainer


def _assert_params(ref_params, port_params, tol=1e-5):
    for a, b in zip(jax.tree_util.tree_leaves(ref_params),
                    tree_leaves(port_params)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                                   atol=tol)


def _run_api(api, resources, rounds=3, comp="none", extra=None):
    api.reset()
    api.init({
        "model": "linear", "dataset": "synthetic",
        "data": {"num_clients": 12, "batch_size": 32},
        "server": {"rounds": rounds, "clients_per_round": 5},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": comp},
        "resources": resources, **(extra or {}),
    })
    if api is repro_torch:
        from repro_torch.core.rounds import Trainer as T
        orig = T.run

        def run(self, callback=None):
            self.server.params = convert.params_from_jax(_p0())
            return orig(self, callback)
        T.run = run
        try:
            res = api.run()
        finally:
            T.run = orig
    else:
        res = api.run()
    api.reset()
    return res


# ---------------------------------------------------------------------------
# degenerate case == synchronous batched path == the reference's async
# ---------------------------------------------------------------------------

DEGENERATE = {"execution": "async", "buffer_size": 5, "max_concurrency": 5}


@pytest.mark.parametrize("comp", ["none", "stc", "int8"])
def test_async_degenerate_matches_batched_sync_and_reference(comp):
    """K = cohort size, uniform speeds: every wave completes at one virtual
    instant with staleness 0, so the trajectory is the synchronous batched
    one (the port's fused round) and the reference's async one."""
    rb = _run_api(repro_torch, {"execution": "batched"}, comp=comp)
    ra = _run_api(repro_torch, DEGENERATE, comp=comp)
    rr = _run_api(ref_api, DEGENERATE, comp=comp)
    for a, b in zip(tree_leaves(rb["params"]), tree_leaves(ra["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    _assert_params(rr["params"], ra["params"])
    for key in ("train_loss", "accuracy"):
        np.testing.assert_allclose([h[key] for h in ra["history"]],
                                   [h[key] for h in rb["history"]],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose([h[key] for h in ra["history"]],
                                   [h[key] for h in rr["history"]],
                                   rtol=1e-4, atol=1e-5)
    assert all(h["staleness_max"] == 0.0 for h in ra["history"])
    assert all(h["clients"] == 5 for h in ra["history"])
    for key in ("clients", "comm_up_bytes", "comm_down_bytes",
                "staleness_mean", "staleness_max", "in_flight"):
        assert [h[key] for h in ra["history"]] == \
            [h[key] for h in rr["history"]], key
    assert list(ra["history"][0]) == list(rr["history"][0])


def test_async_degenerate_matches_batched_sync_hetero_hyperparams():
    extra = {"system_heterogeneity": {"hyperparam_choices": {
        "momentum": (0.0, 0.5, 0.9), "weight_decay": (0.0, 0.01),
        "nesterov": (False, True)}}}
    rb = _run_api(repro_torch, {"execution": "batched"}, extra=extra)
    ra = _run_api(repro_torch, DEGENERATE, extra=extra)
    for a, b in zip(tree_leaves(rb["params"]), tree_leaves(ra["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose([h["train_loss"] for h in ra["history"]],
                               [h["train_loss"] for h in rb["history"]],
                               rtol=1e-4)


def test_async_default_knobs_resolve_to_cohort_size():
    trainer = _make_trainer({"execution": "async"},
                            {"rounds": 1, "clients_per_round": 8})
    eng = AsyncEngine(trainer)
    assert eng.K == 8 and eng.max_concurrency == 8
    assert eng.staleness_power == 0.5


# ---------------------------------------------------------------------------
# heterogeneous speeds, the wall pinned: the reference's event loop
# ---------------------------------------------------------------------------

def _events(trainer):
    task = trainer.tracker.get_task(trainer.cfg.task_id)
    return [(r, cid, cm.metrics["dispatch_time"], cm.metrics["finish_time"],
             cm.metrics["staleness"])
            for r in sorted(task.rounds)
            for cid, cm in sorted(task.rounds[r].clients.items())]


@pytest.mark.parametrize("comp,server", [("none", "plain"),
                                         ("stc", "plain"),
                                         ("int8", "fedbuff")])
def test_async_event_loop_matches_reference(monkeypatch, tmp_path, comp,
                                            server):
    """4x speed spread, K 3 of 8 in flight: the same virtual clock, the
    same cohorts, staleness and params as the reference."""
    _pin_wall(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = {"execution": "async", "buffer_size": 3, "max_concurrency": 8}
    kw = dict(server_over={"rounds": 5, "clients_per_round": 4},
              ratios=(1.0, 4.0), comp=comp)
    port = _make_trainer(res, server_cls=FedBuffServer if server == "fedbuff"
                         else Server, **kw)
    ref = _ref_trainer(res, server_cls=RefFedBuff if server == "fedbuff"
                       else RefServer, **kw)
    rp, rr = port.run(), ref.run()
    _assert_params(rr["params"], rp["params"])
    for key in ("round_time", "virtual_time", "staleness_mean",
                "staleness_max", "clients", "in_flight", "comm_up_bytes",
                "comm_down_bytes"):
        assert [h[key] for h in rp["history"]] == \
            [h[key] for h in rr["history"]], key
    np.testing.assert_allclose([h["train_loss"] for h in rp["history"]],
                               [h["train_loss"] for h in rr["history"]],
                               rtol=1e-4, atol=1e-5)
    assert max(h["staleness_max"] for h in rp["history"]) > 0


def test_async_tracks_the_reference_dispatch_and_finish_times(monkeypatch):
    _pin_wall(monkeypatch)
    res = {"execution": "async", "buffer_size": 3, "max_concurrency": 6}
    kw = dict(server_over={"rounds": 3, "clients_per_round": 6},
              ratios=(1.0, 2.0, 5.0), tracking=True)
    port, ref = _make_trainer(res, **kw), _ref_trainer(res, **kw)
    port.run()
    ref.run()
    ev = _events(port)
    assert ev == _events(ref)
    for _, _, d, f, s in ev:
        assert f > d >= 0.0 and s >= 0.0


def test_async_beats_sync_virtual_time_under_heterogeneity(monkeypatch):
    """Same update budget (32 completions), 4x speed spread: the event
    loop's virtual time beats synchronous rounds, each gated by a slow
    client (the wall pinned, so the gap is structural)."""
    _pin_wall(monkeypatch)
    ratios = (1.0, 4.0)
    rs = _make_trainer({"execution": "batched",
                        "allocation": "one_per_device"},
                       {"rounds": 4}, ratios).run()
    ra = _make_trainer({"execution": "async", "buffer_size": 4,
                        "max_concurrency": 8}, {"rounds": 8}, ratios).run()
    assert sum(h["clients"] for h in rs["history"]) == \
        sum(h["clients"] for h in ra["history"]) == 32
    v_sync = sum(h["round_time"] for h in rs["history"])
    v_async = sum(h["round_time"] for h in ra["history"])
    assert v_sync / v_async > 1.5
    assert max(h["staleness_max"] for h in ra["history"]) > 0


def test_async_respects_concurrency_cap_and_budget(monkeypatch):
    trainer = _make_trainer({"execution": "async", "buffer_size": 3,
                             "max_concurrency": 4},
                            {"rounds": 4, "clients_per_round": 6},
                            ratios=(1.0, 2.0, 5.0))
    waves = []
    orig = Trainer._run_batched

    def spy(self, selected, payload, round_id):
        waves.append(list(selected))
        return orig(self, selected, payload, round_id)

    monkeypatch.setattr(Trainer, "_run_batched", spy)
    res = trainer.run()
    assert all(len(w) <= 4 for w in waves)
    assert all(len(set(w)) == len(w) for w in waves)
    assert sum(len(w) for w in waves) == 4 * 3     # exact drain
    assert len(res["history"]) == 4


# ---------------------------------------------------------------------------
# staleness weighting on the plain K1 route
# ---------------------------------------------------------------------------


def test_fold_staleness_matches_the_reference():
    from repro.kernels.fedavg_agg import fold_staleness as ref_fold
    from repro_torch.kernels.fedavg_agg import fold_staleness
    rng = np.random.RandomState(3)
    for n, power in ((2, 0.5), (7, 0.5), (20, 1.3), (5, 0.0)):
        w = rng.rand(n).astype(np.float32)
        w /= w.sum()
        s = (np.arange(n) % 4).astype(np.float32)
        got = fold_staleness(torch.as_tensor(w), torch.as_tensor(s), power)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_fold(
            jax.numpy.asarray(w), jax.numpy.asarray(s), power)),
            rtol=1e-6, atol=1e-6)
    out = fold_staleness(torch.tensor([0.5, 0.5]), torch.tensor([0.0, 3.0]))
    np.testing.assert_allclose(float(out.sum()), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(out[0] / out[1]), 2.0, rtol=1e-5)


@pytest.mark.parametrize("n", [3, 20])
def test_kernel_staleness_matches_folded_oracle(n):
    from repro_torch.kernels.fedavg_agg import (
        fedavg_aggregate, fedavg_aggregate_tree, fedavg_plain, fold_staleness,
    )
    rng = np.random.RandomState(n)
    u = torch.as_tensor(rng.randn(n, 300).astype(np.float32))
    w = torch.softmax(torch.as_tensor(rng.randn(n).astype(np.float32)), 0)
    s = torch.arange(n, dtype=torch.float32) % 4
    launches = ops.launch_counts()
    want = fedavg_plain(u, fold_staleness(w, s, 0.5))
    assert torch.equal(fedavg_aggregate(u, w, staleness=s,
                                        staleness_power=0.5), want)
    np.testing.assert_allclose(
        fedavg_aggregate_tree(u, w, fanout=2, staleness=s).numpy(),
        want.numpy(), rtol=1e-5, atol=1e-6)
    assert ops.launch_counts() == launches      # CPU: plain versions only


@pytest.mark.parametrize("use_kernel,topology", [(False, "flat"),
                                                 (True, "flat"),
                                                 (True, "hierarchical")])
def test_staleness_weighted_delta_matches_the_reference(use_kernel,
                                                        topology):
    from repro.core.aggregation import staleness_weighted_delta as ref_swd
    from repro_torch.core.aggregation import staleness_weighted_delta
    rng = np.random.RandomState(0)
    updates = [{"w": rng.randn(13, 7).astype(np.float32),
                "b": rng.randn(7).astype(np.float32)} for _ in range(5)]
    num, stal = [3, 9, 1, 4, 6], [0.0, 1.0, 0.0, 2.0, 5.0]
    want = ref_swd(updates, num, stal, use_kernel=False)
    got = staleness_weighted_delta(
        [{k: torch.as_tensor(v) for k, v in u.items()} for u in updates],
        num, stal, use_kernel=use_kernel, topology=topology, fanout=2)
    _assert_params(want, got, tol=1e-6)


# ---------------------------------------------------------------------------
# FedBuffServer under the event loop, and its buffer
# ---------------------------------------------------------------------------


def test_async_drives_fedbuff_server_buffered_apply():
    trainer = _make_trainer({"execution": "async", "buffer_size": 3,
                             "max_concurrency": 6},
                            {"rounds": 3, "clients_per_round": 6},
                            ratios=(1.0, 3.0), server_cls=FedBuffServer)
    before = [t.clone() for t in tree_leaves(trainer.server.params)]
    res = trainer.run()
    assert len(res["history"]) == 3
    assert any(not torch.allclose(a, b) for a, b in
               zip(before, tree_leaves(trainer.server.params)))
    assert trainer.server._buffer == []     # the engine owns the buffer


def test_fedbuff_buffer_size_knob_overrides_class_default():
    cfg = Config.make({"model": "linear",
                       "data": {"dataset": "synthetic", "num_clients": 4},
                       "resources": {"buffer_size": 7}})
    fed = build_federated_data(cfg.data)
    assert FedBuffServer(get_model("linear"), cfg, fed.test).buffer_size == 7
    assert AsyncEngine(_make_trainer(
        {"execution": "async"}, server_cls=FedBuffServer)).K == 5


def test_fedbuff_buffered_ids_leftover_carry_and_state_roundtrip(tmp_path):
    """Leftover carry across rounds, then the buffer through a checkpoint
    file (host arrays back onto the device) and the finalize flush, equal
    to the reference's."""
    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    cfg_d = {"model": "linear",
             "data": {"dataset": "synthetic", "num_clients": 4},
             "resources": {"buffer_size": 5}}
    srv = FedBuffServer(get_model("linear"), Config.make(cfg_d), None)
    ref = RefFedBuff(ref_get_model("linear"), RefConfig.make(cfg_d), None)
    srv.params = convert.params_from_jax(_p0())
    ref.params = jax.tree_util.tree_map(jax.numpy.asarray, _p0())

    def result(i, port):
        upd = {k: {kk: np.full(np.shape(vv), 0.01 * (i + 1), np.float32)
                   for kk, vv in v.items()} for k, v in _p0().items()}
        if port:
            upd = {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
                   for k, v in upd.items()}
        return {"client_id": f"c{i}", "update": upd,
                "num_samples": 10 + i, "train_time": float(i % 3)}

    for s, port in ((srv, True), (ref, False)):
        s.aggregation([result(i, port) for i in range(3)])
        assert s.buffered_client_ids() == ["c0", "c1", "c2"]   # sub-K
        s.aggregation([result(i, port) for i in range(3, 6)])
        assert s.buffered_client_ids() == ["c5"]               # leftover
    _assert_params(ref.params, srv.params)
    save_checkpoint(str(tmp_path), {"server": srv.state_dict()}, step=1)
    srv2 = FedBuffServer(get_model("linear"), Config.make(cfg_d), None)
    srv2.load_state_dict(load_checkpoint(str(tmp_path))["server"])
    assert srv2.buffered_client_ids() == ["c5"]
    assert isinstance(tree_leaves(srv2._buffer[0]["update"])[0],
                      torch.Tensor)
    srv2.params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, srv2.params))
    srv2.finalize()
    ref.finalize()
    assert srv2.buffered_client_ids() == []
    _assert_params(ref.params, srv2.params)


# ---------------------------------------------------------------------------
# validation, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resources,match", [
    ({"execution": "async", "buffer_size": -1}, "buffer_size"),
    ({"execution": "async", "max_concurrency": -2}, "max_concurrency"),
    ({"execution": "async", "staleness_power": -0.5}, "staleness_power"),
    ({"execution": "async", "distributed": "data"}, "batched"),
    ({"execution": "asynch"}, "unknown execution"),
])
def test_async_config_validation(resources, match):
    for api in (ref_api, repro_torch):
        api.reset()
        api.init({"model": "linear", "dataset": "synthetic",
                  "resources": resources})
        with pytest.raises(ValueError, match=match) as exc:
            api.run()
        api.reset()
        if api is ref_api:
            ref_msg = str(exc.value)
    assert str(exc.value) == ref_msg


def test_async_refuses_custom_aggregation_as_the_reference():
    from repro.core.strategies import PowerOfChoiceServer as RefPoC
    from repro_torch.core.strategies import PowerOfChoiceServer
    msgs = []
    for api, poc in ((ref_api, RefPoC), (repro_torch, PowerOfChoiceServer)):
        api.reset()
        api.init({"model": "linear", "dataset": "synthetic",
                  "resources": {"execution": "async"}})
        api.register_server(poc)                   # overrides aggregation
        with pytest.raises(ValueError, match="buffered_apply") as exc:
            api.run()
        msgs.append(str(exc.value))
        api.reset()
        for agg, err in (("fedavgg", KeyError), ("fedbuff", KeyError)):
            api.init({"model": "linear", "dataset": "synthetic",
                      "server": {"aggregation": agg},
                      "resources": {"execution": "async"}})
            with pytest.raises(err, match=agg):    # typos stay loud
                api.run()
            api.reset()
    assert msgs[0] == msgs[1]


def test_run_round_refused_under_async():
    trainer = _make_trainer({"execution": "async"},
                            {"rounds": 1, "clients_per_round": 2},
                            num_clients=4)
    with pytest.raises(ValueError, match="event loop; call Trainer.run"):
        trainer.run_round(0)


def test_async_lora_matches_the_reference(monkeypatch):
    """Async LoRA: FedBuff waves of adapters on the linear model (the
    reference's base frozen in both packages), walls pinned, speeds 1x /
    4x: the same adapters, virtual times, staleness and bytes."""
    from repro.models import lora as ref_lora
    from test_torch_lora import _InjectedBase

    _pin_wall(monkeypatch)
    res = {"execution": "async", "buffer_size": 3, "max_concurrency": 6}
    cfg = _cfg(res, {"rounds": 4, "clients_per_round": 6}, (1.0, 4.0))
    cfg["client"].update(finetune="lora", lora_rank=2, lora_alpha=4.0)
    trainers = []
    for config, model, build, make in (
            (RefConfig, ref_get_model("linear"), ref_build, RefTrainer),
            (Config, _InjectedBase(get_model("linear"), _p0()),
             build_federated_data, Trainer)):
        c = config.make(cfg)
        fed = build(c.data)
        t = make(c, model, fed)
        _assign(t, fed, (1.0, 4.0))
        trainers.append(t)
    ref, port = trainers
    adapters = jax.tree_util.tree_map(np.asarray, ref_lora.lora_wrap(
        ref_get_model("linear"), _p0(), 2, 4.0, ()).init(
            jax.random.PRNGKey(0)))
    ref.server.params = jax.tree_util.tree_map(jax.numpy.asarray, adapters)
    port.server.params = convert.params_from_jax(adapters)
    rr, rp = ref.run(), port.run()
    assert sorted(rp["params"]) == sorted(rr["params"])
    _assert_params(rr["params"], rp["params"])
    for key in ("round_time", "virtual_time", "staleness_mean",
                "staleness_max", "clients", "comm_up_bytes"):
        assert [h[key] for h in rp["history"]] == \
            [h[key] for h in rr["history"]], key
    np.testing.assert_allclose([h["train_loss"] for h in rp["history"]],
                               [h["train_loss"] for h in rr["history"]],
                               rtol=1e-4, atol=1e-5)
    assert max(h["staleness_max"] for h in rp["history"]) > 0


# ---------------------------------------------------------------------------
# faults: retries, the guard, the failure cap, resume
# ---------------------------------------------------------------------------

ASYNC_RES = {"execution": "async", "buffer_size": 3, "max_concurrency": 5}
FAULTS_KW = dict(server_over={"rounds": 3, "clients_per_round": 5})


@pytest.mark.parametrize("faults,counter", [
    ({"dropout_prob": 0.3, "seed": 1, "retry_backoff": 0.01}, "retried"),
    ({"nan_update_prob": 0.3, "seed": 6, "retry_backoff": 0.01}, "rejected"),
    ({"crash_prob": 0.3, "straggler_prob": 0.3, "seed": 2,
      "retry_backoff": 0.01}, "crashed"),
], ids=["dropout", "nan", "crash-straggler"])
def test_async_faults_match_the_reference(monkeypatch, faults, counter):
    """Retries with backoff, the NaN guard and crashes: the accounting of
    every aggregation and the params equal the reference's (wall pinned);
    no NaN reaches the params."""
    _pin_wall(monkeypatch)
    port = _make_trainer(ASYNC_RES, faults=faults, **FAULTS_KW)
    ref = _ref_trainer(ASYNC_RES, faults=faults, **FAULTS_KW)
    rp, rr = port.run(), ref.run()
    assert len(rp["history"]) == 3
    assert sum(h[counter] for h in rp["history"]) > 0
    assert [{k: v for k, v in h.items() if k not in ("wall_time",
                                                     "train_loss")}
            for h in rp["history"]] == \
        [{k: v for k, v in h.items() if k not in ("wall_time", "train_loss")}
         for h in rr["history"]]
    _assert_params(rr["params"], rp["params"])
    for leaf in tree_leaves(port.server.params):
        assert bool(torch.isfinite(leaf).all())


def test_async_deadline_matches_the_reference(monkeypatch):
    """A response deadline only the fast class meets (wall pinned: 1e-4 s
    a step, ratios 1x/4x): slow replies fail at the deadline and retry."""
    _pin_wall(monkeypatch)
    res = {**ASYNC_RES, "round_deadline": 1e-2}
    kw = dict(server_over={"rounds": 3, "clients_per_round": 5},
              ratios=(1.0, 4.0), faults={"retry_backoff": 1e-3})
    rp = _make_trainer(res, **kw).run()
    rr = _ref_trainer(res, **kw).run()
    assert sum(h["deadline_missed"] for h in rp["history"]) > 0
    for key in ("deadline_missed", "retried", "gave_up", "virtual_time",
                "clients"):
        assert [h[key] for h in rp["history"]] == \
            [h[key] for h in rr["history"]], key
    _assert_params(rr["params"], rp["params"])


def test_async_runaway_failure_rate_raises():
    t = _make_trainer({"execution": "async", "buffer_size": 2,
                       "max_concurrency": 2}, {"rounds": 1,
                                               "clients_per_round": 5},
                      faults={"dropout_prob": 1.0, "max_retries": 1,
                              "retry_backoff": 0.001})
    with pytest.raises(ValueError, match="cannot make progress"):
        t.run()


@pytest.mark.parametrize("server_cls", [Server, FedBuffServer])
def test_async_resume_continues_remaining_aggregations(tmp_path, server_cls):
    d = str(tmp_path / "ck")
    kw = dict(server_over={"rounds": 4, "clients_per_round": 5},
              ckpt={"every": 2, "dir": d}, server_cls=server_cls,
              comp="stc")
    t = _make_trainer(ASYNC_RES, **kw)
    t.run()
    assert len(t.history) == 4
    tc = _make_trainer(ASYNC_RES, **kw)
    rc = tc.resume(step=2)           # killed after the 2nd aggregation
    assert len(rc["history"]) == 4
    assert rc["history"][:2] == t.history[:2]      # restored verbatim
    for leaf in tree_leaves(tc.server.params):
        assert bool(torch.isfinite(leaf).all())
    with pytest.raises(ValueError, match="resume with the same engine"):
        _make_trainer({"execution": "batched"},
                      **{**kw, "server_cls": Server}).resume(step=2)
