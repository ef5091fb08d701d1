"""The ported slice end to end: the fused batched FedAvg round of
``repro_torch`` against the reference's fused batched round, from the
reference's initial parameters, plus the round counters and the loud
errors for every configuration outside the port (configurations that
raised before their port landed now run against the reference)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.data.fed_data import build_federated_data as ref_build  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.config import Config as PortConfig  # noqa: E402
from repro_torch.core.rounds import Trainer as PortTrainer  # noqa: E402
from repro_torch.core.server import Server  # noqa: E402
from repro_torch.data.fed_data import build_federated_data as port_build  # noqa: E402
from repro_torch.models.registry import get_model as port_get_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")

LINEAR = {
    "model": "linear",
    "data": {"dataset": "synthetic", "num_clients": 10, "batch_size": 32},
    "server": {"rounds": 3, "clients_per_round": 5},
    "client": {"local_epochs": 2, "lr": 0.1},
    "resources": {"execution": "batched"},
}


def _merge(base, extra):
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in base.items()}
    for k, v in extra.items():
        if isinstance(v, dict):
            out.setdefault(k, {}).update(v)
        else:
            out[k] = v
    return out


def _run_both(cfg):
    rcfg, pcfg = RefConfig.make(cfg), PortConfig.make(cfg)
    ref = RefTrainer(rcfg, ref_get_model(rcfg.model), ref_build(rcfg.data))
    p0 = jax.tree_util.tree_map(
        np.asarray, ref.model.init(jax.random.PRNGKey(rcfg.seed)))
    ref_res = ref.run()
    port = PortTrainer(pcfg, port_get_model(pcfg.model), port_build(pcfg.data))
    port.server.params = convert.params_from_jax(p0)   # injected weights
    port_res = port.run()
    return ref, ref_res, port, port_res


def _selected(trainer, rounds):
    task = trainer.tracker.get_task(trainer.cfg.task_id)
    return [sorted(task.rounds[r].clients) for r in range(rounds)]


def _assert_parity(ref, ref_res, port, port_res, rounds):
    for a, b in zip(jax.tree_util.tree_leaves(ref_res["params"]),
                    tree_leaves(port_res["params"])):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for key in ("train_loss", "loss", "accuracy"):
        np.testing.assert_allclose(
            [h[key] for h in port_res["history"]],
            [h[key] for h in ref_res["history"]], rtol=1e-4, atol=1e-4,
            err_msg=key)
    for key in ("comm_up_bytes", "comm_down_bytes", "clients"):
        assert [h[key] for h in port_res["history"]] == \
            [h[key] for h in ref_res["history"]], key
    assert list(port_res["history"][0]) == list(ref_res["history"][0])
    assert _selected(port, rounds) == _selected(ref, rounds)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_fused_round_matches_reference(compression, kernel):
    cfg = _merge(LINEAR, {"client": {"compression": compression},
                          "resources": {"aggregation_kernel": kernel}})
    _assert_parity(*_run_both(cfg), rounds=3)


def test_hetero_adamw_fedprox_clip_cohort_matches_reference():
    cfg = _merge(LINEAR, {
        "client": {"optimizer": "adamw", "lr": 0.01, "proximal_mu": 0.1,
                   "max_grad_norm": 1.0, "compression": "stc"},
        "data": {"unbalanced": True},
        "system_heterogeneity": {"hyperparam_choices": {
            "lr": (0.005, 0.02), "adam_b1": (0.8, 0.9),
            "weight_decay": (0.0, 0.01)}},
    })
    _assert_parity(*_run_both(cfg), rounds=3)


def test_bounded_stores_spill_and_reload_like_the_reference(monkeypatch):
    # device tiers smaller than the population: every round evicts, the EF
    # residuals spill to host and reload, the data rows are recomputed
    from repro.core.batched import BatchedExecutor as RefExecutor
    from repro_torch.core.batched import BatchedExecutor as PortExecutor
    for cls in (RefExecutor, PortExecutor):
        monkeypatch.setattr(cls, "EF_MAX_CLIENTS", 4)
        monkeypatch.setattr(cls, "DATA_POOL_MAX_CLIENTS", 4)
    cfg = _merge(LINEAR, {"server": {"rounds": 4},
                          "client": {"compression": "int8"}})
    ref, ref_res, port, port_res = _run_both(cfg)
    _assert_parity(ref, ref_res, port, port_res, rounds=4)
    stats = port.engine._ef.stats
    assert stats["spills"] > 0 and stats["reloads"] > 0
    assert port.engine._pool.stats["evictions"] > 0


@pytest.mark.parametrize("kernel", [False, True])
def test_gathered_fedavg_matches_reference(kernel):
    from repro.core.aggregation import fedavg as ref_fedavg
    from repro_torch.core.aggregation import fedavg as port_fedavg
    rs = np.random.RandomState(5)
    glob = {"fc": {"w": rs.standard_normal((6, 3)).astype(np.float32),
                   "b": rs.standard_normal((3,)).astype(np.float32)}}
    ups = [jax.tree_util.tree_map(
        lambda a: rs.standard_normal(a.shape).astype(np.float32), glob)
        for _ in range(4)]
    counts = [10, 30, 5, 55]
    ref = ref_fedavg(jax.tree_util.tree_map(jax.numpy.asarray, glob),
                     [jax.tree_util.tree_map(jax.numpy.asarray, u)
                      for u in ups], counts, use_kernel=kernel, server_lr=0.5)
    out = port_fedavg(convert.params_from_jax(glob),
                      [convert.params_from_jax(u) for u in ups], counts,
                      use_kernel=kernel, server_lr=0.5)
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(out)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_femnist_cnn_round_matches_reference():
    cfg = {"model": "femnist_cnn",
           "data": {"dataset": "femnist", "num_clients": 20,
                    "data_amount": 0.05, "batch_size": 16},
           "server": {"rounds": 1, "clients_per_round": 3},
           "client": {"local_epochs": 1},
           "resources": {"execution": "batched"}}
    _assert_parity(*_run_both(cfg), rounds=1)


def test_one_dispatch_and_one_host_sync_per_round():
    cfg = PortConfig.make(_merge(LINEAR, {"server": {"rounds": 4},
                                          "client": {"compression": "stc"}}))
    trainer = PortTrainer(cfg, port_get_model("linear"), port_build(cfg.data))
    d0, h0 = batched.dispatch_count(), batched.host_sync_count()
    b0 = batched.round_trace_count()
    trainer.run()
    assert batched.dispatch_count() - d0 == 4
    assert batched.host_sync_count() - h0 == 4
    assert batched.round_trace_count() - b0 == 1     # one bucket, one build


# item: the ROADMAP item the port names when it refuses the setting, or
# None once the setting is ported (it then runs against the reference)
UNPORTED = [
    ({"resources": {"execution": "sequential"}, "client": {"finetune": "lora"}},
     "M8"),
    ({"resources": {"execution": "async"}}, "M7"),
    ({"resources": {"round_fusion": "off"}}, None),
    ({"resources": {"distributed": "data"}}, "M5.7"),
    ({"resources": {"aggregation_topology": "hierarchical"}}, None),
    ({"faults": {"dropout_prob": 0.2}}, None),
    # a deadline every client misses: decided by the virtual clock, not by
    # how long either package's first round happened to take
    ({"resources": {"round_deadline": 1e-12}}, None),
    ({"checkpoint": {"every": 1}}, None),
    ({"tracking": {"round_sync": False}}, None),
    ({"client": {"finetune": "lora"}, "resources": {"execution": "async"}},
     "M7"),
    ({"server": {"compression": "int8", "aggregation": "median"}}, None),
    ({"server": {"aggregation": "fedbuff"}}, "M7"),
]


def _median(apply_delta, to_numpy, from_numpy):
    """A registered non-FedAvg aggregator: the coordinate-wise median of
    the updates (numpy's, so both packages take the same one)."""
    def agg(global_params, updates, num_samples, server_lr=1.0, **kw):
        delta = [from_numpy(np.median(np.stack(
            [to_numpy(u)[i] for u in updates]), axis=0))
            for i in range(len(to_numpy(updates[0])))]
        return apply_delta(global_params, delta, server_lr)
    return agg


def _register_median(monkeypatch):
    from repro.core import aggregation as ref_agg
    from repro_torch.core import aggregation as port_agg
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    def ref_apply(g, leaves, lr):
        return ref_agg.apply_delta(g, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(g), leaves), lr)

    def port_apply(g, leaves, lr):
        return port_agg.apply_delta(g, tree_unflatten(tree_flatten(g)[1],
                                                      leaves), lr)
    monkeypatch.setitem(ref_agg.AGGREGATORS, "median", _median(
        ref_apply,
        lambda u: [np.asarray(x, np.float32)
                   for x in jax.tree_util.tree_leaves(u)],
        jax.numpy.asarray))
    monkeypatch.setitem(port_agg.AGGREGATORS, "median", _median(
        port_apply, lambda u: [x.numpy() for x in tree_leaves(u)],
        torch.from_numpy))


@pytest.mark.parametrize("extra,item", UNPORTED,
                         ids=[str(e)[:50] for e, _ in UNPORTED])
def test_configs_outside_the_slice_raise(extra, item, monkeypatch,
                                        tmp_path):
    if item is None:               # ported since: it runs as the reference
        monkeypatch.chdir(tmp_path)       # checkpoints land under the cwd
        _register_median(monkeypatch)
        cfg = _merge(_merge(LINEAR, {"server": {"rounds": 2}}), extra)
        _assert_parity(*_run_both(cfg), rounds=2)
        return
    repro_torch.reset()
    repro_torch.init(_merge(LINEAR, extra))
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.run()
    repro_torch.reset()


@pytest.mark.parametrize("section", ["client", "server"])
def test_unknown_compression_raises_the_reference_error(section):
    cfg = PortConfig.make(_merge(LINEAR, {section: {"compression": "topk"}}))
    with pytest.raises(ValueError, match="unknown compression 'topk'"):
        PortTrainer(cfg, port_get_model("linear"), port_build(cfg.data))


@pytest.mark.parametrize("model,item", [("shakespeare_lstm", "M3"),
                                        ("cifar_resnet18", "M3"),
                                        ("resnet18", "M3")])
def test_unported_models_raise_at_init(model, item):
    repro_torch.reset()
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.init({"model": model, "dataset": "synthetic"})


class _TrainOverride(Client):
    def train(self, params, round_id):
        return {}


class _ApplyOverride(Server):
    def apply_delta(self, delta, server_lr=None):
        pass


def test_stage_overrides_and_remote_and_resume_raise(tmp_path):
    repro_torch.reset()
    repro_torch.init(LINEAR)
    repro_torch.register_client(_TrainOverride)
    with pytest.raises(ValueError,
                       match="cannot vectorize per-client 'train' overrides"):
        repro_torch.run()
    repro_torch.reset()
    repro_torch.init(LINEAR)
    repro_torch.register_server(_ApplyOverride)
    # the override runs on the staged path (one warning): it ignores every
    # delta, so the params stay at their init
    with pytest.warns(UserWarning, match="apply_delta override"):
        res = repro_torch.run()
    init = port_get_model("linear").init(torch.Generator().manual_seed(0),
                                         torch.device("cpu"))
    for a, b in zip(tree_leaves(res["params"]), tree_leaves(init)):
        assert torch.equal(a, b)
    repro_torch.reset()
    for fn in (repro_torch.start_server, repro_torch.start_client):
        with pytest.raises(NotImplementedError, match="M10"):
            fn()
    # resume is ported: with no checkpoint to resume from it says so
    cfg = PortConfig.make(_merge(LINEAR, {"checkpoint": {
        "dir": str(tmp_path / "none")}}))
    trainer = PortTrainer(cfg, port_get_model("linear"), port_build(cfg.data))
    with pytest.raises(FileNotFoundError, match="no checkpoints in"):
        trainer.resume()


def test_quickstart_runs_through_the_public_api():
    repro_torch.reset()
    cfg = repro_torch.init({"dataset": "synthetic", "clients_per_round": 3,
                            "rounds": 2, "execution": "batched",
                            "data": {"num_clients": 6}})
    assert cfg.model == "linear" and cfg.resources.execution == "batched"
    res = repro_torch.run()
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["train_loss"]) for h in res["history"])
    series = repro_torch.tracker().round_series(cfg.task_id, "train_loss")
    assert series == [h["train_loss"] for h in res["history"]]
    repro_torch.reset()
