"""The sequential engine against the batched one, and its stage overrides,
registered aggregators and ``server.compression`` against the reference's
sequential engine running the same subclass or setting (the helpers and
bars of ``tests/test_torch_sequential.py``)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import compression as port_comp  # noqa: E402
from repro_torch.core.client import Client as PortClient  # noqa: E402
from repro_torch.core.config import Config as PortConfig  # noqa: E402
from repro_torch.core.rounds import Trainer as PortTrainer  # noqa: E402
from repro_torch.core.server import Server as PortServer  # noqa: E402
from repro_torch.data.fed_data import build_federated_data as port_build  # noqa: E402
from repro_torch.models.registry import get_model as port_get_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_sequential import (  # noqa: E402
    LINEAR, _both, _init_params, _merge, _run_port,
)

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made these runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_sequential_matches_batched(compression):
    cfg = _merge(LINEAR, {"client": {"compression": compression}})
    p0 = _init_params(cfg)
    _, seq = _run_port(cfg, p0)
    _, bat = _run_port(_merge(cfg, {"resources": {"execution": "batched"}}),
                       p0)
    for a, b in zip(tree_leaves(seq["params"]), tree_leaves(bat["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert [h["comm_up_bytes"] for h in seq["history"]] == \
        [h["comm_up_bytes"] for h in bat["history"]]


# overrides and aggregators, each held against the reference running the
# same subclass


class _RefHalfUpload(RefClient):
    """Sends half its update and no payload_bytes (the round accounts it)."""

    def compression(self, result):
        out = dict(result)
        out["update"] = jax.tree_util.tree_map(lambda u: u * 0.5,
                                               result["update"])
        return out


class _PortHalfUpload(PortClient):
    def compression(self, result):
        out = dict(result)
        out["update"] = tree_map(lambda u: u * 0.5, result["update"])
        return out


def test_client_compression_override_matches_reference():
    _both(LINEAR, rounds=3, ref_kw={"client_cls": _RefHalfUpload},
          port_kw={"client_cls": _PortHalfUpload})


class _RefUnweightedMean(RefServer):
    """Applies the unweighted mean of the updates (ignores sample counts)."""

    def aggregation(self, results):
        ups = [ref_comp.decompress(r["update"]) for r in results]
        delta = ref_agg.weighted_average(
            ups, np.full(len(ups), 1.0 / len(ups), np.float32))
        self.params = ref_agg.apply_delta(self.params, delta)


class _PortUnweightedMean(PortServer):
    def aggregation(self, results):
        ups = [port_comp.decompress(r["update"]) for r in results]
        delta = port_agg.weighted_average(
            ups, np.full(len(ups), 1.0 / len(ups), np.float32))
        self.params = port_agg.apply_delta(self.params, delta)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_server_aggregation_override_matches_reference(compression):
    cfg = _merge(LINEAR, {"client": {"compression": compression}})
    _both(cfg, rounds=3, ref_kw={"server_cls": _RefUnweightedMean},
          port_kw={"server_cls": _PortUnweightedMean})


def _damped(fedavg):
    def agg(global_params, updates, num_samples, **kw):
        return fedavg(global_params, updates, num_samples, server_lr=0.5,
                      **{k: v for k, v in kw.items() if k != "server_lr"})
    return agg


def test_registered_aggregator_matches_reference(monkeypatch):
    monkeypatch.setitem(ref_agg.AGGREGATORS, "damped",
                        _damped(ref_agg.fedavg))
    monkeypatch.setitem(port_agg.AGGREGATORS, "damped",
                        _damped(port_agg.fedavg))
    cfg = _merge(LINEAR, {"server": {"aggregation": "damped"},
                          "resources": {"aggregation_kernel": True}})
    _both(cfg, rounds=3)


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_server_compression_matches_reference(execution):
    cfg = _merge(LINEAR, {"server": {"compression": "int8"},
                          "client": {"compression": "stc"},
                          "resources": {"execution": execution}})
    port, res = _both(cfg, rounds=3)
    # the payload is int8 on the wire: 1 byte an element plus the scale
    from repro_torch.core.rounds import dense_update_bytes
    dense = dense_update_bytes(res["params"]) * res["history"][0]["clients"]
    assert res["history"][0]["comm_down_bytes"] < dense / 2


def test_residual_holders_are_never_evicted(monkeypatch):
    monkeypatch.setattr(PortTrainer, "CLIENT_CACHE_MAX", 3)
    cfg = PortConfig.make(_merge(LINEAR, {"client": {"compression": "stc"},
                                          "server": {"rounds": 2}}))
    trainer = PortTrainer(cfg, port_get_model("linear"), port_build(cfg.data))
    trainer.run()
    held = [c for c in trainer.clients.values() if c._residual is not None]
    assert len(held) == len(trainer.clients) > 3


class _PortTrainOverride(PortClient):
    def train(self, params, round_id):
        res = super().train(params, round_id)
        res["metrics"] = dict(res["metrics"], overridden=1.0)
        return res


@pytest.mark.parametrize("stage", ["compression", "encryption", "upload"])
def test_post_train_overrides_raise_under_batched_only(stage):
    """A post-train stage override runs under both engines (batched: the
    gathering path, with the one round_fusion warning) to the same
    params."""
    cls = type("Override", (PortClient,),
               {stage: lambda self, result: result})
    params = {}
    for execution in ("batched", "sequential"):
        repro_torch.reset()
        repro_torch.init(_merge(LINEAR, {"resources":
                                         {"execution": execution}}))
        repro_torch.register_client(cls)
        if execution == "batched":
            with pytest.warns(UserWarning, match="stage overrides"):
                res = repro_torch.run()
        else:
            res = repro_torch.run()
        assert len(res["history"]) == 3
        params[execution] = tree_leaves(res["params"])
    for a, b in zip(params["batched"], params["sequential"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    repro_torch.register_client(_PortTrainOverride)
    res = repro_torch.run()
    task = repro_torch.tracker().get_task(res["task_id"])
    assert all(c.metrics.get("overridden") == 1.0 for c in
               task.rounds[0].clients.values())
    repro_torch.reset()
