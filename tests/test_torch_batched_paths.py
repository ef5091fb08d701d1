"""The batched engine's staged and gathering paths and the deferred round
sync of ``repro_torch`` against the reference running the same
configuration, subclass or aggregator, from the reference's initial
parameters, and the staged path against the port's own fused round.

Bars: staged against fused bit for bit (both run the same eager ops);
against the reference params within 1e-5, losses within 1e-4, selection
and ``comm_up_bytes`` exact (the helpers of ``tests/test_torch_sequential.py``);
``round_sync=False`` bit for bit against the synced run; the per-round
dispatch and host-sync counts equal to the reference's."""
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core import batched as ref_batched  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import batched as port_batched  # noqa: E402
from repro_torch.core import compression as port_comp  # noqa: E402
from repro_torch.core.client import Client as PortClient  # noqa: E402
from repro_torch.core.server import Server as PortServer  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_sequential import (  # noqa: E402
    LINEAR, _assert_trajectory, _init_params, _merge, _run_port, _run_ref,
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


BATCHED = _merge(LINEAR, {"resources": {"execution": "batched"}})


def _port(cfg, p0, **kw):
    return _run_port(cfg, p0, **kw)[1]


def _assert_same_bits(a, b):
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert [h["train_loss"] for h in a["history"]] == \
        [h["train_loss"] for h in b["history"]]
    assert [h["comm_up_bytes"] for h in a["history"]] == \
        [h["comm_up_bytes"] for h in b["history"]]


# ---------------------------------------------------------------------------
# the staged path (round_fusion="off")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["flat", "hierarchical"])
@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_staged_equals_fused_bit_for_bit(compression, topology):
    cfg = _merge(BATCHED, {"client": {"compression": compression},
                           "server": {"rounds": 2},
                           "resources": {"aggregation_topology": topology,
                                         "aggregation_kernel": True}})
    p0 = _init_params(cfg)
    fused = _port(cfg, p0)
    b0 = port_batched.round_trace_count()
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # "off" never warns
        staged = _port(_merge(cfg, {"resources": {"round_fusion": "off"}}),
                       p0)
    assert port_batched.round_trace_count() == b0   # no fused program
    _assert_same_bits(staged, fused)


def _counted(fn, module):
    d0, h0 = module.dispatch_count(), module.host_sync_count()
    out = fn()
    return out, (module.dispatch_count() - d0, module.host_sync_count() - h0)


@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_staged_matches_reference_and_counts_its_stages(compression):
    cfg = _merge(BATCHED, {"client": {"compression": compression},
                           "server": {"rounds": 2},
                           "resources": {"round_fusion": "off",
                                         "aggregation_kernel": True}})
    p0 = _init_params(cfg)
    (ref, ref_res), ref_n = _counted(lambda: _run_ref(cfg), ref_batched)
    (port, port_res), port_n = _counted(lambda: _run_port(cfg, p0),
                                        port_batched)
    _assert_trajectory(ref, ref_res, port, port_res, rounds=2)
    # a round: training 1 dispatch + 1 sync, compression and aggregation
    # 1 dispatch each, the STC counts 1 sync
    per_round = {"none": (2, 1), "stc": (3, 2), "int8": (3, 1)}[compression]
    assert port_n == ref_n == (2 * per_round[0], 2 * per_round[1])


# ---------------------------------------------------------------------------
# the gathering path: overrides and registered aggregators under batched
# ---------------------------------------------------------------------------


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


class _RefTaggedUpload(RefClient):
    """Built-in compression, then an upload stage of its own."""

    def upload(self, result):
        return dict(result, uploaded=True)


class _PortTaggedUpload(PortClient):
    def upload(self, result):
        return dict(result, uploaded=True)


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


class _RefHalfApply(RefServer):
    """Applies half of each FedAvg delta."""

    def apply_delta(self, delta, server_lr=None):
        super().apply_delta(delta, 0.5)


class _PortHalfApply(PortServer):
    def apply_delta(self, delta, server_lr=None):
        super().apply_delta(delta, 0.5)


def _damped(fedavg):
    def agg(global_params, updates, num_samples, **kw):
        return fedavg(global_params, updates, num_samples, server_lr=0.5,
                      **{k: v for k, v in kw.items() if k != "server_lr"})
    return agg


def _both_warned(cfg, ref_kw, port_kw):
    """Both runs (2 rounds) held to the reference, dispatch and host-sync
    counts included; -> the port's round_fusion warnings."""
    cfg = _merge(cfg, {"server": {"rounds": 2}})
    p0 = _init_params(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (ref, ref_res), ref_n = _counted(lambda: _run_ref(cfg, **ref_kw),
                                         ref_batched)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (port, port_res), port_n = _counted(
            lambda: _run_port(cfg, p0, **port_kw), port_batched)
    _assert_trajectory(ref, ref_res, port, port_res, rounds=2)
    assert port_n == ref_n
    return [str(w.message) for w in caught if "round_fusion" in str(w.message)]


OVERRIDES = [
    ("client compression", "none", {"client_cls": _RefHalfUpload},
     {"client_cls": _PortHalfUpload}, "per-client compression"),
    ("client upload", "stc", {"client_cls": _RefTaggedUpload},
     {"client_cls": _PortTaggedUpload}, "per-client compression"),
    ("server aggregation", "int8", {"server_cls": _RefUnweightedMean},
     {"server_cls": _PortUnweightedMean}, "Server.aggregation override"),
    ("server apply_delta", "stc", {"server_cls": _RefHalfApply},
     {"server_cls": _PortHalfApply}, "Server.apply_delta override"),
]


@pytest.mark.parametrize("name,compression,ref_kw,port_kw,reason", OVERRIDES,
                         ids=[o[0] for o in OVERRIDES])
def test_stage_overrides_under_batched_match_reference(
        name, compression, ref_kw, port_kw, reason):
    cfg = _merge(BATCHED, {"client": {"compression": compression}})
    hits = _both_warned(cfg, ref_kw, port_kw)
    assert len(hits) == 1, hits            # once per trainer, not per round
    assert reason in hits[0]
    assert hits[0].startswith("resources.round_fusion='auto' cannot fuse "
                              "this round into one program (")
    assert hits[0].endswith("); falling back to the staged batched path — "
                            "set round_fusion='off' to silence "
                            "(docs/perf.md)")


def test_registered_aggregator_under_batched_matches_reference(monkeypatch):
    monkeypatch.setitem(ref_agg.AGGREGATORS, "damped",
                        _damped(ref_agg.fedavg))
    monkeypatch.setitem(port_agg.AGGREGATORS, "damped",
                        _damped(port_agg.fedavg))
    cfg = _merge(BATCHED, {"server": {"aggregation": "damped"},
                           "client": {"compression": "stc"},
                           "resources": {"aggregation_kernel": True}})
    hits = _both_warned(cfg, {}, {})
    assert len(hits) == 1 and "'damped' (non-FedAvg)" in hits[0]


# ---------------------------------------------------------------------------
# tracking.round_sync=False: the deferred finalize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution,compression", [
    ("batched", "stc"), ("sequential", "int8")])
def test_round_sync_false_equals_synced_and_reference(execution,
                                                      compression):
    # rounds 0 and 2 defer their finalize, round 1 (a test round) does not
    cfg = _merge(LINEAR, {"client": {"compression": compression},
                          "resources": {"execution": execution},
                          "server": {"rounds": 3, "test_every": 2}})
    deferred_cfg = _merge(cfg, {"tracking": {"round_sync": False}})
    p0 = _init_params(cfg)
    synced = _port(cfg, p0)
    (_, ref_res), ref_n = _counted(lambda: _run_ref(deferred_cfg),
                                   ref_batched)
    deferred, port_n = _counted(lambda: _port(deferred_cfg, p0),
                                port_batched)
    # the fused round: 1 dispatch and 1 fetch a round, deferred or not
    assert port_n == ref_n == ((3, 3) if execution == "batched" else (0, 0))
    _assert_same_bits(deferred, synced)
    assert [list(h) for h in deferred["history"]] == \
        [list(h) for h in synced["history"]]
    for key in ("loss", "accuracy"):       # test rounds read their own params
        assert [h.get(key) for h in deferred["history"]] == \
            [h.get(key) for h in synced["history"]]
    # against the reference's deferred run (test metrics every 2 rounds)
    for a, b in zip(jax.tree_util.tree_leaves(ref_res["params"]),
                    tree_leaves(deferred["params"])):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for key in ("train_loss", "loss", "accuracy"):
        np.testing.assert_allclose(
            [h.get(key, 0.0) for h in deferred["history"]],
            [h.get(key, 0.0) for h in ref_res["history"]], rtol=1e-4,
            atol=1e-4, err_msg=key)
    for key in ("comm_up_bytes", "comm_down_bytes", "clients"):
        assert [h[key] for h in deferred["history"]] == \
            [h[key] for h in ref_res["history"]], key
    assert [list(h) for h in deferred["history"]] == \
        [list(h) for h in ref_res["history"]]


def test_deferred_fused_round_fetches_once_after_the_next_dispatch():
    from repro_torch.core.config import Config
    from repro_torch.core.rounds import Trainer
    from repro_torch.data.fed_data import build_federated_data
    from repro_torch.models.registry import get_model

    cfg = Config.make(_merge(BATCHED, {"tracking": {"round_sync": False},
                                       "client": {"compression": "stc"}}))
    trainer = Trainer(cfg, get_model("linear"),
                      build_federated_data(cfg.data))
    trainer.server.params = get_model("linear").init(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    h0 = port_batched.host_sync_count()
    fin = trainer._dispatch_round(0)
    assert port_batched.host_sync_count() == h0        # nothing fetched yet
    assert trainer.history == []
    metrics = fin()
    assert port_batched.host_sync_count() == h0 + 1    # the one fetch
    assert trainer.history == [metrics]
    assert np.isfinite(metrics["train_loss"]) and metrics["comm_up_bytes"] > 0
