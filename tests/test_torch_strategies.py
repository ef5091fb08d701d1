"""The strategy plugins of the port (``repro_torch.core.strategies``):
FedProx (train stage), STC (compression stages, client and server),
FedReID (train stage), Power-of-Choice (selection stage) and FedBuff
(aggregation stage), each a subclass of the port's ``Client`` / ``Server``
taken by ``register_client`` / ``register_server``, held against the
reference's plugin on the same inputs: one client's round, then the
trajectory (params within 1e-5, losses within 1e-4) and the cohorts."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro as ref_api  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import strategies as ref_st  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.config import ClientConfig as RefClientConfig  # noqa: E402
from repro.data import ClientData as RefClientData  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import strategies as port_st  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.config import ClientConfig  # noqa: E402
from repro_torch.data.fed_data import ClientData  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: under a loaded parallel test
    run torch's thread pool made such runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    ref_api.reset()
    repro_torch.reset()
    yield
    ref_api.reset()
    repro_torch.reset()


def _p0(model="linear"):
    return jax.tree_util.tree_map(np.asarray, ref_get_model(model).init(
        jax.random.PRNGKey(0)))


def _close(ref_tree, port_tree, tol=1e-5):
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                    tree_leaves(port_tree)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                                   atol=tol)


def _one_round(ref_cls, port_cls, model="linear", n=64, seed=0, kw=None,
               **cfg):
    """One client's ``run_round`` in both packages on the same data and
    params: -> (reference result, port result, port client)."""
    rng = np.random.RandomState(seed)
    m = ref_get_model(model)
    x = rng.randn(n, *m.input_shape).astype(np.float32).reshape(n, -1)
    y = rng.randint(0, m.num_classes, n).astype(np.int32)
    p0 = _p0(model)
    bs = cfg.pop("batch_size", 32)
    rc = ref_cls("c0", m, RefClientData(x, y), RefClientConfig(**cfg),
                 batch_size=bs, **(kw or {}))
    pc = port_cls("c0", get_model(model), ClientData(x, y),
                  ClientConfig(**cfg), batch_size=bs, **(kw or {}))
    rr = rc.run_round({"params": jax.tree_util.tree_map(jax.numpy.asarray,
                                                        p0)}, 0)
    pr = pc.run_round({"params": convert.params_from_jax(p0)}, 0)
    return rr, pr, pc


def _run_both(cfg, server=None, client=None):
    """``init; register_*; run`` in both packages, the port from the
    reference's initial params."""
    ref_api.init(cfg)
    if server:
        ref_api.register_server(getattr(ref_st, server))
    if client:
        ref_api.register_client(getattr(ref_st, client))
    ref_res = ref_api.run()
    from repro.core import api as ref_core_api
    ref_trainer = ref_core_api._ctx.trainer

    repro_torch.init(cfg)
    if server:
        repro_torch.register_server(getattr(port_st, server))
    if client:
        repro_torch.register_client(getattr(port_st, client))
    from repro_torch.core import api as port_core_api
    from repro_torch.core.rounds import Trainer
    orig, p0 = Trainer.run, _p0(ref_trainer.model.name)

    def run(self, callback=None):
        self.server.params = convert.params_from_jax(p0)
        return orig(self, callback)
    Trainer.run = run
    try:
        port_res = repro_torch.run()
    finally:
        Trainer.run = orig
    return ref_res, port_res, ref_trainer, port_core_api._ctx.trainer


def _selected(trainer):
    task = trainer.tracker.get_task(trainer.cfg.task_id)
    return [sorted(task.rounds[r].clients) for r in sorted(task.rounds)]


def _assert_trajectory(ref_res, port_res, ref_t, port_t):
    _close(ref_res["params"], port_res["params"])
    for key in ("train_loss", "loss", "accuracy"):
        np.testing.assert_allclose(
            [h[key] for h in port_res["history"]],
            [h[key] for h in ref_res["history"]], rtol=1e-4, atol=1e-4,
            err_msg=key)
    for key in ("clients", "comm_up_bytes", "comm_down_bytes"):
        assert [h[key] for h in port_res["history"]] == \
            [h[key] for h in ref_res["history"]], key
    assert _selected(port_t) == _selected(ref_t)


CFG = {
    "model": "linear", "dataset": "synthetic",
    "data": {"num_clients": 15, "partition": "dir", "batch_size": 32},
    "server": {"rounds": 3, "clients_per_round": 5},
    "client": {"local_epochs": 2, "lr": 0.1},
}


def _with(**sections):
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in CFG.items()}
    for k, v in sections.items():
        out.setdefault(k, {}).update(v)
    return out


# ---------------------------------------------------------------------------
# FedProx
# ---------------------------------------------------------------------------


def test_fedprox_shrinks_update_norm_as_the_reference():
    def norm(res):
        return sum(float(np.sum(np.square(np.asarray(u))))
                   for u in jax.tree_util.tree_leaves(res["update"]))

    rr, pr, pc = _one_round(ref_st.FedProxClient, port_st.FedProxClient,
                            kw={"mu": 1.0}, local_epochs=3, lr=0.1)
    assert pc.cfg.proximal_mu == 1.0
    _close(rr["update"], pr["update"])
    r0, p0, _ = _one_round(RefClient, Client, local_epochs=3, lr=0.1)
    _close(r0["update"], p0["update"])
    assert norm(pr) < sum(float(torch.sum(torch.square(u)))
                          for u in tree_leaves(p0["update"]))
    assert port_st.fedprox_config({"x": 1}, mu=0.5) == \
        ref_st.fedprox_config({"x": 1}, mu=0.5)


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_fedprox_trajectory_matches_the_reference(execution):
    _assert_trajectory(*_run_both(
        _with(resources={"execution": execution}), client="FedProxClient"))


# ---------------------------------------------------------------------------
# STC client and server
# ---------------------------------------------------------------------------


def test_stc_client_sends_sparse_and_keeps_residual():
    rr, pr, pc = _one_round(ref_st.STCClient, port_st.STCClient,
                            local_epochs=2, lr=0.2, stc_sparsity=0.05)
    leaves = tree_leaves(pr["update"])
    assert any(isinstance(x, comp.CompressedTensor) for x in leaves)
    assert pc._residual is not None
    assert pr["payload_bytes"] == rr["payload_bytes"] > 0
    from repro.core.compression import decompress as ref_decompress
    _close(ref_decompress(rr["update"]), comp.decompress(pr["update"]))
    dense = comp.decompress(pr["update"])
    frac = np.mean([float((x != 0).to(torch.float32).mean())
                    for x in tree_leaves(dense) if x.numel() > 64])
    assert frac < 0.2
    assert port_st.stc_config({}, 0.02) == ref_st.stc_config({}, 0.02)


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_stc_client_and_server_trajectory_matches_the_reference(execution):
    """Bidirectional STC: STCServer sends sparse models, STCClient sparse
    updates (a stage override: the batched engine's gathering path)."""
    cfg = _with(resources={"execution": execution, "round_fusion": "off"},
                client={"stc_sparsity": 0.1})
    ref_res, port_res, ref_t, port_t = _run_both(cfg, server="STCServer",
                                                 client="STCClient")
    _assert_trajectory(ref_res, port_res, ref_t, port_t)
    assert port_t.server._residual is not None


# ---------------------------------------------------------------------------
# FedReID
# ---------------------------------------------------------------------------


def test_fedreid_keeps_local_head_out_of_aggregation():
    rr, pr, _ = _one_round(ref_st.FedReIDClient, port_st.FedReIDClient,
                           model="femnist_cnn", n=32, local_epochs=1,
                           lr=0.1, batch_size=16)
    assert float(pr["update"]["fc2"]["w"].abs().max()) == 0.0
    assert float(pr["update"]["conv1"]["w"].abs().max()) > 0.0
    _close(rr["update"], pr["update"])


def test_fedreid_trajectory_matches_the_reference():
    """femnist's virtual population (16 samples a client, generated on
    demand): the backbone moves, the local head stays at its init."""
    cfg = {"model": "femnist_cnn", "dataset": "femnist",
           "data": {"num_clients": 4, "virtual": "on",
                    "samples_per_client": 16, "batch_size": 8},
           "server": {"rounds": 2, "clients_per_round": 2},
           "client": {"local_epochs": 1, "lr": 0.05}}
    ref_res, port_res, ref_t, port_t = _run_both(cfg, client="FedReIDClient")
    _assert_trajectory(ref_res, port_res, ref_t, port_t)
    p0 = convert.params_from_jax(_p0("femnist_cnn"))
    assert torch.equal(port_res["params"]["fc2"]["w"], p0["fc2"]["w"])
    assert not torch.equal(port_res["params"]["conv1"]["w"],
                           p0["conv1"]["w"])


# ---------------------------------------------------------------------------
# Power-of-Choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_power_of_choice_selects_and_trains_as_the_reference(execution):
    cfg = _with(server={"rounds": 5},
                resources={"execution": execution, "round_fusion": "off"})
    ref_res, port_res, ref_t, port_t = _run_both(
        cfg, server="PowerOfChoiceServer")
    _assert_trajectory(ref_res, port_res, ref_t, port_t)
    accs = [h["accuracy"] for h in port_res["history"]]
    assert accs[-1] > accs[0]
    srv = port_t.server
    assert len(srv._last_loss) >= 5
    assert srv._last_loss.keys() == ref_t.server._last_loss.keys()
    sel = srv.selection(sorted(srv._last_loss), round_id=99)
    assert sel == ref_t.server.selection(sorted(ref_t.server._last_loss),
                                         round_id=99)
    losses = [srv._last_loss[c] for c in sel]
    assert np.mean(losses) >= np.mean(list(srv._last_loss.values())) - 1e-6


# ---------------------------------------------------------------------------
# FedBuff under the round-synchronous engines
# ---------------------------------------------------------------------------


def test_fedbuff_trains_with_staleness_weighting_as_the_reference():
    """Under ``batched`` each client's train time is its share of the
    cohort's steps, so the median split (who is one round stale) is the
    reference's; K=5 of 5 a round, then 3 a round with carried leftovers
    and the final flush."""
    for rounds_cfg in ({"rounds": 5, "clients_per_round": 5},
                       {"rounds": 4, "clients_per_round": 3}):
        cfg = _with(server=rounds_cfg,
                    system_heterogeneity={"enabled": True},
                    resources={"execution": "batched",
                               "round_fusion": "off"})
        ref_res, port_res, ref_t, port_t = _run_both(cfg,
                                                     server="FedBuffServer")
        _assert_trajectory(ref_res, port_res, ref_t, port_t)
        assert port_t.server.buffered_client_ids() == []    # flushed
    accs = [h["accuracy"] for h in port_res["history"]]
    assert accs[-1] > accs[0]
