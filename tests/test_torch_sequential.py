"""The sequential engine (``resources.execution="sequential"``, the default)
of ``repro_torch`` against the reference's sequential engine, from the
reference's initial parameters: whole trajectories, the compression stage
with error feedback, the local-training pieces, stage overrides and
registered aggregators (those two and the sequential-against-batched
check in ``tests/test_torch_sequential_overrides.py``).

Bars: params within 1e-5 and ``train_loss`` within 1e-4 (the reference's
engine-parity tolerances); selection and ``comm_up_bytes`` exact.  The
compression stage: STC masks and ``nnz`` exact, int8 ``q`` and ``scale``
bit for bit; STC values are the port's correctly rounded mean of the kept
magnitudes (within 0.5 ulp of the float64 mean), while the reference's
eager f32 sum lands up to a few ulp from it
(``test_stc_stage_gap_is_the_reference_f32_sum``), so port and reference
differ by at most that distance plus half an ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.local_train import local_train as ref_local_train  # noqa: E402
from repro.core.rounds import Trainer as RefTrainer  # noqa: E402
from repro.core.server import Server as RefServer  # noqa: E402
from repro.data.fed_data import build_federated_data as ref_build  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro.optim import get_optimizer as ref_get_optimizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as port_comp  # noqa: E402
from repro_torch.core.client import Client as PortClient  # noqa: E402
from repro_torch.core.config import Config as PortConfig  # noqa: E402
from repro_torch.core.local_train import local_train as port_local_train  # noqa: E402
from repro_torch.core.rounds import Trainer as PortTrainer  # noqa: E402
from repro_torch.core.server import Server as PortServer  # noqa: E402
from repro_torch.data.fed_data import build_federated_data as port_build  # noqa: E402
from repro_torch.models.registry import get_model as port_get_model  # noqa: E402
from repro_torch.optim import clip_by_global_norm as port_clip  # noqa: E402
from repro_torch.optim import get_optimizer as port_get_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

repro_torch.set_device("cpu")

LINEAR = {
    "model": "linear",
    "data": {"dataset": "synthetic", "num_clients": 10, "batch_size": 32},
    "server": {"rounds": 3, "clients_per_round": 5},
    "client": {"local_epochs": 2, "lr": 0.1},
}
FEMNIST = {
    "model": "femnist_cnn",
    "data": {"dataset": "femnist", "num_clients": 20, "data_amount": 0.05,
             "batch_size": 16},
    "server": {"rounds": 2, "clients_per_round": 4},
    "client": {"local_epochs": 1, "compression": "stc"},
}


def _merge(base, extra):
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in base.items()}
    for k, v in extra.items():
        if isinstance(v, dict):
            out.setdefault(k, {}).update(v)
        else:
            out[k] = v
    return out


def _init_params(cfg):
    rcfg = RefConfig.make(cfg)
    return jax.tree_util.tree_map(
        np.asarray, ref_get_model(rcfg.model).init(
            jax.random.PRNGKey(rcfg.seed)))


def _run_ref(cfg, server_cls=RefServer, client_cls=RefClient):
    rcfg = RefConfig.make(cfg)
    model = ref_get_model(rcfg.model)
    data = ref_build(rcfg.data)
    trainer = RefTrainer(rcfg, model, data,
                         server=server_cls(model, rcfg, data.test),
                         client_cls=client_cls)
    return trainer, trainer.run()


def _run_port(cfg, p0, server_cls=PortServer, client_cls=PortClient):
    pcfg = PortConfig.make(cfg)
    model = port_get_model(pcfg.model)
    data = port_build(pcfg.data)
    trainer = PortTrainer(pcfg, model, data,
                          server=server_cls(model, pcfg, data.test),
                          client_cls=client_cls)
    trainer.server.params = convert.params_from_jax(p0)   # injected weights
    return trainer, trainer.run()


def _selected(trainer, rounds):
    task = trainer.tracker.get_task(trainer.cfg.task_id)
    return [sorted(task.rounds[r].clients) for r in range(rounds)]


def _assert_trajectory(ref, ref_res, port, port_res, rounds):
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


def _both(cfg, rounds, ref_kw=None, port_kw=None):
    p0 = _init_params(cfg)
    ref, ref_res = _run_ref(cfg, **(ref_kw or {}))
    port, port_res = _run_port(cfg, p0, **(port_kw or {}))
    _assert_trajectory(ref, ref_res, port, port_res, rounds)
    return port, port_res


# ---------------------------------------------------------------------------
# engine trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_quickstart_matches_reference_sequential(compression):
    cfg = _merge(LINEAR, {"client": {"compression": compression}})
    port, _ = _both(cfg, rounds=3)
    assert port.engine is None          # no batched executor is built


def test_femnist_cnn_none_matches_reference_sequential():
    _both(_merge(FEMNIST, {"client": {"compression": "none"}}), rounds=2)


def test_femnist_cnn_stc_matches_reference_sequential():
    """At femnist's width the two packages' convolutions round differently
    (client updates differ by up to ~1e-5), and STC turns an element that
    lies that close to its tile's threshold into a whole ``±mu`` flip, a
    few elements of one client's round-0 update.  So the trajectory is
    held by selection, bytes down and ``train_loss``; the stage itself is
    held exactly on the reference's own update, and the flips by count."""
    p0 = _init_params(FEMNIST)
    ref, ref_res = _run_ref(FEMNIST)
    port, port_res = _run_port(FEMNIST, p0)
    np.testing.assert_allclose(
        [h["train_loss"] for h in port_res["history"]],
        [h["train_loss"] for h in ref_res["history"]], rtol=1e-4, atol=1e-4)
    for key in ("comm_down_bytes", "clients"):
        assert [h[key] for h in port_res["history"]] == \
            [h[key] for h in ref_res["history"]], key
    assert _selected(port, 2) == _selected(ref, 2)

    cid = _selected(ref, 1)[0][0]
    ref_up = ref.client(cid).train(
        jax.tree_util.tree_map(jnp.asarray, p0), 0)["update"]
    port_up = port.client(cid).train(convert.params_from_jax(p0), 0)["update"]
    flips = total = 0
    for a, b in zip(jax.tree_util.tree_leaves(ref_up), tree_leaves(port_up)):
        a = np.asarray(a)
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)
        if a.size < port_comp.DENSE_MIN_ELEMS:
            continue
        ref_c = ref_comp.stc_compress_array(jnp.asarray(a), 0.01)
        same = port_comp.stc_compress_array(torch.from_numpy(a), 0.01)
        np.testing.assert_array_equal(np.asarray(ref_c.data) != 0,
                                      same.data.numpy() != 0)
        assert int(ref_c.nnz) == int(same.nnz.item())
        own = port_comp.stc_compress_array(b, 0.01)
        flips += int(((np.asarray(ref_c.data) != 0)
                      != (own.data.numpy() != 0)).sum())
        total += a.size
    assert flips <= 1e-5 * total


def test_default_execution_is_sequential_and_runs():
    repro_torch.reset()
    cfg = repro_torch.init({"dataset": "synthetic", "clients_per_round": 3,
                            "rounds": 2, "data": {"num_clients": 6}})
    assert cfg.resources.execution == "sequential"
    res = repro_torch.run()
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["train_loss"]) for h in res["history"])
    assert repro_torch.tracker().round_series(cfg.task_id, "train_loss") \
        == [h["train_loss"] for h in res["history"]]
    repro_torch.reset()


# ---------------------------------------------------------------------------
# the compression stage
# ---------------------------------------------------------------------------


def _stage_tree(seed):
    """A leaf under DENSE_MIN_ELEMS, a length that is not a multiple of
    8192, an all-zero tensor and an outlier-heavy tensor."""
    rs = np.random.RandomState(seed)
    heavy = (rs.standard_normal((40, 100)) * 0.01).astype(np.float32)
    heavy.flat[rs.permutation(heavy.size)[:30]] *= np.float32(1e4)
    return {"a_small": rs.standard_normal((7, 9)).astype(np.float32),
            "b_ragged": (rs.standard_normal(20001) * 0.3).astype(np.float32),
            "c_zero": np.zeros((16, 64), np.float32),
            "d_heavy": heavy}


def _exact_mu_ulps(x, out):
    """Largest |value - exact mean| in ulps over the 8192-element tiles of
    an STC output (the exact mean: float64 of the kept |x|)."""
    x, out = x.reshape(-1), out.reshape(-1)
    worst = 0.0
    for s0 in range(0, x.size, 8192):
        xs, os = x[s0:s0 + 8192], out[s0:s0 + 8192]
        kept = os != 0
        if kept.any():
            exact = np.abs(xs[kept].astype(np.float64)).mean()
            worst = max(worst, float(
                (np.abs(np.abs(os[kept]).astype(np.float64) - exact)
                 / np.spacing(np.float32(exact))).max()))
    return worst


def _assert_leaf(r, p, x, method):
    assert r.kind == p.kind
    if r.kind == "int8":
        np.testing.assert_array_equal(np.asarray(r.data), p.data.numpy())
        assert np.asarray(r.scale).tobytes() == p.scale.numpy().tobytes()
    elif r.kind == "stc":
        ra, pa = np.asarray(r.data), p.data.numpy()
        np.testing.assert_array_equal(ra != 0, pa != 0)
        np.testing.assert_array_equal(np.sign(ra), np.sign(pa))
        assert int(r.nnz) == int(p.nnz.item())
        assert _exact_mu_ulps(x, pa) <= 0.5            # correctly rounded
        gap = np.abs(ra.astype(np.float64) - pa)[pa != 0]
        if gap.size:
            spacing = np.spacing(np.abs(pa[pa != 0]))
            assert (gap / spacing).max() <= _exact_mu_ulps(x, ra) + 0.5
    else:
        np.testing.assert_array_equal(np.asarray(r.data), p.data.numpy())


@pytest.mark.parametrize("method", ["stc", "int8"])
def test_compression_stage_matches_reference(method):
    tree = _stage_tree(1)
    ref_c = ref_comp.compress(jax.tree_util.tree_map(jnp.asarray, tree),
                              method, 0.01)
    port_c = port_comp.compress(convert.params_from_jax(tree), method, 0.01)
    for key in tree:
        _assert_leaf(ref_c[key], port_c[key], tree[key], method)
    assert port_comp.payload_bytes(port_c) == ref_comp.payload_bytes(ref_c)
    ref_d = ref_comp.decompress(ref_c)
    port_d = port_comp.decompress(port_c)
    if method == "int8":
        for key in tree:
            np.testing.assert_array_equal(np.asarray(ref_d[key]),
                                          port_d[key].numpy())


@pytest.mark.parametrize("method", ["stc", "int8"])
def test_error_feedback_matches_reference_over_two_calls(method):
    ups = [_stage_tree(s) for s in (2, 3)]
    ref_r = ref_comp.zero_residual(jax.tree_util.tree_map(jnp.asarray, ups[0]))
    port_r = port_comp.zero_residual(convert.params_from_jax(ups[0]))
    for up in ups:
        ref_c, ref_r = ref_comp.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, up), ref_r, method, 0.01)
        port_c, port_r = port_comp.compress_with_feedback(
            convert.params_from_jax(up), port_r, method, 0.01)
        assert port_comp.payload_bytes_many([port_c, port_c]) == \
            [ref_comp.payload_bytes(ref_c)] * 2
        for key in up:
            a, b = np.asarray(ref_r[key]), port_r[key].numpy()
            if method == "int8":
                np.testing.assert_array_equal(a, b)
            else:   # kept entries carry the STC mean's ulps
                np.testing.assert_allclose(a, b, rtol=0, atol=4 * float(
                    np.spacing(np.float32(np.abs(up[key]).max() + 1e-30))))
                np.testing.assert_array_equal(
                    np.asarray(ref_c[key].data) != 0,
                    port_c[key].data.numpy() != 0)
    c, r = port_comp.compress_with_feedback(port_r, port_r, "none", 0.01)
    assert c is port_r and r is port_r


def test_stc_stage_gap_is_the_reference_f32_sum():
    """The reference's eager stage sums the kept magnitudes in f32 and can
    land more than 2 ulp from their exact mean; the port stays within half
    an ulp of it."""
    rs = np.random.RandomState(0)
    ref_worst = port_worst = 0.0
    for _ in range(12):                # one shape: one reference compile
        x = (rs.standard_normal(3 * 8192 + 5)
             * rs.uniform(1e-4, 10)).astype(np.float32)
        ref_out = np.asarray(ref_comp.stc_compress_array(jnp.asarray(x),
                                                         0.01).data)
        port_out = port_comp.stc_compress_array(torch.from_numpy(x),
                                                0.01).data.numpy()
        ref_worst = max(ref_worst, _exact_mu_ulps(x, ref_out))
        port_worst = max(port_worst, _exact_mu_ulps(x, port_out))
    assert port_worst <= 0.5
    assert ref_worst > 2.0             # 2.05 ulp on these inputs


def test_stc_threshold_matches_reference():
    x = np.abs(np.random.RandomState(4).standard_normal(5000)
               ).astype(np.float32)
    a = ref_comp.stc_threshold(jnp.asarray(x), 0.05)
    b = port_comp.stc_threshold(torch.from_numpy(x), 0.05)
    assert np.asarray(a).tobytes() == b.numpy().tobytes()


# ---------------------------------------------------------------------------
# local-training pieces
# ---------------------------------------------------------------------------


def test_clip_by_global_norm_matches_reference():
    rs = np.random.RandomState(6)
    tree = {"w": rs.standard_normal((30, 4)).astype(np.float32),
            "b": rs.standard_normal(4).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        ref_t, ref_n = ref_clip(jax.tree_util.tree_map(jnp.asarray, tree),
                                max_norm)
        for m in (max_norm, torch.tensor(max_norm)):
            port_t, port_n = port_clip(convert.params_from_jax(tree), m)
            np.testing.assert_allclose(np.asarray(ref_n), port_n.numpy(),
                                       rtol=1e-6)
            for key in tree:
                np.testing.assert_allclose(np.asarray(ref_t[key]),
                                           port_t[key].numpy(), rtol=1e-5,
                                           atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_local_train_with_prox_and_clip_matches_reference(optimizer):
    cfg = _merge(LINEAR, {"client": {"optimizer": optimizer}})
    rcfg = RefConfig.make(cfg)
    data = port_build(PortConfig.make(cfg).data).clients["client_0000"]
    p0 = _init_params(cfg)
    gp = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05), p0)          # a distinct anchor
    c = rcfg.client
    hp = (c.optimizer, 0.05, c.momentum, c.weight_decay, c.nesterov,
          c.adam_b1, c.adam_b2, c.adam_eps)
    kw = dict(epochs=2, batch_size=8, proximal_mu=0.1, max_grad_norm=0.3,
              seed=11)
    ref_p, ref_m = ref_local_train(
        ref_get_model("linear"), jax.tree_util.tree_map(jnp.asarray, p0),
        data.x, data.y, optimizer=ref_get_optimizer(*hp),
        global_params=jax.tree_util.tree_map(jnp.asarray, gp), **kw)
    port_p, port_m = port_local_train(
        port_get_model("linear"), convert.params_from_jax(p0), data.x,
        data.y, optimizer=port_get_optimizer(*hp),
        global_params=convert.params_from_jax(gp), **kw)
    for a, b in zip(jax.tree_util.tree_leaves(ref_p), tree_leaves(port_p)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert ref_m["batches"] == port_m["batches"]
    np.testing.assert_allclose(port_m["loss"], ref_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(port_m["accuracy"], ref_m["accuracy"],
                               rtol=1e-6)


def test_stage_names():
    from repro.core import stages as ref_stages
    from repro_torch.core import stages
    assert stages.SERVER_STAGES == ref_stages.SERVER_STAGES
    assert stages.CLIENT_STAGES == ref_stages.CLIENT_STAGES
    payload = {"params": 1}
    assert stages.identity_stage(payload) is payload


def test_dense_update_bytes_counts_each_leaf_dtype():
    from repro.core.rounds import dense_update_bytes as ref_bytes
    from repro_torch.core.rounds import dense_update_bytes
    tree = {"a": np.zeros((3, 5), np.float32), "b": np.zeros(7, np.float16),
            "c": np.zeros((2, 2), np.int8)}
    assert dense_update_bytes(convert.params_from_jax(tree)) == \
        ref_bytes(jax.tree_util.tree_map(jnp.asarray, tree)) == 78
    assert port_comp.array_nbytes(tree["b"]) == 14


def test_sequential_client_hyperparameters_follow_the_config():
    cfg = PortConfig.make(_merge(LINEAR, {"client": {"proximal_mu": 0.2}}))
    trainer = PortTrainer(cfg, port_get_model("linear"), port_build(cfg.data))
    c = trainer.client("client_0000")
    assert dataclasses.replace(c.cfg) == cfg.client
    assert c._residual is None
