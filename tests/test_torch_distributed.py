"""The sharded cohort of ``repro_torch`` (``resources.distributed =
"data"``) against the reference and against the port's unsharded run.

The port shards in one process over a list of devices
(``repro_torch.set_devices``), one shard an entry; a device may repeat, so
the CPU gives 2, 4 and 8 shards as the reference's tests get them from
forced host devices.  The reference is compared in this process, at its
1-device mesh or unsharded (its own subprocess tests hold its k > 1 meshes
to its unsharded run, ``tests/test_distributed_batched.py``).

* the mesh: the power-of-two prefix and its warning, the refusals (an
  empty device list, an unknown ``distributed``, ``"data"`` outside the
  batched engine) with the reference's messages;
* the sharded routes on the plain versions: K1 against ``ref.fedavg_ref``
  at the reference's bar and, at k = 1, against the reference's sharded
  program within 1e-6; K2 / K3 bit for bit against the port unsharded and
  the reference's masks, counts and int8 round trip;
* the executor on the reference test's unbalanced cohort: k = 1 bit for
  bit, k = 2, 4, 8 within rtol 1e-5 / atol 1e-6 of the port unsharded,
  and within 1e-5 of the reference;
* end to end on the reference test's two configurations, k = 1 and 2,
  against the reference's batched run; at k = 2 against the port
  unsharded: hierarchical FedAvg, faults, the staged and gathering paths,
  the deferred round sync, and a checkpoint that resumes at k = 1 and
  loads in the reference.
"""
import ast
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core.batched import BatchedExecutor as RefExecutor  # noqa: E402
from repro.core.batched import build_client_mesh as ref_mesh  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.config import ClientConfig as RefClientConfig  # noqa: E402
from repro.core.config import Config as RefConfig  # noqa: E402
from repro.core.config import validate_config as ref_validate  # noqa: E402
from repro.data.fed_data import ClientData as RefClientData  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.kernels.fedavg_agg import (  # noqa: E402
    fedavg_aggregate_sharded as ref_sharded, fold_staleness as ref_fold,
)
from repro.models.small import linear_model as ref_linear  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.batched import (  # noqa: E402
    BatchedExecutor, build_client_mesh,
)
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.config import ClientConfig, Config  # noqa: E402
from repro_torch.core.config import validate_config  # noqa: E402
from repro_torch.core.tiered_store import TieredRowStore  # noqa: E402
from repro_torch.data.fed_data import ClientData  # noqa: E402
from repro_torch.kernels import fedavg_agg, ops, quant, stc_topk  # noqa: E402
from repro_torch.models.small import linear_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from test_torch_sequential import (  # noqa: E402
    _init_params, _merge, _run_port, _run_ref,
)

repro_torch.set_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
KS = (1, 2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made these runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shards():
    """``shards(k)`` sets k CPU shards for ``init``/``run``; the default
    device list comes back afterwards."""
    yield lambda k: repro_torch.set_devices(["cpu"] * k)
    repro_torch.set_devices(None)


def _mesh(k):
    return build_client_mesh(["cpu"] * k)


# ---------------------------------------------------------------------------
# the mesh and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,size", [(1, 1), (2, 2), (3, 2), (5, 4), (8, 8),
                                    (12, 8)])
def test_mesh_takes_the_largest_power_of_two_prefix(n, size):
    devs = ["cpu"] * n
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        mesh = build_client_mesh(devs)
    assert mesh.size == size and mesh.axis_names == ("clients",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    msgs = [str(w.message) for w in got]
    if size < n:      # the reference's text, its numbers from this list
        assert msgs == [f"client mesh uses {size} of {n} devices (largest "
                        f"power of two); {n - size} device(s) stay idle"]
    else:
        assert msgs == []


def test_default_devices_follow_set_device_and_set_devices(shards):
    assert repro_torch.get_devices() == [torch.device("cpu")]
    shards(3)
    assert repro_torch.get_devices() == [torch.device("cpu")] * 3
    ex = BatchedExecutor(linear_model(), torch.device("cpu"), "data")
    assert ex.mesh.size == 2                  # power-of-two prefix of 3


def test_refusals_carry_the_reference_messages():
    with pytest.raises(ValueError) as ref_err:
        RefExecutor(ref_linear(), distributed="data", devices=[])
    with pytest.raises(ValueError) as port_err:
        BatchedExecutor(linear_model(), torch.device("cpu"), "data",
                        devices=[])
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError) as ref_err:
        RefExecutor(ref_linear(), distributed="model")
    with pytest.raises(ValueError) as port_err:
        BatchedExecutor(linear_model(), torch.device("cpu"), "model")
    assert str(port_err.value) == str(ref_err.value)
    for res in ({"distributed": "pipeline"},
                {"distributed": "data", "execution": "sequential"},
                {"distributed": "data", "execution": "async"}):
        with pytest.raises(ValueError) as ref_err:
            ref_validate(RefConfig.make({"resources": res}))
        with pytest.raises(ValueError) as port_err:
            validate_config(Config.make({"resources": res}))
        assert str(port_err.value) == str(ref_err.value), res


def test_no_module_of_the_port_imports_torch_distributed():
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.startswith("torch.distributed")
                           for n in names), path


def test_every_launch_makes_its_card_current(monkeypatch):
    """A shard's kernels launch on its own card: CUDA refuses a launch into
    a stream of another device than the current one, so every C launcher
    is called through ``build.launch``, which enters
    ``torch.cuda.device(device)`` around the call."""
    from repro_torch.kernels import build

    kdir = ROOT / "src" / "repro_torch" / "kernels"
    for path in sorted(kdir.glob("*.py")):
        if path.name == "build.py":
            continue
        tree = ast.parse(path.read_text())
        routed = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "launch":
                routed.update(id(a) for a in node.args)
            if isinstance(node, ast.Attribute) and node.attr == "stream":
                assert not (isinstance(node.value, ast.Name)
                            and node.value.id == "build"), path
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr.endswith("_launch"):
                assert id(node) in routed, (path, node.attr)
    seen = []

    class Current:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            seen.append(("enter", self.device))

        def __exit__(self, *exc):
            seen.append(("exit", self.device))

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(build, "stream", lambda device: 77)
    card = torch.device("cuda", 3)
    build.launch(card, "k", lambda a, b, stream: seen.append(
        ("call", a, b, stream)) or 0, 1, 2)
    assert seen == [("enter", card), ("call", 1, 2, 77), ("exit", card)]
    with pytest.raises(RuntimeError, match="k: CUDA launch failed"):
        build.launch(card, "k", lambda stream: 9)


@pytest.mark.parametrize("capacity", (4, 8, 1024))
def test_ef_store_state_round_trips_at_any_hot_tier_capacity(capacity):
    """The EF store is the same whatever the mesh (its rows stay on the
    first shard's device), so a snapshot taken with rows spilled to the
    host tier loads into a fresh store with every row's values."""
    s = TieredRowStore(capacity, spill="host", name="ef")
    gen = torch.Generator().manual_seed(capacity)
    vals = {}
    for i in range(11):
        cid = f"c{i}"
        s.ensure([cid], zero_shapes=[(5,), (3,)])
        vals[cid] = [torch.randn(1, 5, generator=gen),
                     torch.randn(1, 3, generator=gen)]
        s.scatter([cid], vals[cid])
    one = TieredRowStore(1024, spill="host", name="ef")
    one.load_state(s.state())
    snap = one.state()["clients"]
    assert sorted(snap) == sorted(vals)
    for cid, v in vals.items():
        assert all(torch.equal(a, b[0]) for a, b in zip(snap[cid], v))


# ---------------------------------------------------------------------------
# the sharded routes, on their plain versions
# ---------------------------------------------------------------------------


def _agg_inputs():
    rs = np.random.RandomState(1)
    u = rs.standard_normal((37, 700)).astype(np.float32)
    w = np.asarray(jax.nn.softmax(jnp.asarray(
        rs.standard_normal(37).astype(np.float32))))
    s = rs.randint(0, 4, 37).astype(np.float32)
    return u, w, s


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("fanout", [0, 2])
@pytest.mark.parametrize("k", KS)
def test_sharded_fedavg_matches_the_reference_oracle(k, fanout, stale):
    u, w, s = _agg_inputs()
    st = torch.from_numpy(s) if stale else None
    out = ops.fedavg_aggregate_sharded(torch.from_numpy(u),
                                       torch.from_numpy(w), _mesh(k),
                                       staleness=st, fanout=fanout)
    wf = (np.asarray(ref_fold(jnp.asarray(w), jnp.asarray(s), 0.5))
          if stale else w)
    exp = np.asarray(ref_oracle.fedavg_ref(jnp.asarray(u), jnp.asarray(wf)))
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-5, atol=1e-4)
    # the plain version is the same sum in the same order; row blocks
    # given one a shard take the same route
    plain = fedavg_agg.fedavg_sharded_plain(
        torch.from_numpy(u),
        fedavg_agg.fold_staleness(torch.from_numpy(w), st) if stale
        else torch.from_numpy(w), k, fanout)
    assert torch.equal(out, plain)
    if 37 % k == 0 or k == 1:
        return
    blocks = list(torch.from_numpy(u).tensor_split(k))
    assert torch.equal(ops.fedavg_aggregate_sharded(
        blocks, torch.from_numpy(w), _mesh(k), staleness=st,
        fanout=fanout), out)


@pytest.mark.parametrize("fanout", [0, 2])
def test_one_shard_fedavg_matches_the_reference_sharded_program(fanout):
    u, w, _ = _agg_inputs()
    ref = np.asarray(ref_sharded(jnp.asarray(u), jnp.asarray(w),
                                 ref_mesh(jax.devices()[:1]), fanout=fanout))
    out = ops.fedavg_aggregate_sharded(torch.from_numpy(u),
                                       torch.from_numpy(w), _mesh(1),
                                       fanout=fanout)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_sharded_routes_refuse_a_wrong_mesh_or_an_uneven_cohort():
    x = torch.zeros((6, 10))
    bad = _mesh(2)._replace(axis_names=("rows",))
    for fn in (lambda m: ops.fedavg_aggregate_sharded(x, torch.ones(6), m),
               lambda m: ops.stc_compress_batched(x, 0.1, mesh=m),
               lambda m: ops.int8_roundtrip_batched(x, mesh=m)):
        with pytest.raises(ValueError, match="needs a 1-D mesh with axis "
                                             "'clients', got axes"):
            fn(bad)
    with pytest.raises(ValueError, match="client dim 6 must be divisible "
                                         "by the mesh size 4"):
        ops.stc_compress_batched(x, 0.1, mesh=_mesh(4))
    with pytest.raises(ValueError, match="client dim 6 must be divisible "
                                         "by the mesh size 4"):
        ops.int8_roundtrip_batched(x, mesh=_mesh(4))


@pytest.fixture(scope="module")
def compress_ref():
    """(16, 9000) rows and the reference's unsharded K2 / K3 results."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 9000)))
    ro, rn = ref_ops.stc_compress_batched(jnp.asarray(x), 0.05,
                                          interpret=True)
    rs, _ = ref_ops.int8_roundtrip_batched(jnp.asarray(x), interpret=True)
    return x, np.asarray(ro), np.asarray(rn), np.asarray(rs)


@pytest.mark.parametrize("k", KS)
def test_sharded_stc_and_int8_equal_unsharded_bitwise(k, compress_ref):
    x, ro, rn, rs = compress_ref
    xt = torch.from_numpy(x)
    base_out, base_nnz = ops.stc_compress_batched(xt, 0.05)
    base_sent, base_scale = ops.int8_roundtrip_batched(xt)
    out, nnz = ops.stc_compress_batched(xt, 0.05, mesh=_mesh(k))
    sent, scale = ops.int8_roundtrip_batched(xt, mesh=_mesh(k))
    for a, b in ((out, base_out), (nnz, base_nnz), (sent, base_sent),
                 (scale, base_scale)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # row blocks in -> per-shard lists out, the same values
    parts = list(xt.chunk(k))
    po, pn = stc_topk.stc_compress_batched_sharded(parts, 0.05, _mesh(k))
    ps, _ = quant.int8_roundtrip_batched_sharded(parts, _mesh(k))
    assert len(po) == len(pn) == len(ps) == k
    assert torch.equal(torch.cat(po), out) and torch.equal(torch.cat(pn), nnz)
    assert torch.equal(torch.cat(ps), sent)
    # the reference's unsharded kernels: masks, signs and counts, and the
    # int8 round trip bit for bit
    np.testing.assert_array_equal(np.sign(out.numpy()), np.sign(ro))
    np.testing.assert_array_equal(nnz.numpy(), rn)
    np.testing.assert_array_equal(sent.numpy().view(np.int32),
                                  rs.view(np.int32))


# ---------------------------------------------------------------------------
# the executor: the reference test's unbalanced cohort
# ---------------------------------------------------------------------------


def _cohort(client_cls, data_cls, cfg_cls, model):
    rng = np.random.RandomState(0)
    out = []
    for i, n in enumerate([40, 64, 33, 50, 48]):
        data = data_cls(rng.randn(n, 64).astype(np.float32),
                        rng.randint(0, 10, n).astype(np.int32))
        out.append(client_cls(f"c{i}", model, data,
                              cfg_cls(local_epochs=2, lr=0.1),
                              batch_size=16))
    return out


def _stacked(st):
    """Stacked results as numpy, the per-shard trees joined in row order."""
    blocks = st["updates"] if st.get("sharded") else [st["updates"]]
    per = [tree_leaves(b) for b in blocks]
    leaves = [torch.cat([p[i] for p in per]).numpy()
              for i in range(len(per[0]))]
    return leaves, st["loss"], st["acc"]


@pytest.fixture(scope="module")
def executor_base():
    """The reference's unsharded run and the port's, from one init."""
    ref_model = ref_linear()
    p0 = ref_model.init(jax.random.PRNGKey(0))
    ref_st = RefExecutor(ref_model).run_cohort_stacked(
        _cohort(RefClient, RefClientData, RefClientConfig, ref_model), p0,
        round_id=3)
    ref = ([np.asarray(a) for a in jax.tree_util.tree_leaves(
        ref_st["updates"])], ref_st["loss"], ref_st["acc"])
    model = linear_model()
    params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p0))
    clients = _cohort(Client, ClientData, ClientConfig, model)
    base = _stacked(BatchedExecutor(model, torch.device("cpu"))
                    .run_cohort_stacked(clients, params, round_id=3))
    return ref, base, model, params, clients


@pytest.mark.parametrize("k", KS)
def test_executor_shard_count_invariance(k, executor_base):
    ref, base, model, params, clients = executor_base
    ex = BatchedExecutor(model, torch.device("cpu"), "data",
                         devices=["cpu"] * k)
    assert ex.mesh.size == k
    st = ex.run_cohort_stacked(clients, params, round_id=3)
    assert st["sharded"] and len(st["updates"]) == k
    got = _stacked(st)
    if k == 1:                              # the reference's k = 1 rule
        for a, b in zip(base[0], got[0]):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))
        assert np.array_equal(base[1], got[1])
        assert np.array_equal(base[2], got[2])
    else:
        for a, b in zip(base[0] + [base[1], base[2]],
                        got[0] + [got[1], got[2]]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    for a, b in zip(ref[0] + [ref[1], ref[2]], got[0] + [got[1], got[2]]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # the gathering path takes each client's rows from its shard
    per = ex.run_cohort(clients, params, round_id=3)
    for i, res in enumerate(per):
        for a, b in zip(tree_leaves(res["update"]), got[0]):
            assert torch.equal(a, torch.from_numpy(b[i]))


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

#: the reference tests' two configurations
#: (``tests/test_distributed_batched.py``,
#: ``tests/test_compressed_fastpath.py``)
E2E = {
    "none": {
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 12, "batch_size": 32,
                 "unbalanced": True, "unbalanced_sigma": 1.0},
        "server": {"rounds": 3, "clients_per_round": 5},
        "client": {"local_epochs": 2, "lr": 0.1},
        "resources": {"execution": "batched"},
    },
    "stc": {
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 12, "batch_size": 32},
        "server": {"rounds": 3, "clients_per_round": 5},
        "client": {"local_epochs": 2, "lr": 0.1,
                   "compression": "stc", "stc_sparsity": 0.05},
        "resources": {"execution": "batched"},
    },
}


@pytest.fixture(scope="module")
def e2e_ref():
    return {name: _run_ref(cfg)[1] for name, cfg in E2E.items()}


def _run(cfg, p0, k=None, **kw):
    """The port's run of ``cfg`` from ``p0``; ``k`` shards it."""
    if k is not None:
        cfg = _merge(cfg, {"resources": {"distributed": "data"}})
        repro_torch.set_devices(["cpu"] * k)
    try:
        return _run_port(cfg, p0, **kw)
    finally:
        repro_torch.set_devices(None)


@pytest.mark.parametrize("k", (1, 2))
@pytest.mark.parametrize("name", sorted(E2E))
def test_sharded_run_matches_the_reference_batched_run(name, k, e2e_ref):
    cfg = E2E[name]
    trainer, res = _run(cfg, _init_params(cfg), k)
    assert trainer.engine.mesh.size == k
    ref = e2e_ref[name]
    for a, b in zip(jax.tree_util.tree_leaves(ref["params"]),
                    tree_leaves(res["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose([h["train_loss"] for h in res["history"]],
                               [h["train_loss"] for h in ref["history"]],
                               rtol=1e-4)
    ub, ud = (np.array([h["comm_up_bytes"] for h in r["history"]])
              for r in (ref, res))
    if name == "none":
        assert ub.tolist() == ud.tolist()
    else:                       # the reference test's bar for STC bytes
        assert np.abs(ub - ud).max() <= 0.02 * ub.max() + 16, (ub, ud)


class _OwnCompression(Client):
    """A stage override: the round takes the gathering path."""

    def compression(self, result):
        return super().compression(result)


#: at k = 2 against the port's unsharded run (K1 on both, so both sum in
#: the same order): name -> (config overrides, Trainer keywords)
PATHS = {
    "hierarchical": ({"resources": {"aggregation_topology": "hierarchical"},
                      "client": {"compression": "stc"}}, {}),
    "hierarchical fanout 2": ({"resources": {
        "aggregation_topology": "hierarchical", "aggregation_fanout": 2}},
        {}),
    "faults": ({"faults": {"dropout_prob": 0.2, "crash_prob": 0.1,
                           "nan_update_prob": 0.2, "seed": 3},
                "client": {"compression": "int8"}}, {}),
    "staged": ({"resources": {"round_fusion": "off"},
                "client": {"compression": "stc"}}, {}),
    "staged faults": ({"resources": {"round_fusion": "off"},
                       "faults": {"dropout_prob": 0.2,
                                  "nan_update_prob": 0.3, "seed": 3},
                       "client": {"compression": "int8"}}, {}),
    "gathering": ({"client": {"compression": "stc"}},
                  {"client_cls": _OwnCompression}),
    "deferred sync": ({"tracking": {"round_sync": False},
                       "client": {"compression": "int8"}}, {}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_paths_match_the_unsharded_run(path):
    over, kw = PATHS[path]
    cfg = _merge(_merge(E2E["none"], {"resources": {
        "aggregation_kernel": True}}), over)
    p0 = _init_params(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the gathering path's warn-once
        _, base = _run(cfg, p0, **kw)
        trainer, res = _run(cfg, p0, 2, **kw)
    assert trainer.engine.mesh.size == 2
    for a, b in zip(tree_leaves(base["params"]), tree_leaves(res["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for h0, h in zip(base["history"], res["history"]):
        assert abs(h0["train_loss"] - h["train_loss"]) <= 1e-4
        for key in ("comm_up_bytes", "clients", "survivors", "rejected",
                    "dropped", "crashed"):
            assert h0.get(key) == h.get(key), key


def test_sharded_checkpoint_resumes_unsharded_and_loads_in_the_reference(
        tmp_path):
    """A run at k = 2 checkpoints after round 2; a fresh trainer at k = 1
    resumes it and ends where the uninterrupted k = 2 run ends; the file
    loads in the reference with the port's EF rows."""
    d = str(tmp_path / "ck")
    cfg = _merge(E2E["stc"], {"server": {"rounds": 3},
                              "checkpoint": {"every": 2, "dir": d},
                              "resources": {"aggregation_kernel": True}})
    p0 = _init_params(cfg)
    _, full = _run(cfg, p0, 2)
    ck = ref_store.load_checkpoint(d, 2)
    assert ck["execution"] == "batched" and ck["round"] == 2
    assert ck["ef"]["format"] == 2 and len(ck["ef"]["clients"]) >= 5
    assert all(len(rows) == len(tree_leaves(full["params"]))
               for rows in ck["ef"]["clients"].values())
    cfg = _merge(cfg, {"resources": {"distributed": "data"}})
    repro_torch.set_devices(["cpu"])
    try:
        from repro_torch.core.rounds import Trainer
        from repro_torch.data.fed_data import build_federated_data
        from repro_torch.models.registry import get_model
        pcfg = Config.make(cfg)
        t = Trainer(pcfg, get_model("linear"),
                    build_federated_data(pcfg.data))
        assert t.engine.mesh.size == 1
        res = t.resume(step=2)
    finally:
        repro_torch.set_devices(None)
    assert len(res["history"]) == 3
    for a, b in zip(tree_leaves(full["params"]), tree_leaves(res["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
