"""K1's hierarchical route and the tiered row store of ``repro_torch``.

The tree (``kernels.fedavg_agg.fedavg_aggregate_tree``) against the
reference's tree run in interpret mode (within 1e-6, as an aggregation),
against flat FedAvg (bit for bit when ``fanout >= N``, 1e-6 for a real two
tiers) and through both engines against the reference (params 1e-5,
losses 1e-4, bytes exact).  The tiered store: new error-feedback rows are
device zeros and spilled rows come back bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.kernels.fedavg_agg import (  # noqa: E402
    fedavg_aggregate_tree as ref_tree,
)
from repro_torch.core.batched import BatchedExecutor  # noqa: E402
from repro_torch.core.tiered_store import TieredRowStore  # noqa: E402
from repro_torch.kernels import fedavg_agg  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from test_torch_sequential import (  # noqa: E402
    LINEAR, _both, _init_params, _merge, _run_port,
)

repro_torch.set_device("cpu")


def _rows(n, d, seed=0):
    rs = np.random.RandomState(seed)
    u = (rs.standard_normal((n, d)) * rs.uniform(1e-3, 0.1, (n, 1))
         ).astype(np.float32)
    w = rs.uniform(0.1, 1.0, n).astype(np.float32)
    return u, (w / w.sum()).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,fanout", [(16, 0), (10, 3), (33, 5)])
def test_tree_matches_reference_tree(n, fanout, use_kernel):
    u, w = _rows(n, 1037, seed=n + fanout)
    ref = np.asarray(ref_tree(jnp.asarray(u), jnp.asarray(w), fanout=fanout,
                              interpret=True, use_kernel=use_kernel))
    port = fedavg_agg.fedavg_aggregate_tree(
        torch.from_numpy(u), torch.from_numpy(w), fanout=fanout,
        use_kernel=use_kernel)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
    if use_kernel:             # the plain version is the kernel tree
        plain = fedavg_agg.fedavg_tree_plain(
            torch.from_numpy(u), torch.from_numpy(w), fanout=fanout)
        assert torch.equal(_bits(plain), _bits(port))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_tree_with_fanout_past_the_rows_is_flat_bit_for_bit(use_kernel):
    u, w = (torch.from_numpy(a) for a in _rows(16, 2000, seed=3))
    flat = (fedavg_agg.fedavg_aggregate(u, w) if use_kernel
            else torch.einsum("n,nd->d", w, u))
    for fanout in (16, 17, 64):
        tree = fedavg_agg.fedavg_aggregate_tree(u, w, fanout=fanout,
                                                use_kernel=use_kernel)
        assert torch.equal(_bits(tree), _bits(flat))
    # a real two-tier tree reassociates the sum: within 1e-6 of flat
    two = fedavg_agg.fedavg_aggregate_tree(u, w, fanout=0,
                                           use_kernel=use_kernel)
    assert not torch.equal(_bits(two), _bits(flat)) or use_kernel
    np.testing.assert_allclose(two.numpy(), flat.numpy(), rtol=0, atol=1e-6)


def test_grouped_plain_sums_each_group_in_row_order():
    u, w = (torch.from_numpy(a) for a in _rows(12, 300, seed=9))
    out = fedavg_agg.fedavg_aggregate_grouped(u, w, 4)     # CPU: plain
    assert out.shape == (4, 300)
    for g in range(4):
        assert torch.equal(_bits(out[g]), _bits(fedavg_agg.fedavg_plain(
            u[3 * g:3 * g + 3], w[3 * g:3 * g + 3])))


def _tier_shapes(monkeypatch):
    """Record every tier the tree reduces: (groups, rows a group) of an
    einsum tier; (groups, rows) of a kernel tier, whose groups end at the
    tier's last real row (the last tier is one combining launch)."""
    seen = []
    tier, combine, einsum_tier = (fedavg_agg._tier, fedavg_agg._combine,
                                  fedavg_agg._einsum_tier)

    def rec_tier(segs, group):
        (u, _), = segs
        seen.append((-(-u.shape[0] // group), u.shape[0]))
        return tier(segs, group)

    def rec_combine(segs, init, tree=False):
        if tree:
            (u, _), = segs
            seen.append((1, u.shape[0]))
        return combine(segs, init, tree)

    def rec_einsum(u, w, g):
        seen.append((g, u.shape[0] // g))
        return einsum_tier(u, w, g)
    monkeypatch.setattr(fedavg_agg, "_tier", rec_tier)
    monkeypatch.setattr(fedavg_agg, "_combine", rec_combine)
    monkeypatch.setattr(fedavg_agg, "_einsum_tier", rec_einsum)
    return seen


@pytest.mark.parametrize("execution", ["batched", "sequential"])
@pytest.mark.parametrize("kernel", [False, True])
def test_two_tier_tree_through_both_engines_matches_reference(
        execution, kernel, monkeypatch):
    """10 clients a round: the batched engine's 16 bucketed rows with
    fanout 0 (4) make 4 groups of 4 with einsum tiers, then one group of
    the partials; the kernel's groups are 8 rows (2 groups), then one of
    the 2 partials.  The sequential engine's 10 rows (fanout ceil(sqrt(10))
    = 4) pad to 16 for the einsum tiers and group the same way; the
    kernel's tiers pad nothing: 2 groups of its 10 rows (8 and 2), then
    the 2 partials."""
    seen = _tier_shapes(monkeypatch)
    cfg = _merge(LINEAR, {
        "server": {"clients_per_round": 10, "rounds": 2},
        "client": {"compression": "stc"},
        "resources": {"execution": execution, "aggregation_kernel": kernel,
                      "aggregation_topology": "hierarchical"}})
    _both(cfg, rounds=2)
    rows = 16 if execution == "batched" else 10
    assert seen == ([(2, rows), (1, 2)] if kernel
                    else [(4, 4), (1, 4)]) * 2


# ---------------------------------------------------------------------------
# the tiered row store (M5.2: new EF rows on the device, pinned spill)
# ---------------------------------------------------------------------------


def test_new_rows_are_zeros_and_spilled_rows_return_bit_for_bit():
    store = TieredRowStore(3, spill="host", name="ef")
    shapes = [(5,), (70,)]
    rows = store.ensure(["a", "b"], zero_shapes=shapes)
    assert sorted(rows.tolist()) == [1, 2] and store.alloc == 3   # capacity
    for leaf, (s,) in zip(store.leaves, shapes):
        assert leaf.dtype == torch.float32 and leaf.shape[1] == s
        assert torch.equal(_bits(leaf), torch.zeros_like(_bits(leaf)))
    rs = np.random.RandomState(1)
    vals = {c: [torch.from_numpy(rs.standard_normal(s).astype(np.float32))
                for (s,) in shapes] for c in "abcde"}
    store.scatter(["a", "b"], [torch.stack([vals[c][i] for c in "ab"])
                               for i in range(2)])
    store.ensure(["c", "d"], zero_shapes=shapes)   # evicts a (LRU)
    assert list(store.spilled_ids()) == ["a"]
    assert "a" in store and len(store) == 4
    store.scatter(["c", "d"], [torch.stack([vals[c][i] for c in "cd"])
                               for i in range(2)])
    # a reloads bit for bit beside a brand-new e (zeros) and a resident b
    got = store.gather(["e", "a", "b"], zero_shapes=shapes)
    for i in range(2):
        assert torch.equal(_bits(got[i][0]), torch.zeros_like(_bits(got[i][0])))
        assert torch.equal(_bits(got[i][1]), _bits(vals["a"][i]))
        assert torch.equal(_bits(got[i][2]), _bits(vals["b"][i]))
    assert store.stats["spills"] == 3 and store.stats["reloads"] == 1   # c, d out
    store.drop("a")
    assert "a" not in store and len(store) == 4      # e, b hot; c, d spilled
    with pytest.raises(ValueError, match="make_row or zero_shapes"):
        TieredRowStore(2, name="x").ensure(["a"])


def test_data_pool_rows_still_come_from_make_row():
    store = TieredRowStore(2, spill="drop", name="pool")
    x = {c: np.full((3, 2), i, np.int32) for i, c in enumerate("abc")}
    (got,) = store.gather(["b", "a"], lambda c: [x[c]])
    assert got.dtype == torch.int32 and got[:, 0, 0].tolist() == [1, 0]
    (got,) = store.gather(["c", "a"], lambda c: [x[c]])   # drops b
    assert got[:, 0, 0].tolist() == [2, 0] and "b" not in store
    assert store.stats["recomputes"] == 3


@pytest.mark.parametrize("fusion", ["auto", "off"])
def test_bounded_ef_store_runs_bit_for_bit_as_unbounded(fusion, monkeypatch):
    cfg = _merge(LINEAR, {"client": {"compression": "stc"},
                          "resources": {"execution": "batched",
                                        "round_fusion": fusion}})
    p0 = _init_params(cfg)
    free = _run_port(cfg, p0)[1]
    monkeypatch.setattr(BatchedExecutor, "EF_MAX_CLIENTS", 2)
    trainer, bounded = _run_port(cfg, p0)
    assert trainer.engine._ef.stats["reloads"] > 0
    for a, b in zip(tree_leaves(free["params"]),
                    tree_leaves(bounded["params"])):
        assert torch.equal(_bits(a), _bits(b))


def test_invalidate_data_drops_pooled_rows():
    cfg = _merge(LINEAR, {"server": {"rounds": 1},
                          "resources": {"execution": "batched"}})
    trainer, _ = _run_port(cfg, _init_params(cfg))
    engine = trainer.engine
    cid = next(iter(engine._pool.rows))
    engine.invalidate_data(cid)
    assert cid not in engine._pool
    engine.invalidate_data()
    assert engine._pool is None
