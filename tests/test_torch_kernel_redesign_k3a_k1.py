"""K3a (the int8 row max with its scale in the same launch) and K1's
masked and per-card routes, on the CPU.

* K3a's plain mirror — :func:`quant.rowmax_scale` on a CPU tensor, and
  the round trip built on it — against the reference's Pallas round trip
  in interpret mode, bit for bit on (sent, scale) (any NaN equal to any
  NaN), over ragged widths (D % 4 = 0..3) and edge rows: a NaN, +-inf, all
  zeros (scale 1e-12 * f32(1/127)), subnormals only.
* The kernel's access plan: each row's 16-byte vectors start at its
  first aligned element (:func:`quant.row_plan`), the CTAs of a row take
  whole batches (:func:`quant.rowmax_split`), and head, vectors and tail
  cover every element once; the CUDA source's constants match the
  wrapper's.
* K1: the masked tree and the per-card sharded route equal the padded
  forms the port ran before (their code kept here) bit for bit, and one
  launch a run of shards on one device.

The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import build, fedavg_agg, quant  # noqa: E402
from repro_torch.kernels.mesh import ClientMesh  # noqa: E402

repro_torch.set_device("cpu")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (its tensors are small; under
    the parallel test run torch's pool only oversubscribes the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return np.asarray(t).view(np.int32)


def _same_bits(a, b):
    """Bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return (nan == np.isnan(b)).all() and (
        _bits(a[~nan]) == _bits(b[~nan])).all()


# ---------------------------------------------------------------------------
# K3a: the row max and its scale
# ---------------------------------------------------------------------------


def _edge_rows(d, seed):
    """Update-like rows, then a NaN row, a +-inf row, an all-zero row,
    a subnormal-only row and a row of one tiny value (below 1e-12)."""
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((8, d))
         * rs.uniform(1e-3, 2.0, (8, 1))).astype(np.float32)
    x[3, rs.randint(d)] = np.nan
    x[4, rs.randint(d)] = np.inf
    x[4, rs.randint(d)] = -np.inf
    x[5] = 0.0
    x[5, ::3] = -0.0
    x[6] = (rs.randint(1, 2 ** 23, d) * 2.0 ** -149
            * np.where(rs.rand(d) < 0.5, -1.0, 1.0)).astype(np.float32)
    x[7] = 0.0
    x[7, rs.randint(d)] = 3e-13
    return x


@pytest.mark.parametrize("d", [1, 2, 3, 4, 63, 1001, 8194, 20003])
def test_rowmax_scale_mirror_matches_the_reference_round_trip(d):
    x = _edge_rows(d, seed=d)
    ref_sent, ref_scale = ref_ops.int8_roundtrip_batched(jnp.asarray(x),
                                                         interpret=True)
    t = torch.from_numpy(x)
    m, scale = quant.rowmax_scale(t)
    sent, sent_scale = quant.int8_roundtrip_batched(t)
    assert _same_bits(scale.numpy(), np.asarray(ref_scale))
    assert _same_bits(sent_scale.numpy(), np.asarray(ref_scale))
    assert _same_bits(sent.numpy(), np.asarray(ref_sent))
    # m is the row max and the scale its int8_scale, as the kernel
    # publishes both
    assert _same_bits(m.numpy(), np.abs(x).max(axis=1))
    assert _same_bits(quant.rowmax(t).numpy(), m.numpy())
    assert _same_bits(scale.numpy(), quant.int8_scale(m).numpy())
    assert np.isnan(scale[3].item()) and np.isinf(scale[4].item())
    floor = np.float32(1e-12) * np.float32(1.0 / 127.0)
    assert _bits(scale[5].numpy()) == _bits(floor)
    assert _bits(scale[7].numpy()) == _bits(floor)


def test_scale_floor_and_inverse_are_the_references_f32_constants():
    """The kernel takes f32(1/127) from the wrapper (``_INV127``, built as
    the reference builds it) and writes 1e-12 as the f32 literal the
    reference's ``jnp.maximum(m, 1e-12)`` rounds to."""
    assert quant._INV127 == np.float32(1.0 / 127.0)
    assert np.float32(quant._INV127_ARG.value) == quant._INV127
    assert float(np.float32(1e-12)) == float(torch.tensor(
        1e-12, dtype=torch.float32))
    src = (CSRC / "quant.cu").read_text()
    assert "mf >= 1e-12f || mf != mf" in src
    assert "__fmul_rn(" in src


def _cu_const(name, source):
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / source).read_text())
    return m.group(1)


def test_k3a_and_k1_constants_match_the_cuda_sources():
    assert int(_cu_const("RM_CTAS_PER_SM", "quant.cu")) == \
        quant.RM_CTAS_PER_SM
    threads = int(_cu_const("RM_THREADS", "quant.cu"))
    unroll = int(_cu_const("RM_UNROLL", "quant.cu").split()[0])
    assert threads * unroll == quant.RM_BATCH
    assert int(_cu_const("RM_SLOTS", "quant.cu").split()[0]) == \
        quant.RM_SLOTS
    assert int(_cu_const("RM_SPLIT_ROWS", "quant.cu").split()[0]) == \
        quant.RM_SPLIT_ROWS
    assert int(_cu_const("MAX_SEGS", "fedavg_agg.cu")) == fedavg_agg.MAX_SEGS


@pytest.mark.parametrize("head0", [0, 1, 2, 3])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 9, 63, 64, 1001,
                               6603710])
def test_row_plan_starts_each_rows_vectors_at_its_first_aligned_element(
        head0, d):
    """x's element 0 lies ``head0`` elements before a 16-byte boundary
    (data at 16 * k + 4 * (4 - head0) % 16 bytes); row r's vectors
    [lead, tail) start aligned, cover whole 4-element vectors, and leave
    at most 3 + 3 scalars."""
    ptr = 4096 + 4 * ((4 - head0) % 4)
    assert quant.vector_head(ptr, 4) == head0
    for row in range(8):
        lead, nvec, tail = quant.row_plan(d, head0, row)
        assert 0 <= lead <= min(3, d) and tail == lead + 4 * nvec <= d
        assert d - tail < 4 and nvec == (d - lead) // 4
        if lead < d:            # the row reaches its first aligned element
            assert (ptr + 4 * (row * d + lead)) % 16 == 0


@pytest.mark.parametrize("n,d,sms,want", [
    (16, 6422528, 132, 33),        # the fused round's fc1/w leaf
    (1, 6422528, 132, 392),        # the sequential stage's (1, n) row
    (1, 620756992, 132, 527),      # glm4-9b's embedding as one row
    (16, 51200, 132, 7),           # conv2/w
    (16, 800, 132, 1),             # conv1/w: one batch a row
    (1500, 4096, 132, 1),          # more rows than split counters
    (3, 8193, 2, 1),
])
def test_rowmax_split_keeps_the_launch_resident_and_even(n, d, sms, want):
    c = quant.rowmax_split(n, d, sms)
    assert c == want
    batches = max(1, -(-(d // 4) // quant.RM_BATCH))
    assert 1 <= c <= batches
    assert n * c <= max(n, sms * quant.RM_CTAS_PER_SM)
    assert c == 1 or n <= quant.RM_SPLIT_ROWS
    # no CTA takes more batches than the fewest CTAs that fit could
    cap = max(1, sms * quant.RM_CTAS_PER_SM // n)
    assert -(-batches // c) == -(-batches // min(cap, batches))


@pytest.mark.parametrize("n,d,head0,sms", [
    (3, 20002, 2, 2), (2, 41001, 1, 2), (4, 16387, 3, 4), (1, 8192 * 5, 0,
                                                           1)])
def test_k3a_access_plan_covers_every_element_once(n, d, head0, sms):
    """The kernel's accesses emulated: CTA c of a row takes batches c,
    c + C, ... of its vectors, CTA 0 its head and tail scalars; every
    element is read once and the partials' max over the |x| bit patterns
    (NaN above inf) is the row max."""
    c = quant.rowmax_split(n, d, sms)
    assert c > 1
    x = _bits(_edge_rows(d, seed=n)[:n]) & 0x7fffffff
    for row in range(n):
        lead, nvec, tail = quant.row_plan(d, head0, row)
        seen = np.zeros(d, dtype=np.int64)
        partials = []
        for cta in range(c):
            mx = 0
            for b in range(cta * quant.RM_BATCH, nvec, c * quant.RM_BATCH):
                j = np.arange(b, min(b + quant.RM_BATCH, nvec))
                idx = (lead + 4 * j[:, None] + np.arange(4)).ravel()
                seen[idx] += 1
                mx = max(mx, x[row, idx].max())
            if cta == 0:
                idx = np.r_[np.arange(lead), np.arange(tail, d)].astype(int)
                seen[idx] += 1
                if idx.size:
                    mx = max(mx, x[row, idx].max())
            partials.append(mx)
        assert (seen == 1).all()
        m = np.int32(max(partials)).view(np.float32)
        assert _same_bits(m, np.abs(_edge_rows(d, seed=n)[row]).max())


def test_stream_slots_are_distinct_per_stream_and_bounded(monkeypatch):
    current = {"s": 11}
    monkeypatch.setattr(build, "stream", lambda device: current["s"])
    monkeypatch.setattr(build, "_SLOTS", {})
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    assert build.stream_slot(a, 3) == 0
    current["s"] = 12
    assert build.stream_slot(a, 3) == 1
    assert build.stream_slot(b, 3) == 0            # per device
    current["s"] = 11
    assert build.stream_slot(a, 3) == 0            # the same stream again
    current["s"] = 13
    assert build.stream_slot(a, 3) == 2
    current["s"] = 14
    with pytest.raises(RuntimeError, match="more than 3 streams"):
        build.stream_slot(a, 3)


# ---------------------------------------------------------------------------
# K1: masked tiers and one launch a card
# ---------------------------------------------------------------------------


def _padded_tree(updates, weights, fanout):
    """The kernel tree as the port ran it before this change: the rows
    padded to the plan's bucket, every tier padded to whole groups with
    zero rows of weight 0, each group through ``fedavg_plain``."""
    u, w = updates.to(torch.float32), weights.to(torch.float32)
    plan = fedavg_agg._tree_plan(u.shape[0], int(fanout), True)
    if plan is None:
        return fedavg_agg.fedavg_plain(u, w)
    group, tiers = plan
    n = u.shape[0]
    nb = fedavg_agg.bucket_clients(n, fedavg_agg.TILE_N)
    u, w = F.pad(u, (0, 0, 0, nb - n)), F.pad(w, (0, nb - n))
    for g, pad in tiers:
        if pad:
            u, w = F.pad(u, (0, 0, 0, pad)), F.pad(w, (0, pad))
        u = fedavg_agg.fedavg_grouped_plain(u, w, g)
        w = torch.ones((g,), dtype=torch.float32)
    return u[0]


def _padded_sharded(updates, weights, k, fanout):
    """The sharded route as the port ran it before: each block's partial
    (flat, or its padded tree), then k - 1 adds in shard order."""
    out, lo = None, 0
    for u in updates.tensor_split(k):
        r = u.shape[0]
        w = weights[lo:lo + r]
        lo += r
        if not r:
            continue
        part = (_padded_tree(u, w, fanout) if fanout > 0
                else fedavg_agg.fedavg_plain(u, w))
        out = part if out is None else out + part
    return out


def _agg_rows(n, d, seed):
    rs = np.random.RandomState(seed)
    u = (rs.standard_normal((n, d))
         * rs.uniform(1e-3, 2.0, (n, 1))).astype(np.float32)
    u[n // 2, ::7] = -0.0
    if n > 4:
        u[1, 3] = np.inf
        u[2, 5] = np.nan
    w = rs.uniform(0.0, 1.0, n).astype(np.float32)
    w[0] = 0.0
    return torch.from_numpy(u), torch.from_numpy(w / w.sum())


@pytest.mark.parametrize("n,fanout", [(16, 0), (16, 2), (10, 0), (10, 3),
                                      (33, 5), (9, 2), (64, 3), (100, 9),
                                      (5, 2)])
def test_masked_tree_equals_the_padded_tree_bitwise(n, fanout):
    u, w = _agg_rows(n, 129, seed=n + fanout)
    want = _padded_tree(u, w, fanout)
    for got in (fedavg_agg.fedavg_aggregate_tree(u, w, fanout=fanout),
                fedavg_agg.fedavg_tree_plain(u, w, fanout=fanout)):
        assert _same_bits(got.numpy(), want.numpy())


@pytest.mark.parametrize("fanout", [0, 2, 3])
@pytest.mark.parametrize("n,k", [(16, 2), (16, 4), (37, 4), (20, 8),
                                 (3, 4)])
def test_sharded_route_equals_one_launch_a_shard_bitwise(n, k, fanout):
    u, w = _agg_rows(n, 77, seed=n * k + fanout)
    want = _padded_sharded(u, w, k, fanout)
    mesh = ClientMesh(tuple([torch.device("cpu")] * k))
    for got in (fedavg_agg.fedavg_aggregate_sharded(u, w, mesh,
                                                    fanout=fanout),
                fedavg_agg.fedavg_aggregate_sharded(
                    list(u.tensor_split(k)), w, mesh, fanout=fanout),
                fedavg_agg.fedavg_sharded_plain(u, w, k, fanout)):
        assert _same_bits(got.numpy(), want.numpy())


@pytest.mark.parametrize("layout", ["aabb", "abab", "aaab", "abbb"])
@pytest.mark.parametrize("fanout", [0, 2])
def test_shards_on_mixed_devices_keep_the_shard_order(layout, fanout):
    """Runs of shards on one device (two CPU devices stand in for cards:
    ``cpu`` and ``cpu:0`` compare unequal) add in shard order: a later run
    of several shards carries the running sum in, one of a single shard
    adds its partial on the first device."""
    devs = {"a": torch.device("cpu"), "b": torch.device("cpu", 0)}
    mesh = ClientMesh(tuple(devs[c] for c in layout))
    u, w = _agg_rows(24, 65, seed=len(layout) + fanout)
    got = fedavg_agg.fedavg_aggregate_sharded(u, w, mesh, fanout=fanout)
    assert _same_bits(got.numpy(), _padded_sharded(u, w, 4,
                                                   fanout).numpy())


def test_shard_runs_make_one_launch_a_card(monkeypatch):
    """k shards of one device: one run, one combining call (the kernel's
    one launch on a card); k distinct devices: k runs."""
    for k in (2, 4, 8):
        cards = [torch.device("cuda", i) for i in range(k)]
        assert fedavg_agg.shard_runs(cards) == [(c, [i])
                                                for i, c in enumerate(cards)]
        one = [torch.device("cuda", 0)] * k
        assert fedavg_agg.shard_runs(one) == [(one[0], list(range(k)))]
    assert fedavg_agg.shard_runs([torch.device("cuda", 0)] * 2 + [
        torch.device("cuda", 1)] * 2) == [
        (torch.device("cuda", 0), [0, 1]), (torch.device("cuda", 1), [2, 3])]
    calls = []
    tier, combine = fedavg_agg._tier, fedavg_agg._combine
    monkeypatch.setattr(fedavg_agg, "_tier", lambda segs, g: calls.append(
        ("tier", len(segs))) or tier(segs, g))
    monkeypatch.setattr(fedavg_agg, "_combine",
                        lambda segs, init, tree=False: calls.append(
                            ("combine", len(segs))) or combine(segs, init,
                                                               tree))
    u, w = _agg_rows(16, 33, seed=5)
    for k in (2, 4):
        mesh = ClientMesh(tuple([torch.device("cpu")] * k))
        for fanout in (0, 2):
            calls.clear()
            fedavg_agg.fedavg_aggregate_sharded(u, w, mesh, fanout=fanout)
            assert calls == [("combine", k)]
    # a deeper tree a shard: one tier launch a level over all shards
    calls.clear()
    u, w = _agg_rows(64, 33, seed=6)
    mesh = ClientMesh(tuple([torch.device("cpu")] * 2))
    fedavg_agg.fedavg_aggregate_sharded(u, w, mesh, fanout=2)
    assert calls == [("tier", 2), ("combine", 2)]
