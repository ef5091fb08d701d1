"""Card-only checks of the port: each CUDA kernel against its plain
PyTorch version at the main path's shapes, and the fused round on the card
against the same round on the CPU.  Run on a CUDA machine with
``pytest -m cuda tests/test_torch_cuda.py``; every test skips without a
card.  Imports no jax, so it runs where only PyTorch is installed."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.config import Config  # noqa: E402
from repro_torch.core.rounds import Trainer  # noqa: E402
from repro_torch.data.fed_data import build_federated_data  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    attention, fedavg_agg, ops, quant, rwkv6_scan, stc_topk,
)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    repro_torch.set_device(None)


def _updates(n, d, device):
    rs = np.random.RandomState(n + d)
    x = (rs.standard_normal((n, d))
         * rs.uniform(1e-3, 2.0, (n, 1))).astype(np.float32)
    if n > 9:
        x[-1] = 0.0                # an all-zero (padded) client row
    return torch.from_numpy(x).to(device)


def _stc_matches_plain(out, plain):
    """STC masks and signs bit for bit, values within 1 ulp."""
    assert torch.equal(out != 0, plain != 0)
    assert torch.equal(torch.sign(out), torch.sign(plain))
    a, b = out.cpu().numpy(), plain.cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a.astype(np.float64) - b) <= ulp).all()


# (16, 6603710): the whole femnist_cnn update matrix (D % 4 != 0); then
# its fc1/w leaf (D % 4 == 0, the float4 FedAvg path) and ragged widths;
# then STC's adversarial rows (``stc_topk.adversarial_rows``: ties at the
# threshold, one non-zero, denormals, one magnitude, all zeros, an outlier,
# small integers), whose rows end in a one-element segment (8193) or start
# misaligned (20001), through K2 alone
@pytest.mark.parametrize("n,d", [(16, 6603710), (16, 6422528),
                                 (16, 51200), (7, 20001), (1, 63),
                                 ("adversarial", 8193),
                                 ("adversarial", 20001)])
def test_cuda_kernels_match_plain_versions(cuda_device, n, d):
    if n == "adversarial":
        x = stc_topk.adversarial_rows(d).to(cuda_device)
        ko, kn = stc_topk.stc_compress_batched(x, 0.01)
        po, pn = stc_topk.stc_plain(x, 0.01)
        assert torch.equal(kn, pn)
        _stc_matches_plain(ko, po)
        return
    x = _updates(n, d, cuda_device)
    w = torch.rand((n,), device=cuda_device)
    w /= w.sum()
    k, p = fedavg_agg.fedavg_aggregate(x, w), fedavg_agg.fedavg_plain(x, w)
    assert ((k - p).abs().max() <= 1e-6 * p.abs().max()).item()
    ko, kn = stc_topk.stc_compress_batched(x, 0.01)
    po, pn = stc_topk.stc_plain(x, 0.01)
    assert torch.equal(ko != 0, po != 0) and torch.equal(kn, pn)
    a, b = ko.cpu().numpy(), po.cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a.astype(np.float64) - b) <= ulp).all()
    s = quant.int8_scale(quant.rowmax_plain(x))
    assert torch.equal(quant.rowmax(x), quant.rowmax_plain(x))
    assert torch.equal(quant.qdq(x, s).view(torch.int32),
                       quant.qdq_plain(x, s).view(torch.int32))
    (k, kq), (p, pq) = quant.qdq(x, s, True), quant.qdq_plain(x, s, True)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    assert kq.dtype == torch.int8 and torch.equal(kq, pq)


def test_wrappers_count_only_kernel_launches(cuda_device):
    x = _updates(4, 1000, cuda_device)
    ops.reset_launch_counts()
    ops.fedavg_aggregate(x, torch.full((4,), 0.25, device=cuda_device))
    ops.fedavg_aggregate_tree(x, torch.full((4,), 0.25, device=cuda_device),
                              fanout=2)    # 4 rows, groups of 8: one tier
    ops.stc_compress_batched(x, 0.01)
    ops.int8_roundtrip_batched(x)
    ops.fedavg_aggregate(x.cpu(), torch.full((4,), 0.25))   # plain: no count
    q = x[:, :64].reshape(1, 4, 1, 64).contiguous().requires_grad_()
    ops.flash_attention(q, q, q).sum().backward()
    ops.stc_compress(x, 0.01)
    ops.dequantize(*ops.quantize(x), x.shape)
    r = x[:, :64].reshape(1, 64, 1, 4).contiguous()
    ops.wkv6(r, r, r, -r.abs(), x[0, :4].reshape(1, 4),
             torch.zeros((1, 1, 4, 4), device=cuda_device))
    assert ops.launch_counts() == {"fedavg_agg": 1, "fedavg_agg_tree": 1,
                                   "stc_batched": 1,
                                   "int8_rowmax": 1, "int8_qdq": 1,
                                   "flash_fwd": 1, "flash_dq": 1,
                                   "flash_dkv": 1, "stc_dense": 1,
                                   "int8_quantize": 1, "int8_dequantize": 1,
                                   "wkv6": 1}
    with pytest.raises(ValueError, match="contiguous"):
        ops.stc_compress_batched(x.t(), 0.01)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        ops.quantize(x.double())


@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_fused_round_on_card_matches_cpu(cuda_device, compression):
    cfg = Config.make({
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 10, "batch_size": 32},
        "server": {"rounds": 3, "clients_per_round": 5},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": compression},
        "resources": {"execution": "batched", "aggregation_kernel": True}})
    p0 = convert.params_to_numpy(
        get_model("linear").init(torch.Generator().manual_seed(0)))
    out = {}
    for device in ("cuda", "cpu"):
        repro_torch.set_device(device)
        trainer = Trainer(cfg, get_model("linear"),
                          build_federated_data(cfg.data))
        trainer.server.params = convert.params_from_jax(p0)
        out[device] = trainer.run()
    for a, b in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert [h["comm_up_bytes"] for h in out["cuda"]["history"]] == \
        [h["comm_up_bytes"] for h in out["cpu"]["history"]]


# K1's grouped route: the hierarchical tree's first tier at the femnist
# matrix (2 groups of 8), a ragged width in groups of 3 and 8 groups of 2,
# and the whole tree (two tiers), bit for bit against the plain versions
@pytest.mark.parametrize("n,d,groups", [(16, 6603710, 2), (12, 1000003, 4),
                                        (16, 51200, 8), (16, 6603710, 0)])
def test_grouped_fedavg_kernel_matches_plain_version(cuda_device, n, d,
                                                     groups):
    x = _updates(n, d, cuda_device)
    w = torch.rand((n,), device=cuda_device)
    w /= w.sum()
    if groups:
        k = fedavg_agg.fedavg_aggregate_grouped(x, w, groups)
        p = fedavg_agg.fedavg_grouped_plain(x, w, groups)
    else:
        k = fedavg_agg.fedavg_aggregate_tree(x, w, fanout=0)
        p = fedavg_agg.fedavg_tree_plain(x, w, fanout=0)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


# K3a: the fused round's leaves (16 rows, each split over CTAs that
# publish through the row counters), the sequential stage's (1, n) row,
# ragged and tiny widths, and views whose rows start off a 16-byte
# boundary; each with the edge rows (NaN, +-inf, -0.0, subnormals, below
# 1e-12), eagerly and in three replays of a captured launch
@pytest.mark.parametrize("n,d,offset", [
    (16, 6422528, 0), (16, 51200, 0), (16, 800, 0), (1, 6422528, 0),
    (7, 20001, 0), (3, 8193, 0), (1, 63, 0), (1, 2, 0), (6, 20002, 1),
    (5, 4099, 3), (16, 126976, 2)])
def test_k3a_max_and_scale_match_plain_eagerly_and_in_replays(
        cuda_device, n, d, offset):
    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(n * d + offset)
    x = smoke.rowmax_rows(gen, n, d + offset).reshape(-1)[
        offset:offset + n * d].view(n, d)
    smoke.check_rowmax(quant, x, f"({n}, {d}) at element {offset}")


def test_int8_round_trip_is_two_device_launches(cuda_device):
    """K3a writes the max and the scale, K3b the round trip: no memset and
    no elementwise scale launch between them."""
    from torch.profiler import ProfilerActivity, profile

    x = _updates(16, 51200, cuda_device)
    quant.int8_roundtrip_batched(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        quant.int8_roundtrip_batched(x)
        torch.cuda.synchronize()
    names = sorted(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(names) == 2, names
    assert any("rowmax_kernel" in n for n in names), names
    assert any("qdq_kernel" in n for n in names), names


# K1's routes of several blocks or tiers (the tree, the sharded route on
# 2 and 4 shards of the card) at the femnist update matrix and a ragged
# width: bit for bit their plain versions, eagerly and in graph replays,
# with no padded (rows, D) copy
@pytest.mark.parametrize("n,d", [(16, 6603710), (10, 1000003)])
def test_k1_routes_match_plain_and_pad_nothing(cuda_device, n, d):
    x = _updates(n, d, cuda_device)
    w = torch.rand((n,), device=cuda_device)
    w /= w.sum()
    _chip_smoke().check_k1_routes(fedavg_agg, x, w, f"({n}, {d})")
    ops.reset_launch_counts()
    from repro_torch.core.batched import build_client_mesh
    for k in (2, 4):
        for fanout in (0, 2):
            fedavg_agg.fedavg_aggregate_sharded(
                x, w, build_client_mesh([cuda_device] * k), fanout=fanout)
    counts = ops.launch_counts()
    # one launch a call: flat at fanout 0, the one tier of each shard's
    # tree at fanout 2
    assert (counts["fedavg_agg"], counts["fedavg_agg_tree"]) == (2, 2)


@pytest.mark.parametrize("extra", [
    {"resources": {"round_fusion": "off"}, "client": {"compression": "stc"}},
    {"resources": {"round_fusion": "off"}, "client": {"compression": "int8"}},
    {"resources": {"aggregation_topology": "hierarchical"},
     "client": {"compression": "stc"}},
    {"tracking": {"round_sync": False}, "client": {"compression": "int8"}},
], ids=["staged-stc", "staged-int8", "hierarchical-stc", "deferred-int8"])
def test_batched_paths_on_card_match_cpu(cuda_device, extra):
    base = {"model": "linear",
            "data": {"dataset": "synthetic", "num_clients": 10,
                     "batch_size": 32},
            "server": {"rounds": 3, "clients_per_round": 5},
            "client": {"local_epochs": 2, "lr": 0.1},
            "resources": {"execution": "batched",
                          "aggregation_kernel": True}}
    for key, val in extra.items():
        base[key] = dict(base.get(key, {}), **val)
    cfg = Config.make(base)
    p0 = convert.params_to_numpy(
        get_model("linear").init(torch.Generator().manual_seed(0)))
    out = {}
    for device in ("cuda", "cpu"):
        repro_torch.set_device(device)
        trainer = Trainer(cfg, get_model("linear"),
                          build_federated_data(cfg.data))
        trainer.server.params = convert.params_from_jax(p0)
        out[device] = trainer.run()
    for a, b in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert [h["comm_up_bytes"] for h in out["cuda"]["history"]] == \
        [h["comm_up_bytes"] for h in out["cpu"]["history"]]


@pytest.mark.parametrize("execution,resources,compression", [
    ("batched", {}, "stc"),
    ("batched", {"round_fusion": "off"}, "int8"),
    ("batched", {"aggregation_topology": "hierarchical"}, "stc"),
    ("sequential", {}, "none"),
], ids=["fused-stc", "staged-int8", "hierarchical-stc", "sequential-none"])
def test_faulty_rounds_on_card_match_cpu(cuda_device, execution, resources,
                                         compression):
    """Dropout, crash, stragglers and NaN uploads (the fused round's mask
    and guard): the card gives the CPU's fault accounting every round, its
    params within 1e-5 and its wire bytes exactly."""
    cfg = Config.make({
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 8, "batch_size": 32},
        "server": {"rounds": 3, "clients_per_round": 5},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": compression},
        "resources": {"execution": execution, "aggregation_kernel": True,
                      **resources},
        "faults": {"dropout_prob": 0.2, "crash_prob": 0.2,
                   "straggler_prob": 0.3, "nan_update_prob": 0.2,
                   "max_update_norm": 100.0, "seed": 8}})
    p0 = convert.params_to_numpy(
        get_model("linear").init(torch.Generator().manual_seed(0)))
    out = {}
    for device in ("cuda", "cpu"):
        repro_torch.set_device(device)
        trainer = Trainer(cfg, get_model("linear"),
                          build_federated_data(cfg.data))
        trainer.server.params = convert.params_from_jax(p0)
        out[device] = trainer.run()
    keys = ("dropped", "crashed", "straggled", "rejected", "deadline_missed",
            "reselections", "survivors", "clients", "comm_up_bytes")
    assert [[h[k] for k in keys] for h in out["cuda"]["history"]] == \
        [[h[k] for k in keys] for h in out["cpu"]["history"]]
    assert sum(h["rejected"] for h in out["cpu"]["history"]) > 0
    for a, b in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_tiered_store_state_round_trips_bitwise_on_card(cuda_device):
    """An EF store on the card whose rows span both tiers (device capacity
    2 of 5 clients): ``state()`` through the checkpoint serializer and back
    into stores of other capacities, every row bit for bit."""
    from repro_torch.comm import serialize
    from repro_torch.core.tiered_store import TieredRowStore

    shapes = [(6603710,), (62,)]
    s = TieredRowStore(2, spill="host", device=cuda_device, name="ef")
    gen = torch.Generator().manual_seed(0)
    vals = {f"c{i}": [torch.randn(sh, generator=gen) for sh in shapes]
            for i in range(5)}
    for cid, rows in vals.items():
        s.ensure([cid], zero_shapes=shapes)
        s.scatter([cid], [r[None].to(cuda_device) for r in rows])
    assert len(s.spilled_ids()) == 3 and len(s.rows) == 2
    snap = serialize.loads(serialize.dumps(s.state()))
    for cap in (1, 8):
        t = TieredRowStore(cap, spill="host", device=cuda_device, name="ef")
        t.load_state(snap)
        for cid, rows in vals.items():
            got = t.gather([cid], zero_shapes=shapes)
            assert all(torch.equal(g[0].cpu().view(torch.int32),
                                   r.view(torch.int32))
                       for g, r in zip(got, rows))


# the edges of the 8-warp pair kernels' head-dim split above D 128: D 129
# and 136 (DP 192, a ragged second half), 130 (4-byte copies), 193 and 255
# (DP 256, a ragged half); S 1, 65 and 520; BH 1 and 133 (more CTAs than
# SMs); causal and not (chip_smoke.FLASH_PAIR_EDGES)
_PAIR_EDGES = [(bh, s, d, c) for d in (129, 130, 136, 193, 255)
               for bh, s in ((3, 1), (1, 65), (133, 65), (2, 520))
               for c in (True, False)]


# the LoRA path's shape (4 clients x 4 sequences x 32 heads, S 512, D 128),
# ragged sequence lengths and head dims, a head dim that is not a power of
# two, and the full head dim without the causal mask; the instances above
# D 128 (192: Nemotron-4, 256: PaliGemma) at ragged and full head dims
@pytest.mark.parametrize("bh,s,d,causal", [
    (512, 512, 128, True), (3, 1, 20, True), (3, 63, 64, False),
    (3, 200, 20, True), (3, 200, 64, False), (2, 130, 16, True),
    (3, 200, 72, True), (2, 130, 128, False), (3, 200, 160, True),
    (2, 130, 192, False), (3, 200, 200, True), (2, 130, 256, False),
    (96, 256, 192, True), (16, 512, 256, True)] + _PAIR_EDGES)
def test_flash_kernels_match_plain_versions(cuda_device, bh, s, d, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(s * d)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=cuda_device)
                   for _ in range(4))
    o, lse = attention.flash_fwd(q, k, v, causal)
    po, plse = attention.flash_fwd_plain(q, k, v, causal)
    assert (o - po).abs().max().item() <= 1e-5
    assert (lse - plse).abs().max().item() <= 1e-5
    delta = (do * o).sum(dim=-1)
    dq = attention.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = attention.flash_dkv(q, k, v, do, lse, delta, causal)
    want = (attention.flash_dq_plain(q, k, v, do, lse, delta, causal),
            *attention.flash_dkv_plain(q, k, v, do, lse, delta, causal))
    for got, exp in zip((dq, dk, dv), want):
        assert (got - exp).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [192, 256])
def test_flash_kernels_above_128_run_one_pair_cta_a_tile(cuda_device, d):
    """Above D 128 the forward, dQ and dK/dV each run one 8-warp CTA a
    64-row tile (grid z 1) without spills, and fit on an SM."""
    for name, r in attention.kernel_info(d).items():
        assert (r["threads"], r["grid_z"], r["spill_bytes"]) == (256, 1, 0), \
            (name, r)
        assert r["ctas_per_sm"] >= 1, (name, r)


@pytest.mark.parametrize("bh,s,d,causal", [(133, 65, 193, True),
                                           (2, 520, 136, False)])
def test_flash_dq_pair_kernel_is_deterministic(cuda_device, bh, s, d,
                                               causal):
    """dQ has one writer an element and no atomics: two launches on the
    same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=cuda_device)
                   for _ in range(4))
    o, lse = attention.flash_fwd(q, k, v, causal)
    delta = (do * o).sum(dim=-1)
    first = attention.flash_dq(q, k, v, do, lse, delta, causal)
    second = attention.flash_dq(q, k, v, do, lse, delta, causal)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_flash_lora_round_on_card_matches_cpu(cuda_device):
    from repro_torch.models import attention as mattn

    cfg = Config.make({
        "model": "tiny_lm",
        "data": {"dataset": "tiny_lm", "num_clients": 8, "batch_size": 32},
        "server": {"rounds": 2, "clients_per_round": 4},
        "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
                   "lora_rank": 4, "lora_alpha": 8.0,
                   "lora_targets": ("attn",)},
        "resources": {"execution": "batched"}})
    out = {}
    mattn.set_flash_attention(True)
    try:
        for device in ("cuda", "cpu"):
            repro_torch.set_device(device)
            ops.reset_launch_counts()
            out[device] = Trainer(cfg, get_model("tiny_lm"),
                                  build_federated_data(cfg.data)).run()
            launched = ops.launch_counts()
            assert all((launched[k] > 0) == (device == "cuda")
                       for k in ("flash_fwd", "flash_dq", "flash_dkv"))
    finally:
        mattn.set_flash_attention(None)
    for a, b in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _wkv_inputs(B, T, H, hd, device, seed):
    """Unit-normal r, k, v, the model's decay around w0 = -0.6, u at the
    model's init scale and a nonzero starting state."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    r, k, v = randn(B, T, H, hd), randn(B, T, H, hd), randn(B, T, H, hd)
    logw = -torch.exp(torch.clamp(randn(B, T, H, hd) - 0.6, -8.0, 6.0))
    return r, k, v, logw, 0.3 * randn(H, hd), randn(B, H, hd, hd)


# the rwkv6-1.6b prefill shape (16 x 512 tokens, 32 heads of 64), then
# other head dims and lengths
@pytest.mark.parametrize("B,T,H,hd", [(16, 512, 32, 64), (2, 192, 3, 16),
                                      (1, 64, 2, 32), (3, 128, 1, 64)])
def test_wkv6_kernel_matches_plain_version(cuda_device, B, T, H, hd):
    """Within 1e-4 of each output's scale (max(1, max |plain|)): f32
    summation-order differences grow with |y|, which reaches ~100 here."""
    args = _wkv_inputs(B, T, H, hd, cuda_device, seed=T + hd)
    y, s = rwkv6_scan.wkv6(*args)
    py, ps = rwkv6_scan.wkv6_plain(*args)
    for got, want in ((y, py), (s, ps)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("B,T,H,hd", [(4, 256, 4, 64), (2, 192, 3, 16)])
def test_wkv6_kernel_stays_finite_under_extreme_decay(cuda_device, B, T, H,
                                                      hd):
    """log w at the clip (-e^6), every third step -e^-8: finite, and within
    3e-2 of the plain version's scale (ROADMAP's WKV6 caveat: f32 cw
    loses the small steps' digits; both add it serially, so they round it
    alike)."""
    r, k, v, _, u, s0 = _wkv_inputs(B, T, H, hd, cuda_device, seed=T + 1)
    logw = torch.full_like(r, -float(np.exp(6.0)))
    logw[:, ::3] = -float(np.exp(-8.0))
    y, s = rwkv6_scan.wkv6(r, k, v, logw, u, s0)
    py, ps = rwkv6_scan.wkv6_plain(r, k, v, logw, u, s0)
    for got, want in ((y, py), (s, ps)):
        assert torch.isfinite(got).all()
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 3e-2 * scale


# the bench_compression.py size, a ragged size, a small ragged size; then
# STC's adversarial rows as one segment each and a last segment of one
# element, through K4 alone
@pytest.mark.parametrize("n", [2 ** 20, 1000003, 10007, "adversarial"])
def test_dense_stc_and_quant_kernels_match_plain_versions(cuda_device, n):
    if n == "adversarial":
        x = torch.cat([stc_topk.adversarial_rows(stc_topk.SEG).reshape(-1),
                       torch.tensor([5.0])]).to(cuda_device)
        out = stc_topk.stc_compress(x, 0.01)
        plain = stc_topk.stc_dense_plain(x, 0.01)
        assert torch.count_nonzero(out) == torch.count_nonzero(plain)
        _stc_matches_plain(out, plain)
        return
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((n,), generator=gen, device=cuda_device) * 0.37
    out, plain = stc_topk.stc_compress(x, 0.01), stc_topk.stc_dense_plain(x)
    assert torch.equal(out != 0, plain != 0)
    assert torch.equal(torch.sign(out), torch.sign(plain))
    a, b = out.cpu().numpy(), plain.cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a.astype(np.float64) - b) <= ulp).all()
    q, s = quant.quantize(x)
    pq, ps = quant.quantize_plain(x)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    back = quant.dequantize(q, s, x.shape)
    assert torch.equal(back.view(torch.int32),
                       quant.dequantize_plain(q, s, x.shape).view(torch.int32))


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its K5 check
    (``check_dense_quant``) is the one these tests and phase 3c share, its
    stage check (``check_sequential_stage``) the one of phase 4e."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


# the lengths around one vector and one tile, a ragged run of tiles, and
# ``quant.edge_tiles`` (zeros, subnormals, half-integer quotients, NaN, inf);
# each in f32, bf16 and f16, at the allocation's start and one element past
# it (a contiguous view whose data is not 16-byte aligned)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 8191, 8192, 8193,
                               3 * 8192 + 5, "edge"])
def test_dense_quant_kernels_hold_lengths_views_and_edge_tiles(
        cuda_device, n, dtype, offset):
    if n == "edge":
        x = quant.edge_tiles()
    else:
        x = torch.from_numpy(np.random.RandomState(n).standard_normal(n)
                             .astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    if offset:
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        buf[1:].copy_(x)
        x = buf[1:]
        assert x.is_contiguous() and x.data_ptr() % 16
    _chip_smoke().check_dense_quant(quant, x, f"({n}, {dtype}, {offset})")


def test_sequential_compression_stage_on_card_matches_cpu(cuda_device):
    """One client's round-0 femnist update through the sequential STC and
    int8 stages (K2; K3a + K3b with its int8 output) on the card and on the
    CPU, bit for bit: ``chip_smoke.check_sequential_stage``, phase 4e's
    check."""
    _chip_smoke().check_sequential_stage(repro_torch, cuda_device)


def test_staged_stages_on_card_match_cpu(cuda_device):
    """The staged path's compress_stacked (two rounds, STC and int8) and
    aggregate_stacked (flat and tree) on one stacked femnist cohort update,
    card against CPU bit for bit: ``chip_smoke.check_staged_stages``,
    phase 4f's check."""
    _chip_smoke().check_staged_stages(repro_torch, cuda_device)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "glm4-9b"])
def test_prefill_and_decode_on_card_match_cpu(cuda_device, arch):
    """Reduced configs: 12 decode steps, and for rwkv6 the no-grad forward
    (K8), on the card against the same on the CPU, from one init.  (GLM-4's
    70-token prefill at the repo's default init sits on near-tied attention
    scores: a 1e-7 relative perturbation of its embedding moves the logits
    by ~1e-4, as far as the card and the CPU differ.)"""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import (
        Model, make_prefill_step, make_serve_step,
    )

    model = Model(get_arch(arch, reduced=True))
    p_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    p_gpu = convert.params_from_jax(convert.params_to_numpy(p_cpu),
                                    cuda_device)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, model.cfg.vocab, (2, 70)))
    ops.reset_launch_counts()
    got = make_prefill_step(model)(p_gpu, {"tokens": toks.to(cuda_device)})
    assert ops.launch_counts()["wkv6"] == (
        model.cfg.n_layers if arch == "rwkv6-1.6b" else 0)
    if arch == "rwkv6-1.6b":
        want = make_prefill_step(model)(p_cpu, {"tokens": toks})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    step = make_serve_step(model)
    c_gpu = model.init_cache(2, 16, device=cuda_device)
    c_cpu = model.init_cache(2, 16, device="cpu")
    for t in range(12):
        lg, c_gpu = step(p_gpu, c_gpu, toks[:, t:t + 1].to(cuda_device), t)
        lc, c_cpu = step(p_cpu, c_cpu, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the fused round as a CUDA graph a bucket (core/batched.py::CapturedRound)
# ---------------------------------------------------------------------------

@pytest.fixture()
def deterministic(cuda_device):
    """cuDNN's deterministic algorithms, so that two runs of one round on
    the card agree bit for bit whatever stream they run on."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield cuda_device
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags


def _bits_equal(a, b):
    return all(torch.equal(x.cpu().view(torch.int32),
                           y.cpu().view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("extra", [
    {"client": {"compression": "none"}},
    {"client": {"compression": "stc"}},
    {"client": {"compression": "int8"}},
    {"resources": {"aggregation_topology": "hierarchical"},
     "client": {"compression": "stc"}},
    {"tracking": {"round_sync": False}, "client": {"compression": "int8"}},
    {"client": {"compression": "stc"},
     "faults": {"dropout_prob": 0.2, "crash_prob": 0.2,
                "nan_update_prob": 0.2, "max_update_norm": 100.0,
                "seed": 8}},
], ids=["none", "stc", "int8", "hierarchical-stc", "deferred-int8",
        "faulty-stc"])
def test_captured_rounds_equal_eager_rounds_bitwise(deterministic, extra):
    """Five rounds (an eager warm-up, a capture, replays) through the
    Trainer, captured and eager, bit for bit; one capture and one replay a
    round after the warm-up, launches counted through the replays."""
    from repro_torch.core import batched
    from repro_torch.core.batched import BatchedExecutor

    base = {"model": "linear",
            "data": {"dataset": "synthetic", "num_clients": 10,
                     "batch_size": 32},
            "server": {"rounds": 5, "clients_per_round": 5},
            "client": {"local_epochs": 2, "lr": 0.1},
            "resources": {"execution": "batched",
                          "aggregation_kernel": True}}
    for key, val in extra.items():
        base[key] = dict(base.get(key, {}), **val)
    cfg = Config.make(base)
    repro_torch.set_device(deterministic)
    p0 = get_model("linear").init(torch.Generator().manual_seed(0),
                                  deterministic)
    out = {}
    for capture in (True, False):
        trainer = Trainer(cfg, get_model("linear"),
                          build_federated_data(cfg.data))
        trainer.engine = BatchedExecutor(trainer.engine.model,
                                         trainer.device, capture=capture)
        trainer.server.params = p0
        ops.reset_launch_counts()
        n0 = (batched.round_capture_count(), batched.round_replay_count())
        res = trainer.run()
        out[capture] = (res, batched.round_capture_count() - n0[0],
                        batched.round_replay_count() - n0[1],
                        ops.launch_counts())
    (got, caps, reps, launches), (want, ecaps, ereps, elaunches) = \
        out[True], out[False]
    assert _bits_equal(got["params"], want["params"])
    assert [h["train_loss"] for h in got["history"]] == \
        [h["train_loss"] for h in want["history"]]
    # the EF store may grow once as new clients arrive: one more capture
    assert (ecaps, ereps) == (0, 0) and reps == 4 and caps in (1, 2)
    assert launches == elaunches and launches["fedavg_agg"] + \
        launches["fedavg_agg_tree"] > 0


def _card_clients(n, start=0, seed=0):
    from repro_torch.core.client import Client
    from repro_torch.core.config import ClientConfig
    from repro_torch.data.fed_data import ClientData

    rs = np.random.RandomState(seed)
    return [Client(f"c{start + i}", get_model("linear"),
                   ClientData(rs.randn(64, 64).astype(np.float32),
                              rs.randint(0, 10, 64).astype(np.int32)),
                   ClientConfig(lr=0.1, local_epochs=1), batch_size=16)
            for i in range(n)]


def _executor_rounds(capture, device, script):
    """Fused stc rounds through one executor: ``script`` a list of
    cohorts, or ``"reload"`` for a checkpoint round trip of the EF store
    into the same executor.  -> (final params, per-round loss, captures,
    replays)."""
    from repro_torch.core import batched
    from repro_torch.core.batched import BatchedExecutor

    model = get_model("linear")
    ex = BatchedExecutor(model, device, capture=capture)
    params = model.init(torch.Generator().manual_seed(0), device)
    n0 = (batched.round_capture_count(), batched.round_replay_count())
    losses = []
    r = 0
    for step in script:
        if step == "reload":
            ex.load_ef_state(ex.ef_state())
            continue
        st, params, _ = ex.run_round_fused(step, params, r, method="stc",
                                           use_kernel=True)
        losses.append(st["loss"].copy())
        r += 1
    return (params, losses, batched.round_capture_count() - n0[0],
            batched.round_replay_count() - n0[1])


@pytest.mark.parametrize("case", ["growth", "resume"])
def test_rounds_recapture_when_the_ef_store_moves(deterministic, case):
    """The captured round reads the EF store's leaves in place: a store
    that grows (a cohort of new clients past its rows) or is reloaded
    from a checkpoint gets new storage, and the next round captures again
    at once instead of reading the old storage; the run equals the eager
    run bit for bit."""
    a, b, c = _card_clients(4), _card_clients(4, 4, 1), \
        _card_clients(4, 8, 2)
    script = ([a, a, b, c, c] if case == "growth"
              else [a, a, a, "reload", a, a])
    got = _executor_rounds(True, deterministic, script)
    want = _executor_rounds(False, deterministic, script)
    assert _bits_equal(got[0], want[0])
    assert all(np.array_equal(x, y) for x, y in zip(got[1], want[1]))
    # a capture in round 1, and one more where the store moved
    assert got[2:] == (2, 4) and want[2:] == (0, 0)


def test_deferred_fetch_reads_its_own_round_after_the_next_replay(
        deterministic):
    """``sync=False``: round r's fetch, run after round r + 1 replayed the
    same graph, reads round r's loss (a copy out of the graph's pool),
    equal to the eager run's."""
    from repro_torch.core.batched import BatchedExecutor

    clients = _card_clients(4)
    model = get_model("linear")
    out = {}
    for capture in (True, False):
        ex = BatchedExecutor(model, deterministic, capture=capture)
        params = model.init(torch.Generator().manual_seed(0), deterministic)
        sts = []
        pending = None
        for r in range(4):
            st, params, fetch = ex.run_round_fused(
                clients, params, r, method="int8", use_kernel=True,
                sync=False)
            if pending is not None:
                pending()              # round r - 1, after round r's replay
            pending = fetch
            sts.append(st)
        pending()
        out[capture] = [s["loss"] for s in sts]
    assert all(np.array_equal(x, y) for x, y in zip(out[True], out[False]))
    assert not np.array_equal(out[True][2], out[True][3])


# ---------------------------------------------------------------------------
# the serve step as one CUDA graph for every position
# (models/model.py::ServeStep)
# ---------------------------------------------------------------------------

def _serve_case(arch, device, ring=False):
    """A reduced arch on ``device`` (RecurrentGemma at 3 layers with a
    window of 8, so that its local attention's ring wraps): ``(model,
    params, prompt tokens (2, 16))``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch(arch, reduced=True)
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, n_layers=3, window=8)
    if ring:
        cfg = dataclasses.replace(cfg, decode_window=8)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 16))).to(device)
    return model, params, toks


def _greedy(step, model, params, toks, device, ring=False, gen=8):
    """The prompt stepped in, then ``gen`` greedy tokens -> (logits of
    every step, greedy tokens, the cache)."""
    cache = model.init_cache(2, toks.shape[1] + gen, ring=ring,
                             device=device)
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, t:t + 1], t)
        logits.append(lg)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    out = []
    for i in range(gen):
        lg, cache = step(params, cache, tok,
                         torch.tensor(toks.shape[1] + i, device=device))
        logits.append(lg)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(logits, 1), torch.cat(out, 1), cache


@pytest.mark.parametrize("arch,ring", [
    ("glm4-9b", False), ("glm4-9b", True), ("rwkv6-1.6b", False),
    ("deepseek-v2-lite-16b", True), ("whisper-small", False),
    ("recurrentgemma-9b", False)])
def test_captured_serve_step_equals_the_eager_step(cuda_device, arch, ring):
    """Prefill by stepping 16 positions, then 8 greedy tokens, through the
    captured step and its eager twin: the same greedy tokens, logits and
    cache within 1e-4 of the logits' scale (bit for bit printed), one
    warm-up, one capture and a replay for every later step."""
    from repro_torch.models import model as model_mod

    model, params, toks = _serve_case(arch, cuda_device, ring)
    eager = model_mod.make_serve_step(model, ring=ring, capture=False)
    want, want_tok, want_cache = _greedy(eager, model, params, toks,
                                         cuda_device, ring)
    step = model_mod.make_serve_step(model, ring=ring)
    n0 = model_mod.serve_capture_count(), model_mod.serve_replay_count()
    got, got_tok, got_cache = _greedy(step, model, params, toks,
                                      cuda_device, ring)
    n = want.shape[1]
    assert (step.eager_steps, step.captures, step.recaptures,
            step.replays) == (1, 1, 0, n - 1)
    assert (model_mod.serve_capture_count() - n0[0],
            model_mod.serve_replay_count() - n0[1]) == (1, n - 1)
    assert (eager.captures, eager.eager_steps) == (0, n)
    assert torch.equal(got_tok, want_tok)
    scale = max(1.0, want.abs().max().item())
    print(f"{arch} ring={ring}: captured vs eager logits bitwise "
          f"{torch.equal(got, want)}, max |diff| "
          f"{(got - want).abs().max().item():.3g}")
    assert (got - want).abs().max().item() <= 1e-4 * scale
    for a, b in zip(tree_leaves(got_cache), tree_leaves(want_cache)):
        assert (a.float() - b.float()).abs().max().item() <= 1e-4 * max(
            1.0, b.float().abs().max().item())


def test_serve_step_recaptures_on_a_new_cache_and_new_params(cuda_device):
    """The graph reads the params and writes the cache in their own
    storage: another cache or other params capture again at once (the
    step keeps one graph), and the replay reads the new storage."""
    from repro_torch.models import model as model_mod

    model, params, toks = _serve_case("glm4-9b", cuda_device)
    step = model_mod.make_serve_step(model)
    eager = model_mod.make_serve_step(model, capture=False)
    caches = [model.init_cache(2, 16, device=cuda_device) for _ in range(3)]
    for t in range(3):
        step(params, caches[0], toks[:, t:t + 1], t)
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 2)
    got, _ = step(params, caches[1], toks[:, :1], 0)
    want, _ = eager(params, caches[2], toks[:, :1], 0)
    assert (step.captures, step.recaptures) == (2, 1)
    assert torch.equal(got, want)
    other = model.init(torch.Generator().manual_seed(1), cuda_device)
    got, _ = step(other, caches[0], toks[:, 3:4], 3)
    want, _ = eager(other, caches[0], toks[:, 3:4], 3)
    assert (step.captures, step.recaptures, step.eager_steps) == (3, 2, 1)
    assert torch.equal(got, want)


def test_serve_replay_makes_no_host_sync(cuda_device):
    """A hundred replayed steps with a device position and greedy
    feedback (argmax, ``pos + 1``), all under
    ``set_sync_debug_mode("error")``: nothing in the loop makes the host
    wait for the card."""
    from repro_torch.models import model as model_mod

    model, params, toks = _serve_case("rwkv6-1.6b", cuda_device)
    step = model_mod.make_serve_step(model)
    cache = model.init_cache(2, 128, device=cuda_device)
    for t in range(2):                              # warm-up, capture
        lg, cache = step(params, cache, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    pos = torch.tensor(2, device=cuda_device)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(100):
            lg, cache = step(params, cache, tok, pos)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            pos = pos + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert step.replays == 101 and step.captures == 1
    assert int(pos) == 102


# ---------------------------------------------------------------------------
# the sequential engine's client and eval steps as CUDA graphs
# (core/local_train.py::ClientStep, EvalStep)
# ---------------------------------------------------------------------------

def _eager_steps(monkeypatch):
    """Every client and eval step runs eagerly from here on (no device
    type runs them as a graph): the eager side of the A/B."""
    from repro_torch.core import local_train as lt

    monkeypatch.setattr(lt._GraphedStep, "graph_device_types", ())


def _sequential_steps(trainer):
    """The cached client and eval steps the trainer's run used (a cache
    hit each: a miss would make a new, empty step)."""
    from repro_torch.core import local_train as lt

    c = trainer.cfg.client
    opt = trainer.client(trainer.fed_data.client_ids[0]).optimizer
    factories = (lt.make_client_step, lt.make_eval_step)
    sizes = [f.cache_info().currsize for f in factories]
    steps = (lt.make_client_step(trainer.model, opt, c.proximal_mu,
                                 c.max_grad_norm),
             lt.make_eval_step(trainer.model))
    assert [f.cache_info().currsize for f in factories] == sizes
    return steps


def test_captured_sequential_run_equals_eager_bitwise(deterministic,
                                                      monkeypatch):
    """femnist_cnn at published width, 2 rounds of 3 clients through the
    default engine, captured and eager: final params, train losses and
    ``Server.test``'s metrics bit for bit; 1 capture a key, 0 recaptures,
    a replay for every step after the warm-up, and a replay fed a host
    tensor raises."""
    from repro_torch.core import local_train as lt

    cfg = Config.make({
        "model": "femnist_cnn",
        "data": {"dataset": "femnist", "num_clients": 6,
                 "data_amount": 0.06, "batch_size": 32},
        "server": {"rounds": 2, "clients_per_round": 3},
        "client": {"local_epochs": 1, "lr": 0.01}})
    repro_torch.set_device(deterministic)
    p0 = get_model("femnist_cnn").init(torch.Generator().manual_seed(0),
                                       deterministic)
    out = {}
    for capture in (True, False):
        repro_torch.reset()
        if not capture:
            _eager_steps(monkeypatch)
        trainer = Trainer(cfg, get_model("femnist_cnn"),
                          build_federated_data(cfg.data))
        trainer.server.params = p0
        res = trainer.run()
        out[capture] = (res, *_sequential_steps(trainer))
    (got, step, ev), (want, estep, eev) = out[True], out[False]
    assert _bits_equal(got["params"], want["params"])
    for key in ("train_loss", "loss", "accuracy"):
        assert [h[key] for h in got["history"]] == \
            [h[key] for h in want["history"]], key
    assert (step.captures, step.recaptures, step.eager_steps) == (1, 0, 1)
    assert (ev.captures, ev.recaptures, ev.eager_steps) == (1, 0, 1)
    assert len(step.keys()) == 1 and len(ev.keys()) == 1
    assert step.replays > 6 and ev.replays >= 1
    assert (estep.captures, eev.captures, estep.replays) == (0, 0, 0)
    slot = step._slots[step.keys()[0]]
    x, y = slot.graph._static
    with pytest.raises(RuntimeError):
        slot.graph((x.cpu(), y.cpu()))
    repro_torch.reset()


def test_captured_lstm_local_run_equals_eager_bitwise(deterministic,
                                                      monkeypatch):
    """``shakespeare_lstm`` at published width (the launch-bound step
    loop): two clients' local runs through the captured step equal the
    same step run eagerly bit for bit, 1 capture, 0 recaptures."""
    from repro_torch.core import local_train as lt
    from repro_torch.optim import get_optimizer

    model = get_model("shakespeare_lstm")
    opt = get_optimizer("sgd", 0.8, 0.9)
    rs = np.random.RandomState(0)
    x = rs.randint(0, 80, (50, 80)).astype(np.int32)
    y = rs.randint(0, 80, 50).astype(np.int32)
    p0 = model.init(torch.Generator().manual_seed(0), deterministic)
    step = lt.make_client_step(model, opt, 0.0, 0.0)
    for seed in (1, 2):
        kw = dict(epochs=1, batch_size=10, optimizer=opt, seed=seed)
        got = lt.local_train(model, p0, x, y, **kw)
        with monkeypatch.context() as m:
            m.setattr(lt._GraphedStep, "graph_device_types", ())
            want = lt.local_train(model, p0, x, y, **kw)
        assert got[1] == want[1]
        assert _bits_equal(got[0], want[0])
    assert (step.captures, step.recaptures, step.eager_steps,
            step.replays) == (1, 0, 1, 9)
    lt.make_client_step.cache_clear()


def test_remote_services_on_one_card_give_the_serial_params(deterministic):
    """Four client services of this process train at once on the card
    (threads of their RPC servers, each holding the card's lock): the run
    ends at the serial ``init(); run()`` run's params bit for bit, with
    one capture of the shared step."""
    from repro_torch.deploy import Registry

    cfg = {"model": "femnist_cnn",
           "data": {"dataset": "femnist", "num_clients": 4,
                    "data_amount": 0.04, "batch_size": 32},
           "server": {"rounds": 2, "clients_per_round": 4},
           "client": {"local_epochs": 1, "lr": 0.01}}
    repro_torch.set_device(deterministic)
    repro_torch.reset()
    repro_torch.init(cfg)
    seq = repro_torch.run()
    repro_torch.reset()
    repro_torch.init(cfg)
    reg = Registry()
    ids = sorted(repro_torch.core.api._ctx.fed_data.clients)
    clients = [repro_torch.start_client({"client_id": c, "registry": reg})
               for c in ids]
    srv = repro_torch.start_server({"registry": reg})
    try:
        hist = srv.run(2)
    finally:
        srv.stop()
        for c in clients:
            c.stop()
    assert _bits_equal(srv.server.params, seq["params"])
    assert [h["train_loss"] for h in hist] == \
        [h["train_loss"] for h in seq["history"]]
    step = clients[0].client
    from repro_torch.core import local_train as lt
    shared = lt.make_client_step(step.model, step.optimizer,
                                 step.cfg.proximal_mu, step.cfg.max_grad_norm)
    assert (shared.captures, shared.recaptures) == (1, 0)
    repro_torch.reset()


# ---------------------------------------------------------------------------
# the cohort program and the train step as CUDA graphs
# (core/batched.py::BatchedExecutor._train_cohort, models/model.py::TrainStep)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "stc", "int8"])
def test_captured_staged_rounds_equal_eager_rounds_bitwise(deterministic,
                                                           compression):
    """femnist_cnn at published width on the staged path, 4 rounds of 3
    clients, the cohort program captured and eager: final params and
    train losses bit for bit; each bucket warmed up once and captured
    once, a replay for every later round, the bucket's graphs in one
    pool."""
    from repro_torch.core import batched
    from repro_torch.core.batched import BatchedExecutor

    cfg = Config.make({
        "model": "femnist_cnn",
        "data": {"dataset": "femnist", "num_clients": 6,
                 "data_amount": 0.06, "batch_size": 32},
        "server": {"rounds": 4, "clients_per_round": 3},
        "client": {"local_epochs": 1, "lr": 0.01,
                   "compression": compression},
        "resources": {"execution": "batched", "round_fusion": "off",
                      "aggregation_kernel": True}})
    repro_torch.set_device(deterministic)
    p0 = get_model("femnist_cnn").init(torch.Generator().manual_seed(0),
                                       deterministic)
    out = {}
    for capture in (True, False):
        trainer = Trainer(cfg, get_model("femnist_cnn"),
                          build_federated_data(cfg.data))
        trainer.engine = BatchedExecutor(trainer.engine.model,
                                         trainer.device, capture=capture)
        trainer.server.params = p0
        n0 = (batched.cohort_capture_count(), batched.cohort_replay_count())
        res = trainer.run()
        out[capture] = (res, batched.cohort_capture_count() - n0[0],
                        batched.cohort_replay_count() - n0[1],
                        trainer.engine)
    (got, caps, reps, ex), (want, ecaps, ereps, _) = out[True], out[False]
    assert _bits_equal(got["params"], want["params"])
    assert [h["train_loss"] for h in got["history"]] == \
        [h["train_loss"] for h in want["history"]]
    assert (ecaps, ereps) == (0, 0)
    assert caps == len(ex._cohorts) >= 1 and reps == 4 - len(ex._warm)
    repro_torch.reset()


def test_captured_async_waves_equal_eager_bitwise(deterministic,
                                                  monkeypatch):
    """The async engine (K 3 of 8 in flight, 1x / 4x speeds, stc) with the
    measured wall pinned: waves of several buckets, each captured once;
    params, virtual clocks and staleness bit for bit the eager run's."""
    from repro_torch.core import batched
    from repro_torch.core.batched import BatchedExecutor

    orig = BatchedExecutor.run_cohort_stacked

    def fixed_wall(self, clients, params, round_id):
        st = orig(self, clients, params, round_id)
        st["wall"] = float(st["n_steps"].sum()) * 1e-4
        return st

    monkeypatch.setattr(BatchedExecutor, "run_cohort_stacked", fixed_wall)
    cfg = Config.make({
        "model": "linear",
        "data": {"dataset": "synthetic", "num_clients": 8,
                 "batch_size": 32},
        "server": {"rounds": 5, "clients_per_round": 4, "test_every": 0},
        "client": {"local_epochs": 2, "lr": 0.1, "compression": "stc"},
        "system_heterogeneity": {"enabled": True},
        "resources": {"execution": "async", "buffer_size": 3,
                      "max_concurrency": 8, "aggregation_kernel": True}})
    repro_torch.set_device(deterministic)
    p0 = get_model("linear").init(torch.Generator().manual_seed(0),
                                  deterministic)
    out = {}
    for capture in (True, False):
        fed = build_federated_data(cfg.data)
        trainer = Trainer(cfg, get_model("linear"), fed)
        trainer.engine = BatchedExecutor(trainer.engine.model,
                                         trainer.device, capture=capture)
        trainer.server.params = p0
        for i, cid in enumerate(sorted(fed.client_ids)):
            trainer.het.assignment[cid] = (1.0, 4.0)[i % 2]
        n0 = batched.cohort_capture_count()
        out[capture] = (trainer.run(), batched.cohort_capture_count() - n0,
                        len(trainer.engine._cohorts))
    (got, caps, keys), (want, ecaps, _) = out[True], out[False]
    assert _bits_equal(got["params"], want["params"])
    for key in ("virtual_time", "staleness_mean", "staleness_max",
                "train_loss"):
        assert [h[key] for h in got["history"]] == \
            [h[key] for h in want["history"]], key
    assert caps == keys >= 1 and ecaps == 0
    assert max(h["staleness_max"] for h in got["history"]) > 0
    repro_torch.reset()


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_captured_train_step_equals_eager_bitwise_in_place(deterministic,
                                                           arch):
    """The reduced arch, flash on, 5 steps through ``TrainStep`` captured
    (warm-up, capture, replays) and eagerly: losses, metrics and the
    final state bit for bit, the state in the same storage every step,
    K6 / K7a / K7b counted through the replays as the eager run counts
    them."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import attention as mattn
    from repro_torch.models.model import Model, TrainStep, init_train_state
    from repro_torch.optim import sgd

    model = Model(get_arch(arch, reduced=True))
    opt = sgd(0.01, momentum=0.9)
    out = {}
    mattn.set_flash_attention(True)
    try:
        for capture in (True, False):
            state = init_train_state(model, opt, torch.Generator(
                device=deterministic).manual_seed(0), deterministic)
            ptrs = [t.data_ptr() for t in tree_leaves(
                (state.params, state.opt_state, state.step))]
            step = TrainStep(model, opt, capture=capture)
            data = synthetic_lm_batches(model.cfg.vocab, 2, 64, 0,
                                        deterministic)
            ops.reset_launch_counts()
            metrics = []
            for _ in range(5):
                same, m = step(state, next(data))
                assert same is state
                metrics.append({k: v.cpu() for k, v in m.items()})
            assert [t.data_ptr() for t in tree_leaves(
                (state.params, state.opt_state, state.step))] == ptrs
            out[capture] = (state, metrics, ops.launch_counts(),
                            (step.eager_steps, step.captures,
                             step.recaptures, step.replays))
    finally:
        mattn.set_flash_attention(None)
    (got, gm, launches, counts), (want, wm, elaunches, ecounts) = \
        out[True], out[False]
    assert counts == (1, 1, 0, 4) and ecounts == (5, 0, 0, 0)
    assert launches == elaunches and launches["flash_dkv"] > 0
    for a, b in zip(gm, wm):
        assert all(torch.equal(a[k], b[k]) for k in a)
    params = [tree_leaves(s.params) for s in (got, want)]
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(*params))
    assert int(got.step) == int(want.step) == 5
