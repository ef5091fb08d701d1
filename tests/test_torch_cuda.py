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
                              fanout=2)    # 4 rows pad to 8: one tier
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


# the LoRA path's shape (4 clients x 4 sequences x 32 heads, S 512, D 128),
# ragged sequence lengths and head dims, a head dim that is not a power of
# two, and the full head dim without the causal mask
@pytest.mark.parametrize("bh,s,d,causal", [
    (512, 512, 128, True), (3, 1, 20, True), (3, 63, 64, False),
    (3, 200, 20, True), (3, 200, 64, False), (2, 130, 16, True),
    (3, 200, 72, True), (2, 130, 128, False)])
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
