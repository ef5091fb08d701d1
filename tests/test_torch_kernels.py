"""The ported kernels' plain versions against the reference's Pallas
kernels (run in interpret mode, as the reference's own tests run them) and
the wrappers' device routing.  The CUDA kernels themselves are checked on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Bars: FedAvg within 1e-6; STC masks and counts bit for bit, values within
2 ulp (the reference sums the kept magnitudes in f32 and lands more than 1
ulp from the exact mean, while the port's mean — a float64 sum rounded
once, then one f32 division — stays within 1 ulp of it:
``test_stc_mean_gap_is_the_reference_f32_sum``); int8 round trip and
scales bit for bit.  Dense STC (K4) as the batched one; dense quantize and
dequantize (K5): q, scales and the dequantized values bit for bit against
the reference's oracle (``ref.quantize_ref``: a true division by 127) and
against its Pallas kernel in interpret mode, whose scale XLA compiles to a
multiply by f32(1/127) — one ulp off on some tiles
(``test_quantize_scale_gap_is_the_xla_reciprocal_rewrite``).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.kernels import build, fedavg_agg, ops, quant, stc_topk  # noqa: E402

repro_torch.set_device("cpu")

NS = [1, 7, 16]
DS = [64, 1000, 8192, 20000]


def _updates(n, d, seed=0):
    rs = np.random.RandomState(seed + 31 * n + d)
    x = (rs.standard_normal((n, d))
         * rs.uniform(1e-3, 2.0, (n, 1))).astype(np.float32)
    if n == 7:
        x[3] = 0.0                 # an all-zero (padded) client row
    return x


def _ulps(a, b):
    ref = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return (np.abs(a.astype(np.float64) - b) / np.spacing(ref)).max()


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_fedavg_plain_matches_reference_kernel(n, d):
    x = _updates(n, d)
    w = np.random.RandomState(d).uniform(0.1, 1.0, n).astype(np.float32)
    w /= w.sum()
    ref = np.asarray(ref_ops.fedavg_aggregate(jnp.asarray(x), jnp.asarray(w),
                                              interpret=True))
    out = ops.fedavg_aggregate(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_stc_plain_matches_reference_kernel(n, d):
    x = _updates(n, d)
    ro, rn = ref_ops.stc_compress_batched(jnp.asarray(x), 0.01,
                                          interpret=True)
    po, pn = ops.stc_compress_batched(torch.from_numpy(x), 0.01)
    ro, po = np.asarray(ro), po.numpy()
    np.testing.assert_array_equal(ro != 0, po != 0)          # masks
    np.testing.assert_array_equal(np.asarray(rn), pn.numpy())  # nnz
    assert _ulps(ro, po) <= 2.0
    if n == 7:
        assert pn[3] == 0 and not po[3].any()


def _mean_ulps_from_exact(x, out):
    """Largest |mu - exact mean| in ulps over the (row, segment) blocks of
    an STC output, the exact mean being the float64 mean of the kept |x|."""
    worst = 0.0
    for row_x, row_o in zip(x, out):
        for s0 in range(0, x.shape[1], stc_topk.SEG):
            xs, os = row_x[s0:s0 + stc_topk.SEG], row_o[s0:s0 + stc_topk.SEG]
            kept = os != 0
            if kept.any():
                exact = np.abs(xs[kept].astype(np.float64)).mean()
                mu = np.abs(os[kept]).astype(np.float64)
                worst = max(worst, float((np.abs(mu - exact)
                                          / np.spacing(np.float32(exact)))
                                         .max()))
    return worst


def test_stc_mean_gap_is_the_reference_f32_sum():
    """The port's STC values sit within 1 ulp of the exact mean of the kept
    magnitudes; the reference's own f32 sum sits more than 1 ulp from it,
    which is where the 2-ulp bar between the two comes from."""
    port_worst = ref_worst = 0.0
    for n in NS:
        for d in DS:
            x = _updates(n, d)
            ro, _ = ref_ops.stc_compress_batched(jnp.asarray(x), 0.01,
                                                 interpret=True)
            po, _ = ops.stc_compress_batched(torch.from_numpy(x), 0.01)
            port_worst = max(port_worst, _mean_ulps_from_exact(x, po.numpy()))
            ref_worst = max(ref_worst, _mean_ulps_from_exact(x, np.asarray(ro)))
    assert port_worst <= 1.0
    assert ref_worst > 1.0


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_int8_plain_matches_reference_kernel_bitwise(n, d):
    x = _updates(n, d)
    rs_, rsc = ref_ops.int8_roundtrip_batched(jnp.asarray(x), interpret=True)
    ps, psc = ops.int8_roundtrip_batched(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(rs_).view(np.int32),
                                  ps.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(rsc).view(np.int32),
                                  psc.numpy().view(np.int32))


def test_stc_targets_count_real_segment_elements():
    t = stc_topk.segment_targets(0.01, 20000)
    assert t.tolist() == [82.0, 82.0, 36.0]       # 8192, 8192, 3616 real
    assert stc_topk.segment_targets(0.001, 64).tolist() == [1.0]


@pytest.mark.parametrize("fn", [
    lambda x: fedavg_agg.fedavg_aggregate(x, torch.ones(2, device=x.device)),
    lambda x: fedavg_agg.fedavg_aggregate_grouped(
        x, torch.ones(2, device=x.device), 2),
    lambda x: stc_topk.stc_compress_batched(x, 0.01),
    lambda x: quant.rowmax(x),
    lambda x: quant.qdq(x, torch.ones(2, device=x.device)),
    lambda x: stc_topk.stc_compress(x, 0.01),
    lambda x: quant.quantize(x),
    lambda x: quant.dequantize(x.to(torch.int8),
                               torch.ones((1, 1), device=x.device), (2, 8)),
    lambda x: ops.wkv6(*(x.new_zeros((1, 64, 1, 1)),) * 4,
                       x.new_zeros((1, 1)), x.new_zeros((1, 1, 1, 1))),
])
def test_wrappers_never_fall_back_on_other_devices(fn):
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fn(x)


def test_cpu_tensors_take_the_plain_version_without_counting():
    ops.reset_launch_counts()
    x = torch.from_numpy(_updates(7, 1000))
    ops.fedavg_aggregate(x, torch.full((7,), 1 / 7))
    ops.fedavg_aggregate_tree(x, torch.full((7,), 1 / 7), fanout=2)
    ops.stc_compress_batched(x, 0.01)
    ops.int8_roundtrip_batched(x)
    q = x[:6, :64].reshape(1, 2, 3, 64).requires_grad_()
    ops.flash_attention(q, q, q).sum().backward()
    ops.stc_compress(x, 0.01)
    ops.dequantize(*ops.quantize(x), x.shape)
    r = x[:4, :64].reshape(1, 64, 1, 4)
    ops.wkv6(r, r, r, -r.abs(), x[0, :4].reshape(1, 4), torch.zeros(1, 1, 4, 4))
    assert ops.launch_counts() == {"fedavg_agg": 0, "fedavg_agg_tree": 0,
                                   "stc_batched": 0,
                                   "int8_rowmax": 0, "int8_qdq": 0,
                                   "flash_fwd": 0, "flash_dq": 0,
                                   "flash_dkv": 0, "stc_dense": 0,
                                   "int8_quantize": 0, "int8_dequantize": 0,
                                   "wkv6": 0}


# ---------------------------------------------------------------------------
# Dense STC (K4) and dense quantize / dequantize (K5)
# ---------------------------------------------------------------------------

DENSE_SHAPES = [(2 ** 14,), (10007,), (128, 128)]


def _dense(shape, seed=0):
    rs = np.random.RandomState(seed + int(np.prod(shape)))
    return (rs.standard_normal(shape)
            * rs.uniform(1e-3, 2.0)).astype(np.float32)


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_stc_dense_plain_matches_reference_kernel(shape):
    x = _dense(shape)
    ref = np.asarray(ref_ops.stc_compress(jnp.asarray(x), 0.01,
                                          interpret=True))
    out = ops.stc_compress(torch.from_numpy(x), 0.01).numpy()
    assert out.shape == ref.shape == x.shape
    np.testing.assert_array_equal(out != 0, ref != 0)               # mask
    np.testing.assert_array_equal(np.sign(out), np.sign(ref))       # sign
    assert np.count_nonzero(out) == np.count_nonzero(ref)           # nnz
    assert _ulps(ref, out) <= 2.0                                   # mu
    # the same tiles as one row of the batched kernel
    row, _ = stc_topk.stc_plain(torch.from_numpy(x.reshape(1, -1)), 0.01)
    np.testing.assert_array_equal(row.numpy().reshape(shape), out)


# ---------------------------------------------------------------------------
# The CUDA STC kernel's order of the bisection (csrc/stc_topk.cu): steps over
# the whole segment until at most CAND_CAP elements lie between the bounds,
# then the remaining steps on those candidates alone
# ---------------------------------------------------------------------------

SEGMENT_KINDS = ("normal", "ties", "one_nonzero", "denormal", "all_equal",
                 "all_zero", "outlier", "cauchy")


def _segment(kind, real, seed):
    """One segment of ``real`` f32 elements of a kind that stresses the
    bisection ("ties": a mid lands exactly on 1.0, the magnitude of a
    quarter of the elements)."""
    rs = np.random.RandomState(seed)
    sign = np.where(rs.rand(real) < 0.5, -1.0, 1.0)
    mag = np.zeros(real)
    if kind == "normal":
        mag = np.abs(rs.standard_normal(real)) * rs.uniform(1e-3, 2.0)
    elif kind == "ties":
        mag = rs.choice([0.5, 1.0, 2.0], real, p=[0.74, 0.25, 0.01])
    elif kind == "one_nonzero":
        mag[rs.randint(real)] = 3.0
    elif kind == "denormal":
        mag = np.abs(rs.standard_normal(real)) * 1e-39
    elif kind == "all_equal":
        mag[:] = 0.37
    elif kind == "outlier":
        mag = np.abs(rs.standard_normal(real))
        mag[rs.randint(real)] = 1e30
    elif kind == "cauchy":
        mag = np.abs(rs.standard_cauchy(real))
    return (sign * mag).astype(np.float32)


@given(kind=hst.sampled_from(SEGMENT_KINDS),
       real=hst.one_of(hst.just(1), hst.integers(1, 300),
                       hst.integers(1, stc_topk.SEG)),
       seed=hst.integers(0, 2 ** 31 - 1),
       keep=hst.sampled_from([0.01, 0.05, 0.3]),
       cap=hst.sampled_from([stc_topk.CAND_CAP, 1, 1024]))
@settings(max_examples=80, deadline=None, derandomize=True)
def test_stc_kernel_order_matches_sixteen_single_steps(kind, real, seed, keep,
                                                      cap):
    """The kernel's order on a segment's real elements alone gives
    :func:`stc_plain`'s 16 steps on the padded segment, bit for bit:
    thresholds, masks and counts."""
    seg = torch.from_numpy(_segment(kind, real, seed))
    thr, mask, kept, _ = stc_topk.stc_kernel_order_segment(seg, keep, cap)
    want = stc_topk.stc_thresholds(seg[None], keep)[0, 0]
    assert thr.view(torch.int32) == want.view(torch.int32)
    out, nnz = stc_topk.stc_plain(seg[None], keep)
    assert torch.equal(mask, out[0] != 0)
    assert kept == int(nnz[0]) == int(mask.sum())


@pytest.mark.parametrize("real", [stc_topk.SEG, 800, 64])
def test_stc_kernel_order_leaves_update_like_segments_after_few_steps(real):
    """On unit-normal segments (update-like) the whole-segment steps stop
    after at most 3 of the 16 (the kernel's note), and an all-zero
    (padded-client) segment takes none."""
    rs = np.random.RandomState(real)
    for _ in range(5):
        seg = torch.from_numpy(rs.standard_normal(real).astype(np.float32))
        assert stc_topk.stc_kernel_order_segment(seg, 0.01)[3] <= 3
    zero = torch.zeros(real)
    assert stc_topk.stc_kernel_order_segment(zero, 0.01)[3] == 0


@pytest.mark.parametrize("d", [8193, 20001])
def test_stc_plain_matches_reference_on_adversarial_rows(d):
    """The card's adversarial rows (ties at the threshold, one non-zero,
    denormals, one magnitude, all zeros, an outlier, small integers; d =
    8193 ends every row in a segment of one element, d = 20001 misaligns
    every row after the first) through the reference kernel and
    :func:`stc_plain`: masks, signs and counts bit for bit, and the port's
    values within 1 ulp of the exact mean of the kept magnitudes (the
    reference's f32 sum of 8192 equal magnitudes lands 3 ulp from it)."""
    x = stc_topk.adversarial_rows(d)
    ro, rn = ref_ops.stc_compress_batched(jnp.asarray(x.numpy()), 0.01,
                                          interpret=True)
    po, pn = stc_topk.stc_plain(x, 0.01)
    ro, po = np.asarray(ro), po.numpy()
    np.testing.assert_array_equal(ro != 0, po != 0)
    np.testing.assert_array_equal(np.sign(ro), np.sign(po))
    np.testing.assert_array_equal(np.asarray(rn), pn.numpy())
    assert _mean_ulps_from_exact(x.numpy(), po) <= 1.0
    assert pn[4] == 0 and pn[1] == 1          # all zeros; one non-zero


def test_stc_dense_plain_matches_reference_on_adversarial_segments():
    """One adversarial case a segment, then a last segment of one element,
    through the reference's dense kernel and the dense plain version (bars
    as for the batched rows)."""
    x = torch.cat([stc_topk.adversarial_rows(stc_topk.SEG).reshape(-1),
                   torch.tensor([5.0])]).numpy()
    ref = np.asarray(ref_ops.stc_compress(jnp.asarray(x), 0.01,
                                          interpret=True))
    out = stc_topk.stc_dense_plain(torch.from_numpy(x), 0.01).numpy()
    np.testing.assert_array_equal(out != 0, ref != 0)
    np.testing.assert_array_equal(np.sign(out), np.sign(ref))
    assert _mean_ulps_from_exact(x[None], out[None]) <= 1.0
    assert out[-1] == 5.0


def _tile_scales(x):
    m = np.abs(np.pad(x.reshape(-1), (0, (-x.size) % quant.TILE))
               .reshape(-1, quant.TILE)).max(axis=1)
    m = np.maximum(m, np.float32(1e-12))
    return m / np.float32(127.0), m * np.float32(1.0 / 127.0)


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_quantize_plain_matches_reference_bitwise(shape):
    x = _dense(shape, seed=1)
    q, s = ops.quantize(torch.from_numpy(x))
    oq, os_ = ref_oracles.quantize_ref(jnp.asarray(x))
    kq, ks = ref_ops.quantize(jnp.asarray(x), interpret=True)
    tiles = -(-x.size // quant.TILE)
    assert q.shape == (tiles * 8, 1024) and q.dtype == torch.int8
    assert s.shape == (tiles, 1) and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().reshape(-1),
                                  np.asarray(oq).reshape(-1))
    np.testing.assert_array_equal(s.numpy().reshape(-1).view(np.int32),
                                  np.asarray(os_).reshape(-1).view(np.int32))
    # the interpret-mode kernel: equal wherever its scale is the division
    div, mul = _tile_scales(x)
    ks = np.asarray(ks).reshape(-1)
    same = ks == s.numpy().reshape(-1)
    assert (same | ((ks == mul) & (s.numpy().reshape(-1) == div))).all()
    rows = np.repeat(same, 8)
    np.testing.assert_array_equal(q.numpy()[rows], np.asarray(kq)[rows])


def test_quantize_scale_gap_is_the_xla_reciprocal_rewrite():
    """The reference kernel's scale is max|x| * f32(1/127) on every tile
    (XLA rewrites the division by a constant), one ulp from the true
    quotient on some tiles; the port's — and the reference oracle's — is
    the quotient on every tile."""
    x = _dense((64 * quant.TILE,), seed=2)
    div, mul = _tile_scales(x)
    _, ks = ref_ops.quantize(jnp.asarray(x), interpret=True)
    _, s = ops.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ks).reshape(-1), mul)
    np.testing.assert_array_equal(s.numpy().reshape(-1), div)
    assert (div != mul).any()
    assert _ulps(div, mul) <= 1.0


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_dequantize_plain_matches_reference_bitwise(shape):
    x = _dense(shape, seed=3)
    kq, ks = ref_ops.quantize(jnp.asarray(x), interpret=True)
    ref = np.asarray(ref_ops.dequantize(kq, ks, shape, interpret=True))
    out = ops.dequantize(torch.from_numpy(np.array(kq)),
                         torch.from_numpy(np.array(ks)), shape).numpy()
    assert out.shape == shape
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    # the round trip of the port's own q, s stays within half a tile scale
    q, s = ops.quantize(torch.from_numpy(x))
    back = ops.dequantize(q, s, shape).numpy()
    assert np.abs(back - x).max() <= 0.5 * float(s.max()) * 1.0001


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_quantize_plain_matches_reference_on_16_bit_input(shape, dtype):
    """The reference quantizes any float input (its kernel widens to f32):
    the port's plain version on the same bf16 / f16 values gives the
    oracle's q and scales bit for bit, and the interpret-mode kernel's
    wherever its scale is the division."""
    x = _dense(shape, seed=4)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(                  # the same 16-bit values
        np.asarray(xj).view(np.uint16), xt.view(torch.int16).numpy()
        .view(np.uint16))
    q, s = ops.quantize(xt)
    oq, os_ = ref_oracles.quantize_ref(xj)
    kq, ks = ref_ops.quantize(xj, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(oq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(os_).view(np.int32))
    div, mul = _tile_scales(xt.to(torch.float32).numpy())
    ks, s = np.asarray(ks).reshape(-1), s.numpy().reshape(-1)
    same = ks == s
    assert (same | ((ks == mul) & (s == div))).all()
    rows = np.repeat(same, 8)
    np.testing.assert_array_equal(q.numpy()[rows], np.asarray(kq)[rows])


def test_k5_clip_never_binds_for_any_tile_max():
    """K5a leaves out clip(., -127, 127) (``csrc/quant.cu::qbyte``): with
    s = max(m, 1e-12) / 127 for a tile whose max |x| is m, the largest
    quotient m / s rounds to at most 127.  m / RN(m / 127) depends on m's
    mantissa alone while m >= 1e-12 (m / 127 stays normal), so every
    mantissa at three exponents of that range, and maxima below 1e-12 (where
    s is 1e-12 / 127), cover every finite m."""
    mant = np.arange(1 << 23, dtype=np.uint32)
    for exp in (88, 127, 254):     # m in [2^-39, 2^-38), [1, 2), up to FLT_MAX
        m = ((exp << 23) | mant).view(np.float32)
        s = np.maximum(m, np.float32(1e-12)) / np.float32(127.0)
        assert np.abs(np.rint(m / s)).max() == 127.0
    tiny = np.array([1e-45, 1e-30, 9.99e-13], np.float32)
    s = np.maximum(tiny, np.float32(1e-12)) / np.float32(127.0)
    assert np.abs(np.rint(tiny / s)).max() <= 127.0


def _k5_accesses(n, offset, itemsize):
    """Every access of a K5 launch over ``n`` elements at ``offset`` bytes
    past a 16-byte boundary, from the wrapper's plan -> (vector length,
    first elements of the 16-byte vectors, scalar elements, scalars a
    tile)."""
    vec = 16 // itemsize
    head = quant.vector_head(offset, itemsize)
    vectors, scalars, per_tile = [], [], []
    for start in range(0, n, quant.TILE):
        real = min(quant.TILE, n - start)
        lead, nvec, tail = quant.tile_plan(real, head, vec)
        vectors.append(start + lead + vec * np.arange(nvec))
        scalars.append(start + np.r_[0:lead, tail:real])
        per_tile.append(len(scalars[-1]))
    return vec, np.concatenate(vectors), np.concatenate(scalars), per_tile


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@settings(max_examples=60, deadline=None)
@given(n=hst.integers(1, 5 * quant.TILE + 17), data=hst.data())
def test_k5_access_plan_covers_each_element_once_inside_its_tile(
        itemsize, n, data):
    """The K5 kernels' plan for any length and pointer offset: every
    element covered once, no access past n, no 16-byte access across a
    tile boundary (or off its 16-byte alignment), and at most one scalar
    access for each of a tile's first 2 * (vec - 1) threads."""
    offset = data.draw(hst.sampled_from(range(0, 16, itemsize)))
    vec, vectors, scalars, per_tile = _k5_accesses(n, offset, itemsize)
    covered = np.zeros(n, np.int64)
    np.add.at(covered, (vectors[:, None] + np.arange(vec)).reshape(-1), 1)
    np.add.at(covered, scalars, 1)
    assert (covered == 1).all()
    assert (vectors + vec <= n).all() and (scalars < n).all()
    assert (vectors // quant.TILE == (vectors + vec - 1) // quant.TILE).all()
    assert ((offset + vectors * itemsize) % 16 == 0).all()
    assert max(per_tile) <= 2 * (vec - 1)


def test_build_names_libraries_by_source_hash(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert all(p.parent == tmp_path for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(build.SOURCES)
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "--use_fast_math" not in build.NVCC_FLAGS
        assert "cudaGetLastError" in src
        assert "src/repro/kernels/" in src          # names what it replaces
        for fn in build.SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in src


def test_library_names_hash_the_shared_headers(monkeypatch, tmp_path):
    """An edited header (``csrc/*.cuh``) renames every library, so a stale
    build of a source that includes it is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["tf32x3.cuh"]
    for name in ("flash_attn", "wkv6"):
        assert f'#include "{headers[0].name}"' in (
            csrc / f"{name}.cu").read_text()
    before = {name: build.library_path(name) for name in build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    assert all(before[n].parent == after[n].parent for n in build.SOURCES)
