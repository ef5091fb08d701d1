"""The ported kernels' plain versions against the reference's Pallas
kernels (run in interpret mode, as the reference's own tests run them) and
the wrappers' device routing.  The CUDA kernels themselves are checked on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Bars: FedAvg within 1e-6; STC masks and counts bit for bit, values within
2 ulp (the reference sums the kept magnitudes in f32 and lands more than 1
ulp from the exact mean, while the port's mean — a float64 sum rounded
once, then one f32 division — stays within 1 ulp of it:
``test_stc_mean_gap_is_the_reference_f32_sum``); int8 round trip and
scales bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
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
    lambda x: stc_topk.stc_compress_batched(x, 0.01),
    lambda x: quant.rowmax(x),
    lambda x: quant.qdq(x, torch.ones(2, device=x.device)),
])
def test_wrappers_never_fall_back_on_other_devices(fn):
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fn(x)


def test_cpu_tensors_take_the_plain_version_without_counting():
    ops.reset_launch_counts()
    x = torch.from_numpy(_updates(7, 1000))
    ops.fedavg_aggregate(x, torch.full((7,), 1 / 7))
    ops.stc_compress_batched(x, 0.01)
    ops.int8_roundtrip_batched(x)
    q = x[:6, :64].reshape(1, 2, 3, 64).requires_grad_()
    ops.flash_attention(q, q, q).sum().backward()
    assert ops.launch_counts() == {"fedavg_agg": 0, "stc_batched": 0,
                                   "int8_rowmax": 0, "int8_qdq": 0,
                                   "flash_fwd": 0, "flash_dq": 0,
                                   "flash_dkv": 0}


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
