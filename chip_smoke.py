"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), require CUDA,
   turn TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (every ``femnist_cnn`` leaf of >= 64
   elements at N_b = 16 clients, the whole (16, 6,603,710) update matrix,
   and ragged widths), and time kernel, plain version and — where one
   PyTorch call computes the same function — that call (median of CUDA
   events over 20 runs);
3b. hold the three flash-attention kernels (forward, dQ, dK/dV) against
   their plain versions at the LoRA path's shape (BH = 4 clients x 4
   sequences x 32 heads = 512, S = 512, D = 128, causal) and at ragged
   S in {1, 63, 200} x D in {20, 64}, causal and not; forward within 1e-5,
   gradients within 1e-4 at unit-scale inputs; time each next to its plain
   version and fp32 ``scaled_dot_product_attention`` (its forward for the
   forward kernel, its backward — forward + backward minus forward — for
   the two backward kernels);
4. drive the main path through the public entry points: ``init`` + ``run``
   on ``femnist_cnn`` / ``femnist`` at full width, 3 rounds of 10 clients,
   ``execution="batched"``, ``aggregation_kernel=True``, once per
   ``client.compression`` in none / stc / int8, with the kernel launch
   counters set to 0 just before each run and read just after;
4b. drive the LoRA path the same way: GLM-4-9B at its published width cut
   to 2 layers (f32, 1.65 B base parameters, attention projections drawn
   at the published models' scale: ``glm4_2layer``), ``make_tiny_lm``
   sequences of 512 tokens, ``finetune="lora"`` rank 8 / alpha 16 on the
   attention projections, 8 clients, 4 per round, batch 4, 2 rounds, once
   with the flash flag on and once off; the flash kernels must launch in
   the first run only and the final adapters of the two runs agree within
   1e-4; then a probe of the repo's default init (flash on, off, and off
   from a 1e-7-perturbed start) prints how far each gap reaches;
5. run the same port for 2 rounds of 4 clients from one set of injected
   parameters on the card and on the CPU and compare the parameters;
5b. the same for ``tiny_lm`` LoRA with the flash flag on;
6. print the kernel table as one JSON line, then the result line.

The kernel comparisons of phase 3/3b happen before the counters are reset,
so the ``launches`` reported are those of the main-path runs alone (K1-K3
from phase 4, the flash kernels from the flash-on run of phase 4b).

``python3 chip_smoke.py --profile`` instead profiles one steady-state round
per compression mode, and one steady LoRA round of phase 4b's
configuration, with ``torch.profiler`` (device time by operator and the
device's busy share of the round).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
N_BUCKET = 16                  # 10 selected clients -> power-of-two bucket
REPS = 20


def phase(name):
    print(f"\n=== {name}", flush=True)


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes, ops):
    """Least time the card could take: (ms, "bytes" | "operations")."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def ulps(a, b):
    """Elementwise |a - b| in units of the last place of max(|a|, |b|)."""
    a64, b64 = a.double(), b.double()
    ref = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
    return ((a64 - b64).abs() / spacing.double().clamp_min(1e-45)).max().item()


# ---------------------------------------------------------------------------
def main():
    phase("1. device")
    if not torch.cuda.is_available():
        print("CUDA is not available; chip_smoke.py needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))

    import repro_torch
    from repro_torch.kernels import (
        attention, build, fedavg_agg, ops, quant, stc_topk,
    )

    phase("2. build")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in secs.items()})})")

    phase("3. kernels against their plain versions")
    kernels = check_kernels(dev, fedavg_agg, stc_topk, quant)

    phase("3b. flash-attention kernels against their plain versions")
    flash_rows = check_flash(dev, attention)

    phase("4. the main path: femnist_cnn through init/run")
    repro_torch.set_device(None)          # the default: CUDA
    launches = {k: 0 for k in ops.launch_counts()}
    for mode in ("none", "stc", "int8"):
        used = run_slice(repro_torch, ops, mode)
        for k, v in used.items():
            launches[k] += v
    for row in kernels:
        row["launches"] = launches[row["counter"]]
        del row["counter"]

    phase("4b. the LoRA path: GLM-4-9B (2 layers) at full width through "
          "init/run")
    on = run_lora(repro_torch, ops, flash_on=True)
    off = run_lora(repro_torch, ops, flash_on=False)
    diff = max_param_diff(on["params"], off["params"])
    print(f"[lora] flash on vs off: max |adapter diff| {diff:.3g} "
          f"(bar 1e-4)")
    require(diff <= 1e-4, f"flash on vs off adapters differ by {diff}")
    lora_default_init_probe(repro_torch)
    for row in flash_rows:
        row["launches"] = on["launches"][row["counter"]]
        del row["counter"]
    kernels += flash_rows

    phase("5. card against CPU")
    card_vs_cpu(repro_torch)

    phase("5b. card against CPU: tiny_lm LoRA, flash on")
    lora_card_vs_cpu(repro_torch)

    phase("6. result")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
def max_param_diff(a, b):
    from repro_torch.utils.tree import tree_leaves
    return max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def flash_bound(bh, s, d, causal, kernel):
    """Least time of one flash kernel: operations for the (query, key)
    pairs this causal mask keeps, bytes for each input read once and each
    output written once."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mat, row = 4 * bh * s * d, 4 * bh * s
    ops_per_pair, nbytes = {
        "flash_fwd": (4 * d, 4 * mat + row),          # q k v -> o, lse
        "flash_dq": (6 * d, 5 * mat + 2 * row),        # q k v dO lse delta -> dq
        "flash_dkv": (8 * d, 6 * mat + 2 * row),       # ... -> dk, dv
    }[kernel]
    return bound(nbytes, ops_per_pair * pairs)


def check_flash(dev, attention):
    """K6/K7a/K7b against their plain versions, then timed at the LoRA
    path's shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4321)

    def qkv(bh, s, d):
        return [torch.randn((bh, s, d), generator=gen, device=dev)
                for _ in range(4)]

    main = (512, 512, 128, True)
    cases = [main] + [(3, s, d, c) for s in (1, 63, 200) for d in (20, 64)
                      for c in (True, False)]
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for bh, s, d, causal in cases:
        q, k, v, do = qkv(bh, s, d)
        o, lse = attention.flash_fwd(q, k, v, causal)
        po, plse = attention.flash_fwd_plain(q, k, v, causal)
        delta = (do * o).sum(dim=-1)
        dq = attention.flash_dq(q, k, v, do, lse, delta, causal)
        dk, dv = attention.flash_dkv(q, k, v, do, lse, delta, causal)
        pdq = attention.flash_dq_plain(q, k, v, do, lse, delta, causal)
        pdk, pdv = attention.flash_dkv_plain(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        e = {"flash_fwd": max((o - po).abs().max().item(),
                              (lse - plse).abs().max().item()),
             "flash_dq": (dq - pdq).abs().max().item(),
             "flash_dkv": max((dk - pdk).abs().max().item(),
                              (dv - pdv).abs().max().item())}
        print(f"flash (BH {bh}, S {s}, D {d}, causal {causal}): max abs err "
              + ", ".join(f"{n} {x:.3g}" for n, x in e.items()))
        require(e["flash_fwd"] <= 1e-5, f"flash_fwd err {e['flash_fwd']}")
        require(e["flash_dq"] <= 1e-4, f"flash_dq err {e['flash_dq']}")
        require(e["flash_dkv"] <= 1e-4, f"flash_dkv err {e['flash_dkv']}")
        for n in errs:
            errs[n] = max(errs[n], e[n])

    bh, s, d, causal = main
    q, k, v, do = qkv(bh, s, d)
    o, lse = attention.flash_fwd(q, k, v, causal)
    delta = (do * o).sum(dim=-1)
    # the library yardstick: fp32 SDPA on (16 sequences, 32 heads, S, D)
    sq, sk, sv = (t.detach().view(16, 32, s, d).clone().requires_grad_()
                  for t in (q, k, v))
    sdo = do.view(16, 32, s, d)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        torch.autograd.grad(out, (sq, sk, sv), sdo)
    sdpa_f = cuda_ms(sdpa_fwd)
    sdpa_b = cuda_ms(sdpa_fwd_bwd) - sdpa_f
    timed = {
        "flash_fwd": (lambda: attention.flash_fwd(q, k, v, causal),
                      lambda: attention.flash_fwd_plain(q, k, v, causal),
                      sdpa_f, "src/repro/kernels/attention.py:60"),
        "flash_dq": (
            lambda: attention.flash_dq(q, k, v, do, lse, delta, causal),
            lambda: attention.flash_dq_plain(q, k, v, do, lse, delta, causal),
            sdpa_b, "src/repro/kernels/attention.py:151"),
        "flash_dkv": (
            lambda: attention.flash_dkv(q, k, v, do, lse, delta, causal),
            lambda: attention.flash_dkv_plain(q, k, v, do, lse, delta,
                                              causal),
            sdpa_b, "src/repro/kernels/attention.py:176"),
    }
    rows = []
    for name, (kern, plain, lib_ms, replaces) in timed.items():
        b, by = flash_bound(bh, s, d, causal, name)
        rows.append(dict(
            name=name, counter=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attn.cu",
            replaces=replaces, shape=[bh, s, d], max_abs_err=errs[name],
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=b,
            bound_by=by, library_ms=lib_ms))
    for r in rows:
        print(f"{r['name']:12s} {r['shape']} causal: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms "
              f"({'forward' if r['name'] == 'flash_fwd' else 'backward, dq+dk+dv'}"
              f"), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
def femnist_shapes():
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_flatten, tree_paths

    p = femnist_cnn().init(torch.Generator().manual_seed(0), "cpu")
    sizes = [t.numel() for t in tree_flatten(p)[0]]
    return list(zip(tree_paths(p), sizes))


def check_kernels(dev, fedavg_agg, stc_topk, quant):
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(n, d):
        # update-like rows: per-client scale, one all-zero padded client
        x = torch.randn((n, d), generator=gen, device=dev)
        x *= torch.rand((n, 1), generator=gen, device=dev) * 0.1 + 1e-3
        if n > 9:
            x[-1] = 0.0
        return x.contiguous()

    leaves = [(name, s) for name, s in femnist_shapes() if s >= 64]
    d_total = sum(s for _, s in femnist_shapes())
    print("compressed leaves (>= 64 elements):", leaves, "D =", d_total)
    ragged = [(7, 20001), (3, 8193), (1, 63)]
    shapes = [(N_BUCKET, s) for _, s in leaves] + ragged
    errs = {"fedavg_agg": 0.0, "stc": 0.0, "rowmax": 0.0, "qdq": 0.0}

    # K1: the whole update matrix (scalar path: D % 4 != 0), a leaf with
    # D % 4 == 0 (float4 path), ragged widths
    for n, d in [(N_BUCKET, d_total), (N_BUCKET, 6422528), *ragged]:
        u = rand(n, d)
        w = torch.rand((n,), generator=gen, device=dev)
        w /= w.sum()
        k = fedavg_agg.fedavg_aggregate(u, w)
        p = fedavg_agg.fedavg_plain(u, w)
        torch.cuda.synchronize()
        rel = ((k - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
        errs["fedavg_agg"] = max(errs["fedavg_agg"], (k - p).abs().max().item())
        require(rel <= 1e-6, f"fedavg_agg ({n}, {d}): rel err {rel} > 1e-6")
        print(f"fedavg_agg ({n}, {d}): max rel err {rel:.3g}")
    for n, d in shapes:
        x = rand(n, d)
        ko, kn = stc_topk.stc_compress_batched(x, 0.01)
        po, pn = stc_topk.stc_plain(x, 0.01)
        torch.cuda.synchronize()
        require(torch.equal(ko != 0, po != 0), f"stc ({n}, {d}): masks differ")
        require(torch.equal(kn, pn), f"stc ({n}, {d}): nnz differ")
        u = ulps(ko, po) if ko.numel() else 0.0
        require(u <= 1.0, f"stc ({n}, {d}): values differ by {u} ulp > 1")
        errs["stc"] = max(errs["stc"], (ko - po).abs().max().item())
        km = quant.rowmax(x)
        pm = quant.rowmax_plain(x)
        s = quant.int8_scale(pm)
        kq = quant.qdq(x, s)
        pq = quant.qdq_plain(x, s)
        torch.cuda.synchronize()
        require(torch.equal(km.view(torch.int32), pm.view(torch.int32)),
                f"int8 rowmax ({n}, {d}): not bitwise equal")
        require(torch.equal(kq.view(torch.int32), pq.view(torch.int32)),
                f"int8 qdq ({n}, {d}): not bitwise equal")
        errs["rowmax"] = max(errs["rowmax"], (km - pm).abs().max().item())
        errs["qdq"] = max(errs["qdq"], (kq - pq).abs().max().item())
        print(f"stc/int8 ({n}, {d}): masks+nnz bitwise, values <= {u:.3g} "
              f"ulp; rowmax+qdq bitwise")

    # timings at the main path's largest shapes
    rows = []
    n, d = N_BUCKET, d_total
    u = rand(n, d)
    w = torch.rand((n,), generator=gen, device=dev)
    w /= w.sum()
    b, by = bound(4 * n * d + 4 * n + 4 * d, 2 * n * d)
    rows.append(dict(
        name="fedavg_agg", counter="fedavg_agg", route="cuda",
        source="src/repro_torch/kernels/csrc/fedavg_agg.cu",
        replaces="src/repro/kernels/fedavg_agg.py:114",
        shape=[n, d], max_abs_err=errs["fedavg_agg"],
        ms=cuda_ms(lambda: fedavg_agg.fedavg_aggregate(u, w)),
        plain_ms=cuda_ms(lambda: fedavg_agg.fedavg_plain(u, w)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: w @ u)))
    del u

    n, d = N_BUCKET, 6422528          # fc1/w, the dominant leaf
    x = rand(n, d)
    _, nnz = stc_topk.stc_compress_batched(x, 0.01)
    kept = int(nnz.sum().item())
    t = -(-d // stc_topk.SEG)
    # bytes: read x, write out and nnz; operations: per padded element,
    # abs + max + 16 x (compare, add) + final compare and add
    b, by = bound(8 * n * d + 4 * n, 36 * n * t * stc_topk.SEG + 2 * kept)
    rows.append(dict(
        name="stc_batched", counter="stc_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/stc_topk.cu",
        replaces="src/repro/kernels/stc_topk.py:118",
        shape=[n, d], max_abs_err=errs["stc"],
        ms=cuda_ms(lambda: stc_topk.stc_compress_batched(x, 0.01)),
        plain_ms=cuda_ms(lambda: stc_topk.stc_plain(x, 0.01)),
        bound_ms=b, bound_by=by, library_ms=None))
    b, by = bound(4 * n * d + 4 * n, 2 * n * d)
    rows.append(dict(
        name="int8_rowmax", counter="int8_rowmax", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:106",
        shape=[n, d], max_abs_err=errs["rowmax"],
        ms=cuda_ms(lambda: quant.rowmax(x)),
        plain_ms=cuda_ms(lambda: quant.rowmax_plain(x)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(
            lambda: torch.linalg.vector_norm(x, float("inf"), dim=1))))
    s = quant.int8_scale(quant.rowmax_plain(x))
    zp = torch.zeros((n,), dtype=torch.int32, device=dev)
    b, by = bound(8 * n * d + 4 * n, 5 * n * d)
    rows.append(dict(
        name="int8_qdq", counter="int8_qdq", route="cuda",
        source="src/repro_torch/kernels/csrc/quant.cu",
        replaces="src/repro/kernels/quant.py:117",
        shape=[n, d], max_abs_err=errs["qdq"],
        ms=cuda_ms(lambda: quant.qdq(x, s)),
        plain_ms=cuda_ms(lambda: quant.qdq_plain(x, s)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.fake_quantize_per_channel_affine(
            x, s, zp, 0, -127, 127))))
    del x
    for r in rows:
        print(f"{r['name']:12s} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
              f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
def run_slice(repro_torch, ops, mode):
    import math

    from repro_torch.core import batched

    rounds = 3
    repro_torch.reset()
    repro_torch.init({
        "model": "femnist_cnn", "dataset": "femnist",
        "resources": {"execution": "batched", "aggregation_kernel": True},
        "client": {"local_epochs": 1, "compression": mode},
        "server": {"rounds": rounds, "clients_per_round": 10},
    })
    d0, h0 = batched.dispatch_count(), batched.host_sync_count()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = repro_torch.run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    used = ops.launch_counts()
    hist = res["history"]
    print(f"[{mode}] launches {used}")
    require(used["fedavg_agg"] == rounds, f"[{mode}] fedavg_agg launched "
            f"{used['fedavg_agg']} times, expected {rounds}")
    want = {"none": (), "stc": ("stc_batched",),
            "int8": ("int8_rowmax", "int8_qdq")}[mode]
    for k in ("stc_batched", "int8_rowmax", "int8_qdq"):
        if k in want:
            require(used[k] > 0, f"[{mode}] {k} never launched")
        else:
            require(used[k] == 0, f"[{mode}] {k} launched outside its mode")
    require(batched.dispatch_count() - d0 == rounds,
            f"[{mode}] dispatches {batched.dispatch_count() - d0} != {rounds}")
    require(batched.host_sync_count() - h0 == rounds,
            f"[{mode}] host syncs {batched.host_sync_count() - h0} != {rounds}")
    for h in hist:
        require(math.isfinite(h["train_loss"]) and math.isfinite(h["loss"]),
                f"[{mode}] non-finite loss in {h}")
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_leaves
    ref_shapes = [t.shape for t in tree_leaves(
        femnist_cnn().init(torch.Generator().manual_seed(0), "cpu"))]
    out = tree_leaves(res["params"])
    require([t.shape for t in out] == ref_shapes, f"[{mode}] param shapes")
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"[{mode}] non-finite params")
    walls = [h["wall_time"] for h in hist]
    print(f"[{mode}] round wall s: round0 {walls[0]:.4f} "
          f"(first-use setup included), later {[round(x, 4) for x in walls[1:]]};"
          f" run total {total:.3f} s; peak device memory {peak:.2f} GiB")
    print(f"[{mode}] train_loss {[round(h['train_loss'], 5) for h in hist]}"
          f" test loss {[round(h['loss'], 5) for h in hist]} test acc "
          f"{[round(h['accuracy'], 4) for h in hist]} comm_up "
          f"{[h['comm_up_bytes'] for h in hist]}")
    repro_torch.reset()
    return used


def card_vs_cpu(repro_torch):
    from repro_torch import convert
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models.small import femnist_cnn
    from repro_torch.utils.tree import tree_leaves

    p0 = convert.params_to_numpy(
        femnist_cnn().init(torch.Generator().manual_seed(7), "cpu"))
    cfg = {"model": "femnist_cnn", "dataset": "femnist",
           "resources": {"execution": "batched"},
           "client": {"local_epochs": 1},
           "server": {"rounds": 2, "clients_per_round": 4}}
    out = {}
    for device in ("cuda", "cpu"):
        repro_torch.reset()
        repro_torch.set_device(device)
        repro_torch.init(cfg)
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = convert.params_from_jax(p0)
        t0 = time.perf_counter()
        res = trainer.run()
        out[device] = (res, time.perf_counter() - t0)
    repro_torch.set_device(None)
    repro_torch.reset()
    diff = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(out["cuda"][0]["params"]),
        tree_leaves(out["cpu"][0]["params"])))
    lossdiff = max(abs(a["train_loss"] - b["train_loss"]) for a, b in zip(
        out["cuda"][0]["history"], out["cpu"][0]["history"]))
    print(f"card vs CPU after 2 rounds: max |param diff| {diff:.3g} "
          f"(bar 1e-4), max |train_loss diff| {lossdiff:.3g}; "
          f"run s: cuda {out['cuda'][1]:.2f}, cpu {out['cpu'][1]:.2f}")
    require(diff <= 1e-4, f"card vs CPU param diff {diff} > 1e-4")


LORA_SEQ_LEN = 512
LORA_CLIENT = {"local_epochs": 1, "finetune": "lora", "lora_rank": 8,
               "lora_alpha": 16.0, "lora_targets": ("attn",),
               "compression": "none"}


def glm4_2layer(published_scale=True):
    """GLM-4-9B at its published width, depth cut 40 -> 2, f32.

    ``published_scale``: draw the attention projections with std
    1/sqrt(fan-in over the contracted dims) — wq, wk, wv 1/sqrt(d_model),
    wo 1/sqrt(H * hd) — as trained models of this shape are scaled.  The
    repo's default init (the reference's) takes the head count as the
    fan-in of the (d, H, hd) leaves: q and k 11x larger at this width,
    attention scores of std ~128, a hard argmax under which LoRA training
    is chaotic (``lora_default_init_probe`` shows it)."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.models.llm import transformer_lm
    from repro_torch.models.small import FLModel

    arch = dataclasses.replace(get_arch("glm4-9b"), n_layers=2,
                               dtype="float32", max_seq_len=LORA_SEQ_LEN)
    model = transformer_lm(arch, name="glm4-9b-2l")
    if not published_scale:
        return dataclasses.replace(model, name="glm4-9b-2l-default-init")

    class PublishedScale(FLModel):
        def init(self, gen, device=None):
            p = super().init(gen, device)
            for seg in p["segments"]:
                a = seg["attn"]
                _, d, h, _ = a["wq"].shape          # (layers, d, H, hd)
                kv = a["wk"].shape[2]
                a["wq"].mul_(math.sqrt(h / d))
                a["wk"].mul_(math.sqrt(kv / d))
                a["wv"].mul_(math.sqrt(kv / d))
                a["wo"].mul_(1.0 / math.sqrt(h))
            return p

    return PublishedScale(model.name, model.defs, model.apply,
                          model.num_classes, model.input_shape,
                          model.is_sequence)


def lora_config(model, rounds=2):
    """Phase 4b's configuration (registers ``model`` and the dataset).
    Evaluation is off: one full-vocabulary evaluation batch (256 x 512
    tokens x 151,552 logits) would need 79 GB."""
    import repro_torch
    from repro_torch.data.synthetic import make_tiny_lm

    repro_torch.register_model(model)
    repro_torch.register_dataset(
        lambda seed=0: make_tiny_lm(n_seqs=140, seq_len=LORA_SEQ_LEN,
                                    vocab=1024, seed=seed), name="lm512")
    return {"model": model.name, "dataset": "lm512",
            "data": {"num_clients": 8, "batch_size": 4},
            "server": {"rounds": rounds, "clients_per_round": 4,
                       "test_every": 0},
            "client": LORA_CLIENT,
            "resources": {"execution": "batched",
                          "aggregation_kernel": True}}


def run_lora(repro_torch, ops, flash_on):
    import math

    from repro_torch.models import attention as mattn
    from repro_torch.models.lora import adapter_param_count
    from repro_torch.utils.tree import tree_leaves

    tag = f"[lora flash {'on' if flash_on else 'off'}]"
    release(repro_torch)
    cfg = lora_config(glm4_2layer())
    repro_torch.init(cfg)
    mattn.set_flash_attention(flash_on)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = repro_torch.run()
        torch.cuda.synchronize()
    finally:
        mattn.set_flash_attention(None)
    total = time.perf_counter() - t0
    used = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = res["history"]
    print(f"{tag} launches {used}")
    rounds = cfg["server"]["rounds"]
    require(used["fedavg_agg"] == rounds, f"{tag} fedavg_agg launched "
            f"{used['fedavg_agg']} times, expected {rounds}")
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        if flash_on:
            require(used[k] > 0, f"{tag} {k} never launched")
        else:
            require(used[k] == 0, f"{tag} {k} launched with the flag off")
    for h in hist:
        require(math.isfinite(h["train_loss"]), f"{tag} non-finite loss {h}")
    out = tree_leaves(res["params"])
    n = sum(t.numel() for t in out)
    want = adapter_param_count(repro_torch.core.api._ctx.model,
                               LORA_CLIENT["lora_rank"],
                               LORA_CLIENT["lora_targets"])
    require(n == want, f"{tag} {n} trained parameters, expected the "
            f"{want} adapter elements")
    require(all(bool(torch.isfinite(t).all()) for t in out),
            f"{tag} non-finite adapters")
    walls = [h["wall_time"] for h in hist]
    print(f"{tag} round wall s {[round(w, 4) for w in walls]} (round 0 "
          f"includes first use); run total {total:.3f} s (base init "
          f"included); peak device memory {peak:.2f} GiB")
    print(f"{tag} train_loss {[round(h['train_loss'], 6) for h in hist]} "
          f"comm_up {[h['comm_up_bytes'] for h in hist]}")
    release(repro_torch)
    return {"params": res["params"], "launches": used}


def release(repro_torch):
    """Drop the previous run's trainer and programs (and with them its
    6.6 GB base) before the next full-width run."""
    import gc
    repro_torch.reset()
    gc.collect()
    torch.cuda.empty_cache()


def lora_default_init_probe(repro_torch):
    """Phase 4b's configuration with the repo's default init: flash on and
    off from one start, and flash off from that start perturbed by 1e-7
    (relative).  Prints both gaps: where the perturbation moves the result
    as far as the kernels do, the training is chaotic and no two correct
    f32 programs agree within 1e-4."""
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models import attention as mattn
    from repro_torch.utils.tree import tree_map

    out = {}
    for flash_on, perturb in ((True, 0.0), (False, 0.0), (False, 1e-7)):
        release(repro_torch)
        repro_torch.init(lora_config(glm4_2layer(published_scale=False)))
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        start = trainer.model.init(torch.Generator().manual_seed(0),
                                   trainer.device)
        trainer.server.params = tree_map(lambda t: t * (1.0 + perturb),
                                         start)
        mattn.set_flash_attention(flash_on)
        try:
            out[(flash_on, perturb)] = trainer.run()["params"]
        finally:
            mattn.set_flash_attention(None)
        del trainer
    release(repro_torch)
    kern = max_param_diff(out[(True, 0.0)], out[(False, 0.0)])
    pert = max_param_diff(out[(False, 0.0)], out[(False, 1e-7)])
    print(f"[lora default init] max |adapter diff|: flash on vs off {kern:.4g};"
          f" flash off vs flash off from a 1e-7-perturbed start {pert:.4g}")


def lora_card_vs_cpu(repro_torch):
    """``tiny_lm`` LoRA, flash on, 2 rounds of 4 clients on the card and on
    the CPU.  Base and adapters are drawn from the CPU generator, so both
    runs start from the same parameters."""
    from repro_torch.models import attention as mattn

    cfg = {"model": "tiny_lm", "dataset": "tiny_lm",
           "data": {"num_clients": 8, "batch_size": 32},
           "server": {"rounds": 2, "clients_per_round": 4},
           "client": {"local_epochs": 1, "lr": 0.1, "finetune": "lora",
                      "lora_rank": 4, "lora_alpha": 8.0,
                      "lora_targets": ("attn",)},
           "resources": {"execution": "batched"}}
    out = {}
    mattn.set_flash_attention(True)
    try:
        for device in ("cuda", "cpu"):
            repro_torch.reset()
            repro_torch.set_device(device)
            repro_torch.init(cfg)
            out[device] = repro_torch.run()
    finally:
        mattn.set_flash_attention(None)
        repro_torch.set_device(None)
        repro_torch.reset()
    diff = max_param_diff(out["cuda"]["params"], out["cpu"]["params"])
    print(f"tiny_lm LoRA card vs CPU after 2 rounds (flash on): max |adapter "
          f"diff| {diff:.3g} (bar 1e-4)")
    require(diff <= 1e-4, f"LoRA card vs CPU adapter diff {diff} > 1e-4")


def profile_rounds(repro_torch):
    """``--profile``: one steady-state round per compression mode, and one
    of phase 4b's LoRA configuration with the flash flag on, under
    ``torch.profiler`` — device time by operator and the device's busy
    share of the round's wall time (evaluation off, so the round is the
    training round alone)."""
    from repro_torch.core import api
    from repro_torch.core.rounds import Trainer
    from repro_torch.models import attention as mattn

    repro_torch.set_device(None)
    runs = [(mode, {
        "model": "femnist_cnn", "dataset": "femnist",
        "resources": {"execution": "batched", "aggregation_kernel": True},
        "client": {"local_epochs": 1, "compression": mode},
        "server": {"rounds": 3, "clients_per_round": 10, "test_every": 0}})
        for mode in ("none", "stc", "int8")]
    runs.append(("lora flash on", None))
    for tag, cfg in runs:
        repro_torch.reset()
        repro_torch.init(cfg or lora_config(glm4_2layer(), rounds=3))
        ctx = api._ctx
        trainer = Trainer(ctx.config, ctx.model, ctx.fed_data,
                          tracker=ctx.tracker)
        trainer.server.params = trainer.model.init(
            torch.Generator().manual_seed(0), trainer.device)
        mattn.set_flash_attention(cfg is None)
        try:
            profile_round(trainer, tag)
        finally:
            mattn.set_flash_attention(None)
    repro_torch.reset()


def profile_round(trainer, tag):
    from torch.profiler import ProfilerActivity, profile

    for r in range(2):                       # warm-up rounds
        trainer.run_round(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_round(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side entries (kernels, copies, memsets) carry the device
    # time; operator entries would count it a second time
    on_dev = [e for e in rows
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_dev) / 1e3
    print(f"[{tag}] profiled round: wall {wall * 1e3:.2f} ms, device "
          f"busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%)")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    cpu = sorted(rows, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    print(f"[{tag}] top host self time:")
    for e in cpu:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile"]:
        if not torch.cuda.is_available():
            sys.exit("CUDA is not available; --profile needs a CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import repro_torch as _rt
        from repro_torch.kernels import build as _build
        _build.build_all()
        profile_rounds(_rt)
    elif sys.argv[1:]:
        sys.exit(f"usage: python3 chip_smoke.py [--profile]; got {sys.argv[1:]}")
    else:
        main()
