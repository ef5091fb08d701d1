"""Time one source tree's hand-written kernels at their main path's shape,
and hold its WKV6 kernel (K8) against a float64 run.

    python3 scripts/bench_kernels.py --kernel flash|wkv6|stc|int8|fedavg [--root DIR]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
the kernel's source into ``DIR/build/kernels``, and prints the card
(``nvidia-smi`` name and power limit) and one JSON line:

* ``flash``: milliseconds of K6 (forward), K7a (dQ) and K7b (dK/dV) and of
  fp32 ``scaled_dot_product_attention`` at each causal shape that
  ``chip_smoke.py`` phase 3b times at D 128, 192 and 256
  (``FLASH_TIMED``: BH 512 = 4 clients x 4 sequences x 32 heads, S 512,
  the GLM-4 LoRA path's shape at D 128; ``FLASH_ZOO_TIMED``: nemotron-4-
  340b's (96, 1024, 192) and paligemma-3b's (16, 512, 256));
* ``wkv6``: milliseconds of K8 at (B 16, T 512, H 32, hd 64), one layer of
  the ``rwkv6-1.6b`` prefill, on phase 3c's inputs (``chip_smoke.
  wkv_inputs``); its distance from that tree's plain version; and its
  distances from a float64 run of the exact form
  (``models/rwkv6.wkv6_chunked``), each beside the f32 exact form's own:
  on those inputs; in each of the 24 layers of ``rwkv6-1.6b`` (f32,
  parameters from seed 0, 2 x 500 tokens as phase 5c), each on the same
  input, against the same layer with its recurrence run in float64; and
  in the logits end to end, with the token where each gap peaks and,
  beside K8, the tree's plain version run in the kernel's place;
* ``stc``: K2 (batched STC) at each of the six compressed ``femnist_cnn``
  leaves at N = 16 (the main path's shapes; phase 4 launches each once a
  round) and their sum a round, and K4 (dense STC) at 2^20 and 1,000,003:
  CUDA-event ms (host dispatch included), device ms (``chip_smoke.
  device_ms``: the profiler's kernel time) and graph ms (``chip_smoke.
  graph_ms``: calls replayed from a CUDA graph, the host out of the way,
  launch gaps in), each beside its bound (``chip_smoke.stc_bound``);
* ``int8``: K3a (row max and scale) and K3b (quantize/dequantize) at the
  same six leaves and their sums a round, K3a also at the (1, 6,422,528)
  and (1, 620,756,992) rows of the sequential stage, timed as ``stc``,
  beside their bounds (phase 3's), K3a beside ``vector_norm(inf)``; K5a (dense quantize) and K5b (dense dequantize) at 2^20,
  1,000,003 and 16 (one tile: the latency of a launch's dependent chain),
  timed the same way beside their bounds (phase 3c's) and
  ``torch.mul(q, s)``; the host microseconds a K5 wrapper call takes
  (``time.perf_counter_ns`` over 1,000 calls); and a digest of K5's
  outputs on ``quant.edge_tiles``;
* ``fedavg``: K1 at (16, 6,603,710) flat, the hierarchical tree (whole,
  and each tier as the route calls it) and the sharded route on 2 and 4
  shards of the card at fanout 0 and 2, timed as ``stc``, beside flat
  K1's bound and ``w @ U``.

Distances are scaled by max(1, max |reference|), as in phase 3c.  The
timing (``cuda_ms``, ``device_ms``, ``graph_ms``) and the SDPA yardstick
(``sdpa_ms``) are this checkout's ``chip_smoke.py``'s, and K5's edge
tiles this checkout's ``quant.edge_tiles``, whatever tree ``DIR`` holds,
so the numbers compare with its kernel table and two trees' digests with
each other.  To compare two trees on one card,
unpack one (``git archive``) into a directory that ``.gitignore`` lists and
run, in one call on the card: parent, change, change, parent.  Needs a
CUDA card.
"""
import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def bench_flash(smoke):
    from repro_torch.kernels import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    shapes = [smoke.FLASH_TIMED[d] for d in (128, 192, 256)] + [
        smoke.FLASH_ZOO_TIMED[d] for d in (192, 256)]
    res = {"repro_torch": os.path.relpath(attention.__file__),
           "causal": True, "shapes": []}
    for bh, s, d, causal, heads in shapes:
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                       for _ in range(4))
        o, lse = attention.flash_fwd(q, k, v, causal)
        delta = (do * o).sum(dim=-1)
        row = {
            "shape": [bh, s, d],
            "flash_fwd": smoke.cuda_ms(
                lambda: attention.flash_fwd(q, k, v, causal)),
            "flash_dq": smoke.cuda_ms(lambda: attention.flash_dq(
                q, k, v, do, lse, delta, causal)),
            "flash_dkv": smoke.cuda_ms(lambda: attention.flash_dkv(
                q, k, v, do, lse, delta, causal)),
        }
        row["sdpa_fwd"], row["sdpa_bwd"] = smoke.sdpa_ms(q, k, v, do, heads)
        assert all(math.isfinite(x) for x in row.values()
                   if isinstance(x, float))
        res["shapes"].append(row)
        del q, k, v, do, o, lse, delta
    return res


def bench_wkv6(smoke):
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.models import rwkv6 as rwkv_mod

    gen = torch.Generator(device="cuda").manual_seed(smoke.WKV_SEED)
    args = smoke.wkv_inputs(gen, *smoke.WKV_MAIN)
    y, sT = rwkv6_scan.wkv6(*args)
    py, ps = rwkv6_scan.wkv6_plain(*args)
    res = {
        "repro_torch": os.path.relpath(rwkv6_scan.__file__),
        "shape": list(smoke.WKV_MAIN),
        "wkv6_ms": smoke.cuda_ms(lambda: rwkv6_scan.wkv6(*args)),
        "scaled_err": max(smoke.scaled_err(y, py)[1],
                          smoke.scaled_err(sT, ps)[1]),
    }
    del py, ps
    ey, es = rwkv_mod.wkv6_chunked(*(a.double() for a in args))
    cy, cs = rwkv_mod.wkv6_chunked(*args)
    for tag, (a, b) in {"k8": (y, sT), "chunked": (cy, cs)}.items():
        res[f"{tag}_vs_f64_y"] = smoke.scaled_err(a, ey)[1]
        res[f"{tag}_vs_f64_sT"] = smoke.scaled_err(b, es)[1]
    del args, y, sT, ey, es, cy, cs
    res.update(wkv6_model_float64(smoke, rwkv_mod))
    return res


@contextlib.contextmanager
def plain_in_kernels_place():
    """The no-grad path's recurrence (``ops.wkv6``, K8) replaced by the
    tree's plain version."""
    from repro_torch.kernels import ops, rwkv6_scan

    kernel = ops.wkv6
    ops.wkv6 = rwkv6_scan.wkv6_plain
    try:
        yield
    finally:
        ops.wkv6 = kernel


def wkv6_model_float64(smoke, rwkv_mod):
    """rwkv6-1.6b in f32, phase 5c's tokens: K8 (no_grad) and the f32
    exact form (grad mode, nothing recorded) against the float64
    recurrence, layer by layer on the same input and end to end (there
    also the plain version in K8's place)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    model = Model(dataclasses.replace(get_arch("rwkv6-1.6b"),
                                      dtype="float32"))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 500),
                         generator=torch.Generator().manual_seed(2)).to(dev)

    def scaled(a, b):
        return smoke.scaled_err(a, b)[1]
    with torch.no_grad():
        k8, _ = model.forward(params, toks)
        with plain_in_kernels_place():
            plain, _ = model.forward(params, toks)
    with torch.enable_grad():
        chunked, _ = model.forward(params, toks)
        with smoke.float64_recurrence(rwkv_mod):
            witness, _ = model.forward(params, toks)
    out = {"e2e_max_logit": witness.abs().max().item()}
    for tag, a in {"k8": k8, "plain": plain, "chunked": chunked}.items():
        d = (a - witness).abs().amax(-1)                  # (batch, tokens)
        out[f"e2e_{tag}_vs_f64"] = d.max().item()
        out[f"e2e_{tag}_worst_token"] = divmod(int(d.argmax()), d.shape[1])
    out["e2e_k8_vs_chunked"] = (k8 - chunked).abs().max().item()
    del k8, plain, chunked, witness

    seg = tfm.segments(cfg)[0]
    x = params["embed"][toks].to(torch.float32)
    positions = torch.arange(x.shape[1], device=dev)[None, :]
    worst = {"layer_k8_vs_f64": 0.0, "layer_chunked_vs_f64": 0.0,
             "layer_k8_vs_chunked": 0.0}
    for li in range(seg.count):
        p = tfm._layer(params["segments"][0], li)
        with torch.no_grad():
            a = tfm._apply_layer(cfg, seg, p, x, positions)[0]       # K8
        with torch.enable_grad():
            c = tfm._apply_layer(cfg, seg, p, x, positions)[0]       # f32 exact
            with smoke.float64_recurrence(rwkv_mod):
                w = tfm._apply_layer(cfg, seg, p, x, positions)[0]
        for key, (u, v) in {"layer_k8_vs_f64": (a, w),
                            "layer_chunked_vs_f64": (c, w),
                            "layer_k8_vs_chunked": (a, c)}.items():
            worst[key] = max(worst[key], scaled(u, v))
        x = w
    out.update(worst)
    return out


def times(smoke, fn, b_by):
    """CUDA-event, device and graph ms of ``fn`` beside its bound."""
    return {"ms": smoke.cuda_ms(fn), "device_ms": smoke.device_ms(fn),
            "graph_ms": smoke.graph_ms(fn), "bound_ms": b_by[0],
            "bound_by": b_by[1]}


def bench_stc(smoke):
    """K2 at the six compressed femnist leaves (N = 16 update-like rows,
    ``chip_smoke.update_rows``; one launch each a round) and K4 at 2^20
    and 1,000,003: CUDA-event, device and graph ms, each beside its
    bound."""
    from repro_torch.kernels import stc_topk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    res = {"repro_torch": os.path.relpath(stc_topk.__file__), "k2": {},
           "k4": {}}
    for name, d in smoke.femnist_shapes():
        if d < 64:
            continue
        x = smoke.update_rows(gen, smoke.N_BUCKET, d)
        res["k2"][name] = {"shape": list(x.shape), **times(
            smoke, functools.partial(stc_topk.stc_compress_batched, x),
            smoke.stc_bound(x, stc_topk))}
    for key in ("ms", "device_ms", "graph_ms", "bound_ms"):
        res[f"k2_round_{key}"] = sum(r[key] for r in res["k2"].values())
    for n in (2 ** 20, 1000003):
        x = torch.randn((n,), generator=gen, device=dev) * 0.37
        res["k4"][str(n)] = times(
            smoke, functools.partial(stc_topk.stc_compress, x),
            smoke.stc_bound(x.view(1, n), stc_topk, counts=False))
    return res


def bench_int8(smoke):
    """K3a (row max and scale) and K3b (quantize/dequantize) at the six
    compressed femnist leaves (N = 16 update-like rows; one launch each a
    round, as K2), K3a also at the sequential stage's (1, 6,422,528) and
    (1, 620,756,992) rows: CUDA-event, device and graph ms, each beside its
    bound, K3a beside ``vector_norm(inf)``'s."""
    from repro_torch.kernels import quant

    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {"repro_torch": os.path.relpath(quant.__file__), "k3a": {},
           "k3a_norm": {}, "k3b": {}, **k5_host_us(quant)}
    for name, d in smoke.femnist_shapes():
        if d < 64:
            continue
        n = smoke.N_BUCKET
        x = smoke.update_rows(gen, n, d)
        s = quant.int8_scale(quant.rowmax_plain(x))
        res["k3a"][name] = times(smoke, functools.partial(quant.rowmax, x),
                                 smoke.bound(4 * n * d + 8 * n, 2 * n * d))
        res["k3a_norm"][name] = times(smoke, functools.partial(
            torch.linalg.vector_norm, x, float("inf"), dim=1),
            smoke.bound(4 * n * d + 4 * n, 2 * n * d))
        res["k3b"][name] = times(smoke, functools.partial(quant.qdq, x, s),
                                 smoke.bound(8 * n * d + 4 * n, 5 * n * d))
    for k in ("k3a", "k3a_norm", "k3b"):
        for key in ("ms", "device_ms", "graph_ms", "bound_ms"):
            res[f"{k}_round_{key}"] = sum(r[key] for r in res[k].values())
    res["k3a_host_us"] = k3a_host_us(smoke, quant, gen)
    for d in (6422528, smoke.EMBED_ROW):    # the sequential stage's rows
        x = smoke.update_rows(gen, 1, d)
        res["k3a"][f"1x{d}"] = times(smoke, functools.partial(quant.rowmax, x),
                                     smoke.bound(4 * d + 8, 2 * d))
        res["k3a_norm"][f"1x{d}"] = times(smoke, functools.partial(
            torch.linalg.vector_norm, x, float("inf"), dim=1),
            smoke.bound(4 * d + 4, 2 * d))
        del x
    res.update(bench_k5(smoke, quant))
    return res


def k3a_host_us(smoke, quant, gen):
    """Host microseconds of K3a's wrapper call at (16, 6,422,528) and of
    its parts — the output's ``torch.empty``, ``build.launch`` around a
    no-op, the ctypes call refused before any launch (N = 0) — beside
    ``vector_norm(inf)``'s call."""
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    x = smoke.update_rows(gen, smoke.N_BUCKET, 6422528)
    lib = build.load("quant")
    nargs = len(build.SIGNATURES["quant"]["int8_rowmax_launch"])
    refused = [0] * (nargs - 1) + [None]
    return {"rowmax": host_us(functools.partial(quant.rowmax, x)),
            "vector_norm": host_us(functools.partial(
                torch.linalg.vector_norm, x, float("inf"), dim=1)),
            "torch_empty": host_us(lambda: torch.empty(
                (2, smoke.N_BUCKET), dtype=torch.float32, device=dev)),
            "build_launch_noop": host_us(lambda: build.launch(
                dev, "noop", lambda stream: 0)),
            "ctypes_call": host_us(lambda: lib.int8_rowmax_launch(*refused))}


def bench_fedavg(smoke):
    """K1 at the whole femnist update matrix (16, 6,603,710): flat; the
    hierarchical tree at fanout 0 whole and tier by tier as the route calls
    them (the first tier: one grouped launch of 2 groups of 8; the second:
    the 2 partials at weight 1 as a tree of 2 rows at fanout 1, one group
    of 8); the sharded route on k = 2 and 4 shards of the card at fanout 0
    and 2, on the row blocks: CUDA-event, device and graph ms beside the
    bound (flat K1's bytes: no partial crosses a card) and ``w @ U``'s."""
    from repro_torch.core.batched import build_client_mesh
    from repro_torch.kernels import fedavg_agg

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    n, d = smoke.N_BUCKET, sum(s for _, s in smoke.femnist_shapes())
    u = smoke.update_rows(gen, n, d)
    w = torch.rand((n,), generator=gen, device=dev)
    w /= w.sum()
    flat_b = smoke.bound(4 * n * d + 4 * n + 4 * d, 2 * n * d)
    parts = fedavg_agg.fedavg_aggregate_grouped(u, w, 2)
    ones = torch.ones((2,), dtype=torch.float32, device=dev)
    res = {"repro_torch": os.path.relpath(fedavg_agg.__file__),
           "shape": [n, d],
           "flat": times(smoke, functools.partial(
               fedavg_agg.fedavg_aggregate, u, w), flat_b),
           "w_at_u": times(smoke, lambda: w @ u, flat_b),
           "tree": times(smoke, functools.partial(
               fedavg_agg.fedavg_aggregate_tree, u, w, fanout=0),
               smoke.bound(4 * n * d + 4 * n + 4 * 5 * d, 2 * n * d)),
           "tree_tier1": times(smoke, functools.partial(
               fedavg_agg.fedavg_aggregate_grouped, u, w, 2),
               smoke.bound(4 * n * d + 4 * n + 4 * 2 * d, 2 * n * d)),
           "tree_tier2": times(smoke, functools.partial(
               fedavg_agg.fedavg_aggregate_tree, parts, ones, fanout=1),
               smoke.bound(4 * 3 * d + 8, 4 * d))}
    res["host_us"] = {
        "flat": host_us(functools.partial(fedavg_agg.fedavg_aggregate, u, w)),
        "w_at_u": host_us(lambda: w @ u),
        "tree": host_us(functools.partial(fedavg_agg.fedavg_aggregate_tree,
                                          u, w, fanout=0))}
    for k in (2, 4):
        mesh = build_client_mesh([dev] * k)
        blocks = list(u.chunk(k))
        for fanout in (0, 2):
            fn = functools.partial(fedavg_agg.fedavg_aggregate_sharded,
                                   blocks, w, mesh, fanout=fanout)
            res[f"sharded_k{k}_fanout{fanout}"] = times(smoke, fn, flat_b)
            res["host_us"][f"sharded_k{k}_fanout{fanout}"] = host_us(fn)
    return res


def host_us(fn, calls=1000, reps=5):
    """Host microseconds a call of ``fn`` takes (``time.perf_counter_ns``
    over ``calls`` calls, the median of ``reps``): what the caller waits
    before the launch is queued, the device's time left out."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
    return sorted(out)[reps // 2]


def k5_host_us(quant):
    """Host us a K5 wrapper call takes at 2^20 f32, measured first in the
    process, before any profiler session or graph capture, so that every
    tree measures it at the same point."""
    x = torch.randn((2 ** 20,), device="cuda")
    q, s = quant.quantize(x)
    return {"host_us_quantize": host_us(functools.partial(quant.quantize, x)),
            "host_us_dequantize": host_us(
                functools.partial(quant.dequantize, q, s, x.shape))}


def bench_k5(smoke, quant):
    """K5a (quantize) and K5b (dequantize) at 2^20, 1,000,003 and 16 f32:
    CUDA-event, device and graph ms beside their bounds (phase 3c's) and
    ``torch.mul(q, s)``'s; a digest of q, scales and dequantized values of
    this checkout's ``quant.edge_tiles`` (equal digests: equal bits, NaN
    and inf tiles included)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {"k5a": {}, "k5b": {}, "k5_mul": {}}
    for n in (2 ** 20, 1000003, 16):            # 16: one tile's latency
        x = torch.randn((n,), generator=gen, device="cuda") * 0.37
        q, s = quant.quantize(x)
        tiles = s.shape[0]
        q2 = q.view(tiles, quant.TILE)
        b5b = smoke.bound(n + 4 * tiles + 4 * n, 2 * n)
        res["k5a"][str(n)] = times(
            smoke, functools.partial(quant.quantize, x),
            smoke.bound(4 * n + q.numel() + 4 * tiles, 6 * n))
        res["k5b"][str(n)] = times(
            smoke, functools.partial(quant.dequantize, q, s, x.shape), b5b)
        res["k5_mul"][str(n)] = times(
            smoke, functools.partial(torch.mul, q2, s), b5b)
    x = here_edge_tiles().cuda()
    q, s = quant.quantize(x)
    h = hashlib.sha256()
    for t in (q, s, quant.dequantize(q, s, x.shape)):
        h.update(t.cpu().numpy().tobytes())
    res["k5_edge_digest"] = h.hexdigest()[:16]
    return res


def here_edge_tiles():
    """This checkout's ``quant.edge_tiles()``, whatever tree ``--root``
    holds, so that two trees' digests are of the same input."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_k5_edges", os.path.join(HERE, "src", "repro_torch", "kernels",
                                  "quant.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.edge_tiles()


BENCHES = {"flash": ("flash_attn", bench_flash),
           "wkv6": ("wkv6", bench_wkv6),
           "stc": ("stc_topk", bench_stc),
           "int8": ("quant", bench_int8),
           "fedavg": ("fedavg_agg", bench_fedavg)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(BENCHES), required=True)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_kernels.py needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as smoke                  # puts HERE/src on the path
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(root, "build",
                                                       "kernels")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    source, bench = BENCHES[args.kernel]
    build.build_all([source])
    res = {"root": os.path.relpath(root), **bench(smoke)}
    assert all(math.isfinite(x) for x in res.values()
               if isinstance(x, float))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
