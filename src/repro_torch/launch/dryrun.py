"""Dry run: the roofline of one (arch x shape x mesh) step, no device memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape train_4k --out artifacts/dryrun

The reference (``repro.launch.dryrun``) lowers and compiles each step for
a 256- or 512-chip XLA mesh and reads FLOPs, bytes and collectives from
the compiled program.  The port has one card and no SPMD partitioner, so
it splits the same record into what can be known without one:

* **per-device bytes** of the state and inputs from the resolved partition
  specs over the reference's mesh shapes (``launch.mesh``, abstract meshes)
  and rule presets (``launch.shardings``): each leaf's block is its shape
  divided by the sizes of its mesh axes;
* **FLOPs and HBM bytes** by running the step (``models.model``: the train
  step with remat, the prefill or the decode step, or the cross-pod
  federated round) on ``torch._subclasses.FakeTensorMode`` tensors, which
  carry shapes and dtypes and no storage: FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode``, HBM bytes as every eager
  op's tensor inputs read once and outputs written once (views move
  nothing).  The global counts are divided by the chips (a balanced
  program).  Where a stack is deep, the step is traced at three cut
  depths a layer-pattern period apart and the counts extrapolated to the
  full depth — exact, because the counts are a polynomial of degree two
  in the depth (``depth_plan``);
* **collective bytes** from the specs as well, because torch has no HLO
  text to read them from (the reference's ``hlo_analysis.py`` has no
  twin): a spec model (``collective_model``) of FSDP gathers, gradient
  reduce-scatters and all-reduces, tensor-parallel activation all-reduces,
  the expert all-to-alls and the cross-pod sync;
* the roofline on H100 constants (``launch.roofline``) and the
  reference's ``model_flops``.

No device memory is touched: CUDA is never initialized by the trace, and
the record says so (``device``).  Multi-process and multi-host runs are
out of scope: the port runs on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape
from repro_torch.core.config import ArchConfig
from repro_torch.launch import shardings as shr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline, model_flops
from repro_torch.models.model import (
    Model, TrainState, make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.models.sharding import Mesh, use_mesh
from repro_torch.optim import sgd
from repro_torch.utils.tree import tree_flatten, tree_map

# SGD with momentum 0.9: the paper's default optimizer (the reference's too)
LR, MOMENTUM = 0.01, 0.9


def _optimizer():
    return sgd(LR, momentum=MOMENTUM)


# ---------------------------------------------------------------------------
# Per-device bytes from the specs
# ---------------------------------------------------------------------------


def param_specs(model: Model, rules, mesh: Mesh):
    return shr.partition_specs(model.defs(), rules, mesh.shape)


def _spec_params(model: Model):
    """Meta stand-ins of the params (shape and dtype only)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), model.defs())


def input_specs_of(model: Model, shape: InputShape, step: str,
                   num_pods: int = 1, fed_local_steps: int = 4):
    """Meta stand-ins of the step's inputs (decode: tokens, pos, cache;
    fed: the ``(pods, local steps, batch, ...)`` batch)."""
    if step == "fed":
        from repro_torch.core.federated import FedRoundConfig, fed_input_specs
        return fed_input_specs(model, shape, num_pods,
                               FedRoundConfig(local_steps=fed_local_steps))
    return model.input_specs(shape)


def input_partition_specs(model: Model, specs, rules, mesh: Mesh,
                          step: str = "train"):
    """PartitionSpecs of the inputs, as the reference shards its batch,
    tokens, position and cache (fed: the leading pod dim over ``pod``)."""
    out = {}
    for k, v in specs.items():
        if step == "fed":
            out[k] = shr.resolve(("pod_batch",) + (None,) * (v.dim() - 1),
                                 tuple(v.shape),
                                 {**rules, "pod_batch": ("pod",)}, mesh)
        elif k == "cache":
            out[k] = shr.specs_for(v, shr.cache_axes_for(v, model.cfg),
                                   rules, mesh)
        elif k == "tokens" and v.dim() == 2 and v.shape[1] == 1 \
                and "cache" in specs:
            out[k] = shr.resolve(("batch", None), tuple(v.shape), rules,
                                 mesh)
        else:
            out[k] = shr.specs_for({k: v}, shr.batch_axes_for({k: v}),
                                   rules, mesh)[k]
    return out


def per_device_bytes(model: Model, shape: InputShape, mesh: Mesh, rules,
                     step: str, fed_local_steps: int = 4) -> Dict[str, int]:
    """Bytes a device holds: params, optimizer state (momentum mirrors the
    params; the int32 step replicated) and the step's inputs.  Under
    ``fed`` the pod-stacked state shards its pod dim over ``pod``, so a
    device holds the same block of it as of the unstacked state."""
    sizes = mesh.shape
    pspecs = param_specs(model, rules, mesh)
    params = _spec_params(model)
    out = {"params": shr.bytes_per_device(params, pspecs, sizes)}
    if step in ("train", "fed"):
        out["opt_state"] = out["params"] + 4       # momentum + int32 step
    specs = input_specs_of(model, shape, step, sizes.get("pod", 1),
                           fed_local_steps)
    out["inputs"] = shr.bytes_per_device(
        specs, input_partition_specs(model, specs, rules, mesh, step), sizes)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Collective bytes from the specs
# ---------------------------------------------------------------------------


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _tokens_per_device(model: Model, shape: InputShape, mesh: Mesh,
                       rules) -> int:
    """Tokens of one device's batch shard in one pass."""
    sizes = mesh.shape
    B = shape.global_batch
    part = shr.resolve(("batch",), (B,), rules, mesh)[0]
    for a in _axes_of(part):
        B //= sizes[a]
    S = 1 if shape.kind == "decode" else model.text_len(shape)
    return B * S


def collective_model(model: Model, shape: InputShape, mesh: Mesh, rules,
                     step: str, fed_local_steps: int = 4) -> Dict:
    """Per-device collective bytes of one step, from the specs.

    * **FSDP gathers**: a parameter sharded over a batch axis (``data``,
      ``pod``) is all-gathered over those axes before each use — once a
      forward, again in a remat'ed backward; the result is the leaf over
      its remaining (tensor-parallel) axes.
    * **Gradient reduction** (train, fed's local steps): a reduce-scatter
      back to the shard over the FSDP axes, and an all-reduce of the
      shard over every batch axis the leaf is replicated on.
    * **Tensor-parallel all-reduces**: a stacked leaf that contracts a
      ``model``-sharded ``heads`` / ``mlp`` dim into an ``embed`` output
      (the attention and MLP output projections) leaves a partial sum, one
      all-reduce of the device's ``(tokens, d_model)`` activation a layer
      a pass; an ``expert``-sharded one (the MoE down projection) sends
      its tokens' ``top_k`` copies twice through an all-to-all instead.
    * **Cross-pod sync** (fed): an all-reduce of the param shard over
      ``pod`` once a round.

    Passes: prefill and decode 1; train 3 (forward, the remat forward,
    backward); fed 3 a local step.  A collective whose group spans ``pod``
    is inter-node (``dcn_bytes``).  This is a model of a partitioned
    program, not a measurement of one."""
    sizes = mesh.shape
    batch_axes = tuple(a for a in (rules.get("batch") or ()) if a in sizes)
    cfg = model.cfg
    defs = tree_flatten(model.defs())[0]
    specs = shr._flat(param_specs(model, rules, mesh), shr.P)
    act_bytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    tokens = _tokens_per_device(model, shape, mesh, rules)
    train = step in ("train", "fed")
    steps = fed_local_steps if step == "fed" else 1
    passes = 3 if train else 1
    by_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    dcn = [0.0]

    def add(op, nbytes, n, group):
        if n <= 0 or nbytes <= 0:
            return
        by_op[op] = by_op.get(op, 0) + nbytes * n
        counts[op] = counts.get(op, 0) + n
        if "pod" in group:
            dcn[0] += nbytes * n

    for d, s in zip(defs, specs):
        full = shr.nbytes(d.shape, d.dtype)
        axes = [(_axes_of(s[i] if i < len(s) else None), d.axes[i])
                for i in range(len(d.shape))]
        mesh_axes = [a for ax, _ in axes for a in ax if a in sizes]
        n_all = 1
        for a in mesh_axes:
            n_all *= sizes[a]
        fsdp = tuple(a for a in mesh_axes if a in batch_axes)
        n_fsdp = 1
        for a in fsdp:
            n_fsdp *= sizes[a]
        if n_fsdp > 1:
            add("all-gather", full // (n_all // n_fsdp),
                steps * (2 if train else 1), fsdp)
        if train:
            if n_fsdp > 1:
                add("reduce-scatter", full // n_all, steps, fsdp)
            rep = tuple(a for a in batch_axes if a not in mesh_axes)
            n_rep = 1
            for a in rep:
                n_rep *= sizes[a]
            if n_rep > 1:
                add("all-reduce", full // n_all, steps, rep)
        # tensor-parallel partial sums of the output projections
        if not d.axes or d.axes[0] != "layers" or d.axes[-1] != "embed":
            continue
        layers = d.shape[0]
        for ax, name in axes:
            if "model" not in ax or sizes.get("model", 1) <= 1:
                continue
            if name in ("heads", "mlp"):
                add("all-reduce", tokens * cfg.d_model * act_bytes,
                    layers * passes * steps, ("model",))
            elif name == "expert":
                k = cfg.moe.top_k if cfg.moe else 1
                add("all-to-all", tokens * k * cfg.d_model * act_bytes,
                    2 * layers * passes * steps, ("model",))
            break
    if step == "fed":
        params = _spec_params(model)
        shard = shr.bytes_per_device(params, param_specs(model, rules, mesh),
                                     sizes)
        add("all-reduce", shard, 1, ("pod",))
    return {"bytes_by_op": by_op, "count_by_op": counts,
            "total_bytes": sum(by_op.values()), "dcn_bytes": dcn[0]}


# ---------------------------------------------------------------------------
# FLOPs and HBM bytes on fake tensors
# ---------------------------------------------------------------------------


class TrafficMode(TorchDispatchMode):
    """Counts HBM bytes of an eager program: each aten op that is not a
    view reads its tensor inputs once and writes its tensor outputs once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    @staticmethod
    def _tensor_bytes(xs) -> int:
        total = 0
        for x in xs:
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
            elif isinstance(x, (list, tuple)):
                total += TrafficMode._tensor_bytes(x)
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view:
            moved = self._tensor_bytes(args) + self._tensor_bytes(
                kwargs.values()) + self._tensor_bytes(
                    out if isinstance(out, (list, tuple)) else (out,))
            if moved:
                self.bytes += moved
                self.ops += 1
        return out


def depth_plan(cfg: ArchConfig):
    """``(configs, n)``: the configs to trace and the full depth in
    layer-pattern periods.

    Deep stacks are traced at three depths ``base + p``, ``base + 2p``,
    ``base + 3p`` (``p`` the layer-pattern period; ``base`` keeps the full
    model's head, the dense-FFN layers, and its tail, the layers past the
    last whole period), one, two and three periods deep; the full depth
    is ``n = (L - base) / p`` periods.  A step's counts are a polynomial of
    degree two in the periods: FLOPs are linear, and so is most of the
    traffic, but autograd's backward of a layer's slice of a stacked
    parameter writes a zero-filled gradient of the whole stack, once a
    layer, and adds them up — traffic quadratic in the depth.  Three
    points fix that polynomial exactly (``extrapolate``).  An
    encoder-decoder whose encoder is as deep as its decoder cuts both.
    Shallow stacks, and anything else, are traced whole (``n`` None)."""
    L = cfg.n_layers
    p = len(cfg.block_pattern) or 1
    f = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    base = f + (L - f) % p
    if L <= base + 3 * p or (cfg.encoder_layers
                             and cfg.encoder_layers != L):
        return [cfg], None

    def at(n):
        kw = {"n_layers": n}
        if cfg.encoder_layers:
            kw["encoder_layers"] = n
        return dataclasses.replace(cfg, **kw)
    return [at(base + i * p) for i in (1, 2, 3)], (L - base) // p


def extrapolate(t1: int, t2: int, t3: int, n: int) -> int:
    """The degree-two polynomial through ``(1, t1), (2, t2), (3, t3)`` at
    ``n`` (Lagrange form, in exact integers)."""
    return (t1 * (n - 2) * (n - 3) // 2 - t2 * (n - 1) * (n - 3)
            + t3 * (n - 1) * (n - 2) // 2)


def _fake_state(model: Model, fed_pods: int = 0):
    params = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype),
                      model.defs())
    state = TrainState(params, _optimizer().init(params),
                       torch.zeros((), dtype=torch.int32))
    if fed_pods:
        from repro_torch.core.federated import replicate_for_pods
        state = replicate_for_pods(state, fed_pods)
    return state


def _fake_inputs(specs):
    def one(t):
        return torch.zeros(t.shape, dtype=t.dtype)
    return {k: (tree_map(one, v) if k == "cache" else one(v))
            for k, v in specs.items()}


def trace_step(model: Model, shape: InputShape, step: str,
               num_pods: int = 2, fed_local_steps: int = 4,
               fed_compression: str = "none") -> Dict[str, float]:
    """Run one step on fake tensors -> global ``{"flops", "hbm_bytes",
    "ops"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        if step == "train":
            state = _fake_state(model)
            batch = _fake_inputs(model.input_specs(shape))
            fn = make_train_step(model, _optimizer(), remat=True)
            run = lambda: fn(state, batch)                      # noqa: E731
        elif step == "fed":
            from repro_torch.core.federated import (
                FedRoundConfig, fed_input_specs, init_fed_state,
                make_fed_round_step,
            )
            fed_cfg = FedRoundConfig(local_steps=fed_local_steps,
                                     compression=fed_compression)
            fed = init_fed_state(_fake_state(model), num_pods, fed_cfg)
            batch = _fake_inputs(fed_input_specs(model, shape, num_pods,
                                                 fed_cfg))
            fn = make_fed_round_step(model, _optimizer(), fed_cfg, num_pods)
            run = lambda: fn(fed, batch)                        # noqa: E731
        elif step == "prefill":
            params = _fake_state(model).params
            batch = _fake_inputs(model.input_specs(shape))
            fn = make_prefill_step(model)
            run = lambda: fn(params, batch)                     # noqa: E731
        elif step == "serve":
            params = _fake_state(model).params
            ins = _fake_inputs(model.input_specs(shape))
            fn = make_serve_step(model, ring=shape.seq_len > 65_536)
            # the position is a traced input, as in the reference
            run = lambda: fn(params, ins["cache"], ins["tokens"],  # noqa: E731
                             ins["pos"])
        else:
            raise ValueError(step)
        traffic = TrafficMode()
        with FlopCounterMode(display=False) as flops, traffic:
            run()
    return {"flops": int(flops.get_total_flops()),
            "hbm_bytes": int(traffic.bytes), "ops": traffic.ops}


def counted(cfg: ArchConfig, shape: InputShape, step: str,
            **kw) -> Tuple[Dict[str, float], List[int]]:
    """The step's global counts at the full depth (``depth_plan``) and the
    depths traced."""
    cfgs, n = depth_plan(cfg)
    got = [trace_step(Model(c), shape, step, **kw) for c in cfgs]
    depths = [c.n_layers for c in cfgs]
    if n is None:
        return got[0], depths
    return {key: float(extrapolate(*(int(t[key]) for t in got), n))
            for key in got[0]}, depths


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


def dryrun(arch: str, shape_name: str, multi_pod: bool = False,
           step: str = "auto", preset: str = "fsdp_tp",
           fed_local_steps: int = 4, fed_compression: str = "none",
           out_dir: Optional[str] = "artifacts/dryrun",
           seq_override: int = 0, extra_tag: str = "") -> dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    model = Model(cfg)
    rules = dict(shr.PRESETS[preset])
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size

    if shape.kind == "decode" and not cfg.supports_long_context \
            and shape.seq_len > 65_536:
        return {"skipped": True, "reason": "long-context unsupported "
                "(full-attention enc-dec)", "arch": arch,
                "shape": shape_name}
    if step == "auto":
        step = {"train": "train", "prefill": "prefill",
                "decode": "serve"}[shape.kind]
    if step == "fed" and not multi_pod:
        raise ValueError("the fed round is the multi-pod technique: "
                         "pass --multi-pod")
    if fed_compression != "none" and step != "fed":
        raise ValueError("--fed-compression applies to --step fed")
    num_pods = mesh.shape.get("pod", 1)

    t0 = time.time()
    with use_mesh(mesh):
        held = per_device_bytes(model, shape, mesh, rules, step,
                                fed_local_steps)
        coll = collective_model(model, shape, mesh, rules, step,
                                fed_local_steps)
        counts, depths = counted(cfg, shape, step, num_pods=num_pods,
                                 fed_local_steps=fed_local_steps,
                                 fed_compression=fed_compression)
    trace_s = time.time() - t0

    mf = model_flops(cfg, shape, text_len=model.text_len(shape))
    rl = Roofline(flops=counts["flops"] / chips,
                  hbm_bytes=counts["hbm_bytes"] / chips,
                  collective_bytes=coll["total_bytes"], chips=chips,
                  model_flops=mf, dcn_bytes=coll["dcn_bytes"])
    cuda_on = torch.cuda.is_initialized()
    record = {
        "arch": arch,
        "shape": shape_name,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": list(mesh.devices_shape),
        "step": step,
        "preset": preset,
        "trace_s": trace_s,
        "traced_depths": depths,
        "per_device_bytes": held,
        "counted": {"flops": counts["flops"],
                    "hbm_bytes": counts["hbm_bytes"],
                    "ops": counts["ops"]},
        "collectives": {
            "bytes_by_op": coll["bytes_by_op"],
            "count_by_op": coll["count_by_op"],
            "total_bytes": coll["total_bytes"],
        },
        "roofline": rl.to_dict(),
        "device": {"cuda_initialized": cuda_on,
                   "bytes_allocated": (torch.cuda.memory_allocated()
                                       if cuda_on else 0)},
    }
    if fed_compression != "none":
        record["fed_compression"] = fed_compression
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"__{extra_tag}" if extra_tag else ""
        fname = (f"{arch}__{shape_name}__{record['mesh']}__{step}__{preset}"
                 f"{tag}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Roofline of one step per (arch x shape x mesh) on "
        "fake tensors: no device memory is used.")
    ap.add_argument("--arch", required=True, choices=list_archs() + ["all"])
    ap.add_argument("--shape", required=True,
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train", "prefill", "serve", "fed"])
    ap.add_argument("--preset", default="fsdp_tp",
                    choices=list(shr.PRESETS))
    ap.add_argument("--fed-local-steps", type=int, default=4)
    ap.add_argument("--fed-compression", default="none",
                    choices=["none", "stc", "int8", "int8_sync"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-override", type=int, default=0)
    ap.add_argument("--moe-impl", default="global",
                    choices=["global", "expert_parallel"])
    args = ap.parse_args(argv)

    if args.moe_impl != "global":
        from repro_torch.models import moe as _moe
        _moe.set_moe_impl(args.moe_impl)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    failed = 0
    for a in archs:
        for s in shapes:
            try:
                rec = dryrun(a, s, multi_pod=args.multi_pod, step=args.step,
                             preset=args.preset,
                             fed_local_steps=args.fed_local_steps,
                             fed_compression=args.fed_compression,
                             out_dir=args.out, extra_tag=args.tag,
                             seq_override=args.seq_override)
                if rec.get("skipped"):
                    print(f"[SKIP] {a} {s}: {rec['reason']}")
                else:
                    r = rec["roofline"]
                    print(f"[OK] {a} {s} {rec['mesh']} {rec['step']} "
                          f"trace={rec['trace_s']:.1f}s "
                          f"compute={r['compute_s']:.3e}s "
                          f"memory={r['memory_s']:.3e}s "
                          f"coll={r['collective_s']:.3e}s "
                          f"dominant={r['dominant']} "
                          f"useful={r['useful_compute_ratio']:.2f}",
                          flush=True)
            except Exception:
                failed += 1
                print(f"[FAIL] {a} {s}")
                traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
