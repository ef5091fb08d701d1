"""Layer 2: contracts of the port's round programs.

The twin of the reference's ``repro.analysis.contracts``.  It builds a
small, fixed-shape federation (4 clients, linear model) through the
production program factories and checks four properties:

* **build budget** — exactly one build of the cohort program
  (:func:`repro_torch.core.batched.make_cohort_program`), of the rank-2
  LoRA cohort program, of the hierarchical aggregation's tree plan (16 x
  256, fanout 4; ``kernels.fedavg_agg.tree_trace_count``) and of the fused
  round program (``make_round_program``), and none across a second round.
  The port runs eagerly, so a "trace" is a build of the program a cache
  key holds: the counters are ``cohort_trace_count``, ``tree_trace_count``
  and ``round_trace_count``;
* **no host transfers** — each program runs under :class:`HostSyncMode`,
  which records every aten op that makes the host wait for the device
  (``HOST_TRANSFER_OPS``, a boolean-mask index, a copy to the CPU).  On
  a CUDA device each program is also captured as a CUDA graph
  (``core.batched.CapturedRound``: the capture fails on a synchronizing
  call) and replayed under ``torch.cuda.set_sync_debug_mode("error")``;
* **roofline ratchet** — FLOPs (``torch.utils.flop_counter``) and HBM
  bytes (``launch.dryrun.TrafficMode``: each eager op reads its inputs
  and writes its outputs once) of one cohort program call and one fused
  round must stay within ``tolerance`` (default 15%) of
  ``scripts/roofline_baseline_torch.json``.  Both are counted on CPU
  tensors whatever the device: they count the program's ops, which the
  device does not change.  The FLOPs equal the reference's HLO counts;
  eager-op traffic is not XLA's fused traffic, so the bytes have a
  baseline of their own.  ``flcheck_torch --contracts --update-baseline``
  re-records it after an intentional program change;
* **executor** — a fused round through ``BatchedExecutor.
  run_round_fused`` is one dispatch and one host sync; on a CUDA device
  the bucket is captured once (in the round after its eager warm-up),
  never recaptured, and each later round is one replay.  The staged
  path's cohort through ``BatchedExecutor.run_cohort_stacked`` likewise:
  one dispatch and one host sync a call; on a CUDA device an eager call
  0, then one capture, no recapture and one replay a call.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: aten ops whose result the host must wait for: a scalar read, and ops
#: whose output size depends on the data (the device computes it, the
#: host reads it back to allocate)
HOST_TRANSFER_OPS = ("aten._local_scalar_dense", "aten.nonzero",
                     "aten.masked_select", "aten._unique", "aten._unique2",
                     "aten.unique_dim", "aten.unique_consecutive",
                     "aten.unique_dim_consecutive", "aten.bincount")
#: ops that index with a boolean mask (a hidden ``nonzero``)
_MASK_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_",
                   "aten._index_put_impl_")
#: copies, flagged when they land on the CPU from another device
_COPY_OPS = ("aten._to_copy", "aten.copy_")

#: one build per (bucket, hetero-family) combination of the federation
TRACE_BUDGET = 1
TOLERANCE = 0.15
BASELINE_RELPATH = os.path.join("scripts", "roofline_baseline_torch.json")

# fixed tiny-federation shapes (changing these invalidates the baseline)
N_CLIENTS = 4
LOCAL_STEPS = 4
BATCH = 8
DIN = 16
CLASSES = 4
POOL_ROWS = 32


@dataclass
class ContractReport:
    device: str = "cpu"
    traces_first_round: int = 0
    retraces: int = 0
    trace_budget: int = TRACE_BUDGET
    host_transfer_ops: List[str] = field(default_factory=list)
    lora_traces_first_round: int = 0
    lora_retraces: int = 0
    lora_host_transfer_ops: List[str] = field(default_factory=list)
    tree_traces_first_round: int = 0
    tree_retraces: int = 0
    tree_host_transfer_ops: List[str] = field(default_factory=list)
    fused_traces_first_round: int = 0
    fused_retraces: int = 0
    fused_host_transfer_ops: List[str] = field(default_factory=list)
    fused_dispatches_per_round: int = 0
    fused_host_syncs_per_round: int = 0
    fused_captures: Optional[int] = None        # CUDA only
    fused_recaptures: Optional[int] = None
    fused_replays_per_round: Optional[int] = None
    cohort_dispatches_per_call: int = 0
    cohort_host_syncs_per_call: int = 0
    cohort_captures: Optional[int] = None       # CUDA only
    cohort_recaptures: Optional[int] = None
    cohort_replays_per_call: Optional[int] = None
    fused_flops: float = 0.0
    fused_hbm_bytes: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    baseline: Optional[Dict] = None
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def format(self) -> str:
        lines = [
            f"contracts: device {self.device}",
            f"contracts: cohort builds={self.traces_first_round} "
            f"(budget {self.trace_budget}), rebuilds={self.retraces}",
            f"contracts: host transfer ops: "
            f"{self.host_transfer_ops or 'none'}",
            f"contracts: lora cohort builds={self.lora_traces_first_round} "
            f"(budget {self.trace_budget}), "
            f"rebuilds={self.lora_retraces}, host transfer ops: "
            f"{self.lora_host_transfer_ops or 'none'}",
            f"contracts: hierarchical aggregation "
            f"builds={self.tree_traces_first_round} "
            f"(budget {self.trace_budget}), "
            f"rebuilds={self.tree_retraces}, host transfer ops: "
            f"{self.tree_host_transfer_ops or 'none'}",
            f"contracts: fused round builds={self.fused_traces_first_round} "
            f"(budget {self.trace_budget}), "
            f"rebuilds={self.fused_retraces}, "
            f"dispatches/round={self.fused_dispatches_per_round}, "
            f"host syncs/round={self.fused_host_syncs_per_round}, "
            f"host transfer ops: "
            f"{self.fused_host_transfer_ops or 'none'}",
        ]
        if self.fused_captures is not None:
            lines.append(
                f"contracts: fused round CUDA graph captures="
                f"{self.fused_captures}, recaptures={self.fused_recaptures}, "
                f"replays/round={self.fused_replays_per_round}")
        lines.append(
            f"contracts: staged cohort dispatches/call="
            f"{self.cohort_dispatches_per_call}, host syncs/call="
            f"{self.cohort_host_syncs_per_call}")
        if self.cohort_captures is not None:
            lines.append(
                f"contracts: staged cohort CUDA graph captures="
                f"{self.cohort_captures}, recaptures="
                f"{self.cohort_recaptures}, replays/call="
                f"{self.cohort_replays_per_call}")
        lines += [
            f"contracts: fused round program flops={self.fused_flops:.3e} "
            f"hbm_bytes={self.fused_hbm_bytes:.3e}",
            f"contracts: round program flops={self.flops:.3e} "
            f"hbm_bytes={self.hbm_bytes:.3e}",
        ]
        if self.baseline:
            lines.append(
                f"contracts: baseline flops={self.baseline['flops']:.3e} "
                f"hbm_bytes={self.baseline['hbm_bytes']:.3e} "
                f"(tolerance {self.baseline.get('tolerance', TOLERANCE)})")
        for v in self.violations:
            lines.append(f"contracts: VIOLATION: {v}")
        lines.append("contracts: " + ("ok" if self.ok else "FAILED"))
        return "\n".join(lines)


class HostSyncMode(TorchDispatchMode):
    """Records, in ``found``, every op of the program it wraps that makes
    the host wait for the device: the ops of ``HOST_TRANSFER_OPS``, an
    index or index-put with a boolean mask, and a copy onto the CPU from
    another device.  The ops still run."""

    def __init__(self):
        super().__init__()
        self.found: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        out = func(*args, **kwargs)
        if name in HOST_TRANSFER_OPS:
            self.found.append(name)
        elif name in _MASK_INDEX_OPS and len(args) > 1 and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] or ())):
            self.found.append(f"{name} (boolean mask)")
        elif name in _COPY_OPS:
            dst = out if name == "aten._to_copy" else args[0]
            src = args[0] if name == "aten._to_copy" else args[1]
            if isinstance(src, torch.Tensor) and dst.device.type == "cpu" \
                    and src.device.type != "cpu":
                self.found.append(f"{name} ({src.device} -> cpu)")
        return out


def default_baseline_path() -> str:
    from repro_torch.analysis.lint import find_root
    return os.path.join(find_root(os.path.dirname(__file__)),
                        BASELINE_RELPATH)


def _fixed_inputs(model, device: torch.device):
    """Deterministic stacked inputs for the fixed tiny federation on
    ``device``: ``(optimizer, args)``, ``args()`` a fresh tuple ``(stacked
    params, x, y, idx, n_steps, vec, global params)`` each call."""
    from repro_torch.core.batched import CohortVectors
    from repro_torch.core.config import ClientConfig
    from repro_torch.optim import hparams_from_config, sgd_traced
    from repro_torch.utils.tree import tree_map

    params = model.init(torch.Generator().manual_seed(0), device)
    _, hp0 = hparams_from_config(ClientConfig(lr=0.1))
    hp = type(hp0)(*(np.full((N_CLIENTS,), getattr(hp0, f), np.float32)
                     for f in type(hp0)._fields))
    vec = tree_map(lambda a: torch.as_tensor(a, device=device),
                   CohortVectors(mu=np.zeros((N_CLIENTS,), np.float32),
                                 max_norm=np.zeros((N_CLIENTS,), np.float32),
                                 hp=hp))
    opt = sgd_traced(use_momentum=True, use_nesterov=False)

    rng = np.random.RandomState(0)
    x = rng.randn(N_CLIENTS, POOL_ROWS, DIN).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(N_CLIENTS, POOL_ROWS)).astype(np.int64)
    idx = rng.randint(0, POOL_ROWS,
                      size=(N_CLIENTS, LOCAL_STEPS, BATCH)).astype(np.int64)
    n_steps = np.full((N_CLIENTS,), LOCAL_STEPS, np.int64)
    host = [torch.as_tensor(a, device=device) for a in (x, y, idx, n_steps)]

    def args():
        stacked = tree_map(
            lambda p: p.unsqueeze(0).expand((N_CLIENTS,) + tuple(p.shape))
            .clone(), params)
        return (stacked, *host, vec, params)

    return opt, args


def _fused_args(args):
    """The fused round's arguments (method "none", no faults) from the
    cohort program's."""
    from repro_torch.core.aggregation import fedavg_weights

    a = args()
    dev = a[1].device
    weights = torch.as_tensor(fedavg_weights([1] * N_CLIENTS),
                              dtype=torch.float32, device=dev)
    return (a[6], a[1], a[2], a[3], a[4], a[5], weights, None, None, (),
            torch.zeros((N_CLIENTS,), dtype=torch.int64, device=dev))


def _host_transfers(fn, *args) -> List[str]:
    with HostSyncMode() as mode:
        fn(*args)
    return mode.found


def _capture_problems(fn, args, device: torch.device) -> List[str]:
    """On a CUDA device: capture ``fn(*args)`` as a CUDA graph and replay
    it under the sync debug mode "error" -> what failed (empty: nothing)."""
    if device.type != "cuda":
        return []
    from repro_torch.core.batched import CapturedRound

    try:
        CapturedRound(lambda a: fn(*a), args, device)(args)
        torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 - reported as a violation
        return [f"CUDA graph: {type(e).__name__}: {e}"]
    return []


def _budget(report: ContractReport, what: str, first: int, again: int,
            trace_budget: int) -> None:
    if first > trace_budget:
        report.violations.append(
            f"build budget ({what}): {first} build(s) for one "
            f"(bucket, hetero-family) combination, budget is {trace_budget}")
    if again != 0:
        report.violations.append(
            f"build budget ({what}): {again} rebuild(s) across rounds at "
            f"fixed shapes (expected 0)")


def _costs(fn, *args):
    """(FLOPs, HBM bytes) of one eager call."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import TrafficMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    with TrafficMode() as tm:
        fn(*args)
    return float(fc.get_total_flops()), float(tm.bytes)


def check_contracts(baseline_path: Optional[str] = None,
                    update_baseline: bool = False,
                    trace_budget: int = TRACE_BUDGET,
                    tolerance: float = TOLERANCE,
                    device=None) -> ContractReport:
    """Build the programs of the fixed federation on ``device`` (default:
    the port's, ``repro_torch.kernels.ops.get_device``) and check the four
    contracts.

    ``update_baseline=True`` rewrites the roofline baseline instead of
    gating against it (the re-baseline path after an intentional program
    change).  Returns a :class:`ContractReport`; ``report.ok`` is the
    gate verdict."""
    from repro_torch.core import batched
    from repro_torch.core.client import Client
    from repro_torch.core.config import ClientConfig
    from repro_torch.data.fed_data import ClientData
    from repro_torch.kernels import fedavg_agg
    from repro_torch.kernels.ops import get_device
    from repro_torch.models.lora import lora_wrap
    from repro_torch.models.small import linear_model

    device = torch.device(get_device() if device is None else device)
    report = ContractReport(device=str(device), trace_budget=trace_budget)
    model = linear_model(din=DIN, classes=CLASSES)
    opt, args = _fixed_inputs(model, device)

    def build_twice(make, counter, run):
        """Build and run two rounds, each through ``make`` as the
        executor calls it -> (builds in round 1, in round 2, program)."""
        t0 = counter()
        program = make()
        run(program)
        first = counter() - t0
        program = make()
        run(program)
        return first, counter() - t0 - first, program

    # (a), (b): the cohort program.  Fresh caches: the budget counts builds
    # of THIS federation, whatever else the process built before
    def cohort_maker(m):
        return lambda: batched.make_cohort_program(m, opt, LOCAL_STEPS,
                                                   use_prox=False,
                                                   use_clip=False)

    batched.make_cohort_program.cache_clear()
    first, again, program = build_twice(
        cohort_maker(model), batched.cohort_trace_count,
        lambda p: p(*args()))
    report.traces_first_round, report.retraces = first, again
    _budget(report, "cohort", first, again, trace_budget)
    report.host_transfer_ops = (_host_transfers(program, *args())
                                + _capture_problems(program, args(), device))
    if report.host_transfer_ops:
        report.violations.append(
            "host transfers in the cohort program: "
            + ", ".join(report.host_transfer_ops))

    # the same contracts on the LoRA-adapter cohort program (structure
    # only: the roofline ratchet below holds the base program alone)
    lmodel = lora_wrap(model, model.init(torch.Generator().manual_seed(0),
                                         device), rank=2)
    _, largs = _fixed_inputs(lmodel, device)
    first, again, lprogram = build_twice(
        cohort_maker(lmodel), batched.cohort_trace_count,
        lambda p: p(*largs()))
    report.lora_traces_first_round, report.lora_retraces = first, again
    _budget(report, "lora", first, again, trace_budget)
    report.lora_host_transfer_ops = (
        _host_transfers(lprogram, *largs())
        + _capture_problems(lprogram, largs(), device))
    if report.lora_host_transfer_ops:
        report.violations.append(
            "host transfers in the lora cohort program: "
            + ", ".join(report.lora_host_transfer_ops))

    # hierarchical aggregation: the tree of grouped K1 launches, one plan
    # for a fixed (cohort, fanout), none across rounds
    agg_rng = np.random.RandomState(1)
    agg_u = torch.as_tensor(agg_rng.randn(16, 256).astype(np.float32),
                            device=device)
    agg_w = torch.full((16,), 1.0 / 16, dtype=torch.float32, device=device)

    def tree(u, w):
        return fedavg_agg.fedavg_aggregate_tree(u, w, fanout=4,
                                                use_kernel=True)

    fedavg_agg._tree_plan.cache_clear()
    first, again, _ = build_twice(lambda: tree, fedavg_agg.tree_trace_count,
                                  lambda p: p(agg_u, agg_w))
    report.tree_traces_first_round, report.tree_retraces = first, again
    _budget(report, "hierarchical agg", first, again, trace_budget)
    report.tree_host_transfer_ops = (
        _host_transfers(tree, agg_u, agg_w)
        + _capture_problems(tree, (agg_u, agg_w), device))
    if report.tree_host_transfer_ops:
        report.violations.append(
            "host transfers in the hierarchical aggregation: "
            + ", ".join(report.tree_host_transfer_ops))

    # whole-round fusion (resources.round_fusion="auto"): the one program
    # of a round — train, (compression), fault weighting, FedAvg, server
    # apply
    def round_maker():
        return batched.make_round_program(model, opt, LOCAL_STEPS,
                                          use_prox=False, use_clip=False)

    batched.make_round_program.cache_clear()
    first, again, fprogram = build_twice(
        round_maker, batched.round_trace_count,
        lambda p: p(*_fused_args(args)))
    report.fused_traces_first_round, report.fused_retraces = first, again
    _budget(report, "fused round", first, again, trace_budget)
    report.fused_host_transfer_ops = (
        _host_transfers(fprogram, *_fused_args(args))
        + _capture_problems(fprogram, _fused_args(args), device))
    if report.fused_host_transfer_ops:
        report.violations.append(
            "host transfers in the fused round program: "
            + ", ".join(report.fused_host_transfer_ops))

    # executor level: a fused round is ONE dispatch + ONE batched fetch; on
    # a CUDA device one capture for the bucket and one replay a round
    ex_rng = np.random.RandomState(2)
    ex_clients = [
        Client(f"c{i}", model,
               ClientData(ex_rng.randn(POOL_ROWS, DIN).astype(np.float32),
                          ex_rng.randint(0, CLASSES, POOL_ROWS)
                          .astype(np.int32)),
               ClientConfig(lr=0.1, local_epochs=1), batch_size=BATCH)
        for i in range(N_CLIENTS)]
    executor = batched.BatchedExecutor(model, device)
    gen = torch.Generator().manual_seed(0)
    counts = []
    for r in range(3):           # round 0 warms up (captures on round 1)
        n0 = (batched.dispatch_count(), batched.host_sync_count(),
              batched.round_capture_count(), batched.round_replay_count())
        executor.run_round_fused(ex_clients, model.init(gen, device),
                                 round_id=r)
        counts.append([b - a for a, b in zip(n0, (
            batched.dispatch_count(), batched.host_sync_count(),
            batched.round_capture_count(), batched.round_replay_count()))])
    report.fused_dispatches_per_round = counts[1][0]
    report.fused_host_syncs_per_round = counts[1][1]
    if report.fused_dispatches_per_round != 1:
        report.violations.append(
            f"fused round dispatch count: "
            f"{report.fused_dispatches_per_round} (expected exactly 1)")
    if report.fused_host_syncs_per_round != 1:
        report.violations.append(
            f"fused round host-sync count: "
            f"{report.fused_host_syncs_per_round} (expected exactly 1 "
            f"batched device->host fetch)")
    if executor.capture:          # a CUDA device: the rounds are graphs
        report.fused_captures = sum(c[2] for c in counts)
        report.fused_recaptures = counts[2][2]
        report.fused_replays_per_round = counts[2][3]
        if (report.fused_captures, report.fused_recaptures,
                report.fused_replays_per_round,
                counts[0][2] + counts[0][3]) != (1, 0, 1, 0):
            report.violations.append(
                f"fused round CUDA graph: {report.fused_captures} "
                f"capture(s), {report.fused_recaptures} recapture(s), "
                f"{report.fused_replays_per_round} replay(s) a round, "
                f"round 0 captured or replayed {counts[0][2:]} (expected "
                f"an eager round 0, then 1 capture, 0 recaptures and 1 "
                f"replay a round)")

    # the staged path's cohort (the program of every async wave too): one
    # dispatch and one host sync a call; on a CUDA device the bucket
    # captured once, in the call after its eager warm-up, then one replay
    # a call
    counts = []
    for r in range(3):
        n0 = (batched.dispatch_count(), batched.host_sync_count(),
              batched.cohort_capture_count(), batched.cohort_replay_count())
        executor.run_cohort_stacked(ex_clients, model.init(gen, device), r)
        counts.append([b - a for a, b in zip(n0, (
            batched.dispatch_count(), batched.host_sync_count(),
            batched.cohort_capture_count(), batched.cohort_replay_count()))])
    report.cohort_dispatches_per_call = counts[1][0]
    report.cohort_host_syncs_per_call = counts[1][1]
    if (report.cohort_dispatches_per_call,
            report.cohort_host_syncs_per_call) != (1, 1):
        report.violations.append(
            f"staged cohort: {report.cohort_dispatches_per_call} "
            f"dispatch(es), {report.cohort_host_syncs_per_call} host "
            f"sync(s) a call (expected exactly 1 and 1)")
    if executor.capture:
        report.cohort_captures = sum(c[2] for c in counts)
        report.cohort_recaptures = counts[2][2]
        report.cohort_replays_per_call = counts[2][3]
        if (report.cohort_captures, report.cohort_recaptures,
                report.cohort_replays_per_call,
                counts[0][2] + counts[0][3]) != (1, 0, 1, 0):
            report.violations.append(
                f"staged cohort CUDA graph: {report.cohort_captures} "
                f"capture(s), {report.cohort_recaptures} recapture(s), "
                f"{report.cohort_replays_per_call} replay(s) a call, call 0 "
                f"captured or replayed {counts[0][2:]} (expected an eager "
                f"call 0, then 1 capture, 0 recaptures and 1 replay a call)")

    # (c): the cost model, on CPU tensors
    cpu = torch.device("cpu")
    _, cargs = _fixed_inputs(model, cpu)
    report.flops, report.hbm_bytes = _costs(
        cohort_maker(model)(), *cargs())
    report.fused_flops, report.fused_hbm_bytes = _costs(
        round_maker(), *_fused_args(cargs))

    path = baseline_path or default_baseline_path()
    if update_baseline:
        baseline = {
            "flops": report.flops,
            "hbm_bytes": report.hbm_bytes,
            "fused_flops": report.fused_flops,
            "fused_hbm_bytes": report.fused_hbm_bytes,
            "tolerance": tolerance,
            "program": {
                "model": f"linear(din={DIN}, classes={CLASSES})",
                "clients": N_CLIENTS, "local_steps": LOCAL_STEPS,
                "batch": BATCH,
            },
            "torch": torch.__version__,
        }
        with open(path, "w") as f:
            json.dump(baseline, f, indent=1)
            f.write("\n")
        report.baseline = baseline
        return report

    if not os.path.exists(path):
        report.violations.append(
            f"no roofline baseline at {path}; record one with "
            f"'flcheck_torch --contracts --update-baseline'")
        return report
    with open(path) as f:
        report.baseline = json.load(f)
    tol = report.baseline.get("tolerance", tolerance)
    for key in ("flops", "hbm_bytes", "fused_flops", "fused_hbm_bytes"):
        value = getattr(report, key)
        base = report.baseline.get(key, 0.0)
        if base and value > base * (1.0 + tol):
            report.violations.append(
                f"roofline ratchet: round-program {key} {value:.3e} exceeds "
                f"baseline {base:.3e} by more than {tol:.0%} — shrink the "
                f"program or re-baseline with an explanation "
                f"(--update-baseline)")
    return report
