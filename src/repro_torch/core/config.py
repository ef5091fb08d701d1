"""Configuration system.

Two config families live here:

* :class:`Config` — the EasyFL platform configuration consumed by
  ``repro_torch.init(configs)`` (paper §IV-B).  It is a nested dataclass tree that
  can be constructed from plain dicts (the paper's low-code entry point:
  ``easyfl.init({"model": "resnet18"})``) and merged with defaults.

* :class:`ArchConfig` — architecture description for the large-model zoo
  (``repro_torch.configs``), field for field the reference package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Generic dict <-> dataclass plumbing
# ---------------------------------------------------------------------------


def _is_config_dataclass(tp: Any) -> bool:
    return dataclasses.is_dataclass(tp) and isinstance(tp, type)


def from_dict(cls, data: Mapping[str, Any]):
    """Build dataclass ``cls`` from a (possibly partial, nested) dict.

    Unknown keys raise ``KeyError`` — silent typos in experiment configs are
    a classic source of unreproducible results.
    """
    if data is None:
        data = {}
    valid = {f.name: f for f in fields(cls)}
    unknown = set(data) - set(valid)
    if unknown:
        raise KeyError(
            f"unknown config key(s) {sorted(unknown)} for {cls.__name__}; "
            f"valid keys: {sorted(valid)}"
        )
    kwargs = {}
    for name, f in valid.items():
        if name not in data:
            continue
        value = data[name]
        if _is_config_dataclass(f.type if isinstance(f.type, type) else None) and isinstance(value, Mapping):
            value = from_dict(f.type, value)
        elif isinstance(value, Mapping) and _maybe_dataclass_for(f) is not None:
            value = from_dict(_maybe_dataclass_for(f), value)
        kwargs[name] = value
    return cls(**kwargs)


def _maybe_dataclass_for(f: dataclasses.Field):
    """Resolve the dataclass type for fields annotated Optional[SomeConfig]."""
    tp = f.type
    if isinstance(tp, str):
        tp = _TYPE_REGISTRY.get(tp.replace("Optional[", "").replace("]", ""))
    if tp is not None and _is_config_dataclass(tp):
        return tp
    return None


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def merge(cfg, overrides: Mapping[str, Any]):
    """Return a copy of dataclass ``cfg`` with nested ``overrides`` applied."""
    if not overrides:
        return cfg
    updates = {}
    valid = {f.name: f for f in fields(cfg)}
    unknown = set(overrides) - set(valid)
    if unknown:
        raise KeyError(
            f"unknown config key(s) {sorted(unknown)} for {type(cfg).__name__}; "
            f"valid keys: {sorted(valid)}"
        )
    for name, value in overrides.items():
        current = getattr(cfg, name)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[name] = merge(current, value)
        elif isinstance(value, Mapping) and _maybe_dataclass_for(valid[name]) is not None:
            updates[name] = from_dict(_maybe_dataclass_for(valid[name]), value)
        else:
            updates[name] = value
    return dataclasses.replace(cfg, **updates)


# ---------------------------------------------------------------------------
# EasyFL platform configuration (paper §IV)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    """Dataset + statistical-heterogeneity simulation (paper §V-A)."""

    dataset: str = "femnist"          # femnist | shakespeare | cifar10 | registered name
    num_clients: int = 100            # used by flexible datasets (cifar-like)
    partition: str = "iid"            # iid | dir | class | realistic
    dir_alpha: float = 0.5            # Dirichlet concentration for partition="dir"
    classes_per_client: int = 2       # for partition="class"
    unbalanced: bool = False          # lognormal sample-count imbalance
    unbalanced_sigma: float = 1.0
    data_amount: float = 1.0          # fraction of samples used (Fig. 7b)
    batch_size: int = 64              # paper default B=64
    test_batch_size: int = 256
    seed: int = 0
    # Virtual (lazy) populations: "auto" virtualizes synthetic datasets
    # once num_clients exceeds the materialization threshold (10k), "on"
    # forces it, "off" always materializes every partition up front.
    # Virtual clients are generated on demand from (dataset, seed,
    # client index) — cold clients cost zero storage (docs/scale.md).
    virtual: str = "auto"             # auto | on | off
    samples_per_client: int = 0       # virtual datasets: samples per client
    #                                   (0 -> dataset default, 32)


@dataclass(frozen=True)
class ServerConfig:
    rounds: int = 10                  # R
    clients_per_round: int = 10       # C, selected clients per round
    selection: str = "random"         # selection stage strategy
    aggregation: str = "fedavg"       # aggregation stage strategy
    test_every: int = 1
    # Compression stage (server->client direction); "none" | "stc" | "int8"
    compression: str = "none"
    # Server learning rate applied to the aggregated delta:
    # new_params = params + server_lr * delta.  Flows through every engine
    # (sequential aggregation, staged/fused batched apply, async buffer
    # apply) so the engines stay numerically interchangeable.
    server_lr: float = 1.0
    track: bool = True


@dataclass(frozen=True)
class ClientConfig:
    local_epochs: int = 10            # paper default E=10
    optimizer: str = "sgd"            # sgd | adamw
    lr: float = 0.01
    momentum: float = 0.9             # paper: SGD momentum 0.9
    weight_decay: float = 0.0
    nesterov: bool = False            # SGD nesterov momentum
    adam_b1: float = 0.9              # AdamW beta1
    adam_b2: float = 0.999            # AdamW beta2
    adam_eps: float = 1e-8            # AdamW epsilon
    # client->server update compression: "none" | "stc" | "int8"; built-in
    # compressors run in-program on the batched/async fast path (batched
    # kernels + device-resident error feedback, no host gathering)
    compression: str = "none"
    stc_sparsity: float = 0.01        # keep fraction for STC top-k
    #                                   (tile-local per-8192-element budget)
    # FedProx proximal term (0 disables; strategy plugin can override train)
    proximal_mu: float = 0.0
    max_grad_norm: float = 0.0        # 0 = no clipping
    # Fine-tuning mode: "full" trains every parameter; "lora" freezes the
    # base model (replicated once across the cohort) and trains low-rank
    # A/B adapter factors per client — only adapters flow through
    # aggregation/compression/EF-residuals/checkpointing (tiny wire bytes).
    finetune: str = "full"            # full | lora
    lora_rank: int = 8                # adapter rank r (>= 1 under "lora")
    lora_alpha: float = 16.0          # adapter scale: W + (alpha/r)·A@B
    # Substring patterns matched against "/"-joined param paths; () targets
    # every eligible matrix leaf (ndim >= 2 beyond a stacked "layers" axis).
    lora_targets: Tuple[str, ...] = ()


# Per-client-sampleable hyperparameters (``system_heterogeneity.
# hyperparam_choices``): ClientConfig field -> (validator, description).
# Every entry is vectorized by the batched/async cohort program, so sampling
# them per client never forces the sequential path.
def _finite(v) -> bool:
    try:
        import math
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


_HPARAM_VALIDATORS = {
    "lr": (lambda v: _finite(v) and float(v) > 0, "a finite float > 0"),
    "momentum": (lambda v: _finite(v) and 0 <= float(v) < 1,
                 "a finite float in [0, 1)"),
    "weight_decay": (lambda v: _finite(v) and float(v) >= 0,
                     "a finite float >= 0"),
    "nesterov": (lambda v: isinstance(v, (bool, int)) and v in (0, 1, False, True),
                 "a bool"),
    "adam_b1": (lambda v: _finite(v) and 0 <= float(v) < 1,
                "a finite float in [0, 1)"),
    "adam_b2": (lambda v: _finite(v) and 0 <= float(v) < 1,
                "a finite float in [0, 1)"),
    "adam_eps": (lambda v: _finite(v) and float(v) > 0,
                 "a finite float > 0"),
    "proximal_mu": (lambda v: _finite(v) and float(v) >= 0,
                    "a finite float >= 0"),
    "max_grad_norm": (lambda v: _finite(v) and float(v) >= 0,
                      "a finite float >= 0"),
}

SAMPLEABLE_HPARAMS = tuple(_HPARAM_VALIDATORS)


def validate_optimizer_hparams(cfg: "ClientConfig", owner: str = "client"
                               ) -> None:
    """Reject negative/NaN/out-of-range optimizer hyperparameters loudly.

    Called at ``Client`` construction (every execution engine) so a bad
    per-client value — hand-built config or sampled via
    ``system_heterogeneity.hyperparam_choices`` — fails with the offending
    client named instead of producing NaN params mid-round.
    """
    for name, (ok, expected) in _HPARAM_VALIDATORS.items():
        value = getattr(cfg, name)
        if not ok(value):
            raise ValueError(
                f"{owner}: ClientConfig.{name}={value!r} is invalid; "
                f"expected {expected}")


def validate_finetune_config(cfg: "ClientConfig", owner: str = "client"
                             ) -> None:
    """Reject bad fine-tuning knobs loudly at construction time.

    Called from :func:`validate_config` and at ``Client`` construction so a
    bad ``finetune`` / ``lora_rank`` / ``lora_alpha`` / ``lora_targets``
    fails before any cohort program compiles.
    """
    if cfg.finetune not in ("full", "lora"):
        raise ValueError(
            f"{owner}: ClientConfig.finetune={cfg.finetune!r} is invalid; "
            f"expected 'full' or 'lora'")
    if not isinstance(cfg.lora_rank, int) or cfg.lora_rank < 0:
        raise ValueError(
            f"{owner}: ClientConfig.lora_rank={cfg.lora_rank!r} is invalid; "
            f"expected an int >= 0")
    if cfg.finetune == "lora" and cfg.lora_rank < 1:
        raise ValueError(
            f"{owner}: ClientConfig.lora_rank={cfg.lora_rank!r} is invalid "
            f"under finetune='lora'; expected an int >= 1")
    if not _finite(cfg.lora_alpha) or float(cfg.lora_alpha) <= 0:
        raise ValueError(
            f"{owner}: ClientConfig.lora_alpha={cfg.lora_alpha!r} is "
            f"invalid; expected a finite float > 0")
    targets = cfg.lora_targets
    if isinstance(targets, str) or not isinstance(targets, Sequence) \
            or any(not isinstance(t, str) or not t for t in targets):
        raise ValueError(
            f"{owner}: ClientConfig.lora_targets={targets!r} is invalid; "
            f"expected a sequence of non-empty path-substring patterns "
            f"(() targets every eligible matrix leaf)")


def validate_hyperparam_choices(choices) -> None:
    """Validate ``system_heterogeneity.hyperparam_choices`` eagerly.

    ``choices`` maps a sampleable ``ClientConfig`` field to a non-empty
    sequence of candidate values (sampled uniformly per client).  Unknown
    fields — including ``optimizer``, because mixed optimizer *families*
    cannot share one cohort program — and invalid values raise
    ``ValueError`` at init time, not mid-training.
    """
    if not choices:
        return
    if not isinstance(choices, Mapping):
        raise ValueError(
            f"system_heterogeneity.hyperparam_choices must be a mapping of "
            f"ClientConfig field -> sequence of choices, got {choices!r}")
    for name, values in choices.items():
        if name not in _HPARAM_VALIDATORS:
            raise ValueError(
                f"system_heterogeneity.hyperparam_choices: {name!r} is not "
                f"per-client sampleable; allowed: {sorted(SAMPLEABLE_HPARAMS)}"
                + (" (mixed optimizer families cannot share one cohort "
                   "program — partition the federation instead)"
                   if name == "optimizer" else ""))
        if isinstance(values, (str, bytes)) or not isinstance(
                values, Sequence) or len(values) == 0:
            raise ValueError(
                f"system_heterogeneity.hyperparam_choices[{name!r}] must be "
                f"a non-empty sequence of values, got {values!r}")
        ok, expected = _HPARAM_VALIDATORS[name]
        bad = [v for v in values if not ok(v)]
        if bad:
            raise ValueError(
                f"system_heterogeneity.hyperparam_choices[{name!r}] has "
                f"invalid value(s) {bad!r}; expected {expected}")


@dataclass(frozen=True)
class FaultConfig:
    """Seeded client-failure injection (FLGo-style unreliability, §V-A).

    All probabilities are sampled **deterministically per (client, round)**
    by ``repro_torch.simulation.heterogeneity.FaultInjector`` — an FNV-1a hash of
    the coordinate seeds an ``np.random.RandomState`` — so a faulty
    federation replays identically across runs, processes, and
    checkpoint/resume boundaries.  Any non-zero knob activates the fault
    layer (``active``); with every knob at its default the engines are
    byte-identical to a fault-free build (no weight-vector recompute, no
    extra host syncs — gated by ``scripts/check_bench.py``)."""

    dropout_prob: float = 0.0         # client never responds this round
    crash_prob: float = 0.0           # client dies mid-training (partial
    #                                   virtual time elapses, no update)
    straggler_prob: float = 0.0       # client is slowed this round ...
    straggler_slowdown: float = 4.0   # ... by this factor (>= 1)
    nan_update_prob: float = 0.0      # client uploads a corrupted (NaN)
    #                                   update; the server-side guard
    #                                   rejects it by zero-weighting
    max_update_norm: float = 0.0      # norm-outlier guard on each update's
    #                                   global L2 norm (0 = off)
    min_clients_per_round: int = 1    # survivor floor: re-select the cohort
    #                                   (bounded attempts) instead of
    #                                   silently aggregating a tiny one
    max_retries: int = 2              # async: bounded retries per failure
    retry_backoff: float = 1.0        # async: virtual-seconds backoff base,
    #                                   doubled per attempt
    seed: int = 0

    @property
    def active(self) -> bool:
        """True when any injection or guard knob is non-default."""
        return (self.dropout_prob > 0 or self.crash_prob > 0
                or self.straggler_prob > 0 or self.nan_update_prob > 0
                or self.max_update_norm > 0)


def validate_fault_config(cfg: "FaultConfig") -> None:
    """Reject out-of-range fault knobs loudly at ``Trainer`` construction."""
    for name in ("dropout_prob", "crash_prob", "straggler_prob",
                 "nan_update_prob"):
        v = getattr(cfg, name)
        if not _finite(v) or not 0.0 <= float(v) <= 1.0:
            raise ValueError(
                f"faults.{name}={v!r} is invalid; expected a probability "
                f"in [0, 1]")
    if not _finite(cfg.straggler_slowdown) or cfg.straggler_slowdown < 1.0:
        raise ValueError(
            f"faults.straggler_slowdown={cfg.straggler_slowdown!r} is "
            f"invalid; expected a finite factor >= 1")
    if not _finite(cfg.max_update_norm) or cfg.max_update_norm < 0:
        raise ValueError(
            f"faults.max_update_norm={cfg.max_update_norm!r} is invalid; "
            f"expected a finite float >= 0 (0 disables the norm guard)")
    if not isinstance(cfg.min_clients_per_round, int) \
            or cfg.min_clients_per_round < 0:
        raise ValueError(
            f"faults.min_clients_per_round={cfg.min_clients_per_round!r} "
            f"is invalid; expected an int >= 0")
    if not isinstance(cfg.max_retries, int) or cfg.max_retries < 0:
        raise ValueError(
            f"faults.max_retries={cfg.max_retries!r} is invalid; expected "
            f"an int >= 0")
    if not _finite(cfg.retry_backoff) or cfg.retry_backoff < 0:
        raise ValueError(
            f"faults.retry_backoff={cfg.retry_backoff!r} is invalid; "
            f"expected a finite float >= 0")
    if not isinstance(cfg.seed, int):
        raise ValueError(
            f"faults.seed={cfg.seed!r} is invalid; expected an int (it "
            f"seeds the per-(client, round) failure hash)")


@dataclass(frozen=True)
class CheckpointConfig:
    """Periodic atomic checkpoints of the full trainer state
    (``repro_torch.checkpoint.store``): server params, round index, selection
    RNG, heterogeneity speed assignments, error-feedback residuals and any
    FedBuff buffer — everything ``Trainer.resume()`` needs to continue
    bit-identically (synchronous engines) after a kill."""

    every: int = 0                    # checkpoint every N rounds (async:
    #                                   every N buffer aggregations); 0 = off
    dir: str = "artifacts/checkpoints"
    keep: int = 3                     # retained checkpoints (0 = keep all)


def validate_checkpoint_config(cfg: "CheckpointConfig") -> None:
    if not isinstance(cfg.every, int) or cfg.every < 0:
        raise ValueError(
            f"checkpoint.every={cfg.every!r} is invalid; expected an int "
            f">= 0 (0 disables checkpointing)")
    if not isinstance(cfg.keep, int) or cfg.keep < 0:
        raise ValueError(
            f"checkpoint.keep={cfg.keep!r} is invalid; expected an int "
            f">= 0 (0 keeps every checkpoint)")
    if not cfg.dir:
        raise ValueError("checkpoint.dir must be a non-empty path")


@dataclass(frozen=True)
class SystemHeterogeneityConfig:
    """Lightweight system-heterogeneity simulation (paper §V-A)."""

    enabled: bool = False
    # Relative training-speed ratios of simulated device classes, modeled on
    # AI-Benchmark [37] mobile-SoC training-throughput spreads.
    speed_ratios: Tuple[float, ...] = (1.0, 1.53, 2.42, 3.1, 4.4)
    # Optional per-message network latency (seconds) added by the transport.
    network_latency: float = 0.0
    seed: int = 0
    # Per-client optimizer-hyperparameter sampling (optimizer
    # heterogeneity, FLGo-style): maps a ClientConfig field (see
    # SAMPLEABLE_HPARAMS) to a sequence of choices drawn uniformly per
    # client, e.g. {"momentum": (0.0, 0.5, 0.9)}.  Independent of
    # ``enabled`` (which gates the *speed* simulation); every sampleable
    # field is vectorized by the batched/async cohort program.
    hyperparam_choices: Optional[Mapping[str, Sequence]] = None


@dataclass(frozen=True)
class ResourceConfig:
    """Distributed-training optimization (paper §VI).

    ``execution`` selects the client execution engine:

    * ``"sequential"`` — one train step dispatched per client per batch;
      every client and server stage override runs.
    * ``"batched"`` — the whole selected cohort runs as one round program
      (``torch.func.vmap`` over clients around a loop over the bucketed
      local steps, see ``repro_torch.core.batched``).  Requires a uniform
      batch size and optimizer family across the cohort (per-client
      hyperparameters are vectorized).  With default post-train stages and
      FedAvg, built-in ``client.compression`` (stc/int8) runs in-program
      (hand-written CUDA kernels + a device-resident error-feedback store)
      and aggregation consumes the stacked updates directly.
    * ``"async"`` — FedBuff-style overlapping cohorts on a virtual-clock
      event loop (``repro_torch.core.async_engine``): up to
      ``max_concurrency`` clients are in flight at once, each completion
      frees a slot that is refilled at once with the *current* global
      model, and the server aggregates every buffer of ``buffer_size``
      completions with staleness-discounted weights
      (``w_i ∝ n_i / (1+s_i)^staleness_power``).  Each dispatch wave runs
      through the batched engine as one stacked micro-cohort.  Requires
      ``distributed="none"``.

    ``aggregation_kernel`` switches the FedAvg weighted average onto the
    streaming CUDA kernel (``repro_torch.kernels.fedavg_agg``); the default
    ``torch.einsum`` path computes the same sum.

    ``distributed`` shards the batched engine across devices:

    * ``"none"`` — the whole cohort program runs on the trainer's device.
    * ``"data"`` — the stacked client dimension is split over a 1-D client
      mesh, one shard for each entry of ``repro_torch.get_devices()``
      (``repro_torch.set_devices``; a device may repeat), in one process:
      each round copies the params and each shard's rows of the cohort
      data to its device, where local training, compression and fault
      checks run.  Requires ``execution="batched"``; FedAvg then sums
      per-shard partial weighted sums (``repro_torch.kernels.fedavg_agg.
      fedavg_aggregate_sharded``) instead of gathering all N updates on
      one device.
    """

    num_devices: int = 1              # M simulated accelerators
    allocation: str = "greedy_ada"    # greedy_ada | random | slowest | one_per_device
    default_client_time: float = 1.0  # t: default training time before profiling
    momentum: float = 0.5             # m: moving-average momentum for t update
    distributed: str = "none"         # none | data (shard cohort over mesh)
    execution: str = "sequential"     # sequential | batched | async
    aggregation_kernel: bool = False  # FedAvg via the streaming kernel
    # Aggregation reduction topology: "flat" is the single weighted sum;
    # "hierarchical" reduces the cohort through an edge->region->global
    # tree of streaming tiers with aggregation_fanout children per node
    # (one grouped FedAvg-kernel launch a tier under aggregation_kernel).
    # Bit-equal to flat when the fanout covers the whole cohort.
    aggregation_topology: str = "flat"   # flat | hierarchical
    aggregation_fanout: int = 0       # children per tree node (0 = sqrt(N);
    #                                   >= 2 otherwise)
    # --- async (execution="async") knobs ---
    buffer_size: int = 0              # K: aggregate every K completions
    #                                   (0 -> server.clients_per_round)
    max_concurrency: int = 0          # concurrent in-flight clients
    #                                   (0 -> server.clients_per_round)
    staleness_power: float = 0.5      # a in w ∝ 1/(1+staleness)^a (0 = off)
    # Virtual-seconds deadline the server waits for each client's response
    # (0 = wait forever).  Responses slower than the deadline are
    # zero-weighted out of the aggregate (synchronous engines) or treated
    # as failed dispatches (async); the round's virtual makespan is capped
    # at the deadline.  See docs/faults.md.
    round_deadline: float = 0.0
    # Whole-round program fusion on the batched fast path: "auto" fuses
    # train + in-program compression (with EF residual update) + fault
    # mask/guard + FedAvg + server apply into ONE program
    # per round (single dispatch, one batched host fetch) whenever the
    # round is fast-path eligible, the server's apply_delta is not
    # overridden and round_deadline == 0; ineligible rounds fall back to
    # the staged fast path with a one-time warning naming the reason.
    # "off" forces the staged path.  See docs/perf.md.
    round_fusion: str = "auto"        # auto | off


def validate_resource_config(cfg: "ResourceConfig") -> None:
    """Reject unknown engines / out-of-range async knobs at init time.

    Hoisted from ``Trainer.__init__`` so every entry point (including
    config-only tooling) validates identically; messages are unchanged —
    tests match on them.
    """
    if cfg.execution not in ("sequential", "batched", "async"):
        raise ValueError(
            f"unknown execution {cfg.execution!r}; "
            f"expected 'sequential', 'batched' or 'async'")
    if cfg.distributed not in ("none", "data"):
        raise ValueError(
            f"unknown distributed {cfg.distributed!r}; "
            f"expected 'none' or 'data'")
    if cfg.distributed == "data" and cfg.execution != "batched":
        raise ValueError(
            'resources.distributed="data" shards the batched engine; '
            'set resources.execution="batched"')
    if cfg.buffer_size < 0:
        raise ValueError(
            f"resources.buffer_size must be >= 0 (0 = use "
            f"server.clients_per_round), got {cfg.buffer_size}")
    if cfg.max_concurrency < 0:
        raise ValueError(
            f"resources.max_concurrency must be >= 0 (0 = use "
            f"server.clients_per_round), got {cfg.max_concurrency}")
    if cfg.staleness_power < 0:
        raise ValueError(
            f"resources.staleness_power must be >= 0 (0 disables the "
            f"staleness discount), got {cfg.staleness_power}")
    if not _finite(cfg.round_deadline) or cfg.round_deadline < 0:
        raise ValueError(
            f"resources.round_deadline must be a finite float >= 0 "
            f"(0 = wait forever), got {cfg.round_deadline}")
    if cfg.aggregation_topology not in ("flat", "hierarchical"):
        raise ValueError(
            f"unknown aggregation_topology {cfg.aggregation_topology!r}; "
            f"expected 'flat' or 'hierarchical'")
    if cfg.aggregation_fanout < 0 or cfg.aggregation_fanout == 1:
        raise ValueError(
            f"resources.aggregation_fanout must be 0 (auto, ~sqrt(N)) or "
            f">= 2, got {cfg.aggregation_fanout}")
    if cfg.round_fusion not in ("auto", "off"):
        raise ValueError(
            f"unknown round_fusion {cfg.round_fusion!r}; "
            f"expected 'auto' or 'off'")


@dataclass(frozen=True)
class TrackingConfig:
    enabled: bool = True
    backend: str = "memory"           # memory | jsonl
    out_dir: str = "artifacts/tracking"
    # Bound on in-memory per-client metric rows: keep client-level rows
    # for only the most recent N rounds (round-level metrics are always
    # retained).  0 = unbounded — fine for small federations; set a bound
    # for million-client populations so tracking stays O(cohort).
    client_history_rounds: int = 0
    # Per-round timing boundary.  True (default) blocks on the round's
    # device work before stamping wall time, so the virtual clock and
    # per-round wall metrics are exact.  False skips the block on fused
    # rounds and defers the metric fetch one round, overlapping round R's
    # device->host fetch with round R+1's dispatch; wall_time then measures
    # submission, not execution, and scheduler speed profiles lag one
    # round.  Rejected when the fault layer or round_deadline is active
    # (both need the exact clock).  See docs/perf.md.
    round_sync: bool = True


@dataclass(frozen=True)
class Config:
    """Top-level EasyFL configuration (``repro_torch.init``)."""

    task_id: str = "task"
    model: str = "femnist_cnn"        # registered model name
    seed: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    system_heterogeneity: SystemHeterogeneityConfig = field(
        default_factory=SystemHeterogeneityConfig
    )
    resources: ResourceConfig = field(default_factory=ResourceConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    faults: FaultConfig = field(default_factory=FaultConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    @staticmethod
    def make(overrides: Optional[Mapping[str, Any]] = None) -> "Config":
        return merge(Config(), overrides or {})


def validate_config(cfg: "Config") -> None:
    """Validate the whole configuration tree (called by ``Trainer``).

    One entry point touching every ``Config`` section so a bad value fails
    loudly at construction, not mid-training.  Section validators are
    idempotent — components that re-validate defensively (``Client``,
    ``FaultInjector``) raise the same messages.
    """
    if not isinstance(cfg.task_id, str) or not cfg.task_id:
        raise ValueError(
            f"task_id={cfg.task_id!r} is invalid; expected a non-empty "
            f"string")
    if not isinstance(cfg.model, str) or not cfg.model:
        raise ValueError(
            f"model={cfg.model!r} is invalid; expected a registered model "
            f"name")
    if not isinstance(cfg.seed, int):
        raise ValueError(f"seed={cfg.seed!r} is invalid; expected an int")
    if cfg.data.num_clients < 1:
        raise ValueError(
            f"data.num_clients={cfg.data.num_clients!r} is invalid; "
            f"expected an int >= 1")
    if cfg.data.batch_size < 1:
        raise ValueError(
            f"data.batch_size={cfg.data.batch_size!r} is invalid; "
            f"expected an int >= 1")
    if cfg.data.virtual not in ("auto", "on", "off"):
        raise ValueError(
            f"data.virtual={cfg.data.virtual!r} is invalid; expected "
            f"'auto', 'on' or 'off'")
    if cfg.data.samples_per_client < 0:
        raise ValueError(
            f"data.samples_per_client={cfg.data.samples_per_client!r} is "
            f"invalid; expected an int >= 0 (0 = dataset default)")
    if cfg.tracking.client_history_rounds < 0:
        raise ValueError(
            f"tracking.client_history_rounds="
            f"{cfg.tracking.client_history_rounds!r} is invalid; expected "
            f"an int >= 0 (0 = unbounded)")
    if cfg.server.rounds < 0:
        raise ValueError(
            f"server.rounds={cfg.server.rounds!r} is invalid; expected an "
            f"int >= 0")
    if cfg.server.clients_per_round < 1:
        raise ValueError(
            f"server.clients_per_round={cfg.server.clients_per_round!r} "
            f"is invalid; expected an int >= 1")
    if not cfg.tracking.out_dir:
        raise ValueError("tracking.out_dir must be a non-empty path")
    if not isinstance(cfg.tracking.round_sync, bool):
        raise ValueError(
            f"tracking.round_sync={cfg.tracking.round_sync!r} is invalid; "
            f"expected a bool")
    if not _finite(cfg.server.server_lr) or float(cfg.server.server_lr) <= 0:
        raise ValueError(
            f"server.server_lr={cfg.server.server_lr!r} is invalid; "
            f"expected a finite float > 0")
    if not cfg.tracking.round_sync and (
            cfg.faults.active or cfg.resources.round_deadline > 0):
        raise ValueError(
            "tracking.round_sync=False defers the per-round metric fetch "
            "and cannot be combined with fault injection or "
            "resources.round_deadline — both need the exact virtual clock "
            "(see docs/perf.md)")
    validate_optimizer_hparams(cfg.client)
    validate_finetune_config(cfg.client)
    validate_hyperparam_choices(cfg.system_heterogeneity.hyperparam_choices)
    validate_resource_config(cfg.resources)
    validate_fault_config(cfg.faults)
    validate_checkpoint_config(cfg.checkpoint)


# ---------------------------------------------------------------------------
# Architecture configuration (model zoo)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8                # routed experts
    top_k: int = 2
    n_shared: int = 0                 # always-on shared experts
    d_expert: int = 0                 # per-expert FFN hidden dim
    aux_loss_weight: float = 0.01     # router load-balance loss
    first_dense_layers: int = 0       # leading layers that use a dense FFN
    dense_d_ff: int = 0               # FFN dim for those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 = no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str = "arch"
    family: str = "dense"             # dense | moe | ssm | hybrid | vlm | audio
    reference: str = ""               # citation for the hyperparameters
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000
    act: str = "swiglu"               # swiglu | geglu | gelu | sq_relu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    qk_norm: bool = False             # per-head RMSNorm on q,k (Qwen3)
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"       # rope | learned | none
    tie_embeddings: bool = False
    max_seq_len: int = 524_288        # positional capacity for dry-run shapes

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # ssm (rwkv6)
    rwkv_head_dim: int = 64

    # hybrid (recurrentgemma): per-layer mixer pattern, cycled over n_layers
    block_pattern: Tuple[str, ...] = ()   # entries: "attn" | "rglru" | "local_attn"
    window: int = 0                    # local-attention window (training)
    lru_width: int = 0                 # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4              # temporal conv in recurrent block

    # enc-dec / multimodal stubs
    encoder_layers: int = 0            # >0 -> encoder-decoder (whisper)
    n_frames: int = 0                  # audio frames / vision patches (stub input)

    # decode behaviour
    decode_window: int = 8192          # sliding-window KV for long_500k decode
    supports_long_context: bool = True # False -> skip long_500k (noted in DESIGN.md)

    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"

    # ---------------- derived helpers ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Mixer type for every layer."""
        if self.family == "ssm":
            return ("rwkv6",) * self.n_layers
        if self.block_pattern:
            pat = []
            i = 0
            while len(pat) < self.n_layers:
                pat.append(self.block_pattern[i % len(self.block_pattern)])
                i += 1
            return tuple(pat)
        if self.mla is not None:
            return ("mla",) * self.n_layers
        return ("attn",) * self.n_layers

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep the q:kv grouping ratio >= 1 and divisible
        while n_heads % n_kv:
            n_kv -= 1
        head_dim = 32 if self.head_dim else 0
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_expert=min(self.moe.d_expert or 128, 128),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_d_ff=min(self.moe.dense_d_ff or 256, 256),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(
                kv_lora_rank=64, q_lora_rank=0,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 if not self.encoder_layers else 2,
            encoder_layers=2 if self.encoder_layers else 0,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            moe=moe,
            mla=mla,
            window=min(self.window, 64) if self.window else 0,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            max_seq_len=4096,
            decode_window=256,
            dtype="float32",
        )

    # Parameter count (approximate, used for MODEL_FLOPS = 6·N·D)
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for mixer in self.layer_pattern:
            if mixer == "attn" or mixer == "local_attn":
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                per_layer += q + kv + o
            elif mixer == "mla":
                m = self.mla
                per_layer += d * m.kv_lora_rank            # kv down
                per_layer += d * m.qk_rope_head_dim        # shared k rope
                per_layer += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)     # kv up
                qd = m.q_lora_rank or d
                if m.q_lora_rank:
                    per_layer += d * m.q_lora_rank
                per_layer += qd * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            elif mixer == "rwkv6":
                per_layer += 6 * d * d // 1 + 2 * d * 32   # r,k,v,g,o + decay lora (approx)
            elif mixer == "rglru":
                w = self.lru_width or d
                per_layer += 2 * d * w + w * d + w * self.conv1d_width  # in-proj x2, out, conv
                per_layer += 2 * w                          # gates (diag recurrence params)
        # FFN
        for li, mixer in enumerate(self.layer_pattern):
            if self.moe is not None:
                if li < self.moe.first_dense_layers:
                    ff = self.moe.dense_d_ff or self.d_ff
                    mult = 3 if self.act in ("swiglu", "geglu") else 2
                    per_layer_ffn = mult * d * ff
                else:
                    de = self.moe.d_expert or self.d_ff
                    mult = 3 if self.act in ("swiglu", "geglu") else 2
                    n_routed = self.moe.top_k if active_only else self.moe.n_experts
                    per_layer_ffn = (n_routed + self.moe.n_shared) * mult * d * de
                    per_layer_ffn += d * self.moe.n_experts  # router
            else:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                per_layer_ffn = mult * d * self.d_ff
            per_layer += per_layer_ffn
        enc = 0
        if self.encoder_layers:
            # encoder self-attn + ffn + decoder cross-attn already included via
            # layer_pattern for decoder; approximate encoder similarly
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            enc_layer = 4 * d * d + mult * d * self.d_ff
            enc = self.encoder_layers * enc_layer
            enc += self.n_layers * 4 * d * d  # cross-attention per decoder layer
        return emb + per_layer + enc


_TYPE_REGISTRY = {
    "DataConfig": DataConfig,
    "ServerConfig": ServerConfig,
    "ClientConfig": ClientConfig,
    "SystemHeterogeneityConfig": SystemHeterogeneityConfig,
    "ResourceConfig": ResourceConfig,
    "TrackingConfig": TrackingConfig,
    "FaultConfig": FaultConfig,
    "CheckpointConfig": CheckpointConfig,
    "MoEConfig": MoEConfig,
    "MLAConfig": MLAConfig,
}
