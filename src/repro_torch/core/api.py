"""EasyFL interface layer (paper §IV, Table II) — the low-code API.

Three lines for a federated run on the ported fused batched round:

    import repro_torch as easyfl
    easyfl.init({"model": "femnist_cnn", "dataset": "femnist",
                 "resources": {"execution": "batched"}})
    easyfl.run()

Entry points run on CUDA; ``repro_torch.set_device("cpu")`` opts into the
CPU, and without a CUDA device and without that call ``init`` raises.

Categories:
  initialization — ``init(configs)``
  registration   — ``register_dataset`` / ``register_model`` /
                   ``register_server`` / ``register_client``
  execution      — ``run(callback)`` / ``start_server`` / ``start_client``
                   (remote training over sockets, ``core/remote.py``)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.client import Client
from repro_torch.core.config import Config
from repro_torch.core.rounds import Trainer
from repro_torch.core.server import Server
from repro_torch.data.fed_data import (
    ClientData, FederatedDataset, VirtualFederatedDataset,
    build_federated_data,
)
from repro_torch.data.fed_data import register_dataset as _register_dataset
from repro_torch.kernels.ops import get_device
from repro_torch.models.registry import (
    DATASET_DEFAULT_MODEL, get_model, register_model as _register_model,
)
from repro_torch.tracking import Tracker


class _Context:
    def __init__(self):
        self.config: Optional[Config] = None
        self.model = None
        self.server_cls = Server
        self.client_cls = Client
        self.fed_data: Optional[FederatedDataset] = None
        self.tracker: Optional[Tracker] = None
        self.trainer: Optional[Trainer] = None
        self._registered_train = None

    def reset(self):
        self.__init__()


_ctx = _Context()


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _flat_key_sections() -> Dict[str, List[str]]:
    """Leaf field name -> the config sections that declare it, derived
    from the :class:`Config` dataclass tree (never hand-maintained)."""
    out: Dict[str, List[str]] = {}
    top = Config()
    for f in dataclasses.fields(Config):
        section = getattr(top, f.name)
        if dataclasses.is_dataclass(section):
            for leaf in dataclasses.fields(type(section)):
                out.setdefault(leaf.name, []).append(f.name)
    return out


def _fold_flat_keys(configs: Dict[str, Any]) -> Dict[str, Any]:
    """Fold unambiguous flat leaf keys into their nested section.

    ``{"dataset": "femnist"}`` -> ``{"data": {"dataset": "femnist"}}``, and
    so for every single-owner leaf.  Top-level ``Config`` fields
    (``model``, ``seed``, ``task_id``) are left alone; ambiguous leaves
    raise a ``KeyError`` naming every candidate path; unknown keys fall
    through to ``Config.make`` which raises its own loud error."""
    sections = _flat_key_sections()
    top_fields = {f.name for f in dataclasses.fields(Config)}
    for key in [k for k in configs
                if k not in top_fields and k in sections]:
        owners = sections[key]
        if len(owners) > 1:
            raise KeyError(
                f"flat config key {key!r} is ambiguous: "
                + " vs ".join(f"{s}.{key}" for s in owners)
                + " — pass it nested, e.g. "
                + f"{{{owners[0]!r}: {{{key!r}: ...}}}}")
        sec = owners[0]
        if (isinstance(configs.get(sec), dict)
                and key in configs[sec]
                and configs[sec][key] != configs[key]):
            raise KeyError(
                f"flat config key {key!r} conflicts with nested "
                f"{sec}.{key}: {configs[key]!r} != {configs[sec][key]!r}")
        configs.setdefault(sec, {})
        configs[sec] = {**configs[sec], key: configs.pop(key)}
    return configs


def init(configs: Optional[Dict[str, Any]] = None) -> Config:
    """Initialize the platform: merge configs with defaults and set up the
    data manager and the tracking manager.

    Args:
        configs: nested override dict matching the ``Config`` tree.  Any
            flat leaf key owned by exactly one config section is folded
            into it; a leaf owned by several sections raises ``KeyError``.
            When ``"model"`` is omitted it is derived from the dataset.
            Unknown keys raise ``KeyError``; an unregistered model raises
            ``KeyError`` here rather than at ``run()``.

    Returns:
        The merged, immutable :class:`repro_torch.core.config.Config`.

    Raises ``RuntimeError`` when no CUDA device is available and
    ``repro_torch.set_device("cpu")`` was not called.
    """
    get_device()
    configs = _fold_flat_keys(dict(configs or {}))
    if "model" not in configs:
        ds = configs.get("data", {}).get("dataset", Config().data.dataset)
        configs["model"] = DATASET_DEFAULT_MODEL.get(ds, "femnist_cnn")
    cfg = Config.make(configs)
    _ctx.config = cfg
    _ctx.model = get_model(cfg.model)
    if _ctx._registered_train is not None:
        _ctx.fed_data = _ctx._registered_train
    else:
        _ctx.fed_data = build_federated_data(cfg.data)
    _ctx.tracker = Tracker(cfg.tracking.backend, cfg.tracking.out_dir,
                           client_history_rounds=cfg.tracking.client_history_rounds)
    _ctx.trainer = None
    return cfg


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def register_dataset(train, test=None, name: Optional[str] = None) -> None:
    """Register an external dataset.

    * ``train`` is a :class:`repro_torch.data.fed_data.FederatedDataset`
      (or a virtual one): adopted directly as the training federation;
      ``test`` (a ``ClientData`` or anything with ``.x``/``.y``) replaces
      its held-out split.
    * anything else (a ``RawDataset`` or a ``(seed=...) -> RawDataset``
      factory): registered for ``data.dataset`` lookup under ``name`` (or
      the object's ``name`` attribute); a missing name raises
      ``ValueError``.
    """
    if isinstance(train, (FederatedDataset, VirtualFederatedDataset)):
        if test is not None:
            cd = test if isinstance(test, ClientData) else ClientData(
                test.x, test.y)
            if isinstance(train, FederatedDataset):
                train = dataclasses.replace(train, test=cd)
            else:
                train.test = cd
        _ctx._registered_train = train
        if _ctx.config is not None:
            _ctx.fed_data = train
        return
    name = name or getattr(train, "name", None)
    if not name:
        raise ValueError(
            "register_dataset: a name-registered dataset needs a real "
            "name — pass name=... or give the object a .name attribute "
            "(then select it with init({'dataset': <name>}))")
    _register_dataset(name, train, test=test)


def register_model(model) -> None:
    """Register an :class:`repro_torch.models.small.FLModel` instance (or
    a zero-arg factory returning one) for ``config.model`` lookup."""
    _register_model(model)
    if _ctx.config is not None:
        name = getattr(model, "name", None)
        if name:
            _ctx.model = get_model(name)


def register_server(server_cls) -> None:
    """Use ``server_cls`` (a :class:`repro_torch.core.server.Server`
    subclass, e.g. ``FedBuffServer``) for subsequent ``run()`` calls.  The
    synchronous engines run its stage overrides; under ``"batched"`` an
    ``apply_delta`` override takes the staged path and an ``aggregation``
    override the gathering path.  The async event loop aggregates itself:
    an ``aggregation`` override needs ``buffered_apply`` there, else it
    raises."""
    _ctx.server_cls = server_cls


def register_client(client_cls) -> None:
    """Use ``client_cls`` (a :class:`repro_torch.core.client.Client`
    subclass) for subsequent runs.  The sequential engine (the default
    ``execution``) runs every stage override; under ``"batched"`` and
    ``"async"`` a ``train`` override raises, as in the reference, and
    compression / encryption / upload overrides take the gathering path."""
    _ctx.client_cls = client_cls


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def run(callback: Optional[Callable] = None) -> Dict[str, Any]:
    """Start training per the active config (``init`` is implied).

    ``resources.execution`` selects the engine: per-client sequential
    rounds, one-program batched cohorts, or the async FedBuff event loop
    (one history entry per buffer aggregation instead of per round).

    Returns:
        Summary dict: ``task_id``, ``rounds``, ``final`` (last round's
        metrics), ``history`` (one metrics dict per round or aggregation:
        ``round_time`` virtual seconds, ``wall_time``, ``clients``, comm
        byte counters, ``train_loss``, eval metrics every
        ``server.test_every``; the async engine adds ``virtual_time``,
        ``staleness_mean/max`` and ``in_flight``) and ``params`` (the
        final global model, a dict of tensors).
    """
    if _ctx.config is None:
        init({})
    cfg = _ctx.config
    server = _ctx.server_cls(_ctx.model, cfg, _ctx.fed_data.test)
    _ctx.trainer = Trainer(cfg, _ctx.model, _ctx.fed_data,
                           tracker=_ctx.tracker, server=server,
                           client_cls=_ctx.client_cls)
    return _ctx.trainer.run(callback)


def start_server(args: Optional[Dict[str, Any]] = None):
    """Start the server service for remote training (paper Example 2):
    a :class:`repro_torch.core.remote.RemoteServer` of the registered
    server class, its params initialized from ``cfg.seed`` on the device.
    ``args`` are its keyword arguments (``registry``)."""
    from repro_torch.core.remote import RemoteServer
    if _ctx.config is None:
        init({})
    _refuse_compression("server")
    args = dict(args or {})
    server = _ctx.server_cls(_ctx.model, _ctx.config, _ctx.fed_data.test)
    rs = RemoteServer(server, _ctx.config, tracker=_ctx.tracker, **args)
    rs.start()
    return rs


def start_client(args: Optional[Dict[str, Any]] = None):
    """Start a client service for remote training: a
    :class:`repro_torch.core.remote.RemoteClient` serving ``client_id``'s
    data (or ``data``), registered with ``registry``.  Other ``args``:
    ``host``, ``port``, ``latency``.

    Raises ``ValueError`` for a built-in ``client.compression`` (``"stc"``,
    ``"int8"``): the wire format has no encoding for compressed updates
    (ROADMAP queue 3); the reference fails on them mid-round.
    ``start_server`` refuses a built-in ``server.compression`` alike."""
    from repro_torch.core.remote import RemoteClient
    if _ctx.config is None:
        init({})
    _refuse_compression("client")
    args = dict(args or {})
    cid = args.pop("client_id", "client_0000")
    data = args.pop("data", None)
    if data is None:
        data = _ctx.fed_data.clients[cid]
    client = _ctx.client_cls(cid, _ctx.model, data, _ctx.config.client,
                             batch_size=_ctx.config.data.batch_size)
    rc = RemoteClient(client, **args)
    rc.start()
    return rc


def _refuse_compression(section: str) -> None:
    """Remote training sends numpy trees: a built-in compression of
    ``section`` ("client": updates, "server": params) would put
    ``CompressedTensor`` leaves on a wire that has no encoding for them,
    and the reference then fails mid-round.  Raise at start instead."""
    method = getattr(_ctx.config, section).compression
    if method in ("stc", "int8"):
        raise ValueError(
            f"remote training with {section}.compression={method!r}: the "
            f"reference's wire format has no encoding for compressed "
            f"tensors, so they cannot be sent (ROADMAP queue 3); use "
            f"{section}.compression='none' for remote training")


def tracker() -> Tracker:
    """The active tracking manager (task -> rounds -> clients metrics)."""
    return _ctx.tracker


def reset() -> None:
    """Clear global state: the context and the cached round programs and
    sequential client steps (each closes over its model, and a LoRA model
    over its frozen base — gigabytes on the card for a large LM)."""
    from repro_torch.core.batched import make_round_program
    from repro_torch.core.local_train import make_client_step
    _ctx.reset()
    make_round_program.cache_clear()
    make_client_step.cache_clear()
