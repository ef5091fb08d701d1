"""Federated dataset container + data manager (paper's *data manager*).

``FederatedDataset`` holds per-client shards plus a held-out test set;
``build_federated_data(config)`` is the simulation-manager entry point that
turns a :class:`DataConfig` into a partitioned dataset (statistical
heterogeneity per §V-A).  ``register_dataset`` plugs external datasets in,
mirroring the paper's API (Table II).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Set

import numpy as np

from repro_torch.core.config import DataConfig
from repro_torch.data.partition import partition, unbalanced_sizes, apply_sizes
from repro_torch.data.synthetic import (
    VIRTUAL_DATASETS, RawDataset, make_client_shard, make_dataset,
    make_virtual_test, virtual_num_classes,
)

_REGISTERED: Dict[str, Callable[..., RawDataset]] = {}
_REGISTERED_TEST: Dict[str, "RawDataset"] = {}


def register_dataset(name: str, factory_or_data, test=None) -> None:
    """Register an external dataset under ``name`` for ``data.dataset``
    lookup.

    Args:
        name: the value ``data.dataset`` selects it by (required — no
            fallback name is invented).
        factory_or_data: a :class:`RawDataset` or a factory
            ``(seed=...) -> RawDataset``.
        test: optional held-out :class:`RawDataset`.  When given,
            ``build_federated_data`` adopts it as the test split and
            partitions *all* of ``factory_or_data`` across clients;
            when omitted, 10% of the data is carved off as usual.
    """
    if not name:
        raise ValueError("register_dataset: name must be a non-empty string")
    if isinstance(factory_or_data, RawDataset):
        _REGISTERED[name] = lambda **kw: factory_or_data
    else:
        _REGISTERED[name] = factory_or_data
    if test is not None:
        _REGISTERED_TEST[name] = test
    else:
        _REGISTERED_TEST.pop(name, None)


@dataclass
class ClientData:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.random.RandomState(seed).permutation(len(self.x))
        stop = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
        for s in range(0, max(stop, 0), batch_size):
            sel = idx[s : s + batch_size]
            if len(sel) == 0:
                continue
            yield {"x": self.x[sel], "y": self.y[sel]}


@dataclass
class FederatedDataset:
    clients: Dict[str, ClientData]
    test: ClientData
    num_classes: int

    @property
    def client_ids(self) -> List[str]:
        return sorted(self.clients)

    def sizes(self) -> Dict[str, int]:
        return {cid: len(c) for cid, c in self.clients.items()}

    def stats(self) -> Dict[str, float]:
        sizes = np.array([len(c) for c in self.clients.values()])
        return {
            "num_clients": len(self.clients),
            "total_samples": int(sizes.sum()),
            "min": int(sizes.min()),
            "max": int(sizes.max()),
            "mean": float(sizes.mean()),
        }


class ClientIdSpace:
    """Lazy, ordered space of client ids — ``len()`` of a million without
    materializing a million strings.

    Quacks like the ``List[str]`` that ``FederatedDataset.client_ids``
    returns (``len``/``in``/indexing/iteration) but adds O(k)
    :meth:`sample`, which ``Server.selection`` dispatches on via
    ``hasattr(ids, "sample")`` — the list path keeps its historical
    ``rng.choice`` draw order so existing runs stay bit-reproducible."""

    def __init__(self, n: int, prefix: str = "client_"):
        self.n = int(n)
        self.prefix = prefix

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> str:
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return f"{self.prefix}{(i % self.n):04d}"

    def __iter__(self) -> Iterator[str]:
        return (f"{self.prefix}{i:04d}" for i in range(self.n))

    def __contains__(self, cid) -> bool:
        return self.index(cid) is not None

    def index(self, cid: str) -> Optional[int]:
        """Parse a client id back to its index (None when out of space)."""
        if not isinstance(cid, str) or not cid.startswith(self.prefix):
            return None
        try:
            i = int(cid[len(self.prefix):])
        except ValueError:
            return None
        return i if 0 <= i < self.n else None

    def sample(self, rng: np.random.RandomState, k: int,
               exclude: Optional[Set[str]] = None) -> List[str]:
        """Draw ``k`` distinct ids uniformly, skipping ``exclude``, in
        O(k + |exclude|) — rejection sampling against a seen-set (Floyd
        flavor), never touching the other 10^6 - k ids.  Falls back to a
        materialized complement draw when the request covers most of the
        space (small populations), where rejection would thrash."""
        excl = {i for i in (self.index(c) for c in (exclude or ()))
                if i is not None}
        avail = self.n - len(excl)
        k = min(int(k), avail)
        if k <= 0:
            return []
        if k + len(excl) > self.n // 2:
            pool = np.setdiff1d(np.arange(self.n),
                                np.fromiter(excl, np.int64, len(excl)))
            idx = rng.choice(pool, size=k, replace=False)
            return [f"{self.prefix}{int(i):04d}" for i in idx]
        seen = set(excl)
        out: List[int] = []
        while len(out) < k:
            # batched draws amortize RandomState overhead at large k
            for i in rng.randint(0, self.n, size=2 * (k - len(out))):
                if i not in seen:
                    seen.add(int(i))
                    out.append(int(i))
                    if len(out) == k:
                        break
        return [f"{self.prefix}{i:04d}" for i in out]


class _VirtualClients:
    """Lazy ``clients`` mapping: ``__getitem__`` regenerates the shard
    (bit-identically) on every call — no cache here; bounded residency is
    the batched executor's tiered data pool's job."""

    def __init__(self, fed: "VirtualFederatedDataset"):
        self._fed = fed

    def __getitem__(self, cid: str) -> ClientData:
        i = self._fed.ids.index(cid)
        if i is None:
            raise KeyError(cid)
        x, y = make_client_shard(self._fed.dataset, i,
                                 self._fed.samples_per_client, self._fed.seed)
        return ClientData(x, y)

    def __contains__(self, cid) -> bool:
        return cid in self._fed.ids

    def __len__(self) -> int:
        return len(self._fed.ids)

    def __iter__(self) -> Iterator[str]:
        return iter(self._fed.ids)


class VirtualFederatedDataset:
    """``FederatedDataset``-compatible view over a virtual population.

    Nothing per-client is stored: ids come from a :class:`ClientIdSpace`,
    shards from ``synthetic.make_client_shard`` on demand.  Host memory is
    O(1) in the population — ``data.num_clients = 10**6`` costs the same
    as 10**2."""

    def __init__(self, dataset: str, num_clients: int,
                 samples_per_client: int = 0, seed: int = 0):
        self.dataset = dataset
        self.samples_per_client = int(samples_per_client)
        self.seed = int(seed)
        self.ids = ClientIdSpace(num_clients)
        self.clients = _VirtualClients(self)
        self.num_classes = virtual_num_classes(dataset, seed)
        tx, ty = make_virtual_test(dataset, seed=seed)
        self.test = ClientData(tx, ty)

    @property
    def client_ids(self) -> ClientIdSpace:
        return self.ids

    def sizes(self) -> Dict[str, int]:
        raise NotImplementedError(
            "sizes() would materialize the whole virtual population; "
            "use stats() or len(fed.client_ids)")

    def stats(self) -> Dict[str, float]:
        from repro_torch.data.synthetic import VIRTUAL_SAMPLES_DEFAULT
        per = self.samples_per_client or VIRTUAL_SAMPLES_DEFAULT
        return {"num_clients": len(self.ids),
                "total_samples": per * len(self.ids),
                "min": per, "max": per, "mean": float(per)}


def _natural_partition(data: RawDataset, n_clients: int,
                       seed: int) -> List[np.ndarray]:
    """LEAF-style realistic partition by the natural client id."""
    assert data.natural_client is not None
    owners = data.natural_client
    uniq = np.unique(owners)
    rng = np.random.RandomState(seed)
    if len(uniq) > n_clients:
        # merge owners into n_clients groups
        groups = np.array_split(rng.permutation(uniq), n_clients)
    else:
        groups = [np.array([u]) for u in uniq]
    return [np.sort(np.where(np.isin(owners, g))[0]) for g in groups]


VIRTUAL_AUTO_THRESHOLD = 10_000


def _virtualize(cfg: DataConfig) -> bool:
    """Decide materialized vs virtual for this config.

    ``data.virtual="on"`` forces it (loud error for non-virtualizable
    datasets); ``"off"`` never; ``"auto"`` virtualizes synthetic datasets
    once the population crosses ``VIRTUAL_AUTO_THRESHOLD`` — below that,
    materialized partitions keep historical bit-reproducibility."""
    if cfg.virtual == "off" or cfg.dataset in _REGISTERED:
        return False
    if cfg.virtual == "on":
        if cfg.dataset not in VIRTUAL_DATASETS:
            raise ValueError(
                f"data.virtual='on' but dataset {cfg.dataset!r} has no "
                f"per-client generator; virtualizable: "
                f"{sorted(VIRTUAL_DATASETS)} (registered/real datasets "
                f"must be materialized)")
        return True
    return (cfg.dataset in VIRTUAL_DATASETS
            and cfg.num_clients >= VIRTUAL_AUTO_THRESHOLD)


def build_federated_data(cfg: DataConfig) -> FederatedDataset:
    if _virtualize(cfg):
        return VirtualFederatedDataset(
            cfg.dataset, cfg.num_clients,
            samples_per_client=cfg.samples_per_client, seed=cfg.seed)
    if cfg.dataset in _REGISTERED:
        raw = _REGISTERED[cfg.dataset](seed=cfg.seed)
    else:
        raw = make_dataset(cfg.dataset, seed=cfg.seed)

    n = len(raw.x)
    rng = np.random.RandomState(cfg.seed)
    perm = rng.permutation(n)
    reg_test = _REGISTERED_TEST.get(cfg.dataset)
    if reg_test is not None:
        # an explicitly registered test split: partition everything
        test_idx, train_idx = perm[:0], perm
    else:
        n_test = max(1, int(0.1 * n))
        test_idx, train_idx = perm[:n_test], perm[n_test:]

    if cfg.data_amount < 1.0:  # Fig. 7b: fraction of samples used
        keep = max(1, int(len(train_idx) * cfg.data_amount))
        train_idx = train_idx[:keep]

    labels = raw.y[train_idx]
    flat_labels = labels if labels.ndim == 1 else labels[:, 0]

    if cfg.partition == "realistic" and raw.natural_client is not None:
        sub = RawDataset(raw.x[train_idx], raw.y[train_idx], raw.num_classes,
                         raw.natural_client[train_idx])
        parts = _natural_partition(sub, cfg.num_clients, cfg.seed)
        if cfg.unbalanced:
            sizes = unbalanced_sizes(sum(len(p) for p in parts), len(parts),
                                     cfg.unbalanced_sigma, cfg.seed)
            parts = apply_sizes(parts, sizes, cfg.seed)
    else:
        method = cfg.partition if cfg.partition != "realistic" else "iid"
        parts = partition(
            flat_labels, cfg.num_clients, method=method, alpha=cfg.dir_alpha,
            classes_per_client=cfg.classes_per_client,
            unbalanced=cfg.unbalanced, sigma=cfg.unbalanced_sigma,
            seed=cfg.seed)

    clients = {}
    for i, p in enumerate(parts):
        if len(p) == 0:
            continue
        sel = train_idx[p]
        clients[f"client_{i:04d}"] = ClientData(raw.x[sel], raw.y[sel])
    test = (ClientData(reg_test.x, reg_test.y) if reg_test is not None
            else ClientData(raw.x[test_idx], raw.y[test_idx]))
    return FederatedDataset(
        clients=clients,
        test=test,
        num_classes=raw.num_classes,
    )
