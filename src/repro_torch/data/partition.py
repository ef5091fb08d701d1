"""Statistical-heterogeneity partitioners (paper §V-A).

Three non-IID simulation methods over a labelled dataset:
  * ``dirichlet``  — per-client class mixture ~ Dir(alpha) [Wang et al., ICLR'20]
  * ``by_class``   — each client holds N of the K classes [Zhao et al., 2018]
  * ``iid``        — uniform random split
plus lognormal *unbalanced* sample counts, composable with any of the above
(the paper combines Dir(0.5) imbalance with system heterogeneity in Fig. 6c).

All functions are pure numpy, deterministic in ``seed``, and return a list of
index arrays (one per client) that jointly cover a subset of the dataset.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def iid_partition(labels: np.ndarray, n_clients: int, seed: int = 0,
                  sizes: Optional[np.ndarray] = None) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    if sizes is None:
        return [np.sort(s) for s in np.array_split(idx, n_clients)]
    sizes = _fit_sizes(sizes, len(labels))
    out, start = [], 0
    for s in sizes:
        out.append(np.sort(idx[start:start + s]))
        start += s
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Each client's class distribution drawn from Dir(alpha)."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):  # redraw until every client has min_size samples
        client_idx: List[list] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                client_idx[cid].extend(part.tolist())
        if min(len(ci) for ci in client_idx) >= min_size:
            break
    return [np.sort(np.asarray(ci, dtype=np.int64)) for ci in client_idx]


def class_partition(labels: np.ndarray, n_clients: int,
                    classes_per_client: int, seed: int = 0) -> List[np.ndarray]:
    """Each client holds shards from exactly ``classes_per_client`` classes."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    k = min(classes_per_client, n_classes)
    # total shards = n_clients * k, spread uniformly over classes
    shards_per_class = max(1, (n_clients * k) // n_classes)
    shard_pool = []
    for c in range(n_classes):
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        for part in np.array_split(idx_c, shards_per_class):
            if len(part):
                shard_pool.append((c, part))
    rng.shuffle(shard_pool)
    client_idx: List[list] = [[] for _ in range(n_clients)]
    client_classes: List[set] = [set() for _ in range(n_clients)]
    # greedy: give each client shards of at most k distinct classes
    leftovers = []
    for c, part in shard_pool:
        placed = False
        order = rng.permutation(n_clients)
        # prefer clients that already own class c, then clients with < k classes
        for cid in sorted(order, key=lambda i, c=c: (c not in client_classes[i],
                                                len(client_idx[i]))):
            if c in client_classes[cid] or len(client_classes[cid]) < k:
                client_idx[cid].extend(part.tolist())
                client_classes[cid].add(c)
                placed = True
                break
        if not placed:
            leftovers.append((c, part))
    for c, part in leftovers:  # give to smallest client regardless
        cid = int(np.argmin([len(ci) for ci in client_idx]))
        client_idx[cid].extend(part.tolist())
        client_classes[cid].add(c)
    return [np.sort(np.asarray(ci, dtype=np.int64)) for ci in client_idx]


def unbalanced_sizes(total: int, n_clients: int, sigma: float = 1.0,
                     seed: int = 0, min_size: int = 2) -> np.ndarray:
    """Lognormal sample counts summing to ``total``."""
    rng = np.random.RandomState(seed)
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients)
    sizes = np.maximum((raw / raw.sum() * total).astype(int), min_size)
    return _fit_sizes(sizes, total)


def _fit_sizes(sizes: np.ndarray, total: int) -> np.ndarray:
    sizes = np.asarray(sizes, dtype=int).copy()
    diff = total - sizes.sum()
    i = 0
    while diff != 0:
        j = i % len(sizes)
        step = 1 if diff > 0 else -1
        if sizes[j] + step >= 1:
            sizes[j] += step
            diff -= step
        i += 1
    return sizes


def apply_sizes(parts: List[np.ndarray], sizes: np.ndarray,
                seed: int = 0) -> List[np.ndarray]:
    """Subsample each client's indices to the target unbalanced sizes."""
    rng = np.random.RandomState(seed)
    out = []
    for idx, s in zip(parts, sizes):
        s = min(len(idx), int(s))
        out.append(np.sort(rng.choice(idx, size=s, replace=False)))
    return out


def partition(labels: np.ndarray, n_clients: int, method: str = "iid",
              alpha: float = 0.5, classes_per_client: int = 2,
              unbalanced: bool = False, sigma: float = 1.0,
              seed: int = 0) -> List[np.ndarray]:
    """One-stop partitioner used by the data manager."""
    if method in ("iid", "realistic"):
        sizes = (unbalanced_sizes(len(labels), n_clients, sigma, seed)
                 if unbalanced else None)
        return iid_partition(labels, n_clients, seed, sizes)
    if method == "dir":
        parts = dirichlet_partition(labels, n_clients, alpha, seed)
    elif method == "class":
        parts = class_partition(labels, n_clients, classes_per_client, seed)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    if unbalanced:
        sizes = unbalanced_sizes(sum(len(p) for p in parts), n_clients,
                                 sigma, seed)
        parts = apply_sizes(parts, sizes, seed)
    return parts
