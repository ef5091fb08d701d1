"""Synthetic stand-ins for the paper's datasets (Table III).

Real FEMNIST/Shakespeare/CIFAR-10 are not downloadable in this offline
container, so we generate *learnable* synthetic datasets with matching
shape/cardinality semantics:

* ``femnist``     — 28x28x1 images, 62 classes; class-conditional prototypes
  + per-"writer" style shift, so a realistic per-writer partition is non-IID
  in feature space, exactly the property FEMNIST gives FL research.
* ``shakespeare`` — char sequences (vocab 80) from per-"play" bigram Markov
  chains; a realistic per-role partition is non-IID in sequence statistics.
* ``cifar10``     — 32x32x3 images, 10 classes, 60k samples, flexible #clients.

These preserve the experimental *contracts* the paper relies on: models can
learn them, non-IID partitions degrade accuracy, sample counts match.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class RawDataset:
    x: np.ndarray            # (N, ...) float32 / int32
    y: np.ndarray            # (N,) int32 labels (== x for char LM targets)
    num_classes: int
    # optional "natural" client assignment (realistic partition, LEAF-style)
    natural_client: Optional[np.ndarray] = None


def _image_dataset(n: int, hw: int, channels: int, n_classes: int,
                   n_writers: int, noise: float, seed: int) -> RawDataset:
    rng = np.random.RandomState(seed)
    dim = hw * hw * channels
    protos = rng.normal(0, 1.0, size=(n_classes, dim)).astype(np.float32)
    writer_shift = rng.normal(0, 0.6, size=(n_writers, dim)).astype(np.float32)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    w = rng.randint(0, n_writers, size=n).astype(np.int32)
    x = (protos[y] + writer_shift[w]
         + rng.normal(0, noise, size=(n, dim)).astype(np.float32))
    # normalize to image-ish range
    x = (x - x.mean()) / (x.std() + 1e-6)
    return RawDataset(x.astype(np.float32), y, n_classes, natural_client=w)


def make_femnist(n: int = 40_000, n_writers: int = 355, seed: int = 0) -> RawDataset:
    """62-class 28x28 'handwriting'.  (Full FEMNIST: 805,263 samples / 3,550
    writers; scaled 20x for CPU experimentation, ratio preserved.)"""
    return _image_dataset(n, 28, 1, 62, n_writers, noise=1.2, seed=seed)


def make_cifar10(n: int = 60_000, seed: int = 0) -> RawDataset:
    return _image_dataset(n, 32, 3, 10, n_writers=1, noise=1.6, seed=seed)


def make_shakespeare(n_seqs: int = 12_000, seq_len: int = 80,
                     n_roles: int = 113, vocab: int = 80,
                     seed: int = 0) -> RawDataset:
    """Per-role bigram Markov chains (1,129 roles in LEAF; scaled 10x)."""
    rng = np.random.RandomState(seed)
    n_styles = 8
    # style transition matrices: shared base + per-style low-rank quirk
    base = rng.dirichlet(np.ones(vocab) * 0.3, size=vocab)
    styles = []
    for s in range(n_styles):
        quirk = rng.dirichlet(np.ones(vocab) * 0.1, size=vocab)
        styles.append(0.6 * base + 0.4 * quirk)
    role_style = rng.randint(0, n_styles, size=n_roles)
    role = rng.randint(0, n_roles, size=n_seqs).astype(np.int32)
    seqs = np.zeros((n_seqs, seq_len), dtype=np.int32)
    for i in range(n_seqs):
        T = styles[role_style[role[i]]]
        c = rng.randint(vocab)
        for t in range(seq_len):
            seqs[i, t] = c
            c = rng.choice(vocab, p=T[c])
    return RawDataset(seqs, seqs.copy(), vocab, natural_client=role)


def make_synthetic_linear(n: int = 8_000, dim: int = 64, n_classes: int = 10,
                          seed: int = 0) -> RawDataset:
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 1, size=(dim, n_classes)).astype(np.float32)
    x = rng.normal(0, 1, size=(n, dim)).astype(np.float32)
    y = np.argmax(x @ w + rng.normal(0, 0.5, size=(n, n_classes)), axis=1)
    return RawDataset(x, y.astype(np.int32), n_classes)


def make_tiny_lm(n_seqs: int = 2_000, seq_len: int = 16, n_docs: int = 40,
                 vocab: int = 64, seed: int = 0) -> RawDataset:
    """Token sequences for the ``tiny_lm`` transformer: per-"document"
    bigram Markov chains (like ``shakespeare``, but vectorized over
    sequences — one numpy pass per position — and sized for seconds-fast
    CPU LLM rounds).  A realistic partition is non-IID per document."""
    rng = np.random.RandomState(seed)
    n_styles = 4
    base = rng.dirichlet(np.ones(vocab) * 0.3, size=vocab)
    styles = np.stack([
        0.5 * base + 0.5 * rng.dirichlet(np.ones(vocab) * 0.1, size=vocab)
        for _ in range(n_styles)])
    cum = np.cumsum(styles, axis=-1)            # (styles, vocab, vocab)
    doc = rng.randint(0, n_docs, size=n_seqs).astype(np.int32)
    sty = rng.randint(0, n_styles, size=n_docs)[doc]
    seqs = np.zeros((n_seqs, seq_len), dtype=np.int32)
    c = rng.randint(0, vocab, size=n_seqs)
    for t in range(seq_len):
        seqs[:, t] = c
        u = rng.rand(n_seqs, 1)
        c = np.minimum((cum[sty, c] < u).sum(axis=1), vocab - 1)
    return RawDataset(seqs, seqs.copy(), vocab, natural_client=doc)


DATASETS = {
    "femnist": make_femnist,
    "cifar10": make_cifar10,
    "shakespeare": make_shakespeare,
    "synthetic": make_synthetic_linear,
    "tiny_lm": make_tiny_lm,
}


# ---------------------------------------------------------------------------
# Virtual (per-client lazy) generation — million-client populations
# ---------------------------------------------------------------------------
#
# A materialized RawDataset costs O(population) host memory before a single
# round runs.  For synthetic datasets the per-client shard is a pure
# function of ``(dataset, seed, client index)``, so a million-client
# federation needs *zero* storage for cold clients: each client's samples
# are regenerated bit-identically on demand (the explicit recompute path
# behind the batched executor's tiered data pool).  Only the small shared
# structure — class prototypes, the linear teacher, the Markov styles — is
# computed once per ``(dataset, seed)`` and cached below.

VIRTUAL_SAMPLES_DEFAULT = 32


def _client_rng(name: str, seed: int, index: int) -> np.random.RandomState:
    """Process-stable per-client stream (FNV-1a over the identity tuple —
    Python's ``hash`` is process-randomized and would break recompute)."""
    h = 2166136261
    for ch in f"{name}|{seed}|{index}".encode():
        h = (h ^ ch) * 16777619 % (2**31)
    return np.random.RandomState(h)


@functools.lru_cache(maxsize=8)
def _virtual_shared(name: str, seed: int):
    """Shared O(1) structure for a virtual dataset (cached per seed)."""
    rng = np.random.RandomState(seed)
    if name == "synthetic":
        dim, n_classes = 64, 10
        return {"w": rng.normal(0, 1, size=(dim, n_classes)).astype(np.float32),
                "num_classes": n_classes}
    if name in ("femnist", "cifar10"):
        hw, ch, n_classes = ((28, 1, 62) if name == "femnist" else (32, 3, 10))
        dim = hw * hw * ch
        protos = rng.normal(0, 1.0, size=(n_classes, dim)).astype(np.float32)
        noise = 1.2 if name == "femnist" else 1.6
        return {"protos": protos, "noise": noise, "num_classes": n_classes}
    if name == "tiny_lm":
        vocab, n_styles = 64, 4
        base = rng.dirichlet(np.ones(vocab) * 0.3, size=vocab)
        styles = np.stack([
            0.5 * base + 0.5 * rng.dirichlet(np.ones(vocab) * 0.1, size=vocab)
            for _ in range(n_styles)])
        return {"cum": np.cumsum(styles, axis=-1), "n_styles": n_styles,
                "num_classes": vocab}
    raise KeyError(
        f"dataset {name!r} has no virtual generator; "
        f"virtualizable: {sorted(VIRTUAL_DATASETS)}")


VIRTUAL_DATASETS = frozenset({"synthetic", "femnist", "cifar10", "tiny_lm"})


def virtual_num_classes(name: str, seed: int = 0) -> int:
    return _virtual_shared(name, seed)["num_classes"]


def make_client_shard(name: str, client_index: int, n_samples: int,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generate one virtual client's ``(x, y)`` shard.

    Deterministic in ``(name, seed, client_index)`` — calling twice (or on
    different hosts) yields bit-identical arrays, which is what lets the
    tiered data pool *drop* cold rows instead of spilling them.  Each
    client is its own "writer"/"document", so realistic-style feature
    non-IID-ness is preserved at any population size."""
    shared = _virtual_shared(name, seed)
    n = int(n_samples) if n_samples > 0 else VIRTUAL_SAMPLES_DEFAULT
    rng = _client_rng(name, seed, client_index)
    if name == "synthetic":
        w = shared["w"]
        x = rng.normal(0, 1, size=(n, w.shape[0])).astype(np.float32)
        y = np.argmax(x @ w + rng.normal(0, 0.5, size=(n, w.shape[1])), axis=1)
        return x, y.astype(np.int32)
    if name in ("femnist", "cifar10"):
        protos = shared["protos"]
        shift = rng.normal(0, 0.6, size=protos.shape[1]).astype(np.float32)
        y = rng.randint(0, shared["num_classes"], size=n).astype(np.int32)
        x = (protos[y] + shift[None, :]
             + rng.normal(0, shared["noise"],
                          size=(n, protos.shape[1])).astype(np.float32))
        x = (x - x.mean()) / (x.std() + 1e-6)
        return x.astype(np.float32), y
    if name == "tiny_lm":
        cum, vocab = shared["cum"], shared["num_classes"]
        sty = int(rng.randint(shared["n_styles"]))
        seq_len = 16
        seqs = np.zeros((n, seq_len), dtype=np.int32)
        c = rng.randint(0, vocab, size=n)
        for t in range(seq_len):
            seqs[:, t] = c
            u = rng.rand(n, 1)
            c = np.minimum((cum[sty, c] < u).sum(axis=1), vocab - 1)
        return seqs, seqs.copy()
    raise KeyError(f"dataset {name!r} has no virtual generator")


def make_virtual_test(name: str, n_samples: int = 512,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out split for a virtual dataset: shards from reserved client
    indices (``-1 .. -8``) never handed to training clients, so the test
    distribution spans several writers/styles without overlapping any
    client's stream."""
    per = max(1, n_samples // 8)
    xs, ys = zip(*(make_client_shard(name, -(j + 1), per, seed)
                   for j in range(8)))
    return np.concatenate(xs), np.concatenate(ys)


def make_dataset(name: str, seed: int = 0, **kw) -> RawDataset:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[name](seed=seed, **kw)
