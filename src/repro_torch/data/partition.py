"""Federated data partitioning: IID and Dirichlet non-IID (paper Sec. 6.2.5,
concentration alpha in {0.1, 0.5, 0.9}).

Held against ``repro.data.partition``: a numpy copy of the whole module,
so seeded partitions and the rng stream state they leave behind are
bitwise equal on both sides.

Setup complexity contract
-------------------------
``population_partition`` is the million-device cold-start path: it assigns
all N shards in ONE vectorized pass (tiled permutations + per-shard
windows computed from cumulative sizes) and returns a ``PackedParts`` —
a padded (N, W) table + (N,) size vector — instead of N Python array
objects, with no O(N) Python loop. The per-shard ``while`` loop it
replaced (``population_partition_reference``) is kept as the
seeded-parity reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class PackedParts:
    """N client partitions packed as one padded table — the O(N)-free
    representation the population engines consume.

    ``table[u, :sizes[u]]`` holds client u's global sample indices in
    ascending order; ``table[u, sizes[u]:]`` is zero padding (never drawn:
    batch draws are bounded by ``sizes[u]``, and a zero-sample client's
    all-zero row only ever enters zero-weighted aggregation). Behaves as a
    read-only sequence of per-client index arrays, so host-side consumers
    written against ``List[np.ndarray]`` (O(U) cohort loops, tests) keep
    working — but bulk consumers should use ``padded`` / ``client_sizes``,
    which are views/slices, not per-client Python iterations."""

    table: np.ndarray            # (N, W) int32, zero-padded rows
    sizes: np.ndarray            # (N,) int64 true shard sizes

    def __len__(self) -> int:
        return int(self.sizes.shape[0])

    def __getitem__(self, u: int) -> np.ndarray:
        return self.table[u, :self.sizes[u]]

    def __iter__(self) -> Iterator[np.ndarray]:
        return (self[u] for u in range(len(self)))

    def client_sizes(self) -> np.ndarray:
        return self.sizes

    def padded(self, width: int = None, dtype=np.int32) -> np.ndarray:
        """The (N, max(width, W)) zero-padded index table (one vectorized
        pad/cast, no per-client loop). ``width`` widens the table to a
        common width (run_sweep stacks lanes of different max shard
        size)."""
        t = self.table
        if width is not None and width > t.shape[1]:
            t = np.pad(t, ((0, 0), (0, width - t.shape[1])))
        return t.astype(dtype, copy=False)


Parts = Union[PackedParts, List[np.ndarray]]


def iid_partition(num_samples: int, client_sizes: Sequence[int],
                  rng: np.random.Generator) -> List[np.ndarray]:
    """Random disjoint index sets of the requested sizes."""
    total = int(np.sum(client_sizes))
    if total > num_samples:
        raise ValueError(f"need {total} samples, have {num_samples}")
    perm = rng.permutation(num_samples)
    out, ofs = [], 0
    for s in client_sizes:
        out.append(np.sort(perm[ofs:ofs + s]))
        ofs += s
    return out


def population_partition(num_samples: int, client_sizes: Sequence[int],
                         rng: np.random.Generator) -> PackedParts:
    """Population-indexed shards over a FIXED simulation pool, O(N).

    A registered population of N devices needs N shards, but a simulation
    pool rarely holds sum(sizes) distinct samples at N in the thousands.
    The whole assignment is ONE vectorized pass: shard u owns the cyclic
    window of length sizes[u] starting at flat offset cumsum(sizes)[u]
    into a (ceil(total / P), P) stack of permutations of the pool, read
    within its starting permutation row. Shards are disjoint while the
    pool lasts; past one pool's worth, DIFFERENT shards share samples —
    the standard population-scale simulation compromise — but a cyclic
    window of <= P entries of one permutation is duplicate-free, so
    within one shard indices stay unique and no client silently
    overweights a sample.

    Seeded parity: with ``sum(sizes) <= num_samples`` (the no-wrap
    regime) exactly one ``rng.permutation(num_samples)`` is consumed and
    every shard is a sorted disjoint slice of it — bitwise equal to both
    ``iid_partition`` and the per-shard loop reference
    (``population_partition_reference``), including the rng stream state
    left behind. In the wrap regime the assignment is
    distribution-equivalent to the reference but draws the extra
    permutation rows in one batched ``Generator.permuted`` call, so the
    two consume the rng stream differently (documented-equivalent, not
    bitwise; tests/test_population.py pins both regimes).
    """
    sizes = np.asarray(client_sizes, dtype=np.int64)
    if sizes.size and int(sizes.max()) > num_samples:
        raise ValueError(
            f"a shard of {int(sizes.max())} samples cannot be unique "
            f"within a pool of {num_samples}")
    pool = int(num_samples)
    total = int(sizes.sum())
    n_rows = max(1, -(-total // pool))
    if n_rows == 1:
        # no-wrap: the reference's single permutation draw, bit-for-bit
        perms = rng.permutation(pool)[None].astype(np.int32, copy=False)
    else:
        perms = rng.permuted(
            np.broadcast_to(np.arange(pool, dtype=np.int32),
                            (n_rows, pool)).copy(),
            axis=1)
    width = int(sizes.max()) if sizes.size else 0
    n = sizes.shape[0]
    # broadcast-window gather: entry (u, j) reads
    # perms[starts[u] // P, (starts[u] + j) % P]; computed directly at
    # (N, W) — no flat repeat/scatter intermediates, int32 index math
    # while the flat offsets fit (the (N, W) gather is the whole setup
    # cost at N=10^6)
    idx_t = np.int32 if total + width < np.iinfo(np.int32).max else np.int64
    starts = np.concatenate(
        [[0], np.cumsum(sizes)[:-1]]).astype(idx_t, copy=False)
    j = np.arange(width, dtype=idx_t)
    rows2 = np.broadcast_to((starts // pool)[:, None], (n, width))
    cols2 = (starts[:, None] + j) % idx_t(pool)
    mask = j < sizes[:, None]
    table = np.where(mask, perms[rows2, cols2],
                     np.int32(np.iinfo(np.int32).max))
    table.sort(axis=1)           # ascending per shard; sentinels sink last
    table[~mask] = 0             # zero the pad (never drawn; see class doc)
    return PackedParts(table=table.astype(np.int32, copy=False),
                       sizes=sizes)


def population_partition_reference(num_samples: int,
                                   client_sizes: Sequence[int],
                                   rng: np.random.Generator
                                   ) -> List[np.ndarray]:
    """The original per-shard loop — O(N) Python iterations with an
    ``np.isin`` dedupe per wrap. Kept as the seeded-parity reference for
    ``population_partition`` (bitwise in the no-wrap regime) and as the
    setup-time baseline the population_sharded benchmark gate measures
    against; never used by the engines."""
    if max(client_sizes, default=0) > num_samples:
        raise ValueError(
            f"a shard of {max(client_sizes)} samples cannot be unique "
            f"within a pool of {num_samples}")
    perm, ofs = rng.permutation(num_samples), 0
    out: List[np.ndarray] = []
    for s in client_sizes:
        chunks: List[np.ndarray] = [perm[:0]]   # s == 0 => empty shard
        have = 0
        while have < s:
            if ofs == num_samples:
                perm, ofs = rng.permutation(num_samples), 0
            k = min(int(s) - have, num_samples - ofs)
            cand = perm[ofs:ofs + k]
            ofs += k
            # a wrapped shard drops indices it already holds
            cand = cand[~np.isin(cand, np.concatenate(chunks))]
            chunks.append(cand)
            have += cand.size
        out.append(np.sort(np.concatenate(chunks)))
    return out


def dirichlet_partition(labels: np.ndarray, client_sizes: Sequence[int],
                        alpha: float, rng: np.random.Generator
                        ) -> List[np.ndarray]:
    """Per-client class mixture ~ Dirichlet(alpha): small alpha => skewed.

    Draws each client's samples according to its mixture, without
    replacement where possible (falls back to replacement when a class
    pool is exhausted — matches common FL simulation practice).
    """
    num_classes = int(labels.max()) + 1
    by_class = [list(rng.permutation(np.where(labels == c)[0]))
                for c in range(num_classes)]
    out: List[np.ndarray] = []
    for size in client_sizes:
        mix = rng.dirichlet([alpha] * num_classes)
        counts = rng.multinomial(size, mix)
        idx: List[int] = []
        for c, k in enumerate(counts):
            pool = by_class[c]
            take = min(k, len(pool))
            idx.extend(pool[:take])
            del pool[:take]
            if take < k:   # exhausted: sample this class with replacement
                refill = np.where(labels == c)[0]
                idx.extend(rng.choice(refill, size=k - take).tolist())
        out.append(np.asarray(sorted(idx), dtype=np.int64))
    return out


def class_histogram(labels: np.ndarray, parts: Sequence[np.ndarray],
                    num_classes: int) -> np.ndarray:
    """(num_clients, num_classes) sample counts — for tests/diagnostics."""
    return np.stack([np.bincount(labels[p], minlength=num_classes)
                     for p in parts])
