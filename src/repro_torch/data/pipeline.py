"""Minimal batching pipeline for the federated loop.

Held against ``repro.data.pipeline`` (``ArrayDataset`` with ``subset``
and ``epochs``, ``ClientBatcher`` with ``client_sizes`` and
``padded_parts``): host numpy on both sides, so batch indices drawn from
a seeded stream are bitwise equal. ``ClientBatcher`` owns every client's
index partition into one shared backing dataset and draws the stacked
(C, B) index matrix the round step consumes; the runner gathers it and
moves it to the device. The scanned engine's device rng instead uploads
``padded_parts``, the (N, W) zero-padded index table, and draws from it
on the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from repro_torch.data.partition import PackedParts


class ArrayDataset:
    """Dict-of-arrays dataset with random minibatch draws."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset: {sizes}")
        self.arrays = arrays
        self.size = next(iter(sizes.values()))

    def subset(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset({k: v[idx] for k, v in self.arrays.items()})

    def batch(self, batch_size: int, rng: np.random.Generator
              ) -> Dict[str, np.ndarray]:
        """One random batch (with replacement if batch > size)."""
        replace = batch_size > self.size
        idx = rng.choice(self.size, size=batch_size, replace=replace)
        return {k: v[idx] for k, v in self.arrays.items()}

    def epochs(self, batch_size: int, rng: np.random.Generator
               ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless shuffled epochs of full batches (a short tail is
        dropped)."""
        while True:
            perm = rng.permutation(self.size)
            for ofs in range(0, self.size - batch_size + 1, batch_size):
                idx = perm[ofs:ofs + batch_size]
                yield {k: v[idx] for k, v in self.arrays.items()}


class ClientBatcher:
    """Stacked client-batch construction over a shared backing dataset.

    ``parts[u]`` holds client u's global indices into ``base`` (from
    ``iid_partition`` / ``dirichlet_partition``, or a ``PackedParts`` from
    ``population_partition``). ``batch_indices`` samples B local indices
    per client (with replacement only when a client holds fewer than B
    samples) and maps them to a (C, B) global index matrix.
    """

    def __init__(self, base: ArrayDataset, parts: Sequence[np.ndarray]):
        if not len(parts):
            raise ValueError("need at least one client partition")
        self.base = base
        if isinstance(parts, PackedParts):
            self.parts = parts
        else:
            self.parts = [np.asarray(p, dtype=np.int64) for p in parts]
            for u, p in enumerate(self.parts):
                if p.size == 0:
                    raise ValueError(f"client {u} has an empty partition")
        self.num_clients = len(self.parts)

    def batch_indices(self, batch_size: int, rng: np.random.Generator,
                      clients: Optional[Sequence[int]] = None
                      ) -> np.ndarray:
        """The (C, B) GLOBAL index matrix one stacked batch gathers."""
        parts = self.parts if clients is None \
            else [self.parts[int(c)] for c in clients]
        for p in parts:
            if p.size == 0:
                raise ValueError(
                    "cannot draw a host batch from a zero-sample client")
        return np.stack([
            p[rng.choice(p.size, size=batch_size,
                         replace=batch_size > p.size)]
            for p in parts])

    def batch(self, batch_size: int, rng: np.random.Generator,
              clients: Optional[Sequence[int]] = None
              ) -> Dict[str, np.ndarray]:
        """One stacked (C, B, ...) random batch (host numpy)."""
        idx = self.batch_indices(batch_size, rng, clients)
        return {k: v[idx] for k, v in self.base.arrays.items()}

    def client_sizes(self) -> np.ndarray:
        if isinstance(self.parts, PackedParts):
            return self.parts.client_sizes()
        return np.asarray([p.size for p in self.parts], dtype=np.int64)

    def padded_parts(self, width: Optional[int] = None,
                     dtype=np.int32) -> np.ndarray:
        """The (N, W) zero-padded per-client index table: row u's first
        ``client_sizes()[u]`` entries are client u's global indices, the
        rest zeros (an empty row stays all zeros). One vectorized build
        for either form of ``parts``."""
        if isinstance(self.parts, PackedParts):
            return self.parts.padded(width, dtype=dtype)
        sizes = self.client_sizes()
        w = int(max(int(sizes.max(initial=0)), width or 0))
        table = np.zeros((self.num_clients, w), dtype)
        mask = np.arange(w) < sizes[:, None]
        if self.parts:
            table[mask] = np.concatenate(
                [p for p in self.parts if p.size])
        return table
