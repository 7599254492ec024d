"""Minimal batching pipeline for the federated loop.

Held against ``repro.data.pipeline`` (``ArrayDataset``, ``ClientBatcher``):
host numpy on both sides, so batch indices drawn from a seeded stream are
bitwise equal. ``ClientBatcher`` owns every client's index partition into
one shared backing dataset and draws the stacked (C, B) index matrix the
round step consumes; the runner gathers it and moves it to the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

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

    def batch(self, batch_size: int, rng: np.random.Generator
              ) -> Dict[str, np.ndarray]:
        """One random batch (with replacement if batch > size)."""
        replace = batch_size > self.size
        idx = rng.choice(self.size, size=batch_size, replace=replace)
        return {k: v[idx] for k, v in self.arrays.items()}


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
