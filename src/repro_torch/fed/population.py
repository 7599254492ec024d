"""Population-scale partial participation, host half: N registered
devices, U scheduled per round.

Held against ``repro.fed.population`` (``Population``, ``CohortSampler``,
``UniformSampler``): host numpy on both sides, so seeded cohorts and the
rng stream they consume are bitwise equal.

* ``Population`` holds the (N,) struct-of-arrays ``ChannelState`` plus
  each device's fading epoch; block fading advances a population epoch
  and realizations refresh lazily, only for scheduled devices.
* ``CohortSampler`` is the scheduler protocol: ``select`` returns the (U,)
  ascending population indices of this round's cohort and, when defined,
  each member's inclusion probability.
* ``UniformSampler``: uniform without replacement, exact pi = U/N; the
  full-participation case (U == N) returns the identity cohort without
  consuming rng state.

The channel-aware and energy-aware samplers and the device-resident
registry are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.core.channel import ChannelState


@dataclass
class Population:
    """Persistent state for N registered devices."""

    channel: ChannelState          # (N,) persistent per-device state
    fading_epoch: np.ndarray       # (N,) epoch of each device's realization
    epoch: int = 0                 # current population (channel) epoch

    @classmethod
    def sample(cls, cfg: WirelessConfig, num: int, samples_min: int,
               samples_max: int, rng: np.random.Generator,
               dtype=np.float64) -> "Population":
        """Register N devices with one vectorized Table-2 draw."""
        state = ChannelState.sample(cfg, num, samples_min, samples_max, rng,
                                    dtype=dtype)
        return cls(channel=state,
                   fading_epoch=np.zeros(num, dtype=np.int64))

    @property
    def num_devices(self) -> int:
        return self.channel.num_devices

    def __len__(self) -> int:
        return self.num_devices

    def advance_epoch(self) -> int:
        """Start a new block-fading epoch; realizations refresh lazily."""
        self.epoch += 1
        return self.epoch

    def refresh_fading(self, cfg: WirelessConfig, idx: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
        """Re-draw the slow fading/interference realization for the
        scheduled devices ``idx`` whose realization predates the current
        epoch. Returns the refreshed indices."""
        idx = np.asarray(idx, dtype=np.int64)
        stale = idx[self.fading_epoch[idx] < self.epoch]
        if stale.size:
            fading, interference = ChannelState.draw_fading(
                cfg, rng, stale.size)
            self.channel.fading_mean[stale] = fading
            self.channel.interference[stale] = interference
            self.fading_epoch[stale] = self.epoch
        return stale

    def view(self, idx: np.ndarray) -> ChannelState:
        """(U,) cohort view of the channel state (a gathered copy)."""
        return self.channel.take(idx)


SelectResult = Tuple[np.ndarray, Optional[np.ndarray]]


class CohortSampler:
    """Scheduler protocol: pick this round's cohort out of the population.

    ``select(population, cohort_size, rnd, rng, ltfl)`` returns ``idx``,
    the (U,) int64 ascending population indices, and ``probs``, the (U,)
    inclusion probabilities (or None for deterministic schedulers).
    """

    def select(self, population: Population, cohort_size: int, rnd: int,
               rng: np.random.Generator, ltfl: LTFLConfig) -> SelectResult:
        raise NotImplementedError


@dataclass
class UniformSampler(CohortSampler):
    """Uniform without replacement: exact inclusion probability U/N."""

    def select(self, population, cohort_size, rnd, rng, ltfl):
        n = population.num_devices
        if cohort_size == n:            # full participation: identity cohort
            return np.arange(n, dtype=np.int64), np.ones(n)
        idx = np.sort(rng.choice(n, size=cohort_size, replace=False))
        return idx.astype(np.int64), np.full(cohort_size, cohort_size / n)
