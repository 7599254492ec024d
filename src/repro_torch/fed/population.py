"""Population-scale partial participation, host half: N registered
devices, U scheduled per round.

Held against ``repro.fed.population`` (``Population``, ``CohortSampler``,
``UniformSampler``, ``ChannelAwareSampler``, ``gumbel_topk_inclusion``,
``EnergyAwareSampler``): host numpy on both sides, so seeded cohorts,
inclusion probabilities and the rng stream they consume are bitwise
equal.

* ``Population`` holds the (N,) struct-of-arrays ``ChannelState`` plus
  each device's fading epoch; block fading advances a population epoch
  and realizations refresh lazily, only for scheduled devices.
* ``CohortSampler`` is the scheduler protocol: ``select`` returns the (U,)
  ascending population indices of this round's cohort and, when defined,
  each member's inclusion probability.
* ``UniformSampler``: uniform without replacement, exact pi = U/N; the
  full-participation case (U == N) returns the identity cohort without
  consuming rng state.
* ``ChannelAwareSampler``: the top U by expected uplink rate, with an
  optional share of uniform exploration picks; no inclusion
  probabilities.
* ``EnergyAwareSampler``: weighted without replacement by energy
  headroom, with the exact inclusion probabilities of
  ``gumbel_topk_inclusion``.

The device-resident registry, its samplers' device twins and
``ChurnSpec`` are not ported yet.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.core.channel import ChannelState, expected_rate
from repro_torch.core.delay_energy import local_train_energy


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


@dataclass
class ChannelAwareSampler(CohortSampler):
    """Top-U by expected uplink rate at a reference power (opportunistic
    scheduling on last-known CSI).

    ``explore`` in [0, 1) reserves that fraction of the cohort (at least
    one slot whenever explore > 0) for uniform picks outside the top set,
    so that lazily refreshed CSI cannot starve the rest. Deterministic
    selection has no inclusion probabilities (``probs`` is None): use
    ``participation="cohort"``.
    """

    power: Optional[float] = None      # reference power; default mid-range
    explore: float = 0.0

    def select(self, population, cohort_size, rnd, rng, ltfl):
        w = ltfl.wireless
        p_ref = self.power if self.power is not None \
            else 0.5 * (w.p_min + w.p_max)
        rate = expected_rate(w, population.channel,
                             np.full(population.num_devices, p_ref))
        n_explore = 0 if self.explore <= 0.0 else min(
            cohort_size, max(1, round(self.explore * cohort_size)))
        n_top = cohort_size - n_explore
        order = np.argsort(-rate, kind="stable")
        idx = order[:n_top]
        if n_explore:
            rest = order[n_top:]
            idx = np.concatenate(
                [idx, rng.choice(rest, size=n_explore, replace=False)])
        return np.sort(idx).astype(np.int64), None


def gumbel_topk_inclusion(w, k: int, n_quad: int = 64) -> np.ndarray:
    """Exact inclusion probabilities for weighted sampling without
    replacement (numpy's sequential ``choice(replace=False, p=w)``, the
    exponential race: X_j ~ Exp(w_j), keep the k smallest).

    Given X_i = x, device j beats i with probability
    p_j(x) = 1 - e^{-w_j x}, so pi_i = E[P(PoisBin({p_j(x)}_{j != i})
    <= k - 1)]. With s = e^{-x} and, per device, v = s^{N w_i} (sum w =
    1), pi_i = integral over (0, 1) of Q_i(v^{1/(N w_i)}) dv: a bounded
    monotone integrand, taken by ``n_quad``-node Gauss-Legendre. Q_i is a
    truncated Poisson-binomial forward DP with device i's own arrival
    probability set to 0 (leave-one-out without deconvolution);
    O(N^2 k n_quad) in chunks over i.

    k = 1 gives pi = w; uniform weights give k/N; k >= N gives all ones;
    sum_i pi_i = k.
    """
    w = np.asarray(w, np.float64)
    n = w.shape[0]
    if k >= n:
        return np.ones(n)
    w = w / np.sum(w)
    a = n * w                                   # race exponents, ~O(1)
    nodes, qwts = np.polynomial.legendre.leggauss(n_quad)
    v = 0.5 * (nodes + 1.0)                     # map [-1, 1] -> (0, 1)
    qwts = 0.5 * qwts
    log_v = np.log(v)                           # (Q,)
    pi = np.empty(n)
    blk = max(1, int(4e6) // (n * n_quad))      # ~32 MB f64 per chunk
    for i0 in range(0, n, blk):
        idx = np.arange(i0, min(i0 + blk, n))
        # per-device nodes s_i(v) = v^(1/a_i); p_j = 1 - s^(a_j)
        log_s = log_v[None, :] / a[idx, None]            # (B, Q)
        p = 1.0 - np.exp(log_s[:, :, None] * a[None, None, :])
        p[np.arange(idx.size), :, idx] = 0.0             # leave i out
        q = 1.0 - p
        # F[b, m, c] = P(count == c), counts beyond k - 1 dropped
        f = np.zeros((idx.size, n_quad, k))
        f[:, :, 0] = 1.0
        for j in range(n):
            fp = q[:, :, j:j + 1] * f
            fp[:, :, 1:] += p[:, :, j:j + 1] * f[:, :, :-1]
            f = fp
        pi[idx] = f.sum(axis=2) @ qwts          # integral of P(count <= k-1)
    return np.clip(pi, 0.0, 1.0)


@dataclass
class EnergyAwareSampler(CohortSampler):
    """Probability proportional to per-round energy headroom: E^max minus
    the device's full (rho = 0) local-training energy (Eq. 35), floored
    at ``min_headroom``. Weighted without replacement; the reported
    inclusion probabilities are the exact pi_i of
    ``gumbel_topk_inclusion``.

    Headroom depends only on static device attributes, so the weights
    and the pi vector are cached per (population, config[, U]); the
    cache holds a weakref to the population (never its id(), which
    CPython reuses), so a sampler shared by successive runners
    recomputes.
    """

    min_headroom: float = 1e-6         # floor so every pi_i stays positive
    _cache: Optional[Tuple[Any, Any, np.ndarray]] = \
        field(default=None, repr=False, compare=False)
    _pi_cache: Optional[Tuple[Any, Any, int, np.ndarray]] = \
        field(default=None, repr=False, compare=False)

    def headroom(self, population: Population, ltfl: LTFLConfig
                 ) -> np.ndarray:
        e_comp = local_train_energy(ltfl.wireless, population.channel, 0.0)
        return np.maximum(ltfl.e_max - e_comp, self.min_headroom)

    def _norm_weights(self, population, ltfl) -> np.ndarray:
        if self._cache is not None:
            pop_ref, cfg, w = self._cache
            if pop_ref() is population and cfg is ltfl:
                return w
        head = self.headroom(population, ltfl)
        w = head / np.sum(head)
        self._cache = (weakref.ref(population), ltfl, w)
        return w

    def _inclusion(self, population, ltfl, cohort_size) -> np.ndarray:
        if self._pi_cache is not None:
            pop_ref, cfg, k, pi = self._pi_cache
            if pop_ref() is population and cfg is ltfl \
                    and k == cohort_size:
                return pi
        pi = gumbel_topk_inclusion(self._norm_weights(population, ltfl),
                                   cohort_size)
        self._pi_cache = (weakref.ref(population), ltfl, cohort_size, pi)
        return pi

    def select(self, population, cohort_size, rnd, rng, ltfl):
        w = self._norm_weights(population, ltfl)
        idx = np.sort(rng.choice(population.num_devices, size=cohort_size,
                                 replace=False, p=w))
        pi_all = self._inclusion(population, ltfl, cohort_size)
        pi = np.clip(pi_all[idx], 1e-9, 1.0)
        return idx.astype(np.int64), pi
