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

Each sampler's ``device_twin(runner)`` returns its in-segment scheduler
(``repro_torch.control.device_samplers``) for ``ScanRunner(rng=
"device")``. ``ChurnSpec`` (Bernoulli departures, returns and dropped
uploads) is the buffered-async engine's fleet model
(``repro_torch.fed.async_engine``).

The device registry in blocks (the million-device registry)
-----------------------------------------------------------
Held against the reference's lines 177-321 and its samplers'
``sharded_twin`` (:392, :429, :475, :610). ``PopulationArrays`` holds the
registry on the devices of a ``PopMesh`` (``repro_torch.launch.
sharding``): the (N_pad,) ``ChannelArrays`` leaves and the per-device
fading epochs in S equal blocks, each on its block's device, and the
population epoch. N_pad pads N to S equal blocks with copies of device
0, which every sharded draw masks out. One controller (the runner)
drives all blocks; per round:

* the cohort draw is two-stage (the samplers' ``sharded_twin``;
  ``repro_torch.control.device_samplers``): O(N/S) per block and an
  O(S U) merge;
* ``refresh_cohort_dev`` writes O(U) fresh block-fading values into
  each block, only for the scheduled members whose realization predates
  the epoch: the host ``Population``'s lazy refresh, never an O(N)
  redraw;
* ``gather_cohort_dev`` and ``gather_parts_dev`` assemble the cohort's
  (U,) channel view and (U, W) data-index rows on the controller's
  device: each block reads its members and the owning block's row is
  kept, equal to ``take`` / ``index_select`` on the unsplit registry
  bit for bit.

``host_sync`` folds the blocks back into the host ``Population`` once per
``run``: the fading, the interference and each device's own fading
epoch.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.control.device_samplers import (
    DeviceSamplerTwin,
    _block_gather,
    _block_slots,
    _drop_scatter_,
    channel_aware_twin,
    energy_aware_twin,
    sharded_channel_aware_twin,
    sharded_energy_aware_twin,
    sharded_uniform_twin,
    uniform_twin,
)
from repro_torch.core.channel import (ChannelArrays, ChannelState,
                                      draw_fading_dev, expected_rate)
from repro_torch.core.delay_energy import local_train_energy
from repro_torch.launch.sharding import (PopMesh, population_blocks,
                                         population_pad)


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


class PopulationArrays(NamedTuple):
    """The device registry of ``Population`` in S blocks: ``channel`` is S
    ``ChannelArrays`` of (N_pad / S,) float leaves and ``fading_epoch`` S
    (N_pad / S,) int32 tensors, block s on the mesh's device s; ``epoch``
    is the population epoch (a host int: the engine bumps it once per
    block-fading round, so no device value is read for it). Indices
    [N, N_pad) are copies of device 0 that no cohort contains."""

    channel: Tuple[ChannelArrays, ...]
    fading_epoch: Tuple[torch.Tensor, ...]
    epoch: int


def device_population(population: Population, mesh: PopMesh,
                      dtype: torch.dtype = torch.float32
                      ) -> PopulationArrays:
    """Upload a host ``Population`` in equal blocks over the mesh, padded
    with copies of device 0, floats in ``dtype``. One upload per run."""
    n = population.num_devices
    n_pad = population_pad(n, mesh)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def blocks(x, out_dtype):
        a = np.asarray(x)
        if n_pad > n:
            a = np.concatenate([a, np.broadcast_to(a[0], (n_pad - n,))])
        return population_blocks(a.astype(out_dtype, copy=False), mesh)

    ch = population.channel
    leaves = [blocks(f, np_dtype) for f in (
        ch.distance, ch.fading_mean, ch.interference, ch.cpu_hz,
        ch.num_samples)]
    return PopulationArrays(
        channel=tuple(ChannelArrays(*fs) for fs in zip(*leaves)),
        fading_epoch=tuple(blocks(population.fading_epoch, np.int32)),
        epoch=int(population.epoch))


def _block_size(pop: PopulationArrays) -> int:
    return pop.fading_epoch[0].shape[0]


def refresh_cohort_dev(cfg: WirelessConfig, mesh: PopMesh,
                       pop: PopulationArrays, cohort: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       fresh: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       = None) -> PopulationArrays:
    """The lazy block-fading refresh (the device twin of
    ``Population.refresh_fading``): U fresh (fading, interference) values,
    drawn from ``generator`` (``draw_fading_dev``) or given as ``fresh``,
    land in the blocks for the scheduled members whose realization
    predates ``pop.epoch``, and those members' epochs become
    ``pop.epoch``. Each block translates the (U,) cohort to block-local
    slots and drop-scatters its own members in place: O(U) a block, the
    leaves stay where they are. Returns ``pop``."""
    if fresh is None:
        fresh = draw_fading_dev(cfg, generator, cohort.shape[0])
    new_f, new_i = fresh
    blk = _block_size(pop)
    for ch, fe, sl in zip(pop.channel, pop.fading_epoch,
                          _block_slots(cohort, mesh, blk, cohort.device)):
        dev = fe.device
        stale = torch.index_select(fe, 0, sl.slot) < pop.epoch
        _drop_scatter_(
            (ch.fading_mean, ch.interference, fe), sl, sl.own & stale,
            (new_f.to(dev, ch.fading_mean.dtype),
             new_i.to(dev, ch.interference.dtype), pop.epoch))
    return pop


def gather_cohort_dev(mesh: PopMesh, channel: Sequence[ChannelArrays],
                      cohort: torch.Tensor, device=None) -> ChannelArrays:
    """The (U,) cohort view out of the blocks, on ``device`` (default:
    the cohort's): the sharded twin of ``ChannelArrays.take``, equal to
    it bit for bit. O(U) a block; no block is copied whole."""
    device = cohort.device if device is None else torch.device(device)
    blk = channel[0].distance.shape[0]
    slots = _block_slots(cohort, mesh, blk, device)
    return ChannelArrays(*(
        _block_gather([getattr(c, f) for c in channel], slots, device)
        for f in ChannelArrays._fields))


def gather_parts_dev(mesh: PopMesh, table: Sequence[torch.Tensor],
                     sizes: Sequence[torch.Tensor], cohort: torch.Tensor,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cohort's (U, W) data-index rows and (U,) shard sizes out of
    the per-device index table in blocks (S (N_pad / S, W) int32 blocks
    and S matching size blocks), on ``device``: equal to ``index_select``
    on the unsplit table bit for bit, O(U W) a block."""
    device = cohort.device if device is None else torch.device(device)
    slots = _block_slots(cohort, mesh, table[0].shape[0], device)
    return (_block_gather(table, slots, device),
            _block_gather(sizes, slots, device))


def host_sync(population: Population, pop: PopulationArrays) -> None:
    """Fold the device registry back into the host ``Population`` (one
    (N,) download a leaf, once per ``run``): the realized fading and
    interference, each device's own fading epoch, the population
    epoch."""
    n = population.num_devices

    def host(blocks):
        return torch.cat([b.cpu() for b in blocks]).numpy()[:n]

    ch = population.channel
    ch.fading_mean[:] = host([c.fading_mean for c in pop.channel])
    ch.interference[:] = host([c.interference for c in pop.channel])
    population.fading_epoch[:] = host(pop.fading_epoch)
    population.epoch = int(pop.epoch)


@dataclass(frozen=True)
class ChurnSpec:
    """Bernoulli device churn over the registry, for the async engine.

    Each round, every alive device departs with probability ``p_depart``
    and every departed device returns with probability ``p_return`` (a
    two-state Markov chain over the (N,) registry, stationary alive
    fraction p_return / (p_depart + p_return) when both are positive).
    Independently, each scheduled upload is dropped mid-flight with
    probability ``p_drop``: the device trained and transmitted, so its
    energy is spent, but the update never arrives.

    The async engine applies it as masks over the cohort: the registry,
    the sampler and the channel state keep their shapes; a departed or
    dropped device never arrives, so it misses the buffer and its
    staleness keeps aging."""

    p_depart: float = 0.0
    p_return: float = 0.0
    p_drop: float = 0.0

    def __post_init__(self):
        for name in ("p_depart", "p_return", "p_drop"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability in "
                                 f"[0, 1], got {v}")


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

    def device_twin(self, runner) -> Optional[DeviceSamplerTwin]:
        """The in-segment scheduler for ``ScanRunner(rng="device")``, or
        None for a host-only scheduler (the engine then raises)."""
        return None

    def sharded_twin(self, runner, mesh: PopMesh
                     ) -> Optional[DeviceSamplerTwin]:
        """The two-stage scheduler over a registry in blocks
        (``ScanRunner(population_sharding=...)``; ``select(blocks,
        generator)``), or None when this scheduler has none (the engine
        then raises). Its draws come from per-block generators seeded
        from ``runner.seed``; the energy-aware one reports first-order
        inclusion probabilities."""
        return None


@dataclass
class UniformSampler(CohortSampler):
    """Uniform without replacement: exact inclusion probability U/N."""

    def select(self, population, cohort_size, rnd, rng, ltfl):
        n = population.num_devices
        if cohort_size == n:            # full participation: identity cohort
            return np.arange(n, dtype=np.int64), np.ones(n)
        idx = np.sort(rng.choice(n, size=cohort_size, replace=False))
        return idx.astype(np.int64), np.full(cohort_size, cohort_size / n)

    def device_twin(self, runner) -> DeviceSamplerTwin:
        return uniform_twin(runner.population_size, runner.cohort_size)

    def sharded_twin(self, runner, mesh: PopMesh) -> DeviceSamplerTwin:
        return sharded_uniform_twin(runner.population_size,
                                    runner.cohort_size, mesh,
                                    seed=runner.seed, device=runner.device)


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

    def device_twin(self, runner) -> DeviceSamplerTwin:
        return channel_aware_twin(runner.population_size,
                                  runner.cohort_size, runner.ltfl,
                                  power=self.power, explore=self.explore)

    def sharded_twin(self, runner, mesh: PopMesh) -> DeviceSamplerTwin:
        return sharded_channel_aware_twin(
            runner.population_size, runner.cohort_size, runner.ltfl, mesh,
            power=self.power, explore=self.explore, seed=runner.seed,
            device=runner.device)


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

    def device_twin(self, runner) -> DeviceSamplerTwin:
        # the twin recomputes the headroom weights on the device from the
        # population view, so it is right for every sweep lane's own
        # population
        return energy_aware_twin(runner.ltfl, runner.cohort_size,
                                 min_headroom=self.min_headroom)

    def sharded_twin(self, runner, mesh: PopMesh) -> DeviceSamplerTwin:
        return sharded_energy_aware_twin(
            runner.ltfl, runner.population_size, runner.cohort_size, mesh,
            min_headroom=self.min_headroom, seed=runner.seed,
            device=runner.device)
