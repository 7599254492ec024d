"""The paper-scale federated round engine (edge mode).

Held against ``repro.fed.rounds`` (``FedRunner`` with its legacy
``devices`` view, ``RoundRecord`` with its async ``staleness``,
``HostRoundInputs``, ``evaluate``). One round
(Section 2, Eq. 8-10/14-20):

  1. the scheme supplies vectorized controls (rho_u, delta_u, p_u) — for
     LTFL via Algorithm 1 — and a compressor;
  2. the host numpy stream draws the cohort, the (U, B) batch indices, the
     round seed and the channel outcomes alpha_u ~ Bernoulli(1 - q_u)
     (Eq. 4), in exactly the reference's order, so everything it decides
     is bitwise the reference's;
  3. one call to the round step (``core.ltfl_step``) does all tensor work
     on the device: per-client gradients at the pruned weights, mask,
     quantize (one kernel launch per leaf for all clients), aggregate,
     update;
  4. delay (Eq. 34), energy (Eq. 37) and Gamma (Eq. 29) are charged on
     host in float64, Gamma from the measured per-client gradient ranges.

The round's randomness for the quantizer comes from the round seed: the
reference seeds ``jax.random.PRNGKey(seed)`` with the integer it draws
from the numpy stream; this runner draws the same integer at the same
point and seeds a ``torch.Generator`` on the device with it. ``uniforms``
(see ``core.compressors``) replaces those draws, e.g. with the
reference's own, for parity tests.

The runner runs on ``cuda`` unless ``device`` says otherwise and raises
when no card is present. On the card it turns TF32 off for cuDNN
convolutions and matmuls (the reference is full float32; cuDNN would
otherwise convolve float32 in TF32).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import LTFLConfig
from repro_torch.core.channel import packet_error_rate, sample_transmissions
from repro_torch.core.compressors import UniformSource
from repro_torch.core.convergence import gap_terms
from repro_torch.core.delay_energy import (
    device_round_delay,
    device_round_energy,
)
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.data import (
    ArrayDataset,
    ClientBatcher,
    dirichlet_partition,
    iid_partition,
    population_partition,
)
from repro_torch.fed.population import (
    CohortSampler,
    Population,
    UniformSampler,
)
from repro_torch.fed.schemes import BaseScheme
from repro_torch.models.convert import in_leaf_order
from repro_torch.optim import sgd

Tree = Dict[str, torch.Tensor]

# PER cache bound: distinct power vectors cached per channel/cohort epoch
_PER_CACHE_MAX = 8


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises: the
    port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


class HostRoundInputs(NamedTuple):
    """Everything the host decides for one round, in the exact np_rng
    consumption order of ``FedRunner.run_round``."""

    cohort: np.ndarray          # (U,) scheduled population indices
    ctl: Any                    # the scheme's Controls for this round
    weights: np.ndarray         # (U,) aggregation weights
    agg_denom: Optional[float]  # fixed normalizer (unbiased) or None
    batch_idx: np.ndarray       # (U, B) global sample indices
    seed: int                   # the round seed (reference: its PRNGKey)
    alpha: np.ndarray           # (U,) transmission outcomes (Eq. 4)


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_acc: float
    delay: float
    energy: float
    cum_delay: float
    cum_energy: float
    received: int
    gamma: float
    rho_mean: float
    delta_mean: float
    power_mean: float
    cohort: List[int] = field(default_factory=list)
    participation: float = 1.0
    # buffered-async engine: the cohort's mean staleness tau (rounds
    # since each member's last admitted update); 0 for synchronous rounds
    staleness: float = 0.0


class FedRunner:
    """Shared loop: every scheme runs under identical channel, data and
    accounting.

    ``eval_every`` evaluates test accuracy every k rounds (0 => never);
    ``block_fading`` re-draws the slow fading/interference state of the
    scheduled cohort at the start of every round. Population layer:
    ``population_size`` registers N devices (default
    ``ltfl.num_devices``), ``cohort_size`` schedules U of them per round
    (default all N), ``cohort_sampler`` picks them (default
    ``UniformSampler``), and ``participation`` is ``"cohort"`` (Eq. 19
    over the received cohort) or ``"unbiased"`` (Horvitz-Thompson
    N_i / pi_i weights against the population sample total).

    ``params`` is the model's parameter dict (``model.init`` or
    ``convert.params_from_numpy``); the runner keeps its own copy on
    ``device``. ``uniforms`` injects the quantizer's uniforms."""

    def __init__(self, model, params: Tree, ltfl: LTFLConfig,
                 train: ArrayDataset, test: ArrayDataset,
                 scheme: BaseScheme, *, batch_size: int = 64,
                 non_iid_alpha: float = 0.0, label_key: str = "labels",
                 seed: int = 0, eval_every: int = 1,
                 block_fading: bool = False,
                 population_size: Optional[int] = None,
                 cohort_size: Optional[int] = None,
                 cohort_sampler: Optional[CohortSampler] = None,
                 participation: str = "cohort",
                 device: Union[str, torch.device, None] = None,
                 uniforms: Optional[UniformSource] = None):
        if participation not in ("cohort", "unbiased"):
            raise ValueError(f"participation={participation!r} "
                             "(want 'cohort' or 'unbiased')")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference computes in full float32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model
        self.params = {k: v.detach().to(self.device, torch.float32,
                                         copy=True)
                       for k, v in in_leaf_order(params).items()}
        self.ltfl = ltfl
        self.scheme = scheme
        self.batch_size = batch_size
        self.eval_every = eval_every
        self.block_fading = block_fading
        self.np_rng = np.random.default_rng(seed)
        self._eval_rng_seed = (seed, 0xE7A1)   # fixed eval batches

        n_pop = (int(population_size) if population_size is not None
                 else ltfl.num_devices)
        u = int(cohort_size) if cohort_size is not None else n_pop
        if n_pop < 1:
            raise ValueError(f"population_size={n_pop} must be >= 1")
        if not 1 <= u <= n_pop:
            raise ValueError(f"cohort_size={u} must be in [1, {n_pop}]")
        self.population_size = n_pop
        self.cohort_size = u
        self.num_devices = u          # the step's static client width
        self.participation = participation
        self.sampler = cohort_sampler or UniformSampler()

        self.population = Population.sample(
            ltfl.wireless, n_pop, ltfl.samples_min, ltfl.samples_max,
            self.np_rng)
        self._pop_samples_total = float(
            np.sum(self.population.channel.num_samples))
        self._channel_epoch = 0
        self._cohort_epoch = 0
        self.cohort = np.arange(u, dtype=np.int64)
        self._cohort_probs: Optional[np.ndarray] = None   # set per round
        self.channel = self.population.view(self.cohort)
        self._per_cache: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._per_cache_epoch = (-1, -1)

        sizes = self.population.channel.num_samples
        if non_iid_alpha > 0:
            parts = dirichlet_partition(train.arrays[label_key], sizes,
                                        non_iid_alpha, self.np_rng)
        elif population_size is None:
            parts = iid_partition(train.size, sizes, self.np_rng)
        else:
            parts = population_partition(train.size, sizes, self.np_rng)
        self.batcher = ClientBatcher(train, parts)
        self.test = test

        self.num_params = int(sum(p.numel() for p in self.params.values()))
        # per-device gradient-range mass, persistent across rounds
        self._range_sq_pop = np.full(n_pop, 1e-2 * self.num_params)

        self.opt = sgd(ltfl.learning_rate)
        self.opt_state = self.opt.init(self.params)
        scheme.setup(self)

        self._step = make_fl_train_step(
            model, self.opt, self.num_devices, prune=scheme.uses_prune,
            prune_kind="magnitude",
            compressor=scheme.compressor(uniforms=uniforms))
        self.comp_state = self._step.init_comp_state(self.params)

        self.history: List[RoundRecord] = []
        self._cum_delay = 0.0
        self._cum_energy = 0.0

    # ------------------------------------------------------------------ #
    def _scan_shape_signature(self) -> tuple:
        """Every runner-level value a scanned segment bakes in: shapes
        (cohort width, population, batch, parameter count), the eval
        cadence, the participation rule, block fading and Algorithm 1's
        loop bounds. ``ScanRunner.run_sweep`` runs lanes together only
        when these match; the config floats not listed here are laned
        (``scan_engine._LANED_WIRELESS`` / ``_LANED_LTFL``). The device
        is part of it: a bucket's lanes share one batch."""
        return (self.num_devices, self.population_size, self.batch_size,
                self.num_params, self.eval_every, self.participation,
                self.block_fading, str(self.device),
                int(self.ltfl.bo_iters), int(self.ltfl.alt_max_iters))

    @property
    def devices(self):
        """Legacy tuple-of-``DeviceChannel`` view of the cohort channel
        (reference lines 274-277), what ``controller.solve_reference``
        takes."""
        return self.channel.to_devices()

    @property
    def channel_epoch(self) -> int:
        """Bumped whenever the channel realization changes (block fading)."""
        return self._channel_epoch

    @property
    def cohort_epoch(self) -> int:
        """Bumped whenever the scheduled cohort's composition changes."""
        return self._cohort_epoch

    @property
    def range_sq_estimates(self) -> np.ndarray:
        """(U,) gradient-range mass for the CURRENT cohort."""
        return self._range_sq_pop[self.cohort]

    def _packet_error_rates(self, ctl) -> np.ndarray:
        """(U,) PERs at ctl.power — from the scheme's decision when fresh,
        else from a per-epoch LRU cache keyed on the power vector."""
        if ctl.per is not None:
            return np.asarray(ctl.per, np.float64)
        epoch = (self._channel_epoch, self._cohort_epoch)
        if self._per_cache_epoch != epoch:
            self._per_cache.clear()
            self._per_cache_epoch = epoch
        power = np.asarray(ctl.power, np.float64)
        key = power.tobytes()
        hit = self._per_cache.get(key)
        if hit is not None:
            self._per_cache.move_to_end(key)
            return hit
        per = packet_error_rate(self.ltfl.wireless, self.channel, power)
        self._per_cache[key] = per
        if len(self._per_cache) > _PER_CACHE_MAX:
            self._per_cache.popitem(last=False)
        return per

    def _aggregation_weights(self):
        """Per-round aggregation weights for the cohort view, plus the
        fixed denominator (or None => renormalize over received)."""
        ns = self.channel.num_samples.astype(np.float64)
        if self.participation == "cohort":
            return ns, None
        if self._cohort_probs is None:
            raise ValueError(
                "participation='unbiased' needs a cohort sampler that "
                f"reports inclusion probabilities; "
                f"{type(self.sampler).__name__} does not")
        return ns / np.maximum(self._cohort_probs, 1e-12), \
            self._pop_samples_total

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Tree:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    # ------------------------------------------------------------------ #
    def _eval_batches(self, max_batches: int = 4,
                      batch: int = 256) -> List[Dict[str, np.ndarray]]:
        """The FIXED seeded eval batches ``evaluate`` scores."""
        eval_rng = np.random.default_rng(self._eval_rng_seed)
        return [self.test.batch(batch, eval_rng)
                for _ in range(max_batches)]

    def evaluate(self, max_batches: int = 4, batch: int = 256) -> float:
        """Test accuracy over FIXED eval batches (the rng is re-seeded per
        call, so curves carry no eval sampling noise)."""
        accs = []
        with torch.no_grad():
            for b in self._eval_batches(max_batches, batch):
                accs.append(float(self.model.accuracy(
                    self.params, self._to_device(b))))
        return float(np.mean(accs))

    # ------------------------------------------------------------------ #
    def _host_round_inputs(self, rnd: int) -> HostRoundInputs:
        """Advance all host-side per-round state and return the round's
        inputs, consuming np_rng in the reference's exact order."""
        ltfl, w = self.ltfl, self.ltfl.wireless
        if self.block_fading:
            self.population.advance_epoch()
            self._channel_epoch += 1

        cohort, probs = self.sampler.select(
            self.population, self.cohort_size, rnd, self.np_rng, ltfl)
        cohort = np.asarray(cohort, np.int64)
        if not np.array_equal(cohort, self.cohort):
            self._cohort_epoch += 1      # per-device decisions now stale
        self.cohort = cohort
        self._cohort_probs = None if probs is None \
            else np.asarray(probs, np.float64)
        self.population.refresh_fading(w, cohort, self.np_rng)
        self.channel = self.population.view(cohort)

        ctl = self.scheme.controls(rnd)
        weights, agg_denom = self._aggregation_weights()
        batch_idx = self.batcher.batch_indices(self.batch_size, self.np_rng,
                                               clients=cohort)
        seed = int(self.np_rng.integers(0, 2 ** 31 - 1))
        alpha = sample_transmissions(w, self.channel, ctl.power, self.np_rng)
        return HostRoundInputs(cohort=cohort, ctl=ctl, weights=weights,
                               agg_denom=agg_denom, batch_idx=batch_idx,
                               seed=seed, alpha=alpha)

    def run_round(self, rnd: int) -> RoundRecord:
        ltfl = self.ltfl
        h = self._host_round_inputs(rnd)
        cohort, ctl, alpha = h.cohort, h.ctl, h.alpha

        batch = self._to_device(
            {k: v[h.batch_idx] for k, v in self.batcher.base.arrays.items()})
        f32 = {"rho": ctl.rho, "delta": ctl.delta, "weights": h.weights,
               "alpha": alpha}
        controls = {k: torch.from_numpy(np.asarray(v, np.float32))
                    .to(self.device) for k, v in f32.items()}
        if h.agg_denom is not None:
            controls["agg_denom"] = torch.tensor(
                np.float32(h.agg_denom), device=self.device)

        # all tensor work for the round: one step call (Eq. 8-20)
        self.params, self.opt_state, self.comp_state, m = self._step(
            self.params, self.opt_state, self.comp_state, batch, controls,
            h.seed)
        rsqs = m["range_sq"].cpu().numpy().astype(np.float64)
        self._range_sq_pop[cohort] = rsqs

        # ---- accounting (Eq. 31-37): one array op over the cohort axis - #
        w = ltfl.wireless
        payloads = np.asarray(self.scheme.payload_bits(ctl), np.float64)
        rho = np.asarray(ctl.rho, np.float64)
        power = np.asarray(ctl.power, np.float64)
        delay = float(np.max(device_round_delay(
            w, self.channel, payloads, rho, power))) + ltfl.server_delay
        energy = float(np.sum(device_round_energy(
            w, self.channel, payloads, rho, power)))
        self._cum_delay += delay
        self._cum_energy += energy

        pers = self._packet_error_rates(ctl)
        deltas_for_gap = np.where(ctl.delta > 0, ctl.delta, 32.0)
        gap_kw = ({"inclusion": self._cohort_probs,
                   "population_samples": self._pop_samples_total}
                  if self.participation == "unbiased" else {})
        g_terms = gap_terms(ltfl, rsqs, deltas_for_gap, rho, pers,
                            self.channel.num_samples, **gap_kw)

        rec = RoundRecord(
            round=rnd,
            train_loss=float(m["loss"]),
            test_acc=(self.evaluate()
                      if self.eval_every and rnd % self.eval_every == 0
                      else float("nan")),
            delay=float(delay),
            energy=float(energy),
            cum_delay=self._cum_delay,
            cum_energy=self._cum_energy,
            received=int(np.sum(alpha)),
            gamma=float(g_terms.total),
            rho_mean=float(np.mean(ctl.rho)),
            delta_mean=float(np.mean(ctl.delta)),
            power_mean=float(np.mean(ctl.power)),
            cohort=(cohort.tolist()
                    if self.cohort_size < self.population_size else []),
            participation=self.cohort_size / self.population_size,
        )
        self.history.append(rec)
        self.scheme.post_round(rnd, {"train_loss": rec.train_loss,
                                     "delay": rec.delay,
                                     "test_acc": rec.test_acc})
        return rec

    def run(self, num_rounds: int, log_every: int = 0) -> List[RoundRecord]:
        for rnd in range(num_rounds):
            rec = self.run_round(rnd)
            if log_every and rnd % log_every == 0:
                print(f"[{self.scheme.name}] round={rnd:4d} "
                      f"loss={rec.train_loss:.4f} acc={rec.test_acc:.3f} "
                      f"delay={rec.delay:9.1f}s energy={rec.energy:8.2f}J "
                      f"recv={rec.received}/{self.num_devices}")
        return self.history

    def history_dict(self) -> List[Dict]:
        return [asdict(r) for r in self.history]
