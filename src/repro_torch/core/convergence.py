"""Convergence-gap analytics (paper Theorem 1, Eq. 28-30), host half.

Held against ``repro.core.convergence`` (``GapTerms``, ``gap_terms``,
``gamma``, lines 61-147; ``theorem1_bound``, lines 197-203): the same
float64 numpy arithmetic, bitwise.

Gamma^n (Eq. 29) decomposes the per-round convergence gap into the
quantization, pruning and transmission error terms. ``gap_terms`` reduces
over the LAST axis, so (U,) inputs give scalar terms and (K, U) inputs
give (K,) terms in one array op. ``inclusion`` / ``population_samples``
switch on the Horvitz-Thompson partial-participation convention and
``staleness`` the buffered-async attenuation residual, as in the
reference.

``gamma_dev`` (reference lines 149-196) is the float32 device twin of
``gamma`` for in-segment control. The scanned engine's REPORTED gamma is
not it: the engine logs gamma's per-device inputs and reduces them on
the host in float64 with ``gamma`` (``repro_torch.fed.scan_engine``), so
a sweep lane and its solo run share one code path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import LTFLConfig


@dataclass(frozen=True)
class GapTerms:
    quantization: float   # 3 * sum_u range_sq / (4 (2^delta - 1)^2)
    pruning: float        # 3 L^2 D^2 * sum_u rho_u
    transmission: float   # 12 v1 / N * sum_u N_u q_u
    scale: float          # 1 / (1 - 12 v2)
    participation: float = 0.0   # client-sampling variance proxy (HT)
    staleness: float = 0.0       # buffered-async attenuation residual

    @property
    def total(self) -> float:
        return self.scale * (self.quantization + self.pruning
                             + self.transmission + self.participation
                             + self.staleness)


def gap_terms(ltfl: LTFLConfig,
              range_sq_sums: Sequence[float],
              deltas: Sequence[float],
              rhos: Sequence[float],
              pers: Sequence[float],
              num_samples: Sequence[int],
              *,
              inclusion: Optional[Sequence[float]] = None,
              population_samples: Optional[float] = None,
              staleness: Optional[Sequence[float]] = None) -> GapTerms:
    """Evaluate Eq. 29; the device axis is the LAST axis of each input."""
    deltas = np.asarray(deltas, dtype=np.float64)
    ns = np.asarray(num_samples, np.float64)
    if (inclusion is None) != (population_samples is None):
        raise ValueError(
            "inclusion and population_samples go together: HT-scaled "
            "summands divided by a cohort-only total (or vice versa) "
            "would silently mix conventions")
    if inclusion is not None:
        inv = 1.0 / np.maximum(np.asarray(inclusion, np.float64), 1e-12)
    else:
        inv = 1.0
    steps = np.maximum(2.0 ** deltas - 1.0, 1e-12)
    quant = 3.0 * np.sum(np.asarray(range_sq_sums) * inv
                         / (4.0 * steps * steps), axis=-1)
    prune = 3.0 * ltfl.lipschitz ** 2 * ltfl.d_sq \
        * np.sum(np.asarray(rhos, np.float64) * inv, axis=-1)
    n_total = (float(population_samples) if population_samples is not None
               else float(np.sum(ns)))
    trans = 12.0 * ltfl.v1 / n_total * np.sum(
        ns * np.asarray(pers, np.float64) * inv, axis=-1)
    if inclusion is not None:
        part = 12.0 * ltfl.v1 / n_total ** 2 * np.sum(
            ns * ns * (np.asarray(inv) - 1.0) * inv, axis=-1)
    else:
        part = np.float64(0.0)
    if staleness is not None:
        atten = 1.0 - 1.0 / np.sqrt(
            1.0 + np.asarray(staleness, np.float64))
        stale = 12.0 * ltfl.v1 / n_total * np.sum(ns * atten * inv,
                                                  axis=-1)
    else:
        stale = np.float64(0.0)
    scale = 1.0 / (1.0 - 12.0 * ltfl.v2)
    if quant.ndim == 0 and prune.ndim == 0 and trans.ndim == 0 \
            and np.ndim(part) == 0 and np.ndim(stale) == 0:
        return GapTerms(float(quant), float(prune), float(trans), scale,
                        float(part), float(stale))
    quant, prune, trans, part, stale = np.broadcast_arrays(
        quant, prune, trans, part, stale)
    return GapTerms(quant, prune, trans, scale, part, stale)


def gamma(ltfl: LTFLConfig, range_sq_sums, deltas, rhos, pers,
          num_samples, **kw):
    """Gamma^n (Eq. 29); scalar for (U,) inputs, (K,) for (K, U) inputs."""
    return gap_terms(ltfl, range_sq_sums, deltas, rhos, pers,
                     num_samples, **kw).total


def theorem1_bound(ltfl: LTFLConfig, f0_minus_fstar: float,
                   gammas: Sequence[float]) -> float:
    """Eq. 28: average gradient-norm bound after len(gammas) rounds."""
    omega_plus_1 = max(len(gammas), 1)
    head = (2.0 * ltfl.lipschitz * f0_minus_fstar
            / ((1.0 - 12.0 * ltfl.v2) * omega_plus_1))
    return head + float(np.mean(gammas)) if gammas else head


def gamma_dev(ltfl: LTFLConfig,
              range_sq_sums: torch.Tensor,
              deltas: torch.Tensor,
              rhos: torch.Tensor,
              pers: torch.Tensor,
              num_samples: torch.Tensor,
              *,
              inclusion: Optional[torch.Tensor] = None,
              population_samples=None,
              staleness: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device twin of ``gamma``: Eq. 29 in float32 from (U,) tensors,
    reducing over the last axis; the partial-participation arguments go
    together, as for ``gap_terms``."""
    f = torch.float32
    deltas = deltas.to(f)
    ns = num_samples.to(f)
    if inclusion is not None:
        inv = 1.0 / torch.clamp(inclusion.to(f), min=1e-12)
    else:
        inv = 1.0
    steps = torch.clamp(2.0 ** deltas - 1.0, min=1e-12)
    quant = 3.0 * torch.sum(range_sq_sums.to(f) * inv
                            / (4.0 * steps * steps), dim=-1)
    prune = 3.0 * ltfl.lipschitz ** 2 * ltfl.d_sq \
        * torch.sum(rhos.to(f) * inv, dim=-1)
    if population_samples is not None:
        n_total = torch.as_tensor(population_samples, dtype=f,
                                  device=ns.device)
    else:
        n_total = torch.sum(ns, dim=-1)
    trans = 12.0 * ltfl.v1 / n_total * torch.sum(
        ns * pers.to(f) * inv, dim=-1)
    if inclusion is not None:
        part = 12.0 * ltfl.v1 / n_total ** 2 * torch.sum(
            ns * ns * (inv - 1.0) * inv, dim=-1)
    else:
        part = 0.0
    if staleness is not None:
        atten = 1.0 - 1.0 / torch.sqrt(1.0 + staleness.to(f))
        stale = 12.0 * ltfl.v1 / n_total * torch.sum(ns * atten * inv,
                                                     dim=-1)
    else:
        stale = 0.0
    scale = 1.0 / (1.0 - 12.0 * ltfl.v2)
    return scale * (quant + prune + trans + part + stale)
