"""Algorithm 1 on the device: Theorems 2/3 in closed form and the
Bayesian-optimized power control, as tensor ops that never read a value
back to the host.

Held against ``repro.control.device_controller`` (``DeviceDecision``,
``optimal_rho_dev``, ``optimal_delta_dev``, ``evaluate_dev``,
``solve_dev``): the device twin of ``repro_torch.core.controller.solve``,
the same alternation (Stage 1: Theorem 2's rho* and Theorem 3's delta*;
Stage 2: BO over the power vector; stop on Eq. 57) over a
``ChannelArrays`` view, so ``ScanRunner(control="device")`` re-solves
Algorithm 1 every round against that round's fading and cohort without
leaving the segment.

The contract:

* float32 throughout (the host controller is float64): decisions are
  held to ``controller.solve`` by tolerance on seeded channels with the
  host's BO stream injected (tests/test_torch_device_control.py);
* the closed forms keep the host clamps: an infeasible budget clamps rho
  to rho_max and delta to 1, never NaN; delta is a float32
  integer-valued tensor;
* config values may be Python floats or 0-d float32 tensors (a sweep
  lane's laned view); where the reference casts a value to float32 this
  module does too (``f32``), so both kinds compute the same;
* all loop bounds are static. The reference stops the alternation with
  a ``lax.while_loop`` on Eq. 57; reading that condition here would sync
  with the host, so all ``alt_max_iters`` alternations run and a
  ``done`` flag freezes the carry (powers, deltas, previous gamma) once
  |prev_gamma - gamma| <= alt_tol. The decision is the while loop's.
  Every alternation's draws are made up front with a leading
  (alt_max_iters,) axis, so a solve consumes the same amount of the
  lane's stream whenever it stops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import LTFLConfig
from repro_torch.control.device_bayesopt import (
    BODraws,
    make_draws,
    minimize_dev,
)
from repro_torch.core.channel import (
    ChannelArrays,
    expected_rate_dev,
    f32,
    packet_error_rate_dev,
)
from repro_torch.core.controller import _PENALTY
from repro_torch.core.convergence import gamma_dev
from repro_torch.core.delay_energy import (
    device_round_delay_dev,
    device_round_energy_dev,
)
from repro_torch.core.quantization import payload_bits


class DeviceDecision(NamedTuple):
    """Device twin of ``controller.ControlDecision``: (U,) float32
    controls, the 0-d Gamma^n at the decision and the number of
    alternations that ran before Eq. 57 froze the carry (int64, 0-d)."""

    rho: torch.Tensor           # (U,) pruning ratios
    delta: torch.Tensor         # (U,) quantization bits (integer-valued)
    power: torch.Tensor         # (U,) transmission powers (W)
    per: torch.Tensor           # (U,) packet error rates at the decision
    gamma: torch.Tensor         # () Gamma^n at the decision
    alternations: torch.Tensor  # () alternations run


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """clip(x, lo, hi) for bounds that are numbers or tensors."""
    return torch.clamp(torch.clamp(x, min=lo), max=hi)


# --------------------------------------------------------------------------- #
# Theorems 2/3
# --------------------------------------------------------------------------- #
def optimal_rho_dev(ltfl: LTFLConfig, ch: ChannelArrays, payload,
                    power: torch.Tensor) -> torch.Tensor:
    """Theorem 2 (Eq. 40-42), device twin of ``controller.optimal_rho``:
    (U,) payload/power -> (U,) rho*. Infeasible budgets (phi1/phi2 <= 0)
    clamp to rho_max through the formula's own clip."""
    w = ltfl.wireless
    power = power.to(torch.float32)
    rate = torch.clamp(expected_rate_dev(w, ch, power), min=1e-30)
    c0 = f32(w.cycles_per_sample)
    t_budget = f32(ltfl.t_max) - f32(ltfl.server_delay)
    t_comp = ch.num_samples * c0 / ch.cpu_hz
    phi1 = t_budget / (t_comp + payload / rate)
    e_comp = (f32(w.k_eff) * ch.cpu_hz ** (f32(w.sigma_exp) - 1.0)
              * ch.num_samples * c0)
    phi2 = f32(ltfl.e_max) / (e_comp + power * payload / rate)
    return _clip(1.0 - torch.minimum(phi1, phi2), 0.0, f32(ltfl.rho_max))


def optimal_delta_dev(ltfl: LTFLConfig, ch: ChannelArrays,
                      rho: torch.Tensor, power: torch.Tensor,
                      num_params: int) -> torch.Tensor:
    """Theorem 3 (Eq. 44-46), device twin of ``controller.optimal_delta``:
    (U,) rho/power -> (U,) float32 integer-valued delta*. Infeasible
    budgets (phi3/phi4 <= xi, a vanishing rate) clamp to delta = 1,
    never NaN: the host clamp chain."""
    w = ltfl.wireless
    power = power.to(torch.float32)
    rate = torch.clamp(expected_rate_dev(w, ch, power), min=1e-30)
    keep = torch.clamp(1.0 - rho.to(torch.float32), min=1e-9)
    c0 = f32(w.cycles_per_sample)
    t_budget = f32(ltfl.t_max) - f32(ltfl.server_delay)
    xi = f32(ltfl.xi_bits)
    delta_max = f32(ltfl.delta_max)
    t_comp = ch.num_samples * c0 * keep / ch.cpu_hz
    phi3 = (t_budget - t_comp) * rate / keep
    e_comp = (f32(w.k_eff) * ch.cpu_hz ** (f32(w.sigma_exp) - 1.0)
              * ch.num_samples * c0 * keep)
    phi4 = (f32(ltfl.e_max) - e_comp) * rate / (power * keep)
    v_eff = f32(num_params) * keep      # pruned grads are not uploaded
    raw = torch.minimum(torch.minimum((phi3 - xi) / v_eff,
                                      (phi4 - xi) / v_eff),
                        torch.zeros_like(keep) + delta_max)
    raw = torch.where(torch.isnan(raw), 1.0, raw)
    return _clip(torch.floor(raw), 1.0, delta_max)


def evaluate_dev(ltfl: LTFLConfig, ch: ChannelArrays,
                 range_sq_sums: torch.Tensor, rhos: torch.Tensor,
                 deltas: torch.Tensor, powers: torch.Tensor,
                 num_params: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``controller._evaluate``: Gamma^n and feasibility of
    (38b)/(38c) at the given controls. ``powers`` is one (U,) vector or a
    (K, U) batch of candidates: (gamma, feasible) are then 0-d or (K,).
    One expected-rate quadrature serves the delay and the energy."""
    w = ltfl.wireless
    p = powers.to(torch.float32)
    rhos = rhos.to(torch.float32)
    deltas = deltas.to(torch.float32)
    pers = packet_error_rate_dev(w, ch, p)                    # (..., U)
    g = gamma_dev(ltfl, range_sq_sums.to(torch.float32), deltas, rhos,
                  pers, ch.num_samples)
    payload = payload_bits(num_params, deltas, ltfl.xi_bits)
    rate = expected_rate_dev(w, ch, p)
    t = device_round_delay_dev(w, ch, payload, rhos, p, rate=rate) \
        + ltfl.server_delay
    e = device_round_energy_dev(w, ch, payload, rhos, p, rate=rate)
    feasible = (torch.all(t <= ltfl.t_max * (1 + 1e-9), dim=-1)
                & torch.all(e <= ltfl.e_max * (1 + 1e-9), dim=-1))
    return g, feasible


# --------------------------------------------------------------------------- #
# Algorithm 1
# --------------------------------------------------------------------------- #
def solve_dev(ltfl: LTFLConfig, ch: ChannelArrays, num_params: int,
              range_sq_sums: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None, *,
              draws: Optional[BODraws] = None,
              n_candidates: int = 512,
              init_points: int = 4) -> DeviceDecision:
    """Algorithm 1 on the device: alternate Theorem 2 / Theorem 3 / BO
    until Eq. 57, with no host sync.

    ``generator`` draws every alternation's BO draws up front;
    ``draws`` instead injects a ``BODraws`` with a leading
    (alt_max_iters,) axis (the parity tests feed the host optimizer's
    numpy stream through it). Exactly one of the two must be given.
    ``range_sq_sums`` defaults to the host solver's prior (1e-2 *
    num_params per device)."""
    if (generator is None) == (draws is None):
        raise ValueError("pass exactly one of generator= or draws=")
    w = ltfl.wireless
    device = ch.distance.device
    u = ch.distance.shape[0]
    n_alt = int(ltfl.alt_max_iters)
    if range_sq_sums is None:
        range_sq = torch.full((u,), 1e-2 * num_params, dtype=torch.float32,
                              device=device)
    else:
        range_sq = range_sq_sums.to(torch.float32)
    if draws is None:
        draws = make_draws(generator, int(ltfl.bo_iters), init_points,
                           n_candidates, u, device, alternations=n_alt)
    zeros = torch.zeros((u,), dtype=torch.float32, device=device)
    p_min, p_max = f32(w.p_min), f32(w.p_max)
    bounds = torch.stack([zeros + p_min, zeros + p_max], dim=1)

    def stage1(deltas, powers):
        """Theorems 2 + 3 for all devices at the current powers."""
        payload = payload_bits(num_params, deltas, ltfl.xi_bits)
        rhos = optimal_rho_dev(ltfl, ch, payload, powers)
        return rhos, optimal_delta_dev(ltfl, ch, rhos, powers, num_params)

    def objective(rhos, deltas):
        def obj(p_mat):
            """(K, U) candidate powers -> (K,) penalized Gamma values."""
            g, feasible = evaluate_dev(ltfl, ch, range_sq, rhos, deltas,
                                       p_mat, num_params)
            return g + torch.where(feasible, 0.0, _PENALTY)
        return obj

    powers = zeros + 0.5 * (p_min + p_max)
    deltas = zeros + f32(ltfl.delta_max)
    prev_gamma = torch.full((), float("inf"), dtype=torch.float32,
                            device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    ran = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(n_alt):
        active = ~done
        # --- Stage 1: Theorems 2/3 (closed form) ------------------------ #
        rhos_k, deltas_k = stage1(deltas, powers)
        # --- Stage 2: BO over p (problem P4) ---------------------------- #
        dk = BODraws(*(x[k] for x in draws))
        powers_k, _ = minimize_dev(objective(rhos_k, deltas_k), bounds, dk,
                                   xi=ltfl.bo_xi)
        g, _ = evaluate_dev(ltfl, ch, range_sq, rhos_k, deltas_k, powers_k,
                            num_params)
        # the while loop's carry, frozen once Eq. 57 has held
        powers = torch.where(active, powers_k, powers)
        deltas = torch.where(active, deltas_k, deltas)
        done = done | (active & (torch.abs(prev_gamma - g) <= ltfl.alt_tol))
        prev_gamma = torch.where(active, g, prev_gamma)
        ran = ran + active.to(torch.int64)

    # final Stage-1 pass at the chosen powers, as the host solve does
    rhos, deltas = stage1(deltas, powers)
    gamma, _ = evaluate_dev(ltfl, ch, range_sq, rhos, deltas, powers,
                            num_params)
    per = packet_error_rate_dev(w, ch, powers)
    return DeviceDecision(rho=rhos, delta=deltas, power=powers, per=per,
                          gamma=gamma, alternations=ran)
