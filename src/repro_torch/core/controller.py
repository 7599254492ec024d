"""Two-stage LTFL controller (paper Section 5, Algorithm 1).

Held against ``repro.core.controller`` (``optimal_rho``, ``optimal_delta``,
``_evaluate``, ``solve``, and the scalar ``_evaluate_reference`` and
``solve_reference``): the same float64 numpy arithmetic and rng
consumption, so a seeded ``solve`` or ``solve_reference`` returns
bitwise the reference's decision. Payloads come from the port's own
float32 formula (``payload_bits_host``, or ``payload_bits`` on one
device's numbers), as the reference's jnp ``payload_bits`` evaluates it:
one float32 product and one float32 sum.

Stage 1 (closed form): Theorem 2 gives the optimal pruning ratio rho*
(Eq. 40-42), Theorem 3 the optimal quantization level delta* (Eq. 44-46),
given the current power vector. Stage 2: Bayesian optimization over the
power vector p (problem P4). The stages alternate until the Gamma gap
change falls below varrho (Eq. 57). Every stage broadcasts over the
device axis of a ``ChannelState``; ``_evaluate`` also batches over (K, U)
candidate power matrices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import LTFLConfig
from repro_torch.core import bayesopt
from repro_torch.core.channel import (
    ChannelState,
    DeviceChannel,
    as_channel_state,
    expected_rate,
    packet_error_rate,
)
from repro_torch.core.convergence import gamma as gamma_fn
from repro_torch.core.delay_energy import (
    device_round_delay,
    device_round_energy,
)
from repro_torch.core.quantization import payload_bits, payload_bits_host

_PENALTY = 1e9


@dataclass
class ControlDecision:
    rho: np.ndarray          # (U,) pruning ratios
    delta: np.ndarray        # (U,) quantization bits (int)
    power: np.ndarray        # (U,) transmission powers (W)
    per: np.ndarray          # (U,) packet error rates at chosen powers
    gamma: float             # Gamma^n at the decision
    alternations: int        # outer iterations used
    gamma_trace: np.ndarray  # Gamma per outer iteration


def optimal_rho(ltfl: LTFLConfig, dev: Union[ChannelState, DeviceChannel],
                payload, power):
    """Theorem 2 (Eq. 40-42): ``ChannelState`` + (U,) payload/power ->
    (U,) rho*; the scalar ``DeviceChannel`` signature returns a float."""
    scalar = isinstance(dev, DeviceChannel)
    w = ltfl.wireless
    payload = np.asarray(payload, np.float64)
    power = np.asarray(power, np.float64)
    rate = np.maximum(expected_rate(w, dev, power), 1e-30)
    n = np.asarray(dev.num_samples, np.float64)
    cpu = np.asarray(dev.cpu_hz, np.float64)
    t_comp = n * w.cycles_per_sample / cpu
    phi1 = (ltfl.t_max - ltfl.server_delay) / (t_comp + payload / rate)
    e_comp = w.k_eff * cpu ** (w.sigma_exp - 1.0) * n * w.cycles_per_sample
    phi2 = ltfl.e_max / (e_comp + power * payload / rate)
    rho = np.clip(1.0 - np.minimum(phi1, phi2), 0.0, ltfl.rho_max)
    return float(rho) if scalar else rho


def optimal_delta(ltfl: LTFLConfig, dev: Union[ChannelState, DeviceChannel],
                  rho, power, num_params: int):
    """Theorem 3 (Eq. 44-46): ``ChannelState`` + (U,) rho/power -> (U,) int
    delta*. Infeasible budgets clamp to delta = 1, never NaN."""
    scalar = isinstance(dev, DeviceChannel)
    w = ltfl.wireless
    power = np.asarray(power, np.float64)
    rate = np.maximum(expected_rate(w, dev, power), 1e-30)
    keep = np.maximum(1.0 - np.asarray(rho, np.float64), 1e-9)
    n = np.asarray(dev.num_samples, np.float64)
    cpu = np.asarray(dev.cpu_hz, np.float64)
    t_comp = n * w.cycles_per_sample * keep / cpu
    phi3 = (ltfl.t_max - ltfl.server_delay - t_comp) * rate / keep
    e_comp = (w.k_eff * cpu ** (w.sigma_exp - 1.0)
              * n * w.cycles_per_sample * keep)
    phi4 = (ltfl.e_max - e_comp) * rate / (power * keep)
    # Eq. 44 with delta~ = V delta + xi; floor = "min positive integer <= x"
    v_eff = num_params * keep   # pruned grads are not uploaded (Eq. 32)
    raw = np.minimum(np.minimum((phi3 - ltfl.xi_bits) / v_eff,
                                (phi4 - ltfl.xi_bits) / v_eff),
                     float(ltfl.delta_max))
    raw = np.where(np.isnan(raw), 1.0, raw)
    delta = np.clip(np.floor(raw), 1, ltfl.delta_max).astype(np.int64)
    return int(delta) if scalar else delta


def _evaluate(ltfl: LTFLConfig, devices, range_sq_sums, rhos, deltas,
              powers, num_params: int):
    """Gamma^n + feasibility of (38b)/(38c) at the given controls.
    ``powers`` may be one (U,) vector or a (K, U) batch of candidates."""
    w = ltfl.wireless
    state = as_channel_state(devices)
    p = np.asarray(powers, np.float64)
    rhos = np.asarray(rhos, np.float64)
    deltas = np.asarray(deltas, np.float64)
    pers = packet_error_rate(w, state, p)                     # (..., U)
    g = gamma_fn(ltfl, np.asarray(range_sq_sums, np.float64), deltas,
                 rhos, pers, state.num_samples)
    payload = payload_bits_host(num_params, deltas, ltfl.xi_bits)
    # one expected-rate quadrature shared by the delay AND energy batches
    rate = expected_rate(w, state, p)
    t = device_round_delay(w, state, payload, rhos, p, rate=rate) \
        + ltfl.server_delay
    e = device_round_energy(w, state, payload, rhos, p, rate=rate)
    feasible = (np.all(t <= ltfl.t_max * (1 + 1e-9), axis=-1)
                & np.all(e <= ltfl.e_max * (1 + 1e-9), axis=-1))
    return g, feasible


def solve(ltfl: LTFLConfig,
          devices: Union[ChannelState, Sequence[DeviceChannel]],
          num_params: int,
          range_sq_sums: Optional[Sequence[float]] = None,
          rng: Optional[np.random.Generator] = None,
          verbose: bool = False) -> ControlDecision:
    """Algorithm 1: alternate Theorem 2 / Theorem 3 / BO until Eq. 57."""
    state = as_channel_state(devices)
    rng = rng or np.random.default_rng(ltfl.seed)
    u = state.num_devices
    if range_sq_sums is None:
        # conservative prior for the per-device gradient range mass
        range_sq_sums = np.full(u, 1e-2 * num_params)
    range_sq = np.asarray(range_sq_sums, np.float64)
    w = ltfl.wireless

    powers = np.full(u, 0.5 * (w.p_min + w.p_max))
    deltas = np.full(u, ltfl.delta_max, dtype=np.int64)
    prev_gamma = np.inf
    trace = []

    def stage1(deltas: np.ndarray, powers: np.ndarray):
        """Theorems 2 + 3 for all devices at the current powers."""
        payload = payload_bits_host(num_params, deltas, ltfl.xi_bits)
        rhos = optimal_rho(ltfl, state, payload, powers)
        return rhos, optimal_delta(ltfl, state, rhos, powers, num_params)

    for k in range(ltfl.alt_max_iters):
        rhos, deltas = stage1(deltas, powers)

        def objective(p_mat: np.ndarray) -> np.ndarray:
            """(K, U) candidate powers -> (K,) penalized Gamma values."""
            g, feasible = _evaluate(ltfl, state, range_sq, rhos, deltas,
                                    p_mat, num_params)
            return np.asarray(g) + np.where(feasible, 0.0, _PENALTY)

        bounds = np.tile([[w.p_min, w.p_max]], (u, 1))
        res = bayesopt.minimize(objective, bounds, iters=ltfl.bo_iters,
                                rng=rng, xi=ltfl.bo_xi, vectorized=True)
        powers = res.x_best

        g, _ = _evaluate(ltfl, state, range_sq, rhos, deltas, powers,
                         num_params)
        g = float(g)
        trace.append(g)
        if verbose:
            print(f"[controller] k={k} gamma={g:.6g} "
                  f"rho_mean={rhos.mean():.3f} delta_mean={deltas.mean():.2f}")
        if abs(prev_gamma - g) <= ltfl.alt_tol:          # Eq. 57
            prev_gamma = g
            break
        prev_gamma = g

    # final Stage-1 pass at the chosen powers, so the returned decision is
    # feasible even when the loop exits right after a power update
    rhos, deltas = stage1(deltas, powers)
    final_gamma, _ = _evaluate(ltfl, state, range_sq, rhos, deltas, powers,
                               num_params)

    pers = packet_error_rate(w, state, powers)
    return ControlDecision(rho=rhos, delta=deltas, power=powers, per=pers,
                           gamma=float(final_gamma), alternations=k + 1,
                           gamma_trace=np.asarray(trace))


# --------------------------------------------------------------------------- #
# Legacy scalar reference (parity baseline + benchmark comparison)
# --------------------------------------------------------------------------- #
def _payload(num_params: int, delta, xi_bits: int) -> float:
    """One device's Eq. 18 payload in float32, as a Python float."""
    return float(payload_bits(num_params, delta, xi_bits))


def _evaluate_reference(ltfl: LTFLConfig, devices, range_sq_sums, rhos,
                        deltas, powers, num_params: int) -> Tuple[float, bool]:
    """The per-device-loop ``_evaluate`` of one (U,) power vector, kept
    as the reference keeps it (``repro.core.controller``, lines
    236-253)."""
    w = ltfl.wireless
    pers = [float(packet_error_rate(w, d, np.asarray(p)))
            for d, p in zip(devices, powers)]
    g = gamma_fn(ltfl, range_sq_sums, deltas, rhos, pers,
                 [d.num_samples for d in devices])
    feasible = True
    for dev, rho, delta, p in zip(devices, rhos, deltas, powers):
        payload = _payload(num_params, delta, ltfl.xi_bits)
        t = device_round_delay(w, dev, payload, rho, p) + ltfl.server_delay
        e = device_round_energy(w, dev, payload, rho, p)
        if t > ltfl.t_max * (1 + 1e-9) or e > ltfl.e_max * (1 + 1e-9):
            feasible = False
            break
    return g, feasible


def _stage1_reference(ltfl: LTFLConfig, devices, deltas, powers,
                      num_params: int):
    """Theorems 2 and 3, one Python call per device."""
    rhos = np.array([
        optimal_rho(ltfl, dev, _payload(num_params, deltas[i], ltfl.xi_bits),
                    float(powers[i]))
        for i, dev in enumerate(devices)])
    deltas = np.array([
        optimal_delta(ltfl, dev, float(rhos[i]), float(powers[i]),
                      num_params)
        for i, dev in enumerate(devices)])
    return rhos, deltas


def solve_reference(ltfl: LTFLConfig, devices: Sequence[DeviceChannel],
                    num_params: int,
                    range_sq_sums: Optional[Sequence[float]] = None,
                    rng: Optional[np.random.Generator] = None,
                    verbose: bool = False) -> ControlDecision:
    """The scalar Algorithm 1: O(U) Python calls per stage, on a tuple of
    ``DeviceChannel`` (a ``ChannelState`` is split into one). Held
    against ``repro.core.controller.solve_reference`` (lines 256-330):
    the same seeded rng stream, so the decision is bitwise the
    reference's and ``solve``'s."""
    if isinstance(devices, ChannelState):
        devices = devices.to_devices()
    rng = rng or np.random.default_rng(ltfl.seed)
    u = len(devices)
    if range_sq_sums is None:
        range_sq_sums = [1e-2 * num_params] * u
    w = ltfl.wireless

    powers = np.full(u, 0.5 * (w.p_min + w.p_max))
    deltas = np.full(u, ltfl.delta_max, dtype=np.int64)
    prev_gamma = np.inf
    trace = []

    for k in range(ltfl.alt_max_iters):
        rhos, deltas = _stage1_reference(ltfl, devices, deltas, powers,
                                         num_params)

        def objective(p_vec: np.ndarray) -> float:
            g, feasible = _evaluate_reference(ltfl, devices, range_sq_sums,
                                              rhos, deltas, p_vec, num_params)
            return g if feasible else g + _PENALTY

        bounds = np.tile([[w.p_min, w.p_max]], (u, 1))
        res = bayesopt.minimize(objective, bounds, iters=ltfl.bo_iters,
                                rng=rng, xi=ltfl.bo_xi)
        powers = res.x_best

        g, _ = _evaluate_reference(ltfl, devices, range_sq_sums, rhos, deltas,
                                   powers, num_params)
        trace.append(g)
        if verbose:
            print(f"[controller] k={k} gamma={g:.6g} "
                  f"rho_mean={rhos.mean():.3f} delta_mean={deltas.mean():.2f}")
        if abs(prev_gamma - g) <= ltfl.alt_tol:          # Eq. 57
            prev_gamma = g
            break
        prev_gamma = g

    rhos, deltas = _stage1_reference(ltfl, devices, deltas, powers,
                                     num_params)
    final_gamma, _ = _evaluate_reference(ltfl, devices, range_sq_sums, rhos,
                                         deltas, powers, num_params)

    pers = np.array([float(packet_error_rate(w, d, np.asarray(p)))
                     for d, p in zip(devices, powers)])
    return ControlDecision(rho=rhos, delta=deltas, power=powers, per=pers,
                           gamma=float(final_gamma), alternations=k + 1,
                           gamma_trace=np.asarray(trace))
