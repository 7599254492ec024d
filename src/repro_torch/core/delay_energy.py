"""Per-round delay and energy models (paper Section 4.1-4.2, Eq. 31-37),
host half.

Held against ``repro.core.delay_energy`` (lines 33-100): the same float64
numpy arithmetic, bitwise. Every function accepts a scalar
``DeviceChannel`` or a ``ChannelState`` of (U,) arrays, in which case
``payload_bits`` / ``rho`` / ``power`` broadcast over the device axis and
any leading candidate axes. ``rate=`` lets one expected-rate quadrature
serve both the delay and energy evaluations.

The ``*_dev`` twins, ``round_accounting_dev`` and the buffered-async
engine's ``buffered_round_accounting_dev`` (held against the reference's
lines 103-196) evaluate the same formulas in float32 over a
``ChannelArrays`` view on the device, for the scanned engine; they
broadcast over a leading lane axis too, where the config's floats are
(L, 1) tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.core.channel import (
    ChannelArrays,
    as_channel_state,
    expected_rate,
    expected_rate_dev,
    f32,
)


def local_train_delay(cfg: WirelessConfig, dev, rho) -> np.ndarray:
    """Eq. 31: T_lt = N_u c0 (1 - rho) / f_u."""
    return (np.asarray(dev.num_samples, np.float64) * cfg.cycles_per_sample
            * (1.0 - np.asarray(rho, np.float64)) / np.asarray(dev.cpu_hz))


def upload_delay(cfg: WirelessConfig, dev, payload_bits, rho,
                 power, *, rate=None) -> np.ndarray:
    """Eq. 32: T_lu = delta~ (1 - rho) / R(p)."""
    if rate is None:
        rate = expected_rate(cfg, dev, np.asarray(power, np.float64))
    return (np.asarray(payload_bits, np.float64)
            * (1.0 - np.asarray(rho, np.float64))
            / np.maximum(rate, 1e-9))


def local_train_energy(cfg: WirelessConfig, dev, rho) -> np.ndarray:
    """Eq. 35: E_lt = k f^sigma T_lt = k f^(sigma-1) N c0 (1 - rho)."""
    return (cfg.k_eff * np.asarray(dev.cpu_hz) ** (cfg.sigma_exp - 1.0)
            * np.asarray(dev.num_samples, np.float64)
            * cfg.cycles_per_sample * (1.0 - np.asarray(rho, np.float64)))


def upload_energy(cfg: WirelessConfig, dev, payload_bits, rho,
                  power, *, rate=None) -> np.ndarray:
    """Eq. 36: E_lu = p * T_lu."""
    return (np.asarray(power, np.float64)
            * upload_delay(cfg, dev, payload_bits, rho, power, rate=rate))


def device_round_delay(cfg: WirelessConfig, dev, payload_bits, rho,
                       power, *, rate=None) -> np.ndarray:
    return (local_train_delay(cfg, dev, rho)
            + upload_delay(cfg, dev, payload_bits, rho, power, rate=rate))


def device_round_energy(cfg: WirelessConfig, dev, payload_bits, rho,
                        power, *, rate=None) -> np.ndarray:
    """Eq. 37: E = E_lt + E_lu."""
    return (local_train_energy(cfg, dev, rho)
            + upload_energy(cfg, dev, payload_bits, rho, power, rate=rate))


def round_delay(ltfl: LTFLConfig, devices, payload_bits: Sequence[float],
                rhos: Sequence[float], powers: Sequence[float]) -> float:
    """Eq. 34: T = max_u(T_lt + T_lu) + s (stragglers gate the round)."""
    state = as_channel_state(devices)
    per_dev = device_round_delay(
        ltfl.wireless, state, np.asarray(payload_bits, np.float64),
        np.asarray(rhos, np.float64), np.asarray(powers, np.float64))
    return float(np.max(per_dev)) + ltfl.server_delay


def round_energy(ltfl: LTFLConfig, devices, payload_bits: Sequence[float],
                 rhos: Sequence[float], powers: Sequence[float]) -> float:
    """Total round energy: sum_u E_u (Eq. 37 summed over devices)."""
    state = as_channel_state(devices)
    per_dev = device_round_energy(
        ltfl.wireless, state, np.asarray(payload_bits, np.float64),
        np.asarray(rhos, np.float64), np.asarray(powers, np.float64))
    return float(np.sum(per_dev))


# --------------------------------------------------------------------------- #
# device twins (float32, used inside the scanned engine's segment loop)
# --------------------------------------------------------------------------- #
def local_train_delay_dev(cfg: WirelessConfig, ch: ChannelArrays,
                          rho: torch.Tensor) -> torch.Tensor:
    """Eq. 31 on the device: T_lt = N_u c0 (1 - rho) / f_u."""
    return (ch.num_samples * f32(cfg.cycles_per_sample)
            * (1.0 - rho) / ch.cpu_hz)


def upload_delay_dev(cfg: WirelessConfig, ch: ChannelArrays,
                     payload_bits: torch.Tensor, rho: torch.Tensor,
                     power: torch.Tensor, *,
                     rate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 32 on the device: T_lu = delta~ (1 - rho) / R(p)."""
    if rate is None:
        rate = expected_rate_dev(cfg, ch, power)
    return payload_bits * (1.0 - rho) / torch.clamp(rate, min=1e-9)


def local_train_energy_dev(cfg: WirelessConfig, ch: ChannelArrays,
                           rho) -> torch.Tensor:
    """Eq. 35 on the device: E_lt = k f^(sigma-1) N c0 (1 - rho)."""
    return (f32(cfg.k_eff)
            * ch.cpu_hz ** (f32(cfg.sigma_exp) - np.float32(1.0))
            * ch.num_samples
            * f32(cfg.cycles_per_sample)
            * (1.0 - rho))


def device_round_delay_dev(cfg: WirelessConfig, ch: ChannelArrays,
                           payload_bits: torch.Tensor, rho: torch.Tensor,
                           power: torch.Tensor, *,
                           rate: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    return (local_train_delay_dev(cfg, ch, rho)
            + upload_delay_dev(cfg, ch, payload_bits, rho, power,
                               rate=rate))


def device_round_energy_dev(cfg: WirelessConfig, ch: ChannelArrays,
                            payload_bits: torch.Tensor, rho: torch.Tensor,
                            power: torch.Tensor, *,
                            rate: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Eq. 37 on the device: E = E_lt + p * T_lu."""
    return (local_train_energy_dev(cfg, ch, rho)
            + power * upload_delay_dev(cfg, ch, payload_bits, rho, power,
                                       rate=rate))


def round_accounting_dev(ltfl: LTFLConfig, ch: ChannelArrays,
                         payload_bits: torch.Tensor, rho: torch.Tensor,
                         power: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's (delay, energy) on the device: Eq. 34 (the slowest
    device gates the round, plus the server delay) and Eq. 37 summed,
    over the last (device) axis, from one shared rate quadrature. (U,)
    inputs give scalars; a lane bucket's (L, U) gives (L,)."""
    cfg = ltfl.wireless
    rate = expected_rate_dev(cfg, ch, power)
    delay = torch.amax(device_round_delay_dev(
        cfg, ch, payload_bits, rho, power, rate=rate), dim=-1,
        keepdim=True) + ltfl.server_delay
    energy = torch.sum(device_round_energy_dev(
        cfg, ch, payload_bits, rho, power, rate=rate), dim=-1)
    return delay.squeeze(-1), energy


def buffered_round_accounting_dev(
        ltfl: LTFLConfig, ch: ChannelArrays, payload_bits: torch.Tensor,
        rho: torch.Tensor, power: torch.Tensor, admitted: torch.Tensor,
        deadline: float, buffer_size: int, *,
        rate: Optional[torch.Tensor] = None,
        t_u: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A buffered-async round's (delay, energy, per-device completion
    times) on the device, over the last (device) axis.

    The round closes when the K-slot buffer fills, at the K-th admitted
    arrival's completion time, and otherwise at the straggler
    ``deadline`` (or, under an infinite deadline, at the last scheduled
    completion time); then the server delay. Energy is Eq. 37 summed:
    stragglers and dropped uploads still spend theirs.

    ``rate`` and ``t_u`` take the expected-rate quadrature and the
    completion times when the caller already has them (the async
    engine's admission computes both), so the quadrature runs once.
    With ``admitted`` all True, ``buffer_size`` = U and ``deadline`` =
    inf the result is ``round_accounting_dev``'s bitwise: the same ops
    in the same order, and where(True, t, 0) is t."""
    cfg = ltfl.wireless
    if rate is None:
        rate = expected_rate_dev(cfg, ch, power)
    if t_u is None:
        t_u = device_round_delay_dev(cfg, ch, payload_bits, rho, power,
                                     rate=rate)
    filled = torch.sum(admitted.to(torch.int32), dim=-1,
                       keepdim=True) >= buffer_size
    last = torch.amax(torch.where(admitted, t_u, 0.0), dim=-1,
                      keepdim=True)
    # the deadline as the reference holds it, a float32
    cap = torch.clamp(torch.amax(t_u, dim=-1, keepdim=True),
                      max=float(np.float32(deadline)))
    delay = torch.where(filled, last, cap) + ltfl.server_delay
    energy = torch.sum(device_round_energy_dev(
        cfg, ch, payload_bits, rho, power, rate=rate), dim=-1)
    return delay.squeeze(-1), energy, t_u
