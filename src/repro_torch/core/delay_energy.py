"""Per-round delay and energy models (paper Section 4.1-4.2, Eq. 31-37),
host half.

Held against ``repro.core.delay_energy`` (lines 33-100): the same float64
numpy arithmetic, bitwise. Every function accepts a scalar
``DeviceChannel`` or a ``ChannelState`` of (U,) arrays, in which case
``payload_bits`` / ``rho`` / ``power`` broadcast over the device axis and
any leading candidate axes. ``rate=`` lets one expected-rate quadrature
serve both the delay and energy evaluations.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.core.channel import as_channel_state, expected_rate


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
