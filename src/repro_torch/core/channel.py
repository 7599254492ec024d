"""Wireless transmission model (paper Section 2.1, Eq. 1-4), host half.

Held against ``repro.core.channel`` (``DeviceChannel``, ``ChannelState``,
``expected_rate``, ``packet_error_rate``, ``sample_transmissions``,
``sample_devices``): the
same float64 numpy arithmetic, so rates, packet error rates and seeded
transmission outcomes are bitwise equal to the reference's.

Uplink OFDMA with Rayleigh fading: channel power gain h = varpi * d^-2
where varpi is exponentially distributed with mean ``fading_scale``.
Expectations over h in the rate (Eq. 1) and packet error rate (Eq. 3) are
evaluated with Gauss-Laguerre quadrature. ``ChannelState`` is the
struct-of-arrays device representation: one (U,) array per attribute;
rates and PERs broadcast over the device axis and any leading candidate
axes, so the controller scores K candidate power vectors as one (K, U)
array op.

Device twins (the scanned engine's per-round path, ``repro_torch.fed.
scan_engine``), held against the reference's lines 187-363:
``ChannelArrays`` (``ChannelState.to_arrays``) holds float32 tensors on
a device, and ``expected_rate_dev`` / ``packet_error_rate_dev`` /
``sample_transmissions_dev`` / ``draw_fading_dev`` evaluate the same
formulas (the same Gauss-Laguerre nodes) in float32 on that device, so a
segment of rounds runs without a host round trip. Randomness comes from
an explicit ``torch.Generator``. A config field may be a Python float or
a float32 tensor (a sweep's per-lane value, shaped to broadcast against
the channel arrays); two config values are multiplied in float32 either
way, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig

_GL_POINTS = 64
_GL_X, _GL_W = np.polynomial.laguerre.laggauss(_GL_POINTS)


@dataclass(frozen=True)
class DeviceChannel:
    """Static per-device channel/compute attributes drawn per Table 2."""

    distance: float          # d_u (m)
    fading_mean: float       # E[varpi_u]
    interference: float      # I_u (W)
    cpu_hz: float            # f_u
    num_samples: int         # N_u


@dataclass(frozen=True)
class ChannelState:
    """Struct-of-arrays channel state for U devices: each field is (U,)."""

    distance: np.ndarray     # (U,) d_u (m)
    fading_mean: np.ndarray  # (U,) E[varpi_u]
    interference: np.ndarray # (U,) I_u (W)
    cpu_hz: np.ndarray       # (U,) f_u
    num_samples: np.ndarray  # (U,) N_u (int)

    @property
    def num_devices(self) -> int:
        return int(self.distance.shape[0])

    def __len__(self) -> int:
        return self.num_devices

    @classmethod
    def sample(cls, cfg: WirelessConfig, num: int, samples_min: int,
               samples_max: int, rng: np.random.Generator,
               dtype=np.float64) -> "ChannelState":
        """Vectorized device sampling per Table 2 (one draw per field).
        Draws consume the rng stream in float64 and are cast to ``dtype``
        after drawing."""
        dtype = np.dtype(dtype)
        return cls(
            distance=rng.uniform(cfg.dist_min, cfg.dist_max,
                                 num).astype(dtype),
            fading_mean=np.full(num, cfg.fading_scale, dtype=dtype),
            interference=rng.uniform(cfg.interference_min,
                                     cfg.interference_max,
                                     num).astype(dtype),
            cpu_hz=rng.uniform(cfg.cpu_min, cfg.cpu_max, num).astype(dtype),
            num_samples=rng.integers(samples_min, samples_max + 1, num),
        )

    @classmethod
    def from_devices(cls, devices: Sequence[DeviceChannel]) -> "ChannelState":
        return cls(
            distance=np.array([d.distance for d in devices], np.float64),
            fading_mean=np.array([d.fading_mean for d in devices],
                                 np.float64),
            interference=np.array([d.interference for d in devices],
                                  np.float64),
            cpu_hz=np.array([d.cpu_hz for d in devices], np.float64),
            num_samples=np.array([d.num_samples for d in devices], np.int64),
        )

    def to_devices(self) -> Tuple[DeviceChannel, ...]:
        return tuple(
            DeviceChannel(distance=float(self.distance[i]),
                          fading_mean=float(self.fading_mean[i]),
                          interference=float(self.interference[i]),
                          cpu_hz=float(self.cpu_hz[i]),
                          num_samples=int(self.num_samples[i]))
            for i in range(self.num_devices))

    def take(self, idx) -> "ChannelState":
        """Gather a cohort view: (U,) copies of every field at ``idx``."""
        idx = np.asarray(idx, dtype=np.int64)
        return ChannelState(
            distance=self.distance[idx],
            fading_mean=self.fading_mean[idx],
            interference=self.interference[idx],
            cpu_hz=self.cpu_hz[idx],
            num_samples=self.num_samples[idx],
        )

    @staticmethod
    def draw_fading(cfg: WirelessConfig, rng: np.random.Generator,
                    size: int):
        """One block-fading draw for ``size`` devices: (fading_mean,
        interference) arrays. The single source of the slow
        fading/interference distributions."""
        return (cfg.fading_scale * rng.exponential(1.0, size),
                rng.uniform(cfg.interference_min, cfg.interference_max,
                            size))

    def redraw_fading(self, cfg: WirelessConfig,
                      rng: np.random.Generator) -> "ChannelState":
        """Block fading of the slow channel components: per round, the mean
        fading power is re-drawn as fading_scale * Exp(1) and the
        interference level from its Table-2 range."""
        fading, interference = self.draw_fading(cfg, rng, self.num_devices)
        return dataclasses.replace(
            self, fading_mean=fading.astype(self.fading_mean.dtype),
            interference=interference.astype(self.interference.dtype))

    def to_arrays(self, device: Union[str, torch.device, None] = None,
                  dtype: torch.dtype = torch.float32) -> "ChannelArrays":
        """The device twin (float32 by default: what the _dev functions
        compute in whatever the host storage)."""
        return ChannelArrays(*(
            torch.as_tensor(np.asarray(f), dtype=dtype, device=device)
            for f in (self.distance, self.fading_mean, self.interference,
                      self.cpu_hz, self.num_samples)))


class ChannelArrays(NamedTuple):
    """Device twin of ``ChannelState``: each field a float32 tensor,
    (U,) or (N,), or (L, U) for a bucket of sweep lanes.
    ``num_samples`` is float32 (it only enters weighted sums)."""

    distance: torch.Tensor
    fading_mean: torch.Tensor
    interference: torch.Tensor
    cpu_hz: torch.Tensor
    num_samples: torch.Tensor

    def take(self, idx: torch.Tensor) -> "ChannelArrays":
        """The (U,) cohort view of an (N,) population, on the device."""
        return ChannelArrays(*(torch.index_select(f, 0, idx) for f in self))

    @staticmethod
    def stack(views: Sequence["ChannelArrays"]) -> "ChannelArrays":
        """Lanes' (U,) views as one (L, U) view."""
        return ChannelArrays(*(torch.stack(fs) for fs in zip(*views)))


Devices = Union[ChannelState, DeviceChannel, Sequence[DeviceChannel]]


def as_channel_state(devices: Devices) -> ChannelState:
    """Coerce a ChannelState / DeviceChannel / sequence to ChannelState."""
    if isinstance(devices, ChannelState):
        return devices
    if isinstance(devices, DeviceChannel):
        return ChannelState.from_devices([devices])
    return ChannelState.from_devices(devices)


def sample_devices(cfg: WirelessConfig, num: int, samples_min: int,
                   samples_max: int, rng: np.random.Generator
                   ) -> Tuple[DeviceChannel, ...]:
    """Legacy tuple-of-dataclass sampler, one device at a time in the
    reference's draw order (``repro.core.channel.sample_devices``, lines
    233-251), so seeded callers see the same devices; ``ChannelState.
    sample`` draws field by field instead."""
    out = []
    for _ in range(num):
        out.append(DeviceChannel(
            distance=float(rng.uniform(cfg.dist_min, cfg.dist_max)),
            fading_mean=cfg.fading_scale,
            interference=float(rng.uniform(cfg.interference_min,
                                           cfg.interference_max)),
            cpu_hz=float(rng.uniform(cfg.cpu_min, cfg.cpu_max)),
            num_samples=int(rng.integers(samples_min, samples_max + 1)),
        ))
    return tuple(out)


def _mean_gain(dev) -> np.ndarray:
    """E[h] = E[varpi] * d^-2 (Eq. 2); scalar or (U,)."""
    return np.asarray(dev.fading_mean) * np.asarray(dev.distance) ** -2.0


def _noise(cfg: WirelessConfig, dev) -> np.ndarray:
    return np.asarray(dev.interference) + cfg.bandwidth_ul * cfg.n0


def expected_rate(cfg: WirelessConfig, dev, power: np.ndarray) -> np.ndarray:
    """Eq. 1: R = B * E_h[ log2(1 + p h / (I + B N0)) ]  (bits/s).

    ``dev`` is a DeviceChannel (power (...,) -> rate (...,)) or a
    ChannelState (power (..., U) -> rate (..., U)); broadcasting applies.
    """
    p = np.asarray(power, dtype=np.float64)
    c = p * _mean_gain(dev) / _noise(cfg, dev)          # h = mean_gain * X
    val = np.log2(1.0 + c[..., None] * _GL_X)           # X ~ Exp(1)
    return cfg.bandwidth_ul * np.sum(_GL_W * val, axis=-1)


def packet_error_rate(cfg: WirelessConfig, dev,
                      power: np.ndarray) -> np.ndarray:
    """Eq. 3: q = E_h[ 1 - exp(-Upsilon (I + B N0) / (p h)) ]."""
    p = np.asarray(power, dtype=np.float64)
    c = cfg.waterfall * _noise(cfg, dev) / (p * _mean_gain(dev))
    # E over X ~ Exp(1) of 1 - exp(-c / X); integrand -> 1 as X -> 0
    x = np.maximum(_GL_X, 1e-12)
    val = 1.0 - np.exp(-c[..., None] / x)
    return np.clip(np.sum(_GL_W * val, axis=-1), 0.0, 1.0)


def sample_transmissions(cfg: WirelessConfig, devices: Devices,
                         powers: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
    """Eq. 4: alpha_u ~ Bernoulli(1 - q_u(p_u)). Returns int array (U,)."""
    state = as_channel_state(devices)
    qs = packet_error_rate(cfg, state, np.asarray(powers, np.float64))
    return (rng.random(state.num_devices) >= qs).astype(np.int64)


# --------------------------------------------------------------------------- #
# device twins (float32, on the channel arrays' device)
# --------------------------------------------------------------------------- #
def f32(x):
    """A config value as float32: a tensor as it is, a Python number as
    ``np.float32`` (a scalar operand that torch applies in float32)."""
    return x if isinstance(x, torch.Tensor) else np.float32(x)


@functools.lru_cache(maxsize=None)
def _gl_nodes(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The Gauss-Laguerre nodes, weights and clamped nodes as float32
    tensors on ``device``, uploaded once per device."""
    x = torch.as_tensor(_GL_X, dtype=torch.float32, device=device)
    w = torch.as_tensor(_GL_W, dtype=torch.float32, device=device)
    return x, w, torch.clamp(x, min=1e-12)


def gl_nodes(device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _gl_nodes(torch.device(device))


def _mean_gain_dev(ch: ChannelArrays) -> torch.Tensor:
    return ch.fading_mean * ch.distance ** -2.0


def _noise_dev(cfg: WirelessConfig, ch: ChannelArrays) -> torch.Tensor:
    # a float32 product of the two config values, as the reference's
    return ch.interference + f32(cfg.bandwidth_ul) * f32(cfg.n0)


def expected_rate_dev(cfg: WirelessConfig, ch: ChannelArrays,
                      power: torch.Tensor) -> torch.Tensor:
    """Device twin of ``expected_rate`` (Eq. 1): the same quadrature in
    float32, broadcasting over the device axis and any leading axes."""
    x, w, _ = gl_nodes(ch.distance.device)
    p = power.to(torch.float32)
    c = p * _mean_gain_dev(ch) / _noise_dev(cfg, ch)
    val = torch.log2(1.0 + c[..., None] * x)
    return cfg.bandwidth_ul * torch.sum(w * val, dim=-1)


def packet_error_rate_dev(cfg: WirelessConfig, ch: ChannelArrays,
                          power: torch.Tensor) -> torch.Tensor:
    """Device twin of ``packet_error_rate`` (Eq. 3), float32."""
    _, w, x = gl_nodes(ch.distance.device)
    p = power.to(torch.float32)
    c = cfg.waterfall * _noise_dev(cfg, ch) / (p * _mean_gain_dev(ch))
    val = 1.0 - torch.exp(-c[..., None] / x)
    return torch.clamp(torch.sum(w * val, dim=-1), 0.0, 1.0)


def sample_transmissions_dev(cfg: WirelessConfig, ch: ChannelArrays,
                             power: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Device twin of ``sample_transmissions`` (Eq. 4): alpha ~
    Bernoulli(1 - q) from ``generator``, float32 in {0, 1}."""
    qs = packet_error_rate_dev(cfg, ch, power)
    u = torch.rand(qs.shape, generator=generator, device=qs.device,
                   dtype=torch.float32)
    return (u >= qs).to(torch.float32)


def draw_fading_dev(cfg: WirelessConfig, generator: torch.Generator,
                    size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``ChannelState.draw_fading``: one block-fading
    epoch's (fading_mean, interference) for ``size`` devices, float32 on
    the generator's device. The distributions are the host sampler's;
    the stream is torch's (Philox), not numpy's."""
    device = generator.device
    fading = torch.empty(size, dtype=torch.float32, device=device)
    fading.exponential_(1.0, generator=generator)
    interference = torch.empty(size, dtype=torch.float32, device=device)
    interference.uniform_(cfg.interference_min, cfg.interference_max,
                          generator=generator)
    return cfg.fading_scale * fading, interference
