"""Device twins of the cohort samplers: the scanned engine's in-segment
scheduler.

Held against ``repro.control.device_samplers`` (``DeviceSamplerTwin``,
``uniform_twin``, ``channel_aware_twin``, ``energy_aware_twin``,
``_gumbel_topk_inclusion_dev``; lines 83-232). ``ScanRunner(rng=
"device")`` draws each round's cohort on the device from the runner's
``torch.Generator``; a host ``CohortSampler`` takes part by returning one
of these from ``device_twin(runner)``. A twin sees the round's current
channel realization and returns the (U,) cohort, ascending, and, where
defined, the members' inclusion probabilities pi_i.

Sampling without replacement is the Gumbel-top-k trick: i.i.d.
Gumbel(0, 1) noise added to log-weights, the top U keys kept, which is
distributed exactly as sequential weighted sampling without replacement
(numpy's ``choice(replace=False, p=w)``). Uniform sampling is the
equal-weight case (uniform keys, top U). Inclusion probabilities follow
the host samplers: exact U/N for uniform, and for the energy-aware
weights the exact without-replacement pi_i of the quadrature twin of
``repro_torch.fed.population.gumbel_topk_inclusion``, computed once per
twin (the weights depend only on static device attributes).

Ties: ``torch.topk`` and ``torch.argsort`` without ``stable`` promise no
order among equal keys, where the reference's ``lax.top_k`` and the host
``argsort(kind="stable")`` take the lower index first. The channel-aware
twin ranks with a stable sort, so equal rates go to the lower index.

The sharded twins (a registry laid out over several cards) are not
ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.channel import ChannelArrays, expected_rate_dev
from repro_torch.core.delay_energy import local_train_energy_dev

SelectFn = Callable[[ChannelArrays, torch.Generator],
                    Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _gumbel_topk_inclusion_dev(w: torch.Tensor, k: int,
                               n_quad: int = 64) -> torch.Tensor:
    """Device twin of ``gumbel_topk_inclusion``: the exact inclusion
    probabilities of weighted sampling without replacement for all N
    devices, float32, on ``w``'s device. The same exponential-race
    quadrature: per device i, nodes s_i(v) = v^(1 / (N w_i)) on the
    Gauss-Legendre nodes v in (0, 1), the arrival probabilities
    p_j = 1 - s^(N w_j) with device i's own set to 0, and the truncated
    Poisson-binomial forward DP over j; devices in chunks of ~16 MB."""
    n = w.shape[0]
    device = w.device
    if k >= n:
        return torch.ones((n,), dtype=torch.float32, device=device)
    nodes, qwts = np.polynomial.legendre.leggauss(n_quad)
    log_v = torch.log(torch.as_tensor(0.5 * (nodes + 1.0),
                                      dtype=torch.float32, device=device))
    qw = torch.as_tensor(0.5 * qwts, dtype=torch.float32, device=device)
    nw = n * w.to(torch.float32)
    pi = torch.empty((n,), dtype=torch.float32, device=device)
    blk = max(1, int(4e6) // (n * n_quad))
    for i0 in range(0, n, blk):
        idx = torch.arange(i0, min(i0 + blk, n), device=device)
        log_s = log_v[None, :] / nw[idx, None]                  # (B, Q)
        p = 1.0 - torch.exp(log_s[:, :, None] * nw[None, None, :])
        p[torch.arange(idx.numel(), device=device), :, idx] = 0.0
        q = 1.0 - p
        f = torch.zeros((idx.numel(), n_quad, k), dtype=torch.float32,
                        device=device)
        f[:, :, 0] = 1.0
        for j in range(n):
            fp = q[:, :, j:j + 1] * f
            fp[:, :, 1:] += p[:, :, j:j + 1] * f[:, :, :-1]
            f = fp
        pi[idx] = torch.sum(f, dim=2) @ qw      # integral of P(cnt <= k-1)
    return torch.clamp(pi, 0.0, 1.0)


class DeviceSamplerTwin(NamedTuple):
    """A scheduler on the device: ``select(ch_pop, generator) ->
    (cohort, pi | None)``. ``ch_pop`` is the (N,) population view at the
    round's realization; ``cohort`` is (U,) int64, ascending; ``pi`` is
    (U,) float32 or None for deterministic schedulers
    (``provides_inclusion`` says which before any draw). ``prepare``
    (ch_pop), where given, does a twin's one-off set-up work, so that
    the engine can run it before a segment's loop."""

    select: SelectFn
    provides_inclusion: bool
    prepare: Optional[Callable[[ChannelArrays], None]] = None


def _top(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest keys, ascending."""
    return torch.sort(torch.topk(keys, k).indices).values


def uniform_twin(num_devices: int, cohort_size: int) -> DeviceSamplerTwin:
    """Uniform without replacement, exact pi = U/N. U == N is the
    identity cohort and draws nothing, as the host fast path."""
    n, u = num_devices, cohort_size

    def select(ch_pop: ChannelArrays, generator: torch.Generator):
        device = ch_pop.distance.device
        if u == n:
            return (torch.arange(n, device=device),
                    torch.ones((n,), dtype=torch.float32, device=device))
        keys = torch.rand((n,), generator=generator, device=device)
        return _top(keys, u), torch.full((u,), u / n, dtype=torch.float32,
                                         device=device)

    return DeviceSamplerTwin(select=select, provides_inclusion=True)


def channel_aware_twin(num_devices: int, cohort_size: int, ltfl,
                       power: Optional[float] = None,
                       explore: float = 0.0) -> DeviceSamplerTwin:
    """Device twin of ``ChannelAwareSampler``: the top U by expected
    uplink rate at a reference power on the round's realization, equal
    rates to the lower index; ``explore`` reserves the host sampler's
    slot count for uniform picks outside the top set. No inclusion
    probabilities."""
    n, u = num_devices, cohort_size
    w = ltfl.wireless
    p_ref = power if power is not None else 0.5 * (w.p_min + w.p_max)
    n_explore = 0 if explore <= 0.0 else min(
        u, max(1, round(explore * u)))
    n_top = u - n_explore

    def select(ch_pop: ChannelArrays, generator: torch.Generator):
        device = ch_pop.distance.device
        rate = expected_rate_dev(
            w, ch_pop, torch.full((n,), p_ref, dtype=torch.float32,
                                  device=device))
        # stable descending order (host: argsort(-rate, kind="stable"))
        order = torch.argsort(-rate, stable=True)
        idx = order[:n_top]
        if n_explore:
            rest = order[n_top:]
            keys = torch.rand(rest.shape, generator=generator,
                              device=device)
            idx = torch.cat([idx, rest[torch.topk(keys, n_explore).indices]])
        return torch.sort(idx).values, None

    return DeviceSamplerTwin(select=select, provides_inclusion=False)


def energy_aware_twin(ltfl, cohort_size: int,
                      min_headroom: float = 1e-6) -> DeviceSamplerTwin:
    """Device twin of ``EnergyAwareSampler``: Gumbel-top-k with weights
    proportional to the per-round energy headroom (E^max minus the rho =
    0 local-training energy, Eq. 35), recomputed on the device from the
    population view's static attributes. Reports the exact
    without-replacement pi_i, computed at the first draw and kept (the
    weights do not change during a run)."""
    u = cohort_size
    w_cfg = ltfl.wireless
    e_max = float(ltfl.e_max)
    cache = {}

    def weights(ch_pop: ChannelArrays) -> torch.Tensor:
        head = torch.clamp(
            e_max - local_train_energy_dev(w_cfg, ch_pop, 0.0),
            min=min_headroom)
        return head / torch.sum(head)

    def prepare(ch_pop: ChannelArrays) -> None:
        if "pi" not in cache:
            cache["pi"] = _gumbel_topk_inclusion_dev(weights(ch_pop), u)

    def select(ch_pop: ChannelArrays, generator: torch.Generator):
        w = weights(ch_pop)
        gumbel = -torch.log(torch.empty_like(w).exponential_(
            1.0, generator=generator))
        cohort = _top(torch.log(torch.clamp(w, min=1e-30)) + gumbel, u)
        prepare(ch_pop)
        pi = torch.clamp(cache["pi"][cohort], 1e-9, 1.0)
        return cohort, pi

    return DeviceSamplerTwin(select=select, provides_inclusion=True,
                             prepare=prepare)
