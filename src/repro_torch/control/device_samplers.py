"""Device twins of the cohort samplers: the scanned engine's in-segment
scheduler.

Held against ``repro.control.device_samplers`` (``DeviceSamplerTwin``,
``uniform_twin``, ``channel_aware_twin``, ``energy_aware_twin``,
``_gumbel_topk_inclusion_dev``; lines 83-232; the sharded twins,
lines 228-392). ``ScanRunner(rng=
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

Sharded twins (the registry in S blocks)
----------------------------------------
``sharded_*_twin`` schedule over a registry laid out in S equal blocks
(``repro_torch.launch.sharding.PopMesh``; ``repro_torch.fed.population.
PopulationArrays``). Their ``select(blocks, generator)`` takes the S
``ChannelArrays`` blocks and draws in two stages:

1. each block scores its own N_pad / S devices on its own device
   (uniform keys, the mean-SNR score, or Gumbel keys), masks the pad
   tail (global index >= N) to -inf and keeps its local top U;
2. the S local winners, concatenated in block order on the controller's
   device, are ranked once more and the global top U kept.

The merge is exact: a member of the global top U is among the top U of
its own block. Both stages rank with ``torch.sort(descending=True,
stable=True)``: a block's equal keys keep ascending index order and the
blocks are concatenated in index order, so equal keys go to the lowest
global index, as ``lax.top_k`` and the host's stable sort do.

* uniform keys: exactly uniform without replacement, pi = U/N; U == N
  stays the identity cohort and draws nothing;
* the channel-aware twin ranks by mean SNR p E[h] / (I + B N0), strictly
  increasing in the Eq.-1 rate, so its top U is the host sampler's top U
  without the quadrature; ``explore`` runs a second two-stage pass over
  uniform keys with the top set masked out;
* Gumbel keys over the log-headroom: exactly the weighted draw without
  replacement; the reported pi is first-order, min(1, U w_i), with the
  normalizer a sum of per-block partial sums (the exact quadrature needs
  all N weights in one place, which the layout avoids).

Randomness: the reference folds the shard index into the round key. Here
every block has its own ``torch.Generator`` on its device, seeded at
construction from (``seed``, block index); the lane's generator is not
touched, so the channel-aware twin without ``explore`` draws nothing and
its schedule does not depend on S.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.channel import (ChannelArrays, _mean_gain_dev,
                                      _noise_dev, expected_rate_dev)
from repro_torch.core.delay_energy import local_train_energy_dev
from repro_torch.launch.sharding import PopMesh, population_pad

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


# --------------------------------------------------------------------------- #
# sharded twins: a per-block top-k, then a merge on the controller
# --------------------------------------------------------------------------- #
_NEG = float("-inf")


def _check_mesh(num_devices: int, cohort_size: int, mesh: PopMesh) -> int:
    """Validate the (N, U, mesh) triple; returns the per-block size."""
    if "pop" not in getattr(mesh, "axis_names", ()):
        raise ValueError(f"mesh {mesh!r} has no 'pop' axis (use "
                         "repro_torch.launch.sharding.population_mesh)")
    s = int(mesh.shape["pop"])
    blk = population_pad(num_devices, mesh) // s
    if cohort_size > blk:
        raise ValueError(
            f"cohort_size={cohort_size} exceeds the per-shard block "
            f"{blk} (N={num_devices} over {s} shards); stage 1 keeps U "
            "local winners per block, so U must fit in one block: use "
            "fewer shards")
    return blk


def _block_gids(blk: int, s: int, device) -> torch.Tensor:
    """(blk,) global indices of block ``s``."""
    return s * blk + torch.arange(blk, device=device)


def _block_generators(mesh: PopMesh, seed: int) -> list:
    """One generator per block on its device, seeded from (seed, block)
    on the host (nothing is read back from a device)."""
    gens = []
    for s, dev in enumerate(mesh.devices):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence(
            (int(seed), s)).generate_state(1)[0]))
        gens.append(gen)
    return gens


def _rank(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest keys, equal keys in index order."""
    return torch.sort(keys, descending=True, stable=True).indices[:k]


def _local_top(keys: torch.Tensor, gids: torch.Tensor, k: int):
    """Stage 1: one block's k best (keys, global indices)."""
    order = _rank(keys, k)
    return torch.index_select(keys, 0, order), torch.index_select(
        gids, 0, order)


def _merge_topk(vals, gids, k: int, device) -> torch.Tensor:
    """Stage 2: the S blocks' local winners, concatenated in block order
    on ``device``; the global indices of the top k."""
    v = torch.cat([x.to(device) for x in vals])
    g = torch.cat([x.to(device) for x in gids])
    return torch.index_select(g, 0, _rank(v, k))


class _Slots(NamedTuple):
    """Where one block's cohort members land: the clamped block-local
    slot, the members' ownership mask on the block's device, and that
    mask on the controller's device."""

    slot: torch.Tensor
    own: torch.Tensor
    own_ctl: torch.Tensor


def _block_slots(cohort: torch.Tensor, mesh: PopMesh, blk: int,
                 device) -> list:
    out = []
    for s, dev in enumerate(mesh.devices):
        loc = cohort.to(dev) - s * blk
        own = (loc >= 0) & (loc < blk)
        out.append(_Slots(torch.clamp(loc, 0, blk - 1), own,
                          own.to(device)))
    return out


def _block_gather(blocks, slots, device) -> torch.Tensor:
    """The cohort's rows out of S (blk, ...) row blocks, on ``device``:
    each block reads its members' rows and the owning block's row is
    kept. The reference's psum-gather adds the other blocks' zeros
    instead: the same value for the registry's positive leaves, while
    keeping the owner's row equals ``take`` for every float (a sum
    would turn -0.0 into +0.0)."""
    out = None
    for b, sl in zip(blocks, slots):
        rows = torch.index_select(b, 0, sl.slot).to(device)
        own = sl.own_ctl.reshape((-1,) + (1,) * (rows.dim() - 1))
        out = torch.where(own, rows,
                          torch.zeros_like(rows) if out is None else out)
    return out


def _drop_scatter_(dsts, slots: _Slots, keep: torch.Tensor, vals) -> None:
    """``dst[slot[m]] = val[m]`` for the members with ``keep[m]``, in
    place, for each (dst, val) pair; the other members are dropped, as
    the reference's ``.at[].set(mode="drop")``. torch has no drop mode and
    leaves the winner among repeated indices unspecified, so every member
    writes the value its slot ends with: a kept member's value where one
    targets the slot, else the slot's own. O(U^2) per block."""
    slot = slots.slot
    hit = (slot[:, None] == slot[None, :]) & keep[None, :]
    src = torch.argmax(hit.to(torch.int32), dim=1)   # the first kept member
    taken = torch.any(hit, dim=1)
    for dst, val in zip(dsts, vals):
        if isinstance(val, torch.Tensor):
            val = torch.index_select(val, 0, src)
        dst.index_copy_(0, slot, torch.where(
            taken, val, torch.index_select(dst, 0, slot)))


def sharded_uniform_twin(num_devices: int, cohort_size: int, mesh: PopMesh,
                         *, seed: int = 0, device=None) -> DeviceSamplerTwin:
    """Sharded ``uniform_twin``: per-block uniform keys, two-stage top U;
    exact pi = U/N. U == N is the identity cohort and draws nothing.
    ``device`` is the controller's (default: the first block's)."""
    n, u = num_devices, cohort_size
    blk = _check_mesh(n, u, mesh)
    ctl = torch.device(device) if device is not None else mesh.devices[0]
    gids = [_block_gids(blk, s, d) for s, d in enumerate(mesh.devices)]
    gens = _block_generators(mesh, seed)

    def select(blocks, generator: torch.Generator):
        if u == n:
            return (torch.arange(n, device=ctl),
                    torch.ones((n,), dtype=torch.float32, device=ctl))
        vals, wins = [], []
        for g, gen, dev in zip(gids, gens, mesh.devices):
            keys = torch.rand((blk,), generator=gen, device=dev)
            keys = torch.where(g < n, keys, _NEG)   # the pad is never drawn
            v, w = _local_top(keys, g, u)
            vals.append(v)
            wins.append(w)
        cohort = torch.sort(_merge_topk(vals, wins, u, ctl)).values
        return cohort, torch.full((u,), u / n, dtype=torch.float32,
                                  device=ctl)

    return DeviceSamplerTwin(select=select, provides_inclusion=True)


def sharded_channel_aware_twin(num_devices: int, cohort_size: int, ltfl,
                               mesh: PopMesh, power: Optional[float] = None,
                               explore: float = 0.0, *, seed: int = 0,
                               device=None) -> DeviceSamplerTwin:
    """Sharded ``channel_aware_twin``: per-block top U by the mean SNR
    p * E[h] / (I + B N0), a strictly increasing surrogate of the Eq.-1
    rate, so the merged top U is the host sampler's top U. ``explore``
    slots run a second two-stage pass over uniform keys with the top set
    masked out. No inclusion probabilities."""
    n, u = num_devices, cohort_size
    blk = _check_mesh(n, u, mesh)
    ctl = torch.device(device) if device is not None else mesh.devices[0]
    w = ltfl.wireless
    p_ref = np.float32(power if power is not None
                       else 0.5 * (w.p_min + w.p_max))
    n_explore = 0 if explore <= 0.0 else min(
        u, max(1, round(explore * u)))
    n_top = u - n_explore
    gids = [_block_gids(blk, s, d) for s, d in enumerate(mesh.devices)]
    gens = _block_generators(mesh, seed) if n_explore else None

    def select(blocks, generator: torch.Generator):
        vals, wins = [], []
        for g, ch in zip(gids, blocks):
            snr = p_ref * _mean_gain_dev(ch) / _noise_dev(w, ch)
            v, i = _local_top(torch.where(g < n, snr, _NEG), g, n_top)
            vals.append(v)
            wins.append(i)
        top = _merge_topk(vals, wins, n_top, ctl)
        if n_explore:
            slots = _block_slots(top, mesh, blk, ctl)
            vals, wins = [], []
            for g, gen, dev, sl in zip(gids, gens, mesh.devices, slots):
                keys = torch.rand((blk,), generator=gen, device=dev)
                keys = torch.where(g < n, keys, _NEG)
                # the block's members of the top set drop out of the pass
                _drop_scatter_((keys,), sl, sl.own, (_NEG,))
                v, i = _local_top(keys, g, n_explore)
                vals.append(v)
                wins.append(i)
            top = torch.cat([top, _merge_topk(vals, wins, n_explore, ctl)])
        return torch.sort(top).values, None

    return DeviceSamplerTwin(select=select, provides_inclusion=False)


def sharded_energy_aware_twin(ltfl, num_devices: int, cohort_size: int,
                              mesh: PopMesh, min_headroom: float = 1e-6, *,
                              seed: int = 0, device=None
                              ) -> DeviceSamplerTwin:
    """Sharded ``energy_aware_twin``: per-block Gumbel keys over the
    log-headroom, two-stage top U, exactly the weighted draw without
    replacement (the normalizer shifts every key alike, so the blocks
    never need it to select). The reported pi is first-order,
    clip(U * head_i / total, 1e-9, 1), with ``total`` the sum of the
    per-block sums in block order and head_i gathered from the owning
    block."""
    n, u = num_devices, cohort_size
    blk = _check_mesh(n, u, mesh)
    ctl = torch.device(device) if device is not None else mesh.devices[0]
    w_cfg = ltfl.wireless
    e_max = float(ltfl.e_max)
    gids = [_block_gids(blk, s, d) for s, d in enumerate(mesh.devices)]
    gens = _block_generators(mesh, seed)

    def select(blocks, generator: torch.Generator):
        heads, vals, wins = [], [], []
        total = None
        for g, gen, ch in zip(gids, gens, blocks):
            head = torch.clamp(
                e_max - local_train_energy_dev(w_cfg, ch, 0.0),
                min=min_headroom)
            head = torch.where(g < n, head, 0.0)
            part = torch.sum(head).to(ctl)
            total = part if total is None else total + part
            gumbel = -torch.log(torch.empty_like(head).exponential_(
                1.0, generator=gen))
            keys = torch.where(
                g < n, torch.log(torch.clamp(head, min=1e-30)) + gumbel, _NEG)
            v, i = _local_top(keys, g, u)
            heads.append(head)
            vals.append(v)
            wins.append(i)
        cohort = torch.sort(_merge_topk(vals, wins, u, ctl)).values
        head_c = _block_gather(heads, _block_slots(cohort, mesh, blk, ctl),
                               ctl)
        return cohort, torch.clamp(u * head_c / total, 1e-9, 1.0)

    return DeviceSamplerTwin(select=select, provides_inclusion=True)
