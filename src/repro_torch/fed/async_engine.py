"""Buffered-async federated rounds (FedBuff-style) on the scanned engine.

Held against ``repro.fed.async_engine`` (``AsyncRunner``: its
construction checks, host-rng churn, ``_admission``, the async history
and ``staleness``). The paper's round (Eq. 34) waits for its slowest
scheduled device; ``AsyncRunner`` lets the server aggregate what arrives.
Every source of asynchrony is a fixed-shape mask over the scheduled
cohort, decided inside the segment from the delay twins the synchronous
engine already evaluates:

* arrival: device u's upload completes at t_u =
  ``device_round_delay_dev`` (local training + uplink under this round's
  channel). It arrives iff it is alive, its upload was not dropped, and
  t_u <= ``deadline``;
* buffer: the K-slot buffer (``buffer_size``) admits the first K
  arrivals in completion order, by rank over a stable ``argsort`` of the
  masked t_u (ties go to the lower index, as ``jnp.argsort``'s). The
  round closes when the buffer fills or at the deadline
  (``buffered_round_accounting_dev``);
* churn: ``ChurnSpec`` departures and returns over the (N,) registry and
  dropped uploads. A departed or dropped device never arrives; registry,
  sampler and channel state keep their shapes;
* staleness: per-device counters tau_i (reset to 0 on admission, +1 for
  a scheduled device that missed the buffer, unchanged when not
  scheduled). Admitted updates are weighted by 1 / sqrt(1 + tau_i), from
  tau before the reset.

A device that does not arrive still spends its round energy; only its
contribution to the aggregate is masked, through the packet outcomes
alpha, so ``received`` counts applied updates. Under
``participation="unbiased"`` the logged inclusion is the plug-in
pi_i * n_admitted / U. The host reduces gamma with the staleness term
(``repro_torch.core.convergence.gap_terms``), exactly +0.0 at tau = 0.

The reference keeps tau (and the alive chain) in its scan carry; here
each lane keeps them on the device across segments, as the scanned
engine keeps the range estimates: ``_tau_dev`` (N,) float32, and
``_alive_dev`` (N,) bool when churn is drawn on the device. A bucket of
lanes is admitted as one (L, U) batch.

Random streams. Under ``rng="host"`` churn draws on its own numpy
stream, ``default_rng(seed + 0x5EED)``, in the reference's order (per
round: the (N,) departures, the (N,) returns, the (U,) drops), so the
masks are bitwise the reference's and the replayed round inputs stay
``ScanRunner``'s. Under ``rng="device"`` each lane's generator draws
the (N,) departures, the (N,) returns and the (U,) drops after the
packet outcomes and before the quantizer's uniforms; with
``churn=None`` nothing is drawn, so the stream is ``ScanRunner``'s.

``AsyncRunner(deadline=inf, buffer_size=U, churn=None)`` is
``ScanRunner`` bitwise: every mask is an arithmetic identity and the
buffered accounting runs the synchronous accounting's ops in its order.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.channel import expected_rate_dev
from repro_torch.core.delay_energy import (
    buffered_round_accounting_dev,
    device_round_delay_dev,
)
from repro_torch.fed.population import ChurnSpec
from repro_torch.fed.scan_engine import ScanRunner


class _AsyncSpec(NamedTuple):
    """The async constants a segment bakes in (part of a lane's bucket
    signature)."""

    deadline: float          # straggler cutoff on t_u (s); inf = none
    buffer_size: int         # K: admissions that close the round
    churn: Optional[ChurnSpec]


class AsyncRunner(ScanRunner):
    """``ScanRunner`` with buffered-async rounds (module docstring).

    Additional construction arguments:

    * ``deadline``: per-device completion cutoff in seconds from the
      round's start, without the server delay (``inf``: no cutoff);
    * ``buffer_size``: K, the round closes at the K-th admission
      (default U, the cohort size);
    * ``churn``: a ``ChurnSpec`` (None: a fixed fleet).

    ``async_history`` holds one dict per round (``round``, ``tau``,
    ``admitted``, ``n_admitted``); ``RoundRecord.staleness`` is the
    cohort's mean tau. Runs on ``cuda`` unless ``device`` says
    otherwise, and raises without a card, as ``ScanRunner`` does.
    """

    def __init__(self, model, params, ltfl, train, test, scheme, *,
                 deadline: float = float("inf"),
                 buffer_size: Optional[int] = None,
                 churn: Optional[ChurnSpec] = None, **kwargs):
        if not deadline > 0.0:
            raise ValueError(f"deadline={deadline} must be positive "
                             "(use inf for no straggler cutoff)")
        if churn is not None and not isinstance(churn, ChurnSpec):
            raise TypeError(f"churn must be a ChurnSpec, got "
                            f"{type(churn).__name__}")
        super().__init__(model, params, ltfl, train, test, scheme,
                         **kwargs)
        u = self.num_devices
        if buffer_size is None:
            buffer_size = u
        if not 1 <= buffer_size <= u:
            raise ValueError(
                f"buffer_size={buffer_size} must be in [1, {u}] (the "
                "cohort size: the buffer admits scheduled arrivals)")
        self._async = _AsyncSpec(float(deadline), int(buffer_size), churn)
        # the async state, on the device across segments
        self._tau_dev: Optional[torch.Tensor] = None
        self._alive_dev: Optional[torch.Tensor] = None
        # host-rng churn draws on its own stream, so the replayed round
        # inputs stay ScanRunner's
        self._churn_rng = np.random.default_rng(
            int(kwargs.get("seed", 0)) + 0x5EED)
        self._alive_host = np.ones(self.population_size, bool)
        self.async_history: List[Dict[str, Any]] = []
        self.scheme.configure_async(self)

    # ------------------------------------------------------------------ #
    # lanes
    # ------------------------------------------------------------------ #
    def _lane_extra_kwargs(self) -> Dict[str, Any]:
        return dict(deadline=self._async.deadline,
                    buffer_size=self._async.buffer_size,
                    churn=self._async.churn)

    def _engine_signature(self) -> tuple:
        c = self._async.churn
        return ("async", self._async.deadline, self._async.buffer_size,
                None if c is None else (c.p_depart, c.p_return, c.p_drop))

    # ------------------------------------------------------------------ #
    # the async state
    # ------------------------------------------------------------------ #
    def _ensure_device_world(self) -> None:
        """The scanned engine's world, plus tau (N,) and, for churn drawn
        on the device, the alive chain (N,), once."""
        super()._ensure_device_world()
        n = self.population_size
        if self._tau_dev is None:
            self._tau_dev = torch.zeros(n, dtype=torch.float32,
                                        device=self.device)
        if self._async.churn is not None and self.rng == "device" and \
                self._alive_dev is None:
            self._alive_dev = torch.ones(n, dtype=torch.bool,
                                         device=self.device)

    def _prepare_host_segment(self, a: int, b: int):
        """``ScanRunner``'s replay, plus the churn masks of rounds
        [a, b) from the churn stream: (R, U) ``alive_c`` and ``drop``."""
        xs, consts, ctl0, seeds = super()._prepare_host_segment(a, b)
        churn = self._async.churn
        if churn is not None:
            cohorts = xs["cohort"]
            alive_rows, drop_rows = [], []
            for i in range(b - a):
                alive = self._alive_host
                depart = self._churn_rng.random(alive.shape) < \
                    churn.p_depart
                comeback = self._churn_rng.random(alive.shape) < \
                    churn.p_return
                self._alive_host = np.where(alive, ~depart, comeback)
                alive_rows.append(self._alive_host[cohorts[i]])
                drop_rows.append(
                    self._churn_rng.random(cohorts.shape[1]) <
                    churn.p_drop)
            xs["alive_c"] = np.stack(alive_rows)
            xs["drop"] = np.stack(drop_rows)
        return xs, consts, ctl0, seeds

    # ------------------------------------------------------------------ #
    # admission, called by the segment for a bucket of lanes
    # ------------------------------------------------------------------ #
    def _admission(self, lanes: List["AsyncRunner"], view, ch, cohort,
                   alpha, weights, inclusion, rho, power, payload, masks):
        """Mask one round's (L, U) cohorts into buffered arrivals.

        ``self`` is the bucket's first lane (the lanes share the async
        spec); ``view`` is the laned config. Returns the masked (alpha,
        weights, inclusion), the pre-reset tau and the admission mask
        for the log, and the buffered (delay, energy). Updates each
        lane's tau (and alive chain) in place. No host sync."""
        asy = self._async
        churn = asy.churn
        n_lanes, u = cohort.shape
        if churn is None:
            alive_c = drop = None
        elif masks is not None:          # host rng: the replayed masks
            alive_c, drop = masks
        else:                            # device rng: each lane's stream
            alive_l, drop_l = [], []
            for j, lane in enumerate(lanes):
                gen, dev = lane._generator, lane._alive_dev.device
                n = lane.population_size
                stay = ~(torch.rand(n, generator=gen, device=dev)
                         < churn.p_depart)
                comeback = torch.rand(n, generator=gen,
                                      device=dev) < churn.p_return
                lane._alive_dev = torch.where(lane._alive_dev, stay,
                                              comeback)
                alive_l.append(torch.index_select(lane._alive_dev, 0,
                                                  cohort[j]))
                drop_l.append(torch.rand(u, generator=gen, device=dev)
                              < churn.p_drop)
            alive_c, drop = torch.stack(alive_l), torch.stack(drop_l)
        # completion times from the accounting's own twins; the rate
        # quadrature runs once for admission and accounting
        w = view.wireless
        rate = expected_rate_dev(w, ch, power)
        t_u = device_round_delay_dev(w, ch, payload, rho, power, rate=rate)
        deadline = float(np.float32(asy.deadline))
        arrive = t_u <= deadline
        if alive_c is not None:
            arrive = arrive & alive_c & ~drop
        # rank[i]: device i's place in completion order, non-arrivals
        # last (stable: ties to the lower index, as jnp.argsort)
        order = torch.argsort(torch.where(arrive, t_u, float("inf")),
                              dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(u, device=order.device).expand(
                n_lanes, u))
        admitted = arrive & (rank < asy.buffer_size)
        # attenuation from tau before the reset
        tau_c = torch.stack([torch.index_select(lane._tau_dev, 0, c)
                             for lane, c in zip(lanes, cohort)])
        stale_w = 1.0 / torch.sqrt(1.0 + tau_c)
        alpha = torch.where(admitted, alpha, 0.0)
        weights = weights * stale_w
        if inclusion is not None:
            n_adm = torch.sum(admitted, dim=-1, keepdim=True).to(
                torch.float32)
            inclusion = inclusion * (n_adm / np.float32(u))
        delay, energy, _ = buffered_round_accounting_dev(
            view, ch, payload, rho, power, admitted, deadline,
            asy.buffer_size, rate=rate, t_u=t_u)
        # admitted -> 0, scheduled but missed -> +1, unscheduled as is
        new_tau = torch.where(admitted, 0.0, tau_c + 1.0)
        for j, lane in enumerate(lanes):
            lane._tau_dev.index_copy_(0, cohort[j], new_tau[j])
        return alpha, weights, inclusion, tau_c, admitted, (delay, energy)

    # ------------------------------------------------------------------ #
    # after a segment
    # ------------------------------------------------------------------ #
    def _absorb_segment(self, a: int, b: int, ctl, log) -> None:
        super()._absorb_segment(a, b, ctl, log)
        taus = np.asarray(log.tau, np.float64)
        admitted = np.asarray(log.admitted, bool)
        for i, r in enumerate(range(a, b)):
            self.async_history.append({
                "round": r,
                "tau": taus[i],
                "admitted": admitted[i],
                "n_admitted": int(admitted[i].sum()),
            })

    @property
    def staleness(self) -> np.ndarray:
        """The per-device tau counters, (N,) float64 on the host."""
        if self._tau_dev is None:
            return np.zeros(self.population_size)
        return self._tau_dev.cpu().numpy().astype(np.float64)
