"""FL schemes: LTFL and its ablations.

Held against ``repro.fed.schemes`` (``Controls``, ``BaseScheme``,
``LTFLScheme`` with its host ``_solve``, ``controls``, ``payload_bits``
and the three ablation switches). A scheme is a declaration: it supplies
vectorized per-round controls — (U,) pruning ratio rho, quantization
level delta and transmission power — a ``Compressor`` for the round step,
and the analytic uplink payload in bits per device, which the host
delay/energy accounting charges.

The four baselines (FedSGD, SignSGD, FedMP, STC) and the scanned and
async engines' hooks are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core import controller as controller_mod
from repro_torch.core.channel import packet_error_rate
from repro_torch.core.compressors import (
    Compressor,
    UniformSource,
    identity_compressor,
    ltfl_quantizer,
)
from repro_torch.core.quantization import payload_bits_host


@dataclass
class Controls:
    rho: np.ndarray       # (U,) pruning ratios
    delta: np.ndarray     # (U,) quantization bits (0 => no quantization)
    power: np.ndarray     # (U,) W
    # (U,) packet error rates at ``power`` under the CURRENT channel, if the
    # scheme already computed them; None lets the runner fill them in.
    per: Optional[np.ndarray] = None


class BaseScheme:
    name = "base"
    uses_prune = False    # the runner builds the prune stage only when True

    def setup(self, runner) -> None:
        self.runner = runner

    def compressor(self, *, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
        """The scheme's compression stage (default: identity)."""
        return identity_compressor()

    def controls(self, rnd: int) -> Controls:
        raise NotImplementedError

    def payload_bits(self, ctl: Controls) -> np.ndarray:
        """(U,) uplink payload bits under these controls (Eq. 18/32)."""
        raise NotImplementedError

    def post_round(self, rnd: int, metrics: Dict[str, float]) -> None:
        pass

    def _full_bits(self, rho=0.0) -> np.ndarray:
        u = self.runner.num_devices
        return 32.0 * self.runner.num_params * (1.0 - np.asarray(rho)) \
            * np.ones(u)


class LTFLScheme(BaseScheme):
    """The paper's scheme: Algorithm-1 controller + prune + quantize +
    power control. Ablation switches reproduce Fig. 2."""

    def __init__(self, recontrol_every: int = 0, *, use_prune: bool = True,
                 use_quant: bool = True, use_power: bool = True):
        self.recontrol_every = recontrol_every
        self.uses_prune = use_prune
        self.use_quant = use_quant
        self.use_power = use_power
        suffix = "".join(
            s for s, on in (("-noprune", not use_prune),
                            ("-noquant", not use_quant),
                            ("-nopower", not use_power)) if on)
        self.name = "ltfl" + suffix
        self._decision: Optional[controller_mod.ControlDecision] = None
        self._solved_epoch: int = -1
        self._solved_cohort: int = -1

    def compressor(self, *, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
        if not self.use_quant:
            return identity_compressor()
        return ltfl_quantizer(uniforms=uniforms)

    def _solve(self):
        r = self.runner
        ltfl = r.ltfl
        ch = r.channel
        if not self.use_power:
            # fixed mid power, closed-form rho/delta only (one batched
            # Theorem-2/3 call over the device axis)
            w = ltfl.wireless
            powers = np.full(r.num_devices, 0.5 * w.p_max)
            payload = payload_bits_host(r.num_params, ltfl.delta_max,
                                        ltfl.xi_bits)
            rhos = controller_mod.optimal_rho(ltfl, ch, payload, powers)
            deltas = controller_mod.optimal_delta(ltfl, ch, rhos, powers,
                                                  r.num_params)
            pers = packet_error_rate(w, ch, powers)
            self._decision = controller_mod.ControlDecision(
                rho=rhos, delta=deltas, power=powers, per=pers,
                gamma=float("nan"), alternations=0, gamma_trace=np.zeros(0))
        else:
            self._decision = controller_mod.solve(
                ltfl, ch, r.num_params,
                range_sq_sums=r.range_sq_estimates, rng=r.np_rng)
        self._solved_epoch = r.channel_epoch
        self._solved_cohort = r.cohort_epoch

    def controls(self, rnd: int) -> Controls:
        # a decision is per-device: solved against one cohort's channel
        # view, it is meaningless for a differently-composed cohort
        if self._decision is None or (
                self.recontrol_every and rnd % self.recontrol_every == 0) \
                or self._solved_cohort != self.runner.cohort_epoch:
            self._solve()
        d = self._decision
        rho = d.rho if self.uses_prune else np.zeros_like(d.rho)
        delta = (d.delta.astype(np.float64) if self.use_quant
                 else np.zeros_like(d.rho))
        # the decision's PERs are only valid for the channel they were
        # solved against; under block fading the runner recomputes
        per = (d.per if self._solved_epoch == self.runner.channel_epoch
               else None)
        return Controls(rho=rho, delta=delta, power=d.power, per=per)

    def payload_bits(self, ctl: Controls) -> np.ndarray:
        if not self.use_quant:
            return self._full_bits(ctl.rho)
        v = self.runner.num_params
        xi = self.runner.ltfl.xi_bits
        return (v * ctl.delta + xi) * (1.0 - ctl.rho)        # Eq. 18/32
