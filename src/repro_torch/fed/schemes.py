"""FL schemes: LTFL (+ its ablations) and the paper's four baselines
(Section 6.1): FedSGD, SignSGD, FedMP, STC.

Held against ``repro.fed.schemes`` (``Controls``, ``BaseScheme``,
``LTFLScheme`` with its host ``_solve``, ``controls``, ``payload_bits``
and the three ablation switches; ``FedSGDScheme``, ``SignSGDScheme``,
``FedMPScheme`` with its population-indexed UCB1 bandit, ``STCScheme``
with its Golomb payload estimate). A scheme is a declaration: it supplies
vectorized per-round controls — (U,) pruning ratio rho, quantization
level delta and transmission power — a ``Compressor`` for the round step,
and the analytic uplink payload in bits per device, which the host
delay/energy accounting charges.

The scanned engine's hooks (``repro_torch.fed.scan_engine``):
``scan_supported``, ``scan_recontrol_every`` (the host-recontrol cadence
that ends a scanned segment), ``scan_lane_signature`` (what a scheme
bakes into a segment, which ``run_sweep`` buckets lanes by) and
``scan_control_program`` (the ``repro_torch.control.ControlProgram``
that ``ScanRunner(control="device")`` runs inside the segment: LTFL's
per-round Algorithm 1 through ``solve_dev``, FedMP's UCB bandit on the
device). ``configure_async`` is the buffered-async engine's hook
(``repro_torch.fed.async_engine``): LTFL clamps Algorithm 1's host delay
budget to the straggler deadline plus the server delay.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.control import (
    ControlProgram,
    DeviceControls,
    optimal_delta_dev,
    optimal_rho_dev,
    solve_dev,
)
from repro_torch.core import controller as controller_mod
from repro_torch.core.channel import f32, packet_error_rate
from repro_torch.core.compressors import (
    Compressor,
    UniformSource,
    identity_compressor,
    ltfl_quantizer,
    sign_compressor,
    stc_compressor,
)
from repro_torch.core.quantization import payload_bits, payload_bits_host


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
    # the scanned engine runs whole segments of rounds under constant
    # controls; a scheme that cannot declare its recontrol cadence
    # (scan_recontrol_every) sets this False and stays on FedRunner
    scan_supported = True

    def setup(self, runner) -> None:
        self.runner = runner

    def scan_recontrol_every(self, runner) -> int:
        """Host-recontrol cadence for the scanned engine: every k rounds
        the host recomputes ``controls`` (a segment boundary); 0 means
        the controls are constant for the whole run."""
        return 0

    def scan_control_program(self, runner) -> Optional[ControlProgram]:
        """The ``ControlProgram`` that recomputes this scheme's controls
        inside a segment under ``ScanRunner(control="device")``, or None
        when the scheme has no device twin of its control loop (the
        runner then raises if the scheme recontrols). Schemes whose
        ``scan_recontrol_every`` is 0 never need one."""
        return None

    def scan_lane_signature(self, runner) -> tuple:
        """Hashable identity of everything this scheme bakes into a
        scanned segment (compressor constants, switches, arm grids,
        cadences): ``run_sweep`` runs lanes together only when their
        signatures match. Stateless schemes close over shapes only."""
        return (type(self).__name__,)

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

    def configure_async(self, runner) -> None:
        """Called once by ``AsyncRunner`` after ``setup``, to adapt the
        scheme's control problem to buffered rounds. Default: nothing
        (stateless schemes' controls do not depend on how a round
        closes; FedMP's bandit learns from the logged delay, which under
        the async engine is the buffered round's)."""

    def _full_bits(self, rho=0.0) -> np.ndarray:
        u = self.runner.num_devices
        return 32.0 * self.runner.num_params * (1.0 - np.asarray(rho)) \
            * np.ones(u)

    def _fixed_power_controls(self, rho=None) -> Controls:
        """The baselines' controls: no quantization, power p_max / 2 and
        ``rho`` (default 0) for every device."""
        r = self.runner
        u = r.num_devices
        return Controls(rho=np.zeros(u) if rho is None else rho,
                        delta=np.zeros(u),
                        power=np.full(u, 0.5 * r.ltfl.wireless.p_max))


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
        # Algorithm 1's T^max under a straggler deadline (None: the
        # config's); set by configure_async
        self._async_t_max: Optional[float] = None
        # how many rounds ran the device solve (the reference counts the
        # traces that embed it): hold rounds must not
        self._n_decide_solves: int = 0

    def compressor(self, *, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
        if not self.use_quant:
            return identity_compressor()
        return ltfl_quantizer(uniforms=uniforms)

    def scan_recontrol_every(self, runner) -> int:
        # a decision is per cohort: a cohort drawn anew every round
        # re-solves every round (FedRunner's cohort_epoch rule)
        if runner.cohort_size < runner.population_size:
            return 1
        return self.recontrol_every or 0

    def scan_lane_signature(self, runner) -> tuple:
        # the switches gate which solve runs; the cadence shapes the
        # segment plan; the channel regime is laned, not baked
        return (type(self).__name__, self.scan_recontrol_every(runner),
                self.uses_prune, self.use_quant, self.use_power)

    def configure_async(self, runner) -> None:
        """Clamp Algorithm 1's per-round delay budget to min(T^max,
        deadline + server delay): a device that finishes after the
        deadline misses the buffer, so delay beyond it buys nothing. An
        infinite deadline leaves every solve as it was. As in the
        reference, only the host solve reads the clamp; the device
        program (``control="device"``) reads the laned ``t_max``."""
        deadline = runner._async.deadline
        if np.isfinite(deadline):
            budget = deadline + runner.ltfl.server_delay
            if budget < runner.ltfl.t_max:
                self._async_t_max = float(budget)

    def _solve(self):
        r = self.runner
        ltfl = r.ltfl
        if self._async_t_max is not None:
            ltfl = replace(ltfl, t_max=self._async_t_max)
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

    def scan_control_program(self, runner) -> ControlProgram:
        """Algorithm 1 on the device: ``solve_dev`` re-solves against the
        round's own fading and cohort, per-round recontrol with no
        segment boundary. The ablation switches mirror ``controls``: the
        full solve (or, with ``use_power=False``, the closed forms at
        mid power), then prune / quant zeroed. The state is the last
        decision; a cadence k > 1 declares ``every=k`` and hold rounds
        return it without solving. Regime values come from the lane's
        ``ltfl`` argument, never from this scheme or runner."""
        v = runner.num_params
        u = runner.num_devices
        device = runner.device
        use_prune, use_quant = self.uses_prune, self.use_quant
        use_power = self.use_power
        scheme = self

        def solve_controls(ltfl, ch, range_sq, generator) -> DeviceControls:
            scheme._n_decide_solves += 1
            if use_power:
                d = solve_dev(ltfl, ch, v, range_sq, generator)
                rho_full, delta_full, power = d.rho, d.delta, d.power
            else:
                # fixed mid power, closed-form rho/delta only (the host
                # _solve's no-power path)
                power = torch.zeros((u,), device=device) \
                    + 0.5 * f32(ltfl.wireless.p_max)
                payload0 = payload_bits(v, f32(ltfl.delta_max),
                                        ltfl.xi_bits)
                rho_full = optimal_rho_dev(ltfl, ch, payload0, power)
                delta_full = optimal_delta_dev(ltfl, ch, rho_full, power, v)
            rho = rho_full if use_prune else torch.zeros_like(rho_full)
            delta = delta_full if use_quant else torch.zeros_like(rho_full)
            if use_quant:       # Eq. 18/32 through the shared formula
                payload = payload_bits(v, delta, ltfl.xi_bits) * (1.0 - rho)
            else:
                payload = np.float32(32.0 * v) * (1.0 - rho)
            return DeviceControls(rho=rho, delta=delta, power=power,
                                  payload=payload)

        w0 = runner.ltfl.wireless
        zeros = torch.zeros((u,), dtype=torch.float32, device=device)
        init = DeviceControls(
            rho=zeros, delta=zeros,
            power=zeros + np.float32(0.5 * (w0.p_min + w0.p_max)),
            payload=zeros)      # replaced at the first decide round

        def controls(state, r, cohort, ch, range_sq, generator, ltfl, *,
                     decide):
            if not decide:      # hold: the carried decision, no solve
                return state, state
            ctl = solve_controls(ltfl, ch, range_sq, generator)
            return ctl, ctl

        return ControlProgram(init=init, controls=controls,
                              every=max(self.scan_recontrol_every(runner),
                                        1))


class FedSGDScheme(BaseScheme):
    """McMahan et al. 2017: full-precision gradients, no compression."""

    name = "fedsgd"

    def controls(self, rnd):
        return self._fixed_power_controls()

    def payload_bits(self, ctl):
        return self._full_bits()


class SignSGDScheme(BaseScheme):
    """Bernstein et al. 2018: transmit sign(g); the compressor's
    ``server_transform`` signs the aggregate (majority vote)."""

    name = "signsgd"

    def __init__(self, lr_scale: float = 0.02):
        self.lr_scale = lr_scale   # signSGD needs a much smaller step

    def scan_lane_signature(self, runner) -> tuple:
        return (type(self).__name__, self.lr_scale)   # baked into the step

    def compressor(self, *, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
        return sign_compressor(self.lr_scale)

    def controls(self, rnd):
        return self._fixed_power_controls()

    def payload_bits(self, ctl):
        u = self.runner.num_devices
        return float(self.runner.num_params) * np.ones(u)  # 1 bit / coord


class FedMPScheme(BaseScheme):
    """Jiang et al. 2023: per-device multi-armed-bandit pruning-rate
    selection (UCB1 over a discrete rho grid, reward = loss decrease per
    unit round delay). No quantization; full-precision kept entries,
    pruned by magnitude at each client's rho as LTFL's are.

    Bandit state is POPULATION-indexed, (N, A) float64: each registered
    device keeps its own UCB counters across rounds, and only this
    round's cohort pulls an arm."""

    name = "fedmp"
    uses_prune = True

    def __init__(self, arms=(0.0, 0.125, 0.25, 0.375, 0.5), ucb_c=1.0):
        self.arms = np.asarray(arms)
        self.ucb_c = ucb_c

    def setup(self, runner):
        super().setup(runner)
        n, a = runner.population_size, len(self.arms)
        self._counts = np.zeros((n, a))
        self._rewards = np.zeros((n, a))
        self._choice = np.zeros(n, dtype=np.int64)
        self._prev_loss: Optional[float] = None

    def controls(self, rnd):
        r = self.runner
        t = rnd + 1
        for u in r.cohort:
            if np.any(self._counts[u] == 0):
                self._choice[u] = int(np.argmin(self._counts[u]))
            else:
                mean = self._rewards[u] / self._counts[u]
                ucb = mean + self.ucb_c * np.sqrt(
                    2.0 * np.log(t) / self._counts[u])
                self._choice[u] = int(np.argmax(ucb))
        return self._fixed_power_controls(self.arms[self._choice[r.cohort]])

    def payload_bits(self, ctl):
        return self._full_bits(ctl.rho)

    def scan_recontrol_every(self, runner) -> int:
        return 1          # the bandit re-decides (and learns) every round

    def scan_lane_signature(self, runner) -> tuple:
        return (type(self).__name__, tuple(float(a) for a in self.arms),
                float(self.ucb_c))

    def scan_control_program(self, runner) -> ControlProgram:
        """The UCB bandit on the device: (N, A) float32 counts and reward
        sums plus the previous loss, updated each round by ``feedback``
        (the device twin of ``post_round``: the same argmin-unexplored /
        argmax-UCB arm rule, the same loss decrease per unit delay).
        ``absorb`` writes the state back into this scheme after a
        segment; ``_choice`` is not synced (the last cohort's arms live
        in the device state only)."""
        device = runner.device
        arms = torch.as_tensor(self.arms, dtype=torch.float32,
                               device=device)
        ucb_c = np.float32(self.ucb_c)
        u = runner.num_devices
        payload_full = np.float32(32.0 * runner.num_params)
        zeros = torch.zeros((u,), dtype=torch.float32, device=device)
        ones = torch.ones((u,), dtype=torch.float32, device=device)
        one = torch.ones((), dtype=torch.float32, device=device)

        def f32_tensor(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        init = {
            "counts": f32_tensor(self._counts),
            "rewards": f32_tensor(self._rewards),
            "choice": torch.zeros((u,), dtype=torch.int64, device=device),
            "prev_loss": f32_tensor(self._prev_loss or 0.0),
            "has_prev": f32_tensor(0.0 if self._prev_loss is None else 1.0),
        }

        def controls(state, r, cohort, ch, range_sq, generator, ltfl, *,
                     decide):
            # every round decides (every=1): the bandit has no hold path
            c = torch.index_select(state["counts"], 0, cohort)     # (U, A)
            rw = torch.index_select(state["rewards"], 0, cohort)
            two_log_t = np.float32(2.0) * np.log(np.float32(r + 1))
            unexplored = torch.any(c == 0.0, dim=1)
            safe = torch.clamp(c, min=1e-12)
            ucb = rw / safe + ucb_c * torch.sqrt(two_log_t / safe)
            choice = torch.where(unexplored, torch.argmin(c, dim=1),
                                 torch.argmax(ucb, dim=1))
            rho = torch.index_select(arms, 0, choice)
            ctl = DeviceControls(
                rho=rho, delta=zeros,
                power=zeros + 0.5 * f32(ltfl.wireless.p_max),
                payload=payload_full * (1.0 - rho))
            return ctl, {**state, "choice": choice}

        def feedback(state, cohort, loss, delay):
            gain = torch.clamp(state["prev_loss"] - loss, min=0.0)
            reward = torch.where(state["has_prev"] > 0.0,
                                 gain / torch.clamp(delay, min=1e-9), 0.0)
            pulled = (cohort, state["choice"])
            return {**state,
                    "counts": state["counts"].index_put(
                        pulled, ones, accumulate=True),
                    "rewards": state["rewards"].index_put(
                        pulled, reward * ones, accumulate=True),
                    "prev_loss": loss.to(torch.float32),
                    "has_prev": one}

        def absorb(scheme, state):
            scheme._counts = np.asarray(state["counts"], np.float64)
            scheme._rewards = np.asarray(state["rewards"], np.float64)
            scheme._prev_loss = (float(state["prev_loss"])
                                 if float(state["has_prev"]) > 0.0
                                 else None)

        return ControlProgram(init=init, controls=controls,
                              feedback=feedback, absorb=absorb)

    def post_round(self, rnd, metrics):
        loss = metrics["train_loss"]
        if self._prev_loss is not None:
            gain = max(self._prev_loss - loss, 0.0)
            reward = gain / max(metrics["delay"], 1e-9)
            for u in self.runner.cohort:
                a = self._choice[u]
                self._counts[u, a] += 1
                self._rewards[u, a] += reward
        else:
            for u in self.runner.cohort:
                self._counts[u, self._choice[u]] += 1
        self._prev_loss = loss


class STCScheme(BaseScheme):
    """Sattler et al. 2020: sparse ternary compression — top-k
    sparsification + ternarization (mean magnitude of kept entries) +
    client-side error accumulation. The residual is the step's carried
    ``comp_state``; the payload is a Golomb-coded estimate.

    The residual is per cohort SLOT, not per registered device: under
    partial participation with a changing cohort a slot's error feedback
    mixes devices, as in the reference."""

    name = "stc"

    def __init__(self, sparsity: float = 0.01):
        self.sparsity = sparsity

    def scan_lane_signature(self, runner) -> tuple:
        return (type(self).__name__, self.sparsity)   # baked into the step

    def compressor(self, *, uniforms: Optional[UniformSource] = None
                   ) -> Compressor:
        return stc_compressor(self.sparsity)

    def controls(self, rnd):
        return self._fixed_power_controls()

    def payload_bits(self, ctl):
        # Golomb-ish estimate: k * (log2(1/p) + 1.5) bits + magnitude
        v = self.runner.num_params
        k = self.sparsity * v
        bits = k * (np.log2(1.0 / self.sparsity) + 1.5) + 32.0
        return float(bits) * np.ones(self.runner.num_devices)
