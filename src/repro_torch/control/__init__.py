"""The device half of the control plane, held against ``repro.control``.

The host control plane (``repro_torch.core.controller`` / ``bayesopt``
and the ``repro_torch.fed.population`` samplers) is numpy float64 and
runs between segments. This package holds its device twins, so the
scanned engine (``repro_torch.fed.scan_engine``) recontrols, schedules
and evaluates every round without leaving the segment:

* ``device_bayesopt``: the fixed-shape float32 GP surrogate and proposal
  loop (the twin of ``bayesopt.minimize``);
* ``device_controller``: Theorems 2/3 in closed form, the batched
  Gamma/feasibility evaluation and the whole Algorithm-1 alternation
  (``solve_dev``);
* ``device_samplers``: the cohort schedulers' twins, and their sharded
  twins over a registry in blocks;
* ``program``: the ``ControlProgram`` a scheme returns from
  ``scan_control_program`` to run its control loop inside the segment.
"""

from repro_torch.control.device_bayesopt import (
    BODraws,
    make_draws,
    minimize_dev,
)
from repro_torch.control.device_controller import (
    DeviceDecision,
    evaluate_dev,
    optimal_delta_dev,
    optimal_rho_dev,
    solve_dev,
)
from repro_torch.control.device_samplers import (
    DeviceSamplerTwin,
    channel_aware_twin,
    energy_aware_twin,
    sharded_channel_aware_twin,
    sharded_energy_aware_twin,
    sharded_uniform_twin,
    uniform_twin,
)
from repro_torch.control.program import ControlProgram, DeviceControls

__all__ = [
    "BODraws",
    "make_draws",
    "minimize_dev",
    "DeviceDecision",
    "evaluate_dev",
    "optimal_rho_dev",
    "optimal_delta_dev",
    "solve_dev",
    "DeviceSamplerTwin",
    "uniform_twin",
    "channel_aware_twin",
    "energy_aware_twin",
    "sharded_uniform_twin",
    "sharded_channel_aware_twin",
    "sharded_energy_aware_twin",
    "ControlProgram",
    "DeviceControls",
]
