"""The scheme <-> scanned-engine device-control protocol.

Held against ``repro.control.program`` (``DeviceControls``,
``ControlProgram``). ``ScanRunner(control="device")`` runs per-round
control (Algorithm 1's recontrol, FedMP's UCB bandit) inside the
segment's loop instead of ending a segment at every host recontrol
round. A scheme takes part by returning a ``ControlProgram`` from
``scan_control_program(runner)``: the program's state lives on the
device between rounds and segments, ``controls`` makes the round's
decision from it, and ``feedback`` (optional) folds in the round's
measured loss and delay, the device twin of ``BaseScheme.post_round``.

Purity contract, as the reference's: ``controls`` and ``feedback`` read
every per-round and per-lane value from their arguments (state, round,
cohort, channel view, the lane's generator and the lane's laned
``ltfl`` view, whose float fields are 0-d float32 tensors) and close
over static configuration only (arm grids, parameter counts, cohort
widths: what a sweep bucket is keyed on). The engine runs a program
once per lane, so a closure over one runner's mutable state would still
be wrong for a replay, and a closure over a config float would pin one
channel regime.

Cadence: ``every`` declares how often the program decides. The segment
planner aligns segments to it and passes ``decide`` as a plain Python
bool per round; a hold round (``decide=False``) returns the carried
decision and never calls the solve, so it draws nothing from the
lane's generator.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class DeviceControls(NamedTuple):
    """One round's control decision for the (U,) cohort, float32 tensors
    on the runner's device. ``payload`` is the scheme's analytic uplink
    bits under these controls (Eq. 18/32), the device twin of
    ``BaseScheme.payload_bits``: the accounting runs in the segment too."""

    rho: torch.Tensor      # (U,) pruning ratios
    delta: torch.Tensor    # (U,) quantization bits (0 => no quantization)
    power: torch.Tensor    # (U,) transmission powers (W)
    payload: torch.Tensor  # (U,) uplink payload bits


class ControlProgram(NamedTuple):
    """A scheme's device-resident control plane (see the module
    docstring).

    * ``init``: the initial state (tensors on the runner's device; for
      LTFL the last decision, for FedMP the (N, A) bandit);
    * ``controls(state, r, cohort, ch, range_sq, generator, ltfl, *,
      decide) -> (DeviceControls, state)``: round ``r``'s decision for
      the cohort view ``ch`` (a (U,) ``ChannelArrays``) given the
      cohort's carried gradient-range estimates ``range_sq``; ``decide``
      False holds the carried decision;
    * ``every``: the decide cadence in rounds (1: every round);
    * ``feedback(state, cohort, loss, delay) -> state`` (optional): the
      update after the round's step. A program that has one owns the
      feedback loop: the engine then skips the host ``post_round``;
    * ``absorb(scheme, state) -> None`` (optional): run after a segment
      with the state as numpy arrays, so the host scheme stays
      inspectable (FedMP's bandit counters).
    """

    init: Any
    controls: Callable[..., Any]
    every: int = 1
    feedback: Optional[Callable[..., Any]] = None
    absorb: Optional[Callable[..., None]] = None
