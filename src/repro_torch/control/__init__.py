"""The device half of the control plane, held against ``repro.control``:
the cohort samplers' device twins (``device_samplers``). The in-segment
Algorithm 1 (``program``, ``device_bayesopt``, ``device_controller``) is
not ported yet."""

from repro_torch.control.device_samplers import (
    DeviceSamplerTwin,
    channel_aware_twin,
    energy_aware_twin,
    uniform_twin,
)

__all__ = [
    "DeviceSamplerTwin",
    "uniform_twin",
    "channel_aware_twin",
    "energy_aware_twin",
]
