"""The federated round engine, held against ``repro.fed``: ``FedRunner``,
the population layer's uniform sampler and the LTFL scheme."""

from repro_torch.fed.population import (
    CohortSampler,
    Population,
    UniformSampler,
)
from repro_torch.fed.rounds import FedRunner, RoundRecord, resolve_device
from repro_torch.fed.schemes import BaseScheme, Controls, LTFLScheme

ALL_SCHEMES = {"ltfl": LTFLScheme}

__all__ = [
    "FedRunner",
    "RoundRecord",
    "resolve_device",
    "Population",
    "CohortSampler",
    "UniformSampler",
    "BaseScheme",
    "Controls",
    "LTFLScheme",
    "ALL_SCHEMES",
]
