"""The federated round engine, held against ``repro.fed``: ``FedRunner``,
the population layer's cohort samplers, LTFL and the paper's four
baseline schemes."""

from repro_torch.fed.population import (
    ChannelAwareSampler,
    CohortSampler,
    EnergyAwareSampler,
    Population,
    UniformSampler,
    gumbel_topk_inclusion,
)
from repro_torch.fed.rounds import FedRunner, RoundRecord, resolve_device
from repro_torch.fed.schemes import (
    BaseScheme,
    Controls,
    FedMPScheme,
    FedSGDScheme,
    LTFLScheme,
    SignSGDScheme,
    STCScheme,
)

ALL_SCHEMES = {
    "ltfl": LTFLScheme,
    "fedsgd": FedSGDScheme,
    "signsgd": SignSGDScheme,
    "fedmp": FedMPScheme,
    "stc": STCScheme,
}

__all__ = [
    "FedRunner",
    "RoundRecord",
    "resolve_device",
    "Population",
    "CohortSampler",
    "UniformSampler",
    "ChannelAwareSampler",
    "EnergyAwareSampler",
    "gumbel_topk_inclusion",
    "BaseScheme",
    "Controls",
    "LTFLScheme",
    "FedSGDScheme",
    "SignSGDScheme",
    "FedMPScheme",
    "STCScheme",
    "ALL_SCHEMES",
]
