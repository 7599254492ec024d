"""The federated round engine, held against ``repro.fed``: ``FedRunner``,
the scanned engine (``ScanRunner``, ``make_scanned_step``, sweep lanes),
the buffered-async engine (``AsyncRunner``, ``ChurnSpec``), the
population layer's cohort samplers and its device registry in blocks
(``PopulationArrays``, ``device_population``), LTFL and the paper's
four baseline schemes."""

from repro_torch.fed.async_engine import AsyncRunner
from repro_torch.fed.population import (
    ChannelAwareSampler,
    ChurnSpec,
    CohortSampler,
    EnergyAwareSampler,
    Population,
    PopulationArrays,
    UniformSampler,
    device_population,
    gumbel_topk_inclusion,
)
from repro_torch.fed.rounds import FedRunner, RoundRecord, resolve_device
from repro_torch.fed.scan_engine import (
    LaneSpec,
    RoundLog,
    ScanRunner,
    SweepSpec,
    make_scanned_step,
)
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
    "ScanRunner",
    "AsyncRunner",
    "ChurnSpec",
    "RoundLog",
    "LaneSpec",
    "SweepSpec",
    "make_scanned_step",
    "resolve_device",
    "Population",
    "PopulationArrays",
    "device_population",
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
