"""Configurations, held against ``repro.configs`` (Table 2 and the
paper's ResNet)."""

from repro_torch.configs.base import LTFLConfig, WirelessConfig
from repro_torch.configs.ltfl_paper import (
    CONFIG,
    PaperExperimentConfig,
    ResNetConfig,
)

__all__ = ["LTFLConfig", "WirelessConfig", "ResNetConfig",
           "PaperExperimentConfig", "CONFIG"]
