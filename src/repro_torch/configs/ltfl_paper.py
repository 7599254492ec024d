"""The paper's own experimental setup (Section 6): pre-activation ResNet on
CIFAR-10-shaped data, 30 devices, Table 2 wireless parameters.

Held against ``repro.configs.ltfl_paper``. The pixel data is synthetic
CIFAR-shaped (32x32x3, 10 classes, ``repro_torch.data.synthetic_cifar``);
the wireless/FL system parameters are the paper's (``LTFLConfig`` /
``WirelessConfig`` defaults == Table 2).
"""
from dataclasses import dataclass, field

from repro_torch.configs.base import LTFLConfig


@dataclass(frozen=True)
class ResNetConfig:
    """Pre-activation ResNet (paper: 64-channel stem, 4 residual groups,
    global average pool to 1x1x512). The defaults are the paper's widths:
    32 parameter leaves, 4,901,450 parameters."""

    name: str = "ltfl-resnet"
    image_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    stem_channels: int = 64
    group_channels: tuple = (64, 128, 256, 512)
    blocks_per_group: tuple = (1, 1, 1, 1)
    norm: str = "group"              # groupnorm: batch-stat-free (FL-safe)


@dataclass(frozen=True)
class PaperExperimentConfig:
    model: ResNetConfig = field(default_factory=ResNetConfig)
    ltfl: LTFLConfig = field(default_factory=LTFLConfig)
    rounds: int = 300
    batch_size: int = 50              # per-device GD batch
    non_iid_alpha: float = 0.0        # 0 => IID; else Dirichlet(alpha)


CONFIG = PaperExperimentConfig()
