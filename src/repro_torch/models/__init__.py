"""Models, held against ``repro.models``: the paper's pre-activation
ResNet and the weight carry to and from the reference's trees."""

from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.resnet import ResNet

__all__ = ["ResNet", "params_from_numpy", "params_to_numpy"]
