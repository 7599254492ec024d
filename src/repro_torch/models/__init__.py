"""Models, held against ``repro.models``: the paper's pre-activation
ResNet, the small MLP classifier, the dense decoder LM, the model factory
and the weight carry to and from the reference's trees."""

from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.models.registry import build_model, make_train_batch
from repro_torch.models.resnet import ResNet
from repro_torch.models.transformer import DecoderLM

__all__ = ["ResNet", "MLP", "MLPConfig", "DecoderLM", "build_model",
           "make_train_batch", "params_from_numpy", "params_to_numpy"]
