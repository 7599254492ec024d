"""Models, held against ``repro.models``: the paper's pre-activation
ResNet, the small MLP classifier, the decoder LM (dense, MoE and VLM
families, MLA attention), RWKV6 (the SSM family), the Mamba2 + shared
attention hybrid and the encoder-decoder backbone, each with prefill and
decode, the model factory and the weight carry to and from the
reference's trees."""

from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.models.registry import (
    build_model,
    make_decode_inputs,
    make_train_batch,
)
from repro_torch.models.resnet import ResNet
from repro_torch.models.rwkv6 import RWKVLM
from repro_torch.models.transformer import DecoderLM

__all__ = ["ResNet", "MLP", "MLPConfig", "DecoderLM", "RWKVLM", "HybridLM",
           "EncDecLM", "build_model",
           "make_train_batch", "make_decode_inputs", "params_from_numpy",
           "params_to_numpy"]
