"""Core of the port: the numpy host control plane (channel, delay/energy,
convergence gap, Bayesian optimization, Algorithm 1) and the tensor
stages of the round step (pruning, quantization, compression,
aggregation). Exports the reference's names (``repro.core``)."""
from repro_torch.core import (
    aggregation,
    bayesopt,
    channel,
    compressors,
    controller,
    convergence,
    delay_energy,
    pruning,
    quantization,
)
from repro_torch.core.compressors import Compressor, get_compressor
from repro_torch.core.ltfl_step import make_fl_train_step, make_plain_train_step

__all__ = [
    "aggregation",
    "bayesopt",
    "channel",
    "compressors",
    "controller",
    "convergence",
    "delay_energy",
    "pruning",
    "quantization",
    "Compressor",
    "get_compressor",
    "make_fl_train_step",
    "make_plain_train_step",
]
