"""Data: synthetic CIFAR and token sequences, partitions and client
batching, held against ``repro.data`` (numpy on both sides, bitwise)."""

from repro_torch.data.partition import (
    PackedParts,
    class_histogram,
    dirichlet_partition,
    iid_partition,
    population_partition,
    population_partition_reference,
)
from repro_torch.data.pipeline import ArrayDataset, ClientBatcher
from repro_torch.data.synthetic import synthetic_cifar, synthetic_lm

__all__ = [
    "ArrayDataset",
    "ClientBatcher",
    "PackedParts",
    "synthetic_cifar",
    "synthetic_lm",
    "iid_partition",
    "dirichlet_partition",
    "population_partition",
    "population_partition_reference",
    "class_histogram",
]
