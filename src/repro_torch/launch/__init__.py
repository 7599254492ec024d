"""Entry points, held against ``repro.launch``; ``sharding`` holds the
population axis (``PopMesh``, ``population_mesh``, ``population_pad``,
``population_blocks``)."""

from repro_torch.launch.sharding import (
    PopMesh,
    population_blocks,
    population_mesh,
    population_pad,
)

__all__ = [
    "PopMesh",
    "population_mesh",
    "population_pad",
    "population_blocks",
]
