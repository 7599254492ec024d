"""Entry points, held against ``repro.launch``: the meshes
(``make_production_mesh``, ``make_test_mesh``, ``client_axes``,
``num_clients``; ``launch.mesh``), the rule table (``launch.sharding``),
the dry run (``launch.dryrun``, ``launch.dryrun_lib``,
``launch.op_analysis``), and the population axis (``PopMesh``,
``population_mesh``, ``population_pad``, ``population_blocks``)."""

from repro_torch.launch.mesh import (
    client_axes,
    make_production_mesh,
    make_test_mesh,
    num_clients,
)
from repro_torch.launch.sharding import (
    PopMesh,
    population_blocks,
    population_mesh,
    population_pad,
)

__all__ = [
    "make_production_mesh",
    "make_test_mesh",
    "client_axes",
    "num_clients",
    "PopMesh",
    "population_mesh",
    "population_pad",
    "population_blocks",
]
