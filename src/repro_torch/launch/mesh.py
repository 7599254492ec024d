"""Meshes: the reference's production and test layouts as DeviceMeshes.

Held against ``repro.launch.mesh`` (``make_production_mesh``,
``make_test_mesh``, ``client_axes``, ``num_clients``): the same shapes
and axis names,

    production  ("data", "model") = (16, 16), multi-pod
                ("pod", "data", "model") = (2, 16, 16);
    test        (2, 4) and (2, 2, 2),

built with ``torch.distributed.device_mesh.init_device_mesh`` on an
explicit device type. A ``DeviceMesh`` needs a default process group of
the mesh's size: the dry run and the CPU tests make one with the fake
backend (``fake_process_group``), a job on cards with NCCL (one card: a
world of 1 and a (1, 1) mesh from ``make_mesh``). Importing this module
touches no process group.

``AbstractMesh`` is the counterpart of ``jax.sharding.AbstractMesh``:
axis names and sizes with no group. The rule table
(``launch.sharding``) accepts it as well as a ``DeviceMesh``, so rules
resolve without any process group.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


class AbstractMesh:
    """Axis names and sizes, in mesh order; no devices, no group."""

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        self.axis_names = tuple(a for a, _ in axes)
        self.shape = {a: int(n) for a, n in axes}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({tuple(self.shape.items())})"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, for a ``DeviceMesh`` (its dim
    names), an ``AbstractMesh`` or any object with ``axis_names`` and a
    ``shape`` mapping (the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _layout(multi_pod: bool, production: bool):
    if production:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    else:
        shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (whose world size must be the mesh's size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str):
    shape, axes = _layout(multi_pod, production=True)
    return make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str):
    """The CI mesh: 8 ranks, (2, 4) or (2, 2, 2)."""
    shape, axes = _layout(multi_pod, production=False)
    return make_mesh(shape, axes, device_type=device_type)


def client_axes(multi_pod: bool, clients_on_pod_only: bool) -> tuple:
    """Mesh axes the FL client dimension is laid out on."""
    if clients_on_pod_only:
        return ("pod",) if multi_pod else ()
    return ("pod", "data") if multi_pod else ("data",)


def num_clients(mesh, clients_on_pod_only: bool) -> int:
    sizes = mesh_axes(mesh)
    axes = client_axes("pod" in sizes, clients_on_pod_only)
    return max(math.prod(sizes[a] for a in axes), 1)


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """A default process group of ``world_size`` ranks on the fake
    backend (one process plays ``rank``; collectives return at once and
    move no data): what a dry run's mesh needs. Destroy it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def mesh_name(mesh) -> str:
    """'data16xmodel16', as the reference's records name a mesh."""
    return "x".join(f"{k}{v}" for k, v in mesh_axes(mesh).items())

