"""Logical-axis -> mesh-axis sharding rules, and the population axis.

Held against ``repro.launch.sharding``.

The rule table (lines 38-137, 171-197): ``base_rules``, ``make_pspec``,
``sharding_tree``, ``param_shardings``, ``replicated``,
``batch_shardings``, ``cache_shardings`` and ``policy_for``; a leaf's
local ranges from its placements (``local_index``, ``local_slice``) and
its 'model'-only layout (``model_placements``), which tensor parallelism
computes with. Every
parameter, cache and activation dim carries a logical axis name
(``ParamSpec.axes``, ``cache_axes``, ``shard_hint``); a rule maps it to
mesh axes, with two safety passes:

  * divisibility: a dim that does not divide by its mesh axes' extent is
    replicated instead of sharded unevenly;
  * dedupe: a mesh axis appears once per tensor; later dims lose.

Policies: baseline (params sharded over 'model' only, replicated over
'data'), and fsdp (param 'embed' dims also over 'data', for the giants).

``make_pspec`` returns a PartitionSpec-like tuple, one entry per tensor
dim (None, an axis name, or a tuple of names), comparable entry by entry
with the reference's. ``placements`` turns it into DTensor placements,
one per mesh dim: a tensor dim on ("pod", "data") is ``Shard(d)`` on both
mesh dims; DTensor nests shards in mesh-dim order, the order every entry
of the table lists them in, and an entry listing its axes in another
order raises. A ``NamedSharding`` is a (mesh, spec) pair; the mesh is a
``DeviceMesh``, or a ``launch.mesh.AbstractMesh`` where no process
group exists (placements and local shapes still resolve).

The population axis (lines 143-168; ``PopMesh``, ``population_mesh``,
``population_pad``, ``population_blocks``): the reference lays the
(N_pad,) registry over a 1-D ("pop",) device mesh and runs its
per-round population work under ``shard_map``. The port keeps one
controller: a ``PopMesh`` is the tuple of S ``torch.device``s that hold
the S equal blocks, and the scanned engine runs each block's work on its
device and assembles the (U,) results on the runner's own device. A mesh
may repeat a card, so one card holds S > 1 blocks and the two-stage draw
and the gathers run there as they would across cards.
"""
from __future__ import annotations

import math
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.common import logical_axes

Spec = Tuple[Any, ...]
MODEL = ("model",)
DATA = ("data",)
POP = ("pop",)


def base_rules(mesh, *, fsdp: bool = False,
               client_axes: Tuple[str, ...] = ()
               ) -> Dict[str, Optional[tuple]]:
    """Logical name -> mesh axes. Only axes present in ``mesh`` are kept."""
    names = tuple(mesh_axes(mesh))
    pod = ("pod",) if "pod" in names else ()
    rules: Dict[str, Optional[tuple]] = {
        # data-like
        "batch": pod + ("data",),
        "client": client_axes,
        "seq": None,
        "population": POP,
        # parameter dims
        "layers": None,
        "vocab": MODEL,
        "embed": DATA if fsdp else None,
        "embed_out": MODEL,
        "heads_fused": MODEL,
        "kv_fused": MODEL,
        "heads": MODEL,
        "kv_heads": MODEL,
        # head_dim takes 'model' only when the head count could not
        # (dedupe in make_pspec)
        "head_dim": MODEL,
        "d_ff": MODEL,
        "experts": MODEL,
        "expert_ff": None,
        "kv_lora": None,
        "ssm_fused": MODEL,
        "conv": None,
        "state": None,
        # activation dims
        "act_seq": None,
        "act_embed": MODEL,
        "act_ff": MODEL,
        "act_expert_ff": None,
    }
    out = {}
    for k, v in rules.items():
        kept = tuple(a for a in v if a in names) if v is not None else ()
        out[k] = kept if kept else None
    return out


def make_pspec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
               rules: Dict[str, Any], mesh) -> Spec:
    """One tensor's logical axes resolved to a spec, with divisibility and
    dedupe enforced."""
    sizes = mesh_axes(mesh)
    used = set()
    spec: List[Any] = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name) if name is not None else None
        if not entry:
            spec.append(None)
            continue
        ax = (entry,) if isinstance(entry, str) else tuple(entry)
        ax = tuple(a for a in ax if a not in used)
        size = math.prod(sizes[a] for a in ax)
        if ax and size > 0 and dim % size == 0:
            used.update(ax)
            spec.append(ax if len(ax) > 1 else ax[0])
        else:
            spec.append(None)
    return tuple(spec)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim, in mesh order) of a spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        ax = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in ax]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} lists mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A tensor's layout: the mesh and its spec."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape one device holds (every sharded dim divides)."""
        sizes = mesh_axes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            if entry is not None:
                ax = (entry,) if isinstance(entry, str) else entry
                out[d] //= math.prod(sizes[a] for a in ax)
        return tuple(out)


def sharding_tree(mesh, rules: Dict[str, Any], shapes: Dict[str, Any],
                  axes: Dict[str, tuple]) -> Dict[str, NamedSharding]:
    """A ``NamedSharding`` per leaf of a flat (shapes, axes) pair;
    ``shapes`` leaves have ``.shape`` (tensors, meta tensors)."""
    return {k: NamedSharding(mesh, make_pspec(tuple(s.shape), axes[k],
                                              rules, mesh))
            for k, s in shapes.items()}


def param_shardings(mesh, model, rules: Dict[str, Any]
                    ) -> Dict[str, NamedSharding]:
    return sharding_tree(mesh, rules, model.abstract_params(),
                         logical_axes(model.param_specs()))


def stacked_shardings(mesh, model, rules: Dict[str, Any], n_clients: int,
                      lead: Optional[str]) -> Dict[str, NamedSharding]:
    """Shardings of the per-client (n_clients, ...) stack of every leaf,
    the leading dim named ``lead``: "client" gives the step's
    ``param_shardings`` (clients on their mesh axes), None its
    ``gather_shardings`` (the client axis replicated: the int8
    all-gather's target)."""
    shapes = {k: torch.empty((n_clients,) + tuple(v.shape), device="meta")
              for k, v in model.abstract_params().items()}
    axes = {k: (lead,) + a
            for k, a in logical_axes(model.param_specs()).items()}
    return sharding_tree(mesh, rules, shapes, axes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_shardings(mesh, rules: Dict[str, Any], batch_struct: Dict[str, Any],
                    leading: str = "batch") -> Dict[str, NamedSharding]:
    """Every batch leaf's leading dim as ``leading`` (batch / client), the
    rest replicated."""
    return {k: NamedSharding(mesh, make_pspec(
                tuple(s.shape), (leading,) + (None,) * (len(s.shape) - 1),
                rules, mesh))
            for k, s in batch_struct.items()}


def cache_shardings(mesh, rules: Dict[str, Any], model,
                    cache_struct: Dict[str, Any]) -> Dict[str, NamedSharding]:
    axes = model.cache_axes()
    return {k: NamedSharding(mesh, make_pspec(tuple(v.shape), axes[k],
                                              rules, mesh))
            for k, v in cache_struct.items()}


def policy_for(arch: ArchConfig) -> Dict[str, Any]:
    """Per-arch sharding policy: the giants shard params over 'data' too
    and keep clients on 'pod' only."""
    return {
        "fsdp": arch.fl_clients_on_pod_only,
        "clients_on_pod_only": arch.fl_clients_on_pod_only,
    }


# --------------------------------------------------------------------------- #
# DTensors from and to local shards
# --------------------------------------------------------------------------- #
def local_index(shape: Tuple[int, ...], mesh, pl, lead: int = 0) -> tuple:
    """This rank's slices of a tensor of global ``shape`` laid out by
    placements ``pl`` (its local ranges), the first ``lead`` dims
    whole."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, pl)
    return (slice(None),) * lead + tuple(
        slice(o, o + n) for o, n in zip(offset[lead:], local[lead:]))


def model_placements(pl, mesh) -> tuple:
    """Placements ``pl`` with only the 'model' dim's shard kept: the
    layout a rank computes a leaf with under tensor parallelism."""
    from torch.distributed.tensor import Replicate
    names = list(mesh_axes(mesh))
    return tuple(q if names[i] == "model" else Replicate()
                 for i, q in enumerate(pl))


def local_slice(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of a full tensor (no communication)."""
    return full[local_index(full.shape, sharding.mesh, sharding.placements)]


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``full``'s global shape whose local tensor is this
    rank's slice of ``full`` (every rank holds the same ``full``)."""
    return from_local(local_slice(full, sharding).contiguous(), sharding,
                      tuple(full.shape))


def from_local(local: torch.Tensor, sharding: NamedSharding,
               shape: Tuple[int, ...]):
    """A DTensor of global ``shape`` from this rank's shard."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def local_bytes(shapes: Dict[str, Any], shardings: Dict[str, NamedSharding]
                ) -> int:
    """Bytes one device holds of a tree laid out by ``shardings``."""
    return sum(math.prod(shardings[k].local_shape(tuple(v.shape)))
               * v.element_size() for k, v in shapes.items())


# --------------------------------------------------------------------------- #
# population axis (the sharded device registry, repro_torch.fed.population)
# --------------------------------------------------------------------------- #
class PopMesh(NamedTuple):
    """S devices, one per block of the registry, along the axis "pop"."""

    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return ("pop",)

    @property
    def shape(self) -> dict:
        return {"pop": len(self.devices)}


def population_mesh(num_shards: Optional[int] = None,
                    devices: Optional[Sequence[Union[str, torch.device]]]
                    = None) -> PopMesh:
    """A ("pop",) mesh of S blocks. With no ``devices`` it takes the first
    ``num_shards`` CUDA cards (default: all of them) and raises when there
    are fewer, as the reference does for its local devices. ``devices``
    names each block's device and may repeat one (``["cuda:0"] * 8`` holds
    8 blocks on one card; ``["cpu"] * 8`` is a CPU runner's mesh); its
    devices must share one type. Nothing falls back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        s = count if num_shards is None else int(num_shards)
        if not 1 <= s <= count:
            raise ValueError(
                f"num_shards={s} not in [1, {count}] (the CUDA cards "
                "here); pass devices= to place several blocks on one card "
                "or on the CPU")
        return PopMesh(tuple(torch.device("cuda", i) for i in range(s)))
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a population mesh needs at least one device")
    if num_shards is not None and int(num_shards) != len(devs):
        raise ValueError(f"num_shards={num_shards} but {len(devs)} devices")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"population mesh devices of mixed types {kinds}")
    if devs[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the "
                           "population mesh")
    return PopMesh(devs)


def population_pad(n: int, mesh: PopMesh) -> int:
    """Smallest multiple of the 'pop' extent >= n (equal blocks; the pad
    tail is masked out of every cohort draw)."""
    s = int(mesh.shape["pop"])
    return -(-n // s) * s


def population_blocks(x: Union[np.ndarray, torch.Tensor],
                      mesh: PopMesh) -> List[torch.Tensor]:
    """Split a padded (N_pad, ...) array into its S row blocks, each on
    its mesh device (the counterpart of the reference's
    ``population_sharding`` placement). A numpy array uploads one block at
    a time, so no second (N_pad, ...) host copy is made; a block never
    shares memory with ``x``, on the CPU either."""
    s = len(mesh.devices)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split into {s} equal "
                         "blocks; pad to population_pad(n, mesh) first")
    blk = x.shape[0] // s
    out = []
    for i, dev in enumerate(mesh.devices):
        part = x[i * blk:(i + 1) * blk]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(dev, copy=True))
    return out
