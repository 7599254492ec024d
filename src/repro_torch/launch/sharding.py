"""The population axis: the (N,) device registry laid out in S blocks.

Held against ``repro.launch.sharding`` (``population_mesh``,
``population_sharding``, ``population_pad``; lines 143-168). The
reference lays the (N_pad,) registry over a 1-D ("pop",) device mesh and
runs its per-round population work under ``shard_map``. The port keeps
one controller: a ``PopMesh`` is the tuple of S ``torch.device``s that
hold the S equal blocks, and the scanned engine runs each block's work
on its device and assembles the (U,) results on the runner's own device.
A mesh may repeat a card, so one card holds S > 1 blocks and the
two-stage draw and the gathers run there as they would across cards.

The tensor-parallel rule table of the reference's file is not ported
here.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


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
