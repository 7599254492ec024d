"""Weight carry between the reference's parameter trees and the port.

The reference keeps parameters as a pytree of nested dicts and lists; the
port keeps a flat ``Dict[str, Tensor]`` keyed by dotted paths
(``"groups.1.0.conv1"``, ``"head_gn.gamma"``) — the names
``nn.Module.named_parameters`` gives the port's models — ordered as jax
flattens the tree: dict keys sorted, list entries by index. That order is
the leaf order every per-leaf loop follows (uniform draws, range sums).
Layouts are the reference's (HWIO convolutions), so values cross over
unchanged. Neither function needs jax: the tree comes in as numpy arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, params)``; nested dicts (the
transformer's ``layers.attn.wq``) flatten the same way.

bfloat16: ``np.asarray`` of a jax bfloat16 array has the ``bfloat16``
extension dtype, which ``torch.from_numpy`` rejects, so such a leaf
crosses as its 16-bit pattern and is viewed back as ``torch.bfloat16``
(exact). The other way, a bfloat16 tensor comes out as float32 (exact):
numpy has no bfloat16 of its own.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def path_key(name: str) -> Tuple[Union[int, str], ...]:
    """Sort key giving jax's flatten order for a dotted path (list
    indices compare as integers, dict keys as strings)."""
    return tuple(int(t) if t.isdigit() else t for t in name.split("."))


def in_leaf_order(params: Dict[str, Any]) -> Dict[str, Any]:
    """The same dict, reordered into the reference's leaf order."""
    return {k: params[k] for k in sorted(params, key=path_key)}


def _walk(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _to_torch(leaf: Any) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Any, device: Optional[torch.device] = None
                      ) -> Tree:
    """Reference parameter tree (numpy leaves) -> the port's parameters."""
    return {name: _to_torch(leaf).to(device)
            for name, leaf in _walk(tree, "")}


def params_to_numpy(params: Tree) -> Any:
    """The port's parameters -> the reference's nested tree of numpy
    arrays (dicts, with lists where the path component is an index)."""
    root: Dict[str, Any] = {}
    for name, value in params.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.to(torch.float32)
        node[parts[-1]] = value.numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
