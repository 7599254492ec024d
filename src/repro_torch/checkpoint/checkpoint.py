"""npz checkpoints of parameter trees, cross-loadable with the reference.

Held against ``repro.checkpoint.checkpoint`` (``save``, ``restore``,
``latest_step``): ``<dir>/step_<N>.npz`` holds every leaf under its
key-path name (path components joined by ``/``) beside a JSON manifest
(``step_<N>.npz.json``: names, stored dtypes, metadata). A tree is a
nest of dicts, lists and tuples whose leaves are tensors, numpy arrays
or numbers; the port's flat parameter dicts keyed by dotted paths
(``"groups.1.0.conv1"``) name their leaves as the reference's nested
trees do (``groups/1/0/conv1``), so either side restores the other's
files. bfloat16 is stored as float32 and cast back on restore, as in the
reference (exact both ways).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any
_SEP = "/"


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order: dict keys sorted by
    their path components, list entries by index."""
    if isinstance(tree, dict):
        out = []
        keys = sorted(tree, key=lambda k: tuple(
            int(t) if t.isdigit() else t for t in str(k).split(".")))
        for k in keys:
            out += _flatten(tree[k], prefix + tuple(str(k).split(".")))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [(_SEP.join(prefix), tree)]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    return arr


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>.npz`` and its manifest;
    returns the npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    names = [n for n, _ in flat]
    if len(set(names)) != len(names):
        raise ValueError("duplicate key paths in tree")
    arrays = {n: _to_numpy(leaf) for n, leaf in flat}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(arr).astype(like.dtype)
    return torch.from_numpy(np.array(arr))


def _rebuild(tree: Tree, leaves, prefix: Tuple[str, ...] = ()) -> Tree:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return leaves[_SEP.join(prefix)]


def restore(ckpt_dir: str, target: Tree, step: Optional[int] = None
            ) -> Tree:
    """Restore into the structure of ``target`` (its values are ignored;
    each leaf takes the target leaf's dtype and, for a tensor, its
    device). ``step`` None takes the latest."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        leaves = {}
        for name, like in _flatten(target):
            if name not in data:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            leaves[name] = _restore_leaf(data[name], like)
    return _rebuild(target, leaves)
