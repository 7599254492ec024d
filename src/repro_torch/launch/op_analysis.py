"""Per-device operation analysis: FLOPs, bytes, peak memory and
collectives of one device's share of a step, counted on its local ops.

The counterpart of ``repro.launch.hlo_analysis`` (torch has no HLO to
parse). ``OpCounter`` is a ``TorchDispatchMode``; every op that reaches
it on plain tensors is one a device runs. A DTensor op is handed on
(``NotImplemented``) so that DTensor lowers it to the local ops and the
functional collectives of one rank, and those come back through the
counter: a matmul whose weight is sharded 16 ways counts 1/16 of the
global FLOPs (``FlopCounterMode`` over DTensors counts the global op).
The global-shape ops DTensor runs under a ``FakeTensorMode`` to infer
its outputs' shapes pass through uncounted.
Under the fake process group (``launch.mesh.fake_process_group``) the
collectives move nothing, and on meta tensors nothing is computed or
allocated: the counts are those of rank 0's program.

* FLOPs: ``torch.utils.flop_counter``'s registry on each local op, with
  ``FlopCounterMode``'s rule for ops it has no formula for (decompose
  them and count the parts), so on plain tensors the count equals
  ``FlopCounterMode``'s.
* bytes: the inputs plus the outputs of every local op that is not a
  view (a factory's template, as ``empty_like``'s, is not read), and the
  inputs of every hand-written kernel the step launches
  (its wrapper reports them through ``kernels.build.note_reads``; its
  output is counted where the wrapper allocates it). An unfused upper
  bound of the memory traffic: a fusing compiler (and a hand-written
  kernel) keeps intermediates on chip.
* peak live bytes: ``base`` (the step's inputs) plus the storages that
  the ops allocate, each counted from its first output until the last
  tensor on it is freed.
* collectives (``_c10d_functional``): kind, count, operand bytes (the
  local input), group size and wire bytes per device under ring
  algorithms (``_wire_factor``, the reference's verbatim).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")

# FlopCounterMode hands these metadata queries on; so does the counter
_SKIP = {torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default,
         torch.ops.aten.size.default,
         torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default,
         torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default,
         torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default,
         torch.ops.prim.layout.default}
for _name in ("sym_is_contiguous",):
    if hasattr(torch.ops.aten, _name):
        _SKIP.add(getattr(torch.ops.aten, _name).default)


# factories whose tensor argument is a template (its shape, dtype and
# device): they read none of its bytes
_TEMPLATES = {getattr(torch.ops.aten, n) for n in (
    "empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
    "randn_like", "new_empty", "new_empty_strided", "new_zeros", "new_ones",
    "new_full") if hasattr(torch.ops.aten, n)}


def _wire_factor(kind: str, group: int) -> float:
    """Per-device link traffic per operand byte (ring algorithms)."""
    g = max(group, 1)
    if g == 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-gather":          # operand is the local shard
        return float(g - 1)
    if kind == "reduce-scatter":
        return (g - 1) / g
    if kind == "all-to-all":
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _group_size(func, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = func._schema.name.split("::")[-1]
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    return _resolve_process_group(args[-1]).size()


class OpCounter(TorchDispatchMode):
    """Counts one device's ops while it is active (see the module
    docstring). ``base`` is the live bytes before the first op (the
    step's inputs); ``inputs`` are tensors whose storages are already in
    ``base`` (views of them allocate nothing)."""

    def __init__(self, base: int = 0, inputs: Iterable = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.live = self.peak = int(base)
        self.coll = defaultdict(float)
        self.coll_count = 0
        self.coll_wire = 0.0
        self.kernel_reads: Dict[str, int] = defaultdict(int)
        self._known = {_storage_key(t) for t in _tensors(inputs)}
        self._refs: Dict[Any, list] = {}
        self._depth = 0

    def __enter__(self):
        if self._depth == 0:
            build.READ_HOOKS.append(self._note_reads)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            build.READ_HOOKS.remove(self._note_reads)
        return super().__exit__(*exc)

    def _note_reads(self, name: str, tensors) -> None:
        n = sum(_nbytes(t) for t in tensors)
        self.kernel_reads[name] += n
        self.hbm_bytes += n

    def _release(self, key) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def _track(self, out) -> None:
        for t in _tensors(out):
            if type(t) is not torch.Tensor:
                continue
            key = _storage_key(t)
            if key is None or key in self._known:
                continue
            entry = self._refs.get(key)
            if entry is None:
                n = t.untyped_storage().nbytes()
                entry = self._refs[key] = [n, 0]
                self.live += n
            entry[1] += 1
            weakref.finalize(t, self._release, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if func in _SKIP or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation infers the global output's
            # shape under a FakeTensorMode: not an op a device runs
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        ns = func._schema.name.split("::")
        if ns[0] == "_c10d_functional" and ns[-1] in _COLLECTIVES:
            kind = _COLLECTIVES[ns[-1]]
            operand = _nbytes(args[0])
            group = _group_size(func, args)
            self.coll[kind] += operand
            self.coll_count += 1
            self.coll_wire += operand * _wire_factor(kind, group)
        if not func.is_view:
            if packet not in _TEMPLATES:
                self.hbm_bytes += sum(_nbytes(t)
                                      for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    def summary(self) -> Dict[str, float]:
        """The reference's ``analyze_hlo`` keys, plus ``peak_bytes`` and
        ``kernel_read_bytes`` (the part of ``hbm_bytes`` that the
        hand-written kernels read)."""
        out = {"flops": float(self.flops),
               "hbm_bytes": float(self.hbm_bytes),
               "peak_bytes": float(self.peak),
               "coll_count": float(self.coll_count),
               "coll_total": float(sum(self.coll.values())),
               "coll_wire_total": float(self.coll_wire),
               "kernel_read_bytes": float(sum(self.kernel_reads.values()))}
        for kind in _KINDS:
            out["coll_" + kind] = float(self.coll.get(kind, 0.0))
        return out


def analyze_ops(fn: Callable, *args, base: int = 0) -> Dict[str, Any]:
    """Run ``fn(*args)`` under an ``OpCounter`` whose base is ``base``
    bytes (the inputs); returns (summary, fn's result)."""
    counter = OpCounter(base=base, inputs=_local(args))
    with counter:
        result = fn(*args)
    return counter.summary(), result


def _local(tree):
    """The local tensors of a tree that may hold DTensors."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]
