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
  algorithms (``_wire_factor``, the reference's verbatim). The step's
  own (DTensor redistributions, range and aggregate all-reduces) and the
  tensor-parallel model's (``models.tensor_parallel``: the all-reduces,
  all-gathers and reduce-scatters over 'model' of its forward and
  backward passes) are counted alike; ``coll_log`` lists each one
  (kind, output shape and dtype, group size, operand bytes) and the
  summary has a count per kind.

A recurrence over time (``models.common.time_scan``) on meta tensors is
not run step by step: the counter runs four of its steps and counts one
of them n - 3 times (``scan``), as the reference's HLO analysis counts a
``while`` body once times its trip count. The first step and the last
two run as they are (they differ from the others in the backward pass),
so the FLOPs, bytes and collectives equal the step-by-step run's; the
peak keeps the activations that the n - 4 steps not run would hold for
the backward pass.
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
        # how many times an op counts (n - 3 in a scan's step 1), and the
        # most live bytes since a scan's step 1 began its backward pass
        self.scale = 1
        self.region_peak = None
        # bytes counted beyond a storage's size (it stands for the steps
        # of a scan not run), and how many of them were given back
        self._extra: Dict[Any, int] = {}
        self._extra_freed = 0
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.live = self.peak = int(base)
        self.coll = defaultdict(float)
        self.coll_count = 0
        self.coll_kinds: Dict[str, int] = defaultdict(int)
        self.coll_wire = 0.0
        self.coll_log: list = []
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
        n = sum(_nbytes(t) for t in tensors) * self.scale
        self.kernel_reads[name] += n
        self.hbm_bytes += n

    def _release(self, key) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            self._extra_freed += self._extra.pop(key, 0)
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
        if self.region_peak is not None:
            self.region_peak = max(self.region_peak, self.live)

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
        s = self.scale
        if packet in self.registry:
            self.flops += s * int(self.registry[packet](*args, **kwargs,
                                                        out_val=out))
        ns = func._schema.name.split("::")
        if ns[0] == "_c10d_functional" and ns[-1] in _COLLECTIVES:
            kind = _COLLECTIVES[ns[-1]]
            operand = _nbytes(args[0])
            group = _group_size(func, args)
            self.coll[kind] += s * operand
            self.coll_count += s
            self.coll_kinds[kind] += s
            self.coll_wire += s * operand * _wire_factor(kind, group)
            self.coll_log.extend([{"kind": kind, "shape": tuple(out.shape),
                                   "dtype": out.dtype, "group": group,
                                   "bytes": operand}] * s)
        if not func.is_view:
            if packet not in _TEMPLATES:
                self.hbm_bytes += s * sum(_nbytes(t)
                                          for t in _tensors((args, kwargs)))
            self.hbm_bytes += s * sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    # ------------------------------------------------------------------ #
    # a recurrence over time, counted from four of its steps
    # ------------------------------------------------------------------ #
    def scan(self, step: Callable, carry, n: int):
        """``models.common.time_scan(step, carry, n)`` (n > 4) counted as
        the step-by-step run counts it, from steps 0, 1, n - 2 and n - 1
        with step 1 counted n - 3 times. Only the shapes are right: the
        steps run on meta tensors. Step 0 reads a carry without a
        gradient; step n - 1's carry has no consumer, so step n - 2's
        gradients are the first into the tensors that only the carry's
        gradient reaches (RWKV6's decay): the steps between are alike.

        Without autograd the steps write into one (n, ...) output, so the
        peak is the step-by-step run's. Under autograd each step keeps its
        output and activations for the backward pass: the storages that
        step 1 leaves live count n - 3 times, for as long as they live.
        The backward pass reaches the steps in the reverse of the order
        they were made (the engine runs the ready node made last first),
        so ``_Mark``s after steps 0 and 1 bracket step 1's backward
        nodes: they are counted n - 3 times, and what they leave live
        (under ``create_graph``, the graph of the gradients) is counted
        so as well. The stacked outputs come from ``_Stack``, whose
        backward hands each step its own slice of the gradient."""
        k = n - 3
        if not torch.is_grad_enabled():
            carry, y = step(carry, 0)
            out = y.new_empty((n,) + tuple(y.shape))
            out[0] = y
            with _Scale(self, k):
                carry, y = step(carry, 1)
                out[1] = y
            for t in (n - 2, n - 1):
                carry, y = step(carry, t)
                out[t] = y
            return carry, out
        at = {}

        def open_():
            # step 1's backward begins: the live bytes, and what the
            # storages that stand for several steps have given back
            self.scale = k
            at["live"] = self.region_peak = self.live
            at["freed"] = self._extra_freed

        def close():
            # step 1's backward ends: the n - 4 steps not run change the
            # live bytes as it did (less what its storages' weights gave
            # back), each with its transients above its start; what they
            # keep lives as long as step 1's storages
            self.scale = 1
            change = self.live - at["live"] + self._extra_freed - at["freed"]
            above = self.region_peak - at["live"]
            self.region_peak = None
            self.peak = max(self.peak, at["live"] + above
                            + max(0, (k - 1) * change))
            if change > 0:
                alive = [key for key in at["keys"] if key in self._refs]
                if alive:
                    self._weigh(max(alive, key=lambda x: self._refs[x][0]),
                                (k - 1) * change)
                else:
                    self.live += (k - 1) * change

        carry, y0 = step(carry, 0)
        carry, y0 = _Mark.apply(close, carry, y0)
        before = set(self._refs)
        with _Scale(self, k):
            carry, y1 = step(carry, 1)
            carry, y1 = _Mark.apply(open_, carry, y1)
        # the storages step 1 leaves live (its output, the carry, what it
        # keeps for the backward pass) stand for steps 1 .. n - 3
        at["keys"] = [key for key in self._refs if key not in before]
        for key in at["keys"]:
            self._weigh(key, (k - 1) * self._refs[key][0])
        self.peak = max(self.peak, self.live)
        carry, y2 = step(carry, n - 2)
        carry, y3 = step(carry, n - 1)
        return carry, _Stack.apply(n, y0, y1, y2, y3)

    def _weigh(self, key, extra: int) -> None:
        """Count ``extra`` more bytes for a live storage, for as long as
        it lives."""
        self._refs[key][0] += extra
        self._extra[key] = self._extra.get(key, 0) + extra
        self.live += extra

    def summary(self) -> Dict[str, float]:
        """The reference's ``analyze_hlo`` keys, plus ``peak_bytes``,
        ``kernel_read_bytes`` (the part of ``hbm_bytes`` that the
        hand-written kernels read) and ``count_<kind>`` per collective
        kind."""
        out = {"flops": float(self.flops),
               "hbm_bytes": float(self.hbm_bytes),
               "peak_bytes": float(self.peak),
               "coll_count": float(self.coll_count),
               "coll_total": float(sum(self.coll.values())),
               "coll_wire_total": float(self.coll_wire),
               "kernel_read_bytes": float(sum(self.kernel_reads.values()))}
        for kind in _KINDS:
            out["coll_" + kind] = float(self.coll.get(kind, 0.0))
            out["count_" + kind] = float(self.coll_kinds.get(kind, 0))
        return out


class _Scale:
    """``with _Scale(counter, k):`` every op counts k times."""

    def __init__(self, counter: OpCounter, k: int):
        self.counter, self.k = counter, k

    def __enter__(self):
        self.counter.scale = self.k

    def __exit__(self, *exc):
        self.counter.scale = 1
        return False


class _Mark(torch.autograd.Function):
    """The identity on a scan step's outputs (carry, y); its backward
    calls ``hook`` before it hands the gradients on, that is, after the
    backward of every later step and before this step's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(hook, carry, y):
        return carry.view_as(carry), y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hook = inputs[0]

    @staticmethod
    def backward(ctx, g_carry, g_y):
        ctx.hook()
        return None, g_carry, g_y


class _Stack(torch.autograd.Function):
    """The (n, ...) outputs of a scan counted from four steps: step 1's
    output stands for steps 1 .. n - 3; the backward hands each step its
    slice of the gradient, as the stacked n steps' does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(n, first, mid, second_last, last):
        # the stack of n outputs reads n of them (``stack`` is a ``cat`` of
        # their views): the middle one as an expanded view, not n - 3 views
        mids = mid[None].expand((n - 3,) + tuple(mid.shape))
        return torch.cat([first[None], mids, second_last[None], last[None]])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None, g[0], g[1], g[-2], g[-1]


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
