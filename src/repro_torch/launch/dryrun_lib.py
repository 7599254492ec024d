"""Dry-run builders and roofline analysis on the meta device.

Held against ``repro.launch.dryrun_lib``: ``DryRunRecord`` (the same
fields), ``build_train`` (with the reference's variants but the
activation ones, see below), ``build_prefill``, ``build_decode``,
``analyze``, ``_model_flops`` and ``run_pair``. For
every (architecture x input shape x mesh) it builds the port's step --
the LTFL federated train step for ``train_4k``, ``model.prefill`` for
``prefill_32k``, ``model.decode_step`` for the decode shapes -- on meta
tensors laid out as DTensors over a ``DeviceMesh`` of the fake process
group, runs rank 0's program once under ``launch.op_analysis.OpCounter``
(nothing is computed, allocated or sent) and derives the roofline terms
from what that device would run:

    compute    = FLOPs (per device)            / peak FLOP/s
    memory     = bytes moved (per device)      / HBM bandwidth
    collective = wire bytes (per device, ring) / link bandwidth

``HW`` holds the datasheet figures of the NVIDIA H100 SXM5 80GB (bf16
dense tensor-core peak, HBM3 bandwidth, memory, NVLink 4 bandwidth in
each direction); they are datasheet figures, not measurements.

What the port's steps do on a mesh. Parameters rest sharded by the rule
table and are pruned on their shards (``core.sharded_step``). Every
family computes on its 'model' shards (``models.tensor_parallel``):
the train step's clients sit on their mesh axes and each client's rows
split over the remaining dims but 'model' that divide them; prefill and
decode split the batch over its 'batch' axes and every other dim but
'model' that divides it, take no whole copy of a weight (``to_local``;
a weight also sharded over 'data' under fsdp is gathered over 'data'
only), and hold the decode cache as the rule table splits it (over kv
heads, or over head_dim where the head count does not divide; MLA's
latent cache whole; RWKV6's state over heads, its token-shift states as
the (B, D) stream; the hybrid's Mamba2 states over heads and its
convolution states over 'ssm_fused'). The residual stream follows the
rules' activation axes: over d_model by default, over the sequence
under ``{"act": "seq"}``, whole with 'act_embed' None; the
encoder-decoder's encoder stream is laid out from its own shape.

``compile_seconds`` is the wall time of the meta run (there is no
compilation). ``variant`` is a dict of overrides: {"prune": False},
{"agg": "int8"}, {"fsdp": True}, {"remat": False}, {"moe_group": 1024},
{"scan": 2}, ... as the reference's.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.core.ltfl_step import make_fl_train_step
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import (
    client_axes,
    fake_process_group,
    make_production_mesh,
    make_test_mesh,
    mesh_axes,
    mesh_name,
    mesh_size,
    num_clients,
)
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import build_model
from repro_torch.models.common import logical_rule_scope
from repro_torch.models.registry import (
    prefill_batch_struct,
    train_batch_struct,
)
from repro_torch.optim import sgd

# NVIDIA H100 SXM5 80GB datasheet figures (not measurements)
HW = {
    "peak_flops": 989e12,     # bf16 dense tensor-core FLOP/s
    "hbm_bw": 3.35e12,        # HBM3 bytes/s
    "link_bw": 450e9,         # NVLink 4 bytes/s in each direction
    "hbm_bytes": 80e9,        # device memory
}
SEED_BYTES = 8                # the step's integer round seed (int64)


@dataclass
class DryRunRecord:
    arch: str
    shape: str
    mesh: str
    mode: str
    n_clients: int
    variant: Dict[str, Any]
    # memory (per device)
    bytes_per_device: float
    fits_hbm: bool
    # compute / memory / collective raw
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_operand_bytes: float
    collective_wire_bytes: float
    collective_count: int
    # roofline terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops: float
    useful_ratio: float
    compile_seconds: float
    args_bytes: float = 0.0
    out_bytes: float = 0.0
    temp_bytes: float = 0.0
    alias_bytes: float = 0.0

    def to_dict(self):
        return asdict(self)


class Built:
    """A step ready to analyze: ``fn(*args)`` on meta inputs, the rules,
    the client count, and the bytes of its inputs one device holds
    (``args_bytes``; ``alias_bytes`` of them are donated params)."""

    def __init__(self, fn, args, rules, n_clients, args_bytes,
                 alias_bytes=0):
        self.fn, self.args, self.rules = fn, args, rules
        self.n_clients = n_clients
        self.args_bytes, self.alias_bytes = args_bytes, alias_bytes


def _apply_variant_rules(rules, variant):
    """The reference's perf-pass overrides: {"act": "seq"} moves the
    residual stream from d_model-sharding to sequence-parallel sharding,
    and {"rules_override": {...}} sets logical -> mesh entries. The
    activation layouts are those of the tensor-parallel path
    (``models.tensor_parallel``)."""
    override = variant.get("rules_override") or {}
    if "act" in variant:
        if variant["act"] != "seq":
            raise ValueError(f"variant act={variant['act']!r}: only "
                             "'seq' is a layout")
        rules["act_seq"] = ("model",)
        rules["act_embed"] = None
    for k, v in override.items():
        rules[k] = tuple(v) if isinstance(v, list) else v
    return rules


def _meta_input(shape, dtype, mesh, pl):
    """A DTensor of global ``shape`` laid out by placements ``pl`` whose
    local tensor is an empty meta tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(shape), mesh, pl)
    local = torch.empty(local_shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=shlib.contiguous_strides(tuple(shape)))


def _meta_tree(struct: Dict[str, torch.Tensor], shardings):
    return {k: _meta_input(v.shape, v.dtype, shardings[k].mesh,
                           shardings[k].placements)
            for k, v in struct.items()}


def build_train(arch: ArchConfig, shape: ShapeConfig, mesh,
                variant: Dict[str, Any],
                n_clients: Optional[int] = None) -> Built:
    """The LTFL federated train step over ``mesh``; ``n_clients``
    (default: the mesh's client count) must be a multiple of it."""
    model = build_model(arch, remat=bool(variant.get("remat", True)))
    multi_pod = "pod" in mesh_axes(mesh)
    pod_only = arch.fl_clients_on_pod_only
    fsdp = variant.get("fsdp", shlib.policy_for(arch)["fsdp"])
    rules = _apply_variant_rules(
        shlib.base_rules(mesh, fsdp=fsdp,
                         client_axes=client_axes(multi_pod, pod_only)),
        variant)
    n_clients = n_clients or num_clients(mesh, pod_only)
    if shape.global_batch % n_clients:
        raise ValueError(f"{shape.global_batch} rows on {n_clients} clients")
    per_client = shape.global_batch // n_clients
    params_abs = model.abstract_params()
    param_sh = shlib.param_shardings(mesh, model, rules)
    stacked_sh = shlib.stacked_shardings(mesh, model, rules, n_clients,
                                         "client")
    gather_sh = shlib.stacked_shardings(mesh, model, rules, n_clients, None)
    no_constraints = bool(variant.get("no_constraints"))
    step = make_fl_train_step(
        model, sgd(0.05), n_clients,
        prune_block=variant.get("prune_block", 128),
        quantize=variant.get("quant", True),
        prune=variant.get("prune", True),
        simulate_drops=variant.get("drops", True),
        int8_collective=variant.get("agg") == "int8",
        param_shardings=None if no_constraints else stacked_sh,
        gather_shardings=None if no_constraints else gather_sh)
    bs = train_batch_struct(arch, shape.global_batch, shape.seq_len)
    batch_abs = {k: torch.empty((n_clients, per_client) + v.shape[1:],
                                dtype=v.dtype, device="meta")
                 for k, v in bs.items()}
    batch_sh = {k: shlib.NamedSharding(mesh, shlib.make_pspec(
                    tuple(v.shape),
                    ("client", "batch") + (None,) * (v.dim() - 2),
                    rules, mesh)) for k, v in batch_abs.items()}
    if no_constraints:
        # the one-device step on whole tensors: every device's program
        params, batch = params_abs, batch_abs
        p_bytes = sum(v.numel() * v.element_size()
                      for v in params_abs.values())
        b_bytes = sum(v.numel() * v.element_size()
                      for v in batch_abs.values())
    else:
        params = _meta_tree(params_abs, param_sh)
        batch = _meta_tree(batch_abs, batch_sh)
        p_bytes = shlib.local_bytes(params_abs, param_sh)
        b_bytes = shlib.local_bytes(batch_abs, batch_sh)
    controls = {k: torch.empty((n_clients,), device="meta")
                for k in ("rho", "delta", "drop_prob", "weights")}
    c_bytes = sum(4 * n_clients for _ in controls) + SEED_BYTES
    scan_rounds = int(variant.get("scan") or 0)
    if scan_rounds:
        from repro_torch.fed.scan_engine import make_scanned_step
        scanned = make_scanned_step(step)
        batches = {k: _stack_rounds(v, scan_rounds)
                   for k, v in batch.items()}
        b_bytes *= scan_rounds
        c_bytes += SEED_BYTES * (scan_rounds - 1)

        def fn():
            with logical_rule_scope(rules, mesh):
                return scanned(params, (), (), batches, controls,
                               list(range(scan_rounds)))
    else:
        def fn():
            with logical_rule_scope(rules, mesh):
                return step(params, (), (), batch, controls, 0)
    return Built(fn, (), rules, n_clients, p_bytes + b_bytes + c_bytes,
                 alias_bytes=p_bytes)


def _stack_rounds(x, rounds: int):
    """A (R, ...) batch leaf: the round axis replicated."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x.expand((rounds,) + tuple(x.shape))
    local = x.to_local().expand((rounds,) + tuple(x.to_local().shape))
    pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
               for p in x.placements)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=torch.Size((rounds,) + tuple(x.shape)),
                              stride=(0,) + tuple(x.stride()))


def _serve_layout(mesh, rules, batch_size: int):
    """Placements of a (B, ...) inference input: B on the 'batch' axes,
    then on every other mesh dim but 'model' that divides what is left
    (tensor parallelism needs every row there)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = shlib.make_pspec((batch_size,), ("batch",), rules, mesh)
    pl = list(shlib.placements(spec, mesh))
    names = list(mesh_axes(mesh))
    sizes = list(mesh_axes(mesh).values())
    rows = batch_size
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            rows //= sizes[i]
    for i, p in enumerate(pl):
        if names[i] == "model":
            continue
        if isinstance(p, Replicate) and rows % sizes[i] == 0:
            pl[i] = Shard(0)
            rows //= sizes[i]
    return tuple(pl)


def _on_batch_dim(pl, dim: int):
    from torch.distributed.tensor import Shard
    return tuple(Shard(dim) if isinstance(p, Shard) else p for p in pl)


def _dtensor_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree.values())


def _inference_params(arch, mesh, variant):
    model = build_model(arch, remat=False)
    fsdp = variant.get("fsdp", shlib.policy_for(arch)["fsdp"])
    rules = _apply_variant_rules(shlib.base_rules(mesh, fsdp=fsdp), variant)
    if variant.get("cache_rules"):
        rules.update(variant["cache_rules"])
    params_abs = model.abstract_params()
    params = _meta_tree(params_abs, shlib.param_shardings(mesh, model,
                                                         rules))
    return model, rules, params


def _compute_params(mesh, params):
    """The weights one rank computes with: their 'model' shards (gathered
    over any other dim that shards them)."""
    out = {}
    for k, p in params.items():
        pl = shlib.model_placements(p.placements, mesh)
        out[k] = (p if tuple(p.placements) == pl
                  else p.redistribute(mesh, pl)).to_local()
    return out


def build_prefill(arch: ArchConfig, shape: ShapeConfig, mesh,
                  variant: Dict[str, Any]) -> Built:
    model, rules, params = _inference_params(arch, mesh, variant)
    pl = _serve_layout(mesh, rules, shape.global_batch)
    bs = prefill_batch_struct(arch, shape.global_batch, shape.seq_len)
    batch = {k: _meta_input(v.shape, v.dtype, mesh, pl)
             for k, v in bs.items()}

    def fn():
        with torch.inference_mode(), logical_rule_scope(rules, mesh):
            return model.prefill(_compute_params(mesh, params),
                                 {k: b.to_local() for k, b in batch.items()})

    return Built(fn, (), rules, 0,
                 _dtensor_bytes(params) + _dtensor_bytes(batch))


def build_decode(arch: ArchConfig, shape: ShapeConfig, mesh,
                 variant: Dict[str, Any]) -> Built:
    model, rules, params = _inference_params(arch, mesh, variant)
    B = shape.global_batch
    pl = _serve_layout(mesh, rules, B)
    cache_abs = model.abstract_cache(B, shape.seq_len)
    axes = model.cache_axes()
    csh = shlib.cache_shardings(mesh, rules, model, cache_abs)
    md = list(mesh_axes(mesh)).index("model")
    cache = {}
    for k, v in cache_abs.items():
        cpl = list(_on_batch_dim(pl, axes[k].index("batch")))
        cpl[md] = csh[k].placements[md]   # the rule table's over 'model'
        cache[k] = _meta_input(v.shape, v.dtype, mesh, tuple(cpl))
    tok = _meta_input((B,), torch.int32, mesh, pl)
    pos = _meta_input((B,), torch.int32, mesh, pl)

    def fn():
        with torch.inference_mode(), logical_rule_scope(rules, mesh):
            return model.decode_step(_compute_params(mesh, params),
                                     tok.to_local(), pos.to_local(),
                                     {k: c.to_local()
                                      for k, c in cache.items()})

    return Built(fn, (), rules, 0,
                 _dtensor_bytes(params) + _dtensor_bytes(cache)
                 + _dtensor_bytes({"t": tok, "p": pos}),
                 alias_bytes=_dtensor_bytes(cache))


# --------------------------------------------------------------------------- #
# analysis
# --------------------------------------------------------------------------- #
def _model_flops(arch: ArchConfig, shape: ShapeConfig, n_chips: int) -> float:
    """MODEL_FLOPS per device: 6 N D (train) / 2 N D (inference forward),
    N = active params, D = tokens processed globally."""
    n_active = arch.param_count(active_only=True)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_chips
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_chips
    return 2.0 * n_active * shape.global_batch / n_chips


def analyze(arch: ArchConfig, shape: ShapeConfig, mesh, counts: Dict,
            built: Built, variant: Dict[str, Any], seconds: float,
            out_bytes: float) -> DryRunRecord:
    n_chips = mesh_size(mesh)
    peak = counts["peak_bytes"]
    t_comp = counts["flops"] / HW["peak_flops"]
    t_mem = counts["hbm_bytes"] / HW["hbm_bw"]
    t_coll = counts["coll_wire_total"] / HW["link_bw"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    mflops = _model_flops(arch, shape, n_chips)
    flops = counts["flops"]
    return DryRunRecord(
        arch=arch.name, shape=shape.name, mesh=mesh_name(mesh),
        mode=shape.mode, n_clients=built.n_clients, variant=variant,
        bytes_per_device=peak, fits_hbm=peak <= HW["hbm_bytes"],
        flops_per_device=flops,
        hbm_bytes_per_device=counts["hbm_bytes"],
        collective_operand_bytes=counts["coll_total"],
        collective_wire_bytes=counts["coll_wire_total"],
        collective_count=int(counts["coll_count"]),
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=max(terms, key=terms.get),
        model_flops=mflops,
        useful_ratio=(mflops / flops) if flops else 0.0,
        compile_seconds=seconds,
        args_bytes=float(built.args_bytes), out_bytes=float(out_bytes),
        temp_bytes=float(max(peak - built.args_bytes, 0.0)),
        alias_bytes=float(built.alias_bytes))


def _out_bytes(result) -> float:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(result):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return float(total)


def measure(built: Built):
    """Run the built step once under an ``OpCounter``: (counts, result,
    seconds)."""
    from repro_torch.launch.op_analysis import _local
    from torch.utils._pytree import tree_leaves
    counter = OpCounter(base=built.args_bytes,
                        inputs=_local([x for x in tree_leaves(built.args)]))
    t0 = time.time()
    with counter:
        result = built.fn(*built.args)
    return counter.summary(), result, time.time() - t0


def run_pair(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             variant: Optional[Dict[str, Any]] = None,
             test_mesh: bool = False,
             out_dir: Optional[str] = None,
             verbose: bool = True) -> Optional[DryRunRecord]:
    """Build, run on meta and analyze one (arch, shape, mesh); None for
    the documented skips. Makes a fake process group of the mesh's size
    when none exists (and destroys it after)."""
    import torch.distributed as dist
    variant = dict(variant or {})
    shape = configs.get_shape(shape_name)
    arch = configs.arch_for_shape(configs.get_arch(arch_name), shape)
    ok, why = shape_applicable(arch, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch_name} x {shape_name}: {why}")
        return None
    owned = not dist.is_initialized()
    if owned:
        fake_process_group(8 if test_mesh else (512 if multi_pod else 256))
    from repro_torch.models import mamba2 as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rwkv_mod
    saved = (moe_mod.GROUP_SIZE, moe_mod.TOKEN_DISPATCH, rwkv_mod.CHUNK,
             mamba_mod.CHUNK)
    try:
        # the fake group's ranks stand for cards; its tensors are meta
        mesh = (make_test_mesh(multi_pod=multi_pod, device_type="cpu")
                if test_mesh else
                make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        if variant.get("moe_group") and arch.moe is not None:
            moe_mod.GROUP_SIZE = int(variant["moe_group"])
        if variant.get("moe_token") and arch.moe is not None:
            moe_mod.TOKEN_DISPATCH = variant["moe_token"]
        if variant.get("rwkv_chunk"):
            rwkv_mod.CHUNK = int(variant["rwkv_chunk"])
        if variant.get("mamba_chunk"):
            mamba_mod.CHUNK = int(variant["mamba_chunk"])
        builder = {"train": build_train, "prefill": build_prefill,
                   "decode": build_decode}[shape.mode]
        built = builder(arch, shape, mesh, variant)
        counts, result, seconds = measure(built)
        rec = analyze(arch, shape, mesh, counts, built, variant, seconds,
                      _out_bytes(result))
        del result
    finally:
        (moe_mod.GROUP_SIZE, moe_mod.TOKEN_DISPATCH, rwkv_mod.CHUNK,
         mamba_mod.CHUNK) = saved
        if owned:
            dist.destroy_process_group()
    if verbose:
        print(f"{arch_name:24s} {shape_name:12s} {rec.mesh:18s} "
              f"fits={rec.fits_hbm} mem={rec.bytes_per_device/1e9:7.2f}GB "
              f"tc={rec.t_compute*1e3:9.2f}ms tm={rec.t_memory*1e3:9.2f}ms "
              f"tx={rec.t_collective*1e3:9.2f}ms dom={rec.bottleneck} "
              f"useful={rec.useful_ratio:5.2f} run={rec.compile_seconds:.1f}s")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        vtag = "_".join(f"{k}-{v}" for k, v in sorted(variant.items())) \
            or "baseline"
        fn = f"{arch_name}__{shape_name}__{rec.mesh}__{vtag}.json"
        with open(os.path.join(out_dir, fn.replace('/', '-')), "w") as f:
            json.dump(rec.to_dict(), f, indent=2)
    return rec
