"""The LTFL round step over a ``DeviceMesh``: parameters sharded at rest
by the rule table, clients on their mesh axes.

Held against the reference's ``make_fl_train_step(param_shardings=,
gather_shardings=)`` (``repro.core.ltfl_step`` lines 67-69, 109-114,
151-154), which pins the stacked (C, ...) gradients to the parameters'
layout and the int8 levels to a client-replicated layout for their
all-gather. ``core.ltfl_step.make_fl_train_step`` builds this step when
it is given ``param_shardings``. Each rank runs the program below on its
own shards; the collectives are DTensor redistributions and functional
all-reduces over named mesh dims (NCCL on cards, gloo on CPU ranks, the
fake backend in a dry run).

The layout. ``param_shardings`` (one ``launch.sharding.NamedSharding``
per leaf, shaped like the stacked (C, ...) gradients) names the client
axes (the mesh dims of each spec's leading entry) and, for the rest of
each leaf, the parameters' own layout: the params come in as DTensors
placed that way.

Every language-model family (``tensor_parallel``, chosen by
``make_fl_train_step`` from the model's family) computes on its weight
shards (``models.tensor_parallel``): the forward and backward passes run
with each leaf's 'model' shard as it rests, and the collectives over
'model' are the model's own. An expert leaf (E, D, F) is split on its
leading dim, which cuts no tile; the router's (D, E) columns (64 / 16 =
4 a rank at full width) and deepseek's dense prefix (d_ff 10944 / 16 =
684) cut tiles of 32, and take the sub-tiles below. So

1. each leaf is pruned on its shards for the rank's C_l clients:
   ``block_norms`` runs on the shard at sub-tiles as wide as the shard
   holds (gcd of the shard's extent and the block; the whole tile where
   the shard holds whole tiles), the sub-tile norms of every shard are
   all-gathered and combined into whole-tile norms (the root of the sum
   of squares), ranked whole, and ``apply_block_mask`` writes the C_l
   pruned copies of the shard at the same sub-tiles. Those copies feed
   the forward pass as they are: no 'model'-sharded weight is gathered
   (a leaf also sharded over another non-client dim, as 'embed' over
   'data' under fsdp, is gathered over that dim only). A leaf pruned by
   magnitude gathers its importance |w| (float32) and ranks it whole;
   1-D leaves are exempt;
2. each client's batch rows are split over every non-client dim but
   'model' whose size divides them;
3. per-client losses and gradients come from ``vmap(grad_and_value)``
   under the tensor-parallel context, so the gradients leave it in the
   'model' layout of the parameters; they are averaged over the
   row-splitting dims (and reduce-scattered over a further shard dim
   such as fsdp's) and gated by the shard's slice of the mask;
4. and 5. as below.

On a 'model' dim of one rank the model computes as on one device, and
the step is bitwise the unsharded step.

The whole-weight path (``tensor_parallel`` False: the edge models,
and any model when asked, as the tests and ``chip_smoke.py`` ask for the
path the tensor-parallel one is held against) computes the clients'
gradients with whole weights, so

1. each leaf is pruned on its shards for the rank's C_l = C / |client
   axes| clients: ``block_norms`` runs on the rank's shard, the tile
   norms of every shard are all-gathered (a tile never straddles two
   shards) and ranked whole, ``apply_block_mask`` writes the C_l pruned
   copies of the shard, and those are all-gathered over the leaf's shard
   dims into the C_l pruned leaves that the rank computes with. A leaf
   sharded over a client dim is first gathered over it; a leaf whose
   shards would cut a tile, or that is not pruned by tiles, is gathered
   whole and pruned whole, as in the unsharded step;
2. each client's batch rows are split further over every other mesh dim
   whose size divides them (a local chunk, no communication); dims that
   do not divide compute the rows again;
3. per-client losses and gradients come from ``vmap(grad_and_value)``
   on those rows, averaged over the row-splitting dims and laid out as
   ``param_shardings`` in one redistribution (reduce-scatter where the
   parameter is sharded, all-reduce where it is not), then gated by the
   masks (``apply_block_mask`` on the shards; a leaf pruned whole is
   gated whole before the redistribution);
4. the quantizer (the compressor's own ``compress``) runs on each
   rank's (C_l, shard) rows with every client's [lo, hi] all-reduced
   over the leaf's shards first, so the levels are those of the whole
   leaf; the int8 wire format takes its scale from the all-reduced
   max|g| and its levels are redistributed to ``gather_shardings`` (the
   client axis replicated): the all-gather of one byte a coordinate;
5. the sample-weighted aggregate (``aggregation.aggregate``, Eq. 19)
   sums the local clients and all-reduces over the client axes (under
   int8 every rank already holds every client's levels and sums them
   locally), and the optimizer updates each rank's shard.

The range sums, the aggregate and the norm are the shared functions,
given the all-reduces as hooks.

Uniforms: an injected source (``ltfl_quantizer(uniforms=)``,
``int8_uniforms``) gives every client's full leaf and each rank takes
its shard of it, so the step equals the unsharded one draw for draw;
otherwise each rank draws its own (C_l, shard) rows from the round seed
plus ``SHARD_STREAM`` times its rank (rank 0 draws the unsharded step's
stream, so on one device the two are the same program). The drop draw
is the unsharded step's, on every rank.

On a mesh of one device every collective is over a group of one and
the step computes exactly what the unsharded step does, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.core.aggregation import aggregate
from repro_torch.core.compressors import (
    lane_uniforms,
    ltfl_quantizer,
    torch_uniforms,
)
from repro_torch.core.pruning import block_importance, gate_pytree, tileable
from repro_torch.core.quantization import (
    dequantize_int8,
    quantize_int8_clients,
    range_sq_sum,
)
from repro_torch.kernels import ops
from repro_torch.kernels.block_prune import apply_block_mask, block_norms
from repro_torch.models import tensor_parallel as tp
from repro_torch.launch.sharding import (
    contiguous_strides,
    local_index,
    local_slice,
    model_placements,
)
from repro_torch.optim import apply_updates, global_norm

Tree = Dict[str, torch.Tensor]
SHARD_STREAM = 1 << 40


def all_reduce(t: torch.Tensor, op: str, mesh, dims: List[int]
               ) -> torch.Tensor:
    """``t`` reduced with ``op`` ("sum" / "min" / "max") over each of the
    mesh dims ``dims`` in turn."""
    for d in dims:
        t = funcol.all_reduce(t, op, (mesh, d))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class Layout:
    """The step's view of the mesh: client dims, this rank's clients, and
    per leaf the mesh dims its (non-client) shards lie on."""

    def __init__(self, param_shardings: Dict[str, Any], n_clients: int):
        from repro_torch.launch.mesh import mesh_axes
        first = next(iter(param_shardings.values()))
        self.mesh = first.mesh
        self.names = list(mesh_axes(self.mesh))
        self.sizes = [mesh_axes(self.mesh)[a] for a in self.names]
        lead = _client_axes(first)
        self.client_dims = [self.names.index(a) for a in lead]
        for k, s in param_shardings.items():
            sl = _client_axes(s)
            if sl != lead:
                raise ValueError(f"{k}: client axes {sl} differ from "
                                 f"{lead}")
        groups = math.prod(self.sizes[d] for d in self.client_dims)
        if n_clients % groups:
            raise ValueError(f"{n_clients} clients on {groups} groups")
        self.n_clients = n_clients
        self.c_local = n_clients // groups
        coord = self.mesh.get_coordinate()
        block = 0
        for d in self.client_dims:
            block = block * self.sizes[d] + coord[d]
        self.c0 = block * self.c_local
        self.rank = 0
        for d, n in enumerate(self.sizes):
            self.rank = self.rank * n + coord[d]
        self.shardings = param_shardings
        self.model_dim = (self.names.index("model") if "model" in self.names
                          else None)

    @property
    def rows(self) -> slice:
        """This rank's clients among the C."""
        return slice(self.c0, self.c0 + self.c_local)

    def clients(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rows]

    def shard_dims(self, name: str) -> List[int]:
        """Mesh dims (not client dims) that shard leaf ``name``."""
        from torch.distributed.tensor import Shard
        return [i for i, p in enumerate(self.shardings[name].placements)
                if isinstance(p, Shard) and i not in self.client_dims]

    def placements(self, row_dims=()):
        """Client dims Shard(0); ``row_dims`` Partial (sum); the rest
        Replicate."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        return tuple(Shard(0) if i in self.client_dims
                     else Partial() if i in row_dims
                     else Replicate() for i in range(len(self.names)))

    def gather_clients(self, local: torch.Tensor, row_dims=(),
                       n_row: int = 1) -> torch.Tensor:
        """Every client's value from this rank's (C_l, ...) slice; with
        ``row_dims`` each rank holds a partial value and the result is
        the mean over them."""
        from torch.distributed.tensor import DTensor
        if n_row > 1:
            local = local / n_row
        shape = (self.n_clients,) + tuple(local.shape[1:])
        d = DTensor.from_local(
            local, self.mesh, self.placements(row_dims),
            run_check=False, shape=torch.Size(shape),
            stride=contiguous_strides(shape))
        return d.full_tensor()

    def reduce_range(self, name: str, lo: torch.Tensor, hi: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each client's [lo, hi] of a shard over the whole leaf."""
        dims = self.shard_dims(name)
        return (all_reduce(lo, "min", self.mesh, dims),
                all_reduce(hi, "max", self.mesh, dims))


def _client_axes(sharding) -> tuple:
    """The mesh axes of a stacked sharding's leading (client) dim."""
    entry = sharding.spec[0] if sharding.spec else None
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _tile_index(shape, mesh, placements, block: int, lead: int = 0):
    """This rank's slice of the tile grid of a tensor of global ``shape``
    laid out by ``placements`` (the first ``lead`` dims whole), or None
    when a shard boundary cuts a tile of the last two dims."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    n = len(shape)
    idx = [slice(None)] * lead
    for d in range(lead, n):
        o, size = offset[d], local[d]
        if d >= n - 2:
            if o % block or size % block:
                return None
            o, size = o // block, size // block
        idx.append(slice(o, o + size))
    return tuple(idx)


def _sub_block(local_shape, block: int) -> Tuple[int, int]:
    """The sub-tile a shard of ``local_shape`` holds whole: in each of the
    last two dims the gcd of the shard's extent and the block."""
    return (math.gcd(local_shape[-2], block),
            math.gcd(local_shape[-1], block))


def make_sharded_step(*, model_loss_grad: Callable, optimizer, n_clients: int,
                      comp, prune: Callable, prune_kind: str,
                      prune_block: int, do_prune: bool, int8_wire: bool,
                      int8_uniforms, alpha_fn: Callable,
                      param_shardings: Dict[str, Any],
                      gather_shardings: Optional[Dict[str, Any]],
                      tensor_parallel: bool = False) -> Callable:
    """The step over the mesh of ``param_shardings`` (see the module
    docstring); the arguments are ``make_fl_train_step``'s pieces, and
    ``tensor_parallel`` picks the path on weight shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.func import vmap

    if comp.name not in ("ltfl", "none"):
        raise NotImplementedError(
            f"the sharded step runs the ltfl quantizer or none, not "
            f"{comp.name!r}")
    lay = Layout(param_shardings, n_clients)
    mesh = lay.mesh
    block = prune_block

    def shard_uniforms(names, shapes, device, source):
        """A uniform source of this rank's (C_l, shard) rows: the
        injected ``source``'s draw of every client's whole leaf, sliced,
        or the port's own draw from the round seed offset by the rank."""
        def draw(seed, n, local_shapes):
            if source is not None:
                full = source(seed, n_clients,
                              [shapes[k][1:] for k in names])
                return (local_slice(r.to(device), lay.shardings[k])
                        .contiguous() for k, r in zip(names, full))
            if not isinstance(seed, torch.Generator):
                seed = int(seed) + SHARD_STREAM * lay.rank
            return torch_uniforms(seed, n, local_shapes, device)
        return draw

    def prune_shards(params: Dict[str, Any], rho: torch.Tensor):
        """Per leaf, this rank's C_l pruned whole leaves and the mask;
        ``tiled`` names the leaves pruned on their shards, whose masks
        are their whole tile grids."""
        pruned, masks, tiled = {}, {}, set()
        for k, p in params.items():
            # the leaf laid out over its non-client dims only
            pl = tuple(Replicate() if i in lay.client_dims else q
                       for i, q in enumerate(p.placements))
            idx = (_tile_index(p.shape, mesh, pl, block)
                   if prune_kind == "block" and tileable(p, block)
                   else None)
            if idx is None:
                pr, m = prune({k: p.full_tensor()}, rho)
                pruned[k], masks[k] = pr[k], m[k]
                continue
            w = (p if tuple(p.placements) == pl
                 else p.redistribute(mesh, pl)).to_local()
            norms = block_importance(w, block)                # B2
            grid = tuple(p.shape[:-2]) + (p.shape[-2] // block,
                                          p.shape[-1] // block)
            norms = DTensor.from_local(
                norms, mesh, pl, run_check=False, shape=torch.Size(grid),
                stride=contiguous_strides(grid)).full_tensor()
            mask = ops.rank_mask(norms, rho)                 # (C_l, *grid)
            del norms
            part = mask[(slice(None),) + idx].contiguous()
            c = part.shape[0]
            shard = apply_block_mask(                         # B3
                w.reshape(-1, w.shape[-1]).contiguous(),
                part.reshape(c, -1, part.shape[-1]), (block, block)
            ).reshape((c,) + tuple(w.shape))
            del w, part
            held = tuple(Shard(0) if i in lay.client_dims
                         else Shard(q.dim + 1) if isinstance(q, Shard)
                         else q for i, q in enumerate(pl))
            if held != lay.placements():
                shape = (n_clients,) + tuple(p.shape)
                shard = DTensor.from_local(
                    shard, mesh, held, run_check=False,
                    shape=torch.Size(shape),
                    stride=contiguous_strides(shape)
                ).redistribute(mesh, lay.placements()).to_local()
            pruned[k], masks[k] = shard, mask
            tiled.add(k)
        return pruned, masks, tiled

    def compute_layout(p) -> tuple:
        """Placements of the (C, ...) stack a rank computes with: clients
        on their dims, the leaf's 'model' shard kept, the rest whole."""
        md = lay.model_dim
        return tuple(
            Shard(0) if i in lay.client_dims
            else Shard(q.dim + 1) if (i == md and isinstance(q, Shard))
            else Replicate() for i, q in enumerate(p.placements))

    def prune_tp(params: Dict[str, Any], rho: torch.Tensor):
        """Per leaf, this rank's C_l pruned shards in ``compute_layout``
        and its gate: (mask over the whole leaf, sub-tile) for a tiled
        leaf, (element mask, None) for one pruned by magnitude, None for
        an exempt one."""
        pruned, gates = {}, {}
        for k, p in params.items():
            pl = tuple(Replicate() if i in lay.client_dims else q
                       for i, q in enumerate(p.placements))
            w = (p if tuple(p.placements) == pl
                 else p.redistribute(mesh, pl)).to_local()
            held = tuple(Shard(0) if i in lay.client_dims
                         else Shard(q.dim + 1) if isinstance(q, Shard)
                         else q for i, q in enumerate(pl))
            if p.dim() < 2:                                  # exempt
                pruned[k] = p.redistribute(
                    mesh, model_placements(p.placements, mesh)).to_local()
                gates[k] = None
                continue
            if prune_kind == "block" and tileable(p, block):
                sub = _sub_block(w.shape, block)
                grid = tuple(p.shape[:-2]) + (p.shape[-2] // sub[0],
                                              p.shape[-1] // sub[1])
                norms = block_norms(                          # B2
                    w.reshape(-1, w.shape[-1]).contiguous(), sub)
                norms = DTensor.from_local(
                    norms.reshape(tuple(w.shape[:-2]) + (
                        w.shape[-2] // sub[0], w.shape[-1] // sub[1])),
                    mesh, pl, run_check=False, shape=torch.Size(grid),
                    stride=contiguous_strides(grid)).full_tensor()
                r, c_ = block // sub[0], block // sub[1]
                if (r, c_) != (1, 1):                # sub-tiles to tiles
                    norms = torch.sqrt(torch.sum(torch.square(
                        norms.reshape(grid[:-2] + (grid[-2] // r, r,
                                                   grid[-1] // c_, c_))),
                        dim=(-3, -1)))
                mask = ops.rank_mask(norms, rho)       # (C_l, *tile grid)
                del norms
                if (r, c_) != (1, 1):
                    mask = mask.repeat_interleave(r, -2) \
                        .repeat_interleave(c_, -1)
                part = mask[(slice(None),) + local_index(grid, mesh, pl)]
                n = part.shape[0]
                shard = apply_block_mask(                     # B3
                    w.reshape(-1, w.shape[-1]).contiguous(),
                    part.contiguous().reshape(n, -1, part.shape[-1]), sub
                ).reshape((n,) + tuple(w.shape))
                gates[k] = (mask, sub)
            else:                                      # by magnitude
                imp = w.to(torch.float32).abs()
                if any(isinstance(q, Shard) for q in pl):
                    imp = DTensor.from_local(
                        imp, mesh, pl, run_check=False, shape=p.shape,
                        stride=contiguous_strides(tuple(p.shape))
                    ).full_tensor()
                mask = ops.rank_mask(imp, rho)              # (C_l, *leaf)
                del imp
                part = mask[(slice(None),) + local_index(p.shape, mesh, pl)]
                shard = w * part.to(w.dtype)
                gates[k] = (mask, None)
            del w
            want = compute_layout(p)
            if held != want:
                shape = (n_clients,) + tuple(p.shape)
                shard = DTensor.from_local(
                    shard, mesh, held, run_check=False,
                    shape=torch.Size(shape),
                    stride=contiguous_strides(shape)
                ).redistribute(mesh, want).to_local()
            pruned[k] = shard
        return pruned, gates

    def tp_gate(k: str, g: torch.Tensor, gate) -> torch.Tensor:
        """The gradient shard ``g`` (C_l, ...) in the parameter layout
        times its slice of the mask."""
        mask, sub = gate
        place = lay.shardings[k].placements
        shape = (n_clients,) + tuple(mask.shape[1:])
        part = mask[local_index(shape, mesh, place, lead=1)].contiguous()
        if sub is None:
            return g * part.to(g.dtype)
        c = g.shape[0]
        return apply_block_mask(g.reshape(c, -1, g.shape[-1]).contiguous(),
                                part.reshape(c, -1, part.shape[-1]), sub
                                ).reshape(g.shape)

    def tp_step(params, batch, controls, shapes_of):
        """Steps 1-3 on weight shards: the gated gradient shards in the
        parameter layout, the losses and the row-splitting dims."""
        if do_prune:
            pruned, gates = prune_tp(params, lay.clients(controls["rho"]))
        else:
            pruned = {k: p.redistribute(
                mesh, model_placements(p.placements, mesh)).to_local()
                for k, p in params.items()}
            gates = {k: None for k in params}
        in_dims = {k: 0 if v.dim() > params[k].dim() else None
                   for k, v in pruned.items()}
        rows, row_dims = _local_rows(batch, lay, keep=lay.model_dim)
        n_row = math.prod(lay.sizes[d] for d in row_dims)
        outer = tp.current()
        ctx = (outer if outer is not None and outer.mesh is mesh
               else tp.context_for(mesh))
        with tp.scope(ctx):
            grads, losses = vmap(model_loss_grad, in_dims=(in_dims, 0))(
                pruned, rows)
        del pruned, rows
        local = {}
        for k in list(grads):
            g = grads.pop(k)
            if n_row > 1:
                g = g / n_row
            have = tuple(Partial() if i in row_dims else q
                         for i, q in enumerate(compute_layout(params[k])))
            want = lay.shardings[k].placements
            if have != tuple(want):
                g = DTensor.from_local(
                    g, mesh, have, run_check=False,
                    shape=torch.Size(shapes_of[k]),
                    stride=contiguous_strides(shapes_of[k])
                ).redistribute(mesh, want).to_local()
            if gates[k] is not None:
                g = tp_gate(k, g, gates[k])
            local[k] = g
            del g
        return local, losses, row_dims, n_row

    def step(params: Dict[str, Any], opt_state, comp_state,
             batch: Dict[str, Any], controls: Dict[str, torch.Tensor],
             seed):
        shapes_of = {}
        for k, p in params.items():
            if not isinstance(p, DTensor):
                raise TypeError(f"{k}: the sharded step takes DTensor "
                                "params (launch.sharding.distribute)")
            shapes_of[k] = (n_clients,) + tuple(p.shape)
        if tensor_parallel:
            local, losses, row_dims, n_row = tp_step(params, batch, controls,
                                                     shapes_of)
        else:
            local, losses, row_dims, n_row = whole_step(params, batch,
                                                        controls, shapes_of)
        losses = lay.gather_clients(losses, row_dims, n_row)
        rsq = lay.gather_clients(range_sq_sum(
            local, client_axis=True, reduce_range=lay.reduce_range,
            sizes={k: math.prod(s[1:]) for k, s in shapes_of.items()}))

        # 4. the quantizer (or the int8 wire format) on the shards
        alpha = alpha_fn(controls, seed, losses.device)
        device = losses.device
        names = list(local)
        if int8_wire:
            rands = lane_uniforms(
                seed, lay.c_local, [tuple(local[k].shape[1:]) for k in names],
                device, shard_uniforms(names, shapes_of, device,
                                       int8_uniforms))
            agg, agg_layout = _int8_aggregate(
                local, lay, gather_shardings, rands, controls, alpha,
                shapes_of)
        else:
            if comp.name == "ltfl":
                quant = ltfl_quantizer(uniforms=shard_uniforms(
                    names, shapes_of, device, comp.uniforms))
                local, _ = quant.compress(
                    local, lay.clients(controls["delta"]), seed, (),
                    reduce_range=lay.reduce_range)
            agg = aggregate(
                local, controls["weights"], alpha,
                denom=controls.get("agg_denom"), rows=lay.rows,
                reduce_sum=lambda t: all_reduce(t, "sum", mesh,
                                                lay.client_dims))
            agg_layout = {k: lay.shardings[k].placements for k in agg}
        del local
        agg = {k: _to_param_layout(g, agg_layout[k], lay, params[k])
               for k, g in agg.items()}
        agg = comp.server_transform(agg)

        # 5. the update on each rank's shards
        p_loc = {k: p.to_local() for k, p in params.items()}
        lr = controls.get("lr")
        if lr is None:
            updates, opt_state = optimizer.update(agg, opt_state, p_loc)
        elif optimizer.update_with_lr is None:
            raise ValueError("controls['lr'] needs an optimizer with "
                             "update_with_lr")
        else:
            updates, opt_state = optimizer.update_with_lr(
                agg, opt_state, p_loc, lr)
        new = apply_updates(p_loc, updates)
        out = {k: DTensor.from_local(new[k], mesh, params[k].placements,
                                     run_check=False, shape=params[k].shape,
                                     stride=params[k].stride())
               for k in params}

        def norm_sum(name, s):
            dims = [i for i, q in enumerate(params[name].placements)
                    if isinstance(q, Shard)]
            return all_reduce(s, "sum", mesh, dims)

        metrics = {
            "loss": torch.mean(losses),
            "grad_norm": global_norm(agg, reduce_sum=norm_sum),
            "clients_received": torch.sum(alpha),
            "range_sq": rsq,
            "range_sq_mean": torch.mean(rsq),
        }
        return out, opt_state, comp_state, metrics

    def whole_step(params, batch, controls, shapes_of):
        """Steps 1-3 with whole weights."""
        # 1. this rank's clients' pruned leaves
        if do_prune:
            pruned, masks, tiled = prune_shards(
                params, lay.clients(controls["rho"]))
        else:
            pruned = {k: p.full_tensor() for k, p in params.items()}
            masks, tiled = None, set()
        in_dims = {k: 0 if v.dim() > params[k].dim() else None
                   for k, v in pruned.items()}
        # 2. this rank's rows of its clients' batches
        rows, row_dims = _local_rows(batch, lay)
        n_row = math.prod(lay.sizes[d] for d in row_dims)
        # 3. gradients averaged over the rows, laid out by leaf, gated
        with tp.scope(None):
            grads, losses = vmap(model_loss_grad, in_dims=(in_dims, 0))(
                pruned, rows)
        del pruned, rows
        part = lay.placements(row_dims)
        local = {}
        for k in list(grads):
            g = grads.pop(k)
            shard_gate = None
            if k in tiled:
                idx = _tile_index(shapes_of[k], mesh,
                                  lay.shardings[k].placements, block, lead=1)
                if idx is not None:
                    shard_gate = masks[k][idx].contiguous()
            if do_prune and shard_gate is None:
                g = gate_pytree({k: g}, {k: masks[k]}, block)[k]
            if n_row > 1:
                g = g / n_row
            d = DTensor.from_local(g, mesh, part, run_check=False,
                                   shape=torch.Size(shapes_of[k]),
                                   stride=contiguous_strides(shapes_of[k]))
            g = d.redistribute(mesh, lay.shardings[k].placements).to_local()
            del d
            if shard_gate is not None:
                g = gate_pytree({k: g}, {k: shard_gate}, block)[k]
            local[k] = g
            del g, shard_gate
        del masks
        return local, losses, row_dims, n_row

    step.layout = lay
    return step


def _local_rows(batch: Dict[str, Any], lay: Layout,
                keep: Optional[int] = None):
    """This rank's (C_l, B_l, ...) rows of every batch leaf, and the mesh
    dims that split the rows (the batch's own and those added here);
    mesh dim ``keep`` (the tensor-parallel 'model' dim) holds every row."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first = next(iter(batch.values()))
    if not isinstance(first, DTensor):
        raise TypeError("the sharded step takes a DTensor batch "
                        "(launch.sharding.distribute)")
    pl = list(first.placements)
    for i, p in enumerate(pl):
        if (i in lay.client_dims) != (isinstance(p, Shard) and p.dim == 0):
            raise ValueError(f"batch placements {tuple(pl)}: the client "
                             f"dim must be Shard(0) on mesh dims "
                             f"{lay.client_dims} exactly")
    if keep is not None:
        pl[keep] = Replicate()
    n_rows = first.shape[1] if first.dim() > 1 else 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            n_rows //= lay.sizes[i]
    for i, p in enumerate(pl):
        if i != keep and isinstance(p, Replicate) \
                and n_rows % lay.sizes[i] == 0:
            pl[i] = Shard(1)
            n_rows //= lay.sizes[i]
    row_dims = [i for i, p in enumerate(pl)
                if isinstance(p, Shard) and p.dim == 1]
    out = {}
    for k, b in batch.items():
        if tuple(b.placements) != tuple(first.placements):
            raise ValueError(f"batch leaf {k} is laid out unlike the rest")
        out[k] = b.redistribute(b.device_mesh, pl).to_local()
    return out, row_dims


def _int8_aggregate(local: Tree, lay: Layout, gather_shardings, rands,
                    controls, alpha, shapes) -> Tree:
    """The int8 wire format: levels at each client's whole-leaf scale,
    all-gathered over the client axes (``gather_shardings``), dequantized
    to bfloat16 and aggregated on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    device = next(iter(local.values())).device
    deq, layout = {}, {}
    for (k, x), r in zip(local.items(), rands):
        dims = lay.shard_dims(k)
        levels, scales = quantize_int8_clients(
            x, r.to(device),
            reduce_max=lambda m, dims=dims: all_reduce(m, "max", lay.mesh,
                                                       dims))
        del r
        src = lay.shardings[k].placements
        dst = (gather_shardings[k].placements if gather_shardings
               else tuple(Replicate() if i in lay.client_dims else p
                          for i, p in enumerate(src)))
        lv = DTensor.from_local(levels, lay.mesh, src, run_check=False,
                                shape=torch.Size(shapes[k]),
                                stride=contiguous_strides(shapes[k]))
        levels = lv.redistribute(lay.mesh, dst).to_local()
        layout[k] = dst
        scales = lay.gather_clients(scales)
        view = (scales.shape[0],) + (1,) * (levels.dim() - 1)
        deq[k] = dequantize_int8(levels, scales.reshape(view))
    return aggregate(deq, controls["weights"], alpha,
                     denom=controls.get("agg_denom")), layout


def _to_param_layout(agg: torch.Tensor, stacked, lay: Layout, param
                     ) -> torch.Tensor:
    """The aggregate's local shard (laid out as the stacked placements
    ``stacked`` without their client dim) in the parameter's layout:
    itself when the two agree, else redistributed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    have = tuple(Replicate() if i in lay.client_dims
                 else Shard(p.dim - 1) if isinstance(p, Shard) else p
                 for i, p in enumerate(stacked))
    if have == tuple(param.placements):
        return agg
    d = DTensor.from_local(agg, lay.mesh, have, run_check=False,
                           shape=param.shape, stride=param.stride())
    return d.redistribute(lay.mesh, param.placements).to_local()
