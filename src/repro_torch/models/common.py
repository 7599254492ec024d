"""Parameter specs and initialization, and the numerics shared by the
port's models.

Held against ``repro.models.common``: ``ParamSpec`` (shape, logical
sharding axes, init recipe, scale, dtype; bfloat16 unless a model asks
for another), the ``"normal"`` / ``"embed"`` / ``"uniform"`` /
``"ones"`` / ``"zeros"`` inits, ``abstract_params`` (meta tensors),
``logical_axes``, ``stack_specs``, ``param_count_tree``,
``logical_rule_scope``, ``shard_hint``, ``rms_norm``, ``layer_norm``,
``apply_norm``, ``norm_specs``, ``activation``, ``rope_tables``,
``apply_rope``, ``apply_rope_at`` and ``cross_entropy_loss``;
``time_scan`` stands in for the reference's ``lax.scan`` over time in
the recurrent families, ``unstack`` walks stacked layers and
``store_layer`` writes one layer of a stacked cache. ``remat`` is the
counterpart of ``jax.checkpoint(..., policy=nothing_saveable)``.
Parameter trees are flat ``Dict[str, Tensor]`` keyed by dotted paths in
the reference's leaf order (``models.convert``); ``logical_axes`` is a
flat dict under the same keys.

Logical axis vocabulary (``launch.sharding`` maps it onto a mesh):
layers, embed, embed_out, vocab, heads, heads_fused, kv_heads, kv_fused,
head_dim, kv_lora, d_ff, experts, expert_ff, ssm_fused, state, conv,
batch, seq, client, and the activation names act_seq, act_embed,
act_ff, act_expert_ff.

Initialization draws from an explicit ``torch.Generator``, leaf by leaf
in that order; it gives other numbers than the reference's jax keys for
the same seed, so tests carry weights across with ``models.convert``.
Each dtype cast of the reference is mirrored: norms compute in float32
and cast back, the rope tables are float32 and cast to the activations'
dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed | uniform
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # contraction dim convention: second-to-last (HWIO convs: cin;
    # matrices and layer stacks: the input width)
    return shape[-2]


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """One leaf from its recipe: draws in float32 on the generator's
    device, scales, casts to ``spec.dtype``, moves to ``device``."""
    device = generator.device if device is None else device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)

    def normal():
        return torch.randn(spec.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)

    # scaled in place: a stacked expert leaf at full width is ~5 G
    # elements, so a second float32 copy would cost ~19 GB
    if spec.init == "embed":
        x = normal().mul_(spec.scale)
    elif spec.init == "normal":
        x = normal().mul_(spec.scale / math.sqrt(max(_fan_in(spec.shape), 1)))
    elif spec.init == "uniform":
        x = torch.empty(spec.shape, device=generator.device,
                        dtype=torch.float32).uniform_(
            -spec.scale, spec.scale, generator=generator)
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    return x.to(spec.dtype).to(device)


def init_params(specs: Dict[str, ParamSpec], generator: torch.Generator,
                device: Optional[torch.device] = None) -> Tree:
    """Fresh parameters, drawn leaf by leaf in the specs' order."""
    return {name: init_leaf(spec, generator, device)
            for name, spec in specs.items()}


def abstract_params(specs: Dict[str, ParamSpec]) -> Tree:
    """Every leaf as a meta tensor of its shape and dtype (no storage):
    the counterpart of the reference's ``jax.ShapeDtypeStruct`` tree."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in specs.items()}


def logical_axes(specs: Dict[str, ParamSpec]
                 ) -> Dict[str, Tuple[Optional[str], ...]]:
    return {k: s.axes for k, s in specs.items()}


def stack_specs(n_layers: int, specs: Dict[str, ParamSpec]
                ) -> Dict[str, ParamSpec]:
    """Prepend a stacked 'layers' axis to every spec."""
    return {k: ParamSpec((n_layers,) + s.shape, ("layers",) + s.axes,
                         s.init, s.scale, s.dtype)
            for k, s in specs.items()}


def param_count_tree(specs: Dict[str, ParamSpec]) -> int:
    return int(sum(math.prod(s.shape) for s in specs.values()))


def subtree(tree: Dict, prefix: str) -> Dict:
    """The entries under ``prefix`` (e.g. ``"attn."``), prefix removed."""
    n = len(prefix)
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix)}


def prefixed(prefix: str, tree: Dict) -> Dict:
    """The entries of ``tree`` with ``prefix`` put before each name."""
    return {prefix + k: v for k, v in tree.items()}


def unstack(tree: Dict, prefix: str, n: int):
    """Per index i < n along the stacked leading axis of the entries under
    ``prefix``: {name: leaf[i]} (views; the reference's scanned layers)."""
    stacked = subtree(tree, prefix)
    for i in range(n):
        yield {k: v[i] for k, v in stacked.items()}


# --------------------------------------------------------------------------- #
# Common numerics
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Tree, prefix: str = ""
               ) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p[prefix + "gamma"], p[prefix + "beta"])
    return rms_norm(x, p[prefix + "gamma"])


def norm_specs(cfg, d: int) -> Dict[str, ParamSpec]:
    s = {"gamma": ParamSpec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        s["beta"] = ParamSpec((d,), ("embed",), "zeros")
    return s


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


def _rope_freqs(head_dim: int, theta: float,
                device: Optional[torch.device]) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    # torch.full, not torch.tensor: the latter detaches in place, which a
    # grad transform refuses on the meta device (the dry run)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), expo)


def rope_tables(seq_len: int, head_dim: int, theta: float, offset: int = 0,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding cos/sin tables of shape (seq_len, head_dim/2),
    computed in float32 as the reference does."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * _rope_freqs(head_dim, theta, device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope_at(x: torch.Tensor, pos: torch.Tensor, head_dim: int,
                  theta: float) -> torch.Tensor:
    """Rope for decode: x (batch, heads, head_dim), pos (batch,) int; the
    angles in float32, cast to x's dtype (``apply_rope`` with the batch
    in the place of the sequence)."""
    ang = pos.to(torch.float32)[:, None] \
        * _rope_freqs(head_dim, theta, x.device)[None, :]     # (B, half)
    return apply_rope(x, torch.cos(ang), torch.sin(ang))


def time_scan(step: Callable, carry, n: int):
    """The reference's ``lax.scan`` over time as a Python loop:
    ``step(carry, t) -> (carry, y_t)`` for t = 0 .. n - 1; returns
    (carry, ys (n, *y_t.shape)). Without autograd (prefill and decode run
    under ``torch.inference_mode()``) each y_t is written into one tensor
    allocated at the first step; under autograd (training, the datacenter
    step's ``grad`` and ``vmap``) the outputs are stacked at the end, the
    form both take. Either way the values are the same."""
    if torch.is_grad_enabled():
        ys = []
        for t in range(n):
            carry, y = step(carry, t)
            ys.append(y)
        return carry, torch.stack(ys)
    out = None
    for t in range(n):
        carry, y = step(carry, t)
        if out is None:
            out = y.new_empty((n,) + tuple(y.shape))
        out[t] = y
    return carry, out


def store_layer(cache: Tree, key: str, index, value: torch.Tensor,
                lead=None) -> None:
    """``cache[key][index] = value`` for one layer (``index`` an int, or
    (segment, layer)) of a stacked cache that a pass writes layer by
    layer, every layer. A missing leaf is allocated as (*lead,
    *value.shape) (``lead`` an int or a tuple: the stacked dims); a leaf
    of another dtype than ``value`` is replaced by a new one of
    ``value``'s dtype, as the reference's scan stacks its outputs in their
    own dtype (a decode step reads the layers from the cache it was given,
    so the old leaf is still read)."""
    if key not in cache:
        lead = (lead,) if isinstance(lead, int) else tuple(lead)
        cache[key] = value.new_empty(lead + tuple(value.shape))
    elif cache[key].dtype != value.dtype:
        cache[key] = torch.empty(cache[key].shape, dtype=value.dtype,
                                 device=cache[key].device)
    cache[key][index] = value


# --------------------------------------------------------------------------- #
# Activation sharding hints (resolved against the launcher's logical rules)
# --------------------------------------------------------------------------- #
_LOGICAL_RULES: Dict[str, Any] = {"rules": None, "mesh": None}


class logical_rule_scope:
    """Context manager that activates the activation-sharding hints:
    ``with logical_rule_scope(rules, mesh): ...``. ``rules`` maps a
    logical axis name to mesh axes (str / tuple / None); ``mesh`` is a
    ``DeviceMesh`` with dim names."""

    def __init__(self, rules, mesh):
        self.rules, self.mesh = rules, mesh

    def __enter__(self):
        self._saved = dict(_LOGICAL_RULES)
        _LOGICAL_RULES["rules"] = self.rules
        _LOGICAL_RULES["mesh"] = self.mesh
        return self

    def __exit__(self, *exc):
        _LOGICAL_RULES.update(self._saved)
        return False


def shard_hint(x: torch.Tensor, axes: Tuple[Optional[str], ...]
               ) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical ``axes``
    resolve to under the active rules (the reference's
    ``with_sharding_constraint``). The identity outside a
    ``logical_rule_scope`` and for a plain tensor, so the one-card paths
    and the step's local compute run unchanged."""
    rules, mesh = _LOGICAL_RULES["rules"], _LOGICAL_RULES["mesh"]
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import make_pspec, placements
    spec = make_pspec(tuple(x.shape), axes, rules, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


# --------------------------------------------------------------------------- #
# Rematerialization
# --------------------------------------------------------------------------- #
class _Remat(torch.autograd.Function):
    """``fn(*args)`` saving only its inputs; the backward recomputes the
    body and takes its vector-Jacobian product with ``torch.func.vjp``.
    ``torch.utils.checkpoint`` does not run under ``torch.func.grad``
    (saved-tensor hooks); this does, vmap included."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        with torch.no_grad():
            return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        # no_grad: torch.func.grad differentiates with create_graph, which
        # would keep every recomputed intermediate alive through the rest
        # of the backward pass; the gradients here need no graph (the
        # step takes first derivatives only)
        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            return (None,) + tuple(vjp_fn(cotangents))


def remat(body: Callable[..., Tuple[torch.Tensor, ...]], lp: Tree,
          *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``body(lp, *xs)`` (a tuple of tensors) whose intermediates are not
    kept for the backward pass but recomputed there: the reference's
    ``jax.checkpoint(body, policy=nothing_saveable)``. The layer's params
    dict is flattened to positional tensors for ``_Remat``; ``body``
    closes over no tensor."""
    keys = list(lp)

    def flat(*args):
        return body(dict(zip(keys, args[:len(keys)])), *args[len(keys):])

    return _Remat.apply(flat, *[lp[k] for k in keys], *xs)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32. logits (..., V), labels (...). The gold
    logit is gathered (the reference's one-hot contraction picks the same
    entry)."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)
