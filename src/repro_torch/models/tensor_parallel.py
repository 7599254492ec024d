"""Tensor parallelism on the 'model' mesh dim for every language-model
family (``FAMILIES``): the dense, MoE and VLM decoders, RWKV6, the
Mamba2 hybrid and the encoder-decoder.

Makes concrete what the reference leaves to GSPMD. Its rule table
(``repro.launch.sharding`` lines 38-91) puts every dense weight dim --
vocab, heads_fused, kv_fused, head_dim, d_ff -- and the experts on
'model', and XLA partitions ``repro.models.layers``, ``.moe``, ``.mla``
and ``.transformer`` over those shards. Here each rank computes on plain
local tensors, and the collectives are explicit:

* a column-parallel projection (wq, wk, wv and their biases, wi,
  wi_gate, wi_up, the vocab-parallel lm_head) reads the replicated
  activation through ``copy_in`` (the identity, whose gradient is
  all-reduced) and yields the rank's slice of the output features;
* a row-parallel projection (the attention and MLP ``wo``) ends in
  ``reduce_out`` (an all-reduce, whose gradient passes as it is);
* a projection whose fused dim cuts a head (granite's kv_fused 1024 / 16
  = 64 of a 128-wide head, qwen's 40 heads over 16) is gathered whole.
  Where the rank's q heads are whole it attends them against the kv
  heads they use (``gather_sum``: the other ranks' gradients summed
  back); otherwise everything is gathered (``gather``: the gradient is
  the rank's slice), attended whole and ``split`` before ``wo``. This is
  the reference's choice in ``make_pspec`` ("the per-head activation
  stays replicated while the fused ... projections ... do shard",
  ``sharding.py`` lines 7-10);
* the vocab-parallel embedding looks up the rank's rows, where other ids
  give zero, and all-reduces; the loss is the vocab-parallel
  cross-entropy, with the max, the sum of exps and the target logit
  all-reduced;
* the residual stream between blocks is laid out as the rules say
  (make_pspec of ('act_seq', 'act_embed') on its global shape): split
  over d_model (the reference's baseline, 'act_embed' on 'model'), over
  the sequence ({"act": "seq"}) or not at all ('act_embed' None). A
  split stream is gathered for each block (``gather_sum``: the gradient
  is reduce-scattered; after the norm when split over the sequence,
  before it when split over d_model) and each block's output is
  reduce-scattered into it (``scatter_sum``: the gradient is
  all-gathered); an unsplit one enters through ``copy_in`` after the
  norm and leaves through ``reduce_out``. Where a norm's gradient is a
  part (on a sequence shard, or feeding the rank's columns from a
  gathered stream) its scales pass ``copy_in``. A (B, D) decode
  activation has no sequence dim and is split over d_model only. 'act_ff'
  None makes the MLP's hidden activation whole before ``wo``.

The MoE FFN (``models.moe``) keeps the experts whole and splits them
over 'model' (``experts``: the leading dim of w_gate / w_up / w_in /
w_down, and the router's columns; ``expert_range`` reads the rank's
experts from the local leading dim). Token groups and the capacity are
defined on the global token order, so the block input is made whole
first under every layout (``Enter.part``: each rank's experts and router
columns give a part of its gradient). The router's logits are gathered,
so every rank routes every token alike (softmax, top-k, the auxiliary
loss) and lays out the dispatch and combine masks of its own experts (a
slot depends only on the assignments to its expert); the routing
weights pass ``copy_in``, since each rank's combine gives a part of
their gradient, and the auxiliary loss, the same on every rank, is
added once. The rank's partial output leaves as a
row-parallel product does. The decode path gathers each token's top-k
weights from the rank's experts only (others masked to zero) and sums
over 'model'. Shared experts and the dense prefix layers are MLPs (d_ff
on 'model').

The VLM (``models.transformer``) is the dense family's blocks over a
stream of the image embeddings and the tokens: ``embed`` puts the image
rows (an input, given by rank 0 alone into the partial lookups) ahead of
the token rows before the stream is laid out, and the region is as long
as both.

RWKV6 (``models.rwkv6``): the time mix's wr, wk, wv and wg are column-
parallel over heads (heads_fused), wo row-parallel, and the bonus u is
split over heads, so each rank runs the recurrence of its own heads
over the whole sequence (the block input enters through ``Enter.part``
on every layout: the token shift and the recurrence cross any sequence
shard). The decay's LoRA is whole: wa's gradient is a part (``copy_in``)
and w0 and wb's columns are cut to the rank's heads (``split``). The
output norm ``ln_x`` spans all heads, so its sum of squares is summed
over 'model' (``rms_norm``, through ``all_sum``). In the channel mix wk
is column-parallel over d_ff, wv row-parallel and the gate wr column-
parallel over embed_out: the partial sums of ``k @ wv`` are reduce-
scattered onto wr's columns before the gate multiplies them (``gate``).
The decode state splits over heads; the token-shift states follow the
(B, D) stream (``embed_part`` / ``embed_whole``).

Mamba2 (``models.mamba2``, the hybrid's backbone): the rule table puts
in_proj's fused z | x | B | C | dt columns and the convolution's x | B |
C channels ('ssm_fused') on 'model' in contiguous shards that cut across
the five parts and the heads (zamba2-2.7b on 16: 653 of 10,448 columns,
328 of 5,248 channels), while a_log, dt_bias, d_skip, out_norm and
out_proj's rows ('heads', 'ssm_fused' of d_in) split as the heads do.
So the projection is column-parallel and its output is gathered whole as
an activation (``gather_sum``: each rank's consumers give a part of its
gradient); the depthwise convolution runs on the rank's contiguous
channels of x | B | C (the decode cache's ``conv`` split the same way)
and its output, after the SiLU, is gathered whole again; each rank then
takes its heads' z, x and dt and all of B and C (one group, shared by
every head) and runs the recurrence of its heads. ``out_norm`` spans all
of d_in (``rms_norm``, as RWKV6's ``ln_x``), and out_proj is row-
parallel. No weight is gathered.

The hybrid (``models.hybrid``): the shared attention + MLP block is the
dense family's blocks; its leaves are one set used at every call site,
so each rank's shard sums its gradient over the sites. The decode cache
splits the attention k/v over kv heads, ``ssm`` over heads and ``conv``
over 'ssm_fused'.

The encoder-decoder (``models.encdec``): the encoder is the dense
family's blocks (non-causal, no rope) over its own residual stream,
laid out from its own global shape (whisper-medium's 1,500 frames do
not split over 16 under {"act": "seq"} and stay whole). Its first
block reads the frames and positions whole, as every rank holds them
(``Enter(..., whole=True)``), and lays the stream out from them: the
ranks' parts of their gradient are summed before the bfloat16 frames
round it, as one card rounds it. The encoder's
output enters every cross-attention whole: ``Enter.part`` of the stream
after the final norm makes it whole once (``copy_in`` or ``gather_sum``),
so every layer's k and v columns add their parts into one collective in
the backward pass. Cross-attention's q is column-parallel from the
decoder stream, k and v column-parallel over the rank's heads from the
encoder's output, wo row-parallel; in decode the rank's heads attend
the cross cache split over kv heads. The learned positions are whole
and each rank adds its part of them as the stream lays it out; a
vocabulary that 'model' does not divide (whisper's 51,865) leaves the
embedding and head whole, and the loss is the whole cross-entropy.

Multi-head latent attention (``models.mla``): wq, w_uk and w_uv are
column-parallel over heads (heads_fused), wo row-parallel; w_dkv and
kv_norm (kv_lora) are replicated, so the latent is computed whole and
enters the rank's w_uk / w_uv columns (and its heads' rope keys) through
``copy_in``. Where the shards cut a head the projections are gathered,
attended whole and split before ``wo``. The latent cache is whole on
every rank, and the absorbed decode runs the rank's heads against it.

A weight's layout is read from its local shape. A leaf as wide as the
config says is whole: ``make_pspec`` replicated it, and it is computed
replicated. A narrower one is the rank's contiguous shard.

Each collective is a ``torch.autograd.Function`` in the ``setup_context``
form with a ``vmap`` rule. The collectives act elementwise over a
leading batch dim, so the rule moves that dim to the front and runs the
collective on the batched tensor (dims are counted from the end, which
a batch dim does not move). So they run under ``torch.func.grad`` and
``vmap`` and inside ``models.common.remat``. Each backward is the dual
Function, so it is batched the same way. The collectives are
``torch.distributed._functional_collectives`` over (mesh, dim): NCCL on
cards, gloo on CPU ranks, the fake group in a dry run.

The context (``TPContext``) is the mesh, the 'model' dim, this rank's
coordinate on it, its size and the rules (by default the reference's
``base_rules``). ``scope`` enters it; ``models.common.logical_rule_scope``
does, and so do the sharded step and the dry run. ``region`` marks the
model code that honours it (every language model), and
fixes the residual stream's layout from its global shape; ``bind``
carries both into a layer that ``remat`` recomputes in the backward
pass. Outside them, or on a 'model' dim of size 1, ``active()`` is None
and every helper is the identity, so the one-card paths are bitwise as
they were.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

# the families whose models compute on their 'model' shards ("ssm" is
# RWKV6's, ``models.rwkv6.RWKVLM``): every language-model family
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


class TPContext(NamedTuple):
    mesh: Any
    dim: int                     # the 'model' dim of the mesh
    rank: int                    # this rank's coordinate on it
    size: int
    rules: dict

    @property
    def group(self):
        return (self.mesh, self.dim)

    def on_model(self, shape, axes) -> Optional[int]:
        """The dim (< 0) of a tensor of global ``shape`` with logical
        ``axes`` that the rules put on 'model', or None."""
        from repro_torch.launch.sharding import make_pspec
        spec = make_pspec(tuple(shape), tuple(axes), self.rules, self.mesh)
        for i, entry in enumerate(spec):
            if "model" in _axes(entry):
                return i - len(spec)
        return None


# the context, whether a region honours it, the residual stream's split
_STATE = {"ctx": None, "region": False, "split": None}


def context_for(mesh, rules: Optional[dict] = None) -> Optional[TPContext]:
    """The context of ``mesh``'s 'model' dim (None without one) under
    ``rules`` (default: ``launch.sharding.base_rules(mesh)``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names or "model" not in names:
        return None
    if rules is None:
        from repro_torch.launch.sharding import base_rules
        rules = base_rules(mesh)
    d = list(names).index("model")
    return TPContext(mesh, d, int(mesh.get_coordinate()[d]),
                     int(mesh.size(d)), rules)


def _axes(entry) -> tuple:
    if not entry:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Set:
    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self._saved = dict(_STATE)
        _STATE.update(self.kw)
        return self

    def __exit__(self, *exc):
        _STATE.update(self._saved)
        return False


def scope(ctx: Optional[TPContext]) -> _Set:
    """``with scope(ctx):`` makes ``ctx`` the context (None clears it)."""
    return _Set(ctx=ctx, region=False, split=None)


def region(seq_len: Optional[int], d_model: int) -> _Set:
    """``with region(S, D):`` the model code inside honours the context,
    its residual stream of global shape (B, S, D), or (B, D) for a
    ``seq_len`` of None, laid out as the rules say."""
    c = current()
    split = None
    if c is not None:
        if seq_len is None:
            split = c.on_model((d_model,), ("act_embed",))
        else:
            split = c.on_model((seq_len, d_model), ("act_seq", "act_embed"))
    return _Set(region=True, split=split)


def current() -> Optional[TPContext]:
    """The context in scope with a 'model' dim of more than one rank,
    whether or not a region honours it."""
    c = _STATE["ctx"]
    return c if c is not None and c.size > 1 else None


def active() -> Optional[TPContext]:
    """The context the model code computes under, or None."""
    return current() if _STATE["region"] else None


def hinted(name: str) -> bool:
    """Whether the rules put the logical activation axis ``name`` on
    'model'."""
    return "model" in _axes(active().rules.get(name))


def bind(fn: Callable) -> Callable:
    """``fn`` run under the context, region and layout in force now
    (``remat`` calls its body again in the backward pass, outside
    them)."""
    saved = dict(_STATE)
    if active() is None:
        return fn

    def run(*args):
        with _Set(**saved):
            return fn(*args)
    return run


# --------------------------------------------------------------------------- #
# the collectives
# --------------------------------------------------------------------------- #
def _wait(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    if isinstance(t, funcol.AsyncCollectiveTensor):
        return t.wait()
    return t


def _all_reduce(x: torch.Tensor, c: TPContext, op: str = "sum"
                ) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    return _wait(funcol.all_reduce(x.contiguous(), op, c.group))


def _all_gather(x: torch.Tensor, c: TPContext, dim: int) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return _wait(fn(x.contiguous(), dim % x.dim(), c.group))


def _reduce_scatter(x: torch.Tensor, c: TPContext, dim: int
                    ) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "reduce_scatter_single", None) or \
        funcol.reduce_scatter_tensor
    return _wait(fn(x.contiguous(), "sum", dim % x.dim(), c.group))


def _slice(x: torch.Tensor, c: TPContext, dim: int) -> torch.Tensor:
    n = x.shape[dim] // c.size
    return x.narrow(dim, c.rank * n, n).contiguous()


class _Collective(torch.autograd.Function):
    """``apply(x, ctx, dim)``: a collective over 'model' along ``dim``
    (< 0), batched over a leading vmap dim as it is. ``_collective``
    makes each one, its backward the forward of its dual."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp, ctx.dim = inputs[1], inputs[2]

    @classmethod
    def vmap(cls, info, in_dims, x, c, dim):
        if in_dims[0] is None:
            return cls.apply(x, c, dim), None
        return cls.apply(x.movedim(in_dims[0], 0), c, dim), 0


def _collective(name: str, fwd: Callable) -> type:
    def forward(x, c, dim):
        return fwd(x, c, dim)

    def backward(ctx, g):
        return _DUAL[name].apply(g, ctx.tp, ctx.dim), None, None

    return type(name, (_Collective,), {"forward": staticmethod(forward),
                                       "backward": staticmethod(backward)})


_CopyIn = _collective("_CopyIn", lambda x, c, d: x.view_as(x))
_ReduceOut = _collective("_ReduceOut", lambda x, c, d: _all_reduce(x, c))
_Gather = _collective("_Gather", _all_gather)
_Split = _collective("_Split", _slice)
_GatherSum = _collective("_GatherSum", _all_gather)
_ScatterSum = _collective("_ScatterSum", _reduce_scatter)
_DUAL = {"_CopyIn": _ReduceOut, "_ReduceOut": _CopyIn,
         "_Gather": _Split, "_Split": _Gather,
         "_GatherSum": _ScatterSum, "_ScatterSum": _GatherSum}


class _Max(_Collective):
    """The all-reduced max; no gradient flows through it."""

    @staticmethod
    def forward(x, c, dim):
        return _all_reduce(x, c, "max")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None


def all_gather(x: torch.Tensor, ctx: TPContext, dim: int) -> torch.Tensor:
    """The whole of ``x`` split over 'model' along ``dim`` (the logits
    over the vocabulary, a cache over head_dim), for a caller outside
    the model; no gradient."""
    return _all_gather(x, ctx, dim) if ctx.size > 1 else x


def _apply(fn: type, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    c = active()
    return x if c is None else fn.apply(x, c, dim)


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """The identity; the gradient all-reduced over 'model'."""
    return _apply(_CopyIn, x)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """All-reduced over 'model'; the gradient passes as it is."""
    return _apply(_ReduceOut, x)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices along ``dim`` (< 0) concatenated; the gradient
    is the rank's slice (the consumer computes replicated)."""
    return _apply(_Gather, x, dim)


def split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` (< 0); the gradient all-gathered."""
    return _apply(_Split, x, dim)


def gather_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices along ``dim`` (< 0) concatenated; the gradient
    reduce-scattered (each rank's consumer gives a part of it)."""
    return _apply(_GatherSum, x, dim)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """Summed over 'model'; the gradient summed too (each rank's consumer
    gives a part of it)."""
    return reduce_out(copy_in(x))


def embed_part(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """A whole (..., d_model) row as a (B, D) residual stream lays it out:
    the rank's slice where the rules put 'act_embed' on 'model' (RWKV6's
    token-shift states in its cache)."""
    c = active()
    if c is None or c.on_model((d_model,), ("act_embed",)) is None:
        return x
    return _Split.apply(x, c, -1)


def embed_whole(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """``embed_part``'s inverse: the whole row."""
    c = active()
    if c is None or c.on_model((d_model,), ("act_embed",)) is None:
        return x
    return _Gather.apply(x, c, -1)


# --------------------------------------------------------------------------- #
# the layers' pieces
# --------------------------------------------------------------------------- #
def leave(y: torch.Tensor, partial: bool) -> torch.Tensor:
    """A block's output in the residual stream's layout: partial sums (a
    row-parallel product) all-reduced, or reduce-scattered over the
    stream's split dim; a replicated one kept, or sliced."""
    c = active()
    if c is None:
        return y
    s = _STATE["split"]
    if s is not None:
        return (_ScatterSum if partial else _Split).apply(y, c, s)
    return _ReduceOut.apply(y, c, -1) if partial else y


class Enter:
    """The residual stream ``x`` (this rank's part of it) as a block's
    input ``norm(x)``, made on first use for column-parallel consumers
    (``part``) and for replicated ones (``whole``). ``norm(t, wrap)``
    normalizes ``t`` with its scales passed through ``wrap``. An unsplit
    stream is normalized once and enters ``part`` through ``copy_in``; a
    sequence-split one is normalized on its shard (scales through
    ``copy_in``: the shard's gradient is a part) and then gathered; a
    d_model-split one is gathered and then normalized. With ``whole``,
    ``x`` is whole on every rank (a region's input before it is laid
    out, the encoder's frames), and enters as an unsplit stream does."""

    def __init__(self, x: torch.Tensor,
                 norm: Optional[Callable] = None, whole: bool = False):
        self.x = x
        self.norm = norm or (lambda t, wrap: t)
        self.split = None if whole else _STATE["split"]
        self._h = self._part = self._whole = None

    def _local(self) -> torch.Tensor:
        """norm(x) on the rank's rows (an unsplit or sequence-split
        stream)."""
        if self._h is None:
            c, s = active(), self.split
            wrap = copy_in if c is not None and s == -2 else _same
            self._h = self.norm(self.x, wrap)
        return self._h

    def part(self) -> torch.Tensor:
        if self._part is None:
            c, s = active(), self.split
            if c is None:
                self._part = self._local()
            elif s is None:
                self._part = _CopyIn.apply(self._local(), c, -1)
            elif s == -2:
                self._part = _GatherSum.apply(self._local(), c, s)
            else:
                self._part = self.norm(_GatherSum.apply(self.x, c, s),
                                       copy_in)
        return self._part

    def whole(self) -> torch.Tensor:
        if self._whole is None:
            c, s = active(), self.split
            if c is None or s is None:
                self._whole = self._local()
            elif s == -2:
                self._whole = _Gather.apply(self._local(), c, s)
            else:
                self._whole = self.norm(_Gather.apply(self.x, c, s), _same)
        return self._whole


class Whole(Enter):
    """An input every rank holds whole, its gradient summed over the ranks
    by its producer (the encoder-decoder's encoder output, ``Enter.part``
    of its stream): column-parallel consumers read it as it is. A whole
    weight may not read it: its gradient would reach the input alike on
    every rank, and the producer's sum would count it once a rank."""

    def part(self) -> torch.Tensor:
        return self.x

    def whole(self) -> torch.Tensor:
        raise NotImplementedError(
            "an input made whole for column-parallel consumers read "
            "through a whole weight")


def whole_input(t: torch.Tensor):
    """``t``, whole on every rank, as the layers take it: a ``Whole``
    under tensor parallelism, ``t`` itself otherwise."""
    return t if active() is None else Whole(t)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def column(xe: Enter, w: torch.Tensor, b: Optional[torch.Tensor],
           full: int) -> Tuple[torch.Tensor, bool]:
    """``x @ w (+ b)`` and whether it is the rank's slice of the ``full``
    output features (w column-parallel) or all of them (w whole)."""
    sharded = w.shape[-1] != full
    y = (xe.part() if sharded else xe.whole()) @ w
    if b is not None:
        y = y + b
    return y, sharded


def row(y: torch.Tensor, w: torch.Tensor, full: int, y_sharded: bool
        ) -> torch.Tensor:
    """``y @ w`` back in the residual stream: with w row-parallel (the
    rank's rows of ``full``) y is brought to the same slice and the
    partial products summed; with w whole, y is made whole."""
    if w.shape[-2] != full:
        if not y_sharded:
            y = split(y, -1)
        return leave(y @ w, partial=True)
    if y_sharded:
        y = gather(y, -1)
    return leave(y @ w, partial=False)


def gate(r: torch.Tensor, r_sharded: bool, y: torch.Tensor,
         y_partial: bool) -> torch.Tensor:
    """``r * y`` in the residual stream's layout, r a gate over the output
    columns (the rank's slice of them where ``r_sharded``) and y the
    product of a row-parallel weight (partial sums, ``y_partial``) or of
    a whole one: y is reduce-scattered (or cut) onto r's columns, or
    all-reduced, before the gate multiplies it (RWKV6's channel mix)."""
    c = active()
    if c is None:
        return r * y
    if r_sharded:
        out = r * (_ScatterSum if y_partial else _Split).apply(y, c, -1)
        if _STATE["split"] == -1:          # the stream's d_model slice
            return out
        return leave(_Gather.apply(out, c, -1), partial=False)
    if y_partial:
        y = _ReduceOut.apply(y, c, -1)
    return leave(r * y, partial=False)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, full: int,
             eps: float = 1e-6) -> torch.Tensor:
    """``models.common.rms_norm`` over ``full`` features of which ``x``
    holds the rank's slice (all of them, or under tensor parallelism a
    narrower one: the sum of squares all-summed over 'model', the rank's
    slice of the whole ``gamma`` taken)."""
    from repro_torch.models.common import rms_norm as whole_norm
    if x.shape[-1] == full:
        return whole_norm(x, gamma, eps)
    xf = x.to(torch.float32)
    var = all_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) / full
    g = split(gamma, -1) if gamma.shape[-1] == full else gamma
    return (xf * torch.rsqrt(var + eps) * g.to(torch.float32)).to(x.dtype)


def embed(tok: torch.Tensor, ids: torch.Tensor, vocab: int,
          prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of ``tok`` for ``ids`` (B, S), after the rows ``prefix``
    (B, P, D) when given (the VLM's image embeddings, in ``tok``'s dtype),
    in the residual stream's layout: with vocab-parallel ``tok`` the rank
    looks up its own rows (other ids give zero) and the partial lookups
    are summed, the prefix given by rank 0 alone."""
    partial = tok.shape[0] != vocab
    if partial:
        c = active()
        n = tok.shape[0]
        local = ids - c.rank * n
        inside = (local >= 0) & (local < n)
        x = F.embedding(torch.where(inside, local, 0), tok)
        x = x * inside[..., None].to(x.dtype)
    else:
        x = F.embedding(ids, tok)
    if prefix is not None:
        prefix = prefix.to(x.dtype)
        if partial and c.rank:
            prefix = torch.zeros_like(prefix)
        x = torch.cat([prefix, x], dim=-2)
    return leave(x, partial)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy in f32 over vocab-parallel ``logits`` (..., V /
    T): each rank's log-sum-exp over its slice, combined through their
    all-reduced max and sum of exps, less the all-reduced target logit
    (the rank holding it gives it, the others zero)."""
    c = active()
    lf = logits.to(torch.float32)
    z = torch.logsumexp(lf, dim=-1)
    m = _Max.apply(z.detach(), c, -1)
    logz = m + torch.log(_ReduceOut.apply(torch.exp(z - m), c, -1))
    n = lf.shape[-1]
    local = labels.to(torch.int64) - c.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
    gold = _ReduceOut.apply(gold[..., 0] * inside.to(lf.dtype), c, -1)
    return torch.mean(logz - gold)


def cache_split(n_kv: int, head_dim: int) -> Optional[str]:
    """Which dim of a (.., kv_heads, head_dim) cache entry the rule table
    puts on 'model': "kv_heads", "head_dim" or None."""
    d = active().on_model((n_kv, head_dim), ("kv_heads", "head_dim"))
    return None if d is None else ("kv_heads", "head_dim")[d]


def head_range(n_heads: int, n_kv: int) -> Optional[Tuple[int, int]]:
    """The kv heads [lo, hi) that this rank's whole q heads attend to,
    when the q heads split evenly over 'model' and each rank's heads
    group onto their kv heads as a whole attention does; else None."""
    c = active()
    if n_heads % c.size:
        return None
    h_l, g = n_heads // c.size, n_heads // n_kv
    if h_l % g and g % h_l:
        return None
    lo = c.rank * h_l // g
    return lo, lo + max(h_l // g, 1)


def expert_range(local: int, total: int) -> Tuple[int, int]:
    """The experts [lo, hi) of ``total`` that this rank holds, from the
    ``local`` leading dim of its expert weights: all of them for a leaf
    as wide as the config (or outside a context), else the rank's
    contiguous shard."""
    c = active()
    if c is None or local == total:
        return 0, total
    return c.rank * local, (c.rank + 1) * local
