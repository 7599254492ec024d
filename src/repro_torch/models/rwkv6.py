"""RWKV6 "Finch": the attention-free LM with a data-dependent decay
(arXiv:2404.05892).

Held against ``repro.models.rwkv6``: ``DECAY_LORA``, the time-mix,
channel-mix and layer specs, ``_shift``, ``_decay``, the ``CHUNK``
module switch with ``_chunked_recurrence``, ``time_mix_seq``,
``time_mix_step``, ``channel_mix_seq``, ``channel_mix_step`` and
``RWKVLM`` (``param_specs``, ``init``, ``forward``, ``loss``,
``cache_struct``, ``init_cache``, ``decode_step``, ``prefill``).

Time-mix recurrence per head (state S (hd, hd)):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with the decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)) in float32. The
channel mix is the squared-ReLU receptance FFN; token shift mixes each
token with the one before by learned static ratios ``mu``.

Parameters are a flat dict in the reference's leaf order
(``embed.head``, ``embed.tok``, ``final_norm.gamma``, ``layers.cm.mu``,
..., ``layers.tm.wv``); the ``layers.*`` leaves carry the stacked layer
axis and a Python loop over layers replaces the reference's ``lax.scan``
(with ``remat``, the default, each layer under ``models.common.remat``,
as the reference checkpoints its scan body). ``CHUNK = 0`` (the
default, as in the reference) runs the recurrence one token at a time.

The cache is the stacked recurrent state, O(1) in the sequence:
``state`` (L, B, H, hd, hd) float32, ``tm_prev`` and ``cm_prev``
(L, B, D) bfloat16. ``decode_step`` writes the new state into the cache
it is given and returns that same dict (a leaf whose dtype the step's
output does not share is replaced by a new one of the output's dtype, as
the reference's scan stacks its outputs; the step reads the old one).

Tensor parallelism (``models.tensor_parallel``, whose module docstring
gives the layout): under a context with a 'model' dim of more than one
rank the layers compute on the rank's heads and d_ff columns, each
block's input entering as a ``tp.Enter`` of the residual stream; the
logits are the rank's vocabulary slice, the loss the vocab-parallel
cross-entropy, and the cache the rank's part (the state over its heads,
the token-shift states as the (B, D) stream). One body serves both
cases: outside a context every helper is the identity.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.common import (
    ParamSpec,
    cross_entropy_loss,
    init_params,
    prefixed,
    abstract_params,
    remat,
    rms_norm,
    shard_hint,
    stack_specs,
    store_layer,
    subtree,
    time_scan,
    unstack,
)
from repro_torch.models.convert import in_leaf_order
from repro_torch.models.layers import (
    _entered,
    embed_tokens,
    embedding_specs,
    lm_head,
)

Tree = Dict[str, torch.Tensor]
DECAY_LORA = 64

# when > 0, the training path's recurrence takes the chunk-parallel form
# with this intra-chunk length (another float32 summation order);
# 0 => the sequential recurrence
CHUNK = 0


def time_mix_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "mu": ParamSpec((4, d), (None, "embed"), "uniform", scale=0.5),
        "wr": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wk": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wv": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wg": ParamSpec((d, d), ("embed", "heads_fused"), "normal"),
        "wo": ParamSpec((d, d), ("heads_fused", "embed"), "normal"),
        # data-dependent decay LoRA (w0 + tanh(x A) B)
        "w0": ParamSpec((d,), ("embed",), "zeros"),
        "wa": ParamSpec((d, DECAY_LORA), ("embed", None), "normal"),
        "wb": ParamSpec((DECAY_LORA, d), (None, "embed"), "normal",
                         scale=0.1),
        "u": ParamSpec((h, hd), ("heads", "head_dim"), "uniform",
                        scale=0.5),
        "ln_x": ParamSpec((d,), ("embed",), "ones"),
    }


def channel_mix_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamSpec((2, d), (None, "embed"), "uniform", scale=0.5),
        "wk": ParamSpec((d, f), ("embed", "d_ff"), "normal"),
        "wv": ParamSpec((f, d), ("d_ff", "embed"), "normal"),
        "wr": ParamSpec((d, d), ("embed", "embed_out"), "normal"),
    }


def layer_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {"ln1.gamma": ParamSpec((d,), ("embed",), "ones"),
            "ln2.gamma": ParamSpec((d,), ("embed",), "ones"),
            **prefixed("tm.", time_mix_specs(cfg)),
            **prefixed("cm.", channel_mix_specs(cfg))}


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift over the sequence: rows become [prev, x_0, ...,
    x_{S-2}] (in the promoted dtype, as the reference's concatenate)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mixer(xe: "tp.Enter", shifted, mu: torch.Tensor):
    """``mix(i, sharded)``: the token shift ``h + (shifted(h) - h) *
    mu[i]`` of the block input h for a column-parallel consumer
    (``sharded``: h is ``tp.Enter.part`` and ``mu`` passes ``tp.copy_in``,
    since the rank's columns give a part of their gradients) or a whole
    one (h whole); ``shifted(h)`` is computed once for each h."""
    done = {}

    def mix(i: int, sharded: bool) -> torch.Tensor:
        h = xe.part() if sharded else xe.whole()
        if id(h) not in done:
            done[id(h)] = (h, shifted(h))
        m = tp.copy_in(mu[i]) if sharded else mu[i]
        return h + (done[id(h)][1] - h) * m
    return mix


def _decay(p: Tree, x: torch.Tensor, sharded: bool = False
           ) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), the
    sum in the parameters' dtype, the exponentials in float32; with
    ``sharded`` the rank's heads' (w0 and B's columns split as the heads
    are, A's gradient a part)."""
    wa, wb, w0 = p["wa"], p["wb"], p["w0"]
    if sharded:
        wa, wb, w0 = tp.copy_in(wa), tp.split(wb, -1), tp.split(w0, -1)
    loraw = torch.tanh(x @ wa) @ wb
    return torch.exp(-torch.exp((w0 + loraw).to(torch.float32)))


def _heads(cfg: ArchConfig, p: Tree) -> Tuple[int, bool]:
    """The number of heads whose r, k, v and g columns (and ``wo`` rows)
    this rank holds, and whether they are its slice of the heads (under
    tensor parallelism; all of them otherwise)."""
    hd, d = cfg.head_dim, cfg.d_model
    width = p["wr"].shape[-1]
    if any(p[k].shape[-1] != width for k in ("wk", "wv", "wg")) \
            or p["wo"].shape[-2] != width:
        raise NotImplementedError(
            f"{cfg.name}: the time mix's wr, wk, wv, wg and wo laid out "
            "apart")
    if width % hd:
        raise NotImplementedError(
            f"{cfg.name}: the 'model' shards cut a head ({width} of "
            f"{d} features, heads of {hd})")
    return width // hd, width != d


def _own_u(cfg: ArchConfig, u: torch.Tensor, n: int) -> torch.Tensor:
    """The bonus ``u`` of the rank's ``n`` heads (as float32)."""
    if u.shape[0] != n:
        u = tp.split(u, -2)
    if tuple(u.shape) != (n, cfg.head_dim):
        raise NotImplementedError(
            f"{cfg.name}: u {tuple(u.shape)} is not laid out as the heads")
    return u.to(torch.float32)


def _chunked_recurrence(rt, kt, vt, wt, u, state):
    """Chunk-parallel RWKV6 recurrence. rt/kt/vt/wt (B,S,H,K) float32
    (wt in (0, 1)); state (B,H,K,V). With the chunk's entry state S0 and
    A_t = prod_{j<=t} w_j per channel:

        o_t = (r_t . A_{t-1}) S0 + sum_{i<t} (r_t . A_{t-1}/A_i . k_i) v_i
              + (r_t . u . k_t) v_t
        S_c = diag(A_c) S0 + sum_i diag(A_c / A_i) k_i v_i^T

    Returns (new state, o (B,S,H,K))."""
    B, S, H, K = rt.shape
    c = CHUNK
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of CHUNK {c}")
    nc = S // c

    def to_chunks(x):
        return x.reshape(B, nc, c, H, K).transpose(0, 1)   # (nc,B,c,H,K)

    rs, ks, vs, ws = map(to_chunks, (rt, kt, vt, wt))
    eye = torch.eye(c, dtype=torch.float32, device=rt.device)
    tri = torch.tril(torch.ones(c, c, dtype=torch.float32,
                                device=rt.device), diagonal=-1)  # i < t

    def chunk(S0, i):
        r, k, v, w = rs[i], ks[i], vs[i], ws[i]            # (B,c,H,K)
        A = torch.cumprod(w, dim=1)
        A_prev = torch.cat([torch.ones_like(A[:, :1]), A[:, :-1]], dim=1)
        r_dec = r * A_prev                                 # r_t . A_{t-1}
        k_dec = k / torch.clamp(A, min=1e-30)              # k_i / A_i
        inter = torch.einsum("bchk,bhkv->bchv", r_dec, S0)
        M = torch.einsum("bchk,bihk->bhci", r_dec, k_dec) * tri[None, None]
        diag = torch.einsum("bchk,bchk->bhc", r, u[None, None] * k)
        M = M + diag[..., None] * eye[None, None]
        o = inter + torch.einsum("bhci,bihv->bchv", M, v)
        A_c = A[:, -1]                                     # (B,H,K)
        S_new = A_c[..., None] * S0 + torch.einsum(
            "bchk,bchv->bhkv", k_dec * A_c[:, None], v)
        return S_new, o

    state, os_ = time_scan(chunk, state, nc)               # (nc,B,c,H,K)
    return state, os_.transpose(0, 1).reshape(B, S, H, K)


def _time_mix_inputs(cfg: ArchConfig, p: Tree, xe: "tp.Enter", shifted):
    """The time mix's r, k, v (float32, (..., H, hd)), gate g, decay w
    (float32 in (0, 1)) and bonus u over the rank's H heads, the block
    input h they read and whether the heads are the rank's slice.
    ``shifted(h)`` is the token-shifted input."""
    H, sharded = _heads(cfg, p)
    mix = _mixer(xe, shifted, p["mu"])
    xr, xk, xv, xw = (mix(i, sharded) for i in range(4))
    h = xe.part() if sharded else xe.whole()
    heads = tuple(h.shape[:-1]) + (H, cfg.head_dim)
    r = (xr @ p["wr"]).reshape(heads).to(torch.float32)
    k = (xk @ p["wk"]).reshape(heads).to(torch.float32)
    v = (xv @ p["wv"]).reshape(heads).to(torch.float32)
    g = F.silu(xv @ p["wg"])
    w = _decay(p, xw, sharded).reshape(heads)                 # f32 in (0,1)
    return r, k, v, g, w, _own_u(cfg, p["u"], H), h, sharded


def _time_mix_out(cfg: ArchConfig, p: Tree, o: torch.Tensor, g, h,
                  sharded) -> torch.Tensor:
    """``(ln_x(o) * g) @ wo`` back in the residual stream: o (..., H, hd)
    over the rank's heads, in the block input h's dtype, normalized over
    all heads."""
    o = o.reshape(tuple(o.shape[:-2]) + (-1,)).to(h.dtype)
    o = tp.rms_norm(o, p["ln_x"], cfg.d_model) * g
    return tp.row(o, p["wo"], cfg.d_model, sharded)


def time_mix_seq(cfg: ArchConfig, p: Tree, x, prev_x: torch.Tensor,
                 state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time mix. x (B,S,D) the block input (under tensor
    parallelism the ``tp.Enter`` of the stream: the whole sequence is
    read); prev_x (B,D) the last token before the sequence; state
    (B,H,hd,hd) over the rank's heads. Returns (out (B,S,D) in the
    stream's layout, the new prev_x (whole), the new state)."""
    r, k, v, g, w, u, h, sharded = _time_mix_inputs(
        cfg, p, _entered(x), lambda t: _shift(t, prev_x))
    S = h.shape[1]

    if CHUNK and S % CHUNK == 0:
        state, o = _chunked_recurrence(r, k, v, w, u,
                                       state.to(torch.float32))
    else:
        def step(S_state, t):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hd,hd)
            o = torch.einsum("bhi,bhij->bhj", r[:, t],
                             S_state + u[None, :, :, None] * kv)
            return w[:, t, :, :, None] * S_state + kv, o

        state, o = time_scan(step, state.to(torch.float32), S)
        o = o.transpose(0, 1)                                  # (B,S,H,hd)
    out = _time_mix_out(cfg, p, o, g, h, sharded)
    return (shard_hint(out, ("batch", "act_seq", "act_embed")), h[:, -1, :],
            state)


def time_mix_step(cfg: ArchConfig, p: Tree, x, prev_x: torch.Tensor,
                  state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x (B,D) the block input (or its ``tp.Enter``), prev_x
    (B,D) in the stream's layout, state (B,H,hd,hd) float32 over the
    rank's heads. Returns (out, the new prev_x, the new state)."""
    prev = tp.embed_whole(prev_x, cfg.d_model)
    r, k, v, g, w, u, h, sharded = _time_mix_inputs(
        cfg, p, _entered(x), lambda t: prev)
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    new_state = w[..., :, None] * state + kv
    return (_time_mix_out(cfg, p, o, g, h, sharded),
            tp.embed_part(h, cfg.d_model), new_state)


def _channel_mix(cfg: ArchConfig, p: Tree, xe: "tp.Enter", shifted
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigmoid(xr W_r) * (relu(xk W_k)^2 W_v): W_k and W_r column-
    parallel, W_v row-parallel, so its partial sums are reduce-scattered
    onto W_r's columns before the gate (``tp.gate``). Returns (out, the
    whole block input the gate read)."""
    d, f = cfg.d_model, cfg.d_ff
    ks, rs = p["wk"].shape[-1] != f, p["wr"].shape[-1] != d
    mix = _mixer(xe, shifted, p["mu"])
    xk, xr = mix(0, ks), mix(1, rs)
    k = torch.square(F.relu(xk @ p["wk"]))
    if k.dim() == 3:
        k = shard_hint(k, ("batch", "seq", "act_ff"))
    out = tp.gate(torch.sigmoid(xr @ p["wr"]), rs, k @ p["wv"],
                  p["wv"].shape[-2] != f)
    return out, xe.part() if rs else xe.whole()


def channel_mix_seq(cfg: ArchConfig, p: Tree, x, prev_x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) the block input (or its ``tp.Enter``), prev_x (B,D) whole;
    returns (out in the stream's layout, the new prev_x, whole)."""
    out, h = _channel_mix(cfg, p, _entered(x), lambda t: _shift(t, prev_x))
    return out, h[:, -1, :]


def channel_mix_step(cfg: ArchConfig, p: Tree, x, prev_x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,D) the block input (or its ``tp.Enter``), prev_x
    (B,D) in the stream's layout; returns (out, the new prev_x)."""
    prev = tp.embed_whole(prev_x, cfg.d_model)
    out, h = _channel_mix(cfg, p, _entered(x), lambda t: prev)
    return out, tp.embed_part(h, cfg.d_model)


class RWKVLM:
    def __init__(self, cfg: ArchConfig, remat: bool = True):
        if cfg.family != "ssm" or not cfg.name.startswith("rwkv"):
            raise ValueError(f"{cfg.name}: RWKVLM builds the rwkv configs "
                             "of the ssm family")
        self.cfg = cfg
        self.remat = remat

    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        return in_leaf_order({
            **prefixed("embed.", embedding_specs(cfg)),
            "final_norm.gamma": ParamSpec((cfg.d_model,), ("embed",),
                                        "ones"),
            **prefixed("layers.", stack_specs(cfg.n_layers,
                                              layer_specs(cfg))),
        })

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        return init_params(self.param_specs(), generator, device)

    def abstract_params(self) -> Tree:
        return abstract_params(self.param_specs())

    # -------------------------------------------------------------- #
    def _tp(self, seq_len: Optional[int]):
        """The tensor-parallel region over a residual stream of
        ``seq_len`` tokens (None: decode)."""
        return tp.region(seq_len, self.cfg.d_model)

    @staticmethod
    def _norm(x: torch.Tensor, gamma: torch.Tensor) -> "tp.Enter":
        """A block's input ``rms_norm(x, gamma)`` as the layers take it:
        the residual stream with its norm (``tensor_parallel.Enter``)."""
        return tp.Enter(x, lambda t, wrap: rms_norm(t, wrap(gamma)))

    def _layer_seq(self, lp: Tree, x: torch.Tensor, st: Tree
                   ) -> Tuple[torch.Tensor, Tree]:
        cfg = self.cfg
        tm_out, tm_prev, tm_state = time_mix_seq(
            cfg, subtree(lp, "tm."), self._norm(x, lp["ln1.gamma"]),
            st["tm_prev"], st["state"])
        x = x + tm_out
        cm_out, cm_prev = channel_mix_seq(
            cfg, subtree(lp, "cm."), self._norm(x, lp["ln2.gamma"]),
            st["cm_prev"])
        x = x + cm_out
        return x, {"state": tm_state, "tm_prev": tm_prev,
                   "cm_prev": cm_prev}

    def _zero_layer_state(self, lp: Tree, B: int, device) -> Tree:
        """Zero states: the recurrent state over the heads of the rank's
        ``lp`` (all of them outside tensor parallelism), the token-shift
        states whole."""
        cfg = self.cfg
        heads = lp["tm.wr"].shape[-1] // cfg.head_dim
        return {
            "state": torch.zeros((B, heads, cfg.head_dim, cfg.head_dim),
                                 dtype=torch.float32, device=device),
            "tm_prev": torch.zeros((B, cfg.d_model), dtype=torch.bfloat16,
                                   device=device),
            "cm_prev": torch.zeros((B, cfg.d_model), dtype=torch.bfloat16,
                                   device=device),
        }

    def _train_layer(self, lp: Tree, x: torch.Tensor
                     ) -> Tuple[torch.Tensor]:
        """One layer of the training forward from zero states."""
        x, _ = self._layer_seq(lp, x, self._zero_layer_state(
            lp, x.shape[0], x.device))
        return (x,)

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        return lm_head(self.cfg, subtree(params, "embed."),
                       self._norm(x, params["final_norm.gamma"]))

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), a float32 zero: no auxiliary loss)."""
        with self._tp(batch["tokens"].shape[-1]):
            x = embed_tokens(self.cfg, subtree(params, "embed."),
                             batch["tokens"])
            layer = tp.bind(self._train_layer)
            for lp in unstack(params, "layers.", self.cfg.n_layers):
                if self.remat:
                    x, = remat(layer, lp, x)
                else:
                    x, = self._train_layer(lp, x)
            return self._head(params, x), torch.zeros(
                (), dtype=torch.float32, device=x.device)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        with self._tp(batch["tokens"].shape[-1]):
            logits, _ = self.forward(params, batch)
            if logits.shape[-1] != self.cfg.vocab_size:   # vocab-parallel
                return tp.cross_entropy(logits[:, :-1, :],
                                        batch["labels"][:, 1:])
            return cross_entropy_loss(logits[:, :-1, :],
                                      batch["labels"][:, 1:])

    # -------------------------------------------------------------- #
    # decode: the cache is the stacked recurrent state, O(1) in seq
    # -------------------------------------------------------------- #
    def cache_struct(self, batch_size: int, cache_len: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        cfg = self.cfg
        L, B = cfg.n_layers, batch_size
        return {
            "state": ((L, B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                      torch.float32),
            "tm_prev": ((L, B, cfg.d_model), torch.bfloat16),
            "cm_prev": ((L, B, cfg.d_model), torch.bfloat16),
        }

    def cache_axes(self) -> Dict[str, tuple]:
        return {
            "state": ("layers", "batch", "heads", "head_dim", None),
            "tm_prev": ("layers", "batch", "act_embed"),
            "cm_prev": ("layers", "batch", "act_embed"),
        }

    def init_cache(self, batch_size: int, cache_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in self.cache_struct(batch_size,
                                                     cache_len).items()}

    def abstract_cache(self, batch_size: int, cache_len: int) -> Tree:
        return self.init_cache(batch_size, cache_len, torch.device("meta"))

    def decode_step(self, params: Tree, token: torch.Tensor,
                    pos: torch.Tensor, cache: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
        """token (B,) int; pos (B,) (unused: the state carries position);
        returns (logits (B, V), cache), the same dict, updated. Under
        tensor parallelism the cache is the rank's part of it: the state
        over its heads, the token-shift states as the (B, D) stream."""
        cfg = self.cfg
        with self._tp(None):
            src = dict(cache)              # the leaves the step reads
            x = tp.embed(params["embed.tok"], token, cfg.vocab_size)
            for i, lp in enumerate(unstack(params, "layers.",
                                           cfg.n_layers)):
                tm_out, tm_prev, state = time_mix_step(
                    cfg, subtree(lp, "tm."), self._norm(x, lp["ln1.gamma"]),
                    src["tm_prev"][i].to(x.dtype), src["state"][i])
                y = x + tm_out
                cm_out, cm_prev = channel_mix_step(
                    cfg, subtree(lp, "cm."), self._norm(y, lp["ln2.gamma"]),
                    src["cm_prev"][i].to(y.dtype))
                x = y + cm_out
                store_layer(cache, "state", i, state)
                store_layer(cache, "tm_prev", i, tm_prev.to(torch.bfloat16))
                store_layer(cache, "cm_prev", i, cm_prev.to(torch.bfloat16))
            return self._head(params, x), cache

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """Forward over the prompt: (logits (B, S, V), the recurrent state
        after it, stacked (L, ...), in the dtypes the layers produce; under
        tensor parallelism laid out as ``decode_step`` reads it)."""
        cfg = self.cfg
        with self._tp(batch["tokens"].shape[-1]):
            x = embed_tokens(cfg, subtree(params, "embed."),
                             batch["tokens"])
            cache: Tree = {}
            for i, lp in enumerate(unstack(params, "layers.",
                                           cfg.n_layers)):
                x, st = self._layer_seq(lp, x, self._zero_layer_state(
                    lp, x.shape[0], x.device))
                st["tm_prev"] = tp.embed_part(st["tm_prev"], cfg.d_model)
                st["cm_prev"] = tp.embed_part(st["cm_prev"], cfg.d_model)
                for k, v in st.items():
                    store_layer(cache, k, i, v, cfg.n_layers)
            return self._head(params, x), cache
