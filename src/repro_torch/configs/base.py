"""Configuration dataclasses: the architectures and input shapes the port
can build, and the LTFL paper system parameters (Table 2).

Held against ``repro.configs.base`` (``MoEConfig``, ``MLAConfig``,
``SSMConfig``, ``ArchConfig``, ``ShapeConfig``, ``WirelessConfig``,
``LTFLConfig``): the same fields, defaults, checks and parameter count,
so a configuration built on either side describes the same system.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# --------------------------------------------------------------------------- #
# Sub-configs for non-dense families
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int                 # routed experts
    top_k: int
    d_expert: int                    # hidden width of each routed expert
    num_shared_experts: int = 0      # always-on experts (DeepSeek style)
    d_shared_expert: int = 0         # hidden width of the shared expert(s)
    capacity_factor: float = 1.25    # dispatch capacity per expert
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01      # load-balance loss coefficient
    first_k_dense: int = 0           # leading layers that use a dense FFN
    dense_d_ff: int = 0              # width of those dense FFNs


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)."""

    kv_lora_rank: int                # latent c_KV width (paper: 512 for Lite)
    q_lora_rank: int = 0             # 0 => no query compression (Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / RWKV6 style recurrent-block configuration."""

    state_dim: int = 64              # N: per-head SSM state size
    head_dim: int = 64               # P: channels per head
    expand: int = 2                  # d_inner = expand * d_model
    conv_width: int = 4              # depthwise conv kernel (Mamba2)
    n_groups: int = 1                # B/C groups (Mamba2)
    chunk_size: int = 256            # chunked-scan block length


# --------------------------------------------------------------------------- #
# Architecture config
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ArchConfig:
    """A complete, buildable model architecture description."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                 # citation ([arXiv:...] / [hf:...])

    head_dim: int = 0                # 0 => d_model // n_heads
    qkv_bias: bool = False
    mlp_act: str = "silu"            # silu | relu2 | gelu
    glu: bool = True                 # gated (SwiGLU-style) FFN
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"            # rope | learned | none
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 => full attention

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (Zamba2): a single *shared* attention+MLP block invoked every
    # ``attn_every`` SSM layers (arXiv:2411.15242).
    attn_every: int = 0

    # encoder-decoder (Whisper): encoder depth and (stub) frame-sequence len.
    encoder_layers: int = 0
    encoder_seq: int = 0

    # vlm: number of stub image-patch embedding tokens prepended to the text.
    num_image_tokens: int = 0

    # FL/client mapping: True => per-client full grads do not fit per pod, so
    # the client axis is ('pod',) only and params/grads are sharded over
    # 'data' too (launch.sharding.policy_for).
    fl_clients_on_pod_only: bool = False

    # dtype of params/activations for sizing & dry-runs.
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}"
            )

    # ------------------------------------------------------------------ #
    @property
    def subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context (long_500k)?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def is_decoder_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter count (used for roofline MODEL_FLOPS = 6·N·D and for
    # the scale-aware client-axis policy).
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention (dense/moe/vlm/encdec; hybrid counts its shared block once)
        hd = self.head_dim
        if self.mla is not None:
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer += d * qdim                                   # W_q
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # W_dkv
            per_layer += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)                  # W_ukv
            per_layer += self.n_heads * m.v_head_dim * d            # W_o
        elif self.family in ("ssm", "hybrid"):
            pass  # per-layer mix handled below; hybrid's shared block is
            # counted once at the end (weights reused across call sites)
        else:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        # ffn
        if self.moe is not None:
            mo = self.moe
            n_e = mo.top_k if active_only else mo.num_experts
            ff_mult = 3 if self.glu else 2
            per_layer += n_e * mo.d_expert * d * ff_mult
            per_layer += mo.num_shared_experts * mo.d_shared_expert * d * ff_mult
            per_layer += d * mo.num_experts  # router
        elif self.family in ("ssm", "hybrid"):
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            if self.name.startswith("rwkv"):
                # time-mix: r,k,v,g,o projections + decay/first params
                per_layer += 5 * d * d + 2 * d
                per_layer += d * self.d_ff + self.d_ff * d + d * d  # channel mix
            else:
                n_heads_ssm = d_in // s.head_dim
                per_layer += d * (2 * d_in + 2 * s.n_groups * s.state_dim
                                  + n_heads_ssm)  # in_proj (x,z,B,C,dt)
                per_layer += d_in * d             # out_proj
        else:
            ff_mult = 3 if self.glu else 2
            per_layer += ff_mult * d * self.d_ff
        total = emb + L * per_layer
        if self.family == "hybrid" and self.attn_every > 0:
            # one shared attention+MLP block (weights reused at call sites)
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            ff = (3 if self.glu else 2) * d * self.d_ff
            total += q + kv + o + ff
        if self.family == "encdec":
            # encoder layers: self-attn + ffn; decoder adds cross-attn
            enc = self.encoder_layers * (
                4 * d * d + (3 if self.glu else 2) * d * self.d_ff)
            total += enc + L * 4 * d * d  # decoder cross-attn
        return int(total)


# --------------------------------------------------------------------------- #
# Input shapes
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """Whether (arch, shape) is part of the dry-run grid, and why not."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch.name} is full-attention (family={arch.family})"
        )
    return True, ""


# --------------------------------------------------------------------------- #
# LTFL paper system parameters (Table 2)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class WirelessConfig:
    """Wireless/PHY + device parameters, exactly the paper's Table 2.

    Notes:
      * N0 = -174 dBm/Hz = 3.98e-21 W/Hz.
      * The waterfall threshold is listed as "0.023dB" in Table 2; the
        PER formula (Eq. 3) uses it as a linear factor, and 0.023 linear
        reproduces sensible packet error rates (~1-10%), so it is linear.
      * f_u ~ U[30, 110] MHz and c0 = 2.7e8 cycles/sample are the paper's
        values verbatim.
    """

    p_max: float = 0.1               # W
    p_min: float = 0.01              # W
    bandwidth_ul: float = 10e6       # Hz (B_u^UL)
    n0: float = 3.98e-21             # W/Hz (-174 dBm/Hz)
    waterfall: float = 0.023         # Upsilon (linear, see note)
    fading_scale: float = 0.015      # E[varpi_u] Rayleigh scale
    dist_min: float = 100.0          # m, d_u ~ U[100, 300]
    dist_max: float = 300.0
    interference_min: float = 1e-8   # W, I_u ~ U[1e-8, 2e-8]
    interference_max: float = 2e-8
    cpu_min: float = 30e6            # Hz, f_u ~ U[30, 110] MHz
    cpu_max: float = 110e6
    cycles_per_sample: float = 2.7e8 # c0
    k_eff: float = 1.25e-26          # k (effective switched capacitance)
    sigma_exp: float = 3.0           # sigma in E = k f^sigma T


@dataclass(frozen=True)
class LTFLConfig:
    """Controller + FL-round configuration (problem P1, Algorithm 1)."""

    num_devices: int = 30            # U
    samples_min: int = 400           # N_u ~ U[400, 600]
    samples_max: int = 600
    rho_max: float = 0.5             # rho^max
    delta_max: int = 8               # delta^max (bits)
    xi_bits: int = 64                # xi: bits for (min, max, sign block)
    t_max: float = 3000.0            # T^max per round
    e_max: float = 10.0              # E^max per device per round
    server_delay: float = 1.0        # s (Eq. 33)
    learning_rate: float = 0.05      # eta
    # Algorithm 1 / Bayesian optimization
    bo_iters: int = 24               # M^max
    bo_xi: float = 0.01              # PI acquisition offset (Eq. 53)
    alt_max_iters: int = 8           # outer alternation cap
    alt_tol: float = 1e-3            # convergence criterion (Eq. 57)
    # Theorem-1 constants (Assumptions 1-4)
    lipschitz: float = 1.0           # L
    d_sq: float = 1.0                # D^2 (second-moment bound)
    v1: float = 1.0                  # v1 (Assumption 4)
    v2: float = 1.0 / 24.0           # v2 < 1/12 so (1 - 12 v2) > 0
    seed: int = 0
    wireless: WirelessConfig = field(default_factory=WirelessConfig)

    def __post_init__(self):
        if not 0.0 <= self.rho_max <= 1.0:
            raise ValueError("rho_max must be in [0, 1]")
        if self.v2 >= 1.0 / 12.0:
            raise ValueError("Theorem 1 requires v2 < 1/12")
