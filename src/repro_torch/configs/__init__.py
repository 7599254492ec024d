"""Configurations, held against ``repro.configs``: Table 2, the paper's
ResNet, and the architecture registry.

``ARCHS`` holds the reference's ten architectures, with granite-8b's
sliding-window variant in ``VARIANTS``; ``models.build_model`` builds
every one of them (the dense, MoE and VLM families, the SSM rwkv6-7b,
the hybrid zamba2-2.7b and the encoder-decoder whisper-medium).
``get_arch``, ``list_archs``, ``get_shape``, ``arch_for_shape`` (granite's
sliding-window variant for ``long_500k``), ``shape_applicable`` and
``reduce_for_smoke`` behave as the reference's; the dry-run shapes are
``TRAIN_4K``, ``PREFILL_32K``, ``DECODE_32K`` and ``LONG_500K``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    granite_8b,
    mistral_large_123b,
    nemotron_4_340b,
    olmoe_1b_7b,
    phi_3_vision_4_2b,
    qwen1_5_32b,
    rwkv6_7b,
    whisper_medium,
    zamba2_2_7b,
)
from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ArchConfig,
    LTFLConfig,
    MLAConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    WirelessConfig,
    shape_applicable,
)
from repro_torch.configs.ltfl_paper import (
    CONFIG,
    PaperExperimentConfig,
    ResNetConfig,
)

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        qwen1_5_32b.CONFIG,
        rwkv6_7b.CONFIG,
        deepseek_v2_lite_16b.CONFIG,
        nemotron_4_340b.CONFIG,
        granite_8b.CONFIG,
        whisper_medium.CONFIG,
        olmoe_1b_7b.CONFIG,
        zamba2_2_7b.CONFIG,
        phi_3_vision_4_2b.CONFIG,
        mistral_large_123b.CONFIG,
    )
}

# Named variants (not part of the architecture grid; used where documented).
VARIANTS: Dict[str, ArchConfig] = {
    "granite-8b-sw4096": granite_8b.LONG_CONTEXT_VARIANT,
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in VARIANTS:
        return VARIANTS[name]
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(ARCHS) + sorted(VARIANTS)}"
    )


def list_archs() -> List[str]:
    return sorted(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def arch_for_shape(arch: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """The documented per-shape variant: granite-8b runs ``long_500k``
    with its 4096-token sliding window."""
    if shape.name == "long_500k" and arch.name == "granite-8b":
        return VARIANTS["granite-8b-sw4096"]
    return arch


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests:
    2 layers, d_model<=512, <=4 experts, small vocab."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(d_model // n_heads, 8)
    kw = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 128),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_shared_expert=min(cfg.moe.d_shared_expert, 128),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=min(cfg.moe.dense_d_ff, 256),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=64,
            q_lora_rank=0,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        )
        kw["head_dim"] = 48  # nope + rope
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            state_dim=min(cfg.ssm.state_dim, 16),
            head_dim=min(cfg.ssm.head_dim, 32),
            expand=cfg.ssm.expand,
            conv_width=cfg.ssm.conv_width,
            chunk_size=16,
        )
        if cfg.name.startswith("rwkv"):
            # keep d_model divisible by rwkv head_dim
            kw["n_heads"] = d_model // min(cfg.ssm.head_dim, 32)
            kw["n_kv_heads"] = kw["n_heads"]
            kw["head_dim"] = min(cfg.ssm.head_dim, 32)
    if cfg.attn_every:
        kw["attn_every"] = 2  # 2 reduced layers -> one shared-block call
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if cfg.num_image_tokens:
        kw["num_image_tokens"] = 8
    return cfg.replace(**kw)


__all__ = [
    "ARCHS",
    "VARIANTS",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "ArchConfig",
    "ShapeConfig",
    "LTFLConfig",
    "WirelessConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ResNetConfig",
    "PaperExperimentConfig",
    "CONFIG",
    "get_arch",
    "list_archs",
    "get_shape",
    "arch_for_shape",
    "shape_applicable",
    "reduce_for_smoke",
]
