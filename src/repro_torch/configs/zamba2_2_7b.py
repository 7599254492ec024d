"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block.

Held against ``repro.configs.zamba2_2_7b``; ``models.hybrid.HybridLM``
builds it.

Assigned spec: 54L, d_model=2560, 32 heads (GQA kv=32), d_ff=10240,
vocab=32000, ssm_state=64; Mamba2 layers with a single *shared*
attention+MLP block interleaved (arXiv:2411.15242).

The shared block runs every 6 Mamba2 layers (9 call sites over 54
layers), with its weights reused at every call site — gradients from all
call sites sum into the one shared block, which matters for the LTFL
quantization path.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp_act="silu",
    glu=True,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    source="[arXiv:2411.15242]",
)
