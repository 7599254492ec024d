"""olmoe-1b-7b — fully open MoE, 64 experts top-8, no shared experts.

Held against ``repro.configs.olmoe_1b_7b``.

Assigned spec: 16L, d_model=2048, 16 heads (GQA kv=16), expert d_ff=1024,
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp_act="silu",
    glu=True,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_expert=1024,
    ),
    source="[arXiv:2409.02060]",
)
