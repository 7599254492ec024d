"""deepseek-v2-lite-16b — MoE with multi-head latent attention (MLA).

Held against ``repro.configs.deepseek_v2_lite_16b``.

Assigned spec: 27L, d_model=2048, 16 heads (GQA kv=16), expert d_ff=1408,
vocab=102400; MLA kv_lora=512; MoE with shared + routed experts, top-6.
[arXiv:2405.04434]

The assignment line reads "MoE 64e top-6 ... 2 shared+160 routed top-6";
the published DeepSeek-V2-Lite card has 64 routed + 2 shared experts with
top-6 routing (160 routed belongs to full V2). We follow the "64e top-6"
grid entry + 2 shared experts, matching the Lite model. First layer uses a
dense FFN (d_ff 10944) per the paper.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,          # qk_nope (128) + qk_rope (64)
    d_ff=1408,             # routed expert hidden width
    vocab_size=102400,
    mlp_act="silu",
    glu=True,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        d_shared_expert=1408,
        first_k_dense=1,
        dense_d_ff=10944,
    ),
    source="[arXiv:2405.04434]",
)
