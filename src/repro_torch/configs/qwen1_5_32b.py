"""qwen1.5-32b — dense decoder LM with QKV bias.

Held against ``repro.configs.qwen1_5_32b``.

Assigned spec: 64L, d_model=5120, 40 heads (GQA kv=40, i.e. MHA),
d_ff=27392, vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_act="silu",
    glu=True,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen1.5-0.5B]",
)
