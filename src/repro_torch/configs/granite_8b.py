"""granite-8b — llama-architecture dense code model.

Held against ``repro.configs.granite_8b``. Published spec: 36 layers,
d_model 4096, 32 heads (GQA, 8 KV heads), d_ff 14336, vocab 49152,
SwiGLU, RMSNorm, rope_theta 1e7, untied head.  [arXiv:2405.04324]

``LONG_CONTEXT_VARIANT`` swaps in a 4096-token sliding window so the
long_500k decode shape becomes sub-quadratic; every other shape uses the
faithful full-attention config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    mlp_act="silu",
    glu=True,
    rope_theta=10_000_000.0,
    source="[arXiv:2405.04324]",
)

# Sliding-window variant used ONLY for long_500k (beyond-paper enablement).
LONG_CONTEXT_VARIANT = CONFIG.replace(sliding_window=4096)
