"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

Held against ``repro.configs.rwkv6_7b``; ``models.rwkv6.RWKVLM`` builds
it.

Assigned spec: 32L, d_model=4096, attention-free, d_ff=14336, vocab=65536.
Data-dependent decay per-channel per-step (arXiv:2404.05892).

RWKV6 uses head_dim=64 time-mix heads => 64 heads at d_model=4096. The
channel-mix FFN uses squared-ReLU keys (no gating).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # time-mix heads (head_dim 64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mlp_act="relu2",
    glu=False,
    pos_emb="none",        # recurrence encodes position
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=256),
    source="[arXiv:2404.05892]",
)
