"""mistral-large-123b — dense decoder LM.

Held against ``repro.configs.mistral_large_123b``.

Assigned spec: 88L, d_model=12288, 96 heads (GQA kv=8), d_ff=28672,
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]

Like nemotron-4-340b, per-client full grads (246 GB bf16) exceed per-pod
replication limits => FL clients on the 'pod' axis only.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    mlp_act="silu",
    glu=True,
    rope_theta=1_000_000.0,
    fl_clients_on_pod_only=True,
    source="[hf:mistralai/Mistral-Large-Instruct-2407]",
)
