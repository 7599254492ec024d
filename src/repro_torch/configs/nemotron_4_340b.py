"""nemotron-4-340b — dense decoder LM with GQA and squared-ReLU MLP.

Held against ``repro.configs.nemotron_4_340b``.

Assigned spec: 96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728,
vocab=256000, squared-ReLU (no gating).  [arXiv:2402.16819]

Per-client full gradients (680 GB bf16) cannot be replicated 16x per pod,
so FL clients live on the 'pod' axis only (the reference's mesh layout).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_act="relu2",
    glu=False,
    rope_theta=10_000.0,
    fl_clients_on_pod_only=True,
    source="[arXiv:2402.16819]",
)
