"""whisper-medium — encoder-decoder audio backbone (conv frontend stubbed).

Held against ``repro.configs.whisper_medium``; ``models.encdec.EncDecLM``
builds it.

Assigned spec: 24L (decoder; encoder matched at 24L), d_model=1024,
16 heads (kv=16), d_ff=4096, vocab=51865.  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: ``input_specs`` provides precomputed frame embeddings of shape
(batch, encoder_seq, d_model); the reference implements the transformer
backbone that consumes them (encoder self-attn stack + decoder with cross-attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,               # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_act="gelu",
    glu=False,
    norm="layernorm",
    pos_emb="learned",
    encoder_layers=24,
    encoder_seq=1500,          # 30 s of audio at 50 frames/s
    source="[arXiv:2212.04356]",
)
