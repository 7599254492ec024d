"""phi-3-vision-4.2b — VLM: phi3-mini LM backbone + CLIP vision (stubbed).

Held against ``repro.configs.phi_3_vision_4_2b``.

Assigned spec: 32L, d_model=3072, 32 heads (GQA kv=32), d_ff=8192,
vocab=32064.  [hf:microsoft/Phi-3-vision-128k-instruct]

The ViT/CLIP vision encoder + projector is a STUB per the assignment
carve-out: ``input_specs`` provides pre-projected patch embeddings
(batch, num_image_tokens, d_model) that the LM backbone prepends to the
text token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_act="silu",
    glu=True,
    rope_theta=10_000.0,
    num_image_tokens=576,      # stub 24x24 patch grid from the vision tower
    source="[hf:microsoft/Phi-3-vision-128k-instruct]",
)
