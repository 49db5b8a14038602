"""internvl2-2b — VLM: InternViT (stub) + InternLM2-like decoder.

[arXiv:2404.16821] Backbone: 24 layers, d_model=2048, 16 heads (GQA kv=8),
d_ff=8192, vocab=92553.  The vision encoder + projector frontend is a STUB:
``patches`` inputs carry precomputed patch embeddings (InternViT d=1024).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_dim=1024,
    num_patches=256,
)
