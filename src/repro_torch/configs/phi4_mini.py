"""phi4-mini-3.8b — dense decoder: RoPE, SwiGLU, GQA.

[arXiv:2412.08905] 32 layers, d_model=3072, 24 heads (GQA kv=8),
d_ff=8192, vocab=200064.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
)
