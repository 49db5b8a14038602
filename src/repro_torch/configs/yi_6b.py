"""yi-6b — llama-architecture dense GQA decoder.

[arXiv:2403.04652] 32 layers, d_model=4096, 32 heads (GQA kv=4),
d_ff=11008, vocab=64000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)
