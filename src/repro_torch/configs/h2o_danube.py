"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24 layers, d_model=2560, 32 heads (GQA kv=8),
d_ff=6912, vocab=32000, SWA window 4096 — the bounded KV cache is what
carries the long_500k decode shape.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
)
