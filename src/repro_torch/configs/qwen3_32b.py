"""qwen3-32b — dense GQA decoder with qk-norm.

[hf:Qwen/Qwen3 family] 64 layers, d_model=5120, 64 heads (GQA kv=8,
head_dim=128), d_ff=25600, vocab=151936, qk_norm.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,             # 64 heads x 128 > d_model, as in qwen3
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
