"""rwkv6-1.6b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 24 layers, d_model=2048, head_dim=64 (32 heads),
channel-mix d_ff=7168, vocab=65536.  No KV cache: decode carries a
per-layer (H, 64, 64) wkv state — O(1) in sequence length.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pos="none",
)
