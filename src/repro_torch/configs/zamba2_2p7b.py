"""zamba2-2.7b — hybrid: Mamba2 backbone + one shared attention block.

[arXiv:2411.15242] 54 Mamba2 layers, d_model=2560, shared attention block
(32 heads, kv=32) + MLP (d_ff=10240) applied every 6 layers with tied
weights; ssm_state=64.  (Per-invocation LoRA on the shared block is
omitted — DESIGN.md §2.)
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,
)
