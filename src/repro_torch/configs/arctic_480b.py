"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + parallel dense residual.

[hf:Snowflake/snowflake-arctic-base] 35 layers, d_model=7168, 56 heads
(GQA kv=8), expert d_ff=4864, vocab=32000, top-2 of 128 experts with a
dense residual MLP in parallel.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_d_ff=4864,
)
