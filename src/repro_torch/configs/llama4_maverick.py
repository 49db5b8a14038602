"""llama4-maverick-400b-a17b — MoE decoder, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E family] 48 layers, d_model=5120,
40 heads (GQA kv=8), expert d_ff=8192, vocab=202048, 128 experts top-1
with a shared expert, MoE interleaved every 2nd layer (llama4 style) —
which is what makes the model 400B-total / ~17B-active.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    dense_d_ff=8192,
)
