"""The paper's own GPT-style models (Table I): 1.4B / 22B / 175B / 1T.

#Layers / hidden / heads per Table I; params ~= 12 L d^2 (paper's formula).
Table I lists hidden=2114 for the 1.4B model, which is not divisible by its
24 heads; we use 2112 (=24x88) and note the 0.1% delta. GELU 4d FFN,
LayerNorm, MHA — GPT-3 style.
"""
from repro_torch.models.common import ModelConfig


def _gpt(name, n_layers, d_model, n_heads):
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=4 * d_model,
        vocab_size=51200,
        norm="layernorm",
        act="gelu",
    )


CONFIGS = {
    "gpt-1.4b": _gpt("gpt-1.4b", 24, 2112, 24),
    "gpt-22b": _gpt("gpt-22b", 48, 6144, 48),
    "gpt-175b": _gpt("gpt-175b", 96, 12288, 96),
    "gpt-1t": _gpt("gpt-1t", 128, 25600, 128),
}
