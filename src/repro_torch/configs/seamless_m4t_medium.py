"""seamless-m4t-medium — enc-dec multimodal (audio) transformer backbone.

[arXiv:2308.11596] SeamlessM4T-medium: 12 encoder + 12 decoder layers,
d_model=1024, 16 heads (GQA kv=16, i.e. MHA), d_ff=4096, vocab=256206.
Per the brief the mel-spectrogram + conv feature frontend is a STUB: the
model consumes precomputed frame embeddings via ``frames`` inputs.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,              # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    act="gelu",
    pos="rope",               # stand-in for seamless' relative positions (DESIGN.md)
    frontend="audio",
    frontend_dim=512,         # stubbed conv feature dim
    enc_seq_len=1024,         # audio frames per utterance
)
