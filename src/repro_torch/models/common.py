"""Declarative parameter specs + the universal ModelConfig (PyTorch port).

A copy of ``repro/models/common.py`` without JAX: parameters are declared as
a nested dict of :class:`Spec` leaves (shape + logical axes + initializer),
from which the port derives parameter counts and, when real tensors are
wanted, an initialized tree drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.core.expertplan import round_experts, validate_experts


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    scale: float | None = None    # stddev override
    dtype: Any = None             # None -> the caller's default dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"Spec rank mismatch: {self.shape} vs {self.axes}")


def is_spec(x: Any) -> bool:
    return isinstance(x, Spec)


def spec_tree_map(fn: Callable[[Spec], Any], specs: Any) -> Any:
    """Map ``fn`` over the Spec leaves of a nested dict."""
    if is_spec(specs):
        return fn(specs)
    return {k: spec_tree_map(fn, v) for k, v in specs.items()}


def flatten_specs(specs: Any, prefix: str = "") -> Iterator[tuple[str, Spec]]:
    """(dotted path, Spec) pairs in sorted-key order — the JAX pytree order,
    and the naming of the port's state_dict keys."""
    if is_spec(specs):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from flatten_specs(specs[k], f"{prefix}.{k}" if prefix else k)


def param_count(specs: Any) -> int:
    return int(sum(np.prod(s.shape) for _, s in flatten_specs(specs)))


# the most elements a leaf draws in one fp32 piece: a larger leaf draws one
# slice of its leading dims at a time into its storage dtype, so the
# transient fp32 buffer stays at 4 GiB (qwen3-32b's stacked (64, 5120,
# 25600) MLP leaf would take 33.5 GB whole); smaller leaves draw whole, as
# they always did
INIT_PIECE = 1 << 30


def _pieces(shape: tuple[int, ...]) -> int:
    """How many leading dims :func:`init_leaf` iterates over: the fewest
    that bring a piece under ``INIT_PIECE`` elements."""
    k = 0
    while k < len(shape) - 1 and int(np.prod(shape[k:])) > INIT_PIECE:
        k += 1
    return k


def init_leaf(spec: Spec, generator: torch.Generator | None,
              device: torch.device | str, dtype: torch.dtype,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The init rules of ``repro/models/common.py:_init_leaf``: fan-in std
    on the second-to-last dim, ``ones``, ``zeros`` and ``embed`` (std 1).
    The draws come from ``generator`` (torch's stream, not Threefry), in
    fp32, whole or (past ``INIT_PIECE`` elements) a slice of the leading
    dims at a time, each cast to the storage dtype.  ``out``, if given,
    takes the leaf in place (a tensor of its shape)."""
    dtype = spec.dtype or dtype
    if spec.init in ("normal", "embed", "scaled"):
        if spec.scale is not None:
            std = spec.scale
        elif spec.init == "embed":
            std = 1.0
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1.0 / np.sqrt(max(fan_in, 1))
        k = _pieces(spec.shape)
        if out is None:
            out = torch.empty(spec.shape, dtype=dtype, device=device)
        for idx in np.ndindex(*spec.shape[:k]):
            x = torch.randn(spec.shape[k:], generator=generator, device=device,
                            dtype=torch.float32)
            out[idx].copy_(x.mul_(std))
        return out
    if spec.init == "zeros":
        return (torch.zeros(spec.shape, dtype=dtype, device=device) if out is None
                else out.zero_())
    if spec.init == "ones":
        return (torch.ones(spec.shape, dtype=dtype, device=device) if out is None
                else out.fill_(1))
    if spec.init == "arange_neg":
        n = spec.shape[-1] if spec.shape else 1
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device)).expand(spec.shape)
        return base.to(dtype).clone() if out is None else out.copy_(base)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs: Any, generator: torch.Generator | None,
                device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> Any:
    """A nested dict of initialized tensors with the shape of ``specs``;
    leaves draw from ``generator`` one after another in sorted-key order."""
    flat = {path: init_leaf(s, generator, device, dtype)
            for path, s in flatten_specs(specs)}

    def rebuild(tree: Any, prefix: str) -> Any:
        if is_spec(tree):
            return flat[prefix]
        return {k: rebuild(v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    return rebuild(specs, "")


# ---------------------------------------------------------------------------
# ModelConfig — one dataclass covering every assigned architecture family.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None

    # attention flavour
    qk_norm: bool = False
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    pos: str = "rope"           # rope | learned | none
    max_position: int = 1 << 20

    # block flavour
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False
    moe_dense_residual: bool = False
    dense_d_ff: int = 0

    # SSM / RWKV / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    hybrid_attn_every: int = 0

    # encoder-decoder
    enc_layers: int = 0
    enc_seq_len: int = 1024

    # multimodal frontends
    frontend: str | None = None
    num_patches: int = 256
    frontend_dim: int = 0

    use_flash: bool = False
    kv_quant: bool = False

    # numerics
    rms_eps: float = 1e-5
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def reduced(self, *, ep: int = 1, **overrides: Any) -> "ModelConfig":
        """Smoke-test variant: same family/flavours, tiny dims (the same
        rule as ``repro.models.common.ModelConfig.reduced``)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads, 2))
        base = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=d_model // n_heads,
            n_experts=(round_experts(min(self.n_experts, 4), ep)
                       if self.n_experts and ep > 1
                       else min(self.n_experts, 4)),
            top_k=min(self.top_k, 2),
            dense_d_ff=min(self.dense_d_ff, 256) if self.dense_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq_len=min(self.enc_seq_len, 32),
            hybrid_attn_every=min(self.hybrid_attn_every, 2) if self.hybrid_attn_every else 0,
            num_patches=min(self.num_patches, 8),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
        )
        base.update(overrides)
        if ep > 1 and base["n_experts"]:
            validate_experts(base["n_experts"], ep,
                             where=f"{self.name}.reduced(ep={ep})")
        return dataclasses.replace(self, **base)
