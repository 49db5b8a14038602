"""Assigned input shapes and the per-architecture applicability rule (a
copy of ``repro/configs/shapes.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason).  Long-context decode needs a sub-quadratic or
    bounded-memory attention path (SSM, hybrid, RWKV, sliding window)."""
    if shape.name == "long_500k":
        if cfg.family in ("rwkv", "hybrid"):
            return True, "O(1)-state recurrent path"
        if cfg.sliding_window is not None:
            return True, f"sliding-window attention (window={cfg.sliding_window})"
        return False, ("full-attention architecture without a sub-quadratic "
                       "variant; long_500k skipped per DESIGN.md §4")
    return True, "ok"
