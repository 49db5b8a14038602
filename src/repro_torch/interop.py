"""Carry weights from the JAX package's parameter pytree into the port.

The caller converts the JAX tree to numpy on its side (``np.asarray`` per
leaf), so this module never sees a JAX type.  Keys are the pytree paths
joined by dots, which are the port's state_dict keys.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {dotted path: array}."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def from_jax_params(tree: Any, model: nn.Module) -> dict[str, torch.Tensor]:
    """A state_dict for ``model`` from a numpy tree (nested or flat with
    dotted keys).  Strict: every leaf of the tree and every parameter of the
    model must be matched, with equal shapes; anything else raises."""
    flat = flatten_tree(tree)
    expected = model.state_dict()
    missing = sorted(expected.keys() - flat.keys())
    unused = sorted(flat.keys() - expected.keys())
    if missing or unused:
        raise KeyError(f"parameter trees differ: missing {missing}, unused {unused}")
    out = {}
    for key, ref in expected.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(ref.shape)}")
        if arr.dtype.name == "bfloat16":        # ml_dtypes; torch reads fp32
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr)).to(
            device=ref.device, dtype=ref.dtype)
    return out
