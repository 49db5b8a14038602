"""Architecture registry (a copy of the JAX package's): 10 assigned archs + the paper's GPT family."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1p6b",
    # the paper's own models (Table I)
    "gpt-1.4b": "repro_torch.configs.gpt_paper",
    "gpt-22b": "repro_torch.configs.gpt_paper",
    "gpt-175b": "repro_torch.configs.gpt_paper",
    "gpt-1t": "repro_torch.configs.gpt_paper",
}

ASSIGNED = [k for k in _MODULES if not k.startswith("gpt-")]
PAPER = [k for k in _MODULES if k.startswith("gpt-")]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    if name.startswith("gpt-"):
        return mod.CONFIGS[name]
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {name: get_config(name) for name in _MODULES}
