"""The JAX package's single-device jitted train step on the port's batches,
for the port's multi-rank tests: (its initial weights as a flat numpy tree,
its trajectory of (loss, grad_norm))."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamW
from repro.runtime.train_loop import (ParallelPlan as JaxPlan,
                                      build_train_step as jax_build,
                                      init_train_state as jax_init)
from repro_torch.interop import flatten_tree

import _torch_ranks as ranks


def reference(arch: str, overrides: dict, plan: dict, steps: int = ranks.STEPS
              ) -> tuple[dict, np.ndarray]:
    jm = JaxModel(jax_get_config(arch).reduced(**overrides), jnp.float32)
    jplan = JaxPlan(**plan)
    jopt = JaxAdamW(lr=ranks.LR)
    state = jax_init(jm, jax.random.PRNGKey(0), jopt, jplan)
    weights = flatten_tree(jax.tree.map(np.asarray, state["params"]))
    step = jax.jit(jax_build(jm, jopt, jplan))
    out = []
    for b in ranks.batches(jm.cfg.vocab_size, steps, ranks.config(arch, overrides)):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return weights, np.array(out)
