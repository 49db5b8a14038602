"""The single-device training step (the pp = dp = tp = 1 path of
``repro/runtime/train_loop.py``).

``ParallelPlan`` carries the reference's dp/tp/pp/zero/ep/node/qcomm
fields; this slice runs the single-device point of the plan space: ``gas`` gradient-accumulation
microbatches, ``precision`` (bf16 | fp16 | fp32 compute over fp32 master
weights), and the compute policy (``remat``, ``kernels``).  Any other value
of a parallel field raises, naming ROADMAP.md.

``build_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: each microbatch's scaled loss is backpropagated and the
gradients sum in fp32 in the parameters' ``.grad``; then they are divided
by ``gas`` and unscaled in place, checked for finiteness, their global
norm taken, AdamW applied in place (skipped when not finite), and the loss
scale updated.  The metrics are the reference's: loss (the mean CE over the
microbatches), moe_aux, moe_drop (0 for the dense family), grad_norm,
grads_finite and loss_scale, as 0-d tensors on the device.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.core.compute import DEFAULT_POLICY, ComputePolicy
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm

# field -> the only value this slice runs
_SINGLE_DEVICE = {"dp": 1, "tp": 1, "pp": 1, "zero": None, "ep": 1, "node": 1,
                  "qcomm": "none"}


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One point of the paper's plan space; the port runs its single-device
    corner (see the module docstring)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    zero: int | None = None
    ep: int = 1
    node: int = 1
    qcomm: str = "none"
    gas: int = 1                    # gradient accumulation steps
    precision: str = "bf16"         # bf16 | fp16 | fp32
    remat: str = "full"             # full | none (selective: ROADMAP)
    kernels: bool = False           # hand-written CUDA kernels

    def __post_init__(self):
        for name, only in _SINGLE_DEVICE.items():
            if getattr(self, name) != only:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: the parallel executor is "
                    "not ported yet (see ROADMAP.md, Queue 1); this port trains "
                    "on one device")
        if self.gas < 1:
            raise ValueError(f"gas must be >= 1, got {self.gas}")
        prec.policy_from_name(self.precision)           # validates
        if self.remat == "selective":
            raise NotImplementedError(
                "remat='selective' is not ported yet (see ROADMAP.md, Queue 1)")
        if self.kernels and self.precision == "fp16":
            raise NotImplementedError(
                "the CUDA kernels take bf16 and fp32; fp16 kernels are not "
                "ported yet (see ROADMAP.md, Queue 2)")
        self.compute_policy()                           # validates remat

    def compute_policy(self) -> ComputePolicy:
        return ComputePolicy(remat=self.remat, kernels=self.kernels)


def init_train_state(model: Model, opt_cfg: AdamWConfig, plan: ParallelPlan,
                     generator: torch.Generator | None = None) -> dict:
    """The train state over ``model``'s own parameters (drawn from
    ``generator`` when one is given): {"params": {name: Parameter}, "opt",
    "loss_scale", "step"}.  Parameters get ``requires_grad``."""
    if generator is not None:
        model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw_init(params),
            "loss_scale": prec.init_loss_scale(plan.precision == "fp16",
                                               device=model.device),
            "step": 0}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor)
                else v).to(device) for k, v in batch.items()}


def build_train_step(model: Model, opt_cfg: AdamWConfig, plan: ParallelPlan):
    """Returns train_step(state, batch) -> (state, metrics); ``state`` is
    updated in place.  The step runs ``model``'s weights, which must be
    stored in the policy's fp32 master dtype, under the plan's compute policy
    and compute dtype through a view of the model (``Model.with_policy``):
    ``model`` itself keeps its own policy."""
    policy = prec.policy_from_name(plan.precision)
    if model.dtype != policy.param_dtype:
        raise ValueError(f"master weights must be stored in {policy.param_dtype}, "
                         f"the model stores {model.dtype}")
    compute = plan.compute_policy()
    if model.compute not in (DEFAULT_POLICY, compute):
        warnings.warn(
            f"model carries compute policy {model.compute} but the plan "
            f"specifies {compute}; the plan wins inside the step — set "
            f"remat/kernels on the ParallelPlan instead", stacklevel=2)
    model = model.with_policy(compute, policy.compute_dtype)
    gas = plan.gas

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        ls = state["loss_scale"]
        batch = _to_device(batch, model.device)
        B = batch["tokens"].shape[0]
        if B % gas:
            raise ValueError(f"global batch {B} is not a multiple of gas={gas}")
        for p in params.values():
            p.grad = None
        ce_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(gas):
            mb = {k: v[i * B // gas:(i + 1) * B // gas] for k, v in batch.items()}
            loss, metrics = model.loss(mb)
            prec.scale_loss(ls, loss).backward()
            ce_sum += metrics["ce"].detach()
        inv = 1.0 / ls["scale"]
        grads = {}
        for k, p in params.items():    # in place: (sum / gas) unscaled, fp32
            grads[k] = p.grad.div_(gas).mul_(inv)
        finite = prec.all_finite(grads.values())
        grad_norm = global_norm(grads.values())
        state["opt"] = adamw_update(opt_cfg, params, grads, state["opt"],
                                    skip=not bool(finite))
        state["loss_scale"] = prec.update_loss_scale(ls, finite)
        state["step"] += 1
        for p in params.values():
            p.grad = None
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        return state, {"loss": ce_sum / gas, "moe_aux": zero, "moe_drop": zero,
                       "grad_norm": grad_norm, "grads_finite": finite,
                       "loss_scale": state["loss_scale"]["scale"]}

    return train_step
