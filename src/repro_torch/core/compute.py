"""ComputePolicy: the compute-path knobs (a copy of ``repro/core/compute.py``).

  * ``remat`` — what a training step saves for the backward pass:
      - ``"full"`` — every layer body runs under
        ``torch.utils.checkpoint`` (non-reentrant): only layer boundaries
        are saved and everything inside is recomputed in the backward;
      - ``"selective"`` — the same checkpoint with a selective policy
        (``torch.utils.checkpoint.create_selective_checkpoint_contexts``)
        that saves what the reference's
        ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves:
        the outputs of the products without batch dims (the q/k/v/o
        projections, the MLP's plain products, ``in_proj``/``out_proj``,
        rwkv's projections, LoRA and channel-mix products); everything else
        is recomputed (:func:`save_policy`);
      - ``"none"`` — every intermediate is saved.
    The plain attention's query-chunk loop and the plain cross-entropy's
    token chunks stay checkpointed whatever ``remat`` says: their recompute
    is what keeps the scores and the (N, V) logits from being saved.  The
    scan chunk bodies take the policy's own wrapper, as in the reference.
    A checkpoint nests inside a selective one (non-reentrant).  Serving
    runs under ``torch.no_grad`` and checkpoints nothing.
  * ``kernels`` — route the norms, the MLP input half (SwiGLU gate or
    GELU), self-attention (forward and backward), the cross-entropy and the
    grouped expert MLPs through the hand-written CUDA kernels in
    ``repro_torch.kernels`` (their plain PyTorch versions on CPU tensors)
    instead of the plain layers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

REMAT_MODES = ("full", "selective", "none")

_aten = torch.ops.aten
_kernel_depth = 0            # > 0 inside a hand-written kernel's forward


def kernel_forward(forward: Callable) -> Callable:
    """Marks the forward of a kernel's ``torch.autograd.Function``: what it
    computes is one hand-written kernel (its plain version on a CPU tensor),
    which the selective policy recomputes and never saves, as a
    ``pallas_call`` is not a ``dot_general`` to the reference's policy."""
    @functools.wraps(forward)
    def wrapped(*args, **kwargs):
        global _kernel_depth
        _kernel_depth += 1
        try:
            return forward(*args, **kwargs)
        finally:
            _kernel_depth -= 1
    return wrapped


def _product_without_batch_dims(op, args) -> bool:
    """A product ``x @ W`` by a weight: ``aten.mm`` (matmul folds a 3-D
    ``x`` into rows when ``W`` takes a gradient), or ``aten.bmm`` of a 2-D
    weight that matmul broadcast over the batch (batch stride 0).  A bmm of
    batch 1 is not taken for one: torch.einsum lowers a product without
    batch dims to it, but also a batched one whose batch is 1 (the scans'
    einsums at one row), so the port writes its projections with ``@``."""
    if op is _aten.mm.default:
        return True
    if op is _aten.bmm.default:
        a, b = args[0], args[1]
        return a.stride(0) == 0 or b.stride(0) == 0
    return False


def save_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective checkpoint's policy: save the outputs of the products
    without batch dims outside the hand-written kernels, recompute every
    other op (norms, activations, the attention's batched products, the
    collectives: ZeRO 3's gathers run again in the recompute)."""
    if _kernel_depth == 0 and _product_without_batch_dims(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, *, selective: bool = False) -> Callable:
    """``fn`` recomputed in the backward (non-reentrant checkpoint) when a
    gradient is being recorded; called as it is otherwise.  ``selective``
    keeps what :func:`save_policy` saves (looked up at each call).  The
    port's forward draws no random numbers, so the RNG state is not
    stashed."""
    extra = ({"context_fn": lambda: create_selective_checkpoint_contexts(save_policy)}
             if selective else {})

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, **extra, **kwargs)
    return wrapped


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    remat: str = "full"        # full | selective | none
    kernels: bool = False      # hand-written CUDA kernels on the hot path

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")

    def checkpoint(self, fn: Callable) -> Callable:
        """The remat wrapper of a layer body."""
        if self.remat == "none":
            return fn
        return checkpointed(fn, selective=self.remat == "selective")


DEFAULT_POLICY = ComputePolicy()


def resolve(policy: ComputePolicy | None) -> ComputePolicy:
    """None -> the default (full remat, plain compute path)."""
    return DEFAULT_POLICY if policy is None else policy


# ---------------------------------------------------------------------------
# Analytic activation-memory estimate (the paper's Table III axis): what each
# remat mode saves per layer for the backward pass, per device.  The dry run
# puts it beside the traced peak.
# ---------------------------------------------------------------------------

def activation_bytes_estimate(cfg: Any, global_batch: int, seq_len: int,
                              policy: ComputePolicy, *,
                              dp: int = 1, tp: int = 1, pp: int = 1,
                              gas: int = 1, dtype_bytes: int = 2) -> int:
    """Per-device bytes of saved (not recomputed) activations for one
    microbatch's backward through the layer stack.

    Counts only the dominant per-layer tensors of a dense block; attention
    score matrices are excluded (the flash and chunked formulations never
    save them).  MoE/SSM/RWKV stacks reuse the dense estimate of their
    matmul skeleton: a lower bound, labelled as such by the caller.
    """
    tokens = (global_batch // max(dp * gas, 1)) * seq_len  # per-device microbatch
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    q_cols = cfg.n_heads * hd
    kv_cols = cfg.n_kv_heads * hd
    ff = cfg.d_ff
    layers_local = cfg.n_layers // max(pp, 1)

    boundary = d                                   # the layer's input (x)
    # matmul outputs inside one block: q, k, v, attn-out, o-proj,
    # w1/w3 gate halves, w2 out
    dots = (q_cols + 2 * kv_cols + q_cols + d) + (2 * ff + d)
    # elementwise/norm chains saved only under remat="none": the two norm
    # outputs feeding the projections plus the silu*gate product
    elementwise = 2 * d + ff

    if policy.remat == "full":
        per_layer = boundary
    elif policy.remat == "selective":
        per_layer = boundary + dots
    else:
        per_layer = boundary + dots + elementwise
    # TP shards the head/mlp dims of the saved dots
    sharded = boundary + (per_layer - boundary) / max(tp, 1)
    return int(tokens * sharded * layers_local * dtype_bytes)
