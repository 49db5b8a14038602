"""The vocab-parallel cross-entropy of a tensor-parallel model: the per-token
losses of hidden states against an lm_head whose vocab columns are split
over the ranks of a model group (Megatron's column-parallel lm_head).

Each rank takes its shard's (lse, label logit) (:func:`shard_terms`: the CE
kernel ``kernels/cross_entropy.py:cross_entropy_cuda``, or its plain
version on the CPU or under ``plain``); a label outside the shard takes the
stand-in column 0 and no label term, and a shard wholly in the vocab padding
(a local valid vocab of 0, which the kernel refuses) never calls the
kernel.  The ranks' lse are all-gathered and merged in fp32 by the kernel's
own second pass (:func:`merge_lse`, ``cross_entropy.merge_ref``); the
label logits are all-reduced (only the owning rank's is not 0).  The
backward is ``kernels/ref.py:cross_entropy_bwd_ref`` with the merged lse on
the local columns; the caller all-reduces dh over the group (the Megatron
operator in front of the product).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref
from repro_torch.runtime.collectives import all_gather_dim, all_reduce_


def _plain_chunks(h, w, labels, valid_vocab, chunk: int = 8192):
    """cross_entropy_ref over token chunks: the (N, V) fp32 logits never
    exist whole."""
    parts = [cross_entropy_ref(h[s:s + chunk], w, labels[s:s + chunk], valid_vocab)
             for s in range(0, h.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def shard_terms(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                valid_vocab: int, start: int, plain: bool = False):
    """One shard's part for h (N, d) against ``w`` (d, V_local), the vocab
    columns [start, start + V_local): (lse over its valid columns, -1e30 if
    none; the label logit where the label lies in the shard, else 0; the
    local labels, 0 outside; ``owned``, the rows whose label lies in the
    shard; the local valid vocab).  ``labels`` are global, columns at or past
    ``valid_vocab`` (a global index) masked."""
    vv = max(0, min(valid_vocab - start, w.shape[1]))
    local = labels.long() - start
    owned = (local >= 0) & (local < vv)
    local = torch.where(owned, local, torch.zeros_like(local))
    if vv == 0:                     # the shard is all padding
        lse = torch.full(labels.shape, ce.NEG_INF, dtype=torch.float32, device=h.device)
        ll = torch.zeros_like(lse)
    elif plain or h.device.type == "cpu":
        lse, ll = _plain_chunks(h, w, local, vv)
    else:
        lse, ll = ce.cross_entropy_cuda(h, w, local, vv)
    return lse, torch.where(owned, ll, torch.zeros_like(ll)), local, owned, vv


def merge_lse(lses: torch.Tensor) -> torch.Tensor:
    """The tokens' lse over the whole vocab from the shards' (tp, N), in
    shard order: the kernel's merge pass, an all-padding shard skipped."""
    return ce.merge_ref(lses, (lses > ce.NEG_INF).float())


class VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, valid_vocab, start, group, plain):
        lse, ll, local, owned, vv = shard_terms(h, w, labels, valid_vocab, start, plain)
        ll = all_reduce_(ll, group)
        lse = merge_lse(all_gather_dim(lse[None], 0, group))
        ctx.save_for_backward(h, w, local, owned, lse)
        ctx.valid_vocab = vv
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        h, w, local, owned, lse = ctx.saved_tensors
        dh, dw = cross_entropy_bwd_ref(h, w, local, lse, g, ctx.valid_vocab, owned=owned)
        return dh, dw, None, None, None, None, None


def vocab_parallel_tokens(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: int, start: int, group, plain: bool = False
                          ) -> torch.Tensor:
    """Per-token losses (N,) fp32 of h (N, d) against the vocab columns
    [start, start + w.shape[1]) that ``w`` (d, V_local) holds, merged over
    ``group``'s shards (see the module docstring)."""
    return VocabParallelCE.apply(h, w, labels, valid_vocab, start, group, plain)
