"""Plain PyTorch versions of the ported kernels (``repro/kernels/ref.py``)
and of the backward formulas their ``torch.autograd.Function`` s use.

They are the CPU path of the kernel wrappers and the oracle that the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.compute import checkpointed


def _attention_mask(Sq: int, Skv: int, device, *, causal: bool,
                    sliding_window: int | None, q_offset: int):
    """(Sq, Skv) bool of the (query, key) pairs that attend, or None."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if sliding_window is not None:
        w = qpos[:, None] - kpos[None, :] < sliding_window
        mask = w if mask is None else mask & w
    return mask


def flash_attention_ref(
    q: torch.Tensor,   # (B, Hq, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Skv, hd)
    v: torch.Tensor,   # (B, Hkv, Skv, hd)
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Returns O in q's dtype (and, with ``return_lse``, the fp32 row
    log-sum-exp (B, Hq, Sq)); a row that sees no key gives 0."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = _attention_mask(Sq, Skv, q.device, causal=causal,
                           sliding_window=sliding_window, q_offset=q_offset)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # fully masked rows
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_ref(
    q: torch.Tensor,     # (B, Hq, Sq, hd)
    k: torch.Tensor,     # (B, Hkv, Skv, hd)
    v: torch.Tensor,     # (B, Hkv, Skv, hd)
    o: torch.Tensor,     # (B, Hq, Sq, hd)
    lse: torch.Tensor,   # (B, Hq, Sq) fp32
    do: torch.Tensor,    # (B, Hq, Sq, hd)
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    return_scales: bool = False,
):
    """(dq, dk, dv) in the inputs' dtypes by the algebra of
    ``repro/kernels/flash_attention.py:_bwd_dq_kernel``/``_bwd_dkv_kernel``,
    in fp32: P from the saved LSE, delta = rowsum(dO*O), dS = P*(dP - delta)
    (times 1 - t^2 under the softcap), dK/dV summed over each KV head's G
    query heads.  Masked pairs get p = 0 exactly.

    ``return_scales`` also returns the fp32 magnitudes |dS|@|K|*scale,
    |dS|^T@|Q|*scale and P^T@|dO| (at dq's, dk's and dv's shapes), by which
    a bf16 rounding of dS or P inside a kernel bounds its error, and the
    magnitudes C@|K|*scale and C^T@|Q|*scale (dq's and dk's shapes) with
    C = P*(|dO|@|V|^T + rowsum|dO*O|): dP - delta is a difference of two
    sums that cancel where dS is near 0 (the first causal row exactly), so
    another summation order moves dS by a share of C, not of |dS|."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(hd)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    kr = k32.repeat_interleave(G, dim=1) if G > 1 else k32
    vr = v32.repeat_interleave(G, dim=1) if G > 1 else v32
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kr) * scale
    tcap = None
    if softcap is not None:
        tcap = torch.tanh(s / softcap)
        s = tcap * softcap
    mask = _attention_mask(Sq, Skv, q.device, causal=causal,
                           sliding_window=sliding_window, q_offset=q_offset)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=q.device))
    delta = (do32 * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
    ds = p * (dp - delta[..., None])
    if tcap is not None:
        ds = ds * (1.0 - tcap * tcap)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)

    def group_sum(t):                 # (B, Hq, Skv, hd) -> (B, Hkv, Skv, hd)
        return t.reshape(B, Hkv, G, Skv, hd).sum(2)

    grads = (dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype))
    if not return_scales:
        return grads
    ads = ds.abs()
    del dp, ds
    scales = (torch.einsum("bhqk,bhkd->bhqd", ads, kr.abs()) * scale,
              group_sum(torch.einsum("bhqk,bhqd->bhkd", ads, q32.abs())) * scale,
              group_sum(torch.einsum("bhqk,bhqd->bhkd", p, do32.abs())))
    del ads
    c = p * (torch.einsum("bhqd,bhkd->bhqk", do32.abs(), vr.abs())
             + (do32 * o.float()).abs().sum(-1)[..., None])
    cancel = (torch.einsum("bhqk,bhkd->bhqd", c, kr.abs()) * scale,
              group_sum(torch.einsum("bhqk,bhqd->bhkd", c, q32.abs())) * scale)
    return grads, scales, cancel


def cross_entropy_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      valid_vocab: int | None = None):
    """Per-token (lse, label_logit) in fp32 from the materialized logits
    (``repro/kernels/ref.py:cross_entropy_ref`` before its mean): h (N, d),
    w (d, V), labels (N,); columns at or past ``valid_vocab`` are -1e30."""
    logits = h.float() @ w.float()
    V = logits.shape[-1]
    if valid_vocab is not None and valid_vocab < V:
        logits[:, valid_vocab:] = -1e30
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse, ll


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5):
    """(dx, dw) of RMSNorm in fp32 from the saved x and w
    (``repro/kernels/rmsnorm.py:_bwd``)."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    g32 = g.float().reshape(-1, d)
    w32 = w.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * inv
    gw = g32 * w32
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (g32 * xhat).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """fp32 mean, then the mean of squared deviations, rsqrt, scale and
    shift, cast to x's dtype (``repro/kernels/ref.py:layernorm_ref``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def layernorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5):
    """(dx, dw, db) of LayerNorm in fp32 from the saved x and w
    (``repro/kernels/layernorm.py:_bwd``); dw and db sum over the rows in
    fp32 and come back in w's dtype."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    g32 = g.float().reshape(-1, d)
    w32 = w.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    gw = g32 * w32
    dx = inv * (gw - gw.mean(dim=-1, keepdim=True)
                - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (g32 * xhat).sum(0)
    db = g32.sum(0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), db.to(w.dtype)


# the tanh approximation of GELU, with the reference's constants
# (``repro/kernels/gelu_mlp.py``)
SQRT_2_OVER_PI = 0.7978845608028654
GELU_C = 0.044715


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a)
    return 0.5 * a * (1.0 + torch.tanh(u))


def gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh(a)/da = 0.5 (1 + t) + 0.5 a (1 - t^2) du/da."""
    t = torch.tanh(SQRT_2_OVER_PI * (a + GELU_C * a * a * a))
    du = SQRT_2_OVER_PI * (1.0 + 3.0 * GELU_C * a * a)
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * du


def gelu_mlp_in_ref(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The MLP's input half gelu_tanh(x @ w1), the product and the GELU in
    fp32, cast to x's dtype (``repro/kernels/ref.py:gelu_mlp_in_ref``)."""
    return gelu_tanh(x.float() @ w1.float()).to(x.dtype)


def gelu_mlp_in_bwd_ref(x: torch.Tensor, w1: torch.Tensor, g: torch.Tensor):
    """(dx, dw1) of gelu_tanh(x @ w1) by an fp32 recompute of the product
    (``repro/kernels/gelu_mlp.py:_gelu_mlp_bwd``: the pre-activation is
    never saved); x (N, d)."""
    x32, w1_32, g32 = x.float(), w1.float(), g.float()
    da = g32 * gelu_tanh_grad(x32 @ w1_32)
    return (da @ w1_32.T).to(x.dtype), (x32.T @ da).to(w1.dtype)


def swiglu_ref(x: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor) -> torch.Tensor:
    """Fused gate: silu(x@w1) * (x@w3), the products in x's dtype."""
    a = x @ w1
    b = x @ w3
    return (F.silu(a.float()) * b.float()).to(x.dtype)


def swiglu_bwd_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   g: torch.Tensor):
    """(dx, dw1, dw3) of the SwiGLU gate by an fp32 recompute of both
    products (``repro/kernels/swiglu.py:_swiglu_bwd``); x (N, d)."""
    x32, w1_32, w3_32, g32 = x.float(), w1.float(), w3.float(), g.float()
    a = x32 @ w1_32
    b = x32 @ w3_32
    sig = torch.sigmoid(a)
    da = g32 * b * (sig * (1.0 + a * (1.0 - sig)))   # d silu(a)/da
    db = g32 * (a * sig)
    dx = da @ w1_32.T + db @ w3_32.T
    return (dx.to(x.dtype), (x32.T @ da).to(w1.dtype), (x32.T @ db).to(w3.dtype))


def cross_entropy_bwd_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                          lse: torch.Tensor, g: torch.Tensor,
                          valid_vocab: int | None = None, chunk: int | None = None,
                          owned: torch.Tensor | None = None):
    """(dh, dw) of the per-token losses lse - label_logit for the cotangent
    ``g`` (N,), by the reference's ``cross_entropy.py:_ce_tokens_bwd``:
    token chunks recompute fp32 logits and p = exp(logits - lse) from the
    saved lse, so the (N, V) logits never exist whole; dw sums in fp32.
    ``chunk`` rows per chunk (default: about 64 MB of fp32 logits).
    ``owned`` (N,) bool, for a vocab shard: the rows whose label lies in
    ``w``'s columns; the others take no label term (their ``labels`` must
    still index a column)."""
    N, d = h.shape
    V = w.shape[1]
    chunk = chunk or max(1, (1 << 24) // V)
    w32 = w.float()
    dw = torch.zeros((d, V), dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h)
    for s in range(0, N, chunk):
        hb = h[s:s + chunk].float()
        logits = hb @ w32
        if valid_vocab is not None and valid_vocab < V:
            logits[:, valid_vocab:] = -1e30
        dl = torch.exp(logits - lse[s:s + chunk, None])
        rows = torch.arange(hb.shape[0], device=h.device)
        one = 1.0 if owned is None else owned[s:s + chunk].float()
        dl[rows, labels[s:s + chunk].long()] -= one
        dl *= g[s:s + chunk, None].float()
        dh[s:s + chunk] = (dl @ w32.T).to(h.dtype)
        dw += hb.T @ dl
    return dh, dw.to(w.dtype)


def _expert_chunks(E: int, d: int, F: int):
    """Expert ranges holding about 256 MB of one fp32 (d, F) weight each, so
    the fp32 copies of a full-width expert stack never exist whole."""
    step = max(1, (1 << 26) // (d * F))
    return [slice(s, s + step) for s in range(0, E, step)]


def grouped_mlp_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
                    w2: torch.Tensor, mask: torch.Tensor,
                    act: str = "swiglu") -> torch.Tensor:
    """Grouped expert MLP (``repro/kernels/ref.py:grouped_mlp_ref``): x
    (E, N, d), w1/w3 (E, d, F), w2 (E, F, d), mask (E, N) -> (E, N, d) in
    x's dtype.  x is masked, both products and h are fp32, the output is
    masked; masked slots come out exactly zero."""
    E, N, d = x.shape
    out = torch.empty_like(x)
    for e in _expert_chunks(E, d, w1.shape[-1]):
        m = mask[e].float()[..., None]
        x32 = x[e].float() * m
        a = torch.bmm(x32, w1[e].float())
        if act == "swiglu":
            h = F.silu(a) * torch.bmm(x32, w3[e].float())
        else:
            h = gelu_tanh(a)
        out[e] = (torch.bmm(h, w2[e].float()) * m).to(x.dtype)
    return out


def grouped_mlp_bwd_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
                        w2: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                        act: str = "swiglu"):
    """(dx, dw1, dw3, dw2, dmask) of :func:`grouped_mlp_ref` for the
    cotangent ``g`` by an fp32 recompute of h
    (``repro/kernels/grouped_mlp.py:_grouped_bwd``): masked slots get a zero
    dx and add nothing to the weight gradients, the mask gets a zero
    cotangent, and dw3 is None for ``act="gelu"``."""
    m = mask.float()[..., None]
    x32 = x.float() * m
    w1_32, w2_32 = w1.float(), w2.float()
    g32 = g.float() * m
    a = torch.bmm(x32, w1_32)
    dh = torch.bmm(g32, w2_32.transpose(1, 2))
    if act == "swiglu":
        w3_32 = w3.float()
        b = torch.bmm(x32, w3_32)
        sig = torch.sigmoid(a)
        h = a * sig * b
        da = dh * b * (sig * (1.0 + a * (1.0 - sig)))
        db = dh * a * sig
    else:
        h = gelu_tanh(a)
        da = dh * gelu_tanh_grad(a)
    dw2 = torch.bmm(h.transpose(1, 2), g32)
    dx = torch.bmm(da, w1_32.transpose(1, 2))
    dw1 = torch.bmm(x32.transpose(1, 2), da)
    dw3 = None
    if act == "swiglu":
        dx = dx + torch.bmm(db, w3_32.transpose(1, 2))
        dw3 = torch.bmm(x32.transpose(1, 2), db).to(w3.dtype)
    return ((dx * m).to(x.dtype), dw1.to(w1.dtype), dw3, dw2.to(w2.dtype),
            torch.zeros_like(mask))


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 A_log: torch.Tensor, *, chunk: int, wrap=checkpointed):
    """Chunked mamba2 SSD scan (``repro/kernels/ref.py:ssd_scan_ref``, the
    plain path of ``models/ssm.py:_ssd_chunked``): fp32 algebra, zero
    initial state, the chunk body under ``wrap`` (a checkpoint, as the
    reference's ``jax.checkpoint``; identity to save everything).  Also the
    backward recompute of the SSD kernel's Function.

    x: (B, T, H, P); dt: (B, T, H); Bm/Cm: (B, T, N); A_log: (H,).
    Returns (y (B, T, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if chunk < 1 or T % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide T={T}")
    logA = -torch.exp(A_log.float())                       # (H,)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))

    def body(state, xc, dtc, Bc, Cc):
        xc32, dtc32 = xc.float(), dtc.float()
        Bc32, Cc32 = Bc.float(), Cc.float()
        la = dtc32 * logA                                  # (B, Q, H)
        cum = torch.cumsum(la, dim=1)                      # inclusive
        total = cum[:, -1]                                 # (B, H)
        # intra-chunk: W[b,i,j,h] = (C_i . B_j) exp(cum_i - cum_j) dt_j (j <= i);
        # the mask sits inside the exponent: exp of a future gap overflows
        Gsc = torch.einsum("bin,bjn->bij", Cc32, Bc32)
        gap = cum[:, :, None, :] - cum[:, None, :, :]
        L = torch.exp(torch.where(tri[None, :, :, None], gap, -torch.inf))
        W = Gsc[..., None] * L * dtc32[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", W, xc32)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bin,bhpn->bihp", Cc32, state) * torch.exp(cum)[..., None]
        decay_rem = torch.exp(total[:, None, :] - cum)     # (B, Q, H)
        new_state = torch.exp(total)[:, :, None, None] * state + torch.einsum(
            "bjh,bjn,bjhp->bhpn", dtc32 * decay_rem, Bc32, xc32)
        return new_state, y

    body = wrap(body)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, T, chunk):
        c = slice(s, s + chunk)
        state, y = body(state, x[:, c], dt[:, c], Bm[:, c], Cm[:, c])
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def mamba_decode_ref(window: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                     dt_raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                     D: torch.Tensor, state: torch.Tensor, *, n_heads: int,
                     head_dim: int):
    """Single-token mamba decode chain (``repro/kernels/ref.py:
    mamba_decode_ref``): the window's conv in the window's dtype (one
    rounding of the product, one of the bias add), silu in that dtype, then
    softplus(dt) and the state algebra in fp32.

    window: (B, K, ch) with ch = H*P + 2N; conv_w: (K, ch); conv_b: (ch,);
    dt_raw: (B, H); dt_bias/A_log/D: (H,); state: (B, H, P, N) fp32.
    Returns (y (B, H, P) fp32, new state (B, H, P, N) fp32)."""
    B = window.shape[0]
    H, P = n_heads, head_dim
    di = H * P
    N = state.shape[-1]
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias.float())              # (B, H)
    xh = xin.reshape(B, H, P).float()
    a = torch.exp(dt * -torch.exp(A_log.float()))                  # (B, H)
    state = a[:, :, None, None] * state + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + D.float()[None, :, None] * xh
    return y, state


def masked_update_(state: torch.Tensor, new: torch.Tensor,
                   active: torch.Tensor | None) -> None:
    """``state`` takes ``new`` in the rows (dim 0) of the active slots, all
    rows when ``active`` is None; an inactive row is left bit for bit (the
    reference's ``_freeze_inactive``, in place)."""
    if active is None:
        state.copy_(new)
    else:
        keep = active.reshape(-1, *([1] * (state.ndim - 1)))
        state.copy_(torch.where(keep, new, state))


def mamba_decode_ref_(window: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                      dt_raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, state: torch.Tensor,
                      active: torch.Tensor | None = None, *, n_heads: int,
                      head_dim: int) -> torch.Tensor:
    """The in-place form of :func:`mamba_decode_ref`: returns y (B, H, P)
    fp32 and writes the new state over ``state`` in the active slots' rows
    (``active`` (B,) bool, or None: every slot)."""
    y, new = mamba_decode_ref(window, conv_w, conv_b, dt_raw, dt_bias, A_log, D, state,
                              n_heads=n_heads, head_dim=head_dim)
    masked_update_(state, new, active)
    return y


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, state: torch.Tensor, *, chunk: int, wrap=checkpointed):
    """Chunked rwkv6 wkv scan (``repro/kernels/ref.py:wkv_scan_ref``, the
    plain path of ``models/rwkv.py:_wkv_chunked``): log-space per-channel
    decays, the strictly causal intra-chunk scores with the decay gap inside
    the exponent, the bonus current-token ``u`` term and the carried state,
    the chunk body under ``wrap`` (a checkpoint, as the reference's
    ``jax.checkpoint``).  Also the backward recompute of the wkv kernel's
    Function.

    r/k/w: (B, T, H, K); v: (B, T, H, V); u: (H, K); state: (B, H, K, V).
    Returns (y (B, T, H, V) fp32, final state (B, H, K, V) fp32)."""
    B, T, H, K = r.shape
    if chunk < 1 or T % chunk:
        raise ValueError(f"wkv_scan: chunk {chunk} does not divide T={T}")
    lw = torch.log(w)                                      # (B, T, H, K), < 0
    # i < t: strictly causal
    tri_lt = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device),
                        diagonal=-1)

    def body(S, rc, kc, vc, lwc):                          # (B, C, H, *)
        cum = torch.cumsum(lwc, dim=1)                     # inclusive, sequential in t
        cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
        # inter-chunk: y_t += (r_t * exp(cum_{t-1})) @ S
        rd = rc * torch.exp(cum_prev)
        y = torch.einsum("bthk,bhkv->bthv", rd, S)
        # intra-chunk: score_{t,i} = sum_k r_tk k_ik exp(cum_{t-1,k} - cum_{i,k});
        # the mask sits inside the exponent: a future gap is positive
        gap = cum_prev[:, :, None] - cum[:, None, :, :, :]   # (B, t, i, H, K)
        gap = torch.where(tri_lt[None, :, :, None, None], gap, -torch.inf)
        score = torch.einsum("bthk,bihk,btihk->btih", rc, kc, torch.exp(gap))
        y = y + torch.einsum("btih,bihv->bthv", score, vc)
        # bonus (current token) term
        y = y + torch.einsum("bthk,bthv->bthv", rc * (u[None, None] * kc), vc)
        # S' = diag(exp(total)) S + sum_i exp(total - cum_i) k_i v_i
        total = cum[:, -1]                                 # (B, H, K)
        rem = torch.exp(total[:, None] - cum)              # (B, C, H, K)
        S_new = torch.exp(total)[..., None] * S + torch.einsum(
            "bihk,bihv->bhkv", kc * rem, vc)
        return S_new, y

    body = wrap(body)
    ys = []
    for s in range(0, T, chunk):
        c = slice(s, s + chunk)
        state, y = body(state, r[:, c], k[:, c], v[:, c], lw[:, c])
        ys.append(y)
    return torch.cat(ys, dim=1), state


def wkv_decode_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, state: torch.Tensor):
    """Single-step rwkv time-mix core (``repro/kernels/ref.py:wkv_decode_ref``,
    ``models/rwkv.py:_time_mix_core``).

    r/k/w: (B, H, K); v: (B, H, V); u: (H, K); state: (B, H, K, V) fp32.
    Returns (out (B, H, V) fp32, new state (B, H, K, V) fp32, a fresh
    tensor)."""
    kv = k[..., :, None] * v[..., None, :]                 # (B, H, K, V)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None][..., :, None] * kv)
    new_state = w[..., :, None] * state + kv
    return out, new_state


def wkv_decode_ref_(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, state: torch.Tensor,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """The in-place form of :func:`wkv_decode_ref`: returns out (B, H, V)
    fp32 and writes the new state over ``state`` in the active slots' rows
    (``active`` (B,) bool, or None: every slot)."""
    out, new = wkv_decode_ref(r, k, v, w, u, state)
    masked_update_(state, new, active)
    return out
