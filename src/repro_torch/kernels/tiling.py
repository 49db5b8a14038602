"""Block and chunk fitting for the kernels (a copy of
``repro/kernels/tiling.py``).

``fit_block`` picks the largest block size <= ``block`` that divides ``n``.
``pick_chunk`` is the chunk rule of the chunked recurrent scans (mamba2 SSD,
rwkv wkv): the largest power-of-two chunk <= ``target`` dividing T, used by
both the plain chunk loop of ``models/ssm.py`` and the SSD kernel, so that
``kernels=True`` and the plain path agree on the chunk structure (and with
it on the fp32 summation order of the inter-chunk carry).
"""
from __future__ import annotations

# chunk targets per scan family: SSD wants matmul-sized (Q x Q) intra-chunk
# products; wkv's per-channel (Q, Q, K) decay-gap tensor bounds Q lower
SSD_CHUNK = 128
WKV_CHUNK = 32


def fit_block(block: int, n: int) -> int:
    b = min(block, n)
    while n % b != 0:
        b -= 1
    return b


def pick_chunk(T: int, target: int) -> int:
    """Largest power-of-two chunk <= min(target, T) that divides T (1 when
    T is odd)."""
    c, q = 1, 2
    while q <= min(target, T):
        if T % q == 0:
            c = q
        q *= 2
    return c
