"""Block and chunk fitting for the kernels (a copy of
``repro/kernels/tiling.py``), and the tiling of the bf16 Hopper GEMM
(``csrc/tma_gemm.cuh``) that swiglu, gelu_mlp and cross-entropy share.

``fit_block`` picks the largest block size <= ``block`` that divides ``n``.
``pick_chunk`` is the chunk rule of the chunked recurrent scans (mamba2 SSD,
rwkv wkv): the largest power-of-two chunk <= ``target`` dividing T, used by
both the plain chunk loop of ``models/ssm.py`` and the SSD kernel, so that
``kernels=True`` and the plain path agree on the chunk structure (and with
it on the fp32 summation order of the inter-chunk carry).

``gemm_tile`` and ``tile_order`` mirror ``csrc/tma_gemm.cuh``'s
``gemm_cols`` and ``tile_of``: N < STREAM_ROWS streams the weights through
64 x 64 tiles, larger N takes 128-row tiles whose width keeps the last wave
of the SMs full, and the persistent grid takes tiles in groups of GROUP_M
row tiles that sweep the same columns, so the blocks in flight together
share the weight's columns in the L2.

``scan_items``, ``ssd_tri_tiles``, ``ssd_mma_tiles`` and
``wkv_score_pairs`` mirror the work division of the chunk-parallel SSD and
wkv scans (``csrc/ssd_scan.cu``, ``csrc/wkv_scan.cu``): chunks above
SCAN_SMALL_CHUNK go through three kernels (chunk-local, state passing,
read-out) over (b, h, chunk) items with the head fastest; smaller chunks take
the token walk, whose blocks split the state's rows (SSD) or columns (wkv)
SCAN_SPLIT at a time.

``live_row_tiles`` and ``grouped_order`` mirror the bf16 grouped expert
MLP's work list (``csrc/grouped_mlp.cu``: ``grouped_live_kernel`` and
``tma_gemm.cuh``'s ``GroupedTiles``): the (expert, 64-row tile) pairs that
hold a valid slot, ascending, each by every 128-column tile, in
``tile_order``'s grouped order over (listed row tile, column tile); a row
tile with no valid slot gets no item.
"""
from __future__ import annotations

# chunk targets per scan family: SSD wants matmul-sized (Q x Q) intra-chunk
# products; wkv's per-channel (Q, Q, K) decay-gap tensor bounds Q lower
SSD_CHUNK = 128
WKV_CHUNK = 32
# the chunk-parallel scans: chunks up to SCAN_SMALL_CHUNK take the token
# walk, in blocks of SCAN_SPLIT state rows (SSD) or columns (wkv)
SCAN_SMALL_CHUNK = 8
SCAN_SPLIT = 16
STREAM_ROWS = 64
GROUP_M = 16
GROUPED_ROWS, GROUPED_COLS = 64, 128   # the grouped kernels' tile


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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_tile(N: int, F: int, n_sm: int, widths: tuple[int, ...]) -> tuple[int, int]:
    """(rows, columns) of the bf16 GEMM tile for an (N, d) x (d, F) call
    on a card with ``n_sm`` SMs: 64 x 64 below STREAM_ROWS, else 128 rows
    and of ``widths`` the width whose waves of tiles over the SMs, times the
    width, are fewest (the earlier in ``widths`` on a tie)."""
    if N < STREAM_ROWS:
        return 64, 64
    tiles_m = cdiv(N, 128)

    def cost(cols: int) -> int:
        return cdiv(tiles_m * cdiv(F, cols), n_sm) * cols

    best = widths[0]
    for cols in widths[1:]:
        if cost(cols) < cost(best):
            best = cols
    return 128, best


def tile_order(M: int, N: int, tile_m: int, tile_n: int) -> list[tuple[int, int]]:
    """(row tile, column tile) of each tile of an (M, N) output in the order
    the persistent grid takes them (block b of a grid of G takes tiles b,
    b + G, ...): groups of GROUP_M row tiles, the row tile fastest within a
    group."""
    tiles_m, tiles_n = cdiv(M, tile_m), cdiv(N, tile_n)
    order = []
    for tile in range(tiles_m * tiles_n):
        first = tile // (GROUP_M * tiles_n) * GROUP_M
        rows = min(tiles_m - first, GROUP_M)
        r = tile % (GROUP_M * tiles_n)
        order.append((first + r % rows, r // rows))
    return order


def live_row_tiles(mask) -> list[int]:
    """expert * ceil(N / 64) + row tile of each 64-row tile of the (E, N)
    slot mask that holds a valid (nonzero) slot, ascending."""
    E, N = mask.shape
    T = cdiv(N, GROUPED_ROWS)
    valid = [[bool(v) for v in row] for row in (mask != 0).tolist()]
    return [e * T + t for e in range(E) for t in range(T)
            if any(valid[e][t * GROUPED_ROWS:(t + 1) * GROUPED_ROWS])]


def grouped_order(mask, cols: int) -> list[tuple[int, int, int]]:
    """(expert, row tile, column tile) of each work item of the grouped
    gate (cols = F) or down product (cols = d) in the order the persistent
    grid takes them."""
    live = live_row_tiles(mask)
    T = cdiv(mask.shape[1], GROUPED_ROWS)
    return [(live[l] // T, live[l] % T, tn) for l, tn in
            tile_order(len(live) * GROUPED_ROWS, cols, GROUPED_ROWS, GROUPED_COLS)]


def scan_items(B: int, H: int, T: int, Q: int, width: int = 64) -> list[tuple[int, int, int]]:
    """The blocks of a chunked scan of (B, T, H, width) at chunk Q, in block
    order: (b, h, chunk) of the chunk-local and read-out kernels, the head
    fastest, for Q > SCAN_SMALL_CHUNK; else (b, h, first state row or
    column) of the token walk's blocks."""
    if Q <= SCAN_SMALL_CHUNK:
        return [(b, h, s) for b in range(B) for h in range(H)
                for s in range(0, width, SCAN_SPLIT)]
    return [(b, h, c) for b in range(B) for c in range(T // Q) for h in range(H)]


def _tri_patches(Q: int) -> list[tuple[int, int]]:
    """The 4 x 8 patches of 4 x 4 tiles of a Q x Q product that hold a tile
    on or below the diagonal, row-major."""
    return [(si, sj) for si in range(Q // 16) for sj in range((4 * si + 3) // 8 + 1)]


def ssd_tri_tiles(Q: int) -> list[tuple[int, int, int]]:
    """(thread, ti, tj) of the SSD read-out kernel's C B^T tiles (4 x 4, tj
    <= ti) in the order its 2Q threads take them: warp w of Q/16 takes
    patches w, w + Q/16, ...; lane l the tile (4 si + l // 8, 8 sj + l % 8)
    of its patch where that is on or below the diagonal."""
    patches, nw = _tri_patches(Q), Q // 16
    out = []
    for rd in range(cdiv(len(patches), nw)):
        for t in range(2 * Q):
            k = rd * nw + t // 32
            if k >= len(patches):
                continue
            si, sj = patches[k]
            ti, tj = 4 * si + t % 32 // 8, 8 * sj + t % 8
            if tj <= ti:
                out.append((t, ti, tj))
    return out


def ssd_mma_tiles(Q: int) -> list[tuple[int, int, int]]:
    """(warp, strip, jt) of the bf16 SSD read-out kernel's C B^T tiles (16
    rows x 8 columns on the tensor cores, jt <= 2 strip + 1), listed strip
    by strip; warp w of Q/16 takes tiles w, w + Q/16, ..."""
    tiles = [(s, jt) for s in range(Q // 16) for jt in range(2 * s + 2)]
    return [(k % (Q // 16), s, jt) for k, (s, jt) in enumerate(tiles)]


def wkv_score_pairs(Q: int, threads: int = 256) -> list[tuple[int, int, int]]:
    """(thread, t, i) of the wkv read-out kernel's scores (i < t) in the
    order its threads take them: warp w's round rd takes rows pr and
    Q-1-pr (pr = rd * warps + w), lanes below pr row pr, the next Q-1-pr
    lanes row Q-1-pr."""
    nw = threads // 32
    out = []
    for rd in range(cdiv(Q // 2, nw)):
        for th in range(threads):
            pr, lane = rd * nw + th // 32, th % 32
            if pr >= Q // 2 or lane >= Q - 1:
                continue
            out.append((th, pr, lane) if lane < pr else (th, Q - 1 - pr, lane - pr))
    return out
