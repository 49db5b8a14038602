"""The host-side choices of the bf16 flash forward and backward (dQ,
dK/dV), swiglu, gelu_mlp and cross-entropy kernels, as their Python mirrors
state them (``kernels/flash_attention.py``, ``kernels/swiglu.py``,
``kernels/gelu_mlp.py``, ``kernels/cross_entropy.py``, and the GEMM tile
order they share in ``kernels/tiling.py``; ``chip_smoke.py``
holds each mirror to its C entry on the card): for every config's serve
and train shapes, each output tile or work item is covered exactly once,
in the order the kernels take them, every (query, key) pair the mask lets
through lies in a tile the flash kernels walk, and the tiles they walk
without the mask see only visible pairs.  The cross-entropy
kernel's per-tile (max, sumexp) partials and their merge, in float64, equal
the plain version's lse and label logit.  The grouped expert MLP's work
list (``tiling.grouped_order``) covers each column tile of every live
expert's row tiles once and gives a dead one none, at llama4's and arctic's
routed serve masks and the ragged shapes ``chip_smoke.py`` checks.  The
chunk-parallel SSD and wkv scans' work division (``tiling.scan_items``,
``ssd_tri_tiles``, ``ssd_mma_tiles``, ``wkv_score_pairs``) takes every
chunk, lower-triangular tile, score pair and state row once, and
``chip_smoke.check_scan_mirrors`` fails when any C plan entry differs from
its mirror."""
import numpy as np
import pytest
import torch

from repro_torch.configs import all_configs
from repro_torch.kernels import cross_entropy as ce
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gelu_mlp as gm
from repro_torch.kernels import swiglu as sg
from repro_torch.kernels import tiling
from repro_torch.kernels.ref import _attention_mask, cross_entropy_ref
from repro_torch.models.moe import _route, moe_capacity

H100_SMS = 132
# serve prefills of 1..256 tokens (the engine's prompts) and decode at 4
# slots; the train step's microbatch of 4 x 2048 tokens; yi-6b's prefill
SERVE_N = sorted({1, 3, 4, 5, 17, 32, 63, 64, 77, 96, 127, 128, 129, 200, 255, 256,
                  *range(8, 257, 24)})
TRAIN_N = (512, 8192)
SWIGLU_CONFIGS = sorted(n for n, c in all_configs().items()
                        if c.act == "swiglu" and c.family in ("dense", "moe", "hybrid", "vlm"))
FLASH_CONFIGS = sorted(n for n, c in all_configs().items()
                       if c.family != "rwkv" and c.resolved_head_dim in fa.HEAD_DIMS)
GELU_CONFIGS = sorted(n for n, c in all_configs().items() if c.act == "gelu")
# the configs whose padded vocab the bf16 CE kernel takes (a multiple of 8)
CE_CONFIGS = sorted(n for n, c in all_configs().items() if c.padded_vocab % 8 == 0)


def _mlp_widths(cfg) -> set[tuple[int, int]]:
    """(d, F) of the config's swiglu gates: the MLP and the moe family's dense MLP."""
    return {(cfg.d_model, F) for F in (cfg.d_ff, cfg.dense_d_ff) if F}


@pytest.mark.parametrize("N,F,tile", [
    (1, 11008, (64, 64)), (4, 11008, (64, 64)), (63, 11008, (64, 64)),
    (64, 11008, (128, 128)), (256, 11008, (128, 192)), (200, 11008, (128, 192)),
    (512, 11008, (128, 128)), (8192, 11008, (128, 128)),
    (256, 8192, (128, 128)), (256, 4864, (128, 128)),
], ids=lambda v: str(v))
def test_swiglu_tile_regimes(N, F, tile):
    """Decode (N < 64) streams 64 x 64 tiles; prefill widens the column tile
    to 192 where 128 would leave most of a second wave of 132 SMs idle
    (yi-6b's 256-token prefill: 172 tiles of 128, 116 of 192)."""
    assert sg.swiglu_tile(N, F, H100_SMS) == tile


@pytest.mark.parametrize("arch", SWIGLU_CONFIGS)
def test_swiglu_tiles_cover_each_output_once(arch):
    for _, F in _mlp_widths(all_configs()[arch]):
        for N in (*SERVE_N, *TRAIN_N):
            tm, tn = sg.swiglu_tile(N, F, H100_SMS)
            order = tiling.tile_order(N, F, tm, tn)
            tiles = {(i, j) for i in range(-(-N // tm)) for j in range(-(-F // tn))}
            assert len(order) == len(tiles) and set(order) == tiles, (N, F)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b", "llama4-maverick-400b-a17b"])
def test_swiglu_blocks_in_flight_share_columns(arch):
    """At the train microbatch the 132 blocks in flight together cover
    GROUP_M row tiles and ~132 / GROUP_M column tiles, so w1 and w3 are
    read from device memory about N / (128 * GROUP_M) times."""
    cfg = all_configs()[arch]
    tm, tn = sg.swiglu_tile(8192, cfg.d_ff, H100_SMS)
    order = tiling.tile_order(8192, cfg.d_ff, tm, tn)
    for start in range(0, len(order) - H100_SMS, H100_SMS):
        wave = order[start:start + H100_SMS]
        assert len({j for _, j in wave}) <= -(-H100_SMS // tiling.GROUP_M) + 1
        assert len({i for i, _ in wave}) <= 2 * tiling.GROUP_M


def _flash_shapes(cfg):
    """(B, Sq) of the serve prefills and the train microbatch."""
    return [(1, S) for S in SERVE_N] + [(4, 2048)]


@pytest.mark.parametrize("arch", FLASH_CONFIGS)
def test_flash_work_order_covers_each_item_once(arch):
    cfg = all_configs()[arch]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = Hq // Hkv
    for B, S in _flash_shapes(cfg):
        chunk = fa.chunk_pairs(B, Hq, Hkv, S, hd)
        pairs = B * Hq
        assert chunk == pairs or chunk % G == 0
        # the chunk's K and V fit the budget unless one GQA group alone does not
        group_bytes = 2 * S * (-(-hd // 16) * 16) * 2
        assert chunk * group_bytes // G <= max(fa.L2_CHUNK_BYTES, group_bytes)
        order = fa.work_order(B, S, Hq, chunk, causal=True)
        items = {(q0, h, b) for q0 in range(0, S, fa.BLOCK_M) for h in range(Hq)
                 for b in range(B)}
        assert len(order) == len(items) and set(order) == items, (B, S)
        # within a chunk, causal items come longest first
        for first in range(0, len(order), chunk * -(-S // fa.BLOCK_M)):
            q0s = [q0 for q0, _, _ in order[first:first + chunk * -(-S // fa.BLOCK_M)]]
            assert q0s == sorted(q0s, reverse=True)


FLASH_MASK_CASES = [  # (Sq, Skv, causal, window, q_offset)
    (200, 200, True, None, 0),        # partial query and key tiles, the diagonal
    (2048, 2048, True, None, 0),
    (256, 256, True, 64, 0),          # window edges
    (200, 330, True, 100, 130),
    (64, 256, True, None, 192),       # Sq < Skv
    (96, 160, True, 48, 64),
    (200, 200, True, None, -40),      # rows that see no key
    (130, 77, False, None, 0),        # non-causal, partial key tile
    (100, 200, False, None, 0),
    (5, 5, True, None, 0),
    (255, 255, True, None, 0),
    (129, 129, True, 128, 0),
]


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", FLASH_MASK_CASES,
                         ids=lambda v: str(v))
def test_flash_key_tiles_and_unmasked_tiles(Sq, Skv, causal, window, q_offset):
    """Every (query, key) pair the reference mask lets through lies in a
    tile the item walks; every tile a warpgroup walks without the mask
    holds only pairs it lets through."""
    mask = _attention_mask(Sq, Skv, "cpu", causal=causal, sliding_window=window,
                           q_offset=q_offset)
    mask = torch.ones(Sq, Skv, dtype=torch.bool) if mask is None else mask
    for q0 in range(0, Sq, fa.BLOCK_M):
        starts = fa.key_tiles(q0, Sq, Skv, causal=causal, window=window, q_offset=q_offset)
        walked = torch.zeros(Skv, dtype=torch.bool)
        for k0 in starts:
            walked[k0:k0 + fa.BLOCK_N] = True
        rows = slice(q0, min(q0 + fa.BLOCK_M, Sq))
        assert not (mask[rows] & ~walked).any(), q0
        assert starts == sorted(starts, reverse=True)
        for r_lo in (q0, q0 + 64):
            if r_lo >= Sq:
                continue
            wg = mask[r_lo:min(r_lo + 64, Sq)]
            for k0 in starts:
                if not fa.edge_tile(k0, r_lo, Sq, Skv, causal=causal, window=window,
                                    q_offset=q_offset):
                    assert k0 + fa.BLOCK_N <= Skv and wg[:, k0:k0 + fa.BLOCK_N].all(), (r_lo, k0)


@pytest.mark.parametrize("arch", FLASH_CONFIGS)
def test_flash_bwd_work_orders_cover_each_item_once(arch):
    """At the train microbatch (4 x 2048 tokens, causal): the dQ kernel's
    items (the forward's order) and the dK/dV kernel's (k0, KV head, b)
    items each once; the dK/dV items in chunks of (b, KV head) pairs whose
    Q and dO fit the L2 budget unless two waves of items need more, the
    longest first within each chunk (G heads times the query tiles that
    see their keys), so a chunk's longest starts first."""
    cfg = all_configs()[arch]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = 4, 2048
    order = fa.work_order(B, S, Hq, fa.chunk_pairs(B, Hq, Hkv, S, hd), causal=True)
    items = {(q0, h, b) for q0 in range(0, S, fa.BLOCK_M) for h in range(Hq) for b in range(B)}
    assert len(order) == len(items) and set(order) == items
    chunk = fa.dkv_chunk(B, Hq, Hkv, S, S, hd, H100_SMS)
    pairs, nk, G = B * Hkv, S // fa.DKV_BLOCK_N, Hq // Hkv
    pair_bytes = 2 * G * S * (-(-hd // 16) * 16) * 2
    assert (chunk == pairs or chunk * pair_bytes <= fa.L2_CHUNK_BYTES
            or (chunk - 1) * nk < 2 * H100_SMS)
    assert chunk == pairs or chunk * nk >= H100_SMS        # two waves, spread evenly
    order = fa.dkv_work_order(B, Hkv, S, chunk)
    items = {(k0, hk, b) for k0 in range(0, S, fa.DKV_BLOCK_N) for hk in range(Hkv)
             for b in range(B)}
    assert len(order) == len(items) and set(order) == items
    for first in range(0, len(order), chunk * nk):
        lengths = [G * len(fa.query_tiles(k0, S, S, causal=True, window=None, q_offset=0))
                   for k0, _, _ in order[first:first + chunk * nk]]
        assert lengths == sorted(lengths, reverse=True) and lengths[0] == G * S // 64


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", FLASH_MASK_CASES,
                         ids=lambda v: str(v))
def test_flash_bwd_tiles_and_unmasked_tiles(Sq, Skv, causal, window, q_offset):
    """Both backward kernels: every (query, key) pair the reference mask
    lets through lies in a tile the dQ item of its query rows walks and in
    one the dK/dV item of its key walks; every tile a warpgroup walks
    without the mask holds only pairs it lets through; the dK/dV items come
    longest first where the order promises it (causal, and no window or
    q_offset <= 0, as in a train step: with a window and a positive
    q_offset the first key tiles are seen by fewer rows)."""
    mask = _attention_mask(Sq, Skv, "cpu", causal=causal, sliding_window=window,
                           q_offset=q_offset)
    mask = torch.ones(Sq, Skv, dtype=torch.bool) if mask is None else mask
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for q0 in range(0, Sq, fa.BLOCK_M):             # dQ: key tiles of 64
        starts = fa.key_tiles(q0, Sq, Skv, block_n=fa.DQ_BLOCK_N, **kw)
        walked = torch.zeros(Skv, dtype=torch.bool)
        for k0 in starts:
            walked[k0:k0 + fa.DQ_BLOCK_N] = True
        assert not (mask[q0:q0 + fa.BLOCK_M] & ~walked).any(), q0
        assert len(set(starts)) == len(starts)
        for r_lo in range(q0, min(q0 + fa.BLOCK_M, Sq), fa.WG_ROWS):
            wg = mask[r_lo:r_lo + fa.WG_ROWS]
            for k0 in starts:
                if not fa.edge_tile(k0, r_lo, Sq, Skv, block_n=fa.DQ_BLOCK_N, **kw):
                    assert (k0 + fa.DQ_BLOCK_N <= Skv
                            and wg[:, k0:k0 + fa.DQ_BLOCK_N].all()), (r_lo, k0)
    lengths = []
    for k0 in range(0, Skv, fa.DKV_BLOCK_N):        # dK/dV: query tiles of 64
        starts = fa.query_tiles(k0, Sq, Skv, **kw)
        walked = torch.zeros(Sq, dtype=torch.bool)
        for q0 in starts:
            walked[q0:q0 + fa.DKV_BLOCK_M] = True
        assert not (mask[:, k0:k0 + fa.DKV_BLOCK_N] & ~walked[:, None]).any(), k0
        assert len(set(starts)) == len(starts)
        for kw0 in range(k0, min(k0 + fa.DKV_BLOCK_N, Skv), fa.WG_ROWS):
            for q0 in starts:
                if not fa.dkv_edge_tile(q0, kw0, Sq, Skv, **kw):
                    assert (q0 + fa.DKV_BLOCK_M <= Sq and kw0 + fa.WG_ROWS <= Skv
                            and mask[q0:q0 + fa.DKV_BLOCK_M, kw0:kw0 + fa.WG_ROWS].all()), (
                        kw0, q0)
        lengths.append(len(starts))
    if causal and (not window or q_offset <= 0):
        assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("N,tile", [
    (1, (64, 64)), (4, (64, 64)), (63, (64, 64)), (64, (128, 128)), (256, (128, 128)),
    (8192, (128, 256)),
], ids=lambda v: str(v))
def test_gelu_mlp_tile_regimes(N, tile):
    """At gpt-1.4b's F = 8448: decode (N < 64) streams 64 x 64 tiles; a
    256-token prefill takes 128 columns (132 tiles, one wave; 256 would
    leave half the SMs idle); the train microbatch 256 (16 waves, as many
    as 32 of 128, with fewer blocks)."""
    assert gm.gelu_mlp_tile(N, 8448, H100_SMS) == tile


@pytest.mark.parametrize("arch", GELU_CONFIGS)
def test_gelu_mlp_tiles_cover_each_output_once(arch):
    cfg = all_configs()[arch]
    for N in (*SERVE_N, *TRAIN_N):
        tm, tn = gm.gelu_mlp_tile(N, cfg.d_ff, H100_SMS)
        order = tiling.tile_order(N, cfg.d_ff, tm, tn)
        tiles = {(i, j) for i in range(-(-N // tm)) for j in range(-(-cfg.d_ff // tn))}
        assert len(order) == len(tiles) and set(order) == tiles, N


@pytest.mark.parametrize("arch", CE_CONFIGS)
def test_ce_tiles_cover_each_output_once(arch):
    """Every (row tile, column tile) of the train microbatch's and the
    serve shapes' logits once, and one partial a row for each column tile."""
    V = all_configs()[arch].padded_vocab
    for N in (*SERVE_N, *TRAIN_N, 4 * 2047):
        tm, tn = ce.TILE_M, ce.TILE_N
        order = tiling.tile_order(N, V, tm, tn)
        tiles = {(i, j) for i in range(-(-N // tm)) for j in range(-(-V // tn))}
        assert len(order) == len(tiles) and set(order) == tiles, N
        assert ce.n_partials(V, torch.bfloat16) == -(-V // tn)


@pytest.mark.parametrize("kernel", ["gelu_mlp", "cross_entropy"])
def test_gemm_blocks_in_flight_share_columns(kernel):
    """At the train microbatch the 132 blocks in flight together cover
    GROUP_M row tiles and ~132 / GROUP_M column tiles, so the weight is
    read from device memory about N / (128 * GROUP_M) times."""
    if kernel == "gelu_mlp":
        N, cols = 8192, all_configs()["gpt-1.4b"].d_ff
        tile = gm.gelu_mlp_tile(N, cols, H100_SMS)
    else:
        N, cols = 4 * 2047, all_configs()["yi-6b"].padded_vocab
        tile = ce.TILE_M, ce.TILE_N
    order = tiling.tile_order(N, cols, *tile)
    for start in range(0, len(order) - H100_SMS, H100_SMS):
        wave = order[start:start + H100_SMS]
        assert len({j for _, j in wave}) <= -(-H100_SMS // tiling.GROUP_M) + 1
        assert len({i for i, _ in wave}) <= 2 * tiling.GROUP_M


CE_PARTIAL_CASES = [  # (N, d, V, valid_vocab, labels)
    (37, 24, 1288, 1100, (1099, 1024, 0, 777)),   # valid_vocab inside tile 4; tile 5 past it
    (37, 24, 1288, 1024, (1023, 768, 0, 777)),    # valid_vocab on tile 4's start
    (21, 16, 1000, None, (999, 768, 256, 5)),     # the last tile partial, labels in it
    (9, 8, 512, 256, (255, 0, 128, 1)),           # a whole tile past valid_vocab
    (5, 8, 200, 199, (198, 0, 57, 100)),          # one partial tile
]


@pytest.mark.parametrize("N,d,V,vv,labels", CE_PARTIAL_CASES, ids=lambda v: str(v))
def test_ce_partials_merge_to_the_plain_lse(N, d, V, vv, labels):
    """The kernel's algebra in float64: (max, sumexp) per 256-column tile
    over the valid columns, sumexp 0 for a tile with none, merged in order
    skipping those, and the label logit from the tile that holds it, equal
    ``cross_entropy_ref``'s lse and label logit on the same fp32 inputs."""
    rng = np.random.default_rng(N * 1000 + V)
    h = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, V)) * d ** -0.5).astype(np.float32))
    lab = torch.tensor(labels).repeat(-(-N // len(labels)))[:N]
    m, s, ll = ce.partials_ref(h.double(), w.double(), lab, vv)
    assert m.shape == s.shape == (ce.n_partials(V, torch.bfloat16), N)
    if vv is not None:
        past = torch.arange(m.shape[0]) * ce.TILE_N >= vv
        assert (s[past] == 0).all() and (m[past] == ce.NEG_INF).all()
        assert (s[~past] > 0).all()
    lse = ce.merge_ref(m, s)
    rlse, rll = cross_entropy_ref(h, w, lab, vv)
    torch.testing.assert_close(lse.float(), rlse, rtol=0, atol=1e-5)
    torch.testing.assert_close(ll.float(), rll, rtol=0, atol=1e-5)


def _routed_mask(arch: str, G: int, g: int, seed: int) -> torch.Tensor:
    """The (E, G*C) slot mask the model's router gives G groups of g tokens
    under softmax-of-Gaussian gates, in the grouped kernel's layout (as
    ``chip_smoke.routed_mask``)."""
    cfg = all_configs()[arch]
    E, C = cfg.n_experts, moe_capacity(g, cfg)
    gen = torch.Generator().manual_seed(seed)
    gates = torch.softmax(torch.randn(G, g, E, generator=gen), -1)
    valid = _route(gates, cfg.top_k, C)[2]
    return valid.reshape(G, E, C).transpose(0, 1).reshape(E, G * C).float()


def _ragged_mask(E: int, N: int, seed: int) -> torch.Tensor:
    """``chip_smoke.py``'s ragged cases: expert 1 with no valid slot, expert
    0 with rows 64..127 (a whole row tile when N > 64) masked."""
    mask = (torch.rand(E, N, generator=torch.Generator().manual_seed(seed)) > 0.4).float()
    mask[1] = 0
    mask[0, 64:128] = 0
    return mask


LLAMA4_ID, ARCTIC_ID = "llama4-maverick-400b-a17b", "arctic-480b"
GROUPED_CASES = {  # name -> (mask, [(d, F) ...])
    "llama4 prefill 256": (lambda: _routed_mask(LLAMA4_ID, 1, 256, 0), [(5120, 8192)]),
    "llama4 decode": (lambda: _routed_mask(LLAMA4_ID, 4, 1, 1), [(5120, 8192)]),
    "arctic prefill 256": (lambda: _routed_mask(ARCTIC_ID, 1, 256, 2), [(7168, 4864)]),
    "arctic decode": (lambda: _routed_mask(ARCTIC_ID, 4, 1, 3), [(7168, 4864)]),
    # N 80: two row tiles an expert
    "arctic prefill 4096": (lambda: _routed_mask(ARCTIC_ID, 1, 4096, 4), [(7168, 4864)]),
    "ragged 8x37": (lambda: _ragged_mask(8, 37, 5), [(256, 520)]),
    "ragged 4x130": (lambda: _ragged_mask(4, 130, 6), [(128, 96)]),
    "all masked": (lambda: torch.zeros(4, 37), [(256, 520)]),
}


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_order_covers_each_live_tile_once(case):
    """Every column tile of every (expert, 64-row tile) with a valid slot
    exactly once, in both products (columns F for the gate, d for the down
    product); no item for a row tile, or an expert, with no valid slot."""
    make, widths = GROUPED_CASES[case]
    mask = make()
    E, N = mask.shape
    T = -(-N // tiling.GROUPED_ROWS)
    valid = mask.ne(0)
    live = {(e, t) for e in range(E) for t in range(T)
            if valid[e, t * tiling.GROUPED_ROWS:(t + 1) * tiling.GROUPED_ROWS].any()}
    assert tiling.live_row_tiles(mask) == sorted(e * T + t for e, t in live)
    for d, F in widths:
        for cols in (F, d):
            order = tiling.grouped_order(mask, cols)
            want = {(e, t, j) for e, t in live for j in range(-(-cols // tiling.GROUPED_COLS))}
            assert len(order) == len(want) and set(order) == want, cols
            assert {e for e, _, _ in order} == set(valid.any(1).nonzero()[:, 0].tolist())
    if case == "all masked":
        assert order == []


@pytest.mark.parametrize("case", ["llama4 prefill 256", "llama4 decode", "arctic decode"])
def test_grouped_blocks_in_flight_share_columns(case):
    """The 132 blocks in flight together take at most two groups of GROUP_M
    listed row tiles (the tile order of the dense GEMMs over the list), and
    of each expert a run of adjacent column tiles, so a wave reads adjacent
    128-byte boxes of each expert's weight rows."""
    make, ((d, F),) = GROUPED_CASES[case]
    order = tiling.grouped_order(make(), F)
    for start in range(0, len(order) - H100_SMS, H100_SMS):
        wave = order[start:start + H100_SMS]
        assert len({e for e, _, _ in wave}) <= 2 * tiling.GROUP_M
        for e in {e for e, _, _ in wave}:
            cols = sorted(j for ee, _, j in wave if ee == e)
            assert cols == list(range(cols[0], cols[-1] + 1)), (start, e)


# the chunked scans: (B, T, H, chunk) of chip_smoke.py's SSD and wkv cases,
# at zamba2's 80 SSM heads and rwkv6's 32, and every chunk each kernel takes
SCAN_CASES = [(4, 2048, 80, 128), (1, 255, 80, 1), (1, 200, 80, 8), (1, 96, 80, 32),
              (1, 64, 80, 64), (1, 48, 80, 16), (2, 100, 3, 4), (4, 2048, 32, 32),
              (1, 50, 32, 2)]


@pytest.mark.parametrize("B,T,H,chunk", SCAN_CASES, ids=lambda v: str(v))
def test_scan_items_cover_each_chunk_once(B, T, H, chunk):
    """The chunk kernels' blocks take every (b, h, chunk) once, the head
    fastest; the token walk's blocks take every (b, h) once per 16-row
    (column) part, and the parts cover the 64 state rows once."""
    items = tiling.scan_items(B, H, T, chunk)
    if chunk > tiling.SCAN_SMALL_CHUNK:
        assert sorted(items) == [(b, h, c) for b in range(B) for h in range(H)
                                 for c in range(T // chunk)]
        assert [h for _, h, _ in items[:H]] == list(range(H))
    else:
        assert sorted(items) == [(b, h, s) for b in range(B) for h in range(H)
                                 for s in range(0, 64, tiling.SCAN_SPLIT)]
    assert len(items) == len(set(items))


@pytest.mark.parametrize("Q", [16, 32, 64, 128])
def test_ssd_tiles_cover_the_lower_triangle_once(Q):
    """C B^T's tiles cover every (i, j <= i) of a Q-chunk once: the fp32
    4 x 4 tiles (each of the 2Q threads at most once a round, no round
    longer than the list needs) and the bf16 16 x 8 mma tiles (spread over
    the Q/16 warps within one tile of each other)."""
    tiles = tiling.ssd_tri_tiles(Q)
    assert sorted((ti, tj) for _, ti, tj in tiles) == [
        (ti, tj) for ti in range(Q // 4) for tj in range(ti + 1)]
    assert all(0 <= t < 2 * Q for t, _, _ in tiles)
    per_thread = np.bincount([t for t, _, _ in tiles], minlength=2 * Q)
    assert per_thread.max() <= -(-len(tiling._tri_patches(Q)) // (Q // 16))
    covered = set()
    for w, s, jt in tiling.ssd_mma_tiles(Q):
        assert 0 <= w < Q // 16 and 8 * jt <= 16 * s + 15
        cells = {(i, j) for i in range(16 * s, 16 * s + 16)
                 for j in range(8 * jt, 8 * jt + 8) if j <= i}
        assert not covered & cells
        covered |= cells
    assert covered == {(i, j) for i in range(Q) for j in range(i + 1)}
    per_warp = np.bincount([w for w, _, _ in tiling.ssd_mma_tiles(Q)])
    assert per_warp.max() - per_warp.min() <= 1


@pytest.mark.parametrize("Q", [16, 32])
def test_wkv_score_pairs_cover_each_pair_once(Q):
    """The wkv read-out kernel forms every score (t, i < t) of a Q-chunk
    once, each thread at most one a round, and no pair with i >= t (the
    masked half, whose gap would be positive)."""
    pairs = tiling.wkv_score_pairs(Q)
    assert sorted((t, i) for _, t, i in pairs) == [(t, i) for t in range(Q) for i in range(t)]
    rounds = -(-(Q // 2) // 8)
    assert np.bincount([th for th, _, _ in pairs]).max() <= rounds
    # a warp's lanes take two rows, whose pairs fill Q - 1 lanes
    for th in range(0, 256, 32):
        rows = {t for w, t, _ in pairs if th <= w < th + 32}
        assert len(rows) <= 2 * rounds


def _scan_stubs(name: str, broken: str | None):
    """Stand-ins for a scan module's C plan entries that answer as the
    mirrors do, or with one of them broken."""
    ssd_kernel = name == "ssd_scan"

    def items(B, T, H, chunk):
        got = tiling.scan_items(B, H, T, chunk)
        if broken == "split" and chunk <= tiling.SCAN_SMALL_CHUNK:
            # the token walk's blocks taking twice the state rows each
            return [(b, h, s) for b, h, s in got if s % (2 * tiling.SCAN_SPLIT) == 0]
        return got[1:] + got[:1] if broken == "items" else got

    def tiles(chunk, dtype=torch.float32):
        got = (tiling.ssd_mma_tiles(chunk) if dtype == torch.bfloat16
               else tiling.ssd_tri_tiles(chunk)) if ssd_kernel else tiling.wkv_score_pairs(chunk)
        return got[:-1] if broken == "tiles" else got

    return {"scan_items_cuda": items, "tri_tiles_cuda" if ssd_kernel else "score_pairs_cuda":
            tiles}


@pytest.mark.parametrize("broken", [None, "items", "tiles", "split"])
@pytest.mark.parametrize("name", ["ssd_scan", "wkv_scan"])
def test_chip_smoke_holds_the_scan_mirrors_to_the_c_entries(name, broken, monkeypatch):
    """``chip_smoke.check_scan_mirrors`` compares every C plan entry of the
    scan with its mirror at the script's cases: it passes when they agree
    and fails when any one of them differs."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    for attr, stub in _scan_stubs(name, broken).items():
        monkeypatch.setattr(module, attr, stub)
    cases = ([(B, T, 80, c) for B, T, c in chip_smoke._ssd_cases()] if name == "ssd_scan"
             else [(B, T, 32, c) for B, T, c in chip_smoke._wkv_cases()])
    if broken is None:
        assert chip_smoke.check_scan_mirrors(name, cases) > len(cases)
    else:
        with pytest.raises(AssertionError, match=name):
            chip_smoke.check_scan_mirrors(name, cases)


@pytest.mark.parametrize("B,T,H,chunk", [(4, 2048, 80, 128), (1, 256, 80, 128), (1, 255, 80, 1)],
                         ids=lambda v: str(v))
def test_ssd_bound_counts_the_function_once(B, T, H, chunk):
    """``chip_smoke.ssd_bound`` counts the scan's bytes once (x and y, B and
    C, dt, the state), C B^T once per (b, chunk) whatever the heads, and
    the three fp32-operand products (W x, D_c, C S) once per head; the
    train shape is bound by its bytes."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    ms, by, floors = chip_smoke.ssd_bound(B, T, H, 64, 64, chunk, 2)
    one_head = chip_smoke.ssd_bound(B, T, 1, 64, 64, chunk, 2)[2]
    pairs = chunk * (chunk + 1) // 2
    assert floors["cbt_flops"] == one_head["cbt_flops"] == B * (T // chunk) * 2 * pairs * 64
    assert floors["split_flops"] == H * one_head["split_flops"]
    assert floors["split_flops"] == B * H * (T // chunk) * (2 * pairs * 64 + 4 * chunk * 64 * 64)
    assert floors["nbytes"] == 2 * (2 * B * T * H * 64 + 2 * B * T * 64) + 4 * B * T * H + \
        4 * B * H * 64 * 64
    assert ms == max(floors["bytes"], floors["tensor"])
    if (B, T) == (4, 2048):
        assert by == "bytes"
