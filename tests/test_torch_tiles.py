"""The host-side choices of the bf16 flash forward and swiglu kernels, as
their Python mirrors state them (``kernels/flash_attention.py``,
``kernels/swiglu.py``; ``chip_smoke.py`` holds each mirror to its C entry
on the card): for every config's serve and train shapes, each output tile
or work item is covered exactly once, in the order the kernels take them,
and the tiles the flash kernel walks without its mask see only visible
(query, key) pairs."""
import pytest
import torch

from repro_torch.configs import all_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import swiglu as sg
from repro_torch.kernels.ref import _attention_mask

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
            order = sg.tile_order(N, F, tm, tn)
            tiles = {(i, j) for i in range(-(-N // tm)) for j in range(-(-F // tn))}
            assert len(order) == len(tiles) and set(order) == tiles, (N, F)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b", "llama4-maverick-400b-a17b"])
def test_swiglu_blocks_in_flight_share_columns(arch):
    """At the train microbatch the 132 blocks in flight together cover
    GROUP_M row tiles and ~132 / GROUP_M column tiles, so w1 and w3 are
    read from device memory about N / (128 * GROUP_M) times."""
    cfg = all_configs()[arch]
    tm, tn = sg.swiglu_tile(8192, cfg.d_ff, H100_SMS)
    order = sg.tile_order(8192, cfg.d_ff, tm, tn)
    for start in range(0, len(order) - H100_SMS, H100_SMS):
        wave = order[start:start + H100_SMS]
        assert len({j for _, j in wave}) <= -(-H100_SMS // sg.GROUP_M) + 1
        assert len({i for i, _ in wave}) <= 2 * sg.GROUP_M


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
