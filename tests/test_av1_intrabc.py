"""Intra block copy (screen content) conformance vs libdav1d.

Synth keyframes with allow_intrabc=1: plain intra blocks fill the top
superblock rows, intrabc (copy) blocks below reference them through
DVs coded with the dedicated ndv contexts (reference easyav1's AV1
decode path; libaom decodemv.c read_intrabc_info / av1_is_dv_valid).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

from easyav1.video.av1 import constants as C  # noqa: E402
from av1_synth import (EncBlock, dav1d_decode_ivf, encode_frame,  # noqa: E402
                       make_ivf, my_decode_tu, assert_same)

W, H = 128, 320          # 2 x 5 superblocks
SB64_PER_ROW = W // 64
DELAY_SB64 = 4           # INTRABC_DELAY_PIXELS / 64


def dv_valid(r, c, bsize, dv):
    """libaom av1_is_dv_valid for a single 64x64-SB tile spanning the
    frame (full-pel dv = (row, col) in 1/8 pel)."""
    if dv[0] % 8 or dv[1] % 8:
        return False
    bw = C.BLOCK_W4[bsize] * 4
    bh = C.BLOCK_H4[bsize] * 4
    src_t = r * 4 * 8 + dv[0]
    src_l = c * 4 * 8 + dv[1]
    src_b = src_t + bh * 8
    src_r = src_l + bw * 8
    if src_t < 0 or src_l < 0 or src_b > H * 8 or src_r > W * 8:
        return False
    # sub-8x8 chroma would read one more 2px column/row to the left/top
    if bw < 8 and (src_l >> 3) % 8 < 4:
        return False
    if bh < 8 and (src_t >> 3) % 8 < 4:
        return False
    active_sb_row = (r * 4) >> 6
    active_sb64_col = (c * 4) >> 6
    src_sb_row = ((src_b >> 3) - 1) >> 6
    src_sb64_col = ((src_r >> 3) - 1) >> 6
    active = active_sb_row * SB64_PER_ROW + active_sb64_col
    src = src_sb_row * SB64_PER_ROW + src_sb64_col
    if src >= active - DELAY_SB64:
        return False
    gradient = 1 + DELAY_SB64
    wf = gradient * (active_sb_row - src_sb_row)
    if src_sb_row > active_sb_row or \
            src_sb64_col >= active_sb64_col - DELAY_SB64 + wf:
        return False
    return True


def _intra_fill(rng, rows):
    """Random intra blocks (16x16 grid) covering mi rows [0, rows)."""
    blocks = []
    for r in range(0, rows, 4):
        for c in range(0, W // 4 // 4 * 4, 4):
            n = int(rng.integers(0, 5))
            blocks.append(EncBlock(
                r=r, c=c, bsize=C.BLOCK_16X16,
                y_mode=int(rng.choice([C.DC_PRED, C.V_PRED, C.H_PRED,
                                       C.SMOOTH_PRED, C.PAETH_PRED])),
                skip=n == 0,
                luma_coeffs=None if n == 0 else
                [[(int(rng.integers(1, 120)), int(rng.integers(0, 2)))
                  for _ in range(n)]]))
    return blocks


def run_case(seed, n_bc=12, sizes=(C.BLOCK_16X16,)):
    rng = np.random.default_rng(seed)
    blocks = _intra_fill(rng, 48)          # SB rows 0-2 are intra
    # intrabc blocks in SB rows 3-4, sources >= 3 SB rows up
    placed = 0
    occupied = set()
    tries = 0
    while placed < n_bc and tries < 500:
        tries += 1
        bsize = int(rng.choice(sizes))
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        r = int(rng.integers(48, (H // 4) - h4 + 1))
        c = int(rng.integers(0, (W // 4) - w4 + 1))
        cell_h = max(4, h4)
        cell_w = max(4, w4)
        r -= r % cell_h
        c -= c % cell_w
        if r < 48:
            continue
        if any((r + dr, c + dc) in occupied
               for dr in range(cell_h) for dc in range(cell_w)):
            continue
        # pick a source at least 3 SB rows above (full-pel, odd pixels
        # allowed: chroma then needs the half-pel bilinear taps)
        sy = int(rng.integers(0, max(1, r * 4 - 200)))
        sx = int(rng.integers(0, W - w4 * 4))
        dv = ((sy - r * 4) * 8, (sx - c * 4) * 8)
        if not dv_valid(r, c, bsize, dv):
            continue
        blocks.append(EncBlock(r=r, c=c, bsize=bsize, skip=True, dv=dv))
        # complete the 16x16 cell with sibling intra blocks so the
        # partition tree stays simple (HORZ/VERT/SPLIT of one cell)
        if (w4, h4) == (4, 2):
            blocks.append(EncBlock(r=r + 2, c=c, bsize=bsize, skip=True))
        elif (w4, h4) == (2, 4):
            blocks.append(EncBlock(r=r, c=c + 2, bsize=bsize, skip=True))
        elif (w4, h4) == (2, 2):
            for (dr, dc) in ((0, 2), (2, 0), (2, 2)):
                blocks.append(EncBlock(r=r + dr, c=c + dc, bsize=bsize,
                                       skip=True))
        for dr in range(cell_h):
            for dc in range(cell_w):
                occupied.add((r + dr, c + dc))
        placed += 1
    assert placed >= n_bc // 2, f"only placed {placed} intrabc blocks"
    # fill the remaining mi area of SB rows 3-4 with intra blocks
    for r in range(48, H // 4, 4):
        for c in range(0, W // 4, 4):
            if (r, c) in occupied:
                continue
            blocks.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                   skip=True))
    q = int(rng.integers(40, 180))
    tu = encode_frame(W, H, q, blocks, intrabc=True)
    tag = f"ibc{seed}"
    dav = dav1d_decode_ivf(make_ivf([tu], W, H), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intrabc_16x16(seed):
    run_case(seed)


def test_intrabc_mixed_sizes():
    run_case(7, n_bc=10, sizes=(C.BLOCK_8X8, C.BLOCK_16X16,
                                C.BLOCK_32X32, C.BLOCK_16X8,
                                C.BLOCK_8X16))


if __name__ == "__main__":
    run_case(0)
    print("ok")


def test_intrabc_pallas_pipe(monkeypatch):
    """intrabc frames through the device pipe: cls-11 units predict as
    dynamic slices of the partially reconstructed plane in the jax
    scan executor (two-stage bilinear taps resolved by the exporter);
    no C-recon fallback, bit-exact vs dav1d."""
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    run_case(3)
    run_case(7, n_bc=10, sizes=(C.BLOCK_8X8, C.BLOCK_16X16,
                                C.BLOCK_32X32, C.BLOCK_16X8,
                                C.BLOCK_8X16))
    assert native._PIPE_STATS["frames"] > 0
    assert native._PIPE_STATS["fallbacks"] == 0
