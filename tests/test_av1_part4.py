"""Conformance for 4:1 (HORZ_4/VERT_4) and AB (HORZ_A/B, VERT_A/B)
partitions via synthesized bitstreams decoded by libdav1d and our
decoder (found broken on real cpu-used<=3 libaom streams: SB-to-SB
parse desync once a 4:1 partition appears)."""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from av1_synth import (EncBlock, assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu)


def roundtrip(blocks, tag, w=64, h=64, q=40, **kw):
    tu = encode_frame(w, h, q, blocks, **kw)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


FILL = [EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
        EncBlock(8, 8, C.BLOCK_32X32)]


def test_horz4_16():
    """16x16 -> four 16x4 strips, plus neighbors after it in parse order."""
    blocks = [EncBlock(i, 0, C.BLOCK_16X4, skip=False,
                       luma_coeffs=[[(3 + i, i & 1)]]) for i in range(4)] \
        + [EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
           EncBlock(4, 4, C.BLOCK_16X16)] + FILL
    roundtrip(blocks, "p4_h16")


def test_vert4_16():
    blocks = [EncBlock(0, i, C.BLOCK_4X16, skip=False,
                       luma_coeffs=[[(2 + i, i & 1)]]) for i in range(4)] \
        + [EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
           EncBlock(4, 4, C.BLOCK_16X16)] + FILL
    roundtrip(blocks, "p4_v16")


def test_horz4_32():
    blocks = [EncBlock(2 * i, 0, C.BLOCK_32X8, skip=False,
                       luma_coeffs=[[(1 + i, 0), (2, 1)]]) for i in range(4)] \
        + FILL
    roundtrip(blocks, "p4_h32")


def test_vert4_32():
    blocks = [EncBlock(0, 2 * i, C.BLOCK_8X32, skip=False,
                       luma_coeffs=[[(1 + i, 1), (1, 0)]]) for i in range(4)] \
        + FILL
    roundtrip(blocks, "p4_v32")


def test_horz4_64():
    blocks = [EncBlock(4 * i, 0, C.BLOCK_64X16, skip=False,
                       luma_coeffs=[[(2, 0), (1 + i, 1)]]) for i in range(4)]
    roundtrip(blocks, "p4_h64")


def test_vert4_64():
    blocks = [EncBlock(0, 4 * i, C.BLOCK_16X64, skip=False,
                       luma_coeffs=[[(4, 0)], [(1 + i, 0)]])
              for i in range(4)]
    roundtrip(blocks, "p4_v64")


def test_4to1_then_next_sb():
    """The observed real-stream failure shape: a 4:1 partition in SB0,
    then content in SB1/SB2 — catches post-SB parse desync."""
    sb0 = [EncBlock(i, 0, C.BLOCK_16X4, skip=False,
                    luma_coeffs=[[(3, 0)]]) for i in range(4)] \
        + [EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
           EncBlock(4, 4, C.BLOCK_16X16)] + FILL
    sb1 = [EncBlock(16, 2 * i, C.BLOCK_8X32, skip=False,
                    luma_coeffs=[[(2 + i, i & 1)]]) for i in range(4)] \
        + [EncBlock(16, 8, C.BLOCK_32X32), EncBlock(24, 0, C.BLOCK_32X32),
           EncBlock(24, 8, C.BLOCK_32X32)]
    sb2 = [EncBlock(32 + 4 * i, 0, C.BLOCK_64X16, skip=False,
                    luma_coeffs=[[(1 + i, 0)]]) for i in range(4)]
    roundtrip(sb0 + sb1 + sb2, "p4_desync", w=64, h=192)


def test_horz4_modes_and_chroma():
    """Directional modes + chroma coeffs on 4:1 strips (chroma pairing
    for 4-tall rows)."""
    blocks = [EncBlock(i, 0, C.BLOCK_16X4, skip=False,
                       y_mode=C.V_PRED if i & 1 else C.H_PRED,
                       luma_coeffs=[[(2, 0)]],
                       chroma_coeffs=[[(1, 0)], [(2, 1)]] if i == 1 else None)
              for i in range(4)] \
        + [EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
           EncBlock(4, 4, C.BLOCK_16X16)] + FILL
    roundtrip(blocks, "p4_modes")


def test_horz_a():
    blocks = [EncBlock(0, 0, C.BLOCK_16X16), EncBlock(0, 4, C.BLOCK_16X16),
              EncBlock(4, 0, C.BLOCK_32X16, skip=False,
                       luma_coeffs=[[(3, 0), (1, 1)]])] + FILL
    roundtrip(blocks, "pab_ha")


def test_horz_b():
    blocks = [EncBlock(0, 0, C.BLOCK_32X16, skip=False,
                       luma_coeffs=[[(2, 1)]]),
              EncBlock(4, 0, C.BLOCK_16X16), EncBlock(4, 4, C.BLOCK_16X16)] \
        + FILL
    roundtrip(blocks, "pab_hb")


def test_vert_a():
    blocks = [EncBlock(0, 0, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
              EncBlock(0, 4, C.BLOCK_16X32, skip=False,
                       luma_coeffs=[[(1, 0), (1, 1)]])] + FILL
    roundtrip(blocks, "pab_va")


def test_vert_b():
    blocks = [EncBlock(0, 0, C.BLOCK_16X32, skip=False,
                       luma_coeffs=[[(4, 0)]]),
              EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 4, C.BLOCK_16X16)] \
        + FILL
    roundtrip(blocks, "pab_vb")


def test_ab_at_64():
    """AB partitions at the 64x64 level."""
    blocks = [EncBlock(0, 0, C.BLOCK_32X32), EncBlock(0, 8, C.BLOCK_32X32),
              EncBlock(8, 0, C.BLOCK_64X32, skip=False,
                       luma_coeffs=[[(2, 0)]])]
    roundtrip(blocks, "pab_ha64")
