"""AV1 conformance via synthesized bitstreams: our encoder produces
streams that libdav1d and our decoder must decode identically, locking
msac, syntax, contexts, transforms and intra prediction bit-exactly."""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from av1_synth import (EncBlock, assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu, synth_compare)


def roundtrip(blocks, tag, w=64, h=64, q=40, **kw):
    tu = encode_frame(w, h, q, blocks, **kw)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


def test_skip_single_block():
    roundtrip([EncBlock(0, 0, C.BLOCK_64X64)], "p_skip64")


def test_split_blocks():
    roundtrip([EncBlock(r, c, C.BLOCK_32X32) for r in (0, 8) for c in (0, 8)],
              "p_split")


def test_dc_coefficient():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, skip=False,
                        luma_coeffs=[[(5, 0)]]),
               EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
               EncBlock(8, 8, C.BLOCK_32X32)], "p_dc")


def test_modes_and_coeffs():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, y_mode=C.SMOOTH_PRED, skip=False,
                        luma_coeffs=[[(3, 1), (2, 0), (1, 1)]]),
               EncBlock(0, 8, C.BLOCK_32X32, y_mode=C.PAETH_PRED),
               EncBlock(8, 0, C.BLOCK_32X32, y_mode=C.V_PRED),
               EncBlock(8, 8, C.BLOCK_32X32, y_mode=C.H_PRED)], "p_modes")


def test_directional_modes():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, y_mode=C.SMOOTH_V_PRED,
                        uv_mode=C.SMOOTH_PRED),
               EncBlock(0, 8, C.BLOCK_32X32, y_mode=C.SMOOTH_H_PRED,
                        skip=False,
                        luma_coeffs=[[(7, 0), (1, 1), (2, 0), (3, 1),
                                      (1, 0), (1, 1)]]),
               EncBlock(8, 0, C.BLOCK_32X32, y_mode=C.D45_PRED),
               EncBlock(8, 8, C.BLOCK_32X32, y_mode=C.D135_PRED)], "p_dir")


def test_directional_modes2():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, skip=False,
                        luma_coeffs=[[(14, 0), (9, 1), (3, 0), (2, 1),
                                      (1, 0)]]),
               EncBlock(0, 8, C.BLOCK_32X32, y_mode=C.D203_PRED),
               EncBlock(8, 0, C.BLOCK_32X32, y_mode=C.D67_PRED),
               EncBlock(8, 8, C.BLOCK_32X32, y_mode=C.D113_PRED)], "p_dir2")


def test_cdf_adaptation():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, skip=False,
                        luma_coeffs=[[(5, 0)]]),
               EncBlock(0, 8, C.BLOCK_32X32, skip=False,
                        luma_coeffs=[[(3, 1), (2, 0), (1, 1)]]),
               EncBlock(8, 0, C.BLOCK_32X32), EncBlock(8, 8, C.BLOCK_32X32)],
              "p_adapt", adapt=True)


def test_tx_mode_select():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, skip=False,
                        luma_coeffs=[[(10, 0)]]),
               EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
               EncBlock(8, 8, C.BLOCK_32X32)], "p_txsel",
              tx_mode_select=True)


def test_adapt_and_txselect():
    roundtrip([EncBlock(0, 0, C.BLOCK_32X32, y_mode=C.SMOOTH_PRED, skip=False,
                        luma_coeffs=[[(3, 1), (2, 0), (1, 1)]]),
               EncBlock(0, 8, C.BLOCK_32X32, y_mode=C.SMOOTH_H_PRED,
                        skip=False,
                        luma_coeffs=[[(7, 0), (1, 1), (2, 0), (3, 1),
                                      (1, 0), (1, 1)]]),
               EncBlock(8, 0, C.BLOCK_32X32, y_mode=C.D45_PRED),
               EncBlock(8, 8, C.BLOCK_32X32, y_mode=C.H_PRED)],
              "p_both", adapt=True, tx_mode_select=True)


def test_tx64():
    roundtrip([EncBlock(0, 0, C.BLOCK_64X64, skip=False,
                        luma_coeffs=[[(10, 0), (4, 1), (3, 0), (2, 1),
                                      (1, 0), (1, 1), (2, 0)]])], "p_tx64")


def test_small_blocks():
    fill = [EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
            EncBlock(8, 8, C.BLOCK_32X32)]
    roundtrip([EncBlock(r, c, C.BLOCK_16X16) for r in (0, 4) for c in (0, 4)]
              + fill, "p_split16")
    roundtrip([EncBlock(0, 0, C.BLOCK_16X16, skip=False,
                        luma_coeffs=[[(5, 0), (2, 1)]])] +
              [EncBlock(r, c, C.BLOCK_16X16) for r in (0, 4) for c in (0, 4)
               if (r, c) != (0, 0)] + fill, "p_split16c")
    roundtrip([EncBlock(r, c, C.BLOCK_8X8) for r in (0, 2) for c in (0, 2)] +
              [EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
               EncBlock(4, 4, C.BLOCK_16X16)] + fill, "p_split8")


def test_rect_blocks():
    fill = [EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
            EncBlock(8, 8, C.BLOCK_32X32)]
    roundtrip([EncBlock(0, 0, C.BLOCK_16X32, skip=False,
                        luma_coeffs=[[(5, 0), (2, 1)]]),
               EncBlock(0, 4, C.BLOCK_16X32)] + fill, "p_r1632")
    roundtrip([EncBlock(0, 0, C.BLOCK_32X16, skip=False,
                        luma_coeffs=[[(0, 0), (3, 0), (1, 1)]]),
               EncBlock(4, 0, C.BLOCK_32X16)] + fill, "p_r3216")
    roundtrip([EncBlock(0, 0, C.BLOCK_8X16, skip=False,
                        luma_coeffs=[[(6, 0), (2, 0), (1, 1)]]),
               EncBlock(0, 2, C.BLOCK_8X16),
               EncBlock(4, 0, C.BLOCK_16X8, skip=False,
                        luma_coeffs=[[(1, 1), (2, 0)]]),
               EncBlock(6, 0, C.BLOCK_16X8),
               EncBlock(0, 4, C.BLOCK_16X16),
               EncBlock(4, 4, C.BLOCK_16X16)] + fill, "p_r8x16")


def test_rect64():
    cc = [(9, 0), (7, 1), (3, 0), (2, 1), (1, 0), (1, 1), (2, 0), (1, 1),
          (1, 0), (3, 1), (2, 0), (1, 0)]
    roundtrip([EncBlock(0, 0, C.BLOCK_64X32, skip=False, luma_coeffs=[cc]),
               EncBlock(8, 0, C.BLOCK_64X32)], "p_r6432", q=255)
    roundtrip([EncBlock(0, 0, C.BLOCK_32X64, skip=False, luma_coeffs=[cc]),
               EncBlock(0, 8, C.BLOCK_32X64)], "p_r3264", q=255)


def test_tx4x4_depth():
    fill2 = [EncBlock(2, 0, C.BLOCK_8X8), EncBlock(2, 2, C.BLOCK_8X8),
             EncBlock(0, 4, C.BLOCK_16X16), EncBlock(4, 0, C.BLOCK_16X16),
             EncBlock(4, 4, C.BLOCK_16X16), EncBlock(0, 8, C.BLOCK_32X32),
             EncBlock(8, 0, C.BLOCK_32X32), EncBlock(8, 8, C.BLOCK_32X32)]
    roundtrip([EncBlock(0, 0, C.BLOCK_8X8, skip=False, tx_depth=1,
                        luma_coeffs=[[(4, 0)], [(2, 1)], [],
                                     [(1, 0), (1, 1)]]),
               EncBlock(0, 2, C.BLOCK_8X8, skip=False, tx_depth=1,
                        luma_coeffs=[[(3, 0)], [], [], []])] + fill2,
              "p_tx44", tx_mode_select=True)


def test_golomb_level():
    roundtrip([EncBlock(0, 0, C.BLOCK_16X16, skip=False,
                        luma_coeffs=[[(127, 1), (20, 0)]])] +
              [EncBlock(r, c, C.BLOCK_16X16) for r in (0, 4) for c in (0, 4)
               if (r, c) != (0, 0)] +
              [EncBlock(0, 8, C.BLOCK_32X32), EncBlock(8, 0, C.BLOCK_32X32),
               EncBlock(8, 8, C.BLOCK_32X32)], "p_golomb", q=120)


def edge_roundtrip(blocks, tag, w, h, q=40, **kw):
    tu = encode_frame(w, h, q, blocks, **kw)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


def test_edge_partitions():
    edge_roundtrip([EncBlock(0, 0, C.BLOCK_32X64, skip=False,
                             luma_coeffs=[[(10, 0)]])], "p_edgeA", 16, 64)
    edge_roundtrip([EncBlock(0, 0, C.BLOCK_64X32, skip=False,
                             luma_coeffs=[[(10, 0)]])], "p_edgeH", 64, 16)
    edge_roundtrip([EncBlock(0, 0, C.BLOCK_32X32),
                    EncBlock(0, 8, C.BLOCK_32X32),
                    EncBlock(8, 0, C.BLOCK_32X32),
                    EncBlock(8, 8, C.BLOCK_32X32),
                    EncBlock(0, 16, C.BLOCK_16X32, skip=False,
                             luma_coeffs=[[(5, 0), (2, 1)]]),
                    EncBlock(8, 16, C.BLOCK_16X32)], "p_edge80", 80, 64)


def test_cdef_synth():
    blocks = [EncBlock(0, 0, C.BLOCK_32X32, skip=False,
                       luma_coeffs=[[(9, 0), (6, 1), (4, 0), (3, 1)]]),
              EncBlock(0, 8, C.BLOCK_32X32, y_mode=C.V_PRED, skip=False,
                       luma_coeffs=[[(7, 1), (2, 0)]]),
              EncBlock(8, 0, C.BLOCK_32X32, skip=False,
                       chroma_coeffs=[[(4, 0)], [(2, 1)]]),
              EncBlock(8, 8, C.BLOCK_32X32)]
    for cdef in ((3, [(4, 2, 3, 1)]), (6, [(15, 4, 15, 4)]),
                 (4, [(0, 2, 0, 0), (11, 0, 11, 0)], {(0, 0): 1})):
        tu = encode_frame(64, 64, 60, blocks, cdef=cdef)
        dav = dav1d_decode_ivf(make_ivf([tu], 64, 64), f"p_cdef{cdef[0]}")[0]
        mine = my_decode_tu(tu)
        assert_same(dav, mine, f"cdef{cdef}")
