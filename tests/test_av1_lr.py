"""Loop restoration conformance: synthesized streams with known
Wiener / self-guided unit parameters, decoded by libdav1d and our
decoder, compared bit-exact (spec §7.17, dav1d looprestoration)."""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from av1_synth import (EncBlock, assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu)


def blocks_with_texture(w4, h4, seed=7):
    """Non-skip 16x16 grid with pseudo-random coeffs so the filters see
    gradients and texture."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(0, h4, 4):
        for c in range(0, w4, 4):
            n = int(rng.integers(2, 9))
            coeffs = [[(int(rng.integers(1, 12)), int(rng.integers(0, 2)))
                       for _ in range(n)]]
            out.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                                luma_coeffs=coeffs,
                                chroma_coeffs=[[(3, 0)], [(2, 1)]]
                                if (r + c) % 8 == 0 else None))
    return out


def roundtrip(tag, w=64, h=64, q=60, lr=None, lr_units=None, seed=7,
              lf_levels=(0, 0)):
    blocks = blocks_with_texture(2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3),
                                 seed)
    tu = encode_frame(w, h, q, blocks, lr=lr, lr_units=lr_units,
                      lf_levels=lf_levels)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


W = C.RESTORE_WIENER
S = C.RESTORE_SGRPROJ
SW = C.RESTORE_SWITCHABLE


def test_lr_wiener_luma():
    roundtrip("lr_wy", lr=[W, 0, 0],
              lr_units={(0, 0, 0): ("wiener", [[2, -5, 20], [-1, 3, 10]])})


def test_lr_wiener_none_unit():
    """Frame type WIENER but the unit opts out (use_wiener = 0)."""
    roundtrip("lr_wnone", lr=[W, 0, 0], lr_units={})


def test_lr_wiener_chroma():
    """Chroma wiener (first tap forced 0)."""
    roundtrip("lr_wc", lr=[0, W, W],
              lr_units={(1, 0, 0): ("wiener", [[0, -3, 30], [0, 8, -10]]),
                        (2, 0, 0): ("wiener", [[0, 0, 15], [0, -7, 46]])})


def test_lr_sgr_both_passes():
    roundtrip("lr_s9", lr=[0, 0, S],
              lr_units={(2, 0, 0): ("sgr", 9, -10, 7)})


def test_lr_sgr_sets():
    """One set from each radius class: both, pass1-only, pass0-only."""
    roundtrip("lr_s0", lr=[S, 0, 0],
              lr_units={(0, 0, 0): ("sgr", 0, 20, 40)})
    roundtrip("lr_s11", lr=[S, 0, 0],
              lr_units={(0, 0, 0): ("sgr", 11, 0, 60)})
    roundtrip("lr_s14", lr=[S, 0, 0],
              lr_units={(0, 0, 0): ("sgr", 14, -30, 0)})


def test_lr_switchable():
    roundtrip("lr_sw", lr=[SW, 0, 0],
              lr_units={(0, 0, 0): ("wiener", [[5, -10, 30], [2, 2, 2]])})
    roundtrip("lr_sw2", lr=[SW, 0, 0],
              lr_units={(0, 0, 0): ("sgr", 3, 10, 20)})


def test_lr_multi_unit_stripes():
    """128x192 frame: 2x3 luma units of 64px, three 64-row stripes with
    the 8-row offset, predictive tap coding across units."""
    units = {}
    rng = np.random.default_rng(3)
    for ur in range(3):
        for uc in range(2):
            if (ur + uc) % 3 == 0:
                units[(0, ur, uc)] = ("wiener", [
                    [int(rng.integers(-5, 11)), int(rng.integers(-23, 9)),
                     int(rng.integers(-17, 47))] for _ in range(2)])
            elif (ur + uc) % 3 == 1:
                units[(0, ur, uc)] = ("sgr", int(rng.integers(0, 16)),
                                      -5, 20)
    # chroma plane: 96x64-px -> 2x1 units of 64 chroma px
    units[(1, 0, 0)] = ("sgr", 12, 0, 33)
    units[(1, 1, 0)] = ("wiener", [[0, 4, 12], [0, -2, 25]])
    roundtrip("lr_multi", w=128, h=192, lr=[SW, SW, 0], lr_units=units)


def test_lr_with_deblock():
    """Nonzero loop filter levels: the stripe boundary rows must come
    from the deblocked (pre-cdef) frame."""
    roundtrip("lr_lf", w=64, h=128, q=80, lr=[W, 0, 0],
              lr_units={(0, 0, 0): ("wiener", [[3, -2, 18], [1, 1, 24]]),
                        (0, 1, 0): ("sgr", 5, 25, 30)},
              lf_levels=(20, 20, 15, 15))
