"""Superres conformance: synthesized streams coded at a downscaled
width (spec §5.9.8 superres_params), decoded by libdav1d and our
decoder, compared bit-exact — locks the normative upscaler (spec
§7.16, dav1d resize stage) and its interaction with LF/CDEF/LR."""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from av1_synth import (assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu)
from test_av1_lr import blocks_with_texture


def roundtrip_sr(tag, w, h, denom, q=60, seed=7, **kw):
    wd = (w * 8 + denom // 2) // denom
    blocks = blocks_with_texture(2 * ((wd + 7) >> 3), 2 * ((h + 7) >> 3),
                                 seed)
    tu = encode_frame(w, h, q, blocks, superres_denom=denom, **kw)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert mine["y"].shape == (h, w), (mine["y"].shape, (h, w))
    assert_same(dav, mine, tag)


@pytest.mark.parametrize("denom", range(9, 17))
def test_superres_denoms(denom):
    # w = 8*denom makes the coded width exactly 64 (the synthetic
    # encoder needs 16-aligned coded dims); each denom still exercises
    # a distinct step/phase schedule
    roundtrip_sr(f"sr_d{denom}", 8 * denom, 64, denom, seed=denom)


def test_superres_unaligned_coded_width():
    # coded width 57 (mi area wider than visible): locks the
    # aligned-edge tap rule
    roundtrip_sr("sr_odd", 64, 64, 9)


def test_superres_wide():
    roundtrip_sr("sr_wide", 192, 64, 16, seed=3)


def test_superres_with_lf():
    roundtrip_sr("sr_lf", 96, 64, 12, lf_levels=(24, 20))


def test_superres_with_cdef():
    roundtrip_sr("sr_cdef", 120, 64, 15,
                 cdef=(3, [(4, 2, 3, 1)]))


def test_superres_with_lr():
    W = C.RESTORE_WIENER
    roundtrip_sr("sr_lr", 88, 64, 11, lr=[W, 0, 0],
                 lr_units={(0, 0, 0): ("wiener", [[2, -5, 20],
                                                  [-1, 3, 10]])})


@pytest.mark.parametrize("denom", [9, 12, 16])
def test_superres_pallas_pipe(denom, monkeypatch):
    """Superres frames through the full device pipe: the sr_jax matmul
    upscaler runs between device CDEF and LR, no C-recon fallback."""
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    roundtrip_sr(f"sr_pipe_d{denom}", 8 * denom, 64, denom, seed=denom,
                 lf_levels=(12, 10), cdef=(3, [(4, 2, 3, 1)]))
    assert native._PIPE_STATS["frames"] > 0
    assert native._PIPE_STATS["fallbacks"] == 0


def test_superres_lr_pallas_pipe(monkeypatch):
    """Superres + loop restoration both on device in one frame (the
    upscaled deblocked snapshot feeds LR's stripe context)."""
    from easyav1 import native

    W = C.RESTORE_WIENER
    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    roundtrip_sr("sr_lr_pipe", 88, 64, 11, lr=[W, 0, 0],
                 lr_units={(0, 0, 0): ("wiener", [[2, -5, 20],
                                                  [-1, 3, 10]])},
                 lf_levels=(10, 8))
    assert native._PIPE_STATS["fallbacks"] == 0
