"""Device film-grain kernel vs the verified host reference
(fg_ref.FilmGrain, itself pinned to dav1d by test_av1_fg): bit-exact
on random planes across parameter shapes (overlap, lag, chroma modes,
restricted range, odd dims, 10-bit)."""

import numpy as np
import pytest

from easyav1.video.av1.fg_ref import FilmGrain
from easyav1.video.av1.headers import FilmGrainParams
from easyav1.video.av1.recon.fg_jax import DeviceFilmGrain


class _Color:
    def __init__(self, ssx=1, ssy=1, mono=False):
        self.subsampling_x = ssx
        self.subsampling_y = ssy
        self.mono_chrome = mono


class _Seq:
    def __init__(self, **kw):
        self.color = _Color(**kw)


def _params(**kw):
    fg = FilmGrainParams(apply_grain=True, grain_seed=kw.pop("seed", 7777),
                         num_y_points=2,
                         point_y_value=[0, 255], point_y_scaling=[64, 64],
                         ar_coeff_lag=kw.pop("lag", 2),
                         overlap_flag=kw.pop("overlap", True))
    lag = fg.ar_coeff_lag
    n = 2 * lag * (lag + 1)
    rng = np.random.default_rng(3)
    fg.ar_coeffs_y = (rng.integers(-20, 20, n)).tolist()
    fg.ar_coeffs_cb = (rng.integers(-20, 20, n + 1)).tolist()
    fg.ar_coeffs_cr = (rng.integers(-20, 20, n + 1)).tolist()
    for k, v in kw.items():
        setattr(fg, k, v)
    return fg


def _roundtrip(fg, w=97, h=66, bd=8, ssx=1, ssy=1, mono=False, seed=5):
    seq = _Seq(ssx=ssx, ssy=ssy, mono=mono)
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    planes = [rng.integers(0, mx + 1, (h, w)).astype(dt)]
    if not mono:
        planes += [rng.integers(0, mx + 1, (ch, cw)).astype(dt)
                   for _ in range(2)]
    want = FilmGrain(fg, seq, bd).apply(planes)
    got = DeviceFilmGrain(fg, seq, bd).apply(planes)
    for i, (a, b) in enumerate(zip(want, got)):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() == 0, (
            f"plane {i}: maxdiff {d.max()} at "
            f"{np.argwhere(d > 0)[:4].tolist()}")


def test_fg_jax_luma_only():
    _roundtrip(_params())


def test_fg_jax_no_overlap():
    _roundtrip(_params(overlap=False))


def test_fg_jax_lag0():
    _roundtrip(_params(lag=0))


def test_fg_jax_chroma():
    fg = _params()
    fg.num_cb_points = 2
    fg.point_cb_value = [0, 255]
    fg.point_cb_scaling = [48, 80]
    fg.num_cr_points = 3
    fg.point_cr_value = [0, 128, 255]
    fg.point_cr_scaling = [40, 60, 90]
    fg.cb_mult, fg.cb_luma_mult, fg.cb_offset = 140, 120, 300
    fg.cr_mult, fg.cr_luma_mult, fg.cr_offset = 110, 135, 220
    _roundtrip(fg)


def test_fg_jax_chroma_from_luma():
    fg = _params()
    fg.chroma_scaling_from_luma = True
    _roundtrip(fg)


def test_fg_jax_restricted_range():
    fg = _params()
    fg.clip_to_restricted_range = True
    _roundtrip(fg)


def test_fg_jax_block_multiple_dims():
    _roundtrip(_params(), w=128, h=64)


def test_fg_jax_odd_tail():
    _roundtrip(_params(), w=33, h=97)


def test_fg_jax_444():
    fg = _params()
    fg.num_cb_points = 2
    fg.point_cb_value = [0, 255]
    fg.point_cb_scaling = [48, 80]
    fg.cb_mult, fg.cb_luma_mult, fg.cb_offset = 140, 120, 300
    _roundtrip(fg, ssx=0, ssy=0)


def test_fg_jax_10bit():
    fg = _params()
    fg.grain_scaling = 10
    _roundtrip(fg, bd=10)


def test_fg_jax_device_pipe_e2e(monkeypatch):
    """EASYAV1_PIPE=device end-to-end: the backend routes grain through
    DeviceFilmGrain and the frame stays bit-exact vs dav1d."""
    from av1_synth import (assert_same, dav1d_decode_ivf, encode_frame,
                           make_ivf, my_decode_tu)
    from easyav1.video.av1 import constants as C
    rng = np.random.default_rng(11)
    from av1_synth import EncBlock
    blocks = []
    for r in range(0, 16, 4):
        for c in range(0, 16, 4):
            n = int(rng.integers(2, 9))
            coeffs = [[(int(rng.integers(1, 12)), int(rng.integers(0, 2)))
                       for _ in range(n)]]
            blocks.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                   skip=False, luma_coeffs=coeffs))
    tu = encode_frame(64, 64, 60, blocks,
                      fg={"seed": 77, "y_points": [(0, 80), (255, 60)],
                          "lag": 2,
                          "ar_y": [3, -4, 7, 1, 2, -6, 5, 0, 9, -2, 4, 1],
                          "overlap": True})
    dav = dav1d_decode_ivf(make_ivf([tu], 64, 64), "fgdev")[0]
    monkeypatch.setenv("EASYAV1_PIPE", "device")
    mine = my_decode_tu(tu)
    assert_same(dav, mine, "fg_device_pipe")


def test_fg_jax_real_stream_params():
    """Grain params shaped like libaom's denoise output (several y
    points, lag 3, both chroma planes)."""
    fg = _params(lag=3, seed=43962)
    fg.num_y_points = 6
    fg.point_y_value = [0, 40, 90, 140, 200, 255]
    fg.point_y_scaling = [30, 45, 60, 55, 40, 20]
    fg.num_cb_points = 2
    fg.point_cb_value = [0, 255]
    fg.point_cb_scaling = [20, 28]
    fg.num_cr_points = 2
    fg.point_cr_value = [0, 255]
    fg.point_cr_scaling = [18, 30]
    fg.cb_mult, fg.cb_luma_mult, fg.cb_offset = 128, 192, 256
    fg.cr_mult, fg.cr_luma_mult, fg.cr_offset = 134, 190, 260
    _roundtrip(fg, w=190, h=130)
