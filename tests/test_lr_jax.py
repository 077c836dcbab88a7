"""Device loop-restoration kernel vs the verified host reference
(lr_ref.LoopRestoration, itself pinned to dav1d by test_av1_lr):
bit-exact on random planes across unit types, sgr sets, multi-unit
frames, odd dims and bitdepths."""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from easyav1.video.av1.lr_ref import LoopRestoration
from easyav1.video.av1.recon.lr_jax import DeviceLoopRestoration


class _Color:
    def __init__(self, ssx=1, ssy=1, mono=False):
        self.subsampling_x = ssx
        self.subsampling_y = ssy
        self.mono_chrome = mono


class _Seq:
    def __init__(self, **kw):
        np_ = kw.pop("num_planes", 3)
        self.color = _Color(**kw)
        self.color.num_planes = np_


class _Lr:
    def __init__(self, types, sizes):
        self.uses_lr = True
        self.frame_restoration_type = types
        self.loop_restoration_size = sizes


class _Hdr:
    def __init__(self, w, h, types, sizes):
        self.upscaled_width = w
        self.frame_height = h
        self.lr = _Lr(types, sizes)


class _Plan:
    def __init__(self):
        self.lr_type = {}
        self.lr_wiener = {}
        self.lr_sgr = {}


def _mk(w, h, bd=8, ssx=1, ssy=1, seed=3):
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    aw, ah = (w + 7) & ~7, (h + 7) & ~7
    cw, chh = (aw + ssx) >> ssx, (ah + ssy) >> ssy
    planes = [rng.integers(0, mx + 1, (ah, aw)).astype(np.int32)]
    planes += [rng.integers(0, mx + 1, (chh, cw)).astype(np.int32)
               for _ in range(2)]
    debl = [np.clip(p + rng.integers(-2, 3, p.shape), 0, mx)
            .astype(np.int32) for p in planes]
    return planes, debl


def _run(w, h, types, sizes, plan, bd=8, ssx=1, ssy=1, seed=3):
    seq = _Seq(ssx=ssx, ssy=ssy)
    hdr = _Hdr(w, h, types, sizes)
    planes, debl = _mk(w, h, bd=bd, ssx=ssx, ssy=ssy, seed=seed)
    want = [p.copy() for p in planes]
    got = [p.copy() for p in planes]
    LoopRestoration(hdr, seq, plan, bd).apply(want, debl)
    DeviceLoopRestoration(hdr, seq, plan, bd).apply(got, debl)
    for i, (a, b) in enumerate(zip(want, got)):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() == 0, (
            f"plane {i}: maxdiff {d.max()} at "
            f"{np.argwhere(d > 0)[:4].tolist()}")


W, S = C.RESTORE_WIENER, C.RESTORE_SGRPROJ


def test_lr_jax_wiener_luma():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[2, -5, 20], [-1, 3, 10]]
    _run(64, 64, [W, 0, 0], [256, 128, 128], plan)


def test_lr_jax_wiener_chroma():
    plan = _Plan()
    plan.lr_type[(1, 0, 0)] = W
    plan.lr_wiener[(1, 0, 0)] = [[0, -3, 30], [0, 8, -10]]
    plan.lr_type[(2, 0, 0)] = W
    plan.lr_wiener[(2, 0, 0)] = [[0, 0, 15], [0, -7, 46]]
    _run(64, 64, [0, W, W], [256, 128, 128], plan)


@pytest.mark.parametrize("sgr_set,xq0,xq1",
                         [(0, 20, 40), (9, -10, 7), (11, 0, 60),
                          (14, -30, 0)])
def test_lr_jax_sgr_sets(sgr_set, xq0, xq1):
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = S
    plan.lr_sgr[(0, 0, 0)] = (sgr_set, xq0, xq1)
    _run(64, 64, [S, 0, 0], [256, 128, 128], plan)


def test_lr_jax_multi_unit_mixed():
    """Several stripes and unit columns, wiener and sgr interleaved,
    some units absent (passthrough)."""
    plan = _Plan()
    rng = np.random.default_rng(11)
    for urow in range(3):
        for ucol in range(3):
            k = (urow + ucol) % 3
            if k == 0:
                plan.lr_type[(0, urow, ucol)] = W
                plan.lr_wiener[(0, urow, ucol)] = [
                    [int(rng.integers(-5, 6)), int(rng.integers(-16, 17)),
                     int(rng.integers(-20, 48))] for _ in range(2)]
            elif k == 1:
                plan.lr_type[(0, urow, ucol)] = S
                plan.lr_sgr[(0, urow, ucol)] = (
                    int(rng.integers(0, 16)), int(rng.integers(-50, 32)),
                    int(rng.integers(-20, 80)))
    _run(192, 160, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64], plan)


def test_lr_jax_odd_dims():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[5, -10, 30], [2, 2, 2]]
    plan.lr_type[(0, 1, 0)] = S
    plan.lr_sgr[(0, 1, 0)] = (3, 10, 20)
    _run(100, 132, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64], plan)


def test_lr_jax_10bit():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[-3, 12, 24], [4, -8, 40]]
    plan.lr_type[(0, 0, 1)] = S
    plan.lr_sgr[(0, 0, 1)] = (5, 15, 25)
    _run(192, 64, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64], plan,
         bd=10)


def test_lr_jax_12bit_sgr():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = S
    plan.lr_sgr[(0, 0, 0)] = (0, 25, 30)
    _run(64, 64, [S, 0, 0], [256, 128, 128], plan, bd=12)


def test_lr_jax_device_pipe_e2e(monkeypatch):
    """EASYAV1_PIPE=device end-to-end on a real LR stream: LF + CDEF +
    LR all run as device kernels, bit-exact vs dav1d."""
    from av1_synth import (assert_same, dav1d_decode_ivf, encode_frame,
                           make_ivf, my_decode_tu)
    rng = np.random.default_rng(5)
    from av1_synth import EncBlock
    blocks = []
    for r in range(0, 32, 4):
        for c in range(0, 32, 4):
            n = int(rng.integers(2, 9))
            coeffs = [[(int(rng.integers(1, 12)), int(rng.integers(0, 2)))
                       for _ in range(n)]]
            blocks.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                   skip=False, luma_coeffs=coeffs))
    tu = encode_frame(
        128, 128, 60, blocks,
        lr=[C.RESTORE_SWITCHABLE, C.RESTORE_WIENER, 0],
        lr_units={(0, 0, 0): ("wiener", [[2, -5, 20], [-1, 3, 10]]),
                  (0, 0, 1): ("sgr", 4, 12, 30),
                  (1, 0, 0): ("wiener", [[0, -3, 30], [0, 8, -10]])},
        lf_levels=(6, 4))
    dav = dav1d_decode_ivf(make_ivf([tu], 128, 128), "lrdev")[0]
    monkeypatch.setenv("EASYAV1_PIPE", "device")
    mine = my_decode_tu(tu)
    assert_same(dav, mine, "lr_device_pipe")


def test_lr_jax_chroma_sgr_420():
    plan = _Plan()
    plan.lr_type[(1, 0, 0)] = S
    plan.lr_sgr[(1, 0, 0)] = (7, 12, 18)
    _run(128, 128, [0, S, 0], [256, 128, 128], plan)


def test_lr_jax_apply_device_parity():
    """Device-resident apply (row-gather stripe assembly, at[].set
    writeback, mi-padded planes) is bit-exact vs the numpy apply."""
    import jax.numpy as jnp

    plan = _Plan()
    rng = np.random.default_rng(17)
    for urow in range(3):
        for ucol in range(3):
            k = (urow + ucol) % 3
            if k == 0:
                plan.lr_type[(0, urow, ucol)] = W
                plan.lr_wiener[(0, urow, ucol)] = [
                    [int(rng.integers(-5, 6)),
                     int(rng.integers(-16, 17)),
                     int(rng.integers(-20, 48))] for _ in range(2)]
            elif k == 1:
                plan.lr_type[(0, urow, ucol)] = S
                plan.lr_sgr[(0, urow, ucol)] = (
                    int(rng.integers(0, 16)),
                    int(rng.integers(-50, 32)),
                    int(rng.integers(-20, 80)))
    plan.lr_type[(1, 0, 0)] = S
    plan.lr_sgr[(1, 0, 0)] = (7, 12, 18)
    plan.lr_type[(2, 0, 0)] = W
    plan.lr_wiener[(2, 0, 0)] = [[0, 0, 15], [0, -7, 46]]
    w, h = 180, 150
    types = [C.RESTORE_SWITCHABLE, S, W]
    seq = _Seq()
    hdr = _Hdr(w, h, types, [64, 64, 64])
    planes, debl = _mk(w, h)
    want = [p.copy() for p in planes]
    lrr = DeviceLoopRestoration(hdr, seq, plan, 8)
    lrr.apply(want, debl)
    # device path gets mi-padded planes (extra margin must pass through)
    pad = [np.pad(p, ((0, 8), (0, 16)), constant_values=3)
           for p in planes]
    got = lrr.apply_device([jnp.asarray(p) for p in pad],
                           [jnp.asarray(d) for d in debl])
    for i in range(3):
        g = np.asarray(got[i])
        assert np.array_equal(g[:planes[i].shape[0],
                                :planes[i].shape[1]], want[i]), \
            f"plane {i} mismatch"
        assert (g[planes[i].shape[0]:] == 3).all()
        assert (g[:, planes[i].shape[1]:] == 3).all()
