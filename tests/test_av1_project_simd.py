"""av1_project_mvfield C-vs-numpy parity on randomized motion fields.

The AVX2 projection kernel (av1_recon_tmpl.h av1_project_mvfield) must
match the pure-numpy fallback in mfmv.setup_motion_field cell for cell,
including last-write-wins on duplicate scatter targets.  Reference
semantics: libaom av1_setup_motion_field (dav1d's
src/refmvs.c load_tmvs plays this role in the reference decoder).
"""

import numpy as np
import pytest

import easyav1.native as nat
from easyav1.video.av1.mfmv import DIV_MULT, MAX_FRAME_DISTANCE


def _numpy_project(mi_rows, mi_cols, ref8, mv8, ref_off, start_to_cur,
                   dir2, tpl_mv, tpl_off):
    """Mirror of the numpy fallback in mfmv.project (kept standalone so
    the test exercises the C kernel against independent math)."""
    h8 = (mi_rows + 1) >> 1
    w8 = (mi_cols + 1) >> 1
    srcref = ref8.astype(np.int32)
    off = ref_off[np.clip(srcref, 0, 8)]
    ok = (srcref > 0) & (off > 0) & (off <= MAX_FRAME_DISTANCE) \
        & (abs(start_to_cur) <= MAX_FRAME_DISTANCE)
    fr = mv8[:, :, 0].astype(np.int64)
    fc = mv8[:, :, 1].astype(np.int64)
    den = np.minimum(off, MAX_FRAME_DISTANCE)
    num = int(np.clip(start_to_cur, -MAX_FRAME_DISTANCE,
                      MAX_FRAME_DISTANCE))
    dmul = np.asarray(DIV_MULT, np.int64)[den]
    lim = (1 << 14) - 1

    def proj(v):
        t = v * num * dmul
        r = np.where(t >= 0, (t + 8192) >> 14, -((-t + 8192) >> 14))
        return np.clip(r, -lim, lim)

    pr, pc = proj(fr), proj(fc)
    roff = np.where(pr >= 0, pr >> 6, -((-pr) >> 6))
    coff = np.where(pc >= 0, pc >> 6, -((-pc) >> 6))
    ys = np.arange(h8, dtype=np.int64)[:, None]
    xs = np.arange(w8, dtype=np.int64)[None, :]
    row = ys - roff if dir2 else ys + roff
    col = xs - coff if dir2 else xs + coff
    ok &= (row >= 0) & (row < (mi_rows >> 1)) \
        & (col >= 0) & (col < (mi_cols >> 1))
    base_y = (ys >> 3) << 3
    base_x = (xs >> 3) << 3
    ok &= (row >= base_y) & (row < base_y + 8) \
        & (col >= base_x - 8) & (col < base_x + 16)
    ridx = row[ok]
    cidx = col[ok]
    tpl_mv[ridx, cidx, 0] = fr[ok]
    tpl_mv[ridx, cidx, 1] = fc[ok]
    tpl_off[ridx, cidx] = off[ok]


@pytest.mark.parametrize("seed", range(6))
def test_project_mvfield_matches_numpy(seed):
    lib = nat._load()
    if lib is None:
        pytest.skip("native library unavailable")
    from easyav1.native import _vp
    rng = np.random.default_rng(seed)
    # mix tiny, odd-size and 8-lane-aligned fields; dense + wild MVs
    mi_rows = int(rng.integers(2, 80))
    mi_cols = int(rng.integers(2, 140))
    h8 = (mi_rows + 1) >> 1
    w8 = (mi_cols + 1) >> 1
    ref8 = rng.integers(-1, 9, (h8, w8)).astype(np.int8)
    if seed % 3 == 0:
        ref8[rng.random((h8, w8)) < 0.7] = 0     # sparse field
    mv8 = rng.integers(-4095, 4096, (h8, w8, 2)).astype(np.int16)
    ref_off = rng.integers(-5, 40, 9).astype(np.int32)
    start_to_cur = int(rng.integers(-35, 36))
    dir2 = bool(seed & 1)

    tpl_mv_c = np.zeros((h8, w8, 2), np.int16)
    tpl_off_c = np.zeros((h8, w8), np.int8)
    lib.av1_project_mvfield(mi_rows, mi_cols, _vp(ref8), _vp(mv8),
                            _vp(ref_off), start_to_cur, int(dir2),
                            _vp(tpl_mv_c), _vp(tpl_off_c))

    tpl_mv_py = np.zeros((h8, w8, 2), np.int16)
    tpl_off_py = np.zeros((h8, w8), np.int8)
    _numpy_project(mi_rows, mi_cols, ref8, mv8, ref_off, start_to_cur,
                   dir2, tpl_mv_py, tpl_off_py)

    assert np.array_equal(tpl_off_c, tpl_off_py), seed
    assert np.array_equal(tpl_mv_c, tpl_mv_py), seed
