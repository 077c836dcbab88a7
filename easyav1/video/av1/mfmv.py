"""Temporal motion vector projection (spec §7.9 motion field estimation
+ §7.20 mv storage).

Per-frame, per-8x8-cell motion vectors of up to 3 projected reference
motion fields feed the temporal candidates of find_mv_stack.  Semantics
mirror libaom av1_setup_motion_field / av1_copy_frame_mvs and were
validated bit-exact against libdav1d on real inter streams
(use_ref_frame_mvs=1).

Reference parity: easyav1 gets this behavior from dav1d
(src/easyav1.c decode path); this module is part of our from-scratch
AV1 decoder replacing it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from easyav1.video.av1 import constants as C

MAX_FRAME_DISTANCE = 31
REFMVS_LIMIT = (1 << 12) - 1
MFMV_STACK_SIZE = 3

# div_mult[d] ~ 2^14 / d (libaom table, truncating)
DIV_MULT = [0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820,
            1638, 1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862,
            819, 780, 744, 712, 682, 655, 630, 606, 585, 564, 546, 528]


def _clamp(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def mv_projection(mv_row: int, mv_col: int, num: int, den: int):
    """libaom get_mv_projection: scale mv by num/den in Q14."""
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 \
        else max(num, -MAX_FRAME_DISTANCE)
    out = []
    for v in (mv_row, mv_col):
        t = v * num * DIV_MULT[den]
        r = (t + 8192) >> 14 if t >= 0 else -((-t + 8192) >> 14)
        out.append(_clamp(r, -(1 << 14) + 1, (1 << 14) - 1))
    return out[0], out[1]


def save_tmvs(hdr, ref0_grid, ref1_grid, mvs_grid):
    """Per-8x8 mv storage at frame end (libaom av1_copy_frame_mvs,
    sampled at the odd mi of each cell).  Returns (ref8, mv8).
    Vectorized: list 1 (when eligible) overwrites list 0, matching the
    reference's per-cell write order."""
    mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    h8 = (mi_rows + 1) >> 1
    w8 = (mi_cols + 1) >> 1
    sign = hdr.ref_frame_sign_bias
    hints = hdr.order_hints
    cur = hdr.order_hint
    # ref_frame_side (libaom av1_calculate_ref_frame_side): skip refs
    # that are future-side or same-hint
    side = np.zeros(9, np.int8)
    for ref in range(C.LAST_FRAME, C.ALTREF_FRAME + 1):
        if sign[ref]:
            side[ref] = 1
        elif hints[ref] == cur:
            side[ref] = -1
    import easyav1.native as _nat
    _lib = _nat._load() if _nat.available() else None
    if _lib is not None and ref0_grid.dtype == np.int8 \
            and mvs_grid.dtype == np.int16:
        from easyav1.native import _vp
        ref8 = np.empty((h8, w8), np.int8)
        mv8 = np.empty((h8, w8, 2), np.int16)
        r0 = np.ascontiguousarray(ref0_grid)
        r1 = np.ascontiguousarray(ref1_grid)
        mg = np.ascontiguousarray(mvs_grid)
        sd = np.ascontiguousarray(side)
        _lib.av1_save_tmvs(mi_rows, mi_cols, _vp(sd), _vp(r0), _vp(r1),
                           _vp(mg), _vp(ref8), _vp(mv8))
        return ref8, mv8
    r_idx = np.minimum(2 * np.arange(h8) + 1, mi_rows - 1)
    c_idx = np.minimum(2 * np.arange(w8) + 1, mi_cols - 1)
    g0 = ref0_grid[r_idx][:, c_idx].astype(np.int32)
    g1 = ref1_grid[r_idx][:, c_idx].astype(np.int32)
    mvs = mvs_grid[r_idx][:, c_idx]          # (h8, w8, 2, 2)
    mv0 = mvs[:, :, 0, :].astype(np.int32)
    mv1 = mvs[:, :, 1, :].astype(np.int32)
    ok0 = (g0 > C.INTRA_FRAME) & (side[np.clip(g0, 0, 8)] == 0) \
        & (np.abs(mv0) <= REFMVS_LIMIT).all(-1)
    ok1 = (g1 > C.INTRA_FRAME) & (side[np.clip(g1, 0, 8)] == 0) \
        & (np.abs(mv1) <= REFMVS_LIMIT).all(-1)
    ref8 = np.where(ok1, g1, np.where(ok0, g0, C.NONE_FRAME)) \
        .astype(np.int8)
    mv8 = np.where(ok1[..., None], mv1,
                   np.where(ok0[..., None], mv0, 0)).astype(np.int16)
    return ref8, mv8


def setup_motion_field(hdr, seq, slot_states, slot_tmvs):
    """Project up to 3 reference motion fields into the current frame
    (libaom av1_setup_motion_field).

    slot_states: List[RefFrameState]; slot_tmvs: per-slot (ref8, mv8)
    or None.  Returns (tpl_mv (h8,w8,2) int16, tpl_off (h8,w8) int8)
    with tpl_off==0 marking invalid cells.
    """
    mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    h8 = (mi_rows + 1) >> 1
    w8 = (mi_cols + 1) >> 1
    tpl_mv = np.zeros((h8, w8, 2), np.int16)
    tpl_off = np.zeros((h8, w8), np.int8)

    def rel_dist(a, b):
        if not seq.enable_order_hint:
            return 0
        d = a - b
        m = 1 << (seq.order_hint_bits - 1)
        return (d & (m - 1)) - (d & m)

    cur = hdr.order_hint

    def project(ref, dir2):
        slot = hdr.ref_frame_idx[ref - C.LAST_FRAME]
        st = slot_states[slot]
        tm = slot_tmvs[slot]
        if tm is None or st is None:
            return 0
        if st.mi_rows != mi_rows or st.mi_cols != mi_cols \
                or st.frame_type in (C.KEY_FRAME, C.INTRA_ONLY_FRAME):
            return 0
        start_hint = st.order_hint
        saved = st.saved_order_hints or [0] * 8
        start_to_cur = rel_dist(start_hint, cur)
        ref_off = np.zeros(9, np.int32)
        for rf in range(C.LAST_FRAME, C.ALTREF_FRAME + 1):
            ref_off[rf] = rel_dist(start_hint, saved[rf])
        if dir2:
            start_to_cur = -start_to_cur
        ref8, mv8 = tm
        import easyav1.native as _nat
        _lib = _nat._load() if _nat.available() else None
        if _lib is not None and ref8.dtype == np.int8 \
                and mv8.dtype == np.int16:
            from easyav1.native import _vp
            ro = np.ascontiguousarray(ref_off, np.int32)
            r8c = np.ascontiguousarray(ref8)
            m8c = np.ascontiguousarray(mv8)
            _lib.av1_project_mvfield(mi_rows, mi_cols, _vp(r8c),
                                     _vp(m8c), _vp(ro),
                                     int(start_to_cur), int(bool(dir2)),
                                     _vp(tpl_mv), _vp(tpl_off))
            return 1
        # vectorized projection (mv_projection + get_block_position)
        srcref = ref8.astype(np.int32)
        off = ref_off[np.clip(srcref, 0, 8)]
        ok = (srcref > C.INTRA_FRAME) & (off > 0) \
            & (off <= MAX_FRAME_DISTANCE) \
            & (abs(start_to_cur) <= MAX_FRAME_DISTANCE)
        fr = mv8[:, :, 0].astype(np.int64)
        fc = mv8[:, :, 1].astype(np.int64)
        den = np.minimum(off, MAX_FRAME_DISTANCE)
        num = np.clip(start_to_cur, -MAX_FRAME_DISTANCE,
                      MAX_FRAME_DISTANCE)
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
        # get_block_position window: rows exactly the 64px band
        # (MAX_OFFSET_HEIGHT=0), cols within +-64px (8 cells each side)
        base_y = (ys >> 3) << 3
        base_x = (xs >> 3) << 3
        ok &= (row >= base_y) & (row < base_y + 8) \
            & (col >= base_x - 8) & (col < base_x + 16)
        ridx = row[ok]
        cidx = col[ok]
        # duplicate targets: numpy fancy assignment keeps the LAST
        # value in index order, matching the scalar loop's write order
        tpl_mv[ridx, cidx, 0] = fr[ok]
        tpl_mv[ridx, cidx, 1] = fc[ok]
        tpl_off[ridx, cidx] = off[ok]
        return 1

    hints = hdr.order_hints
    ref_stamp = MFMV_STACK_SIZE - 1
    last_slot = hdr.ref_frame_idx[0]
    last_st = slot_states[last_slot]
    if last_st is not None and slot_tmvs[last_slot] is not None:
        alt_of_last = (last_st.saved_order_hints or [0] * 8)[C.ALTREF_FRAME]
        is_overlay = alt_of_last == hints[C.GOLDEN_FRAME]
        if not is_overlay:
            project(C.LAST_FRAME, True)
        ref_stamp -= 1
    if rel_dist(hints[C.BWDREF_FRAME], cur) > 0:
        if project(C.BWDREF_FRAME, False):
            ref_stamp -= 1
    if rel_dist(hints[C.ALTREF2_FRAME], cur) > 0:
        if project(C.ALTREF2_FRAME, False):
            ref_stamp -= 1
    if rel_dist(hints[C.ALTREF_FRAME], cur) > 0 and ref_stamp >= 0:
        if project(C.ALTREF_FRAME, False):
            ref_stamp -= 1
    if ref_stamp >= 0:
        project(C.LAST2_FRAME, True)
    return tpl_mv, tpl_off
