"""Minimal inter-frame AV1 encoder for conformance debugging.

Extends the intra synth encoder (av1_enc) with a non-reduced sequence
header, inter frame headers (error-resilient, order hints off, fixed
interp filter) and inter block coding: is_inter, single-ref tree,
new/nearest/near/global modes with the shared refmvs stack, drl, mv
residuals, optional residual coefficients.

Same methodology as the intra path: dav1d decoding these streams is the
ground truth for the symbol semantics; our decoder is then compared
per-pixel (and per-symbol via rng traces when debugging).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.av1_enc import (BitWriter, EncBlock, obu,
                                           SimpleTileEncoder)
from easyav1.video.av1.refmvs import RefMvFinder


@dataclasses.dataclass
class InterEncBlock(EncBlock):
    is_inter: bool = False
    ref: int = C.LAST_FRAME
    mode: int = C.NEARESTMV          # NEWMV/NEARESTMV/NEARMV/GLOBALMV
    mv: Tuple[int, int] = (0, 0)     # final mv (row, col) 1/8 pel
    ref_mv_idx: int = 0
    motion_mode: int = 0             # SIMPLE/OBMC_MOTION/WARPED
    interp: int = 0                  # switchable interp filter
    ref2: int = -1                   # second reference (compound)
    mv2: Tuple[int, int] = (0, 0)
    compound_idx: int = 1            # jnt: 1=average, 0=distance
    skip_mode: bool = False          # derived-compound skip mode
    interintra_mode: int = -1        # >=0: II_DC/V/H/SMOOTH
    ii_wedge: int = 0
    ii_wedge_idx: int = 0


def write_sequence_header_full(w: int, h: int,
                               order_hints: bool = False,
                               jnt: bool = False,
                               interintra: bool = False,
                               warp: bool = False,
                               sb128: bool = False) -> bytes:
    """Non-reduced profile-0 8-bit 4:2:0 sequence header; order hints
    (+ref_frame_mvs) optional; warp, dual filter, superres, cdef,
    restoration off."""
    bw = BitWriter()
    bw.f(0, 3)    # seq_profile
    bw.f(0, 1)    # still_picture
    bw.f(0, 1)    # reduced_still_picture_header
    bw.f(0, 1)    # timing_info_present
    bw.f(0, 1)    # initial_display_delay_present
    bw.f(0, 5)    # operating_points_cnt_minus_1
    bw.f(0, 12)   # operating_point_idc[0]
    bw.f(0, 5)    # seq_level_idx[0]
    bw.f(15, 4)   # frame_width_bits_minus_1
    bw.f(15, 4)   # frame_height_bits_minus_1
    bw.f(w - 1, 16)
    bw.f(h - 1, 16)
    bw.f(0, 1)    # frame_id_numbers_present
    bw.f(int(sb128), 1)    # use_128x128_superblock
    bw.f(0, 1)    # enable_filter_intra
    bw.f(0, 1)    # enable_intra_edge_filter
    bw.f(int(interintra), 1)    # enable_interintra_compound
    bw.f(0, 1)    # enable_masked_compound
    bw.f(int(warp), 1)    # enable_warped_motion
    bw.f(0, 1)    # enable_dual_filter
    bw.f(int(order_hints), 1)    # enable_order_hint
    if order_hints:
        bw.f(int(jnt), 1)        # enable_jnt_comp
        bw.f(1, 1)               # enable_ref_frame_mvs
    bw.f(1, 1)    # seq_choose_screen_content_tools -> SELECT
    bw.f(1, 1)    # seq_choose_integer_mv -> SELECT
    if order_hints:
        bw.f(6, 3)               # order_hint_bits_minus_1 -> 7 bits
    bw.f(0, 1)    # enable_superres
    bw.f(0, 1)    # enable_cdef
    bw.f(0, 1)    # enable_restoration
    # color_config
    bw.f(0, 1)    # high_bitdepth
    bw.f(0, 1)    # mono_chrome
    bw.f(0, 1)    # color_description_present
    bw.f(0, 1)    # color_range
    bw.f(0, 2)    # chroma_sample_position
    bw.f(0, 1)    # separate_uv_delta_q
    bw.f(0, 1)    # film_grain_params_present
    bw.f(1, 1)    # trailing bit
    return bw.bytes()


def write_frame_header_full(bw: BitWriter, frame_type: int, base_q: int,
                            refresh: int, hp_mv: bool = False,
                            adapt: bool = False, tx_select: bool = False,
                            switchable: bool = False,
                            w: int = 64, h: int = 64,
                            motion_switch: bool = False,
                            err: bool = True,
                            primary_ref: int = 7,
                            carry: bool = False,
                            order_hints: bool = False,
                            order_hint: int = 0,
                            slot_hints=None,
                            ref_idx=None,
                            use_rfm: bool = False,
                            ref_select: bool = False,
                            skip_allowed: bool = False,
                            skip_mode: bool = False,
                            warp: bool = False,
                            lf=None,
                            coded_size=None,
                            sb128: bool = False) -> None:
    """Frame header for the full sequence header above (mirrors
    headers.parse_frame_header bit-for-bit for this configuration)."""
    is_intra = frame_type in (C.KEY_FRAME, C.INTRA_ONLY_FRAME)
    bw.f(0, 1)              # show_existing_frame
    bw.f(frame_type, 2)
    bw.f(1, 1)              # show_frame
    is_key = frame_type == C.KEY_FRAME
    if not is_key:
        bw.f(int(err), 1)   # error_resilient_mode (KEY+show: implied)
    bw.f(0 if adapt else 1, 1)   # disable_cdf_update
    bw.f(0, 1)              # allow_screen_content_tools (SELECT)
    bw.f(1 if (coded_size and not is_intra) else 0, 1)  # frame_size_override
    if order_hints:
        bw.f(order_hint & 127, 7)
    # primary_ref_frame: intra or error-resilient -> no bits
    if not is_key and not err:
        bw.f(primary_ref, 3)
    if not is_key:
        bw.f(refresh, 8)    # refresh_frame_flags
    if order_hints and err and not (is_key and refresh == 0xFF):
        for i in range(8):
            bw.f((slot_hints or [0] * 8)[i] & 127, 7)
    if is_intra:
        bw.f(0, 1)          # render_and_frame_size_different
    else:
        if order_hints:
            bw.f(0, 1)      # frame_refs_short_signaling
        for i in range(C.REFS_PER_FRAME):
            bw.f((ref_idx or [0] * 7)[i], 3)   # ref_frame_idx[i]
        if coded_size:
            # frame_size(): explicit coded dims (scaled references);
            # requires error_resilient so frame_size_with_refs is not
            # taken (spec 5.9.5)
            assert err, "coded_size needs error_resilient_mode"
            bw.f(coded_size[0] - 1, 16)
            bw.f(coded_size[1] - 1, 16)
        # then render_size()
        bw.f(0, 1)          # render_and_frame_size_different
        if not False:       # force_integer_mv == 0
            bw.f(int(hp_mv), 1)   # allow_high_precision_mv
        bw.f(int(switchable), 1)  # is_filter_switchable
        if not switchable:
            bw.f(0, 2)      # interpolation_filter = EIGHTTAP
        bw.f(int(motion_switch), 1)   # is_motion_mode_switchable
        # use_ref_frame_mvs: only coded when order hints + ref-frame-mvs
        # are enabled in the sequence and not error-resilient
        if not err and order_hints:
            bw.f(int(use_rfm), 1)     # use_ref_frame_mvs
    if adapt:
        bw.f(0 if carry else 1, 1)   # disable_frame_end_update_cdf
    bw.f(1, 1)              # uniform_tile_spacing
    # single tile: emit a 0 increment bit per possible col/row doubling
    sb_shift = 5 if sb128 else 4
    sb_cols = (2 * ((w + 7) >> 3) + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (2 * ((h + 7) >> 3) + (1 << sb_shift) - 1) >> sb_shift
    def _tl2(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k
    for _ in range(_tl2(1, sb_cols)):
        bw.f(0, 1)
        break                # loop exits at the first 0 bit
    for _ in range(_tl2(1, sb_rows)):
        bw.f(0, 1)
        break
    bw.f(base_q, 8)         # base_q_idx
    bw.f(0, 1)              # delta_q_y_dc present
    if True:
        bw.f(0, 1)          # delta_q_u_dc
        bw.f(0, 1)          # delta_q_u_ac
    bw.f(0, 1)              # using_qmatrix
    bw.f(0, 1)              # segmentation_enabled
    bw.f(0, 1)              # delta_q_present
    # loop filter: lf = (l0, l1, u, v, sharpness) enables filtering
    # with delta_enabled=1 / delta_update=0 (spec default ref/mode
    # deltas apply: INTRA +1, GOLDEN/ALTREF/BWDREF -1)
    if lf is None:
        bw.f(0, 6)
        bw.f(0, 6)
        bw.f(0, 3)          # sharpness
        bw.f(0, 1)          # delta_enabled
    else:
        l0, l1, lu, lv, sharp = lf
        bw.f(l0, 6)
        bw.f(l1, 6)
        if l0 or l1:
            bw.f(lu, 6)
            bw.f(lv, 6)
        bw.f(sharp, 3)
        bw.f(1, 1)          # delta_enabled
        bw.f(0, 1)          # delta_update
    # cdef/lr skipped (disabled in seq)
    bw.f(int(tx_select), 1)  # tx_mode_select
    if not is_intra:
        bw.f(int(ref_select), 1)   # reference_select
    if skip_allowed:
        bw.f(int(skip_mode), 1)   # skip_mode_present
    # allow_warped_motion: only coded when inter + not error-resilient
    # + seq enable_warped_motion (spec uncompressed_header)
    if warp and not is_intra and not err:
        bw.f(1, 1)          # allow_warped_motion
    bw.f(0, 1)              # reduced_tx_set
    if not is_intra:
        for _ in range(C.REFS_PER_FRAME):
            bw.f(0, 1)      # is_global[ref]
    # film grain absent


class _HdrStub:
    """Just enough frame-header surface for RefMvFinder."""
    def __init__(self, hp_mv):
        self.gm_type = [C.IDENTITY] * 8
        self.gm_params = [[0] * 6 for _ in range(8)]
        self.allow_high_precision_mv = hp_mv
        self.force_integer_mv = False
        self.order_hint = 0
        self.order_hints = [0] * 8
        self.ref_frame_sign_bias = [False] * 8
        self.use_ref_frame_mvs = False


class InterTileEncoder(SimpleTileEncoder):
    def __init__(self, w, h, base_q, hp_mv=False, switchable=False,
                 motion_switch=False, allow_warp=False, ref_select=False,
                 jnt=False, interintra=False, **kw):
        super().__init__(w, h, base_q, **kw)
        self.enable_interintra = interintra
        self.switchable = switchable
        self.motion_switch = motion_switch
        self.allow_warp = allow_warp
        self.ref_select = ref_select
        self.jnt = jnt
        self.interp = np.zeros((2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3), 2),
                               np.int8)
        self.frame_is_intra = False
        self.hp_mv = hp_mv
        self.hdr = _HdrStub(hp_mv)
        self.mi_row_start = 0
        self.mi_col_start = 0
        self.mi_row_end = self.mi_rows
        self.mi_col_end = self.mi_cols
        self.ref_frames0 = np.full((self.mi_rows, self.mi_cols), -1,
                                   np.int8)
        self.ref_frames1 = np.full((self.mi_rows, self.mi_cols), -1,
                                   np.int8)
        self.mvs = np.zeros((self.mi_rows, self.mi_cols, 2, 2), np.int16)
        self.modes = np.zeros((self.mi_rows, self.mi_cols), np.int16)
        self.comp_group_grid = np.zeros((self.mi_rows, self.mi_cols),
                                        np.int8)
        self.comp_idx_grid = np.ones((self.mi_rows, self.mi_cols),
                                     np.int8)
        self.decoded_mi = np.zeros((self.mi_rows, self.mi_cols), bool)
        self.skip_mode_g = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.skip_mode_present = False
        self.skip_mode_frames = (C.LAST_FRAME, C.ALTREF_FRAME)
        # plan stub for RefMvFinder (bsize grid)
        class _Plan:
            pass
        self.plan = _Plan()
        self.plan.bsize = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.refmv = RefMvFinder(self)

    def _is_inside(self, r, c):
        return (0 <= r < self.mi_rows and 0 <= c < self.mi_cols
                and bool(self.decoded_mi[r, c]))

    def _has_tr(self, r, c, bsize):
        rr, cc = r - 1, c + C.BLOCK_W4[bsize]
        if rr < 0 or cc >= self.mi_cols:
            return False
        return bool(self.decoded_mi[rr, cc])

    # -- block encode (overrides the intra-only version) -------------------

    def _encode_block(self, blk):
        # skip_mode (spec read_skip_mode: coded before skip/is_inter for
        # every >=8x8 block when skip_mode_present)
        sm = False
        if (not self.frame_is_intra and self.skip_mode_present
                and C.BLOCK_W4[blk.bsize] * 4 >= 8
                and C.BLOCK_H4[blk.bsize] * 4 >= 8):
            r0, c0 = blk.r, blk.c
            smctx = 0
            if r0 > 0:
                smctx += int(self.skip_mode_g[r0 - 1, c0])
            if c0 > 0:
                smctx += int(self.skip_mode_g[r0, c0 - 1])
            sm = bool(getattr(blk, "skip_mode", False)) \
                and bool(getattr(blk, "is_inter", False))
            self._sym(self.cdf["skip_mode"][smctx], int(sm))
            h4g = min(C.BLOCK_H4[blk.bsize], self.mi_rows - r0)
            w4g = min(C.BLOCK_W4[blk.bsize], self.mi_cols - c0)
            self.skip_mode_g[r0:r0 + h4g, c0:c0 + w4g] = int(sm)
        if sm:
            self._encode_skip_mode_block(blk)
            return
        if self.frame_is_intra or not getattr(blk, "is_inter", False):
            if not self.frame_is_intra:
                self._encode_intra_in_inter(blk)
                return
            super()._encode_block(blk)
            self._post_grids(blk, C.INTRA_FRAME, (0, 0), blk.y_mode)
            return

        r, c, bsize = blk.r, blk.c, blk.bsize
        self._enc_skip(blk)
        self._enc_is_inter(blk, 1)

        avail_u = r > 0
        avail_l = c > 0
        ref2 = int(getattr(blk, "ref2", -1))
        is_comp = ref2 > C.INTRA_FRAME
        comp_allowed = (min(C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]) * 4 >= 8)
        if self.ref_select and comp_allowed:
            mctx = self._comp_mode_ctx(r, c, avail_u, avail_l)
            self._sym(self.cdf["comp_inter"][mctx], int(is_comp))
        if is_comp:
            self._encode_compound(blk, r, c, bsize, avail_u, avail_l)
            return

        # single-ref tree (mirror of TileDecoder._read_ref_frames)
        cnt = self._count_refs(r, c, avail_u, avail_l)
        fwd = cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME] + \
            cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME]
        bwd = cnt[C.BWDREF_FRAME] + cnt[C.ALTREF2_FRAME] + \
            cnt[C.ALTREF_FRAME]
        sr = self.cdf["single_ref"]
        ref = blk.ref
        is_bwd = ref >= C.BWDREF_FRAME
        self._sym(sr[self._ref_ctx(fwd, bwd)][0], int(is_bwd))
        if is_bwd:
            ctx2 = self._ref_ctx(cnt[C.ALTREF2_FRAME] + cnt[C.BWDREF_FRAME],
                                 cnt[C.ALTREF_FRAME])
            self._sym(sr[ctx2][1], int(ref == C.ALTREF_FRAME))
            if ref != C.ALTREF_FRAME:
                ctx6 = self._ref_ctx(cnt[C.BWDREF_FRAME],
                                     cnt[C.ALTREF2_FRAME])
                self._sym(sr[ctx6][5], int(ref == C.ALTREF2_FRAME))
        else:
            ctx3 = self._ref_ctx(cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME],
                                 cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME])
            last34 = ref in (C.LAST3_FRAME, C.GOLDEN_FRAME)
            self._sym(sr[ctx3][2], int(last34))
            if last34:
                ctx5 = self._ref_ctx(cnt[C.LAST3_FRAME],
                                     cnt[C.GOLDEN_FRAME])
                self._sym(sr[ctx5][4], int(ref == C.GOLDEN_FRAME))
            else:
                ctx4 = self._ref_ctx(cnt[C.LAST_FRAME],
                                     cnt[C.LAST2_FRAME])
                self._sym(sr[ctx4][3], int(ref == C.LAST2_FRAME))

        st = self.refmv.find(r, c, bsize, (ref, C.NONE_FRAME), False)

        # inter mode bools
        mode = blk.mode
        self._sym(self.cdf["newmv"][st.new_mv_ctx], int(mode != C.NEWMV))
        if mode != C.NEWMV:
            self._sym(self.cdf["zeromv"][st.zero_mv_ctx],
                      int(mode != C.GLOBALMV))
            if mode != C.GLOBALMV:
                self._sym(self.cdf["refmv"][st.ref_mv_ctx],
                          int(mode != C.NEARESTMV))
        # drl (clamp the requested index to what the stack can code)
        if mode in (C.NEARMV, C.NEAR_NEARMV):
            ref_mv_idx = min(max(1, blk.ref_mv_idx),
                             max(1, st.num_found - 1))
        else:
            ref_mv_idx = min(blk.ref_mv_idx, max(0, st.num_found - 1))
        if mode == C.NEWMV:
            for idx in range(2):
                if st.num_found > idx + 1:
                    stop = ref_mv_idx == idx
                    self._sym(self.cdf["drl"][self._drl_ctx(st, idx)],
                              int(not stop))
                    if stop:
                        break
        elif mode == C.NEARMV:
            for idx in range(1, 3):
                if st.num_found > idx + 1:
                    stop = ref_mv_idx == idx
                    self._sym(self.cdf["drl"][self._drl_ctx(st, idx)],
                              int(not stop))
                    if stop:
                        break
        # mv
        if mode == C.NEWMV:
            pred = self.refmv._lower_precision(st.mvs[ref_mv_idx][0])
            mv = blk.mv
            self._enc_mv(mv[0] - pred[0], mv[1] - pred[1])
        elif mode == C.NEARESTMV:
            mv = st.mvs[0][0]
        elif mode == C.NEARMV:
            mv = st.mvs[ref_mv_idx][0]
        else:
            mv = st.global_mvs[0]
        blk.mv = (int(mv[0]), int(mv[1]))
        # interintra (mirror of TileDecoder read order: before motion
        # mode, single-ref 8x8..32x32 with NEAREST..NEWMV)
        ii_on = False
        if (getattr(self, "enable_interintra", False)
                and C.NEARESTMV <= mode <= C.NEWMV
                and C.BLOCK_8X8 <= bsize <= C.BLOCK_32X32):
            from easyav1.video.av1.tile import SIZE_GROUP
            szg = SIZE_GROUP[bsize]
            ii = int(getattr(blk, "interintra_mode", -1))
            self._sym(self.cdf["interintra"][szg], int(ii >= 0))
            if ii >= 0:
                ii_on = True
                self._sym(self.cdf["interintra_mode"][szg], ii, 4)
                from easyav1.video.av1.wedge import wedge_allowed
                if wedge_allowed(bsize):
                    self._sym(self.cdf["wedge_interintra"][bsize],
                              int(blk.ii_wedge))
                    if blk.ii_wedge:
                        self._sym(self.cdf["wedge_idx"][bsize],
                                  blk.ii_wedge_idx, 16)
        # motion mode (mirror of TileDecoder._inter_mode_info gating)
        mm = int(getattr(blk, "motion_mode", 0))
        emitted_mm = 0
        if self.motion_switch and not ii_on:
            cands = self._find_warp_samples(r, c, bsize, ref,
                                            avail_u, avail_l)
            glob_block = (mode == C.GLOBALMV
                          and min(C.BLOCK_W4[bsize],
                                  C.BLOCK_H4[bsize]) * 4 >= 8
                          and self.hdr.gm_type[ref] > C.TRANSLATION
                          and not self.hdr.force_integer_mv)
            if (min(C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]) * 4 >= 8
                    and not glob_block
                    and self._has_overlappable(r, c, bsize, avail_u,
                                               avail_l)):
                if (len(cands) >= 1 and self.allow_warp
                        and not self.hdr.force_integer_mv):
                    self._sym(self.cdf["motion_mode"][bsize], mm, 3)
                else:
                    mm = min(mm, 1)
                    self._sym(self.cdf["obmc"][bsize],
                              int(mm == C.OBMC_MOTION))
                emitted_mm = mm
        blk.motion_mode = emitted_mm
        # spec needs_interp_filter: a large GLOBALMV block codes the
        # filter ONLY when GmType == TRANSLATION (IDENTITY suppresses)
        nontrans_global = (mode == C.GLOBALMV
                           and min(C.BLOCK_W4[bsize],
                                   C.BLOCK_H4[bsize]) * 4 >= 8
                           and self.hdr.gm_type[ref] != C.TRANSLATION)
        # interp filter (single symbol; dual filter disabled); not coded
        # for warped / non-translational global blocks
        filt = getattr(blk, "interp", 0)
        if emitted_mm == C.WARPED or nontrans_global:
            filt = 0
            blk.interp = 0
        elif self.switchable:
            ctx = (0 * 2 + 0) * 4
            left_type = 3
            above_type = 3
            if avail_l and (int(self.ref_frames0[r, c - 1]) == ref
                            or int(self.ref_frames1[r, c - 1]) == ref):
                left_type = int(self.interp[r, c - 1, 0])
            if avail_u and (int(self.ref_frames0[r - 1, c]) == ref
                            or int(self.ref_frames1[r - 1, c]) == ref):
                above_type = int(self.interp[r - 1, c, 0])
            if left_type == above_type:
                ctx += left_type
            elif left_type == 3:
                ctx += above_type
            elif above_type == 3:
                ctx += left_type
            else:
                ctx += 3
            self._sym(self.cdf["switchable_interp"][ctx], filt, 3)
        w4g = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4g = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        self.interp[r:r + h4g, c:c + w4g, 0] = filt
        self.interp[r:r + h4g, c:c + w4g, 1] = filt

        # residual
        tx_size = T.MAX_TX_SIZE_RECT[bsize]
        has_chroma = True
        if C.BLOCK_H4[bsize] == 1 and (r & 1) == 0:
            has_chroma = False
        if C.BLOCK_W4[bsize] == 1 and (c & 1) == 0:
            has_chroma = False
        if not blk.skip:
            if self.tx_mode_select:
                self._emit_var_tx_nosplit(r, c, bsize, tx_size)
            self._encode_residual_inter(blk, tx_size, has_chroma)
        else:
            self._clear_skip_ctx(blk, tx_size, has_chroma)

        self._post_grids(blk, blk.ref, blk.mv, blk.mode)
        if ii_on:
            w4g = min(C.BLOCK_W4[bsize], self.mi_cols - c)
            h4g = min(C.BLOCK_H4[bsize], self.mi_rows - r)
            self.ref_frames1[r:r + h4g, c:c + w4g] = C.INTRA_FRAME
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        if blk.skip:
            self.a_txw[c:c + w4] = w4 * 4
            self.l_txh[r:r + h4] = h4 * 4
        elif not self.tx_mode_select:
            self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
            self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]
        # else: the var-tx tree already published its LEAF dims to the
        # ctx arrays (parity: dav1d read_vartx_tree leaf set_ctx); a
        # max-tx overwrite here would desync txfm_partition contexts.
        self.a_skip[c:c + w4] = int(blk.skip)
        self.l_skip[r:r + h4] = int(blk.skip)
        self.a_mode[c:c + w4] = C.DC_PRED
        self.l_mode[r:r + h4] = C.DC_PRED

    def _encode_compound(self, blk, r, c, bsize, avail_u, avail_l):
        """Compound block emission (mirror of the decoder's compound
        arms: ref pair tree, compound mode, drl, per-component mvs,
        compound type)."""
        from easyav1.video.av1.tile import TileDecoder as _TDX
        ref, ref2 = blk.ref, blk.ref2
        cnt = self._count_refs(r, c, avail_u, avail_l)
        fwd = cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME] + \
            cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME]
        bwd = cnt[C.BWDREF_FRAME] + cnt[C.ALTREF2_FRAME] + \
            cnt[C.ALTREF_FRAME]
        uni = not (self._is_backward(ref) ^ self._is_backward(ref2))
        tctx = self._comp_ref_type_ctx(r, c, avail_u, avail_l)
        self._sym(self.cdf["comp_ref_type"][tctx], 0 if uni else 1)
        ucr = self.cdf["uni_comp_ref"]
        if uni:
            bwd_pair = ref == C.BWDREF_FRAME
            self._sym(ucr[self._ref_ctx(fwd, bwd)][0], int(bwd_pair))
            if not bwd_pair:
                ctx1 = self._ref_ctx(cnt[C.LAST2_FRAME],
                                     cnt[C.LAST3_FRAME]
                                     + cnt[C.GOLDEN_FRAME])
                not_l2 = ref2 != C.LAST2_FRAME
                self._sym(ucr[ctx1][1], int(not_l2))
                if not_l2:
                    ctx2 = self._ref_ctx(cnt[C.LAST3_FRAME],
                                         cnt[C.GOLDEN_FRAME])
                    self._sym(ucr[ctx2][2],
                              int(ref2 == C.GOLDEN_FRAME))
        else:
            cr = self.cdf["comp_ref"]
            cb = self.cdf["comp_bwdref"]
            ctx0 = self._ref_ctx(cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME],
                                 cnt[C.LAST3_FRAME]
                                 + cnt[C.GOLDEN_FRAME])
            hi = ref in (C.LAST3_FRAME, C.GOLDEN_FRAME)
            self._sym(cr[ctx0][0], int(hi))
            if hi:
                ctx2 = self._ref_ctx(cnt[C.LAST3_FRAME],
                                     cnt[C.GOLDEN_FRAME])
                self._sym(cr[ctx2][2], int(ref == C.GOLDEN_FRAME))
            else:
                ctx1 = self._ref_ctx(cnt[C.LAST_FRAME],
                                     cnt[C.LAST2_FRAME])
                self._sym(cr[ctx1][1], int(ref == C.LAST2_FRAME))
            bctx0 = self._ref_ctx(cnt[C.BWDREF_FRAME]
                                  + cnt[C.ALTREF2_FRAME],
                                  cnt[C.ALTREF_FRAME])
            self._sym(cb[bctx0][0], int(ref2 == C.ALTREF_FRAME))
            if ref2 != C.ALTREF_FRAME:
                bctx1 = self._ref_ctx(cnt[C.BWDREF_FRAME],
                                      cnt[C.ALTREF2_FRAME])
                self._sym(cb[bctx1][1], int(ref2 == C.ALTREF2_FRAME))

        st = self.refmv.find(r, c, bsize, (ref, ref2), True)
        mode = blk.mode
        cctx = self._compound_mode_ctx(st, r, c)
        self._sym(self.cdf["inter_compound_mode"][cctx],
                  mode - C.NEAREST_NEARESTMV, 8)
        # drl
        if mode in (C.NEW_NEWMV,):
            ref_mv_idx = min(blk.ref_mv_idx, max(0, st.num_found - 1))
            for idx in range(2):
                if st.num_found > idx + 1:
                    stop = ref_mv_idx == idx
                    self._sym(self.cdf["drl"][self._drl_ctx(st, idx)],
                              int(not stop))
                    if stop:
                        break
        elif mode in (C.NEAR_NEARMV, C.NEAR_NEWMV, C.NEW_NEARMV):
            ref_mv_idx = min(max(1, blk.ref_mv_idx),
                             max(1, st.num_found - 1))
            for idx in range(1, 3):
                if st.num_found > idx + 1:
                    stop = ref_mv_idx == idx
                    self._sym(self.cdf["drl"][self._drl_ctx(st, idx)],
                              int(not stop))
                    if stop:
                        break
        else:
            ref_mv_idx = 0
        # per-component mvs
        comps = _TDX._COMP_COMPONENTS[mode]
        mvs = []
        want = (blk.mv, blk.mv2)
        for i, m in enumerate(comps):
            if m == C.NEARESTMV:
                mv = st.mvs[0][i]
            elif m == C.NEARMV:
                mv = st.mvs[ref_mv_idx][i]
            elif m == C.GLOBALMV:
                mv = st.global_mvs[i]
            else:
                pred = self.refmv._lower_precision(st.mvs[ref_mv_idx][i])
                mv = want[i]
                self._enc_mv(mv[0] - pred[0], mv[1] - pred[1])
            mvs.append((int(mv[0]), int(mv[1])))
        blk.mv = mvs[0]
        blk.mv2 = mvs[1]
        # compound type: masked compound off in the synth seq header;
        # jnt (dist-wtd) optional
        compound_idx = int(getattr(blk, "compound_idx", 1))
        if self.jnt:
            ictx = self._comp_index_ctx(r, c, (ref, ref2), avail_u,
                                        avail_l)
            self._sym(self.cdf["compound_index"][ictx], compound_idx)
        else:
            compound_idx = 1
        # interp filter (switchable compound emission not wired yet)
        assert not self.switchable, "switchable interp + compound TODO"
        filt = getattr(blk, "interp", 0)
        w4g = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4g = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        self.interp[r:r + h4g, c:c + w4g, 0] = filt
        self.interp[r:r + h4g, c:c + w4g, 1] = filt
        # residual
        tx_size = T.MAX_TX_SIZE_RECT[bsize]
        has_chroma = True
        if C.BLOCK_H4[bsize] == 1 and (r & 1) == 0:
            has_chroma = False
        if C.BLOCK_W4[bsize] == 1 and (c & 1) == 0:
            has_chroma = False
        if not blk.skip:
            if self.tx_mode_select:
                self._emit_var_tx_nosplit(r, c, bsize, tx_size)
            self._encode_residual_inter(blk, tx_size, has_chroma)
        else:
            self._clear_skip_ctx(blk, tx_size, has_chroma)
        self._post_grids_comp(blk, ref, ref2, blk.mv, blk.mv2, mode,
                              compound_idx)
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        if blk.skip:
            self.a_txw[c:c + w4] = w4 * 4
            self.l_txh[r:r + h4] = h4 * 4
        elif not self.tx_mode_select:
            self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
            self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]
        self.a_skip[c:c + w4] = int(blk.skip)
        self.l_skip[r:r + h4] = int(blk.skip)
        self.a_mode[c:c + w4] = C.DC_PRED
        self.l_mode[r:r + h4] = C.DC_PRED

    def _encode_skip_mode_block(self, blk):
        """Skip-mode block: no further symbols; state mirrors the
        decoder's derived NEAREST_NEARESTMV compound from the header's
        skip-mode ref pair."""
        r, c, bsize = blk.r, blk.c, blk.bsize
        ref, ref2 = self.skip_mode_frames
        st = self.refmv.find(r, c, bsize, (ref, ref2), True)
        mv, mv2 = st.mvs[0]
        blk.ref, blk.ref2 = ref, ref2
        blk.mv = (int(mv[0]), int(mv[1]))
        blk.mv2 = (int(mv2[0]), int(mv2[1]))
        blk.mode = C.NEAREST_NEARESTMV
        blk.skip = True
        blk.motion_mode = 0
        blk.interp = 0
        tx_size = T.MAX_TX_SIZE_RECT[bsize]
        self._clear_skip_ctx(blk, tx_size, True)
        self._post_grids_comp(blk, ref, ref2, blk.mv, blk.mv2,
                              C.NEAREST_NEARESTMV, 1)
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        w4g = min(w4, self.mi_cols - c)
        h4g = min(h4, self.mi_rows - r)
        self.interp[r:r + h4g, c:c + w4g] = 0
        self.a_txw[c:c + w4] = w4 * 4
        self.l_txh[r:r + h4] = h4 * 4
        self.a_skip[c:c + w4] = 1
        self.l_skip[r:r + h4] = 1
        self.a_mode[c:c + w4] = C.DC_PRED
        self.l_mode[r:r + h4] = C.DC_PRED

    def _post_grids_comp(self, blk, ref, ref2, mv, mv2, mode, comp_idx):
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        self.ref_frames0[r:r + h4, c:c + w4] = ref
        self.ref_frames1[r:r + h4, c:c + w4] = ref2
        self.mvs[r:r + h4, c:c + w4, 0, 0] = mv[0]
        self.mvs[r:r + h4, c:c + w4, 0, 1] = mv[1]
        self.mvs[r:r + h4, c:c + w4, 1, 0] = mv2[0]
        self.mvs[r:r + h4, c:c + w4, 1, 1] = mv2[1]
        self.modes[r:r + h4, c:c + w4] = mode
        self.comp_group_grid[r:r + h4, c:c + w4] = 0
        self.comp_idx_grid[r:r + h4, c:c + w4] = comp_idx
        self.plan.bsize[r:r + h4, c:c + w4] = bsize
        self.decoded_mi[r:r + h4, c:c + w4] = True

    def _emit_var_tx_nosplit(self, r, c, bsize, tx_size):
        """txfm_partition bits = 0 for every max-tx unit (no split)."""
        w4 = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        if tx_size == C.TX_4X4:
            # no symbol, but the leaf still publishes its dims to the
            # txfm-partition ctx lines (mirror _var_tx_node leaf)
            self.a_txw[c:c + w4] = 4
            self.l_txh[r:r + h4] = 4
            return
        max_sq = T.TX_SIZE_SQR_UP[T.MAX_TX_SIZE_RECT[bsize]]
        for yy in range(0, h4, T.TX_H4[tx_size]):
            for xx in range(0, w4, T.TX_W4[tx_size]):
                txw = T.TX_WIDTH[tx_size]
                txh = T.TX_HEIGHT[tx_size]
                above = r + yy > 0 and int(self.a_txw[c + xx]) < txw
                left = c + xx > 0 and int(self.l_txh[r + yy]) < txh
                cat = ((T.TX_SIZE_SQR_UP[tx_size] != max_sq
                        and max_sq > C.TX_8X8)
                       + (C.TX_SIZES - 1 - max_sq) * 2)
                ctx = cat * 3 + above + left
                self._sym(self.cdf["txfm_partition"][ctx], 0)
                self.a_txw[c + xx:c + xx + T.TX_W4[tx_size]] = txw
                self.l_txh[r + yy:r + yy + T.TX_H4[tx_size]] = txh

    SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
                  0, 0, 1, 1, 2, 2]

    def _encode_intra_in_inter(self, blk):
        r, c, bsize = blk.r, blk.c, blk.bsize
        self._enc_skip(blk)
        self._enc_is_inter(blk, 0)
        self._sym(self.cdf["y_mode"][self.SIZE_GROUP[bsize]], blk.y_mode)
        if bsize >= C.BLOCK_8X8 and C.V_PRED <= blk.y_mode <= C.D67_PRED:
            self._sym(self.cdf["angle_delta"][blk.y_mode - C.V_PRED],
                      blk.angle_y + 3)
        # chroma mode (cfl-capable sizes get the 14-symbol row); only
        # coded when this block carries chroma (4-row/col pairing rule)
        has_chroma_mi = not (
            (C.BLOCK_H4[bsize] == 1 and (r & 1) == 0)
            or (C.BLOCK_W4[bsize] == 1 and (c & 1) == 0))
        if has_chroma_mi:
            cfl_allowed = (C.BLOCK_W4[bsize] * 4 <= 32
                           and C.BLOCK_H4[bsize] * 4 <= 32)
            nsym = 14 if cfl_allowed else 13
            self._sym(self.cdf["uv_mode"][1 if cfl_allowed else 0]
                      [blk.y_mode], blk.uv_mode, nsym)
            if blk.uv_mode == C.UV_CFL_PRED:
                au, av = getattr(blk, "cfl_alphas", None) or (0, 0)
                sign_u = 0 if au == 0 else (1 if au < 0 else 2)
                sign_v = 0 if av == 0 else (1 if av < 0 else 2)
                joint = sign_u * 3 + sign_v - 1
                self._sym(self.cdf["cfl_sign"][0], joint, 8)
                if sign_u:
                    ctx = (3 if sign_u == 2 else 0) + sign_v
                    self._sym(self.cdf["cfl_alpha"][ctx], abs(au) - 1, 16)
                if sign_v:
                    ctx = (3 if sign_v == 2 else 0) + sign_u
                    self._sym(self.cdf["cfl_alpha"][ctx], abs(av) - 1, 16)
            if (bsize >= C.BLOCK_8X8
                    and C.V_PRED <= blk.uv_mode <= C.D67_PRED):
                self._sym(self.cdf["angle_delta"][blk.uv_mode - C.V_PRED],
                          blk.angle_uv + 3)
        # filter_intra flag (mirrors TileDecoder._intra_mode_info; only
        # when the sequence enables the tool — synth sequences do not)
        if (getattr(getattr(self, "seq", None), "enable_filter_intra",
                    False)
                and blk.y_mode == C.DC_PRED
                and C.BLOCK_W4[bsize] * 4 <= 32
                and C.BLOCK_H4[bsize] * 4 <= 32):
            fi = getattr(blk, "filter_intra", None)
            self._sym(self.cdf["filter_intra_use"][bsize],
                      int(fi is not None))
            if fi is not None:
                self._sym(self.cdf["filter_intra_mode"][0], fi, 5)
        # tx size (TX_MODE_SELECT: intra blocks code the depth symbol)
        tx_size = T.MAX_TX_SIZE_RECT[bsize]
        if self.tx_mode_select and bsize != C.BLOCK_4X4:
            max_depth = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4,
                         2, 2, 3, 3, 4, 4][bsize]
            cat = max(0, min(T.TX_SIZE_SQR_UP[tx_size] - 1, 3))
            above = int(self.a_txw[c]) >= T.TX_WIDTH[tx_size]
            left = int(self.l_txh[r]) >= T.TX_HEIGHT[tx_size]
            # INTER neighbors contribute their BLOCK dims (libaom
            # get_tx_size_context), not leaf-tx dims
            if r > 0 and int(self.ref_frames0[r - 1, c]) > C.INTRA_FRAME:
                nb = int(self.plan.bsize[r - 1, c])
                above = C.BLOCK_W4[nb] * 4 >= T.TX_WIDTH[tx_size]
            if c > 0 and int(self.ref_frames0[r, c - 1]) > C.INTRA_FRAME:
                nb = int(self.plan.bsize[r, c - 1])
                left = C.BLOCK_H4[nb] * 4 >= T.TX_HEIGHT[tx_size]
            actx = int(above) + int(left)
            nsym2 = 2 if cat == 0 else min(max_depth, 2) + 1
            self._sym(self.cdf["tx_size"][cat][actx], blk.tx_depth, nsym2)
            for _ in range(blk.tx_depth):
                tx_size = T.SPLIT_TX_SIZE[tx_size]
        has_chroma = True
        if C.BLOCK_H4[bsize] == 1 and (r & 1) == 0:
            has_chroma = False
        if C.BLOCK_W4[bsize] == 1 and (c & 1) == 0:
            has_chroma = False
        if not blk.skip:
            self._encode_residual(blk, tx_size, has_chroma)
        else:
            self._clear_skip_ctx(blk, tx_size, has_chroma)
        self._post_grids(blk, C.INTRA_FRAME, (0, 0), blk.y_mode)
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
        self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]
        self.a_skip[c:c + w4] = int(blk.skip)
        self.l_skip[r:r + h4] = int(blk.skip)
        self.a_mode[c:c + w4] = blk.y_mode
        self.l_mode[r:r + h4] = blk.y_mode

    def _enc_skip(self, blk):
        r, c = blk.r, blk.c
        ctx = 0
        if r > 0:
            ctx += int(self.a_skip[c])
        if c > 0:
            ctx += int(self.l_skip[r])
        self._sym(self.cdf["skip"][ctx], int(blk.skip))

    def _enc_is_inter(self, blk, v):
        r, c = blk.r, blk.c
        avail_u = r > 0
        avail_l = c > 0
        if avail_u and avail_l:
            ai = int(self.ref_frames0[r - 1, c]) == C.INTRA_FRAME
            li = int(self.ref_frames0[r, c - 1]) == C.INTRA_FRAME
            ctx = 3 if (ai and li) else int(ai or li)
        elif avail_u or avail_l:
            nb = (int(self.ref_frames0[r - 1, c]) == C.INTRA_FRAME
                  if avail_u else
                  int(self.ref_frames0[r, c - 1]) == C.INTRA_FRAME)
            ctx = 2 * int(nb)
        else:
            ctx = 0
        self._sym(self.cdf["intra_inter"][ctx], v)

    def _count_refs(self, r, c, avail_u, avail_l):
        counts = [0] * 8
        for rr, cc, av in ((r - 1, c, avail_u), (r, c - 1, avail_l)):
            if not av:
                continue
            f0 = int(self.ref_frames0[rr, cc])
            f1 = int(self.ref_frames1[rr, cc])
            if f0 > C.INTRA_FRAME:
                counts[f0] += 1
            if f1 > C.INTRA_FRAME:
                counts[f1] += 1
        return counts

    @staticmethod
    def _ref_ctx(c0, c1):
        if c0 == c1:
            return 1
        return 0 if c0 < c1 else 2

    @staticmethod
    def _drl_ctx(st, idx):
        if st.weights[idx] >= 640:
            return 0 if st.weights[idx + 1] >= 640 else 1
        return 2

    def _enc_mv(self, dr, dc, prefix="mv", force_int=False):
        joint = (2 if dr else 0) | (1 if dc else 0)
        jmap = {0: C.MV_JOINT_ZERO, 1: C.MV_JOINT_HNZVZ,
                2: C.MV_JOINT_HZVNZ, 3: C.MV_JOINT_HNZVNZ}
        self._sym(self.cdf[f"{prefix}_joint"][0], jmap[joint])
        if dr:
            self._enc_mv_component(0, dr, prefix, force_int)
        if dc:
            self._enc_mv_component(1, dc, prefix, force_int)

    def _enc_mv_component(self, comp, v, prefix="mv", force_int=False):
        cdf = self.cdf
        hp_coded = self.hp_mv and prefix == "mv"
        sign = int(v < 0)
        mag = abs(v)
        self._sym(cdf[f"{prefix}_sign_{comp}"][0], sign)
        # find class: mag-1 in [0, 16) -> class0
        m = mag - 1
        if m < 16:
            self._sym(cdf[f"{prefix}_classes_{comp}"][0], 0)
            int_bit = (m >> 3) & 1
            fr = (m >> 1) & 3
            hp = m & 1
            self._sym(cdf[f"{prefix}_class0_{comp}"][0], int_bit)
            if force_int:
                assert fr == 3, "integer-mv diff must be full-pel"
            else:
                self._sym(cdf[f"{prefix}_class0_fr_{comp}"][int_bit], fr)
            if hp_coded:
                self._sym(cdf[f"{prefix}_class0_hp_{comp}"][0], hp)
            else:
                assert hp == 1, "1/8-pel diff needs allow_high_precision"
        else:
            cls = 1
            while mag >= (2 << (cls + 3)) + 1 and cls < 10:
                cls += 1
            # mag in [CLASS0_SIZE << (cls+2) .. *2): offset encoding
            base = 2 << (cls + 2)
            off = mag - base - 1
            d = off >> 3
            fr = (off >> 1) & 3
            hp = off & 1
            self._sym(cdf[f"{prefix}_classes_{comp}"][0], cls)
            for i in range(cls):
                self._sym(cdf[f"{prefix}_bits_{comp}"][i], (d >> i) & 1)
            if force_int:
                assert fr == 3, "integer-mv diff must be full-pel"
            else:
                self._sym(cdf[f"{prefix}_fr_{comp}"][0], fr)
            if hp_coded:
                self._sym(cdf[f"{prefix}_hp_{comp}"][0], hp)
            else:
                assert hp == 1

    def _post_grids(self, blk, ref, mv, mode):
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        self.ref_frames0[r:r + h4, c:c + w4] = ref
        self.ref_frames1[r:r + h4, c:c + w4] = C.NONE_FRAME
        self.mvs[r:r + h4, c:c + w4, 0, 0] = mv[0]
        self.mvs[r:r + h4, c:c + w4, 0, 1] = mv[1]
        self.modes[r:r + h4, c:c + w4] = mode
        self.plan.bsize[r:r + h4, c:c + w4] = bsize
        self.decoded_mi[r:r + h4, c:c + w4] = True

    def _clear_skip_ctx(self, blk, tx_size, has_chroma):
        # mirror TileDecoder._clear_coef_ctx: chroma lines are cleared
        # only when the block carries chroma (4xN pairing rule)
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        planes = (0, 1, 2) if has_chroma else (0,)
        for p in planes:
            x4 = c >> (1 if p else 0)
            y4 = r >> (1 if p else 0)
            ww = max(1, w4 >> (1 if p else 0))
            hh = max(1, h4 >> (1 if p else 0))
            self.a_lvl[p][x4:x4 + ww] = 0
            self.l_lvl[p][y4:y4 + hh] = 0
            self.a_sign[p][x4:x4 + ww] = 0
            self.l_sign[p][y4:y4 + hh] = 0

    def _encode_residual_inter(self, blk, tx_size, has_chroma):
        # inter tx type must be DCT_DCT; _encode_txb's tx-type emission
        # handles the inter sets via self.frame_is_intra
        self._encode_residual(blk, tx_size, has_chroma)


class IntraBcTileEncoder(InterTileEncoder):
    """Keyframe encoder with intra block copy (mirror of the decoder's
    use_intrabc/DV path; see tile.py _decode_block and libaom
    decodemv.c read_intrabc_info).  Intrabc blocks must be skip
    (copy-only); regular blocks follow the keyframe syntax with
    screen-content palette zero-flags."""

    def __init__(self, w, h, base_q, **kw):
        super().__init__(w, h, base_q, **kw)
        self.frame_is_intra = True
        self.screen_tools = True
        self.intrabc_g = np.zeros((self.mi_rows, self.mi_cols), bool)
        self.mib_size = 16        # 64x64 superblocks

    def _emit_deltas_hook(self, blk):
        # use_intrabc is read right after the deltas, before mode info
        self._sym(self.cdf["intrabc"][0],
                  int(getattr(blk, "dv", None) is not None))

    def _encode_block(self, blk):
        dv = getattr(blk, "dv", None)
        if dv is None:
            super()._encode_block(blk)
            return
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        assert blk.skip, "intrabc synth blocks must be skip (copy-only)"
        assert dv[0] % 8 == 0 and dv[1] % 8 == 0, "DV must be full-pel"
        self._enc_skip(blk)
        self._emit_deltas_hook(blk)          # intrabc = 1
        # DV prediction (mirror of the decoder): INTRA_FRAME stack,
        # lowered to even then truncated to full-pel, with the
        # av1_find_ref_dv fallback
        st = self.refmv.find(r, c, bsize,
                             (C.INTRA_FRAME, C.NONE_FRAME), False)

        def _lower(m):
            return tuple(v + (-1 if v > 0 else 1) if (v & 1) else v
                         for v in m)

        dv_ref = _lower(st.mvs[0][0])
        if dv_ref == (0, 0):
            dv_ref = _lower(st.mvs[1][0])
        if dv_ref == (0, 0):
            mib = self.mib_size
            if r - mib < 0:
                dv_ref = (0, (-4 * mib - 256) * 8)
            else:
                dv_ref = (-4 * mib * 8, 0)
        dv_ref = ((dv_ref[0] >> 3) * 8, (dv_ref[1] >> 3) * 8)
        self._enc_mv(dv[0] - dv_ref[0], dv[1] - dv_ref[1],
                     prefix="dv", force_int=True)
        # skipped inter-style block: txfm ctx gets the block dims
        self.a_txw[c:c + w4] = w4 * 4
        self.l_txh[r:r + h4] = h4 * 4
        self.a_skip[c:c + w4] = 1
        self.l_skip[r:r + h4] = 1
        self.a_mode[c:c + w4] = C.DC_PRED
        self.l_mode[r:r + h4] = C.DC_PRED
        has_chroma = True
        if h4 == 1 and (r & 1) == 0:
            has_chroma = False
        if w4 == 1 and (c & 1) == 0:
            has_chroma = False
        self._clear_skip_ctx(blk, T.MAX_TX_SIZE_RECT[bsize], has_chroma)
        self._post_grids(blk, C.INTRA_FRAME, dv, C.NEWMV)
        h4c = min(h4, self.mi_rows - r)
        w4c = min(w4, self.mi_cols - c)
        self.intrabc_g[r:r + h4c, c:c + w4c] = True


def _zero_counts(t):
    """libaom av1_reset_cdf_symbol_counters on the saved state."""
    if isinstance(t, list):
        if t and not isinstance(t[0], (list, dict)):
            t[-1] = 0
        else:
            for v in t:
                _zero_counts(v)
    elif isinstance(t, dict):
        for v in t.values():
            _zero_counts(v)


def encode_inter_sequence(w: int, h: int, q: int, frames,
                          hp_mv: bool = False, adapt: bool = False,
                          tx_select: bool = False,
                          switchable: bool = False,
                          motion_switch: bool = False,
                          err: bool = True,
                          carry: bool = False,
                          warp: bool = False,
                          lf=None) -> List[bytes]:
    """frames: list of (frame_type, blocks).  Returns one TU per frame
    (seq header included in the first)."""
    from easyav1.video.av1.av1_enc import write_frame_header_bits
    tus = []
    prev_cdf = None
    seq = write_sequence_header_full(w, h, warp=warp)
    for i, entry in enumerate(frames):
        if len(entry) == 3:
            ftype, blocks, fsize = entry
        else:
            (ftype, blocks), fsize = entry, None
        fw, fh2 = fsize if fsize else (w, h)
        bw = BitWriter()
        write_frame_header_full(bw, ftype, q,
                                refresh=0xFF if ftype == C.KEY_FRAME
                                else 0x01, hp_mv=hp_mv, adapt=adapt,
                                tx_select=tx_select,
                                switchable=switchable, w=fw, h=fh2,
                                motion_switch=motion_switch,
                                err=err, primary_ref=0, carry=carry,
                                warp=warp, lf=lf,
                                coded_size=fsize)
        bw.byte_align()
        hdr_bytes = bw.bytes()
        tenc = InterTileEncoder(fw, fh2, q, hp_mv=hp_mv, adapt=adapt,
                                tx_mode_select=tx_select,
                                switchable=switchable,
                                motion_switch=motion_switch,
                                allow_warp=warp and ftype != C.KEY_FRAME
                                and not err)
        if ftype == C.KEY_FRAME:
            tenc.frame_is_intra = True
        if carry and prev_cdf is not None and ftype != C.KEY_FRAME:
            # primary_ref inheritance: start from the previous frame's
            # end-of-tile entropy state (spec load_cdfs)
            tenc.cdf = copy.deepcopy(prev_cdf)
        tile = tenc.encode_blocks(blocks)
        if carry:
            prev_cdf = tenc.cdf
            _zero_counts(prev_cdf)
        tu = obu(C.OBU_TEMPORAL_DELIMITER, b"")
        if i == 0:
            tu += obu(C.OBU_SEQUENCE_HEADER, seq)
        tu += obu(C.OBU_FRAME, hdr_bytes + tile)
        tus.append(tu)
    return tus


# motion-mode gating shares the decoder's exact sample-gathering and
# overlappability scans (duck-typed over the shared grid attributes)
from easyav1.video.av1.tile import TileDecoder as _TD  # noqa: E402

InterTileEncoder._find_warp_samples = _TD._find_warp_samples
InterTileEncoder._has_overlappable = _TD._has_overlappable
InterTileEncoder._comp_mode_ctx = _TD._comp_mode_ctx
InterTileEncoder._compound_mode_ctx = _TD._compound_mode_ctx
InterTileEncoder._COMP_MODE_CTX_MAP = _TD._COMP_MODE_CTX_MAP
InterTileEncoder._comp_ref_type_ctx = _TD._comp_ref_type_ctx
InterTileEncoder._comp_group_ctx = _TD._comp_group_ctx
InterTileEncoder._comp_index_ctx = _TD._comp_index_ctx
InterTileEncoder._nb_info = _TD._nb_info
InterTileEncoder._is_backward = _TD._is_backward


class _SeqStub:
    enable_order_hint = True
    order_hint_bits = 7


class _SlotState:
    """Mirror of the decoder's RefFrameState for the synth encoder."""
    def __init__(self, order_hint, saved_order_hints, mi_rows, mi_cols,
                 frame_type):
        self.valid = True
        self.order_hint = order_hint
        self.saved_order_hints = saved_order_hints
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.frame_type = frame_type


def encode_ref_sequence(w: int, h: int, q: int, frames,
                        hp_mv: bool = False, adapt: bool = True,
                        tx_select: bool = False, carry: bool = False,
                        motion_switch: bool = False,
                        switchable: bool = False,
                        ref_select: bool = False,
                        jnt: bool = False,
                        interintra: bool = False,
                        warp: bool = False,
                        sb128: bool = False) -> List[bytes]:
    """Order-hint sequences with arbitrary ref slot structure.

    frames: list of dicts {type, blocks, refresh (8-bit mask), ref_idx
    (7 slots), order_hint, use_rfm, err}.  The encoder mirrors the
    decoder's cross-frame state: slot entropy contexts (carry), slot
    order hints, and the per-slot 8x8 motion fields feeding the
    temporal candidate scan (spec 7.9), so streams round-trip through
    both dav1d and our decoder.
    """
    from easyav1.video.av1 import mfmv

    tus = []
    seq = write_sequence_header_full(w, h, order_hints=True, jnt=jnt,
                                     interintra=interintra, warp=warp,
                                     sb128=sb128)
    mi_cols = 2 * ((w + 7) >> 3)
    mi_rows = 2 * ((h + 7) >> 3)
    slot_states = [None] * 8
    slot_tmvs = [None] * 8
    slot_cdfs = [None] * 8
    for i, fr in enumerate(frames):
        ftype = fr["type"]
        blocks = fr["blocks"]
        refresh = fr.get("refresh", 0xFF if ftype == C.KEY_FRAME else 1)
        ref_idx = fr.get("ref_idx", [0] * 7)
        order_hint = fr.get("order_hint", i)
        use_rfm = fr.get("use_rfm", False)
        err = fr.get("err", False)
        is_key = ftype == C.KEY_FRAME

        def rel(a, b):
            d = a - b
            m = 1 << 6
            return (d & (m - 1)) - (d & m)

        skip_allowed = False
        sm_frames = None
        if not is_key and ref_select:
            fwd_i = bwd_i = -1
            fwd_h = bwd_h = 0
            for j in range(7):
                st0 = slot_states[ref_idx[j]]
                rh = st0.order_hint if st0 else 0
                if rel(rh, order_hint) < 0:
                    if fwd_i < 0 or rel(rh, fwd_h) > 0:
                        fwd_i, fwd_h = j, rh
                elif rel(rh, order_hint) > 0:
                    if bwd_i < 0 or rel(rh, bwd_h) < 0:
                        bwd_i, bwd_h = j, rh
            if fwd_i >= 0 and bwd_i >= 0:
                skip_allowed = True
                sm_frames = (C.LAST_FRAME + min(fwd_i, bwd_i),
                             C.LAST_FRAME + max(fwd_i, bwd_i))
            elif fwd_i >= 0:
                s2_i = -1
                s2_h = 0
                for j in range(7):
                    st0 = slot_states[ref_idx[j]]
                    rh = st0.order_hint if st0 else 0
                    if rel(rh, fwd_h) < 0 and (s2_i < 0
                                               or rel(rh, s2_h) > 0):
                        s2_i, s2_h = j, rh
                if s2_i >= 0:
                    skip_allowed = True
                    sm_frames = (C.LAST_FRAME + min(fwd_i, s2_i),
                                 C.LAST_FRAME + max(fwd_i, s2_i))
        use_skip_mode = bool(fr.get("skip_mode", False)) and skip_allowed
        bw = BitWriter()
        write_frame_header_full(
            bw, ftype, q, refresh=refresh, hp_mv=hp_mv, adapt=adapt,
            tx_select=tx_select, w=w, h=h, motion_switch=motion_switch,
            switchable=switchable and not is_key,
            err=err, primary_ref=0 if not is_key else 7, carry=carry,
            order_hints=True, order_hint=order_hint, ref_idx=ref_idx,
            use_rfm=use_rfm, ref_select=ref_select and not is_key,
            skip_allowed=skip_allowed, skip_mode=use_skip_mode,
            warp=warp, sb128=sb128)
        bw.byte_align()
        tenc = InterTileEncoder(w, h, q, hp_mv=hp_mv, adapt=adapt,
                                tx_mode_select=tx_select,
                                motion_switch=motion_switch,
                                switchable=switchable and not is_key,
                                ref_select=ref_select, jnt=jnt,
                                interintra=interintra,
                                allow_warp=warp and not is_key and not err)
        if sb128:
            tenc.sb_mi = 32
            tenc.mib_size = 32
        tenc.seq = _SeqStub        # order-hint aware refmvs (rel_dist)
        if use_skip_mode:
            tenc.skip_mode_present = True
            tenc.skip_mode_frames = sm_frames
        stub = tenc.hdr
        stub.order_hint = order_hint
        stub.order_hints = [0] * 8
        stub.ref_frame_sign_bias = [False] * 8
        stub.use_ref_frame_mvs = use_rfm
        stub.ref_frame_idx = list(ref_idx)
        stub.mi_rows = mi_rows
        stub.mi_cols = mi_cols
        if not is_key:
            for r in range(C.LAST_FRAME, C.ALTREF_FRAME + 1):
                st = slot_states[ref_idx[r - C.LAST_FRAME]]
                hint = st.order_hint if st else 0
                stub.order_hints[r] = hint
                stub.ref_frame_sign_bias[r] = rel(hint, order_hint) > 0
            if use_rfm:
                tenc.tpl_mv, tenc.tpl_off = mfmv.setup_motion_field(
                    stub, _SeqStub, slot_states, slot_tmvs)
        if ftype == C.KEY_FRAME:
            tenc.frame_is_intra = True
        if carry and not is_key and slot_cdfs[ref_idx[0]] is not None:
            tenc.cdf = copy.deepcopy(slot_cdfs[ref_idx[0]])
        tile = tenc.encode_blocks(blocks)
        # post-frame slot updates (mirror decoder wrapup)
        if is_key:
            tmvs = (np.full(((mi_rows + 1) >> 1, (mi_cols + 1) >> 1),
                            C.NONE_FRAME, np.int8),
                    np.zeros(((mi_rows + 1) >> 1, (mi_cols + 1) >> 1, 2),
                             np.int16))
        else:
            tmvs = mfmv.save_tmvs(stub, tenc.ref_frames0,
                                  tenc.ref_frames1, tenc.mvs)
        state = _SlotState(order_hint, list(stub.order_hints),
                           mi_rows, mi_cols, ftype)
        end_cdf = copy.deepcopy(tenc.cdf)
        _zero_counts(end_cdf)
        for sl in range(8):
            if refresh & (1 << sl):
                slot_states[sl] = state
                slot_tmvs[sl] = tmvs
                slot_cdfs[sl] = end_cdf
        tu = obu(C.OBU_TEMPORAL_DELIMITER, b"")
        if i == 0:
            tu += obu(C.OBU_SEQUENCE_HEADER, seq)
        tu += obu(C.OBU_FRAME, bw.bytes() + tile)
        tus.append(tu)
    return tus
