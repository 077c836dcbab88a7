"""Motion-vector reference stack (spec §7.10.2 find_mv_stack).

Spatial candidate scan over the above row / left column / corner
points, weight accumulation, stack sort, mode-context derivation and
extra-candidate fill.  Temporal MV projection is a no-op (fixtures run
with use_ref_frame_mvs disabled / error-resilient frames).

Host-side sequential code by design (SURVEY.md §7: refmvs stays on the
host next to the entropy decoder, like dav1d's refmvs.c; weights follow
the candidate-length rule weight = 2*len, len = max(step, min(bw4,
cand_w4)), validated bit-exact against libdav1d on inter fixtures).
"""

from __future__ import annotations

from typing import List, Tuple

from easyav1.video.av1 import constants as C

MV_BORDER = 128          # 1/8-pel units of allowed out-of-frame motion
REF_CAT_LEVEL = 640
INVALID_MV = None


class MvStack:
    __slots__ = ("mvs", "weights", "num_found", "new_mv_count",
                 "num_nearest", "new_mv_ctx", "ref_mv_ctx", "zero_mv_ctx",
                 "global_mvs")

    def __init__(self):
        self.mvs: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
        self.weights: List[int] = []
        self.num_found = 0
        self.new_mv_count = 0
        self.num_nearest = 0
        self.new_mv_ctx = 0
        self.ref_mv_ctx = 0
        self.zero_mv_ctx = 0
        self.global_mvs = [(0, 0), (0, 0)]


def _is_newmv_mode(mode: int) -> bool:
    return mode in (C.NEWMV, C.NEW_NEWMV, C.NEAR_NEWMV, C.NEW_NEARMV,
                    C.NEAREST_NEWMV, C.NEW_NEARESTMV)


def _is_global_mode(mode: int) -> bool:
    return mode in (C.GLOBALMV, C.GLOBAL_GLOBALMV)


class RefMvFinder:
    """Spatial MV predictor search over the per-4x4 decode-state grids
    maintained by the tile decoder (ref_frames0/1, mvs, modes)."""

    def __init__(self, dec):
        self.dec = dec          # TileDecoder

    # -- global motion ------------------------------------------------------

    def setup_global_mv(self, ref: int, r: int, c: int, bsize: int):
        """GLOBALMV predictor (spec 7.10.2.1)."""
        hdr = self.dec.hdr
        if ref <= C.INTRA_FRAME:
            return (0, 0)
        typ = hdr.gm_type[ref]
        if typ == C.IDENTITY:
            return (0, 0)
        p = hdr.gm_params[ref]
        if typ == C.TRANSLATION:
            mv = (p[0] >> 13, p[1] >> 13)
        else:
            bw = C.BLOCK_W4[bsize] * 4
            bh = C.BLOCK_H4[bsize] * 4
            x = c * 4 + bw // 2 - 1
            y = r * 4 + bh // 2 - 1
            xc = (p[2] - (1 << 16)) * x + p[3] * y + p[0]
            yc = p[4] * x + (p[5] - (1 << 16)) * y + p[1]

            def rnd(v, n):
                return (v + (1 << (n - 1)) + (v >> 31 if False else 0)) >> n

            def round2signed(v, n):
                return ((v + (1 << (n - 1))) >> n if v >= 0
                        else -((-v + (1 << (n - 1))) >> n))

            if hdr.allow_high_precision_mv:
                mv = (round2signed(yc, 13), round2signed(xc, 13))
            else:
                mv = (round2signed(yc, 13), round2signed(xc, 13))
        return self._lower_precision(mv)

    def _lower_precision(self, mv):
        hdr = self.dec.hdr
        out = []
        for v in mv:
            if getattr(hdr, "force_integer_mv", 0):
                a = abs(v)
                a2 = ((a + 3) >> 3) << 3
                v = a2 if v >= 0 else -a2
            elif not hdr.allow_high_precision_mv:
                if v & 1:
                    v += -1 if v > 0 else 1
            out.append(int(v))
        return tuple(out)

    # -- candidate addition ---------------------------------------------------

    def _cand(self, mv_r, mv_c):
        dec = self.dec
        return ((int(dec.ref_frames0[mv_r, mv_c]),
                 int(dec.ref_frames1[mv_r, mv_c])),
                ((int(dec.mvs[mv_r, mv_c, 0, 0]),
                  int(dec.mvs[mv_r, mv_c, 0, 1])),
                 (int(dec.mvs[mv_r, mv_c, 1, 0]),
                  int(dec.mvs[mv_r, mv_c, 1, 1]))),
                int(dec.modes[mv_r, mv_c]))

    def _add_candidate(self, st: MvStack, mv_r, mv_c, weight, ref_frames,
                       is_compound, flags):
        """spec add_ref_mv_candidate; flags = [found_match] (in/out)."""
        cand_ref, cand_mvs, cand_mode = self._cand(mv_r, mv_c)
        if cand_ref[0] <= C.INTRA_FRAME:
            # intrabc neighbours (libaom is_intrabc_block) DO act as
            # mv candidates for an INTRA_FRAME (DV) search
            if not (ref_frames[0] == C.INTRA_FRAME
                    and cand_ref[0] == C.INTRA_FRAME
                    and bool(self.dec.intrabc_g[mv_r, mv_c])):
                return
        glob = _is_global_mode(cand_mode)
        if not is_compound:
            for j in range(2):
                if cand_ref[j] == ref_frames[0]:
                    mv = (st.global_mvs[0] if glob else cand_mvs[j])
                    flags[0] = True
                    if _is_newmv_mode(cand_mode):
                        st.new_mv_count += 1
                    for i in range(st.num_found):
                        if st.mvs[i][0] == mv:
                            st.weights[i] += weight
                            return
                    if st.num_found < 8:
                        st.mvs.append((mv, (0, 0)))
                        st.weights.append(weight)
                        st.num_found += 1
                    return
        else:
            if (cand_ref[0] == ref_frames[0]
                    and cand_ref[1] == ref_frames[1]):
                mv0 = st.global_mvs[0] if glob else cand_mvs[0]
                mv1 = st.global_mvs[1] if glob else cand_mvs[1]
                flags[0] = True
                if _is_newmv_mode(cand_mode):
                    st.new_mv_count += 1
                for i in range(st.num_found):
                    if st.mvs[i] == (mv0, mv1):
                        st.weights[i] += weight
                        return
                if st.num_found < 8:
                    st.mvs.append((mv0, mv1))
                    st.weights.append(weight)
                    st.num_found += 1

    # -- scans -----------------------------------------------------------------

    def _scan_row(self, st, r, c, bsize, delta_row, ref_frames,
                  is_compound, max_row_offset=-6, processed=None):
        """libaom scan_row_mbmi: len floors (16-wide step-4, far-row
        step-2), weight = len * max(2, rows-covered) for candidates at
        least as wide as the block, and processed-row tracking so outer
        scans skip rows a tall candidate already covered."""
        dec = self.dec
        bw4 = C.BLOCK_W4[bsize]
        end4 = min(min(bw4, dec.mi_cols - c), 16)
        d_row = delta_row
        d_col = 0
        if abs(delta_row) > 1:
            d_row += r & 1
            d_col = 1 - (c & 1)
        found = [False]
        i = 0
        while i < end4:
            mv_r = r + d_row
            mv_c = c + d_col + i
            if not dec._is_inside(mv_r, mv_c):
                break
            cand_bs = int(dec.plan.bsize[mv_r, mv_c])
            cand_w4 = C.BLOCK_W4[cand_bs]
            length = min(bw4, cand_w4)
            if bw4 >= 16:
                length = max(length, 4)
            elif abs(d_row) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= bw4 <= cand_w4:
                inc = min(-max_row_offset + d_row + 1,
                          C.BLOCK_H4[cand_bs])
                weight = max(weight, inc)
                if processed is not None:
                    processed[0] = inc - d_row - 1
            self._add_candidate(st, mv_r, mv_c, length * weight,
                                ref_frames, is_compound, found)
            i += length
        return found[0]

    def _scan_col(self, st, r, c, bsize, delta_col, ref_frames,
                  is_compound, max_col_offset=-6, processed=None):
        dec = self.dec
        bh4 = C.BLOCK_H4[bsize]
        end4 = min(min(bh4, dec.mi_rows - r), 16)
        d_col = delta_col
        d_row = 0
        if abs(delta_col) > 1:
            d_col += c & 1
            d_row = 1 - (r & 1)
        found = [False]
        i = 0
        while i < end4:
            mv_r = r + d_row + i
            mv_c = c + d_col
            if not dec._is_inside(mv_r, mv_c):
                break
            cand_bs = int(dec.plan.bsize[mv_r, mv_c])
            cand_h4 = C.BLOCK_H4[cand_bs]
            length = min(bh4, cand_h4)
            if bh4 >= 16:
                length = max(length, 4)
            elif abs(d_col) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= bh4 <= cand_h4:
                inc = min(-max_col_offset + d_col + 1,
                          C.BLOCK_W4[cand_bs])
                weight = max(weight, inc)
                if processed is not None:
                    processed[0] = inc - d_col - 1
            self._add_candidate(st, mv_r, mv_c, length * weight,
                                ref_frames, is_compound, found)
            i += length
        return found[0]

    def _scan_point(self, st, r, c, delta_row, delta_col, ref_frames,
                    is_compound):
        dec = self.dec
        mv_r = r + delta_row
        mv_c = c + delta_col
        if not dec._is_inside(mv_r, mv_c):
            return False
        if int(dec.ref_frames0[mv_r, mv_c]) == C.NONE_FRAME:
            return False
        found = [False]
        self._add_candidate(st, mv_r, mv_c, 4, ref_frames, is_compound,
                            found)
        return found[0]

    # -- main --------------------------------------------------------------------

    def find(self, r, c, bsize, ref_frames, is_compound) -> MvStack:
        dec = self.dec
        st = MvStack()
        bw4 = C.BLOCK_W4[bsize]
        bh4 = C.BLOCK_H4[bsize]

        st.global_mvs[0] = self.setup_global_mv(ref_frames[0], r, c, bsize)
        if is_compound:
            st.global_mvs[1] = self.setup_global_mv(ref_frames[1], r, c,
                                                    bsize)

        # scan-range bounds (libaom av1_find_mv_refs): sub-8x8 blocks
        # only reach 2 rows/cols up (with odd-position adjustment);
        # bounds also clamp to the tile edge
        row_adj = 1 if (bh4 < 2 and (r & 1)) else 0
        col_adj = 1 if (bw4 < 2 and (c & 1)) else 0
        max_row_offset = 0
        if dec._is_inside(r - 1, c):
            max_row_offset = (-4 + row_adj) if bh4 < 2 else -6
            max_row_offset = max(max_row_offset, dec.mi_row_start - r)
        max_col_offset = 0
        if dec._is_inside(r, c - 1):
            max_col_offset = (-4 + col_adj) if bw4 < 2 else -6
            max_col_offset = max(max_col_offset, dec.mi_col_start - c)
        processed_rows = [0]
        processed_cols = [0]

        found_above = self._scan_row(st, r, c, bsize, -1, ref_frames,
                                     is_compound, max_row_offset,
                                     processed_rows)
        found_left = self._scan_col(st, r, c, bsize, -1, ref_frames,
                                    is_compound, max_col_offset,
                                    processed_cols)
        if max(bw4, bh4) <= 16 and dec._has_tr(r, c, bsize):
            if self._scan_point(st, r, c, -1, bw4, ref_frames,
                                is_compound):
                found_above = True

        close_matches = int(found_above) + int(found_left)
        st.num_nearest = st.num_found
        num_new = st.new_mv_count

        for i in range(st.num_nearest):
            st.weights[i] += REF_CAT_LEVEL

        if getattr(dec, "tpl_off", None) is not None:
            # temporal candidates from the projected motion field
            self._temporal_scan(st, r, c, bsize, ref_frames, is_compound)
        else:
            # no temporal mvs: zero-mv context from the global mv
            gm = st.global_mvs[0]
            st.zero_mv_ctx = 1 if (abs(gm[0]) >= 8
                                   or abs(gm[1]) >= 8) else 0

        if self._scan_point(st, r, c, -1, -1, ref_frames, is_compound):
            found_above = True
        for idx in (2, 3):
            # effective offsets (_scan_row/_scan_col re-apply the same
            # odd-position adjustment internally)
            eff_ro = -(idx << 1) + 1 + row_adj
            eff_co = -(idx << 1) + 1 + col_adj
            if (abs(eff_ro) <= abs(max_row_offset)
                    and abs(eff_ro) > processed_rows[0]):
                if self._scan_row(st, r, c, bsize, -(idx << 1) + 1,
                                  ref_frames, is_compound,
                                  max_row_offset, processed_rows):
                    found_above = True
            if (abs(eff_co) <= abs(max_col_offset)
                    and abs(eff_co) > processed_cols[0]):
                if self._scan_col(st, r, c, bsize, -(idx << 1) + 1,
                                  ref_frames, is_compound,
                                  max_col_offset, processed_cols):
                    found_left = True

        total_matches = int(found_above) + int(found_left)

        def sort_seg(lo, hi):
            order = sorted(range(lo, hi), key=lambda i: -st.weights[i])
            st.mvs[lo:hi] = [st.mvs[i] for i in order]
            st.weights[lo:hi] = [st.weights[i] for i in order]

        sort_seg(0, st.num_nearest)
        sort_seg(st.num_nearest, st.num_found)

        # mode contexts (spec 7.10.2 step after sorting)
        if close_matches == 0:
            st.new_mv_ctx = min(total_matches, 1)
            st.ref_mv_ctx = total_matches
        elif close_matches == 1:
            st.new_mv_ctx = 3 - min(num_new, 1)
            st.ref_mv_ctx = 2 + total_matches
        else:
            st.new_mv_ctx = 5 - min(num_new, 1)
            st.ref_mv_ctx = 5

        # extra search (spec 7.10.2.12): when fewer than 2 ref-matched
        # candidates, re-scan the close neighbors taking mvs from ANY
        # reference (no sign flip needed: order hints disabled).  These
        # DO count into NumMvFound (verified vs dav1d).
        if st.num_found < 2:
            if is_compound:
                self._extra_search_comp(st, r, c, bsize, ref_frames)
            else:
                self._extra_search(st, r, c, bsize, ref_frames)

        # global-mv pad to 2 entries; padding does NOT count into
        # NumMvFound — drl bits key off genuinely found candidates
        # (verified vs dav1d)
        while len(st.mvs) < 2:
            if is_compound:
                st.mvs.append((st.global_mvs[0], st.global_mvs[1]))
            else:
                st.mvs.append((st.global_mvs[0], (0, 0)))
            st.weights.append(2)

        for i in range(len(st.mvs)):
            st.mvs[i] = (self._clamp_mv(st.mvs[i][0], r, c, bsize),
                         self._clamp_mv(st.mvs[i][1], r, c, bsize))
        st.global_mvs[0] = self._clamp_mv(st.global_mvs[0], r, c, bsize)
        if is_compound:
            st.global_mvs[1] = self._clamp_mv(st.global_mvs[1], r, c,
                                              bsize)
        return st

    # -- temporal (projected) candidates (libaom add_tpl_ref_mv) -----------

    def _rel_dist_pub(self, a, b):
        return self._rel_dist(a, b)

    def _rel_dist(self, a, b):
        seq = self.dec.seq
        if not seq.enable_order_hint:
            return 0
        d = a - b
        m = 1 << (seq.order_hint_bits - 1)
        return (d & (m - 1)) - (d & m)

    def _temporal_scan(self, st, r, c, bsize, ref_frames, is_compound):
        dec = self.dec
        # spec 7.10.2: the temporal scan covers at most 16 units (64px)
        # per direction — 128px blocks do NOT scan their lower halves
        bw4 = min(C.BLOCK_W4[bsize], dec.mi_col_end - c, 16)
        bh4 = min(C.BLOCK_H4[bsize], dec.mi_row_end - r, 16)
        step_h = 4 if C.BLOCK_H4[bsize] >= 16 else 2
        step_w = 4 if C.BLOCK_W4[bsize] >= 16 else 2
        found00 = False
        for br in range(0, bh4, step_h):
            for bc in range(0, bw4, step_w):
                ret = self._add_tpl(st, r, c, br, bc, ref_frames,
                                    is_compound)
                if br == 0 and bc == 0:
                    found00 = ret
        if not found00:
            st.zero_mv_ctx = 1
        # spec allowExtension tests the UNCLIPPED block dims (7.10.2.14
        # uses Num_4x4_Blocks_*): a 16-unit block overhanging the frame
        # edge must NOT gain extension samples just because its clipped
        # height drops below 16
        full_h4 = C.BLOCK_H4[bsize]
        full_w4 = C.BLOCK_W4[bsize]
        allow_ext = (2 <= full_h4 < 16) and (2 <= full_w4 < 16)
        if allow_ext:
            voff = max(2, full_h4)
            hoff = max(2, full_w4)
            for (br, bc) in ((voff, -2), (voff, hoff), (voff - 2, hoff)):
                # extension samples stay within the current superblock
                # band: row/col in [0, sb) x [0, 2*sb) (validated vs
                # dav1d: the (bh4,-2) sample is dropped when it crosses
                # the SB column leftward)
                row = (r & 15) + br
                col = (c & 15) + bc
                if not (0 <= row < 16 and 0 <= col < 16):
                    continue
                self._add_tpl(st, r, c, br, bc, ref_frames, is_compound)

    def _add_tpl(self, st, r, c, br, bc, ref_frames, is_compound):
        dec = self.dec
        pos_r = br if (r & 1) else br + 1
        pos_c = bc if (c & 1) else bc + 1
        mv_r = r + pos_r
        mv_c = c + pos_c
        if not (dec.mi_row_start <= mv_r < dec.mi_row_end
                and dec.mi_col_start <= mv_c < dec.mi_col_end):
            return False
        y8 = mv_r >> 1
        x8 = mv_c >> 1
        if int(dec.tpl_off[y8, x8]) == 0:
            return False
        off = int(dec.tpl_off[y8, x8])
        fr = int(dec.tpl_mv[y8, x8, 0])
        fc = int(dec.tpl_mv[y8, x8, 1])
        from easyav1.video.av1.mfmv import mv_projection
        hdr = dec.hdr
        cur0 = self._rel_dist(hdr.order_hint,
                              hdr.order_hints[ref_frames[0]])
        mv0 = self._lower_precision(mv_projection(fr, fc, cur0, off))
        if not is_compound:
            if br == 0 and bc == 0:
                gm = st.global_mvs[0]
                st.zero_mv_ctx = 1 if (abs(mv0[0] - gm[0]) >= 16
                                       or abs(mv0[1] - gm[1]) >= 16) else 0
            for i in range(st.num_found):
                if st.mvs[i][0] == mv0:
                    st.weights[i] += 2
                    return True
            if st.num_found < 8:
                st.mvs.append((mv0, (0, 0)))
                st.weights.append(2)
                st.num_found += 1
            return True
        cur1 = self._rel_dist(hdr.order_hint,
                              hdr.order_hints[ref_frames[1]])
        mv1 = self._lower_precision(mv_projection(fr, fc, cur1, off))
        if br == 0 and bc == 0:
            gm0, gm1 = st.global_mvs
            st.zero_mv_ctx = 1 if (abs(mv0[0] - gm0[0]) >= 16
                                   or abs(mv0[1] - gm0[1]) >= 16
                                   or abs(mv1[0] - gm1[0]) >= 16
                                   or abs(mv1[1] - gm1[1]) >= 16) else 0
        for i in range(st.num_found):
            if st.mvs[i] == (mv0, mv1):
                st.weights[i] += 2
                return True
        if st.num_found < 8:
            st.mvs.append((mv0, mv1))
            st.weights.append(2)
            st.num_found += 1
        return True

    def _extra_search_comp(self, st: MvStack, r, c, bsize, ref_frames):
        """Compound extra search (libaom process_compound_ref_mv_candidate
        + combined-list padding)."""
        dec = self.dec
        bias = dec.hdr.ref_frame_sign_bias
        ref_id = [[], []]
        ref_diff = [[], []]

        def process(mv_r, mv_c):
            cand_ref, cand_mvs, _m = self._cand(mv_r, mv_c)
            for j in range(2):
                can_rf = cand_ref[j]
                for k in range(2):
                    if can_rf == ref_frames[k] and len(ref_id[k]) < 2:
                        ref_id[k].append(cand_mvs[j])
                    elif can_rf > C.INTRA_FRAME and len(ref_diff[k]) < 2:
                        mv = cand_mvs[j]
                        if bias[can_rf] != bias[ref_frames[k]]:
                            mv = (-mv[0], -mv[1])
                        ref_diff[k].append(mv)

        bw4 = C.BLOCK_W4[bsize]
        bh4 = C.BLOCK_H4[bsize]
        i = 0
        while i < min(bw4, dec.mi_col_end - c):
            mv_r, mv_c = r - 1, c + i
            if not dec._is_inside(mv_r, mv_c):
                break
            process(mv_r, mv_c)
            i += C.BLOCK_W4[int(dec.plan.bsize[mv_r, mv_c])]
        i = 0
        while i < min(bh4, dec.mi_row_end - r):
            mv_r, mv_c = r + i, c - 1
            if not dec._is_inside(mv_r, mv_c):
                break
            process(mv_r, mv_c)
            i += C.BLOCK_H4[int(dec.plan.bsize[mv_r, mv_c])]

        comp_list = [[None, None], [None, None]]
        for k in range(2):
            pool = ref_id[k] + ref_diff[k]
            for idx in range(2):
                comp_list[idx][k] = (pool[idx] if idx < len(pool)
                                     else st.global_mvs[k])
        if st.num_found:
            ent = tuple(comp_list[0])
            if (comp_list[0][0] == st.mvs[0][0]
                    and comp_list[0][1] == st.mvs[0][1]):
                ent = tuple(comp_list[1])
            st.mvs.append((ent[0], ent[1]))
            st.weights.append(2)
            st.num_found += 1
        else:
            for idx in range(2):
                st.mvs.append((comp_list[idx][0], comp_list[idx][1]))
                st.weights.append(2)
                st.num_found += 1

    def _extra_search(self, st: MvStack, r, c, bsize, ref_frames):
        # single-ref extension (libaom av1_find_mv_refs rf[1]==NONE
        # branch): BOTH the row and the col loop are bounded by
        # min(block width, block height) in mi units (each clamped to
        # the frame), so narrow blocks only examine the first neighbor
        dec = self.dec
        bw4 = C.BLOCK_W4[bsize]
        bh4 = C.BLOCK_H4[bsize]
        mi_w = min(16, bw4, dec.mi_cols - c)
        mi_h = min(16, bh4, dec.mi_rows - r)
        end = min(mi_w, mi_h)
        for pass_ in range(2):
            i = 0
            while i < end and st.num_found < 2:
                if pass_ == 0:
                    mv_r, mv_c = r - 1, c + i
                else:
                    mv_r, mv_c = r + i, c - 1
                if not dec._is_inside(mv_r, mv_c):
                    break
                cand_ref, cand_mvs, _mode = self._cand(mv_r, mv_c)
                if ref_frames[0] == C.INTRA_FRAME:
                    if (cand_ref[0] == C.INTRA_FRAME
                            and bool(dec.intrabc_g[mv_r, mv_c])):
                        mv = cand_mvs[0]
                        if all(st.mvs[k][0] != mv
                               for k in range(st.num_found)):
                            st.mvs.append((mv, (0, 0)))
                            st.weights.append(2)
                            st.num_found += 1
                elif cand_ref[0] > C.INTRA_FRAME:
                    # libaom process_single_ref_mv_candidate: BOTH mvs
                    # of a compound neighbor are added without
                    # rechecking the <2 stop (the cap is only tested
                    # between candidates), so NumMvFound can reach 3
                    bias = self.dec.hdr.ref_frame_sign_bias
                    for j in range(2):
                        if cand_ref[j] > C.INTRA_FRAME:
                            mv = cand_mvs[j]
                            if bias[cand_ref[j]] != bias[ref_frames[0]]:
                                mv = (-mv[0], -mv[1])
                            if all(st.mvs[k][0] != mv
                                   for k in range(st.num_found)):
                                st.mvs.append((mv, (0, 0)))
                                st.weights.append(2)
                                st.num_found += 1
                cand_bs = int(dec.plan.bsize[mv_r, mv_c])
                i += (C.BLOCK_W4[cand_bs] if pass_ == 0
                      else C.BLOCK_H4[cand_bs])

    def _clamp_mv(self, mv, r, c, bsize):
        dec = self.dec
        bw4 = C.BLOCK_W4[bsize]
        bh4 = C.BLOCK_H4[bsize]
        row_border = MV_BORDER + bh4 * 4 * 8
        col_border = MV_BORDER + bw4 * 4 * 8
        mn_row = -(r * 4 * 8) - row_border
        mx_row = (dec.mi_rows - bh4 - r) * 4 * 8 + row_border
        mn_col = -(c * 4 * 8) - col_border
        mx_col = (dec.mi_cols - bw4 - c) * 4 * 8 + col_border
        return (max(mn_row, min(mx_row, mv[0])),
                max(mn_col, min(mx_col, mv[1])))
