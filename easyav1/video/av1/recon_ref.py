"""Frame reconstruction reference (numpy, bit-exact target).

Intra prediction (spec §7.11.2: DC/V/H/Paeth/Smooth*/directional with
edge preparation) and 2-D inverse transform application (spec §7.13.3:
rect scaling, row pass + row shift, column pass + shift 4, clamping).
Replays the FramePlan block sequence in decode order — prediction of
each transform block uses previously reconstructed pixels, which is the
wavefront dependency a device port schedules over superblock diagonals.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.headers import FrameHeader, SequenceHeader
from easyav1.video.av1.itx_ref import inv_wht4, transform_1d
from easyav1.video.av1.tile import FramePlan, TxBlock
from easyav1.video.av1 import warp as warp_mod
from easyav1.video.av1 import wedge as wedge_mod

# libaom av1/common/av1_inv_txfm2d.c inv_shift_* (first entry, negated);
# note the 4:1 sizes (4X16/16X4 -> 1, 8X32/32X8 -> 2) — they are NOT 0/1
_ROW_SHIFT = [0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2]

# 1-D kinds per tx type: (vertical, horizontal)
_TX_1D = {
    C.DCT_DCT: ("dct", "dct"),
    C.ADST_DCT: ("adst", "dct"),
    C.DCT_ADST: ("dct", "adst"),
    C.ADST_ADST: ("adst", "adst"),
    C.FLIPADST_DCT: ("flipadst", "dct"),
    C.DCT_FLIPADST: ("dct", "flipadst"),
    C.FLIPADST_FLIPADST: ("flipadst", "flipadst"),
    C.ADST_FLIPADST: ("adst", "flipadst"),
    C.FLIPADST_ADST: ("flipadst", "adst"),
    C.IDTX: ("identity", "identity"),
    C.V_DCT: ("dct", "identity"),
    C.H_DCT: ("identity", "dct"),
    C.V_ADST: ("adst", "identity"),
    C.H_ADST: ("identity", "adst"),
    C.V_FLIPADST: ("flipadst", "identity"),
    C.H_FLIPADST: ("identity", "flipadst"),
}


def inverse_transform(txb: TxBlock, bitdepth: int) -> np.ndarray:
    """Returns the (h, w) residual block."""
    tx = txb.tx_size
    w = T.TX_WIDTH[tx]
    h = T.TX_HEIGHT[tx]
    if txb.lossless:
        # inverse 4x4 Walsh-Hadamard (aom_iwht4x4_16_add): input >> 2,
        # row butterfly pass, then column pass without shift
        x = txb.coeffs.astype(np.int64) >> 2

        def _wht_pass(a, c_, d, b):
            a = a + c_
            d = d - b
            e = (a - d) >> 1
            b = e - b
            c_ = e - c_
            a = a - b
            d = d + c_
            return a, b, c_, d

        r0, r1, r2, r3 = _wht_pass(x[:, 0], x[:, 1], x[:, 2], x[:, 3])
        t = np.stack([r0, r1, r2, r3], axis=1)   # (4 rows, 4 cols)
        c0, c1, c2, c3 = _wht_pass(t[0], t[1], t[2], t[3])
        return np.stack([c0, c1, c2, c3], axis=0)
    mn = -(1 << (bitdepth + 7))
    mx = (1 << (bitdepth + 7)) - 1
    vkind, hkind = _TX_1D[txb.tx_type]
    adj_w = txb.coeffs.shape[1]
    adj_h = txb.coeffs.shape[0]
    buf = np.zeros((h, w), np.int64)
    buf[:adj_h, :adj_w] = txb.coeffs
    # rectangular scaling
    if abs(w.bit_length() - h.bit_length()) == 1:
        buf = (buf * 2896 + 2048) >> 12
    # row pass (horizontal transform along axis 1)
    rows = transform_1d(hkind, buf.T, mn, mx)  # (w, h): axis0 = width
    shift = _ROW_SHIFT[tx]
    rows = (rows + ((1 << shift) >> 1)) >> shift
    rows = np.clip(rows, mn, mx)
    # col pass (vertical transform along axis 0 of (h, w))
    cols_in = rows.T  # (h, w)
    cols = transform_1d(vkind, cols_in, mn, mx)
    out = (cols + 8) >> 4
    return out


# ---------------------------------------------------------------------------

def _scale_chroma_bsize(bsize: int, ssx: int, ssy: int) -> int:
    """libaom scale_chroma_bsize: minimum prediction block the chroma of
    a sub-8x8 luma block behaves as, per subsampling."""
    if bsize == C.BLOCK_4X4:
        if ssx and ssy:
            return C.BLOCK_8X8
        if ssx:
            return C.BLOCK_8X4
        if ssy:
            return C.BLOCK_4X8
    elif bsize == C.BLOCK_4X8:
        if ssx:
            return C.BLOCK_8X8
    elif bsize == C.BLOCK_8X4:
        if ssy:
            return C.BLOCK_8X8
    elif bsize == C.BLOCK_4X16:
        if ssx:
            return C.BLOCK_8X16
    elif bsize == C.BLOCK_16X4:
        if ssy:
            return C.BLOCK_16X8
    return bsize


def _morton(r: int, c: int, bits: int) -> int:
    m = 0
    for b in range(bits):
        m |= ((c >> b) & 1) << (2 * b)
        m |= ((r >> b) & 1) << (2 * b + 1)
    return m


class FrameRecon:
    def __init__(self, seq: SequenceHeader, hdr: FrameHeader, plan: FramePlan,
                 refs=None):
        self.seq = seq
        self.hdr = hdr
        self.plan = plan
        self.refs = refs or [None] * 8
        self.bd = seq.color.bitdepth
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y
        aw = plan.mi_cols * 4
        ah = plan.mi_rows * 4
        cw = aw >> self.ssx
        chh = ah >> self.ssy
        self.planes = [np.zeros((ah, aw), np.int32),
                       np.zeros((chh, cw), np.int32),
                       np.zeros((chh, cw), np.int32)]
        self.widths = [plan.width, (plan.width + self.ssx) >> self.ssx,
                       (plan.width + self.ssx) >> self.ssx]
        self.heights = [plan.height, (plan.height + self.ssy) >> self.ssy,
                        (plan.height + self.ssy) >> self.ssy]
        self.sb4 = 32 if seq.use_128x128_superblock else 16
        d = T.data()
        self.sm_weights = d["sm_weights"]
        self.dr_table = d["dr_intra_derivative"]
        # tile geometry in mi units: neighbor availability (intra
        # edges, TR/BL, OBMC, smooth-filter type) never crosses a tile
        # boundary (spec is_inside, 5.11.5)
        t = hdr.tile
        sbl = 5 if seq.use_128x128_superblock else 4
        self._tcs = [min(cs << sbl, plan.mi_cols) for cs in t.col_starts]
        self._trs = [min(rs << sbl, plan.mi_rows) for rs in t.row_starts]
        self._tcol_of = np.searchsorted(
            np.asarray(self._tcs[1:]), np.arange(plan.mi_cols),
            side="right")
        self._trow_of = np.searchsorted(
            np.asarray(self._trs[1:]), np.arange(plan.mi_rows),
            side="right")

    def _tile_bounds(self, mi_row: int, mi_col: int):
        """(row_start, row_end, col_start, col_end) in luma mi of the
        tile containing (mi_row, mi_col)."""
        tc = int(self._tcol_of[mi_col])
        tr = int(self._trow_of[mi_row])
        return (self._trs[tr], self._trs[tr + 1],
                self._tcs[tc], self._tcs[tc + 1])

    def run_aligned(self):
        """Reconstruct and return the mi-aligned planes (loop filtering
        runs on these; cropping to the display size happens afterwards)."""
        for blk in self.plan.blocks:
            self._recon_block(blk)
        return [self.planes[p]
                for p in range(3 if self.seq.color.num_planes > 1 else 1)]

    def crop(self, planes):
        out = []
        for p, buf in enumerate(planes):
            out.append(buf[:self.heights[p], :self.widths[p]]
                       .astype(np.uint8 if self.bd == 8 else np.uint16))
        return out

    def run(self):
        return self.crop(self.run_aligned())

    # ------------------------------------------------------------------

    def _recon_block(self, blk):
        if getattr(blk, "is_inter", False):
            self._recon_block_inter(blk)
            return
        txmap: Dict[Tuple[int, int, int], TxBlock] = {
            (t.plane, t.x, t.y): t for t in blk.tx_blocks}
        r, c = blk.r, blk.c
        w4 = C.BLOCK_W4[blk.bsize]
        h4 = C.BLOCK_H4[blk.bsize]
        mi_cols = self.plan.mi_cols
        mi_rows = self.plan.mi_rows
        # luma
        tx = blk.tx_size
        sw = T.TX_W4[tx]
        sh = T.TX_H4[tx]
        for yy in range(0, min(h4, mi_rows - r), sh):
            for xx in range(0, min(w4, mi_cols - c), sw):
                self._recon_tx(blk, 0, (c + xx) * 4, (r + yy) * 4, tx,
                               blk.y_mode, blk.angle_y, txmap)
        if blk.has_chroma and self.seq.color.num_planes > 1:
            tx = blk.uv_tx_size
            sw = T.TX_W4[tx]
            sh = T.TX_H4[tx]
            cb4 = max(1, min(w4, mi_cols - c) >> self.ssx)
            ch4 = max(1, min(h4, mi_rows - r) >> self.ssy)
            cx = (c >> self.ssx) * 4
            cy = (r >> self.ssy) * 4
            uv_mode = blk.uv_mode
            cfl_ac = None
            if uv_mode == C.UV_CFL_PRED:
                # CfL (spec §7.11.5): base is DC prediction plus
                # alpha-scaled zero-mean subsampled luma
                uv_mode = C.DC_PRED
                cfl_ac = self._cfl_ac(cx, cy, cb4 * 4, ch4 * 4)
            for yy in range(0, ch4, sh):
                for xx in range(0, cb4, sw):
                    for plane in (1, 2):
                        self._recon_tx(blk, plane, cx + xx * 4, cy + yy * 4,
                                       tx, uv_mode, blk.angle_uv, txmap,
                                       cfl_ac=cfl_ac,
                                       cfl_alpha=(blk.cfl_alphas[plane - 1]
                                                  if cfl_ac is not None
                                                  else 0))

    def _gm_shear(self, ref):
        """Cached shear params for the global warp of `ref` (None if the
        global model is shear-invalid -> translational fallback)."""
        if not hasattr(self, "_gm_shear_cache"):
            self._gm_shear_cache = {}
        if ref not in self._gm_shear_cache:
            self._gm_shear_cache[ref] = warp_mod.get_shear_params(
                list(self.hdr.gm_params[ref]))
        return self._gm_shear_cache[ref]

    def _recon_block_inter(self, blk):
        """Motion compensation (spec §7.11.3: translational, local warp,
        global warp, OBMC, compound) for the whole block, then var-tx
        residual add."""
        hdr = self.hdr
        if blk.ref_frame[1] > C.INTRA_FRAME:
            self._recon_compound(blk)
            self._residual_add(blk)
            return
        if blk.ref_frame[0] == C.INTRA_FRAME:
            # intra block copy (spec 7.11.3, libaom av1_build_inter_
            # predictors with ref = current frame): integer-pel luma DV,
            # BILINEAR filter for the chroma half-pel phases; sources
            # the partially reconstructed current frame
            n_planes = 3 if (blk.has_chroma
                             and self.seq.color.num_planes > 1) else 1
            for plane in range(min(n_planes, len(self.planes))):
                ssx = self.ssx if plane else 0
                ssy = self.ssy if plane else 0
                x = (blk.c >> ssx) * 4
                y = (blk.r >> ssy) * 4
                w = max(1, C.BLOCK_W4[blk.bsize] >> ssx) * 4
                h = max(1, C.BLOCK_H4[blk.bsize] >> ssy) * 4
                buf = self.planes[plane]
                full_w, full_h = w, h
                w = min(w, buf.shape[1] - x)
                h = min(h, buf.shape[0] - y)
                pred = self._predict_inter(buf, x, y, w, h, blk.mv,
                                           ssx, ssy,
                                           (C.BILINEAR, C.BILINEAR),
                                           plane, filt_w=full_w,
                                           filt_h=full_h)
                buf[y:y + h, x:x + w] = pred
            self._residual_add(blk)
            return
        ref = blk.ref_frame[0]
        slot = hdr.ref_frame_idx[ref - 1]
        ref_planes = self.refs[slot]
        if ref_planes is None:
            raise ValueError(f"missing reference frame slot {slot}")
        # warp selection: local warp beats global; invalid -> translation
        wm = None
        if blk.motion_mode == C.WARPED and blk.warp is not None:
            wm = blk.warp
        elif (blk.inter_mode in (C.GLOBALMV,)
              and min(C.BLOCK_W4[blk.bsize], C.BLOCK_H4[blk.bsize]) * 4 >= 8
              and hdr.gm_type[ref] > C.TRANSLATION
              and not hdr.gm_invalid[ref]):
            shear = self._gm_shear(ref)
            if shear is not None:
                wm = (list(hdr.gm_params[ref]), shear)
        n_planes = 3 if (blk.has_chroma and self.seq.color.num_planes > 1) \
            else 1
        for plane in range(min(n_planes, len(self.planes))):
            ssx = self.ssx if plane else 0
            ssy = self.ssy if plane else 0
            x = (blk.c >> ssx) * 4
            y = (blk.r >> ssy) * 4
            w = max(1, C.BLOCK_W4[blk.bsize] >> ssx) * 4
            h = max(1, C.BLOCK_H4[blk.bsize] >> ssy) * 4
            buf = self.planes[plane]
            full_w, full_h = w, h
            w = min(w, buf.shape[1] - x)
            h = min(h, buf.shape[0] - y)
            # spec 7.11.3.1: warp only when the PLANE prediction is at
            # least 8x8; smaller (chroma of 8x8 luma) -> translational
            w4 = C.BLOCK_W4[blk.bsize]
            h4 = C.BLOCK_H4[blk.bsize]
            if plane and ((w4 == 1 and ssx) or (h4 == 1 and ssy)):
                # sub-8x8 chroma (spec 7.11.3.1): the chroma block spans
                # 2x1/1x2/2x2 luma blocks; unless one of them is intra,
                # each 2px-granular piece is predicted with ITS luma
                # block's mv/ref/filter
                if self._sub8x8_chroma(blk, plane, x, y, w, h, ssx, ssy):
                    continue
            if wm is not None and full_w >= 8 and full_h >= 8:
                pred = warp_mod.warp_affine(ref_planes[plane], wm[0],
                                            wm[1], x, y, w, h, ssx, ssy,
                                            self.bd)
            else:
                pred = self._predict_inter(ref_planes[plane], x, y, w, h,
                                           blk.mv, ssx, ssy,
                                           blk.interp_filter, plane,
                                           filt_w=full_w, filt_h=full_h)
            if blk.interintra_mode >= 0:
                pred = self._interintra_blend(blk, plane, x, y, w, h,
                                              full_w, full_h, pred,
                                              ssx, ssy)
            buf[y:y + h, x:x + w] = pred
        if blk.motion_mode == C.OBMC_MOTION:
            self._apply_obmc(blk)
        self._residual_add(blk)

    # interintra mode -> intra predictor (libaom interintra_to_intra_mode)
    _II_TO_MODE = [C.DC_PRED, C.V_PRED, C.H_PRED, C.SMOOTH_PRED]
    # libaom ii_size_scales[BLOCK_SIZES_ALL]
    _II_SIZE_SCALE = [32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1,
                      8, 8, 4, 4, 2, 2]

    def _interintra_blend(self, blk, plane, x, y, w, h, full_w, full_h,
                          inter, ssx, ssy):
        """Interintra compound (spec 7.11.3.13, libaom
        av1_combine_interintra): intra prediction over the whole plane
        block blended with the inter prediction by a wedge or smooth
        mask (mask weights the INTRA side)."""
        mode = self._II_TO_MODE[blk.interintra_mode]
        intra = self._predict_intra(blk, plane, x, y, full_w, full_h,
                                    mode, 0)
        intra = intra[:h, :w].astype(np.int64)
        inter = np.asarray(inter)[:h, :w].astype(np.int64)
        if blk.ii_wedge:
            ml = wedge_mod.wedge_mask(blk.bsize, blk.ii_wedge_idx, 0)
            m = ml if plane == 0 else wedge_mod.subsample_mask(
                ml, ssx, ssy)
            m = m[:h, :w].astype(np.int64)
        else:
            if plane == 0:
                pbsize = blk.bsize
            else:
                cw4 = max(1, C.BLOCK_W4[blk.bsize] >> ssx)
                ch4 = max(1, C.BLOCK_H4[blk.bsize] >> ssy)
                pbsize = next(b for b in range(22)
                              if C.BLOCK_W4[b] == cw4
                              and C.BLOCK_H4[b] == ch4)
            scale = self._II_SIZE_SCALE[pbsize]
            wts = T.data()["ii_weights1d"].astype(np.int64)
            ii = blk.interintra_mode
            if ii == 0:          # II_DC
                m = np.full((h, w), 32, np.int64)
            elif ii == 1:        # II_V: weight by row
                m = wts[np.clip(np.arange(h) * scale, 0, 127)][:, None]
                m = np.broadcast_to(m, (h, w)).copy()
            elif ii == 2:        # II_H: weight by col
                m = wts[np.clip(np.arange(w) * scale, 0, 127)][None, :]
                m = np.broadcast_to(m, (h, w)).copy()
            else:                # II_SMOOTH: min(row, col)
                idx = np.minimum(np.arange(h)[:, None],
                                 np.arange(w)[None, :])
                m = wts[np.clip(idx * scale, 0, 127)]
        return (intra * m + inter * (64 - m) + 32) >> 6

    def _sub8x8_chroma(self, blk, plane, x, y, w, h, ssx, ssy):
        """Per-quadrant chroma prediction for sub-8x8 luma blocks
        (spec 7.11.3.1 candRow/candCol loop).  Returns False when a
        covered luma block is intra (someUseIntra): the caller then
        predicts the whole chroma block with this block's own mv."""
        hdr = self.hdr
        plan = self.plan
        w4 = C.BLOCK_W4[blk.bsize]
        h4 = C.BLOCK_H4[blk.bsize]
        cand_r = (blk.r >> ssy) << ssy
        cand_c = (blk.c >> ssx) << ssx
        rows = [cand_r + j
                for j in range(1 + (ssy if h4 == 1 else 0))]
        cols = [cand_c + i
                for i in range(1 + (ssx if w4 == 1 else 0))]
        for rr in rows:
            for cc in cols:
                if int(plan.ref0_grid[rr, cc]) <= C.INTRA_FRAME:
                    return False
        buf = self.planes[plane]
        pw = (4 >> ssx) if w4 == 1 else w
        ph = (4 >> ssy) if h4 == 1 else h
        for j, rr in enumerate(rows):
            for i, cc in enumerate(cols):
                ref = int(plan.ref0_grid[rr, cc])
                slot = hdr.ref_frame_idx[ref - 1]
                rp = self.refs[slot]
                mv = (int(plan.mvs_grid[rr, cc, 0, 0]),
                      int(plan.mvs_grid[rr, cc, 0, 1]))
                filt = (int(plan.interp_grid[rr, cc, 0]),
                        int(plan.interp_grid[rr, cc, 1]))
                px = x + i * pw
                py = y + j * ph
                cw = min(pw, buf.shape[1] - px)
                chh = min(ph, buf.shape[0] - py)
                if cw <= 0 or chh <= 0:
                    continue
                pred = self._predict_inter(rp[plane], px, py, cw, chh,
                                           mv, ssx, ssy, filt, plane,
                                           filt_w=pw, filt_h=ph)
                buf[py:py + chh, px:px + cw] = pred
        return True

    def _residual_add(self, blk):
        mx = (1 << self.bd) - 1
        for txb in blk.tx_blocks:
            res = inverse_transform(txb, self.bd)
            buf = self.planes[txb.plane]
            h = min(res.shape[0], buf.shape[0] - txb.y)
            w = min(res.shape[1], buf.shape[1] - txb.x)
            reg = buf[txb.y:txb.y + h, txb.x:txb.x + w]
            np.clip(reg + res[:h, :w], 0, mx, out=reg)

    def _recon_compound(self, blk):
        """Two-reference prediction: average / distance-weighted /
        wedge / difference-weighted (spec §7.11.3.1, dav1d
        recon_tmpl.c COMP_INTER_*)."""
        hdr = self.hdr
        rp = []
        for ref in blk.ref_frame:
            slot = hdr.ref_frame_idx[ref - 1]
            planes = self.refs[slot]
            if planes is None:
                raise ValueError(f"missing reference frame slot {slot}")
            rp.append(planes)
        if blk.compound_type == C.COMPOUND_DISTANCE:
            w0, w1 = self._dist_weights(blk.ref_frame)
        else:
            w0 = w1 = 8
        masked = blk.compound_type in (C.COMPOUND_WEDGE, C.COMPOUND_DIFFWTD)
        n_planes = 3 if (blk.has_chroma and self.seq.color.num_planes > 1) \
            else 1
        mx = (1 << self.bd) - 1
        mask_luma = None
        for plane in range(min(n_planes, len(self.planes))):
            ssx = self.ssx if plane else 0
            ssy = self.ssy if plane else 0
            x = (blk.c >> ssx) * 4
            y = (blk.r >> ssy) * 4
            w = max(1, C.BLOCK_W4[blk.bsize] >> ssx) * 4
            h = max(1, C.BLOCK_H4[blk.bsize] >> ssy) * 4
            buf = self.planes[plane]
            full_w, full_h = w, h
            w = min(w, buf.shape[1] - x)
            h = min(h, buf.shape[0] - y)
            # masked compound predicts the full (unclipped) block so
            # the chroma mask subsample matches dav1d's padded buffers
            pw, ph = (full_w, full_h) if masked else (w, h)
            p0 = self._predict_inter(rp[0][plane], x, y, pw, ph, blk.mv,
                                     ssx, ssy, blk.interp_filter, plane,
                                     filt_w=full_w, filt_h=full_h,
                                     comp=True)
            p1 = self._predict_inter(rp[1][plane], x, y, pw, ph, blk.mv2,
                                     ssx, ssy, blk.interp_filter, plane,
                                     filt_w=full_w, filt_h=full_h,
                                     comp=True)
            if masked:
                if plane == 0:
                    if blk.compound_type == C.COMPOUND_WEDGE:
                        mask_luma = wedge_mod.wedge_mask(
                            blk.bsize, blk.wedge_idx, blk.wedge_sign)
                    else:
                        mask_luma = wedge_mod.diffwtd_mask(
                            p0, p1, blk.mask_type, self.bd)
                    m = mask_luma
                else:
                    m = wedge_mod.subsample_mask(mask_luma, ssx, ssy)
                out = wedge_mod.mask_blend(p0, p1, m, self.bd)[:h, :w]
            else:
                out = np.clip((p0 * w0 + p1 * w1 + 128) >> 8, 0, mx)
            buf[y:y + h, x:x + w] = out

    _MAX_NB_OBMC = [0, 1, 2, 3, 4, 4, 4]

    def _apply_obmc(self, blk):
        """Overlapped block motion compensation (spec §7.11.3.9-10,
        libaom av1_build_obmc_inter_prediction)."""
        plan = self.plan
        hdr = self.hdr
        d = T.data()
        masks = {1: np.array([64], np.int64),
                 2: d["obmc_mask_2"].astype(np.int64),
                 4: d["obmc_mask_4"].astype(np.int64),
                 8: d["obmc_mask_8"].astype(np.int64),
                 16: d["obmc_mask_16"].astype(np.int64),
                 32: d["obmc_mask_32"].astype(np.int64)}
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        bw = w4 * 4
        bh = h4 * 4
        w4c = min(w4, plan.mi_cols - c)
        h4c = min(h4, plan.mi_rows - r)
        t_rs, _t_re, t_cs, _t_ce = self._tile_bounds(r, c)
        n_planes = 3 if (blk.has_chroma and self.seq.color.num_planes > 1) \
            else 1

        def nb_pred(plane, nb_r, nb_c, px, py, pw, ph):
            nref = int(plan.ref0_grid[nb_r, nb_c])
            mv = (int(plan.mvs_grid[nb_r, nb_c, 0, 0]),
                  int(plan.mvs_grid[nb_r, nb_c, 0, 1]))
            interp = (int(plan.interp_grid[nb_r, nb_c, 0]),
                      int(plan.interp_grid[nb_r, nb_c, 1]))
            rp = self.refs[hdr.ref_frame_idx[nref - 1]]
            return self._predict_inter(rp[plane], px, py, pw, ph, mv,
                                       self.ssx if plane else 0,
                                       self.ssy if plane else 0,
                                       interp, plane)

        def plane_skip(above_pass):
            """libaom av1_skip_u4x4_pred_in_obmc: skip the ABOVE pass for
            chroma plane-blocks 4x4 / 8x4 / 4x8."""
            pw4 = max(1, w4 >> self.ssx)
            ph4 = max(1, h4 >> self.ssy)
            tiny = (pw4 * 4 <= 4 and ph4 * 4 <= 8) or \
                   (pw4 * 4 <= 8 and ph4 * 4 <= 4)
            return tiny and above_pass

        # ---- above pass
        if r > t_rs:
            nb_max = self._MAX_NB_OBMC[(w4 * 4).bit_length() - 3]
            count = 0
            i = 0
            while i < w4c and count < nb_max:
                nbc = c + i
                step = min(C.BLOCK_W4[int(plan.bsize[r - 1, nbc])], 16)
                rel = i
                nbc_eff = nbc
                if step == 1:
                    rel = (nbc & ~1) - c
                    nbc_eff = (nbc & ~1) + 1
                    step = 2
                if int(plan.ref0_grid[r - 1, nbc_eff]) > C.INTRA_FRAME:
                    count += 1
                    op_mi = min(w4, step)
                    overlap = (min(bh, 64) >> 1)
                    for plane in range(min(n_planes, len(self.planes))):
                        if plane and plane_skip(True):
                            continue
                        ssx = self.ssx if plane else 0
                        ssy = self.ssy if plane else 0
                        px = ((c + rel) * 4) >> ssx
                        py = (r * 4) >> ssy
                        pw = (op_mi * 4) >> ssx
                        ph = overlap >> ssy
                        buf = self.planes[plane]
                        pw = min(pw, buf.shape[1] - px)
                        ph = min(ph, buf.shape[0] - py)
                        if pw <= 0 or ph <= 0:
                            continue
                        tmp = nb_pred(plane, r - 1, nbc_eff, px, py, pw,
                                      ph)
                        m = masks[overlap >> ssy][:ph, None]
                        reg = buf[py:py + ph, px:px + pw]
                        reg[:] = (m * reg + (64 - m) * tmp + 32) >> 6
                i = rel + step
        # ---- left pass
        if c > t_cs:
            nb_max = self._MAX_NB_OBMC[(h4 * 4).bit_length() - 3]
            count = 0
            i = 0
            while i < h4c and count < nb_max:
                nbr = r + i
                step = min(C.BLOCK_H4[int(plan.bsize[nbr, c - 1])], 16)
                rel = i
                nbr_eff = nbr
                if step == 1:
                    rel = (nbr & ~1) - r
                    nbr_eff = (nbr & ~1) + 1
                    step = 2
                if int(plan.ref0_grid[nbr_eff, c - 1]) > C.INTRA_FRAME:
                    count += 1
                    op_mi = min(h4, step)
                    overlap = (min(bw, 64) >> 1)
                    for plane in range(min(n_planes, len(self.planes))):
                        if plane and plane_skip(False):
                            continue
                        ssx = self.ssx if plane else 0
                        ssy = self.ssy if plane else 0
                        px = (c * 4) >> ssx
                        py = ((r + rel) * 4) >> ssy
                        pw = overlap >> ssx
                        ph = (op_mi * 4) >> ssy
                        buf = self.planes[plane]
                        pw = min(pw, buf.shape[1] - px)
                        ph = min(ph, buf.shape[0] - py)
                        if pw <= 0 or ph <= 0:
                            continue
                        tmp = nb_pred(plane, nbr_eff, c - 1, px, py, pw,
                                      ph)
                        m = masks[overlap >> ssx][None, :pw]
                        reg = buf[py:py + ph, px:px + pw]
                        reg[:] = (m * reg + (64 - m) * tmp + 32) >> 6
                i = rel + step

    # MC subpel filter selection (spec Subpel_Filters): 4-tap variants
    # for block dims <= 4; SHARP falls back to the regular 4-tap
    def _mc_filter(self, interp, dim):
        d = T.data()
        if dim <= 4:
            # libaom av1_interp_4tap remap applies to regular/sharp/
            # smooth only; BILINEAR keeps its own 2-tap kernel
            if interp == C.BILINEAR:
                return d["mc_filter_bilinear"].astype(np.int64)
            return (d["mc_filter_smooth4"] if interp == C.EIGHTTAP_SMOOTH
                    else d["mc_filter_regular4"]).astype(np.int64)
        key = {C.EIGHTTAP: "mc_filter_regular8",
               C.EIGHTTAP_SMOOTH: "mc_filter_smooth8",
               C.EIGHTTAP_SHARP: "mc_filter_sharp8",
               3: "mc_filter_bilinear"}[interp]
        return d[key].astype(np.int64)

    # dist-wtd compound weights (libaom quant_dist tables)
    _QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7))
    _QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))

    def _dist_weights(self, ref_frame):
        """(w_ref0, w_ref1) for COMPOUND_DISTANCE, sum 16."""
        hdr = self.hdr

        def rel(a, b):
            seq = self.seq
            if not seq.enable_order_hint:
                return 0
            d = a - b
            m = 1 << (seq.order_hint_bits - 1)
            return (d & (m - 1)) - (d & m)

        cur = hdr.order_hint
        bck = min(abs(rel(cur, hdr.order_hints[ref_frame[0]])), 31)
        fwd = min(abs(rel(hdr.order_hints[ref_frame[1]], cur)), 31)
        # nearer ref takes QL[i][0]; row from the strict ratio ladder
        # far*2 < near*{3,5,7} (dav1d-validated, see
        # tests/test_av1_jnt_onesided.py)
        order = int(fwd <= bck)
        near, far = (fwd, bck) if order else (bck, fwd)
        for i in range(3):
            if far * 2 < near * self._QUANT_DIST_WEIGHT[i][1]:
                break
        else:
            i = 3
        wn = self._QUANT_DIST_LOOKUP[i][0]
        wf = self._QUANT_DIST_LOOKUP[i][1]
        return (wf, wn) if order else (wn, wf)

    def _predict_inter(self, ref, x, y, w, h, mv, ssx, ssy, interp,
                       plane, filt_w=None, filt_h=None, comp=False):
        """8-tap separable subpel MC with edge-replicating coordinate
        clamps (spec 7.11.3.2 block_inter_predict, no ref scaling).
        filt_w/filt_h: UNCLIPPED plane block dims for subpel filter
        selection (frame-edge blocks keep the full-size filter)."""
        # start positions in 1/16-pel plane units
        start_x = (x << 4) + (mv[1] << (1 - ssx))
        start_y = (y << 4) + (mv[0] << (1 - ssy))
        frac_x = start_x & 15
        frac_y = start_y & 15
        ix = start_x >> 4
        iy = start_y >> 4
        last_x = ref.shape[1] - 1
        last_y = ref.shape[0] - 1
        fh = self._mc_filter(interp[1], filt_w or w)[frac_x]
        fv = self._mc_filter(interp[0], filt_h or h)[frac_y]
        # horizontal pass into (h+7, w) intermediate
        rows = np.clip(np.arange(iy - 3, iy + h + 4), 0, last_y)
        cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, last_x)
        src = ref[np.ix_(rows, cols)].astype(np.int64)
        inter = np.zeros((h + 7, w), np.int64)
        for t in range(8):
            inter += fh[t] * src[:, t:t + w]
        inter = (inter + 4) >> 3                      # InterRound0 = 3
        out = np.zeros((h, w), np.int64)
        for t in range(8):
            out += fv[t] * inter[t:t + h]
        if comp:
            # compound intermediates: InterRound1 = 7, no clipping
            return (out + 64) >> 7
        out = (out + 1024) >> 11                      # InterRound1 = 11
        return np.clip(out, 0, (1 << self.bd) - 1)

    def _cfl_ac(self, cx, cy, cw, chh):
        """Zero-mean subsampled-luma AC for CfL (spec §7.11.5.3, 4:2:0):
        2x2 luma sums scaled x2, minus the rounded average."""
        luma = self.planes[0]
        ly = cy << self.ssy
        lx = cx << self.ssx
        sub = luma[ly:ly + (chh << self.ssy), lx:lx + (cw << self.ssx)]
        sub = sub.astype(np.int64)
        if self.ssx and self.ssy:
            ac = (sub[0::2, 0::2] + sub[0::2, 1::2] +
                  sub[1::2, 0::2] + sub[1::2, 1::2]) << 1
        elif self.ssx:
            ac = (sub[:, 0::2] + sub[:, 1::2]) << 2
        else:
            ac = sub << 3
        log2sz = (cw.bit_length() - 1) + (chh.bit_length() - 1)
        avg = (int(ac.sum()) + (1 << (log2sz - 1))) >> log2sz
        return ac - avg

    def _recon_tx(self, blk, plane, x, y, tx, mode, angle_delta, txmap,
                  cfl_ac=None, cfl_alpha=0):
        w = T.TX_WIDTH[tx]
        h = T.TX_HEIGHT[tx]
        buf = self.planes[plane]
        pw = buf.shape[1]
        ph = buf.shape[0]
        w = min(w, pw - x)
        h = min(h, ph - y)
        pred = self._palette_pred(blk, plane, x, y, T.TX_WIDTH[tx],
                                  T.TX_HEIGHT[tx])
        if (pred is None and plane == 0
                and blk.filter_intra is not None):
            pred = self._filter_intra_pred(blk, plane, x, y,
                                           T.TX_WIDTH[tx],
                                           T.TX_HEIGHT[tx],
                                           blk.filter_intra)
        if pred is None:
            pred = self._predict_intra(blk, plane, x, y, T.TX_WIDTH[tx],
                                       T.TX_HEIGHT[tx], mode, angle_delta)
        if cfl_ac is not None and cfl_alpha:
            diff = cfl_alpha * cfl_ac[:pred.shape[0], :pred.shape[1]]
            scaled = np.sign(diff) * ((np.abs(diff) + 32) >> 6)
            pred = np.clip(pred + scaled, 0, (1 << self.bd) - 1)
        txb = txmap.get((plane, x, y))
        if txb is not None:
            res = inverse_transform(txb, self.bd)
            pred = pred + res[:pred.shape[0], :pred.shape[1]]
        np.clip(pred, 0, (1 << self.bd) - 1, out=pred)
        buf[y:y + h, x:x + w] = pred[:h, :w]

    def _palette_pred(self, blk, plane, x, y, w, h):
        """Palette prediction for a tx block (None when the block/plane
        has no palette). Coordinates are plane pixels; the color map is
        block-relative at plane resolution (spec predict_palette)."""
        pal = self.plan.palette.get((blk.r, blk.c))
        if not pal or not isinstance(pal, tuple):
            return None
        pal_y, pal_cb, pal_cr, map_y, map_uv = pal
        if plane == 0:
            if pal_y is None:
                return None
            colors, pmap = np.asarray(pal_y, np.int64), map_y
            bx = blk.c * 4
            by = blk.r * 4
        else:
            if pal_cb is None:
                return None
            colors = np.asarray(pal_cb if plane == 1 else pal_cr, np.int64)
            pmap = map_uv
            bx = (blk.c >> self.ssx) * 4
            by = (blk.r >> self.ssy) * 4
        rx = x - bx
        ry = y - by
        mh, mw = pmap.shape
        rows = np.clip(np.arange(ry, ry + h), 0, mh - 1)
        cols = np.clip(np.arange(rx, rx + w), 0, mw - 1)
        return colors[pmap[np.ix_(rows, cols)]]

    # ------------------------------------------------------------------

    def _avail_tr_bl(self, blk, plane, x4, y4, w4, h4):
        """Top-right / bottom-left availability (libaom reconintra.c
        has_top_right / has_bottom_left): position-in-superblock rules
        plus the Z-order tables extracted from libaom (has_tr/bl_tables,
        with the vertical variants for PARTITION_VERT_A)."""
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        bsize = blk.bsize
        if plane:
            # libaom scale_chroma_bsize: sub-8x8 blocks evaluate the
            # chroma TR/BL availability with the bsize scaled up to the
            # chroma sampling grid (e.g. 16X4 pairs act as 16X8 for
            # 4:2:0) — the SB-position tables index by that size
            bsize = _scale_chroma_bsize(bsize, ssx, ssy)
        mi_row, mi_col = blk.r, blk.c
        bw_mi = C.BLOCK_W4[bsize]
        bh_mi = C.BLOCK_H4[bsize]
        col_off = x4 - (mi_col >> ssx)
        row_off = y4 - (mi_row >> ssy)
        plane_bw = max(1, bw_mi >> ssx)
        plane_bh = max(1, bh_mi >> ssy)
        mi_rows = self.plan.mi_rows
        mi_cols = self.plan.mi_cols
        t_rs, _t_re, t_cs, t_ce = self._tile_bounds(mi_row, mi_col)
        sb_mi = self.sb4
        part = getattr(blk, "partition", 0)
        wl = bw_mi.bit_length() - 1
        hl = bh_mi.bit_length() - 1
        d = T.data()

        def table_bit(fam):
            # libaom get_has_tr_table / get_has_bl_table: the vertical
            # tables apply to PARTITION_VERT_A for top-right but to BOTH
            # VERT_A and VERT_B for bottom-left
            if fam == "has_bl":
                use_vert = (part in (C.PARTITION_VERT_A,
                                     C.PARTITION_VERT_B)
                            and bsize < 16)
            else:
                use_vert = (part == C.PARTITION_VERT_A and bsize < 16)
            key = fam + ("_vert" if use_vert else "")
            offs = d[key + "_offs"]
            flat = d[key + "_flat"]
            tab = flat[offs[bsize]:offs[bsize + 1]]
            blk_row = (mi_row & (sb_mi - 1)) >> hl
            blk_col = (mi_col & (sb_mi - 1)) >> wl
            idx = (blk_row << (5 - wl)) + blk_col
            return (int(tab[idx >> 3]) >> (idx & 7)) & 1

        # -- has_top_right --------------------------------------------
        # have_top/have_left per libaom av1_predict_intra_block: inner
        # tx rows/cols have the neighbor inside the block
        top_available = row_off > 0 or (mi_row >> ssy) > (t_rs >> ssy)
        right_available = mi_col + ((col_off + w4) << ssx) < t_ce
        if not top_available or not right_available:
            have_tr = False
        elif row_off > 0:
            if bw_mi * 4 > 64:
                if (row_off == (16 >> ssy)
                        and col_off + w4 == (16 >> ssx)):
                    have_tr = True
                else:
                    bw64 = 16 >> ssx
                    have_tr = (col_off % bw64) + w4 < bw64
            else:
                have_tr = col_off + w4 < plane_bw
        elif col_off + w4 < plane_bw:
            have_tr = True
        else:
            blk_row = (mi_row & (sb_mi - 1)) >> hl
            blk_col = (mi_col & (sb_mi - 1)) >> wl
            if blk_row == 0:
                have_tr = True
            elif ((blk_col + 1) << wl) >= sb_mi:
                have_tr = False
            else:
                have_tr = bool(table_bit("has_tr"))

        # -- has_bottom_left ------------------------------------------
        yd = (((mi_rows - mi_row - bh_mi) * 4) >> ssy) \
            + (plane_bh - row_off - h4) * 4
        bottom_available = yd > 0 and \
            mi_row + ((row_off + h4) << ssy) < mi_rows
        left_available = col_off > 0 or (mi_col >> ssx) > (t_cs >> ssx)
        if not bottom_available or not left_available:
            have_bl = False
        elif bw_mi * 4 > 64 and col_off > 0 \
                and (col_off % (16 >> ssx)) == 0:
            bh64 = 16 >> ssy
            row64 = row_off % bh64
            have_bl = row64 + h4 < min(plane_bh, bh64)
        elif col_off > 0:
            have_bl = False
        elif row_off + h4 < plane_bh:
            have_bl = True
        else:
            blk_row = (mi_row & (sb_mi - 1)) >> hl
            blk_col = (mi_col & (sb_mi - 1)) >> wl
            if blk_col == 0:
                row_off_in_sb = ((blk_row << hl) >> ssy) + row_off
                have_bl = row_off_in_sb + h4 < (sb_mi >> ssy)
            elif ((blk_row + 1) << hl) >= sb_mi:
                have_bl = False
            else:
                have_bl = bool(table_bit("has_bl"))
        return have_tr, have_bl

    def _filter_intra_pred(self, blk, plane, x, y, w, h, fi_mode):
        """Recursive filter intra (spec 7.11.2.3): 4x2 patches predicted
        from 7 neighbors with the Intra_Filter_Taps table (extracted
        from libaom .rodata; dav1d ipred filter_intra equivalent)."""
        buf = self.planes[plane]
        bd = self.bd
        base = 1 << (bd - 1)
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        t_rs, _t_re, t_cs, _t_ce = self._tile_bounds(blk.r, blk.c)
        have_above = y > (t_rs * 4) >> ssy
        have_left = x > (t_cs * 4) >> ssx
        max_x = buf.shape[1] - 1
        taps = T.data()["filter_intra_taps"][fi_mode].astype(np.int64)
        W = np.zeros((h + 1, w + 1), np.int64)
        # edge preparation (spec intra edge fill, no filtering)
        if have_above:
            for i in range(w):
                W[0, 1 + i] = buf[y - 1, min(x + i, max_x)]
        else:
            W[0, 1:] = (buf[y, x - 1] if have_left else base - 1)
        if have_left:
            for i in range(h):
                W[1 + i, 0] = buf[y + i, x - 1]
        else:
            W[1:, 0] = (W[0, 1] if have_above else base + 1)
        if have_above and have_left:
            W[0, 0] = buf[y - 1, x - 1]
        elif have_above:
            W[0, 0] = W[0, 1]
        elif have_left:
            W[0, 0] = W[1, 0]
        else:
            W[0, 0] = base
        mx = (1 << bd) - 1
        for y0 in range(0, h, 2):
            for x0 in range(0, w, 4):
                p = np.array([W[y0, x0],
                              W[y0, x0 + 1], W[y0, x0 + 2],
                              W[y0, x0 + 3], W[y0, x0 + 4],
                              W[y0 + 1, x0], W[y0 + 2, x0], 0],
                             np.int64)
                for k in range(8):
                    v = int((taps[k] * p).sum())
                    # dav1d ipred filter_intra rounds with a plain
                    # arithmetic shift (floor for negative sums)
                    v = (v + 8) >> 4
                    v = min(max(v, 0), mx)
                    W[y0 + 1 + (k >> 2), x0 + 1 + (k & 3)] = v
        return W[1:, 1:].copy()

    def _predict_intra(self, blk, plane, x, y, w, h, mode, angle_delta):
        buf = self.planes[plane]
        bd = self.bd
        base = 1 << (bd - 1)
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        t_rs, _t_re, t_cs, _t_ce = self._tile_bounds(blk.r, blk.c)
        have_above = y > (t_rs * 4) >> ssy
        have_left = x > (t_cs * 4) >> ssx
        max_x = buf.shape[1] - 1
        max_y = buf.shape[0] - 1

        is_dir = C.V_PRED <= mode <= C.D67_PRED
        p_angle = 0
        if is_dir:
            base_angles = {C.V_PRED: 90, C.H_PRED: 180, C.D45_PRED: 45,
                           C.D135_PRED: 135, C.D113_PRED: 113,
                           C.D157_PRED: 157, C.D203_PRED: 203,
                           C.D67_PRED: 67}
            p_angle = base_angles[mode] + angle_delta * 3

        # edge arrays with OFF=2 headroom: corner at OFF-1, pixel k at
        # OFF+k; upsampling doubles the edge in place (corner -> OFF-2)
        OFF = 2
        need_edge = 2 * max(w, h) + 1  # +1: interpolation reads base+1
        above = np.zeros(OFF + 2 * need_edge + 2, np.int64)
        left = np.zeros(OFF + 2 * need_edge + 2, np.int64)

        x4 = x >> 2
        y4 = y >> 2
        have_tr, have_bl = self._avail_tr_bl(blk, plane, x4, y4,
                                             w >> 2, h >> 2)

        if have_above:
            n_main = w
            # real top-right extent is min(w, h) (dav1d z1 reads the
            # edge only to w + min(w, h); beyond is flat)
            n_ext = min(w, h) if have_tr else 0
            for i in range(n_main + n_ext):
                above[OFF + i] = buf[y - 1, min(x + i, max_x)]
            for i in range(n_main + n_ext, need_edge):
                above[OFF + i] = above[OFF + n_main + n_ext - 1]
        else:
            fill = buf[y, x - 1] if have_left else base - 1
            above[OFF:] = fill
        if have_left:
            n_main = h
            n_ext = min(w, h) if have_bl else 0
            for i in range(n_main + n_ext):
                left[OFF + i] = buf[min(y + i, max_y), x - 1]
            for i in range(n_main + n_ext, need_edge):
                left[OFF + i] = left[OFF + n_main + n_ext - 1]
        else:
            fill = buf[y - 1, x] if have_above else base + 1
            left[OFF:] = fill
        if have_above and have_left:
            corner = buf[y - 1, x - 1]
        elif have_above:
            corner = buf[y - 1, x]
        elif have_left:
            corner = buf[y, x - 1]
        else:
            corner = base
        above[OFF - 1] = corner
        left[OFF - 1] = corner

        up_above = up_left = 0
        if (is_dir and p_angle not in (90, 180)
                and getattr(self.seq, "enable_intra_edge_filter", 0)):
            # filter type: above/left BLOCK neighbour used a smooth mode
            ft = self._filter_type(blk, plane)
            if (90 < p_angle < 180 and (w + h) >= 24
                    and have_above and have_left):
                s = (int(left[OFF]) * 5 + int(above[OFF - 1]) * 6
                     + int(above[OFF]) * 5 + 8) >> 4
                above[OFF - 1] = s
                left[OFF - 1] = s
            if have_above:
                strength = self._filter_strength(w + h, p_angle - 90, ft)
                num_px = (min(w, buf.shape[1] - x)
                          + (h if p_angle < 90 else 0) + 1)
                self._edge_filter(above, OFF - 1, num_px, strength)
                if strength and p_angle < 90:
                    # dav1d z1 max_base_x = w + h - 1 once filtered:
                    # beyond is flat from the FILTERED last sample
                    above[OFF + w + h:] = above[OFF + w + h - 1]
            if have_left:
                strength = self._filter_strength(w + h, p_angle - 180, ft)
                num_px = (min(h, buf.shape[0] - y)
                          + (w if p_angle > 180 else 0) + 1)
                self._edge_filter(left, OFF - 1, num_px, strength)
                if strength and p_angle > 180:
                    left[OFF + w + h:] = left[OFF + w + h - 1]
            up_above = int(self._use_upsample(w, h, p_angle - 90, ft))
            if up_above:
                n = w + (h if p_angle < 90 else 0)
                self._upsample_edge(above, OFF, n)
            up_left = int(self._use_upsample(w, h, p_angle - 180, ft))
            if up_left:
                n = h + (w if p_angle > 180 else 0)
                self._upsample_edge(left, OFF, n)

        A = above[OFF:]
        L = left[OFF:]
        out = np.zeros((h, w), np.int64)

        if mode == C.DC_PRED:
            if have_above and have_left:
                avg = (A[:w].sum() + L[:h].sum() + ((w + h) >> 1)) // (w + h)
            elif have_above:
                avg = (A[:w].sum() + (w >> 1)) // w
            elif have_left:
                avg = (L[:h].sum() + (h >> 1)) // h
            else:
                avg = base
            out[:] = avg
        elif is_dir and p_angle == 90:
            out[:] = A[:w]
        elif is_dir and p_angle == 180:
            out[:] = L[:h][:, None]
        elif mode == C.PAETH_PRED:
            b = A[:w][None, :]
            l = L[:h][:, None]
            p = b + l - corner
            pb = np.abs(p - b)
            pl = np.abs(p - l)
            pc = np.abs(p - corner)
            out = np.where((pl <= pb) & (pl <= pc), l,
                           np.where(pb <= pc, b, corner))
        elif mode in (C.SMOOTH_PRED, C.SMOOTH_V_PRED, C.SMOOTH_H_PRED):
            out = self._smooth(mode, A, L, w, h)
        elif is_dir:
            out = self._directional(p_angle, above, left, w, h,
                                    up_above, up_left)
        else:
            raise NotImplementedError(f"mode {mode}")
        return out

    def _filter_type(self, blk, plane) -> int:
        """Spec get_filter_type: 1 if the block's above or left neighbour
        mi used a smooth prediction mode (per plane).  For chroma the
        neighbours are libaom's chroma_above_mbmi / chroma_left_mbmi:
        the mi at the chroma-aligned BOTTOM-RIGHT cell, stepped up /
        left — above reads row r0-1 at col c0|ssx, left reads col c0-1
        at row r0|ssy.  A sub-8x8 neighbour pair stores its coded
        uv_mode only in the carrier (bottom-right) mi, so the top-row
        cell the naive lookup hits holds no chroma mode."""
        plan = self.plan
        smooth = (C.SMOOTH_PRED, C.SMOOTH_V_PRED, C.SMOOTH_H_PRED)
        if plane == 0:
            modes = plan.y_mode
            ra = rl = blk.r
            ca = cl = blk.c
        else:
            modes = plan.uv_mode
            r0 = blk.r & ~self.ssy
            c0 = blk.c & ~self.ssx
            ra, ca = r0, c0 | self.ssx
            rl, cl = r0 | self.ssy, c0
        t_rs, _t_re, t_cs, _t_ce = self._tile_bounds(blk.r, blk.c)
        above_smooth = ra > t_rs and int(modes[ra - 1, ca]) in smooth
        left_smooth = cl > t_cs and int(modes[rl, cl - 1]) in smooth
        return 1 if (above_smooth or left_smooth) else 0

    def _sm_w(self, n):
        offs = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}
        o = offs[n]
        return self.sm_weights[o:o + n].astype(np.int64)

    def _smooth(self, mode, A, L, w, h):
        wy = self._sm_w(h)[:, None]
        wx = self._sm_w(w)[None, :]
        below = L[h - 1]
        right = A[w - 1]
        a = A[:w][None, :]
        l = L[:h][:, None]
        if mode == C.SMOOTH_PRED:
            num = (wy * a + (256 - wy) * below
                   + wx * l + (256 - wx) * right)
            return (num + 256) >> 9
        if mode == C.SMOOTH_V_PRED:
            num = wy * a + (256 - wy) * below
            return (num + 128) >> 8
        num = wx * l + (256 - wx) * right
        return (num + 128) >> 8

    # -- intra edge filtering (spec §7.11.2.7-7.11.2.11) -------------------

    _EDGE_KERNELS = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]

    @staticmethod
    def _filter_strength(blk_wh, delta, filter_type):
        d = abs(delta)
        s = 0
        if filter_type == 0:
            if blk_wh <= 8:
                if d >= 56:
                    s = 1
            elif blk_wh <= 12:
                if d >= 40:
                    s = 1
            elif blk_wh <= 16:
                if d >= 40:
                    s = 1
            elif blk_wh <= 24:
                if d >= 8:
                    s = 1
                if d >= 16:
                    s = 2
                if d >= 32:
                    s = 3
            elif blk_wh <= 32:
                s = 1
                if d >= 4:
                    s = 2
                if d >= 32:
                    s = 3
            else:
                s = 3
        else:
            if blk_wh <= 8:
                if d >= 40:
                    s = 1
                if d >= 64:
                    s = 2
            elif blk_wh <= 16:
                if d >= 20:
                    s = 1
                if d >= 48:
                    s = 2
            elif blk_wh <= 24:
                if d >= 4:
                    s = 3
            else:
                s = 3
        return s

    @classmethod
    def _edge_filter(cls, edge, start, sz, strength):
        """In-place 5-tap smoothing over edge[start .. start+sz-1]; the
        first element is left unfiltered (spec intra_edge_filter)."""
        if strength == 0 or sz <= 1:
            return
        kern = cls._EDGE_KERNELS[strength - 1]
        orig = [int(edge[start + k]) for k in range(sz)]
        for i in range(1, sz):
            s = 0
            for j in range(5):
                k = min(max(i - 2 + j, 0), sz - 1)
                s += kern[j] * orig[k]
            edge[start + i] = (s + 8) >> 4

    @staticmethod
    def _use_upsample(w, h, delta, filter_type):
        d = abs(delta)
        if d <= 0 or d >= 40:
            return False
        return (w + h) <= 8 if filter_type else (w + h) <= 16

    def _upsample_edge(self, edge, start, num_px):
        """Spec upsample_intra_edge: edge[start-1] is the corner; writes
        the 2x-upsampled samples back with the corner moving to start-2."""
        mx = (1 << self.bd) - 1
        dup = [int(edge[start - 1])] + \
              [int(edge[start + i]) for i in range(num_px)]
        dup = [dup[0]] + dup + [dup[-1]]
        # dup[i] for i in 0..num_px+1 maps to old edge[-1 + (i-1)]
        edge[start - 2] = dup[0]
        for i in range(num_px):
            s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
            s = min(max((s + 8) >> 4, 0), mx)
            edge[start + 2 * i - 1] = s
            edge[start + 2 * i] = dup[i + 2]

    def _directional(self, p_angle, above, left, w, h,
                     up_above=0, up_left=0):
        """above/left: arrays with the corner at index OFF-1 and edge
        pixel k at OFF+k (OFF=2 headroom for upsampled reads to -2)."""
        dr = self.dr_table
        out = np.zeros((h, w), np.int64)
        OFF = 2
        A = above
        L = left
        if p_angle < 90:
            dx = int(dr[p_angle])
            max_base = (w + h - 1) << up_above
            for i in range(h):
                idx = (i + 1) * dx
                for j in range(w):
                    base = (idx >> (6 - up_above)) + (j << up_above)
                    if base >= max_base:
                        out[i, j] = A[OFF + max_base]
                    else:
                        shift = ((idx << up_above) >> 1) & 0x1F
                        out[i, j] = (A[OFF + base] * (32 - shift)
                                     + A[OFF + base + 1] * shift + 16) >> 5
        elif p_angle > 180:
            dy = int(dr[270 - p_angle])
            max_base = (w + h - 1) << up_left
            for j in range(w):
                idy = (j + 1) * dy
                for i in range(h):
                    base = (idy >> (6 - up_left)) + (i << up_left)
                    if base >= max_base:
                        out[i, j] = L[OFF + max_base]
                    else:
                        shift = ((idy << up_left) >> 1) & 0x1F
                        out[i, j] = (L[OFF + base] * (32 - shift)
                                     + L[OFF + base + 1] * shift + 16) >> 5
        else:  # zone 2: 90 < pAngle < 180
            dx = int(dr[180 - p_angle])
            dy = int(dr[p_angle - 90])
            for i in range(h):
                for j in range(w):
                    idx = (j << 6) - (i + 1) * dx
                    base = idx >> (6 - up_above)
                    if base >= -(1 << up_above):
                        shift = ((idx << up_above) >> 1) & 0x1F
                        out[i, j] = (A[OFF + base] * (32 - shift)
                                     + A[OFF + base + 1] * shift + 16) >> 5
                    else:
                        idy = (i << 6) - (j + 1) * dy
                        base_y = idy >> (6 - up_left)
                        shift = ((idy << up_left) >> 1) & 0x1F
                        out[i, j] = (L[OFF + base_y] * (32 - shift)
                                     + L[OFF + base_y + 1] * shift + 16) >> 5
        return out
