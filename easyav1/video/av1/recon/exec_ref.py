"""Data-driven intra recon executor (numpy reference).

Consumes the native bridge's per-pred-unit records
(`av1_recon.c:av1_export_pred_units`) plus the coded-tx stream and
replays reconstruction without re-deriving any block semantics: every
irregular decision (neighbor availability, edge filter strength,
upsample flags, resolved angle, CfL geometry) was made host-side and
baked into the record.  This module is the behavioral spec for the
device executor — the executor must follow record fields only, never
plan state.

Record layout (24 x int32, decode order), mirroring av1_recon.c UF:
  0 plane, 1 x, 2 y, 3 w, 4 h,
  5 class (0 dc, 1 v, 2 h, 3 directional, 4 smooth, 5 smooth_v,
           6 smooth_h, 7 paeth, 8 cfl, 9 filter-intra/unsupported),
  6 p_angle, 7 have_above, 8 have_left, 9 have_tr, 10 have_bl,
  11 strength_above, 12 strength_left, 13 up_above, 14 up_left,
  15 corner_filter, 16 cfl_alpha, 17 ac_x, 18 ac_y, 19 ac_w, 20 ac_h,
  21 tx_size, 22 raw mode, 23 reserved

Parity: this is the device-side analog of the recon stage easyav1 gets
from libdav1d (reference easyav1.c:decode_video); semantics mirror
native/av1_recon.c predict_intra/recon_tx bit-for-bit.
"""

from __future__ import annotations

from typing import List

import numpy as np

from easyav1.video.av1 import tables as T

UF = 24
OFF = 2

_EDGE_KERNELS = np.array([[0, 4, 8, 4, 0], [0, 5, 6, 5, 0],
                          [2, 4, 4, 4, 2]], np.int64)
_SM_OFFS = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}


def _edge_filter(edge, start, sz, strength):
    if strength == 0 or sz <= 1:
        return
    kern = _EDGE_KERNELS[strength - 1]
    orig = edge[start:start + sz].copy()
    idx = np.arange(1, sz)
    acc = np.zeros(sz - 1, np.int64)
    for j in range(5):
        k = np.clip(idx - 2 + j, 0, sz - 1)
        acc += kern[j] * orig[k]
    edge[start + 1:start + sz] = (acc + 8) >> 4


def _upsample_edge(edge, start, num_px, bd):
    mx = (1 << bd) - 1
    dup = np.empty(num_px + 3, np.int64)
    dup[0] = dup[1] = edge[start - 1]
    dup[2:2 + num_px] = edge[start:start + num_px]
    dup[num_px + 2] = dup[num_px + 1]
    edge[start - 2] = dup[0]
    s = -dup[:num_px] + 9 * dup[1:num_px + 1] + 9 * dup[2:num_px + 2] \
        - dup[3:num_px + 3]
    s = np.clip((s + 8) >> 4, 0, mx)
    edge[start - 1:start + 2 * num_px - 1:2] = s
    edge[start:start + 2 * num_px:2] = dup[2:num_px + 2]


def _directional(dr, p_angle, above, left, w, h, up_above, up_left):
    out = np.zeros((h, w), np.int64)
    ii = np.arange(h)[:, None]
    jj = np.arange(w)[None, :]
    if p_angle < 90:
        dx = int(dr[p_angle])
        max_base = (w + h - 1) << up_above
        idx = (ii + 1) * dx
        base = (idx >> (6 - up_above)) + (jj << up_above)
        shift = ((idx << up_above) >> 1) & 0x1F
        shift = np.broadcast_to(shift, (h, w))
        b = np.minimum(base, max_base)
        v = (above[OFF + b] * (32 - shift)
             + above[OFF + np.minimum(b + 1, max_base + 1)] * shift
             + 16) >> 5
        out = np.where(base >= max_base, above[OFF + max_base], v)
    elif p_angle > 180:
        dy = int(dr[270 - p_angle])
        max_base = (w + h - 1) << up_left
        idy = (jj + 1) * dy
        base = (idy >> (6 - up_left)) + (ii << up_left)
        shift = ((idy << up_left) >> 1) & 0x1F
        shift = np.broadcast_to(shift, (h, w))
        b = np.minimum(base, max_base)
        v = (left[OFF + b] * (32 - shift)
             + left[OFF + np.minimum(b + 1, max_base + 1)] * shift
             + 16) >> 5
        out = np.where(base >= max_base, left[OFF + max_base], v)
    else:
        dx = int(dr[180 - p_angle])
        dy = int(dr[p_angle - 90])
        idx = (jj << 6) - (ii + 1) * dx
        base = idx >> (6 - up_above)
        shift_a = ((idx << up_above) >> 1) & 0x1F
        use_above = base >= -(1 << up_above)
        va = (above[OFF + np.maximum(base, -2)] * (32 - shift_a)
              + above[OFF + np.maximum(base, -2) + 1] * shift_a + 16) >> 5
        idy = (ii << 6) - (jj + 1) * dy
        base_y = idy >> (6 - up_left)
        shift_l = ((idy << up_left) >> 1) & 0x1F
        vl = (left[OFF + np.maximum(base_y, -2)] * (32 - shift_l)
              + left[OFF + np.maximum(base_y, -2) + 1] * shift_l + 16) >> 5
        out = np.where(use_above, va, vl)
    return out


def _smooth(sm_weights, cls, A, L, w, h):
    wy = sm_weights[_SM_OFFS[h]:_SM_OFFS[h] + h].astype(np.int64)[:, None]
    wx = sm_weights[_SM_OFFS[w]:_SM_OFFS[w] + w].astype(np.int64)[None, :]
    below = L[h - 1]
    right = A[w - 1]
    if cls == 4:      # SMOOTH
        num = wy * A[:w][None, :] + (256 - wy) * below \
            + wx * L[:h][:, None] + (256 - wx) * right
        return (num + 256) >> 9
    if cls == 5:      # SMOOTH_V
        return (wy * A[:w][None, :] + (256 - wy) * below + 128) >> 8
    return (wx * L[:h][:, None] + (256 - wx) * right + 128) >> 8


class UnitExecutor:
    """Replays pred-unit records into mi-aligned planes."""

    def __init__(self, mi_rows: int, mi_cols: int, ssx: int, ssy: int,
                 bitdepth: int = 8, num_planes: int = 3):
        aw, ah = mi_cols * 4, mi_rows * 4
        self.bd = bitdepth
        self.ssx, self.ssy = ssx, ssy
        self.dims = [(ah, aw), (ah >> ssy, aw >> ssx),
                     (ah >> ssy, aw >> ssx)][:num_planes]
        self.planes = [np.zeros(d, np.int64) for d in self.dims]
        d = np.load(T.__file__.replace("tables.py", "tables_data.npz"))
        self.dr = d["dr_intra_derivative"]
        self.sm = d["sm_weights"]

    def residual_planes(self, txs: np.ndarray, coeffs: np.ndarray):
        """Assemble per-plane residual planes from coded tx records
        (itx outputs scatter-added at (x, y), clipped at plane dims)."""
        from easyav1.video.av1.recon_ref import inverse_transform
        from easyav1.video.av1.tile import TxBlock
        res = [np.zeros(d, np.int64) for d in self.dims]
        for k in range(txs.shape[0]):
            plane, x, y, tsz, ttyp, eob, coff, lossless = \
                (int(v) for v in txs[k])
            adj = T.ADJUSTED_TX_SIZE[tsz]
            tw, th = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
            blk = TxBlock(plane=plane, x=x, y=y, tx_size=tsz,
                          tx_type=ttyp, eob=eob & 0xFFF,
                          coeffs=coeffs[coff:coff + tw * th]
                          .reshape(th, tw).astype(np.int64),
                          lossless=bool(lossless))
            r = inverse_transform(blk, self.bd)
            ph, pw = self.dims[plane]
            h = min(r.shape[0], ph - y)
            w = min(r.shape[1], pw - x)
            res[plane][y:y + h, x:x + w] += r[:h, :w]
        return res

    def run(self, units: np.ndarray, residuals: List[np.ndarray]):
        for k in range(units.shape[0]):
            self._unit(units[k], residuals)
        return self.planes

    # -- single unit ------------------------------------------------
    def _unit(self, u, residuals):
        (plane, x, y, w, h, cls, p_angle, have_above, have_left,
         have_tr, have_bl, sa, sl, ua, ul, cf, alpha, ac_x, ac_y,
         ac_w, ac_h) = (int(v) for v in u[:21])
        buf = self.planes[plane]
        ph, pw = self.dims[plane]
        bd = self.bd
        base = 1 << (bd - 1)
        max_x, max_y = pw - 1, ph - 1

        need_edge = 2 * max(w, h) + 1
        esz = OFF + 2 * need_edge + 2
        above = np.zeros(esz, np.int64)
        left = np.zeros(esz, np.int64)

        if have_above:
            n = w + (w if have_tr else 0)
            cols = np.minimum(x + np.arange(n), max_x)
            above[OFF:OFF + n] = buf[y - 1, cols]
            above[OFF + n:] = above[OFF + n - 1]
        else:
            above[:] = buf[y, x - 1] if have_left else base - 1
        if have_left:
            n = h + (h if have_bl else 0)
            rows = np.minimum(y + np.arange(n), max_y)
            left[OFF:OFF + n] = buf[rows, x - 1]
            left[OFF + n:] = left[OFF + n - 1]
        else:
            left[:] = buf[y - 1, x] if have_above else base + 1
        if have_above and have_left:
            corner = int(buf[y - 1, x - 1])
        elif have_above:
            corner = int(buf[y - 1, x])
        elif have_left:
            corner = int(buf[y, x - 1])
        else:
            corner = base
        above[OFF - 1] = corner
        left[OFF - 1] = corner

        if cls == 3:          # general directional: edge prep applies
            if cf:
                s = (int(left[OFF]) * 5 + int(above[OFF - 1]) * 6
                     + int(above[OFF]) * 5 + 8) >> 4
                above[OFF - 1] = s
                left[OFF - 1] = s
            if have_above:
                num_px = min(w, pw - x) + (h if p_angle < 90 else 0) + 1
                _edge_filter(above, OFF - 1, num_px, sa)
            if have_left:
                num_px = min(h, ph - y) + (w if p_angle > 180 else 0) + 1
                _edge_filter(left, OFF - 1, num_px, sl)
            if ua:
                _upsample_edge(above, OFF,
                               w + (h if p_angle < 90 else 0), bd)
            if ul:
                _upsample_edge(left, OFF,
                               h + (w if p_angle > 180 else 0), bd)

        A = above[OFF:]
        L = left[OFF:]
        if cls in (0, 8):     # DC (CfL base is DC)
            if have_above and have_left:
                avg = (int(A[:w].sum()) + int(L[:h].sum())
                       + ((w + h) >> 1)) // (w + h)
            elif have_above:
                avg = (int(A[:w].sum()) + (w >> 1)) // w
            elif have_left:
                avg = (int(L[:h].sum()) + (h >> 1)) // h
            else:
                avg = base
            pred = np.full((h, w), avg, np.int64)
        elif cls == 1:
            pred = np.broadcast_to(A[:w], (h, w)).copy()
        elif cls == 2:
            pred = np.broadcast_to(L[:h][:, None], (h, w)).copy()
        elif cls == 3:
            pred = _directional(self.dr, p_angle, above, left, w, h,
                                ua, ul)
        elif cls in (4, 5, 6):
            pred = _smooth(self.sm, cls, A, L, w, h)
        elif cls == 7:
            b = A[:w][None, :]
            ll = L[:h][:, None]
            p = b + ll - corner
            pb = np.abs(p - b)
            pl = np.abs(p - ll)
            pc = np.abs(p - corner)
            pred = np.where((pl <= pb) & (pl <= pc), ll,
                            np.where(pb <= pc, b, corner))
        elif cls == 10:
            # literal unit (palette): prediction pre-folded into the
            # residual plane by the host composer
            pred = np.zeros((h, w), np.int64)
        elif cls == 11:
            # intra block copy: two-stage bilinear from the partially
            # reconstructed plane (av1_mc.h predict_inter_i32 parity);
            # p_angle/cf carry src col/row, sa/sl/ua/ul the live taps
            ix, iy = p_angle, cf
            th3, th4, tv3, tv4 = sa, sl, ua, ul
            win = np.zeros((h + 8, w + 8), np.int64)
            for r in range(h + 8):
                sy = min(max(iy - 3 + r, 0), ph - 1)
                for c in range(w + 8):
                    sx = min(max(ix - 3 + c, 0), pw - 1)
                    win[r, c] = buf[sy, sx]
            mid = (th3 * win[:, 3:3 + w] + th4 * win[:, 4:4 + w]
                   + 4) >> 3
            v = (tv3 * mid[3:3 + h, :] + tv4 * mid[4:4 + h, :]
                 + 1024) >> 11
            pred = np.clip(v, 0, (1 << bd) - 1)
        elif cls == 9:
            # recursive filter intra (spec 7.11.2.3); p_angle carries
            # the filter mode, edges are the unfiltered above/left
            from easyav1.video.av1 import tables as _T

            taps = np.asarray(_T.data()["filter_intra_taps"],
                              np.int64)[p_angle]
            mx9 = (1 << bd) - 1
            W9 = np.zeros((h + 1, w + 1), np.int64)
            W9[0, 1:] = A[:w]
            W9[1:, 0] = L[:h]
            W9[0, 0] = corner
            for y0 in range(0, h, 2):
                for x0 in range(0, w, 4):
                    p = np.array([W9[y0, x0], W9[y0, x0 + 1],
                                  W9[y0, x0 + 2], W9[y0, x0 + 3],
                                  W9[y0, x0 + 4], W9[y0 + 1, x0],
                                  W9[y0 + 2, x0], 0], np.int64)
                    v = (taps @ p + 8) >> 4
                    v = np.clip(v, 0, mx9)
                    W9[y0 + 1:y0 + 3, x0 + 1:x0 + 5] = v.reshape(2, 4)
            pred = W9[1:, 1:]
        else:
            raise NotImplementedError(f"unit class {cls}")

        mxpix = (1 << bd) - 1
        if cls == 8 and alpha:
            # CfL applies only where the ac block overlaps the tx
            # (av1_recon.c recon_tx: i < cfl_h && j < cfl_stride);
            # rows/cols beyond keep the plain DC prediction
            ac = self._cfl_ac(ac_x, ac_y, ac_w, ac_h)
            oh = min(h, ac_h - (y - ac_y))
            ow = min(w, ac_w - (x - ac_x))
            diff = alpha * ac[y - ac_y:y - ac_y + oh,
                              x - ac_x:x - ac_x + ow]
            scaled = np.sign(diff) * ((np.abs(diff) + 32) >> 6)
            pred = pred.copy()
            pred[:oh, :ow] = np.clip(pred[:oh, :ow] + scaled, 0, mxpix)

        res = residuals[plane]
        cw = min(w, pw - x)
        chh = min(h, ph - y)
        out = pred[:chh, :cw] + res[y:y + chh, x:x + cw]
        buf[y:y + chh, x:x + cw] = np.clip(out, 0, mxpix)

    def _cfl_ac(self, cx, cy, cw, chh):
        luma = self.planes[0]
        ly, lx = cy << self.ssy, cx << self.ssx
        if self.ssx and self.ssy:
            blk = luma[ly:ly + 2 * chh, lx:lx + 2 * cw]
            v = (blk[0::2, 0::2] + blk[0::2, 1::2]
                 + blk[1::2, 0::2] + blk[1::2, 1::2]) << 1
        elif self.ssx:
            blk = luma[ly:ly + chh, lx:lx + 2 * cw]
            v = (blk[:, 0::2] + blk[:, 1::2]) << 2
        else:
            v = luma[ly:ly + chh, lx:lx + cw] << 3
        log2sz = (cw.bit_length() - 1) + (chh.bit_length() - 1)
        avg = (int(v.sum()) + (1 << (log2sz - 1))) >> log2sz
        return v - avg
