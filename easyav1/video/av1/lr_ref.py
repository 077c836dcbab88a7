"""Loop restoration (Wiener + self-guided) numpy reference.

Spec §7.17; reference behavior dav1d looprestoration_tmpl.c /
lr_apply_tmpl.c (ext/dav1d submodule, cmake/dav1d.cmake:249-250).
Bit-exact integer math; operates on full-frame planes:

- input `cdef`: the CDEF-filtered (post-deblock) planes that LR reads
  inside the current 64-row stripe,
- input `deblocked`: the pre-CDEF deblocked planes, supplying the two
  rows above/below each stripe (spec get_source_sample),
- output written in place into `cdef` copies (LrFrame).

No superres yet: UpscaledWidth == FrameWidth.
"""

from __future__ import annotations

from typing import List

import numpy as np

from easyav1.video.av1 import constants as C

# per-set (radius0, radius1); s values are derived from the spec eps
# table and verified byte-exact against dav1d_sgr_params in libdav1d
SGR_RADII = [(2, 1)] * 10 + [(0, 1)] * 4 + [(2, 0)] * 2
SGR_S = [(140, 3236), (112, 2158), (93, 1618), (80, 1438),
         (70, 1295), (58, 1177), (47, 1079), (37, 996),
         (30, 925), (25, 863), (0, 2589), (0, 1618),
         (0, 1177), (0, 925), (56, 0), (22, 0)]

_DIV_LUT = {9: 455, 25: 164}  # Round2(2^12, n) (spec Div_Lut)


class LoopRestoration:
    def __init__(self, hdr, seq, plan, bitdepth: int):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y

    def apply(self, planes: List[np.ndarray],
              deblocked: List[np.ndarray]) -> None:
        """planes: CDEF output (modified in place to LrFrame);
        deblocked: pre-CDEF planes (read-only). Both aligned buffers;
        only the visible crop is filtered."""
        hdr = self.hdr
        lr = getattr(hdr, "lr", None)
        if lr is None or not lr.uses_lr:
            return
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            self._apply_plane(plane, planes, deblocked)

    # -- per-plane ---------------------------------------------------------

    def _apply_plane(self, plane, planes, deblocked):
        hdr = self.hdr
        lr = hdr.lr
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        pw = (hdr.upscaled_width + ssx) >> ssx
        ph = (hdr.frame_height + ssy) >> ssy
        unit_size = lr.loop_restoration_size[plane]
        unit_rows = max((ph + (unit_size >> 1)) // unit_size, 1)
        unit_cols = max((pw + (unit_size >> 1)) // unit_size, 1)
        cdef = planes[plane][:ph, :pw].astype(np.int64)
        debl = deblocked[plane][:ph, :pw].astype(np.int64)
        out = planes[plane]

        stripe_h = 64 >> ssy
        stripe_off = 8 >> ssy
        n_stripes = (ph + stripe_off + stripe_h - 1) // stripe_h
        for s in range(n_stripes):
            ss = s * stripe_h - stripe_off
            se = ss + stripe_h - 1  # inclusive
            y0 = max(0, ss)
            y1 = min(se, ph - 1)
            if y0 > y1:
                continue
            # source window with stripe rules: rows [y0-3, y1+3]
            src = self._stripe_source(cdef, debl, ss, se, y0, y1, ph)
            # src row index offset: src[0] corresponds to y0-3.
            # The whole stripe belongs to ONE unit row: units are
            # effectively shifted up by the 8-px stripe offset (dav1d
            # lr_sbrow: ruy from y + 8*(y!=0)), so the unit row is the
            # stripe's 64-aligned position.
            urow = min(unit_rows - 1, (ss + stripe_off) // unit_size)
            ry0, ry1 = y0, y1
            for ucol in range(unit_cols):
                ux0 = ucol * unit_size
                ux1 = (ucol + 1) * unit_size - 1 \
                    if ucol < unit_cols - 1 else pw - 1
                rtype = self.plan.lr_type.get((plane, urow, ucol),
                                              C.RESTORE_NONE)
                if rtype == C.RESTORE_WIENER:
                    taps = self.plan.lr_wiener[(plane, urow, ucol)]
                    res = self._wiener(src, ry0 - (y0 - 3), ry1 - (y0 - 3),
                                       ux0, ux1, pw, taps, plane)
                elif rtype == C.RESTORE_SGRPROJ:
                    sgr_set, xqd0, xqd1 = \
                        self.plan.lr_sgr[(plane, urow, ucol)]
                    res = self._sgrproj(src, ry0 - (y0 - 3),
                                        ry1 - (y0 - 3),
                                        ux0, ux1, pw, sgr_set,
                                        xqd0, xqd1)
                else:
                    continue
                out[ry0:ry1 + 1, ux0:ux1 + 1] = res

    def _stripe_source(self, cdef, debl, ss, se, y0, y1, ph):
        """Rows [y0-3 .. y1+3] with spec get_source_sample semantics:
        inside [ss, se] -> cdef; above/below -> deblocked clamped to
        stripe boundary +-2 (and to the plane)."""
        rows = np.arange(y0 - 3, y1 + 4)
        src = np.empty((len(rows), cdef.shape[1]), np.int64)
        for i, y in enumerate(rows):
            yy = min(max(int(y), 0), ph - 1)
            if yy < ss:
                src[i] = debl[max(ss - 2, yy)]
            elif yy > se:
                src[i] = debl[min(se + 2, yy)]
            else:
                src[i] = cdef[yy]
        return src

    # -- wiener --------------------------------------------------------

    def _wiener(self, src, r0, r1, x0, x1, pw, taps, plane):
        """src: stripe-source rows (r0/r1 index into src for the output
        rows); returns (r1-r0+1, x1-x0+1) filtered pixels."""
        bd = self.bd
        t = taps
        fh = self._fil7(t[1], plane)   # horizontal pass uses taps[1]?
        fv = self._fil7(t[0], plane)
        # spec: vfilter from LrWiener[..][0], hfilter from [..][1]
        round0 = 3 + (2 if bd == 12 else 0)
        round1 = 11 - (2 if bd == 12 else 0)
        limit = (1 << (bd + 1 + 7 - round0)) - 1
        bias0 = 1 << (bd + 6)
        off1 = 1 << (bd + round1 - 1)
        w = x1 - x0 + 1
        h = r1 - r0 + 1
        # horizontal over rows r0-3 .. r1+3 (src covers them)
        cols = np.clip(np.arange(x0 - 3, x1 + 4), 0, pw - 1)
        win = src[r0 - 3:r1 + 4][:, cols]
        inter = np.full((h + 6, w), bias0, np.int64)
        for k in range(7):
            inter += fh[k] * win[:, k:k + w]
        inter = (inter + (1 << (round0 - 1))) >> round0
        np.clip(inter, 0, limit, out=inter)
        res = np.full((h, w), -off1, np.int64)
        for k in range(7):
            res += fv[k] * inter[k:k + h]
        res = (res + (1 << (round1 - 1))) >> round1
        return np.clip(res, 0, (1 << bd) - 1)

    @staticmethod
    def _fil7(t3, plane):
        t0, t1, t2 = (0 if plane else t3[0]), t3[1], t3[2]
        if plane:
            center = 128 - 2 * (t1 + t2)
        else:
            center = 128 - 2 * (t0 + t1 + t2)
        return [t0, t1, t2, center, t2, t1, t0]

    # -- self-guided ---------------------------------------------------

    def _sgrproj(self, src, r0, r1, x0, x1, pw, sgr_set, xqd0, xqd1):
        bd = self.bd
        h = r1 - r0 + 1
        w = x1 - x0 + 1
        rad = SGR_RADII[sgr_set]
        svals = SGR_S[sgr_set]
        u = src[r0:r1 + 1, np.clip(np.arange(x0, x1 + 1), 0, pw - 1)] << 4
        flt = [u, u]
        for p in range(2):
            if rad[p]:
                flt[p] = self._box_filter(src, r0, h, x0, w, pw,
                                          rad[p], svals[p], p)
        # libaom av1_decode_xq: xqd0 weighs pass 0, xqd1 weighs the
        # source, pass 1 takes the remainder
        w0 = xqd0
        w1 = xqd1
        w2 = (1 << 7) - w0 - w1
        v = w0 * flt[0] + w1 * u + w2 * flt[1]
        s = (v + (1 << 10)) >> 11
        return np.clip(s, 0, (1 << bd) - 1)

    def _box_filter(self, src, r0, h, x0, w, pw, radius, s, pass_):
        """spec 7.17.3 boxFilter + final weighting; src rows cover
        [r0-3, r0+h+2] at least (stripe source)."""
        bd = self.bd
        n = (2 * radius + 1) ** 2
        one_over_n = _DIV_LUT[n]
        # A/B over grid i in [-1, h], j in [-1, w]; pass0 only odd i
        # relative to the output (grid rows r where (i & 1) == 0 per
        # spec means absolute output-relative even? libaom grid: rows
        # i = -1, 1, 3, ... (every other, starting at -1)
        gi = np.arange(-1, h + 1)
        if pass_ == 0:
            gi = gi[(gi + 1) % 2 == 0]  # -1, 1, 3, ...
        gj = np.arange(-1, w + 1)
        # box sums via padded cumulative windows on the stripe source
        # sample (y,x) via clamped indices into src
        A = np.zeros((h + 2, w + 2), np.int64)
        B = np.zeros((h + 2, w + 2), np.int64)
        cols = np.clip(np.arange(x0 - 1 - radius, x0 + w + 1 + radius),
                       0, pw - 1)
        rows = np.arange(r0 - 1 - radius, r0 + h + 1 + radius)
        rows = np.clip(rows, 0, src.shape[0] - 1)
        ext = src[rows][:, cols]
        sq = ext * ext
        k = 2 * radius + 1
        # sliding window sums
        csum = np.cumsum(ext, axis=0)
        csum = np.vstack([np.zeros((1, ext.shape[1]), np.int64), csum])
        rsumv = csum[k:] - csum[:-k]
        csq = np.cumsum(sq, axis=0)
        csq = np.vstack([np.zeros((1, ext.shape[1]), np.int64), csq])
        rsqv = csq[k:] - csq[:-k]
        c2 = np.cumsum(rsumv, axis=1)
        c2 = np.hstack([np.zeros((c2.shape[0], 1), np.int64), c2])
        bsum = c2[:, k:] - c2[:, :-k]
        c3 = np.cumsum(rsqv, axis=1)
        c3 = np.hstack([np.zeros((c3.shape[0], 1), np.int64), c3])
        asum = c3[:, k:] - c3[:, :-k]
        # asum/bsum[i, j] = window centered at (r0-1+i, x0-1+j)
        for i in gi:
            a = asum[i + 1]
            b = bsum[i + 1]
            if bd > 8:
                sh = 2 * (bd - 8)
                a = (a + (1 << (sh - 1))) >> sh
                b = (b + (1 << (bd - 9))) >> (bd - 8)
            p = np.maximum(0, a * n - b * b)
            z = (p * s + (1 << 19)) >> 20
            a2 = np.where(z >= 255, 256,
                          np.where(z == 0, 1,
                                   ((z << 8) + z // 2) // (z + 1)))
            b2 = ((256 - a2) * b * one_over_n + (1 << 11)) >> 12
            A[i + 1] = a2
            B[i + 1] = b2
        # final weighting
        out = np.zeros((h, w), np.int64)
        dgd = src[r0:r0 + h][:, np.clip(np.arange(x0, x0 + w), 0, pw - 1)]
        for i in range(h):
            if pass_ == 0:
                if (i & 1) == 0:
                    a = (6 * (A[i, 1:w + 1] + A[i + 2, 1:w + 1])
                         + 5 * (A[i, 0:w] + A[i, 2:w + 2]
                                + A[i + 2, 0:w] + A[i + 2, 2:w + 2]))
                    b = (6 * (B[i, 1:w + 1] + B[i + 2, 1:w + 1])
                         + 5 * (B[i, 0:w] + B[i, 2:w + 2]
                                + B[i + 2, 0:w] + B[i + 2, 2:w + 2]))
                    shift = 9  # SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS
                else:
                    a = (6 * A[i + 1, 1:w + 1]
                         + 5 * (A[i + 1, 0:w] + A[i + 1, 2:w + 2]))
                    b = (6 * B[i + 1, 1:w + 1]
                         + 5 * (B[i + 1, 0:w] + B[i + 1, 2:w + 2]))
                    shift = 8
            else:
                a = np.zeros(w, np.int64)
                b = np.zeros(w, np.int64)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        wt = 4 if (dx == 0 or dy == 0) else 3
                        a += wt * A[i + 1 + dy, 1 + dx:w + 1 + dx]
                        b += wt * B[i + 1 + dy, 1 + dx:w + 1 + dx]
                shift = 9
            v = a * dgd[i] + b
            out[i] = (v + (1 << (shift - 1))) >> shift
        return out
