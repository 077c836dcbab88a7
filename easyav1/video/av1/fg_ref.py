"""Film grain synthesis (spec §7.18.3) — numpy reference, bit-exact.

Reference behavior: dav1d filmgrain_tmpl.c / fg_apply_tmpl.c
(ext/dav1d submodule, cmake/dav1d.cmake:251-252). Grain is applied to
the OUTPUT picture only; reference frames stay grain-free. The
Gaussian sequence is extracted byte-exact from libdav1d.

All Round2 here are the plain (x + half) >> n form (arithmetic shift
on negatives), matching dav1d's round2/spec integer semantics.
"""

from __future__ import annotations

from typing import List

import numpy as np

from easyav1.video.av1 import tables as T

GRAIN_W = 82
GRAIN_H = 73
BLK = 32


def _rand(state: int, bits: int):
    bit = ((state >> 0) ^ (state >> 1) ^ (state >> 3) ^ (state >> 12)) & 1
    state = (state >> 1) | (bit << 15)
    return state, (state >> (16 - bits)) & ((1 << bits) - 1)


def _r2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _ar_positions(lag):
    """AR neighborhood in coding order (deltaRow -lag..0, deltaCol
    -lag..lag, stopping at the center)."""
    pos = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            pos.append((dr, dc))
    return pos


def generate_grain(fg, bd: int, ssx: int, ssy: int, mono: bool):
    """Returns (luma_grain (73,82), cb_grain, cr_grain) int64 arrays."""
    gauss = T.data()["gaussian_sequence"].astype(np.int64)
    shift = 12 - bd + fg.grain_scale_shift
    gmin = -(128 << (bd - 8))
    gmax = (128 << (bd - 8)) - 1

    state = fg.grain_seed
    luma = np.zeros((GRAIN_H, GRAIN_W), np.int64)
    if fg.num_y_points:
        for y in range(GRAIN_H):
            for x in range(GRAIN_W):
                state, r = _rand(state, 11)
                luma[y, x] = _r2(int(gauss[r]), shift)
    lag = fg.ar_coeff_lag
    pos = _ar_positions(lag)
    if fg.num_y_points:
        coeffs = fg.ar_coeffs_y
        for y in range(3, GRAIN_H):
            for x in range(3, GRAIN_W - 3):
                s = 0
                for (dr, dc), c in zip(pos, coeffs):
                    s += c * int(luma[y + dr, x + dc])
                v = int(luma[y, x]) + _r2(s, fg.ar_coeff_shift)
                luma[y, x] = min(max(v, gmin), gmax)

    if mono:
        return luma, None, None

    cw = 44 if ssx else GRAIN_W
    chh = 38 if ssy else GRAIN_H
    out_c = []
    for num_pts, coeffs, seed_xor in (
            (fg.num_cb_points, fg.ar_coeffs_cb, 0xb524),
            (fg.num_cr_points, fg.ar_coeffs_cr, 0x49d8)):
        cg = np.zeros((chh, cw), np.int64)
        gen = fg.chroma_scaling_from_luma or num_pts > 0
        state = fg.grain_seed ^ seed_xor
        if gen:
            for y in range(chh):
                for x in range(cw):
                    state, r = _rand(state, 11)
                    cg[y, x] = _r2(int(gauss[r]), shift)
            for y in range(3, chh):
                for x in range(3, cw - 3):
                    s = 0
                    for (dr, dc), c in zip(pos, coeffs):
                        s += c * int(cg[y + dr, x + dc])
                    if len(coeffs) == len(pos) + 1 and fg.num_y_points:
                        lx = ((x - 3) << ssx) + 3
                        ly = ((y - 3) << ssy) + 3
                        lum = 0
                        for i in range(ssy + 1):
                            for j in range(ssx + 1):
                                lum += int(luma[ly + i, lx + j])
                        lum = _r2(lum, ssx + ssy)
                        s += coeffs[-1] * lum
                    v = int(cg[y, x]) + _r2(s, fg.ar_coeff_shift)
                    cg[y, x] = min(max(v, gmin), gmax)
        out_c.append(cg)
    return luma, out_c[0], out_c[1]


def scaling_lut(points_val, points_scl, bd: int) -> np.ndarray:
    """Piecewise-linear scaling LUT (spec init scaling function),
    8-bit index domain."""
    n = len(points_val)
    lut = np.zeros(256, np.int64)
    if n == 0:
        return lut
    for i in range(points_val[0]):
        lut[i] = points_scl[0]
    for j in range(n - 1):
        dx = points_val[j + 1] - points_val[j]
        dy = points_scl[j + 1] - points_scl[j]
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for k in range(dx):
            lut[points_val[j] + k] = \
                points_scl[j] + ((k * delta + 32768) >> 16)
    for i in range(points_val[-1], 256):
        lut[i] = points_scl[-1]
    return lut


class FilmGrain:
    """Grain generator + blender for one parameter set."""

    def __init__(self, fg, seq, bd: int):
        self.fg = fg
        self.bd = bd
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y
        self.mono = getattr(seq.color, "mono_chrome", False)
        self.luma_g, self.cb_g, self.cr_g = generate_grain(
            fg, bd, self.ssx, self.ssy, self.mono)
        self.lut_y = scaling_lut(fg.point_y_value, fg.point_y_scaling, bd)
        if fg.chroma_scaling_from_luma:
            self.lut_cb = self.lut_y
            self.lut_cr = self.lut_y
        else:
            self.lut_cb = scaling_lut(fg.point_cb_value,
                                      fg.point_cb_scaling, bd)
            self.lut_cr = scaling_lut(fg.point_cr_value,
                                      fg.point_cr_scaling, bd)

    # -- grain sampling ------------------------------------------------

    @staticmethod
    def _offs(randval, sub):
        offx = 3 + (2 >> sub[0]) * (3 + (randval >> 4))
        offy = 3 + (2 >> sub[1]) * (3 + (randval & 0xF))
        return offx, offy

    def _g(self, grain, offsets, sub, bxi, byi, x, y):
        offx, offy = self._offs(offsets[bxi][byi], sub)
        return int(grain[offy + y + (BLK >> sub[1]) * byi,
                         offx + x + (BLK >> sub[0]) * bxi])

    def _grain_block(self, grain, offsets, sub, bw2, bh, xstart, ystart,
                     gmin, gmax):
        """(bh, bw2) grain with left/top overlap blending."""
        wx = [[27, 17], [17, 27]] if (2 >> sub[0]) == 2 else [[23, 22]]
        wy = [[27, 17], [17, 27]] if (2 >> sub[1]) == 2 else [[23, 22]]
        g = np.empty((bh, bw2), np.int64)
        for y in range(bh):
            for x in range(bw2):
                gr = self._g(grain, offsets, sub, 0, 0, x, y)
                if x < xstart:
                    old = self._g(grain, offsets, sub, 1, 0, x, y)
                    gr = _r2(old * wx[x][0] + gr * wx[x][1], 5)
                    gr = min(max(gr, gmin), gmax)
                if y < ystart:
                    top = self._g(grain, offsets, sub, 0, 1, x, y)
                    if x < xstart:
                        oldt = self._g(grain, offsets, sub, 1, 1, x, y)
                        top = _r2(oldt * wx[x][0] + top * wx[x][1], 5)
                        top = min(max(top, gmin), gmax)
                    gr = _r2(top * wy[y][0] + gr * wy[y][1], 5)
                    gr = min(max(gr, gmin), gmax)
                g[y, x] = gr
        return g

    # -- application ----------------------------------------------------

    def apply(self, planes: List[np.ndarray]) -> List[np.ndarray]:
        fg = self.fg
        bd = self.bd
        sx, sy = self.ssx, self.ssy
        out = [p.astype(np.int64).copy() for p in planes]
        h, w = planes[0].shape
        gmin = -(128 << (bd - 8))
        gmax = (128 << (bd - 8)) - 1
        if fg.clip_to_restricted_range:
            ymin, ymax = 16 << (bd - 8), 235 << (bd - 8)
            cmin, cmax = 16 << (bd - 8), 240 << (bd - 8)
        else:
            ymin = cmin = 0
            ymax = cmax = (1 << bd) - 1
        shift = fg.grain_scaling
        do_cb = bool(fg.num_cb_points or fg.chroma_scaling_from_luma)
        do_cr = bool(fg.num_cr_points or fg.chroma_scaling_from_luma)

        for row in range((h + 31) // 32):
            rows = 2 if (fg.overlap_flag and row > 0) else 1
            row_seeds = []
            for i in range(rows):
                s = fg.grain_seed
                s ^= (((row - i) * 37 + 178) & 0xFF) << 8
                s ^= ((row - i) * 173 + 105) & 0xFF
                row_seeds.append(s)
            yoff = row * 32
            bh = min(BLK, h - yoff)
            passes = []
            if fg.num_y_points:
                passes.append((0, self.luma_g, self.lut_y, (0, 0)))
            if not self.mono and len(planes) > 1:
                if do_cb:
                    passes.append((1, self.cb_g, self.lut_cb, (sx, sy)))
                if do_cr:
                    passes.append((2, self.cr_g, self.lut_cr, (sx, sy)))
            for plane, grain, lut, sub in passes:
                seeds = list(row_seeds)
                offsets = [[0] * rows + [0] * (2 - rows),
                           [0] * rows + [0] * (2 - rows)]
                pb_h = min(BLK >> sub[1], ((h + sy) >> sub[1])
                           - (yoff >> sub[1])) if plane else bh
                for bx in range(0, w, BLK):
                    if fg.overlap_flag and bx:
                        offsets[1] = list(offsets[0])
                    for i in range(rows):
                        seeds[i], r = _rand(seeds[i], 8)
                        offsets[0][i] = r
                    if plane == 0:
                        pb_w = min(BLK, w - bx)
                        px, py = bx, yoff
                    else:
                        pw = (w + sx) >> sx
                        pb_w = min(BLK >> sub[0], pw - (bx >> sub[0]))
                        px, py = bx >> sub[0], yoff >> sub[1]
                    if pb_w <= 0 or pb_h <= 0:
                        continue
                    ystart = (min(2 >> sub[1], pb_h)
                              if fg.overlap_flag and row > 0 else 0)
                    xstart = (min(2 >> sub[0], pb_w)
                              if fg.overlap_flag and bx > 0 else 0)
                    g = self._grain_block(grain, offsets, sub, pb_w, pb_h,
                                          xstart, ystart, gmin, gmax)
                    src = out[plane][py:py + pb_h, px:px + pb_w]
                    if plane == 0:
                        scale = lut[np.clip(src, 0, 255)]
                        vmin, vmax = ymin, ymax
                    else:
                        # chroma scaling index from (averaged) luma
                        luma = planes[0].astype(np.int64)
                        ly = py << sub[1]
                        lx = px << sub[0]
                        lblk = luma[ly:ly + (pb_h << sub[1]),
                                    lx:lx + (pb_w << sub[0])]
                        # pad to even dims for the horizontal pair avg
                        need_w = pb_w << sub[0]
                        if lblk.shape[1] < need_w:
                            lblk = np.pad(lblk,
                                          ((0, 0),
                                           (0, need_w - lblk.shape[1])),
                                          mode="edge")
                        need_h = pb_h << sub[1]
                        if lblk.shape[0] < need_h:
                            lblk = np.pad(lblk,
                                          ((0, need_h - lblk.shape[0]),
                                           (0, 0)), mode="edge")
                        avg = lblk[::(1 << sub[1]), ::(1 << sub[0])]
                        if sub[0]:
                            right = lblk[::(1 << sub[1]), 1::(1 << sub[0])]
                            avg = (avg + right + 1) >> 1
                        if fg.chroma_scaling_from_luma:
                            val = avg
                        else:
                            mult = (fg.cb_mult, fg.cr_mult)[plane - 1]
                            lmult = (fg.cb_luma_mult,
                                     fg.cr_luma_mult)[plane - 1]
                            offv = (fg.cb_offset, fg.cr_offset)[plane - 1]
                            # coded mults are biased by 128, the 9-bit
                            # offset by 256 (dav1d read_film_grain)
                            combined = (avg * (lmult - 128)
                                        + src * (mult - 128))
                            val = np.clip((combined >> 6)
                                          + ((offv - 256) << (bd - 8)),
                                          0, (1 << bd) - 1)
                        scale = lut[np.clip(val, 0, 255)]
                        vmin, vmax = cmin, cmax
                    noise = (scale * g + (1 << (shift - 1))) >> shift
                    out[plane][py:py + pb_h, px:px + pb_w] = \
                        np.clip(src + noise, vmin, vmax)
        return [np.clip(p, 0, (1 << bd) - 1).astype(planes[i].dtype)
                for i, p in enumerate(out)]
