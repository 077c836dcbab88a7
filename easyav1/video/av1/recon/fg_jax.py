"""Device film-grain synthesis (spec §7.18.3).

Film grain is an output-only device kernel —
no intra-frame dependencies, pure per-pixel integer math.  The
sequential pieces (LFSR grain-template generation, per-block offset
randvals) are tiny and stay on the host (fg_ref.generate_grain /
_rand); the dense work — grain window gathers, overlap blending,
scaling-LUT application, noise add — runs as one jitted device
computation per plane, vectorized over all 32x32 grain blocks.

Bit-exactness contract: integer-only ops mirroring fg_ref.FilmGrain
(the verified host reference, itself pinned to dav1d via the
conformance tests); reference role dav1d filmgrain_tmpl.c / fg_apply
(cmake/dav1d.cmake:1001-1015).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from easyav1.video.av1.fg_ref import (BLK, FilmGrain, _rand)


def _block_randvals(seed: int, nrows: int, ncols: int) -> np.ndarray:
    """R[r, c]: c-th 8-bit randval of the LFSR stream seeded for block
    row r (fg_ref row_seeds + per-bx advance)."""
    out = np.zeros((nrows, ncols), np.int32)
    for r in range(nrows):
        s = seed
        s ^= ((r * 37 + 178) & 0xFF) << 8
        s ^= (r * 173 + 105) & 0xFF
        for c in range(ncols):
            s, rv = _rand(s, 8)
            out[r, c] = rv
    return out


def _offsets(rv: np.ndarray, subx: int, suby: int):
    offx = 3 + (2 >> subx) * (3 + (rv >> 4))
    offy = 3 + (2 >> suby) * (3 + (rv & 0xF))
    return offx.astype(np.int32), offy.astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("bh", "bw", "nrows", "ncols", "subx", "suby",
                     "overlap", "gmin", "gmax"))
def _grain_plane(grain_pad, offx, offy, bh, bw, nrows, ncols, subx,
                 suby, overlap, gmin, gmax):
    """Per-block grain windows with left/top overlap blending →
    (nrows*bh, ncols*bw) grain plane.

    offx/offy: (4, nrows, ncols) window offsets for
    [cur, left-col, above-row, above-left] randvals."""
    def win(oy, ox, dy, dx):
        return jax.lax.dynamic_slice(grain_pad, (oy + dy, ox + dx),
                                     (bh, bw))

    wins = jax.vmap(win, in_axes=(0, 0, None, None))
    g_cur = wins(offy[0].reshape(-1), offx[0].reshape(-1), 0, 0)
    g_left = wins(offy[1].reshape(-1), offx[1].reshape(-1), 0, bw)
    g_top = wins(offy[2].reshape(-1), offx[2].reshape(-1), bh, 0)
    g_tl = wins(offy[3].reshape(-1), offx[3].reshape(-1), bh, bw)

    def r2_5(x):
        return (x + 16) >> 5

    x_idx = jnp.arange(bw, dtype=jnp.int32)[None, None, :]
    y_idx = jnp.arange(bh, dtype=jnp.int32)[None, :, None]
    bcol = jnp.tile(jnp.arange(ncols, dtype=jnp.int32), nrows)
    brow = jnp.repeat(jnp.arange(nrows, dtype=jnp.int32), ncols)
    n_over_x = 2 >> subx
    n_over_y = 2 >> suby
    # horizontal blend weights per overlap column
    if n_over_x == 2:
        wx_old = jnp.where(x_idx == 0, 27, 17)
        wx_new = jnp.where(x_idx == 0, 17, 27)
    else:
        wx_old = jnp.full_like(x_idx, 23)
        wx_new = jnp.full_like(x_idx, 22)
    if n_over_y == 2:
        wy_old = jnp.where(y_idx == 0, 27, 17)
        wy_new = jnp.where(y_idx == 0, 17, 27)
    else:
        wy_old = jnp.full_like(y_idx, 23)
        wy_new = jnp.full_like(y_idx, 22)

    xmask = ((x_idx < n_over_x) & (bcol[:, None, None] > 0)
             & bool(overlap))
    ymask = ((y_idx < n_over_y) & (brow[:, None, None] > 0)
             & bool(overlap))

    def hblend(old, new):
        b = jnp.clip(r2_5(old * wx_old + new * wx_new), gmin, gmax)
        return jnp.where(xmask, b, new)

    g_h = hblend(g_left, g_cur)
    g_th = hblend(g_tl, g_top)
    g = jnp.clip(r2_5(g_th * wy_old + g_h * wy_new), gmin, gmax)
    g = jnp.where(ymask, g, g_h)
    return (g.reshape(nrows, ncols, bh, bw)
            .transpose(0, 2, 1, 3)
            .reshape(nrows * bh, ncols * bw))


@functools.partial(jax.jit, static_argnames=("shift", "vmin", "vmax"))
def _apply_luma(src, g, lut, shift, vmin, vmax):
    scale = lut[jnp.clip(src, 0, 255)]
    noise = (scale * g + (1 << (shift - 1))) >> shift
    return jnp.clip(src + noise, vmin, vmax)


@functools.partial(
    jax.jit,
    static_argnames=("shift", "vmin", "vmax", "subx", "suby", "bd",
                     "from_luma", "mult", "lmult", "offv"))
def _apply_chroma(src, luma, g, lut, shift, vmin, vmax, subx, suby, bd,
                  from_luma, mult, lmult, offv):
    avg = luma[::(1 << suby), ::(1 << subx)]
    if subx:
        avg = (avg + luma[::(1 << suby), 1::(1 << subx)] + 1) >> 1
    if from_luma:
        val = avg
    else:
        combined = avg * (lmult - 128) + src * (mult - 128)
        val = jnp.clip((combined >> 6) + ((offv - 256) << (bd - 8)),
                       0, (1 << bd) - 1)
    scale = lut[jnp.clip(val, 0, 255)]
    noise = (scale * g + (1 << (shift - 1))) >> shift
    return jnp.clip(src + noise, vmin, vmax)


class DeviceFilmGrain:
    """Film grain applied on device; host does templates + randvals.

    Same contract as fg_ref.FilmGrain.apply (bit-exact); planes in,
    grained planes out."""

    def __init__(self, fg, seq, bd: int):
        self.fg = fg
        self.bd = bd
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y
        ref = FilmGrain(fg, seq, bd)   # host: grain templates + LUTs
        self.mono = ref.mono
        pad = BLK + 8
        self._grain = {}
        if fg.num_y_points:
            self._grain[0] = jnp.asarray(np.pad(
                ref.luma_g, ((0, pad), (0, pad))).astype(np.int32))
        if not self.mono and ref.cb_g is not None:
            g = np.pad(ref.cb_g, ((0, pad), (0, pad))).astype(np.int32)
            self._grain[1] = jnp.asarray(g)
            g = np.pad(ref.cr_g, ((0, pad), (0, pad))).astype(np.int32)
            self._grain[2] = jnp.asarray(g)
        self._lut = {0: jnp.asarray(ref.lut_y.astype(np.int32)),
                     1: jnp.asarray(ref.lut_cb.astype(np.int32)),
                     2: jnp.asarray(ref.lut_cr.astype(np.int32))}

    def apply(self, planes: List[np.ndarray]) -> List[np.ndarray]:
        fg = self.fg
        bd = self.bd
        sx, sy = self.ssx, self.ssy
        h, w = planes[0].shape
        nrows = (h + BLK - 1) // BLK
        ncols = (w + BLK - 1) // BLK
        R = _block_randvals(fg.grain_seed, nrows, ncols)
        z = np.zeros_like(R)
        tl = z.copy()
        tl[1:, 1:] = R[:-1, :-1]
        R4 = np.stack([
            R,                                          # current
            np.concatenate([z[:, :1], R[:, :-1]], 1),   # left column
            np.concatenate([z[:1], R[:-1]], 0),         # row above
            tl,                                         # above-left
        ])
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

        # edge-padded device planes at full-block dims (partial-block
        # tails are computed then cropped; edge padding matches the
        # reference's luma-average edge handling)
        def pad_to(a, ph, pw):
            return np.pad(a, ((0, ph - a.shape[0]), (0, pw - a.shape[1])),
                          mode="edge")

        H, W = nrows * BLK, ncols * BLK
        luma_dev = None
        out = [np.asarray(p) for p in planes]
        if fg.num_y_points:
            src = jnp.asarray(pad_to(planes[0], H, W).astype(np.int32))
            ox, oy = _offsets(R4, 0, 0)
            g = _grain_plane(self._grain[0], ox, oy, BLK, BLK, nrows,
                             ncols, 0, 0, bool(fg.overlap_flag),
                             gmin, gmax)
            res = _apply_luma(src, g, self._lut[0], shift, ymin, ymax)
            out[0] = np.asarray(res)[:h, :w].astype(planes[0].dtype)
        if (do_cb or do_cr) and not self.mono and len(planes) > 1:
            ch, cw2 = planes[1].shape
            CH, CW = nrows * (BLK >> sy), ncols * (BLK >> sx)
            luma_dev = jnp.asarray(
                pad_to(planes[0], CH << sy, CW << sx).astype(np.int32))
            ox, oy = _offsets(R4, sx, sy)
            for plane in (1, 2):
                if plane == 1 and not do_cb:
                    continue
                if plane == 2 and not do_cr:
                    continue
                src = jnp.asarray(
                    pad_to(planes[plane], CH, CW).astype(np.int32))
                g = _grain_plane(self._grain[plane], ox, oy, BLK >> sy,
                                 BLK >> sx, nrows, ncols, sx, sy,
                                 bool(fg.overlap_flag), gmin, gmax)
                mult = (fg.cb_mult, fg.cr_mult)[plane - 1]
                lmult = (fg.cb_luma_mult, fg.cr_luma_mult)[plane - 1]
                offv = (fg.cb_offset, fg.cr_offset)[plane - 1]
                res = _apply_chroma(
                    src, luma_dev, g, self._lut[plane], shift, cmin,
                    cmax, sx, sy, bd, bool(fg.chroma_scaling_from_luma),
                    mult, lmult, offv)
                out[plane] = np.asarray(res)[:ch, :cw2].astype(
                    planes[plane].dtype)
        return out
