"""Device loop restoration (spec §7.17): Wiener + self-guided.

LR is stripe-parallel by construction (64-px stripes
never read each other's output), so the frame becomes one batched
tensor of stripe windows and both filters run as dense, jitted,
integer-exact computations over (n_stripes, stripe_h(+6), width):

- Wiener: 7-tap separable filter with PER-COLUMN tap vectors (each
  restoration unit's taps are expanded across its columns on the host,
  so unit boundaries cost nothing on device — no gather, no ragged
  loops).
- Self-guided: box sums via cumulative sums along both axes, the
  z -> a2 mapping as a 256-entry LUT lookup (z fits uint32; the spec
  division becomes a host-precomputed table), per-column s/w weights.
- Per-column restoration-type masks select wiener / sgr / passthrough.

Bit-exactness contract: integer-only ops mirroring lr_ref
(LoopRestoration, the verified host reference pinned to dav1d by
tests/test_av1_lr*.py); reference role dav1d looprestoration_tmpl.c /
lr_apply_tmpl.c (cmake/dav1d.cmake:1001-1015).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1.lr_ref import SGR_RADII, SGR_S, _DIV_LUT


def _a2_lut() -> np.ndarray:
    """a2 as a function of min(z, 255) (spec 7.17.3)."""
    lut = np.empty(256, np.int32)
    lut[0] = 1
    for z in range(1, 255):
        lut[z] = ((z << 8) + z // 2) // (z + 1)
    lut[255] = 256
    return lut


_A2 = _a2_lut()


@functools.partial(
    __import__("jax").jit,
    static_argnames=("sh", "bd", "any_w", "any_s"))
def _lr_stripes(S, FH, FV, is_w, is_s, s0c, s1c, r0c, r1c, w0c, w1c,
                lut, sh, bd, any_w, any_s):
    """One plane's stripes.

    S: (ns, sh+6, W+6) int32 stripe sources (rows y0-3..y1+3, 3
    edge-replicated columns each side; short stripes padded by
    replicating their last valid row).
    FH/FV: (ns, 7, W) per-column wiener taps; is_w/is_s: (ns, W) bool;
    s0c/s1c/w0c/w1c: (ns, W) int32 sgr params; r0c/r1c: (ns, W) bool
    (radius enabled per pass).
    Returns (ns, sh, W) filtered pixels.
    """
    import jax.numpy as jnp

    W = S.shape[2] - 6
    center = S[:, 3:3 + sh, 3:3 + W]
    out = center

    if any_w:
        round0 = 3 + (2 if bd == 12 else 0)
        round1 = 11 - (2 if bd == 12 else 0)
        limit = (1 << (bd + 1 + 7 - round0)) - 1
        bias0 = 1 << (bd + 6)
        off1 = 1 << (bd + round1 - 1)
        inter = jnp.full_like(S[:, :, :W], bias0)
        for k in range(7):
            inter = inter + FH[:, k, None, :] * S[:, :, k:k + W]
        inter = jnp.clip((inter + (1 << (round0 - 1))) >> round0,
                         0, limit)
        resw = jnp.full_like(center, -off1)
        for k in range(7):
            resw = resw + FV[:, k, None, :] * inter[:, k:k + sh, :]
        resw = jnp.clip((resw + (1 << (round1 - 1))) >> round1,
                        0, (1 << bd) - 1)
        out = jnp.where(is_w[:, None, :], resw, out)

    if any_s:
        u = center << 4
        # box sums over the source for both radii via double cumsum.
        # A/B grids cover i in [-1, sh], j in [-1, W] (centers at
        # rows y0-1+i = S-row i+2, cols x0-1+j = S-col j+2).
        S2 = S * S

        def boxes(radius):
            k = 2 * radius + 1
            # grid storage row g (0..sh+1) is centred at S-row g+2,
            # so windows span S rows [2-radius, sh+3+radius] and cols
            # [2-radius, W+1+radius]: all within the 3-px padding.
            r0_ = 2 - radius
            c0_ = 2 - radius
            nr = sh + 2 + k - 1   # rows of windows along axis 1
            nc = W + 2 + k - 1
            sub = S[:, r0_:r0_ + nr, c0_:c0_ + nc]
            sub2 = S2[:, r0_:r0_ + nr, c0_:c0_ + nc]

            def win2d(x):
                c = jnp.cumsum(x, axis=1)
                c = jnp.concatenate(
                    [jnp.zeros_like(c[:, :1]), c], axis=1)
                rv = c[:, k:] - c[:, :-k]
                c2 = jnp.cumsum(rv, axis=2)
                c2 = jnp.concatenate(
                    [jnp.zeros_like(c2[:, :, :1]), c2], axis=2)
                return c2[:, :, k:] - c2[:, :, :-k]

            return win2d(sub2), win2d(sub)   # (ns, sh+2, W+2)

        def sgr_pass(radius, n, one_over_n, sc, pass0):
            asum, bsum = boxes(radius)
            if bd > 8:
                shp = 2 * (bd - 8)
                asum = (asum + (1 << (shp - 1))) >> shp
                bsum = (bsum + (1 << (bd - 9))) >> (bd - 8)
            p = jnp.maximum(0, asum * n - bsum * bsum)

            # a2/b2 for grid-column offset dx, computed with the s of
            # the OUTPUT column (restoration units recompute their
            # boundary ring with their own s, so s follows the output
            # column, not the window centre) -> (ns, sh+2, W)
            def ab(dx):
                pp = p[:, :, 1 + dx:1 + dx + W]
                bb = bsum[:, :, 1 + dx:1 + dx + W]
                z = ((pp.astype(jnp.uint32)
                      * sc[:, None, :].astype(jnp.uint32))
                     + (1 << 19)) >> 20
                a2 = lut[jnp.minimum(z, 255).astype(jnp.int32)]
                b2 = (((256 - a2) * bb) * one_over_n
                      + (1 << 11)) >> 12
                return a2, b2

            if pass0:
                # even rows: grid rows i and i+2 with col weights
                # 5/6/5, shift 9; odd rows: grid row i+1, shift 8
                a_e = jnp.zeros_like(center)
                b_e = jnp.zeros_like(center)
                a_o = jnp.zeros_like(center)
                b_o = jnp.zeros_like(center)
                for dx in (-1, 0, 1):
                    wt = 6 if dx == 0 else 5
                    a2, b2 = ab(dx)
                    a_e = a_e + wt * (a2[:, 0:sh, :]
                                      + a2[:, 2:sh + 2, :])
                    b_e = b_e + wt * (b2[:, 0:sh, :]
                                      + b2[:, 2:sh + 2, :])
                    a_o = a_o + wt * a2[:, 1:sh + 1, :]
                    b_o = b_o + wt * b2[:, 1:sh + 1, :]
                rows = jnp.arange(sh)
                even = (rows % 2 == 0)[None, :, None]
                v_e = (a_e * center + b_e + (1 << 8)) >> 9
                v_o = (a_o * center + b_o + (1 << 7)) >> 8
                return jnp.where(even, v_e, v_o)
            a_m = jnp.zeros_like(center)
            b_m = jnp.zeros_like(center)
            for dx in (-1, 0, 1):
                a2, b2 = ab(dx)
                for dy in (-1, 0, 1):
                    wt = 4 if (dx == 0 or dy == 0) else 3
                    a_m = a_m + wt * a2[:, 1 + dy:sh + 1 + dy, :]
                    b_m = b_m + wt * b2[:, 1 + dy:sh + 1 + dy, :]
            return (a_m * center + b_m + (1 << 8)) >> 9

        flt0 = jnp.where(r0c[:, None, :],
                         sgr_pass(2, 25, _DIV_LUT[25], s0c, True), u)
        flt1 = jnp.where(r1c[:, None, :],
                         sgr_pass(1, 9, _DIV_LUT[9], s1c, False), u)
        w2c = 128 - w0c - w1c
        v = (w0c[:, None, :] * flt0 + w1c[:, None, :] * u
             + w2c[:, None, :] * flt1)
        ress = jnp.clip((v + (1 << 10)) >> 11, 0, (1 << bd) - 1)
        out = jnp.where(is_s[:, None, :], ress, out)

    return out


class DeviceLoopRestoration:
    """Same contract as lr_ref.LoopRestoration: apply(planes,
    deblocked) modifies `planes` in place, bit-exact."""

    def __init__(self, hdr, seq, plan, bitdepth: int):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y

    def apply(self, planes: List[np.ndarray],
              deblocked: List[np.ndarray]) -> None:
        hdr = self.hdr
        lr = getattr(hdr, "lr", None)
        if lr is None or not lr.uses_lr:
            return
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            self._apply_plane(plane, planes, deblocked)

    def _plane_geometry(self, plane):
        hdr = self.hdr
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        pw = (hdr.upscaled_width + ssx) >> ssx
        ph = (hdr.frame_height + ssy) >> ssy
        stripe_h = 64 >> ssy
        stripe_off = 8 >> ssy
        ns = (ph + stripe_off + stripe_h - 1) // stripe_h
        return pw, ph, stripe_h, stripe_off, ns

    def _apply_plane(self, plane, planes, deblocked):
        import jax.numpy as jnp

        hdr = self.hdr
        lr = hdr.lr
        pw, ph, stripe_h, stripe_off, ns = self._plane_geometry(plane)
        unit_size = lr.loop_restoration_size[plane]
        unit_rows = max((ph + (unit_size >> 1)) // unit_size, 1)
        unit_cols = max((pw + (unit_size >> 1)) // unit_size, 1)
        cdef = np.asarray(planes[plane])[:ph, :pw].astype(np.int32)
        debl = np.asarray(deblocked[plane])[:ph, :pw].astype(np.int32)

        sh = stripe_h

        params = self._stripe_params(plane, pw, ph, sh, stripe_off, ns,
                                     unit_size, unit_rows, unit_cols)
        (spans, FH, FV, is_w, is_s, s0c, s1c, r0c, r1c, w0c, w1c,
         any_w, any_s) = params
        if not (any_w or any_s):
            return

        S = np.empty((ns, sh + 6, pw + 6), np.int32)
        row_idx, sel_debl = self._row_sources(ph, sh, stripe_off, ns,
                                              spans)
        for s in range(ns):
            if spans[s] is None:
                continue
            for i in range(sh + 6):
                src = debl if sel_debl[s, i] else cdef
                row = src[row_idx[s, i]]
                S[s, i, 3:3 + pw] = row
                S[s, i, :3] = row[0]
                S[s, i, 3 + pw:] = row[pw - 1]

        res = _lr_stripes(
            jnp.asarray(S), jnp.asarray(FH), jnp.asarray(FV),
            jnp.asarray(is_w), jnp.asarray(is_s), jnp.asarray(s0c),
            jnp.asarray(s1c), jnp.asarray(r0c), jnp.asarray(r1c),
            jnp.asarray(w0c), jnp.asarray(w1c), jnp.asarray(_A2),
            sh, self.bd, any_w, any_s)
        res = np.asarray(res)
        out = planes[plane]
        for s, span in enumerate(spans):
            if span is None:
                continue
            y0, h = span
            out[y0:y0 + h, :pw] = res[s, :h].astype(out.dtype)

    def _stripe_params(self, plane, pw, ph, stripe_h, stripe_off, ns,
                       unit_size, unit_rows, unit_cols):
        """Per-stripe spans + per-column wiener/sgr parameter maps
        (host math shared by the numpy and device-resident paths)."""
        FH = np.zeros((ns, 7, pw), np.int32)
        FV = np.zeros((ns, 7, pw), np.int32)
        is_w = np.zeros((ns, pw), bool)
        is_s = np.zeros((ns, pw), bool)
        s0c = np.zeros((ns, pw), np.int32)
        s1c = np.zeros((ns, pw), np.int32)
        r0c = np.zeros((ns, pw), bool)
        r1c = np.zeros((ns, pw), bool)
        w0c = np.zeros((ns, pw), np.int32)
        w1c = np.zeros((ns, pw), np.int32)
        spans = []   # per stripe: (y0, h) or None
        for s in range(ns):
            ss = s * stripe_h - stripe_off
            se = ss + stripe_h - 1
            y0 = max(0, ss)
            y1 = min(se, ph - 1)
            if y0 > y1:
                spans.append(None)
                continue
            spans.append((y0, y1 - y0 + 1))
            urow = min(unit_rows - 1, (ss + stripe_off) // unit_size)
            for ucol in range(unit_cols):
                ux0 = ucol * unit_size
                ux1 = ((ucol + 1) * unit_size - 1
                       if ucol < unit_cols - 1 else pw - 1)
                rtype = self.plan.lr_type.get((plane, urow, ucol),
                                              C.RESTORE_NONE)
                cs = slice(ux0, ux1 + 1)
                if rtype == C.RESTORE_WIENER:
                    taps = self.plan.lr_wiener[(plane, urow, ucol)]
                    fh = _fil7(taps[1], plane)
                    fv = _fil7(taps[0], plane)
                    for k in range(7):
                        FH[s, k, cs] = fh[k]
                        FV[s, k, cs] = fv[k]
                    is_w[s, cs] = True
                elif rtype == C.RESTORE_SGRPROJ:
                    sgr_set, xqd0, xqd1 = \
                        self.plan.lr_sgr[(plane, urow, ucol)]
                    rad = SGR_RADII[sgr_set]
                    sv = SGR_S[sgr_set]
                    s0c[s, cs] = sv[0]
                    s1c[s, cs] = sv[1]
                    r0c[s, cs] = rad[0] != 0
                    r1c[s, cs] = rad[1] != 0
                    w0c[s, cs] = xqd0
                    w1c[s, cs] = xqd1
                    is_s[s, cs] = True
        return (spans, FH, FV, is_w, is_s, s0c, s1c, r0c, r1c, w0c,
                w1c, bool(is_w.any()), bool(is_s.any()))

    @staticmethod
    def _row_sources(ph, stripe_h, stripe_off, ns, spans):
        """Per (stripe, source-row) plane-row index + deblocked-source
        flag (the stripe-assembly row selection, shared by host and
        device paths: rows above/below the stripe read the pre-CDEF
        deblocked snapshot, clamped 2 px into it)."""
        sh = stripe_h
        row_idx = np.zeros((ns, sh + 6), np.int64)
        sel_debl = np.zeros((ns, sh + 6), bool)
        for s in range(ns):
            if spans[s] is None:
                continue
            ss = s * stripe_h - stripe_off
            se = ss + stripe_h - 1
            y0, h = spans[s]
            for i in range(sh + 6):
                y = y0 - 3 + i
                if i >= h + 6:
                    y = y0 - 3 + h + 5
                yy = min(max(y, 0), ph - 1)
                if yy < ss:
                    row_idx[s, i] = max(ss - 2, yy)
                    sel_debl[s, i] = True
                elif yy > se:
                    row_idx[s, i] = min(se + 2, yy)
                    sel_debl[s, i] = True
                else:
                    row_idx[s, i] = yy
        return row_idx, sel_debl

    def apply_device(self, planes, deblocked):
        """Device-resident LR: `planes`/`deblocked` are device int32
        arrays (possibly mi-padded beyond the visible dims); returns a
        new list of device planes with LR applied, no host plane
        round-trips (stripe windows assemble as device row gathers).
        Bit-exact vs apply()."""
        import jax.numpy as jnp

        hdr = self.hdr
        lr = getattr(hdr, "lr", None)
        out = list(planes)
        if lr is None or not lr.uses_lr:
            return out
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            pw, ph, sh, stripe_off, ns = self._plane_geometry(plane)
            unit_size = lr.loop_restoration_size[plane]
            unit_rows = max((ph + (unit_size >> 1)) // unit_size, 1)
            unit_cols = max((pw + (unit_size >> 1)) // unit_size, 1)
            (spans, FH, FV, is_w, is_s, s0c, s1c, r0c, r1c, w0c, w1c,
             any_w, any_s) = self._stripe_params(
                plane, pw, ph, sh, stripe_off, ns, unit_size,
                unit_rows, unit_cols)
            if not (any_w or any_s):
                continue
            row_idx, sel_debl = self._row_sources(ph, sh, stripe_off,
                                                  ns, spans)
            cdef_d = out[plane][:ph, :pw].astype(jnp.int32)
            debl_d = deblocked[plane][:ph, :pw].astype(jnp.int32)
            flat = row_idx.reshape(-1)
            Sc = jnp.take(cdef_d, jnp.asarray(flat), axis=0)
            Sd = jnp.take(debl_d, jnp.asarray(flat), axis=0)
            S = jnp.where(jnp.asarray(sel_debl.reshape(-1))[:, None],
                          Sd, Sc).reshape(ns, sh + 6, pw)
            S = jnp.concatenate(
                [jnp.repeat(S[:, :, :1], 3, axis=2), S,
                 jnp.repeat(S[:, :, -1:], 3, axis=2)], axis=2)
            res = _lr_stripes(
                S, jnp.asarray(FH), jnp.asarray(FV),
                jnp.asarray(is_w), jnp.asarray(is_s), jnp.asarray(s0c),
                jnp.asarray(s1c), jnp.asarray(r0c), jnp.asarray(r1c),
                jnp.asarray(w0c), jnp.asarray(w1c), jnp.asarray(_A2),
                sh, self.bd, any_w, any_s)
            # scatter stripes back: row y lives in stripe
            # (y + stripe_off) // sh at offset y - y0(s)
            ymap = np.zeros(ph, np.int64)
            for s, span in enumerate(spans):
                if span is None:
                    continue
                y0, h = span
                ymap[y0:y0 + h] = s * sh + np.arange(h)
            restored = jnp.take(res.reshape(ns * sh, pw),
                                jnp.asarray(ymap), axis=0)
            out[plane] = out[plane].at[:ph, :pw].set(
                restored.astype(out[plane].dtype))
        return out


def _fil7(t3, plane):
    t0, t1, t2 = (0 if plane else t3[0]), t3[1], t3[2]
    if plane:
        center = 128 - 2 * (t1 + t2)
    else:
        center = 128 - 2 * (t0 + t1 + t2)
    return [t0, t1, t2, center, t2, t1, t0]
