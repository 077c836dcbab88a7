"""Deblocking loop filter on device (JAX, int32, bit-exact vs lf_ref).

Key fact that makes this vectorizable: within one pass, every edge's
read window is disjoint from every other edge's write window (AV1's
filter length is capped by the adjacent transform size, which also
lower-bounds the distance to the neighbouring edge), so all edges of a
pass filter in parallel from the pre-pass pixels — exactly what the
sequential reference computes.

Because edge columns sit on a stride-4 grid, every tap read and write
is a strided slice of the (padded) plane — no gathers.  The horizontal
pass runs the same core on the transposed plane.

Parity: lf_ref.py (verified bit-exact vs libdav1d); spec §7.14.
"""

from __future__ import annotations

import functools

import numpy as np

from easyav1.video.av1.lf_ref import (LoopFilter, _filter_levels,
                                          _limits)


def _pass_body(H: int, W: int, bd: int):
    """Traceable single-pass (vertical-edge) filter core on a [H, W]
    plane — the body behind `_make_pass_kernel`, reusable inside a
    larger fused jit (postfilter_fused).

    ne = W//4 - ... edges at x = 4*(e+1) for e in [0, ne); per-row maps:
      size_m  [H, ne] int32 — 0 (inactive), 4, 6, 8, 14
    limit/blimit/thresh are 0-d int32 arrays.
    """
    import jax
    import jax.numpy as jnp

    ne = (W + 3) // 4 - 1          # edges between 4px columns
    if ne <= 0:
        return None
    F = 1 << (bd - 8)
    half = 1 << (bd - 1)
    mxv = (1 << bd) - 1
    PAD = 8

    def kernel(buf, size_m, limit, blimit, thresh):
        B = jnp.full((H, W + 2 * PAD), 0, jnp.int32)
        B = B.at[:, PAD:PAD + W].set(buf)

        # taps: P[k] at x-1-k, Q[k] at x+k for edge x = 4*(e+1)
        def col(off):
            s = PAD + 4 + off
            return jax.lax.slice(B, (0, s), (H, s + 4 * (ne - 1) + 1),
                                 (1, 4))

        P = [col(-1 - k) for k in range(7)]
        Q = [col(k) for k in range(7)]
        p0, p1, p2, p3 = P[0], P[1], P[2], P[3]
        q0, q1, q2, q3 = Q[0], Q[1], Q[2], Q[3]

        a = jnp.abs
        sz = size_m
        act = sz > 0

        mask = ((a(p1 - p0) <= limit) & (a(q1 - q0) <= limit)
                & (a(p0 - q0) * 2 + (a(p1 - q1) >> 1) <= blimit))
        mask6 = (a(p2 - p1) <= limit) & (a(q2 - q1) <= limit)
        mask8 = (a(p3 - p2) <= limit) & (a(q3 - q2) <= limit)
        mask = mask & jnp.where(sz >= 6, mask6, True) \
                    & jnp.where(sz >= 8, mask8, True)
        mask = mask & act

        flat = ((a(p1 - p0) <= F) & (a(q1 - q0) <= F)
                & (a(p2 - p0) <= F) & (a(q2 - q0) <= F))
        flat = flat & jnp.where(sz >= 8,
                                (a(p3 - p0) <= F) & (a(q3 - q0) <= F),
                                True)
        flat2 = ((a(P[4] - p0) <= F) & (a(Q[4] - q0) <= F)
                 & (a(P[5] - p0) <= F) & (a(Q[5] - q0) <= F)
                 & (a(P[6] - p0) <= F) & (a(Q[6] - q0) <= F))

        use14 = mask & (sz == 14) & flat & flat2
        use8 = mask & (sz >= 8) & flat & ~use14
        use6 = mask & (sz == 6) & flat
        use4 = mask & ~(use14 | use8 | use6)

        # filter14 (13-tap, weights sum 16): offsets -6..5
        pv = P
        qv = Q
        f14 = {}
        f14[-6] = (pv[6] * 7 + pv[5] * 2 + pv[4] * 2 + pv[3] + pv[2]
                   + pv[1] + pv[0] + qv[0] + 8) >> 4
        f14[-5] = (pv[6] * 5 + pv[5] * 2 + pv[4] * 2 + pv[3] * 2 + pv[2]
                   + pv[1] + pv[0] + qv[0] + qv[1] + 8) >> 4
        f14[-4] = (pv[6] * 4 + pv[5] + pv[4] * 2 + pv[3] * 2 + pv[2] * 2
                   + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + 8) >> 4
        f14[-3] = (pv[6] * 3 + pv[5] + pv[4] + pv[3] * 2 + pv[2] * 2
                   + pv[1] * 2 + pv[0] + qv[0] + qv[1] + qv[2] + qv[3]
                   + 8) >> 4
        f14[-2] = (pv[6] * 2 + pv[5] + pv[4] + pv[3] + pv[2] * 2
                   + pv[1] * 2 + pv[0] * 2 + qv[0] + qv[1] + qv[2] + qv[3]
                   + qv[4] + 8) >> 4
        f14[-1] = (pv[6] + pv[5] + pv[4] + pv[3] + pv[2] + pv[1] * 2
                   + pv[0] * 2 + qv[0] * 2 + qv[1] + qv[2] + qv[3] + qv[4]
                   + qv[5] + 8) >> 4
        f14[0] = (pv[5] + pv[4] + pv[3] + pv[2] + pv[1] + pv[0] * 2
                  + qv[0] * 2 + qv[1] * 2 + qv[2] + qv[3] + qv[4] + qv[5]
                  + qv[6] + 8) >> 4
        f14[1] = (pv[4] + pv[3] + pv[2] + pv[1] + pv[0] + qv[0] * 2
                  + qv[1] * 2 + qv[2] * 2 + qv[3] + qv[4] + qv[5]
                  + qv[6] * 2 + 8) >> 4
        f14[2] = (pv[3] + pv[2] + pv[1] + pv[0] + qv[0] + qv[1] * 2
                  + qv[2] * 2 + qv[3] * 2 + qv[4] + qv[5] + qv[6] * 3
                  + 8) >> 4
        f14[3] = (pv[2] + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] * 2
                  + qv[3] * 2 + qv[4] * 2 + qv[5] + qv[6] * 4 + 8) >> 4
        f14[4] = (pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] * 2
                  + qv[4] * 2 + qv[5] * 2 + qv[6] * 5 + 8) >> 4
        f14[5] = (pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] * 2
                  + qv[5] * 2 + qv[6] * 7 + 8) >> 4

        f8 = {
            -3: (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
            -2: (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
            -1: (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
            0: (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
            1: (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
            2: (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
        }
        f6 = {
            -2: (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3,
            -1: (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3,
            0: (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3,
            1: (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3,
        }

        # narrow filter4
        def CL(x):
            return jnp.clip(x, -half, half - 1)

        ps1, ps0 = p1 - half, p0 - half
        qs0, qs1 = q0 - half, q1 - half
        hev = (a(p1 - p0) > thresh) | (a(q1 - q0) > thresh)
        f = jnp.where(hev, CL(ps1 - qs1), 0)
        f = CL(f + 3 * (qs0 - ps0))
        f1 = CL(f + 4) >> 3
        f2 = CL(f + 3) >> 3
        f3 = (f1 + 1) >> 1
        f4 = {
            0: jnp.clip(CL(qs0 - f1) + half, 0, mxv),
            -1: jnp.clip(CL(ps0 + f2) + half, 0, mxv),
            1: jnp.clip(CL(qs1 - f3) + half, 0, mxv),
            -2: jnp.clip(CL(ps1 + f3) + half, 0, mxv),
        }
        f4w = {0: use4, -1: use4, 1: use4 & ~hev, -2: use4 & ~hev}

        # write back per offset.  All candidates come from the pre-pass
        # taps P/Q (snapshotted above).  The strided lanes of different
        # offsets ALIAS across neighbouring edges (4(e+1)+off grid), so
        # each write must be masked to the lanes a filter actually
        # touches — unmasked lanes keep the CURRENT value, which may
        # already hold a neighbouring edge's output.  Lanes where two
        # filters both write never exist (the AV1 filter-length /
        # edge-spacing bound), so the merge order is irrelevant.
        for off in range(-6, 6):
            v = P[-1 - off] if off < 0 else Q[off]
            wm = use14
            if off in f4:
                v = jnp.where(f4w[off], f4[off], v)
                wm = wm | f4w[off]
            if off in f6:
                v = jnp.where(use6, f6[off], v)
                wm = wm | use6
            if off in f8:
                v = jnp.where(use8, f8[off], v)
                wm = wm | use8
            v = jnp.where(use14, f14[off], v)
            s = PAD + 4 + off
            cur = jax.lax.slice(B, (0, s), (H, s + 4 * (ne - 1) + 1),
                                (1, 4))
            B = B.at[:, s:s + 4 * (ne - 1) + 1:4].set(
                jnp.where(wm, v, cur))
        return B[:, PAD:PAD + W]

    return kernel


@functools.lru_cache(maxsize=None)
def _make_pass_kernel(H: int, W: int, bd: int):
    """Jitted wrapper over `_pass_body` (see its docstring)."""
    import jax
    body = _pass_body(H, W, bd)
    return jax.jit(body) if body is not None else None


def _cell_maps(g, plane, vertical: bool):
    """Per-cell edge size map (0=inactive) from lf_ref grids, matching
    the reference's per-edge conditions."""
    gw, gh = g["gw"], g["gh"]
    txw, txh = g["txw"], g["txh"]
    skip = g["skip"].astype(bool)
    if vertical:
        cx = np.arange(1, gw, dtype=np.int32)[None, :]      # [1, ne]
        on_edge = (cx % txw[:, 1:]) == 0
        blk = g["edge_left"][:, 1:]
        sk = skip[:, 1:] & skip[:, :-1]
        active = on_edge & (blk | ~sk)
        min_tx = np.minimum(txw[:, 1:], txw[:, :-1]) * 4
    else:
        cy = np.arange(1, gh, dtype=np.int32)[None, :]      # [1, ne]
        on_edge = (cy % txh[1:, :].T) == 0
        blk = g["edge_top"][1:, :].T
        sk = (skip[1:, :] & skip[:-1, :]).T
        active = on_edge & (blk | ~sk)
        min_tx = np.minimum(txh[1:, :], txh[:-1, :]).T * 4
    if plane == 0:
        s = np.where(min_tx >= 16, 14, np.where(min_tx >= 8, 8, 4))
    else:
        s = np.where(min_tx >= 8, 6, 4)
    return np.where(active, s, 0).astype(np.int32)


def device_pass(buf, hdr, bd, plane, pass_, g):
    """Run one device LF pass in place on buf given an lf_ref-style
    grids dict g."""
    lvl = _filter_levels(hdr, plane, pass_, None)
    if lvl == 0:
        return
    limit, blimit, thresh = _limits(lvl, hdr.lf.sharpness, bd)
    h, w = buf.shape
    vertical = pass_ == 0
    size = _cell_maps(g, plane, vertical)
    if size.shape[1] <= 0:
        return
    # visible-frame crop in 4px units (parity: lf_ref._filter_pass)
    ss_x = 1 if g["gw"] < hdr.mi_cols else 0
    ss_y = 1 if g["gh"] < hdr.mi_rows else 0
    h4u = (hdr.frame_height + 3) >> 2
    w4u = (hdr.upscaled_width + 3) >> 2
    vis_h = min(h, ((h4u + ss_y) >> ss_y) << 2)
    vis_w = min(w, ((w4u + ss_x) >> ss_x) << 2)
    if vertical:
        size[(vis_h + 3) >> 2:, :] = 0
        for e in range(size.shape[1]):   # edge e is at x = (e+1)*4
            if (e + 1) * 4 >= vis_w:
                size[:, e] = 0
    else:
        size[(vis_w + 3) >> 2:, :] = 0
        for e in range(size.shape[1]):   # edge e is at y = (e+1)*4
            if (e + 1) * 4 >= vis_h:
                size[:, e] = 0
    if vertical:
        size_m = np.repeat(size, 4, axis=0)[:h]
        kern = _make_pass_kernel(h, w, bd)
        if kern is None:
            return
        out = kern(buf.astype(np.int32), size_m,
                   np.int32(limit), np.int32(blimit), np.int32(thresh))
        buf[:, :] = np.asarray(out)
    else:
        size_m = np.repeat(size, 4, axis=0)[:w]
        kern = _make_pass_kernel(w, h, bd)
        if kern is None:
            return
        out = kern(np.ascontiguousarray(buf.T).astype(np.int32),
                   size_m,
                   np.int32(limit), np.int32(blimit), np.int32(thresh))
        buf[:, :] = np.asarray(out).T


def lf_device_apply(planes, hdr, bd, grids_for) -> None:
    """Device loop filter over all planes; grids_for(plane, shape)
    returns the lf_ref-style grids dict (from the Python plan or from
    the native decoder's exported grids)."""
    if hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0 and \
            hdr.lf.level[2] == 0 and hdr.lf.level[3] == 0:
        return
    if getattr(hdr, "allow_intrabc", False):
        return
    for plane in range(len(planes)):
        # spec 7.14.1: luma skipped only when BOTH level[0]/[1] are 0 —
        # delta-adjusted per-block levels can be nonzero at base 0
        if plane == 0 and hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0:
            continue
        if plane == 1 and hdr.lf.level[2] == 0:
            continue
        if plane == 2 and hdr.lf.level[3] == 0:
            continue
        g = grids_for(plane, planes[plane].shape)
        for pass_ in (0, 1):
            device_pass(planes[plane], hdr, bd, plane, pass_, g)


class LoopFilterDevice(LoopFilter):
    """Device loop filter; reuses the reference's grid building."""

    def apply(self, planes) -> None:
        lf_device_apply(planes, self.hdr, self.bd, self._build_grids)
