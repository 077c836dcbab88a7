"""CDEF on device (JAX, int32, bit-exact vs cdef_ref).

The whole frame filters in one jitted call: the direction search runs
for every 8x8 luma unit as a batched tensor contraction, and the 12-tap
constrained filter is applied plane-wide with per-pixel parameter maps
(strength/shift/direction broadcast from per-unit arrays).  Taps whose
(dir-dependent) offsets land outside the frame read CDEF_VERY_LARGE
from the constant padded source, exactly like the scalar reference.

Parity: cdef_ref.py (itself verified bit-exact vs libdav1d); spec §7.15.
"""

from __future__ import annotations

import functools

import numpy as np

CDEF_VERY_LARGE = 0x4000

# Cdef_Directions[dir][k] = (dy, dx), primary taps k=0,1
CDEF_DIRECTIONS = np.array([
    [[-1, 1], [-2, 2]], [[0, 1], [-1, 2]], [[0, 1], [0, 2]],
    [[0, 1], [1, 2]], [[1, 1], [2, 2]], [[1, 0], [2, 1]],
    [[1, 0], [2, 0]], [[1, 0], [2, -1]]], np.int32)

DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)

CDEF_UV_DIR = np.array([
    [[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
    [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]]], np.int32)


def _partial_indicators():
    """IND[d, k, i, j] = 1 where pixel (i,j) of an 8x8 block contributes
    to partial[d][k] (spec §7.15.2 direction search)."""
    ind = np.zeros((8, 15, 8, 8), np.int32)
    for i in range(8):
        for j in range(8):
            ind[0, i + j, i, j] = 1
            ind[1, i + (j >> 1), i, j] = 1
            ind[2, i, i, j] = 1
            ind[3, 3 + i - (j >> 1), i, j] = 1
            ind[4, 7 + i - j, i, j] = 1
            ind[5, 3 - (i >> 1) + j, i, j] = 1
            ind[6, j, i, j] = 1
            ind[7, (i >> 1) + j, i, j] = 1
    return ind


def _cost_weights():
    """W[d, k] so that cost[d] = sum_k W[d,k] * partial[d,k]^2."""
    w = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        w[d, :8] = 105
    for d in (0, 4):
        for i in range(7):
            w[d, i] = DIV_TABLE[i + 1]
            w[d, 14 - i] = DIV_TABLE[i + 1]
        w[d, 7] = 105
    for d in (1, 3, 5, 7):
        for i in range(5):
            w[d, 3 + i] = 105
        for i in range(3):
            w[d, i] = DIV_TABLE[2 * i + 2]
            w[d, 10 - i] = DIV_TABLE[2 * i + 2]
    return w


@functools.lru_cache(maxsize=None)
def _make_partial_kernel(uh: int, uw: int, coeff_shift: int):
    """Jitted per-unit direction-search partial sums: luma_pad
    [uh*8+4, uw*8+4] int32 → partials [uh, uw, 8, 15] int32.
    |partial| ≤ 8·(CDEF_VERY_LARGE>>shift) < 2^18, safely int32; the
    squares need int64 and are summed on the host."""
    import jax
    import jax.numpy as jnp

    IND = _partial_indicators()

    def kernel(luma_pad):
        lh = uh * 8
        lw = uw * 8
        blocks = luma_pad[2:2 + lh, 2:2 + lw]
        blocks = blocks.reshape(uh, 8, uw, 8).transpose(0, 2, 1, 3)
        x = (blocks >> coeff_shift) - 128                 # [uh,uw,8,8]
        return jnp.einsum("uvij,dkij->uvdk", x, IND,
                          preferred_element_type=jnp.int32)

    return jax.jit(kernel)


def find_dirs_host(partials: np.ndarray):
    """cost/argmax/variance from device partials (int64 host math,
    mirror of cdef_ref.find_dir)."""
    part = partials.astype(np.int64)
    cost = np.sum((part ** 2) * _cost_weights()[None, None], axis=-1)
    best = np.argmax(cost, axis=-1).astype(np.int32)     # first max wins
    bc = np.take_along_axis(cost, best[..., None].astype(np.int64),
                            axis=-1)[..., 0]
    oc = np.take_along_axis(cost, (((best + 4) & 7)[..., None]
                                   .astype(np.int64)), axis=-1)[..., 0]
    var = ((bc - oc) >> 10).astype(np.int32)
    return best, var


def _filter_body(ph: int, pw: int, ssx: int, ssy: int, plane: int,
                 bitdepth: int, damping: int):
    """Traceable CDEF filter for one plane of dims (ph, pw) — the body
    behind `_make_kernel`, reusable inside a larger fused jit.

    Args of the returned fn:
      plane_in  [ph, pw] int32 — the deblocked plane
      dir_u, var_u [uh, uw] int32 — per-unit direction / variance
      pri_u, sec_u [uh, uw] int32 — per-8x8-unit strengths
                (shifted by coeff_shift; 0 where the unit is skipped)
      filt_u   [uh, uw] int32 — 1 where the unit is filtered at all
    Returns the filtered plane [ph, pw] int32.
    """
    import jax
    import jax.numpy as jnp

    coeff_shift = bitdepth - 8
    # unit dims in this plane: 8x8 luma → (8>>ssy)x(8>>ssx) here
    bw = 8 >> (ssx if plane else 0)
    bh = 8 >> (ssy if plane else 0)
    pdamp = damping - (1 if plane else 0)

    def kernel(plane_in, dir_u, var_u, pri_u, sec_u, filt_u):
        if plane == 0:
            # luma primary scales with direction variance
            v6 = var_u >> 6
            lg = 31 - jax.lax.clz(jnp.maximum(v6, 1))
            i = jnp.minimum(lg, 12)
            adj = jnp.where(var_u != 0,
                            (pri_u * (4 + i) + 8) >> 4,
                            0)
            # the direction gate uses the PRE-adjustment strength: the
            # secondary taps keep the searched direction even when the
            # variance scaling rounds the primary strength to zero
            # (parity: cdef_ref.apply's `pdir = dir_ if pri else 0`)
            pdir_u = jnp.where(pri_u != 0, dir_u, 0)
            pri_u = jnp.where(pri_u != 0, adj, 0)
        else:
            remap = jnp.asarray(CDEF_UV_DIR[ssx][ssy])
            pdir_u = jnp.where(pri_u != 0, remap[dir_u], 0)

        # damping shifts per unit: max(0, pdamp - floor_log2(strength))
        def shift_for(thr):
            lg = 31 - jax.lax.clz(jnp.maximum(thr, 1))
            return jnp.maximum(0, pdamp - lg)

        pri_sh = shift_for(pri_u)
        sec_sh = shift_for(sec_u)

        pdir_u = pdir_u.astype(jnp.int32)

        # padded source (constant): border = CDEF_VERY_LARGE
        src = jnp.full((ph + 4, pw + 4), CDEF_VERY_LARGE, jnp.int32)
        src = src.at[2:2 + ph, 2:2 + pw].set(plane_in)

        # per-pixel maps (unit grid may overhang the plane; crop)
        def up(u):  # [uh,uw] -> [ph,pw]
            e = jnp.repeat(jnp.repeat(u, bh, axis=0), bw, axis=1)
            return e[:ph, :pw]

        pri_p = up(pri_u)
        sec_p = up(sec_u)
        pri_shp = up(pri_sh)
        sec_shp = up(sec_sh)
        dir_p = up(pdir_u)
        filt_p = up(filt_u)

        px = plane_in

        pt_even = jnp.asarray(np.array([4, 2], np.int32))
        pt_odd = jnp.asarray(np.array([3, 3], np.int32))
        is_odd = (pri_p >> coeff_shift) & 1
        st = np.array([2, 1], np.int32)

        def tap_value(dir_map, k, sgn):
            """Tap plane for offset sgn*CDEF_DIRECTIONS[d, k] selected
            per pixel by dir_map — static shifted slices + an 8-way
            select instead of a per-pixel gather (shifted slices fuse
            into the selects)."""
            out = None
            for d in range(8):
                dy = int(CDEF_DIRECTIONS[d, k, 0]) * sgn
                dx = int(CDEF_DIRECTIONS[d, k, 1]) * sgn
                v = jax.lax.slice(src, (2 + dy, 2 + dx),
                                  (2 + dy + ph, 2 + dx + pw))
                out = v if out is None else \
                    jnp.where(dir_map == d, v, out)
            return out

        def constr(diff, thr, sh):
            ad = jnp.abs(diff)
            rhs = jnp.maximum(thr - (ad >> sh), 0)
            mag = jnp.minimum(ad, rhs)
            return jnp.where(diff < 0, -mag, mag)

        s = jnp.zeros((ph, pw), jnp.int32)
        mx = px
        mn = px

        # primary taps
        for k in range(2):
            w_k = jnp.where(is_odd == 1, pt_odd[k], pt_even[k])
            for sgn in (1, -1):
                v = tap_value(dir_p, k, sgn)
                tap = w_k * constr(v - px, pri_p, pri_shp)
                s = s + jnp.where(pri_p != 0, tap, 0)
                seen = (pri_p != 0) & (v != CDEF_VERY_LARGE)
                mx = jnp.where(seen, jnp.maximum(mx, v), mx)
                mn = jnp.where(seen, jnp.minimum(mn, v), mn)
        # secondary taps
        for rot in (2, 6):
            sdir = (dir_p + rot) & 7
            for k in range(2):
                for sgn in (1, -1):
                    v = tap_value(sdir, k, sgn)
                    tap = st[k] * constr(v - px, sec_p, sec_shp)
                    s = s + jnp.where(sec_p != 0, tap, 0)
                    seen = (sec_p != 0) & (v != CDEF_VERY_LARGE)
                    mx = jnp.where(seen, jnp.maximum(mx, v), mx)
                    mn = jnp.where(seen, jnp.minimum(mn, v), mn)

        val = px + ((8 + s - (s < 0)) >> 4)
        val = jnp.clip(val, mn, mx)
        active = (filt_p != 0) & ((pri_p != 0) | (sec_p != 0))
        return jnp.where(active, val, px)

    return kernel


@functools.lru_cache(maxsize=None)
def _make_kernel(ph: int, pw: int, ssx: int, ssy: int, plane: int,
                 bitdepth: int, damping: int):
    """Jitted wrapper over `_filter_body` (see its docstring)."""
    import jax
    return jax.jit(_filter_body(ph, pw, ssx, ssy, plane, bitdepth,
                                damping))


def _dirs_body(uh: int, uw: int, coeff_shift: int):
    """Traceable on-device direction search: deblocked luma plane
    (padded to the unit grid with CDEF_VERY_LARGE) → (dir, var) int32
    [uh, uw].

    Exactness: partial sums read real pixels only when the unit grid
    does not overhang the mi-aligned plane; then |x| <= 128+
    after the coeff shift, partial k sums n_k <= 8 of them, and
    cost = sum_k w_k * p_k^2 <= 840*128^2*64 < 2^31 — int32 is exact.
    Callers must use the host fallback (`find_dirs_host`) when the
    unit grid overhangs (VERY_LARGE values break the bound).
    """
    import jax.numpy as jnp

    IND = _partial_indicators()
    W32 = _cost_weights().astype(np.int32)

    def body(luma_pad):
        lh, lw = uh * 8, uw * 8
        blocks = luma_pad[2:2 + lh, 2:2 + lw]
        blocks = blocks.reshape(uh, 8, uw, 8).transpose(0, 2, 1, 3)
        x = (blocks >> coeff_shift) - 128                 # [uh,uw,8,8]
        part = jnp.einsum("uvij,dkij->uvdk", x, jnp.asarray(IND),
                          preferred_element_type=jnp.int32)
        cost = jnp.sum(part * part * jnp.asarray(W32)[None, None],
                       axis=-1)                           # [uh,uw,8]
        best = jnp.argmax(cost, axis=-1).astype(jnp.int32)
        bc = jnp.take_along_axis(cost, best[..., None], axis=-1)[..., 0]
        oc = jnp.take_along_axis(cost, ((best + 4) & 7)[..., None],
                                 axis=-1)[..., 0]
        var = (bc - oc) >> 10
        return best, var

    return body


def unit_maps(skip_grid: np.ndarray, cdef_idx_grid: np.ndarray,
              mi_rows: int, mi_cols: int):
    """Per-8x8-unit (filtered?, strength index) maps from the mi skip
    grid and the per-64x64 cdef index grid (vectorized host math)."""
    uh = (mi_rows + 1) // 2
    uw = (mi_cols + 1) // 2
    # pad the skip grid to even dims replicating the last row/col
    # (matches min(r+1, mi_rows-1) in the scalar walk)
    sk = np.asarray(skip_grid, np.int8)
    if mi_rows & 1:
        sk = np.vstack([sk, sk[-1:]])
    if mi_cols & 1:
        sk = np.hstack([sk, sk[:, -1:]])
    all_skip = (sk[0::2, 0::2] & sk[0::2, 1::2]
                & sk[1::2, 0::2] & sk[1::2, 1::2])
    uy, ux = np.mgrid[0:uh, 0:uw]
    idxm = cdef_idx_grid[(uy * 2) // 16, (ux * 2) // 16].astype(np.int32)
    filt = ((all_skip == 0) & (idxm >= 0)).astype(np.int32)
    idxm = np.where(filt, idxm, -1)
    return filt, idxm


def cdef_device_apply(planes, hdr, seq, ssx, ssy, bd, filt, idxm):
    """Device CDEF on mi-aligned planes given precomputed unit maps."""
    cd = hdr.cdef
    coeff_shift = bd - 8
    y_pri = np.array(cd.y_pri_strength, np.int32)
    y_sec = np.array(cd.y_sec_strength, np.int32)
    uv_pri = np.array(cd.uv_pri_strength, np.int32)
    uv_sec = np.array(cd.uv_sec_strength, np.int32)
    safe = np.where(idxm >= 0, idxm, 0)
    sel = filt != 0
    uh, uw = filt.shape

    luma = planes[0]
    lh, lw = uh * 8, uw * 8
    lpad = np.full((lh + 4, lw + 4), CDEF_VERY_LARGE, np.int32)
    lpad[2:2 + luma.shape[0], 2:2 + luma.shape[1]] = luma
    partials = np.asarray(_make_partial_kernel(uh, uw, coeff_shift)(lpad))
    dir_u, var_u = find_dirs_host(partials)

    for plane in range(len(planes)):
        if plane == 0:
            pri = np.where(sel, y_pri[safe], 0) << coeff_shift
            sec = np.where(sel, y_sec[safe], 0) << coeff_shift
        else:
            pri = np.where(sel, uv_pri[safe], 0) << coeff_shift
            sec = np.where(sel, uv_sec[safe], 0) << coeff_shift
        buf = planes[plane]
        ph, pw = buf.shape
        kern = _make_kernel(ph, pw, ssx, ssy, plane, bd,
                            cd.damping + coeff_shift)
        out = kern(buf.astype(np.int32), dir_u, var_u,
                   pri.astype(np.int32), sec.astype(np.int32), filt)
        buf[:, :] = np.asarray(out)


class CdefDevice:
    """Drop-in device replacement for cdef_ref.Cdef (same apply())."""

    def __init__(self, hdr, seq, plan, bitdepth=8):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = plan.subsampling_x
        self.ssy = plan.subsampling_y

    def apply(self, planes) -> None:
        hdr = self.hdr
        cd = hdr.cdef
        if not getattr(self.seq, "enable_cdef", False):
            return
        if hdr.coded_lossless or getattr(hdr, "allow_intrabc", False):
            return
        if (max(cd.y_pri_strength) == 0 and max(cd.y_sec_strength) == 0
                and max(cd.uv_pri_strength) == 0
                and max(cd.uv_sec_strength) == 0):
            return
        plan = self.plan
        mi_rows, mi_cols = plan.mi_rows, plan.mi_cols
        # cdef idx grid: ceil(mi/16) units of 64x64
        gi = np.full(((mi_rows + 15) // 16, (mi_cols + 15) // 16), -1,
                     np.int8)
        for (r, c), idx in plan.cdef_idx.items():
            gi[r // 16, c // 16] = idx
        filt, idxm = unit_maps(plan.skip, gi, mi_rows, mi_cols)
        cdef_device_apply(planes, hdr, self.seq, self.ssx, self.ssy,
                          self.bd, filt, idxm)
