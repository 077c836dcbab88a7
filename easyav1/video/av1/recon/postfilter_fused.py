"""Fused device postfilter: loop filter + CDEF with planes resident on
device (two jit dispatches per frame, no per-pass host round-trips).

The r1 device postfilter called six separate LF jits and three CDEF
jits per frame, each round-tripping full int32 planes over the host
link (~100 MB/frame) and downloading a 15 MB partial-sums tensor for a
host direction search — ~2 s/frame at 1080p.  This module keeps the
planes on device across both filters; per frame the host uploads only
the compact parameter maps (edge-size cell grids, per-unit strengths —
~1 MB) and downloads the final planes once.

Stage 1 (one jit): vertical+horizontal deblocking for every plane,
reusing lf_jax._pass_body (bit-exact core); the horizontal pass runs
the same core on the transposed plane.
Stage 2 (one jit): CDEF — the direction search runs on device
(cdef_jax._dirs_body, exact in int32 when the 8x8 unit grid does not
overhang the mi-aligned plane; the rare overhang case falls back to
the host search between the stages), then cdef_jax._filter_body per
plane.

Parity: lf_ref.py / cdef_ref.py semantics (both verified bit-exact vs
libdav1d); mirrors the loopfilter/cdef stage split of dav1d's
lf_apply_tmpl.c / cdef_apply_tmpl.c (reference build list at
cmake/dav1d.cmake:1001-1015).
"""

from __future__ import annotations

import functools

import numpy as np

from easyav1.video.av1.lf_ref import _filter_levels, _limits
from easyav1.video.av1.recon.cdef_jax import (CDEF_VERY_LARGE,
                                                  _dirs_body,
                                                  _filter_body,
                                                  find_dirs_host,
                                                  _make_partial_kernel,
                                                  unit_maps)
from easyav1.video.av1.recon.lf_jax import _cell_maps, _pass_body


@functools.lru_cache(maxsize=None)
def _lf_stage(dims: tuple, bd: int):
    """jit: fn(planes, sizes_v, sizes_h, limits) -> planes.

    dims: ((ph, pw), ...) mi-aligned per plane.
    sizes_v[p]: [ceil(ph/4), ne_v] int32 cell grid (0/4/6/8/14)
    sizes_h[p]: [ceil(pw/4), ne_h] int32
    limits: [np, 2, 3] int32 (limit, blimit, thresh) per plane/pass.
    """
    import jax
    import jax.numpy as jnp

    np_ = len(dims)

    def fn(planes, sizes_v, sizes_h, lims_v, lims_h):
        out = []
        for p in range(np_):
            ph, pw = dims[p]
            buf = planes[p]
            body_v = _pass_body(ph, pw, bd)
            if body_v is not None:
                sm = jnp.repeat(sizes_v[p], 4, axis=0)[:ph]
                lm = jnp.repeat(lims_v[p], 4, axis=1)[:, :ph]
                buf = body_v(buf, sm, lm[0], lm[1], lm[2])
            body_h = _pass_body(pw, ph, bd)
            if body_h is not None:
                sm = jnp.repeat(sizes_h[p], 4, axis=0)[:pw]
                lm = jnp.repeat(lims_h[p], 4, axis=1)[:, :pw]
                buf = body_h(buf.T, sm, lm[0], lm[1], lm[2]).T
            out.append(buf)
        return out

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _cdef_stage(dims: tuple, bd: int, ssx: int, ssy: int, damping: int,
                dev_dirs: bool):
    """jit: fn(planes, pri_y, sec_y, pri_uv, sec_uv, filt[, dir, var])
    -> planes.  damping already includes coeff_shift."""
    import jax
    import jax.numpy as jnp

    np_ = len(dims)
    ph0, pw0 = dims[0]
    cs = bd - 8

    def fn(planes, pri_y, sec_y, pri_uv, sec_uv, filt, dir_u=None,
           var_u=None):
        uh, uw = filt.shape
        if dev_dirs:
            lpad = jnp.full((uh * 8 + 4, uw * 8 + 4), CDEF_VERY_LARGE,
                            jnp.int32)
            lpad = lpad.at[2:2 + ph0, 2:2 + pw0].set(planes[0])
            dirs, var = _dirs_body(uh, uw, cs)(lpad)
        else:
            dirs, var = dir_u, var_u
        out = []
        for p in range(np_):
            ph, pw = dims[p]
            body = _filter_body(ph, pw, ssx, ssy, min(p, 1), bd,
                                damping)
            pri = pri_y if p == 0 else pri_uv
            sec = sec_y if p == 0 else sec_uv
            out.append(body(planes[p], dirs, var, pri, sec, filt))
        return out

    return jax.jit(fn)


def _lf_size_maps(hdr, bd, dims, num_planes, grids_for):
    """Host: per-plane (size_v, size_h) cell grids plus PER-EDGE
    (limit, blimit, thresh) maps (levels vary per block on inter
    frames via ref/mode deltas, segments and delta_lf; the C decoder
    exports the resolved per-cell level grids)."""
    sizes_v, sizes_h = [], []
    lims_v, lims_h = [], []
    lf_on = not (hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0
                 and hdr.lf.level[2] == 0 and hdr.lf.level[3] == 0) \
        and not getattr(hdr, "allow_intrabc", False)
    # 64-entry (limit, blimit, thresh) LUTs over the level
    luts = np.zeros((3, 64), np.int32)
    for lv in range(1, 64):
        luts[:, lv] = _limits(lv, hdr.lf.sharpness, bd)
    for p in range(num_planes):
        ph, pw = dims[p]
        g = grids_for(p, (ph, pw)) if lf_on else None
        plane_on = lf_on
        if p == 0 and hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0:
            plane_on = False
        if p == 1 and hdr.lf.level[2] == 0:
            plane_on = False
        if p == 2 and hdr.lf.level[3] == 0:
            plane_on = False
        for pass_ in (0, 1):
            vertical = pass_ == 0
            ne = (g["gw"] - 1 if vertical else g["gh"] - 1) if g else 0
            rows = (ph + 3) // 4 if vertical else (pw + 3) // 4
            if not plane_on or ne <= 0 or g is None:
                size = np.zeros((rows, max(ne, 0)), np.int32)
                lim = np.zeros((3, rows, max(ne, 0)), np.int32)
            else:
                size = _cell_maps(g, p, vertical)
                # per-edge level: current cell's, else the neighbour's
                lv = g["lvl0"] if pass_ == 0 else g["lvl1"]
                if vertical:
                    lvl_e = np.where(lv[:, 1:] > 0, lv[:, 1:],
                                     lv[:, :-1])
                else:
                    lvl_e = np.where(lv[1:, :] > 0, lv[1:, :],
                                     lv[:-1, :]).T
                size = np.where(lvl_e > 0, size, 0)
                lim = luts[:, lvl_e]
                # visible-frame crop (parity: lf_ref._filter_pass)
                ss_x = 1 if g["gw"] < hdr.mi_cols else 0
                ss_y = 1 if g["gh"] < hdr.mi_rows else 0
                h4u = (hdr.frame_height + 3) >> 2
                w4u = (hdr.upscaled_width + 3) >> 2
                vis_h = min(ph, ((h4u + ss_y) >> ss_y) << 2)
                vis_w = min(pw, ((w4u + ss_x) >> ss_x) << 2)
                if vertical:
                    size[(vis_h + 3) >> 2:, :] = 0
                    ecap = (vis_w >> 2) - 1      # edge e at x=4(e+1)
                    size[:, max(ecap, 0):] = 0
                else:
                    size[(vis_w + 3) >> 2:, :] = 0
                    ecap = (vis_h >> 2) - 1
                    size[:, max(ecap, 0):] = 0
            (sizes_v if vertical else sizes_h).append(size)
            (lims_v if vertical else lims_h).append(lim)
    return sizes_v, sizes_h, lims_v, lims_h


def postfilter_frame(planes, hdr, seq, grids_for, skip_grid,
                     cdef_idx_grid, want_deblocked=False):
    """Apply LF + CDEF on device.  `planes` are mi-aligned int32
    arrays (numpy or device); returns device arrays, or a (devices,
    deblocked) pair when want_deblocked (the post-LF pre-CDEF planes,
    needed by the loop-restoration stage's stripe context).

    grids_for(plane, shape) -> lf_ref-style grids dict.
    skip_grid / cdef_idx_grid: mi skip grid + per-64x64 cdef indices.
    """
    import jax.numpy as jnp

    bd = seq.color.bitdepth
    num_planes = len(planes)
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes)
    dev = [jnp.asarray(np.ascontiguousarray(p, np.int32))
           if isinstance(p, np.ndarray) else p for p in planes]

    # --- loop filter ---
    lf_on = not (hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0
                 and hdr.lf.level[2] == 0 and hdr.lf.level[3] == 0) \
        and not getattr(hdr, "allow_intrabc", False)
    if lf_on:
        sizes_v, sizes_h, lims_v, lims_h = _lf_size_maps(
            hdr, bd, dims, num_planes, grids_for)
        dev = _lf_stage(dims, bd)(
            dev, [jnp.asarray(s) for s in sizes_v],
            [jnp.asarray(s) for s in sizes_h],
            [jnp.asarray(s) for s in lims_v],
            [jnp.asarray(s) for s in lims_h])
    deblocked = list(dev) if want_deblocked else None

    # --- cdef ---
    cd = hdr.cdef
    cdef_on = (getattr(seq, "enable_cdef", False) and cd is not None
               and not hdr.coded_lossless
               and not getattr(hdr, "allow_intrabc", False)
               and (max(cd.y_pri_strength, default=0)
                    or max(cd.y_sec_strength, default=0)
                    or max(cd.uv_pri_strength, default=0)
                    or max(cd.uv_sec_strength, default=0)))
    if cdef_on:
        cs = bd - 8
        filt, idxm = unit_maps(skip_grid, cdef_idx_grid, hdr.mi_rows,
                               hdr.mi_cols)
        uh, uw = filt.shape
        safe = np.where(idxm >= 0, idxm, 0)
        sel = filt != 0
        y_pri = np.array(cd.y_pri_strength, np.int32)
        y_sec = np.array(cd.y_sec_strength, np.int32)
        # monochrome streams code no uv strengths; zeros keep the
        # shared uv-parameter plumbing shape-safe (planes 1/2 absent)
        nz = np.zeros(8, np.int32)    # indexed by cdef_idx (< 8)
        uv_pri = (np.array(cd.uv_pri_strength, np.int32)
                  if len(cd.uv_pri_strength) else nz)
        uv_sec = (np.array(cd.uv_sec_strength, np.int32)
                  if len(cd.uv_sec_strength) else nz)
        pri_y = (np.where(sel, y_pri[safe], 0) << cs).astype(np.int32)
        sec_y = (np.where(sel, y_sec[safe], 0) << cs).astype(np.int32)
        pri_uv = (np.where(sel, uv_pri[safe], 0) << cs).astype(np.int32)
        sec_uv = (np.where(sel, uv_sec[safe], 0) << cs).astype(np.int32)
        ph0, pw0 = dims[0]
        dev_dirs = (uh * 8 <= ph0) and (uw * 8 <= pw0)
        stage = _cdef_stage(dims, bd, seq.color.subsampling_x,
                            seq.color.subsampling_y, cd.damping + cs,
                            dev_dirs)
        args = [dev, jnp.asarray(pri_y), jnp.asarray(sec_y),
                jnp.asarray(pri_uv), jnp.asarray(sec_uv),
                jnp.asarray(filt.astype(np.int32))]
        if not dev_dirs:
            # overhang: host direction search (int32 bound broken by
            # CDEF_VERY_LARGE entering the partials)
            lpad = np.full((uh * 8 + 4, uw * 8 + 4), CDEF_VERY_LARGE,
                           np.int32)
            lpad[2:2 + ph0, 2:2 + pw0] = np.asarray(dev[0])
            partials = np.asarray(
                _make_partial_kernel(uh, uw, cs)(lpad))
            dir_u, var_u = find_dirs_host(partials)
            args += [jnp.asarray(dir_u), jnp.asarray(var_u)]
        dev = stage(*args)
    if want_deblocked:
        return dev, deblocked
    return dev
