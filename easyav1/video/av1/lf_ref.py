"""AV1 deblocking (loop) filter — host reference (spec §7.14).

Bit-exact numpy implementation operating on the reconstructed planes.
Edge order per spec: for each plane, ALL vertical edges first, then all
horizontal edges (the horizontal pass reads vertically-filtered pixels).

Parity reference: easyav1 delegates this to dav1d's lf_apply
(reference: src/decode.c loopfilter dispatch); here it is re-derived
from the specification for the device recon path.  The device port
(recon/lf_jax.py) vectorises the per-edge mask/filter math across whole
edge columns; this module is the conformance oracle for it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.tile import FramePlan

MAX_LOOP_FILTER = 63


# mode_lf_lut (libaom): GLOBALMV / GLOBAL_GLOBALMV use mode_deltas[0],
# every other inter mode uses mode_deltas[1]; intra always deltas-free
_MODE_DELTA_IDX0 = (C.GLOBALMV, C.GLOBAL_GLOBALMV)


def _filter_levels(hdr, plane: int, pass_: int, blk=None) -> int:
    """Per-block filter level (spec get_filter_level); segmentation and
    delta_lf are not yet wired (fixtures do not use them)."""
    lf = hdr.lf
    if plane == 0:
        base = lf.level[pass_]
    elif plane == 1:
        base = lf.level[2]
    else:
        base = lf.level[3]
    lvl = base
    if getattr(lf, "delta_enabled", False):
        scale = 1 << (base >> 5)
        if blk is None or not blk.is_inter:
            lvl += lf.ref_deltas[0] * scale
        else:
            midx = 0 if blk.inter_mode in _MODE_DELTA_IDX0 else 1
            lvl += (lf.ref_deltas[blk.ref_frame[0]]
                    + lf.mode_deltas[midx]) * scale
        lvl = max(0, min(MAX_LOOP_FILTER, lvl))
    return lvl


def _limits(lvl: int, sharpness: int, bitdepth: int):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = min(max(1, lvl >> shift), 9 - sharpness)
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    scale = 1 << (bitdepth - 8)
    return limit * scale, blimit * scale, thresh * scale


def _filter_line(buf, idx, size: int, limit: int, blimit: int, thresh: int,
                 bitdepth: int) -> None:
    """Filter one 1-D line of samples across an edge.  `idx(k)` maps the
    tap offset k (…, -2=p1, -1=p0, 0=q0, 1=q1, …) to a buffer index."""
    F = 1 << (bitdepth - 8)
    p = lambda k: int(buf[idx(-1 - k)])
    q = lambda k: int(buf[idx(k)])

    p0, p1 = p(0), p(1)
    q0, q1 = q(0), q(1)
    mask = (abs(p1 - p0) <= limit and abs(q1 - q0) <= limit and
            abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= blimit)
    if size >= 6:
        p2, q2 = p(2), q(2)
        mask = mask and abs(p2 - p1) <= limit and abs(q2 - q1) <= limit
    if size >= 8:
        p3, q3 = p(3), q(3)
        mask = mask and abs(p3 - p2) <= limit and abs(q3 - q2) <= limit
    if not mask:
        return

    flat = False
    if size >= 6:
        flat = (abs(p1 - p0) <= F and abs(q1 - q0) <= F and
                abs(p2 - p0) <= F and abs(q2 - q0) <= F)
    if size >= 8:
        flat = flat and abs(p3 - p0) <= F and abs(q3 - q0) <= F

    if size == 14 and flat:
        flat2 = (abs(p(4) - p0) <= F and abs(q(4) - q0) <= F and
                 abs(p(5) - p0) <= F and abs(q(5) - q0) <= F and
                 abs(p(6) - p0) <= F and abs(q(6) - q0) <= F)
        if flat2:
            pv = [p(k) for k in range(7)]
            qv = [q(k) for k in range(7)]
            # 13-tap window with tripled centre run (weights sum to 16)
            o = {}
            o[-6] = (pv[6] * 7 + pv[5] * 2 + pv[4] * 2 + pv[3] + pv[2]
                     + pv[1] + pv[0] + qv[0] + 8) >> 4
            o[-5] = (pv[6] * 5 + pv[5] * 2 + pv[4] * 2 + pv[3] * 2 + pv[2]
                     + pv[1] + pv[0] + qv[0] + qv[1] + 8) >> 4
            o[-4] = (pv[6] * 4 + pv[5] + pv[4] * 2 + pv[3] * 2 + pv[2] * 2
                     + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + 8) >> 4
            o[-3] = (pv[6] * 3 + pv[5] + pv[4] + pv[3] * 2 + pv[2] * 2
                     + pv[1] * 2 + pv[0] + qv[0] + qv[1] + qv[2] + qv[3]
                     + 8) >> 4
            o[-2] = (pv[6] * 2 + pv[5] + pv[4] + pv[3] + pv[2] * 2
                     + pv[1] * 2 + pv[0] * 2 + qv[0] + qv[1] + qv[2] + qv[3]
                     + qv[4] + 8) >> 4
            o[-1] = (pv[6] + pv[5] + pv[4] + pv[3] + pv[2] + pv[1] * 2
                     + pv[0] * 2 + qv[0] * 2 + qv[1] + qv[2] + qv[3] + qv[4]
                     + qv[5] + 8) >> 4
            o[0] = (pv[5] + pv[4] + pv[3] + pv[2] + pv[1] + pv[0] * 2
                    + qv[0] * 2 + qv[1] * 2 + qv[2] + qv[3] + qv[4] + qv[5]
                    + qv[6] + 8) >> 4
            o[1] = (pv[4] + pv[3] + pv[2] + pv[1] + pv[0] + qv[0] * 2
                    + qv[1] * 2 + qv[2] * 2 + qv[3] + qv[4] + qv[5]
                    + qv[6] * 2 + 8) >> 4
            o[2] = (pv[3] + pv[2] + pv[1] + pv[0] + qv[0] + qv[1] * 2
                    + qv[2] * 2 + qv[3] * 2 + qv[4] + qv[5] + qv[6] * 3
                    + 8) >> 4
            o[3] = (pv[2] + pv[1] + pv[0] + qv[0] + qv[1] + qv[2] * 2
                    + qv[3] * 2 + qv[4] * 2 + qv[5] + qv[6] * 4 + 8) >> 4
            o[4] = (pv[1] + pv[0] + qv[0] + qv[1] + qv[2] + qv[3] * 2
                    + qv[4] * 2 + qv[5] * 2 + qv[6] * 5 + 8) >> 4
            o[5] = (pv[0] + qv[0] + qv[1] + qv[2] + qv[3] + qv[4] * 2
                    + qv[5] * 2 + qv[6] * 7 + 8) >> 4
            for k, v in o.items():
                buf[idx(k)] = v
            return
        # fall through to filter8 on flat-but-not-flat2

    if size >= 8 and flat:
        o = {}
        o[-3] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3
        o[-2] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3
        o[-1] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3
        o[0] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3
        o[1] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3
        o[2] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3
        for k, v in o.items():
            buf[idx(k)] = v
        return
    if size == 6 and flat:
        o = {}
        o[-2] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3
        o[-1] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3
        o[0] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3
        o[1] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3
        for k, v in o.items():
            buf[idx(k)] = v
        return

    # narrow filter4 (8-bit signed arithmetic scaled for bitdepth)
    mx = (1 << bitdepth) - 1
    half = 1 << (bitdepth - 1)
    clamp = lambda x: max(-half, min(half - 1, x))
    ps1, ps0 = p1 - half, p0 - half
    qs0, qs1 = q0 - half, q1 - half
    hev = abs(p1 - p0) > thresh or abs(q1 - q0) > thresh
    f = clamp(ps1 - qs1) if hev else 0
    f = clamp(f + 3 * (qs0 - ps0))
    f1 = clamp(f + 4) >> 3
    f2 = clamp(f + 3) >> 3
    oq0 = max(0, min(mx, clamp(qs0 - f1) + half))
    op0 = max(0, min(mx, clamp(ps0 + f2) + half))
    buf[idx(0)] = oq0
    buf[idx(-1)] = op0
    if not hev:
        f3 = (f1 + 1) >> 1
        buf[idx(1)] = max(0, min(mx, clamp(qs1 - f3) + half))
        buf[idx(-2)] = max(0, min(mx, clamp(ps1 + f3) + half))


class LoopFilter:
    """Builds per-plane tx/level/skip grids from the FramePlan and applies
    the deblocking filter in place on [y, u, v] int arrays."""

    def __init__(self, hdr, seq, plan: FramePlan, bitdepth: int = 8):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = plan.subsampling_x
        self.ssy = plan.subsampling_y

    def apply(self, planes: List[np.ndarray]) -> None:
        hdr = self.hdr
        if hdr.lf.level[0] == 0 and hdr.lf.level[1] == 0 and \
                hdr.lf.level[2] == 0 and hdr.lf.level[3] == 0:
            return
        if getattr(hdr, "allow_intrabc", False):
            return
        n_planes = len(planes)
        for plane in range(n_planes):
            # spec 7.14.1: luma is skipped only when BOTH level[0] and
            # level[1] are zero — a zero base level still filters edges
            # whose per-block delta-adjusted level is nonzero (e.g. the
            # intra ref_delta of +1)
            if plane == 0 and hdr.lf.level[0] == 0 and \
                    hdr.lf.level[1] == 0:
                continue
            if plane == 1 and hdr.lf.level[2] == 0:
                continue
            if plane == 2 and hdr.lf.level[3] == 0:
                continue
            grids = self._build_grids(plane, planes[plane].shape)
            for pass_ in (0, 1):
                self._filter_pass(planes[plane], plane, pass_, grids)

    # -- grids -------------------------------------------------------------

    def _build_grids(self, plane: int, shape) -> dict:
        """Per-4px-cell grids in plane coordinates: tx w4/h4, block edge
        flags, skip, and filter level."""
        h, w = shape
        gw = (w + 3) >> 2
        gh = (h + 3) >> 2
        txw = np.ones((gh, gw), np.int32)
        txh = np.ones((gh, gw), np.int32)
        skip = np.zeros((gh, gw), np.int32)
        lvl0 = np.zeros((gh, gw), np.int32)
        lvl1 = np.zeros((gh, gw), np.int32)
        edge_left = np.zeros((gh, gw), bool)
        edge_top = np.zeros((gh, gw), bool)
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        for b in self.plan.blocks:
            if plane and not b.has_chroma:
                continue
            # plane-space block rect (4px units)
            bx = (b.c >> ssx)
            by = (b.r >> ssy)
            bw = max(1, C.BLOCK_W4[b.bsize] >> ssx)
            bh = max(1, C.BLOCK_H4[b.bsize] >> ssy)
            x1 = min(bx + bw, gw)
            y1 = min(by + bh, gh)
            if bx >= gw or by >= gh:
                continue
            tx = b.tx_size if plane == 0 else b.uv_tx_size
            txw[by:y1, bx:x1] = T.TX_W4[tx]
            txh[by:y1, bx:x1] = T.TX_H4[tx]
            skip[by:y1, bx:x1] = 1 if b.skip else 0
            lvl0[by:y1, bx:x1] = _filter_levels(self.hdr, plane, 0, b)
            lvl1[by:y1, bx:x1] = _filter_levels(self.hdr, plane, 1, b)
            edge_left[by:y1, bx] = True
            edge_top[by, bx:x1] = True
        # overlay actual tx tree (covers tx splitting inside coded blocks)
        for (p, x, y, tx_size) in self.plan.lf_txs:
            if p != plane:
                continue
            cx, cy = x >> 2, y >> 2
            tw4, th4 = T.TX_W4[tx_size], T.TX_H4[tx_size]
            x1 = min(cx + tw4, gw)
            y1 = min(cy + th4, gh)
            if cx >= gw or cy >= gh:
                continue
            txw[cy:y1, cx:x1] = tw4
            txh[cy:y1, cx:x1] = th4
        return {"txw": txw, "txh": txh, "skip": skip,
                "lvl0": lvl0, "lvl1": lvl1,
                "edge_left": edge_left, "edge_top": edge_top,
                "gw": gw, "gh": gh}

    # -- edge pass ---------------------------------------------------------

    def _filter_pass(self, buf: np.ndarray, plane: int, pass_: int, g):
        hdr = self.hdr
        bd = self.bd
        lvls = g["lvl0"] if pass_ == 0 else g["lvl1"]
        # deblocking covers only the VISIBLE frame in 4px units (dav1d
        # h4/w4 = ceil(cropped/4), chroma derived from the luma units);
        # the mi-aligned extension stays unfiltered -- CDEF later reads
        # it as plain recon samples
        ssx = self.ssx if plane else 0
        ssy = self.ssy if plane else 0
        h4u = (self.plan.height + 3) >> 2
        w4u = (self.plan.width + 3) >> 2
        h = min(buf.shape[0], (((h4u + ssy) >> ssy) << 2))
        w = min(buf.shape[1], (((w4u + ssx) >> ssx) << 2))
        gw, gh = g["gw"], g["gh"]
        txw, txh = g["txw"], g["txh"]
        skip = g["skip"]
        limit_cache = {}

        def limits_for(lvl):
            if lvl not in limit_cache:
                limit_cache[lvl] = _limits(lvl, hdr.lf.sharpness, bd)
            return limit_cache[lvl]
        if pass_ == 0:  # vertical edges, scan columns
            for cy in range(gh):
                for cx in range(1, gw):
                    x = cx * 4
                    if x >= w:
                        break
                    # edge only where the current tx starts at this column
                    if (x >> 2) % txw[cy, cx] != 0:
                        continue
                    is_block_edge = g["edge_left"][cy, cx]
                    if not is_block_edge and skip[cy, cx] and skip[cy, cx - 1]:
                        continue
                    lvl = int(lvls[cy, cx]) or int(lvls[cy, cx - 1])
                    if lvl == 0:
                        continue
                    limit, blimit, thresh = limits_for(lvl)
                    min_tx = min(txw[cy, cx], txw[cy, cx - 1]) * 4
                    if plane == 0:
                        size = 14 if min_tx >= 16 else (8 if min_tx >= 8
                                                        else 4)
                    else:
                        size = 6 if min_tx >= 8 else 4
                    y0 = cy * 4
                    for dy in range(min(4, h - y0)):
                        row = buf[y0 + dy]
                        _filter_line(row, lambda k, x=x: x + k, size,
                                     limit, blimit, thresh, bd)
        else:  # horizontal edges
            for cy in range(1, gh):
                y = cy * 4
                if y >= h:
                    break
                for cx in range(gw):
                    if (y >> 2) % txh[cy, cx] != 0:
                        continue
                    is_block_edge = g["edge_top"][cy, cx]
                    if not is_block_edge and skip[cy, cx] and skip[cy - 1, cx]:
                        continue
                    lvl = int(lvls[cy, cx]) or int(lvls[cy - 1, cx])
                    if lvl == 0:
                        continue
                    limit, blimit, thresh = limits_for(lvl)
                    min_tx = min(txh[cy, cx], txh[cy - 1, cx]) * 4
                    if plane == 0:
                        size = 14 if min_tx >= 16 else (8 if min_tx >= 8
                                                        else 4)
                    else:
                        size = 6 if min_tx >= 8 else 4
                    x0 = cx * 4
                    for dx in range(min(4, w - x0)):
                        col = buf[:, x0 + dx]
                        _filter_line(col, lambda k, y=y: y + k, size,
                                     limit, blimit, thresh, bd)
