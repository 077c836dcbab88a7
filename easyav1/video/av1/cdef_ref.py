"""CDEF — constrained directional enhancement filter (spec §7.15).

Host reference implementation operating on the deblocked planes. The
filter reads from a constant copy of the input (no in-place feedback)
with out-of-frame samples set to CDEF_VERY_LARGE, which are excluded
from the min/max clamp.

Parity: easyav1 inherits this from dav1d (cdef_apply); re-derived from
the specification for the device pipeline, where the 8x8 direction
search and tap filtering become vectorised lax ops.
"""

from __future__ import annotations

from typing import List

import numpy as np

from easyav1.video.av1 import constants as C

CDEF_VERY_LARGE = 0x4000

# Cdef_Directions[dir][k] = (dy, dx) offsets for primary taps k=0,1
CDEF_DIRECTIONS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]

DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]


def find_dir(block8, coeff_shift):
    """Direction search on an 8x8 luma block (spec §7.15.2)."""
    partial = [[0] * 15 for _ in range(8)]
    for i in range(8):
        for j in range(8):
            x = (int(block8[i, j]) >> coeff_shift) - 128
            partial[0][i + j] += x
            partial[1][i + (j >> 1)] += x
            partial[2][i] += x
            partial[3][3 + i - (j >> 1)] += x
            partial[4][7 + i - j] += x
            partial[5][3 - (i >> 1) + j] += x
            partial[6][j] += x
            partial[7][(i >> 1) + j] += x
    cost = [0] * 8
    for i in range(8):
        cost[2] += partial[2][i] * partial[2][i]
        cost[6] += partial[6][i] * partial[6][i]
    cost[2] *= 105
    cost[6] *= 105
    for d in (0, 4):
        for i in range(7):
            cost[d] += partial[d][i] ** 2 * DIV_TABLE[i + 1]
            cost[d] += partial[d][14 - i] ** 2 * DIV_TABLE[i + 1]
        cost[d] += partial[d][7] ** 2 * 105
    for d in (1, 3, 5, 7):
        for i in range(5):
            cost[d] += partial[d][3 + i] ** 2
        cost[d] *= 105
        for i in range(3):
            cost[d] += ((partial[d][i] ** 2 + partial[d][10 - i] ** 2)
                        * DIV_TABLE[2 * i + 2])
    best = max(range(8), key=lambda d: cost[d])
    var = (cost[best] - cost[(best + 4) & 7]) >> 10
    return best, var


def constrain(diff, threshold, damping):
    if not threshold:
        return 0
    shift = max(0, damping - (threshold.bit_length() - 1))
    mag = min(abs(diff), max(0, threshold - (abs(diff) >> shift)))
    return -mag if diff < 0 else mag


class Cdef:
    def __init__(self, hdr, seq, plan, bitdepth=8):
        self.hdr = hdr
        self.seq = seq
        self.plan = plan
        self.bd = bitdepth
        self.ssx = plan.subsampling_x
        self.ssy = plan.subsampling_y

    def apply(self, planes: List[np.ndarray]) -> None:
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
        bd = self.bd
        coeff_shift = bd - 8
        damping = cd.damping + coeff_shift
        plan = self.plan
        skip = plan.skip
        mi_rows, mi_cols = plan.mi_rows, plan.mi_cols

        # constant padded sources per plane
        srcs = []
        for p, buf in enumerate(planes):
            src = np.full((buf.shape[0] + 4, buf.shape[1] + 4),
                          CDEF_VERY_LARGE, np.int32)
            src[2:2 + buf.shape[0], 2:2 + buf.shape[1]] = buf
            srcs.append(src)

        n_planes = len(planes)
        for r in range(0, mi_rows, 2):        # 8x8 luma steps
            for c in range(0, mi_cols, 2):
                # all-skip 8x8 -> unfiltered
                r2 = min(r + 1, mi_rows - 1)
                c2 = min(c + 1, mi_cols - 1)
                if (skip[r, c] and skip[r, c2] and skip[r2, c]
                        and skip[r2, c2]):
                    continue
                idx = plan.cdef_idx.get((r & ~15, c & ~15), -1)
                if idx == -1:
                    continue
                y = r * 4
                x = c * 4
                # direction search only runs when a primary strength is
                # in use; otherwise dir/var stay 0
                if cd.y_pri_strength[idx] or cd.uv_pri_strength[idx]:
                    dir_, var = find_dir(
                        srcs[0][y + 2:y + 10, x + 2:x + 10], coeff_shift)
                else:
                    dir_, var = 0, 0
                for plane in range(n_planes):
                    if plane == 0:
                        pri = cd.y_pri_strength[idx] << coeff_shift
                        sec = cd.y_sec_strength[idx] << coeff_shift
                        pdamp = damping
                        px, py, pw, ph = x, y, 8, 8
                        pdir = dir_ if pri else 0
                    else:
                        pri = cd.uv_pri_strength[idx] << coeff_shift
                        sec = cd.uv_sec_strength[idx] << coeff_shift
                        pdamp = damping - 1
                        px = x >> self.ssx
                        py = y >> self.ssy
                        pw = 8 >> self.ssx
                        ph = 8 >> self.ssy
                        pdir = (CDEF_UV_DIR[self.ssx][self.ssy][dir_]
                                if pri else 0)
                    if pri == 0 and sec == 0:
                        continue
                    if plane == 0:
                        # luma primary strength scales with the direction
                        # variance; zero variance disables it entirely
                        if pri:
                            if var:
                                i = (min((var >> 6).bit_length() - 1, 12)
                                     if (var >> 6) else 0)
                                adj_pri = (pri * (4 + i) + 8) >> 4
                            else:
                                adj_pri = 0
                        else:
                            adj_pri = 0
                    else:
                        adj_pri = pri
                    self._filter_block(planes[plane], srcs[plane], px, py,
                                       pw, ph, adj_pri, sec, pdamp, pdir,
                                       plane, var)

    def _filter_block(self, dst, src, x, y, w, h, pri, sec, damping, dir_,
                      plane, var):
        bd = self.bd
        # taps per spec: primary [4,2] or [3,3] by pri strength parity
        pt = [[4, 2], [3, 3]][(pri >> (bd - 8)) & 1]
        st = [2, 1]
        d0 = CDEF_DIRECTIONS[dir_]
        s1 = CDEF_DIRECTIONS[(dir_ + 2) & 7]
        s2 = CDEF_DIRECTIONS[(dir_ + 6) & 7]
        out = np.empty((h, w), np.int32)
        for i in range(h):
            for j in range(w):
                px = int(src[y + i + 2, x + j + 2])
                s = 0
                mx = px
                mn = px
                if pri:
                    for k in range(2):
                        for sgn in (1, -1):
                            dy, dx = d0[k]
                            v = int(src[y + i + 2 + sgn * dy,
                                        x + j + 2 + sgn * dx])
                            s += pt[k] * constrain(v - px, pri, damping)
                            if v != CDEF_VERY_LARGE:
                                mx = max(mx, v)
                                mn = min(mn, v)
                if sec:
                    for dirs in (s1, s2):
                        for k in range(2):
                            for sgn in (1, -1):
                                dy, dx = dirs[k]
                                v = int(src[y + i + 2 + sgn * dy,
                                            x + j + 2 + sgn * dx])
                                s += st[k] * constrain(v - px, sec, damping)
                                if v != CDEF_VERY_LARGE:
                                    mx = max(mx, v)
                                    mn = min(mn, v)
                val = px + ((8 + s - (1 if s < 0 else 0)) >> 4)
                out[i, j] = min(max(val, mn), mx)
        dst[y:y + h, x:x + w] = out


# chroma direction conversion for subsampled planes (spec
# Cdef_Uv_Dir[ss_x][ss_y][dir])
CDEF_UV_DIR = [
    [[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
    [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]],
]
