"""Minimal AV1 encoder: sequence/frame header writers + tile encoder.

Primary purpose: conformance instrumentation — streams synthesized here
are decoded by libdav1d in tests, pinning the exact syntax/CDF usage of
the tile decoder (tile.py) element by element. It is also the seed of a
real encode path (a capability the reference library lacks entirely).

Scope grows with the decoder: intra keyframes, single tile.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.cdf import CdfContext
from easyav1.video.av1.msac_enc import MsacEncoder
from easyav1.video.av1.tile import (mi_wlog2, mi_hlog2, _PART_ABOVE,
                                        _PART_LEFT, partition_subsize)


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def f(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def byte_align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        self.byte_align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def obu(obu_type: int, payload: bytes) -> bytes:
    header = bytes([(obu_type << 3) | 0x02])  # has_size_field
    return header + leb128(len(payload)) + payload


def write_sequence_header(w: int, h: int, base_q_unused: int = 0,
                          edge_filter: bool = False,
                          cdef=None, restoration: bool = False,
                          film_grain: bool = False,
                          superres: bool = False) -> bytes:
    """Minimal profile-0 8-bit 4:2:0 sequence header,
    reduced_still_picture_header form (spec §5.5)."""
    bw = BitWriter()
    bw.f(0, 3)    # seq_profile
    bw.f(1, 1)    # still_picture
    bw.f(1, 1)    # reduced_still_picture_header
    bw.f(0, 5)    # seq_level_idx[0]
    bw.f(15, 4)   # frame_width_bits_minus_1
    bw.f(15, 4)   # frame_height_bits_minus_1
    bw.f(w - 1, 16)
    bw.f(h - 1, 16)
    bw.f(0, 1)    # use_128x128_superblock
    bw.f(0, 1)    # enable_filter_intra
    bw.f(int(edge_filter), 1)    # enable_intra_edge_filter
    bw.f(int(superres), 1)    # enable_superres
    bw.f(1 if cdef else 0, 1)    # enable_cdef
    bw.f(1 if restoration else 0, 1)    # enable_restoration
    # color_config
    bw.f(0, 1)    # high_bitdepth
    bw.f(0, 1)    # mono_chrome
    bw.f(0, 1)    # color_description_present
    bw.f(0, 1)    # color_range
    bw.f(0, 2)    # chroma_sample_position
    bw.f(0, 1)    # separate_uv_delta_q
    bw.f(1 if film_grain else 0, 1)    # film_grain_params_present
    bw.f(1, 1)    # trailing bit
    return bw.bytes()


def write_frame_header_bits(bw: BitWriter, base_q_idx: int,
                            disable_cdf_update: bool = True,
                            tx_mode_select: bool = False,
                            lf_levels=(0, 0), cdef=None,
                            w: int = 64, h: int = 64, lr=None,
                            fg=None, intrabc: bool = False,
                            screen: bool = False,
                            superres_seq: bool = False,
                            superres_denom=None) -> None:
    """Frame header for the reduced_still_picture sequence (KEY, shown)."""
    allow_screen = intrabc or screen
    bw.f(int(disable_cdf_update), 1)  # disable_cdf_update
    bw.f(int(allow_screen), 1)  # allow_screen_content_tools (force==SELECT)
    if allow_screen:
        bw.f(1, 1)        # force_integer_mv (seq force == SELECT)
    # frame_size_override absent (reduced); no order hint; primary ref none
    # refresh implicitly 0xFF; frame size from seq max
    if superres_seq:      # superres_params (spec 5.9.8)
        if superres_denom:
            bw.f(1, 1)                      # use_superres
            bw.f(superres_denom - 9, 3)     # denom - SUPERRES_DENOM_MIN
        else:
            bw.f(0, 1)
    bw.f(0, 1)            # render_and_frame_size_different
    if allow_screen:
        bw.f(int(intrabc), 1)  # allow_intrabc
    # tile info (uniform, single tile; a zero increment bit per dimension
    # whenever max_log2_tile_cols/rows > 0 — spec 5.9.15 tile_info)
    bw.f(1, 1)            # uniform_tile_spacing
    sb_cols = (w + 63) >> 6
    sb_rows = (h + 63) >> 6
    if sb_cols > 1:
        bw.f(0, 1)        # increment_tile_cols_log2 stop
    if sb_rows > 1:
        bw.f(0, 1)        # increment_tile_rows_log2 stop
    # quantization_params
    bw.f(base_q_idx, 8)
    bw.f(0, 1)            # delta_q_y_dc coded flag
    bw.f(0, 1)            # delta_q_u_dc
    bw.f(0, 1)            # delta_q_u_ac
    bw.f(0, 1)            # using_qmatrix
    # segmentation
    bw.f(0, 1)            # segmentation_enabled
    # delta_q_params (base_q > 0)
    if base_q_idx:
        bw.f(0, 1)        # delta_q_present
    lossless = base_q_idx == 0
    # loop filter (skipped entirely when coded_lossless or intrabc)
    if not lossless and not intrabc:
        bw.f(lf_levels[0], 6)  # level[0]
        bw.f(lf_levels[1], 6)  # level[1]
        if lf_levels[0] or lf_levels[1]:
            bw.f(lf_levels[2] if len(lf_levels) > 2 else 0, 6)
            bw.f(lf_levels[3] if len(lf_levels) > 3 else 0, 6)
        bw.f(0, 3)        # sharpness
        bw.f(0, 1)        # delta_enabled
    if cdef is not None:
        # cdef params: damping-3, bits, then per-idx strengths y/uv
        damping, strengths = cdef[0], cdef[1]
        bits = {1: 0, 2: 1, 4: 2, 8: 3}[len(strengths)]
        bw.f(damping - 3, 2)
        bw.f(bits, 2)
        for (ypri, ysec, upri, usec) in strengths:
            bw.f(ypri, 4)
            bw.f(3 if ysec == 4 else ysec, 2)
            bw.f(upri, 4)
            bw.f(3 if usec == 4 else usec, 2)
    if lr is not None:
        # lr_params: per-plane frame restoration type (coded order NONE,
        # SWITCHABLE, WIENER, SGRPROJ == C.RESTORE_* values), then unit
        # size bits (shift 0 -> 256>>2 = 64px luma units)
        for p_ in range(3):
            bw.f(lr[p_], 2)
        if any(lr):
            bw.f(0, 1)    # lr_unit_shift = 0
        if lr[1] or lr[2]:
            bw.f(0, 1)    # lr_uv_shift = 0
    if not lossless:
        bw.f(int(tx_mode_select), 1)  # tx_mode_select
    # reference_select / skip_mode / warped skipped (intra)
    bw.f(0, 1)            # reduced_tx_set
    # global motion: none (intra)
    if fg is not None:
        # film_grain_params (spec 5.9.30); fg is a dict of fields
        bw.f(1, 1)                       # apply_grain
        bw.f(fg["seed"], 16)
        # update_grain not coded on KEY frames
        ypts = fg.get("y_points", [])
        bw.f(len(ypts), 4)
        for v, sc in ypts:
            bw.f(v, 8)
            bw.f(sc, 8)
        csl = fg.get("chroma_scaling_from_luma", False)
        bw.f(int(csl), 1)
        cbpts = fg.get("cb_points", [])
        crpts = fg.get("cr_points", [])
        if not (csl or (len(ypts) == 0 and True)):
            pass
        # 4:2:0, so points are coded unless csl or (420 and ny==0)
        if not csl and not (len(ypts) == 0):
            bw.f(len(cbpts), 4)
            for v, sc in cbpts:
                bw.f(v, 8)
                bw.f(sc, 8)
            bw.f(len(crpts), 4)
            for v, sc in crpts:
                bw.f(v, 8)
                bw.f(sc, 8)
        elif not csl and len(ypts) == 0:
            cbpts = []
            crpts = []
        bw.f(fg.get("scaling_shift", 8) - 8, 2)
        lag = fg.get("lag", 0)
        bw.f(lag, 2)
        npos = 2 * lag * (lag + 1)
        ar_y = fg.get("ar_y", [0] * npos)
        if ypts:
            for cst in ar_y:
                bw.f(cst + 128, 8)
        if csl or cbpts:
            for cst in fg.get("ar_cb", [0] * (npos + (1 if ypts else 0))):
                bw.f(cst + 128, 8)
        if csl or crpts:
            for cst in fg.get("ar_cr", [0] * (npos + (1 if ypts else 0))):
                bw.f(cst + 128, 8)
        bw.f(fg.get("ar_coeff_shift", 6) - 6, 2)
        bw.f(fg.get("grain_scale_shift", 0), 2)
        if cbpts:
            bw.f(fg.get("cb_mult", 128), 8)
            bw.f(fg.get("cb_luma_mult", 192), 8)
            bw.f(fg.get("cb_offset", 256), 9)
        if crpts:
            bw.f(fg.get("cr_mult", 128), 8)
            bw.f(fg.get("cr_luma_mult", 192), 8)
            bw.f(fg.get("cr_offset", 256), 9)
        bw.f(int(fg.get("overlap", False)), 1)
        bw.f(int(fg.get("clip_restricted", False)), 1)


@dataclasses.dataclass
class EncBlock:
    r: int
    c: int
    bsize: int
    y_mode: int = C.DC_PRED
    uv_mode: int = C.DC_PRED
    skip: bool = True
    tx_depth: int = 0
    # luma coefficient levels+signs in scan order (level, sign) per txblock,
    # one list per luma tx block in raster order; empty = all_zero
    luma_coeffs: Optional[List[List[Tuple[int, int]]]] = None
    chroma_coeffs: Optional[List[List[Tuple[int, int]]]] = None
    # CfL: uv_mode becomes UV_CFL_PRED with these signed alphas (-16..16)
    cfl: Optional[Tuple[int, int]] = None
    angle_y: int = 0
    angle_uv: int = 0
    # palette: (colors ascending, (h, w) index map) per plane group
    palette_y: Optional[tuple] = None
    tx_type: int = C.DCT_DCT   # luma tx type (must be legal for the set)
    # intrabc displacement vector (row, col) in 1/8-pel (full-pel
    # multiples of 8); None = regular intra block
    dv: Optional[Tuple[int, int]] = None


class SimpleTileEncoder:
    """Encodes a user-specified block layout (mirror of TileDecoder's
    syntax for the supported subset: TX_MODE_LARGEST, no angle deltas,
    no palette/filter-intra/cfl; single tile)."""

    def __init__(self, w: int, h: int, base_q_idx: int,
                 adapt: bool = False, tx_mode_select: bool = False,
                 cdef_bits: Optional[int] = None, cdef_vals=None,
                 lr_types=None, lr_units=None):
        self.adapt = adapt
        self.lossless = base_q_idx == 0
        # loop restoration: lr_types = per-plane C.RESTORE_* frame type,
        # lr_units = {(plane, urow, ucol): ("wiener", [[t0..t2]x2]) |
        #             ("sgr", set, xqd0, xqd1) | None}
        self.lr_types = lr_types
        self.lr_units = lr_units or {}
        self.lr_ref_wiener = [[[3, -7, 15] for _ in range(2)]
                              for _ in range(3)]
        self.lr_ref_sgr = [[-32, 31] for _ in range(3)]
        self.tx_mode_select = tx_mode_select
        self.cdef_bits = cdef_bits
        self.cdef_vals = cdef_vals or {}
        self.cdef_done = {}
        self.w = w
        self.h = h
        self.mi_cols = 2 * ((w + 7) >> 3)
        self.mi_rows = 2 * ((h + 7) >> 3)
        self.base_q = base_q_idx
        self.cdf = CdfContext.default(base_q_idx).t
        self.enc = MsacEncoder()
        self.a_part = np.zeros(self.mi_cols, np.int32)
        self.l_part = np.zeros(self.mi_rows, np.int32)
        self.a_mode = np.full(self.mi_cols, C.DC_PRED, np.int32)
        self.l_mode = np.full(self.mi_rows, C.DC_PRED, np.int32)
        self.a_skip = np.zeros(self.mi_cols, np.int32)
        self.l_skip = np.zeros(self.mi_rows, np.int32)
        self.a_txw = np.zeros(self.mi_cols, np.int32)
        self.l_txh = np.zeros(self.mi_rows, np.int32)
        self.a_lvl = [np.zeros(self.mi_cols, np.int32) for _ in range(3)]
        self.l_lvl = [np.zeros(self.mi_rows, np.int32) for _ in range(3)]
        self.a_sign = [np.zeros(self.mi_cols, np.int32) for _ in range(3)]
        self.l_sign = [np.zeros(self.mi_rows, np.int32) for _ in range(3)]
        # palette state (mirrors TileDecoder a_pal/l_pal)
        self.a_pal_sz = [np.zeros(self.mi_cols, np.int32) for _ in range(2)]
        self.l_pal_sz = [np.zeros(self.mi_rows, np.int32) for _ in range(2)]
        self.a_pal = [np.zeros((self.mi_cols, 8), np.int32)
                      for _ in range(3)]
        self.l_pal = [np.zeros((self.mi_rows, 8), np.int32)
                      for _ in range(3)]

    def _emit_deltas_hook(self, blk):
        """Replay point for per-superblock delta_q/lf symbols (used by
        the plan re-encoder; synth streams never code deltas)."""

    def _sym(self, cdf_row, symbol, nsym=None):
        if nsym is not None and len(cdf_row) != nsym + 1:
            sub = cdf_row[:nsym - 1] + [0, cdf_row[-1]]
            self.enc.encode_symbol(sub, symbol)
            self._update(sub, symbol)
            cdf_row[:nsym - 1] = sub[:nsym - 1]
            cdf_row[-1] = sub[-1]
        else:
            self.enc.encode_symbol(cdf_row, symbol)
            self._update(cdf_row, symbol)

    def _emit_palette_colors(self, plane, r, c, colors):
        """Mirror of TileDecoder._read_palette_colors: cache bools for
        colors present in the merged above/left cache, then ascending
        delta coding for the rest."""
        enc = self.enc
        bd = 8
        n = len(colors)
        l_sz = int(self.l_pal_sz[plane][r])
        a_sz = int(self.a_pal_sz[plane][c]) if (r & 15) else 0
        lcol = self.l_pal[plane][r]
        acol = self.a_pal[plane][c]
        cache = []
        li = ai = 0
        while li < l_sz and ai < a_sz:
            lv = int(lcol[li])
            av = int(acol[ai])
            if lv < av:
                if not cache or cache[-1] != lv:
                    cache.append(lv)
                li += 1
            else:
                if av == lv:
                    li += 1
                if not cache or cache[-1] != av:
                    cache.append(av)
                ai += 1
        while li < l_sz:
            lv = int(lcol[li])
            li += 1
            if not cache or cache[-1] != lv:
                cache.append(lv)
        while ai < a_sz:
            av = int(acol[ai])
            ai += 1
            if not cache or cache[-1] != av:
                cache.append(av)
        remaining = set(colors)
        used = []
        for cval in cache:
            if len(used) >= n:
                break
            take = cval in remaining
            enc.encode_bool_equi(int(take))
            if take:
                used.append(cval)
                remaining.discard(cval)
        new = sorted(remaining)
        assert len(used) + len(new) == n, "palette colors not representable"
        if not new:
            return
        mind = 1 if plane == 0 else 0
        mx = (1 << bd) - 1
        enc.encode_literal(new[0], bd)
        if len(used) + 1 < n:
            # choose the minimum bits that can carry every delta
            deltas = [new[i + 1] - new[i] - mind
                      for i in range(len(new) - 1)]
            need = max(d.bit_length() for d in deltas) if deltas else 0
            bits = max(bd - 3, need)
            assert bits <= bd - 1, "palette delta too wide"
            enc.encode_literal(bits - (bd - 3), 2)
            prev = new[0]
            for i in range(1, len(new)):
                delta = new[i] - prev - mind
                enc.encode_literal(delta, bits)
                prev = new[i]
                if prev + mind >= mx:
                    break
                bits = min(bits, (mx - prev - mind).bit_length())

    def _emit_palette_map(self, n, m, uv):
        """Mirror of TileDecoder._read_palette_map."""
        enc = self.enc
        h, w = m.shape
        enc.encode_ns(int(m[0, 0]), n)
        cdfs = self.cdf["palette_uv_color_index" if uv
                        else "palette_y_color_index"][n - 2]
        for i in range(1, w + h - 1):
            first = min(i, w - 1)
            last = max(0, i - h + 1)
            for x in range(first, last - 1, -1):
                y = i - x
                have_left = x > 0
                have_top = y > 0
                if not have_left:
                    ctx = 0
                    order0 = [int(m[y - 1, x])]
                elif not have_top:
                    ctx = 0
                    order0 = [int(m[y, x - 1])]
                else:
                    lft = int(m[y, x - 1])
                    top = int(m[y - 1, x])
                    tl = int(m[y - 1, x - 1])
                    if lft == top and top == tl:
                        ctx = 4
                        order0 = [top]
                    elif top == lft:
                        ctx = 3
                        order0 = [top, tl]
                    elif lft == tl:
                        ctx = 2
                        order0 = [lft, top]
                    elif top == tl:
                        ctx = 2
                        order0 = [tl, lft]
                    else:
                        ctx = 1
                        order0 = [min(lft, top), max(lft, top), tl]
                order = order0 + [k for k in range(8)
                                  if k not in order0]
                sym = order.index(int(m[y, x]))
                self._sym(cdfs[ctx], sym, n)

    def _update(self, cdf, symbol):
        if not self.adapt:
            return
        n = len(cdf) - 1
        count = cdf[n]
        rate = 3 + (count > 15) + (count > 31) + min(n.bit_length() - 1, 2)
        for i in range(n - 1):
            if i >= symbol:
                cdf[i] -= cdf[i] >> rate
            else:
                cdf[i] += (32768 - cdf[i]) >> rate
        cdf[n] = count + (count < 32)

    def encode_blocks(self, blocks: List[EncBlock]) -> bytes:
        # partition tree: caller supplies the leaf blocks; we derive the
        # tree for the (single) 64x64 superblock grid
        from collections import defaultdict
        blkmap = {(b.r, b.c): b for b in blocks}
        sb_mi = getattr(self, "sb_mi", 16)
        root = C.BLOCK_128X128 if sb_mi == 32 else C.BLOCK_64X64
        for sr in range(0, self.mi_rows, sb_mi):
            for sc in range(0, self.mi_cols, sb_mi):
                self._emit_lr(sr, sc)
                self._encode_partition(sr, sc, root, blkmap)
        return self.enc.done()

    # -- loop restoration emission (mirror of TileDecoder._read_lr) -------

    def _emit_lr(self, r, c):
        if not self.lr_types:
            return
        from easyav1.video.av1.tile import (
            _WIENER_TAPS_MIN, _WIENER_TAPS_MAX, _WIENER_TAPS_K, _SGR_RADII,
            _SGRPROJ_XQD_MIN, _SGRPROJ_XQD_MAX)
        for plane in range(3):
            frt = self.lr_types[plane]
            if frt == C.RESTORE_NONE:
                continue
            ssx = ssy = 1 if plane else 0
            unit_size = 64  # shift 0 luma, uv shift 0 (plane units)
            ph = (self.h + ssy) >> ssy
            pw = (self.w + ssx) >> ssx
            unit_rows = max((ph + (unit_size >> 1)) // unit_size, 1)
            unit_cols = max((pw + (unit_size >> 1)) // unit_size, 1)
            num = 4 >> ssy
            ur0 = (r * num + unit_size - 1) // unit_size
            ur1 = min(unit_rows, ((r + 16) * num + unit_size - 1)
                      // unit_size)
            num = 4 >> ssx
            uc0 = (c * num + unit_size - 1) // unit_size
            uc1 = min(unit_cols, ((c + 16) * num + unit_size - 1)
                      // unit_size)
            for urow in range(ur0, ur1):
                for ucol in range(uc0, uc1):
                    unit = self.lr_units.get((plane, urow, ucol))
                    self._emit_lr_unit(plane, frt, unit,
                                       _WIENER_TAPS_MIN, _WIENER_TAPS_MAX,
                                       _WIENER_TAPS_K, _SGR_RADII,
                                       _SGRPROJ_XQD_MIN, _SGRPROJ_XQD_MAX)

    def _emit_lr_unit(self, plane, frt, unit, WMIN, WMAX, WK, SRAD,
                      XMIN, XMAX):
        kind = None if unit is None else unit[0]
        if frt == C.RESTORE_WIENER:
            self._sym(self.cdf["wiener_restore"][0],
                      1 if kind == "wiener" else 0)
        elif frt == C.RESTORE_SGRPROJ:
            self._sym(self.cdf["sgrproj_restore"][0],
                      1 if kind == "sgr" else 0)
        else:
            self._sym(self.cdf["switchable_restore"][0],
                      {None: 0, "wiener": 1, "sgr": 2}[kind], 3)
        if kind == "wiener":
            taps = unit[1]
            for p in range(2):
                first = 1 if plane else 0
                for j in range(first, 3):
                    ref = self.lr_ref_wiener[plane][p][j]
                    self._enc_signed_subexp(taps[p][j], WMIN[j],
                                            WMAX[j] + 1, WK[j], ref)
                    self.lr_ref_wiener[plane][p][j] = taps[p][j]
        elif kind == "sgr":
            _, sgr_set, xqd0, xqd1 = unit
            # 4-bit literal, MSB first
            for i in range(3, -1, -1):
                self.enc.encode_bool_equi((sgr_set >> i) & 1)
            for i, v in enumerate((xqd0, xqd1)):
                radius = SRAD[sgr_set][i]
                ref = self.lr_ref_sgr[plane][i]
                if radius:
                    self._enc_signed_subexp(v, XMIN[i], XMAX[i] + 1, 4, ref)
                self.lr_ref_sgr[plane][i] = v

    # -- subexp-with-ref encoder (forward of msac decode_subexp) ----------

    def _enc_literal(self, v, n):
        for i in range(n - 1, -1, -1):
            self.enc.encode_bool_equi((v >> i) & 1)

    def _enc_ns(self, v, n):
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            if w > 1:
                self._enc_literal(v, w - 1)
            return
        if w > 1:
            self._enc_literal((v + m) >> 1, w - 1)
        self.enc.encode_bool_equi((v + m) & 1)

    def _enc_subexp(self, t, num_syms, k):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                self._enc_ns(t - mk, num_syms - mk)
                return
            if t >= mk + a:
                self.enc.encode_bool_equi(1)
                i += 1
                mk += a
            else:
                self.enc.encode_bool_equi(0)
                self._enc_literal(t - mk, b2)
                return

    def _enc_signed_subexp(self, x, low, high, k, ref):
        mx = high - low
        x -= low
        r = ref - low
        if (r << 1) <= mx:
            t = self._recenter(r, x)
        else:
            t = self._recenter(mx - 1 - r, mx - 1 - x)
        self._enc_subexp(t, mx, k)

    @staticmethod
    def _recenter(r, x):
        # forward of spec inverse_recenter: below-ref values get odd
        # codes, above-ref get even codes
        if x > 2 * r:
            return x
        if x < r:
            return ((r - x) << 1) - 1
        return (x - r) << 1

    def _encode_partition(self, r, c, bsize, blkmap):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        w4 = C.BLOCK_W4[bsize]
        half = w4 >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        bsl = mi_wlog2(bsize)
        blk = blkmap.get((r, c))
        if bsize == C.BLOCK_4X4:
            self._encode_block(blkmap[(r, c)])
            return
        # derive partition type from the block map (incl. AB + 4:1)
        q = half >> 1
        sq = (partition_subsize(C.PARTITION_SPLIT, bsize)
              if bsize > C.BLOCK_8X8 else None)
        hsub = partition_subsize(C.PARTITION_HORZ, bsize)
        vsub = partition_subsize(C.PARTITION_VERT, bsize)

        def _at(rr, cc):
            b = blkmap.get((rr, cc))
            return b.bsize if b is not None else None

        if blk is not None and blk.bsize == bsize:
            part = C.PARTITION_NONE
        elif blk is not None and blk.bsize == hsub:
            part = (C.PARTITION_HORZ_B
                    if sq is not None and _at(r + half, c) == sq
                    else C.PARTITION_HORZ)
        elif blk is not None and blk.bsize == vsub:
            part = (C.PARTITION_VERT_B
                    if sq is not None and _at(r, c + half) == sq
                    else C.PARTITION_VERT)
        elif (C.BLOCK_16X16 <= bsize <= C.BLOCK_64X64 and blk is not None
              and blk.bsize == partition_subsize(C.PARTITION_HORZ_4, bsize)):
            part = C.PARTITION_HORZ_4
        elif (C.BLOCK_16X16 <= bsize <= C.BLOCK_64X64 and blk is not None
              and blk.bsize == partition_subsize(C.PARTITION_VERT_4, bsize)):
            part = C.PARTITION_VERT_4
        elif (blk is not None and sq is not None and blk.bsize == sq
              and _at(r, c + half) == sq and _at(r + half, c) == hsub):
            part = C.PARTITION_HORZ_A
        elif (blk is not None and sq is not None and blk.bsize == sq
              and _at(r + half, c) == sq and _at(r, c + half) == vsub):
            part = C.PARTITION_VERT_A
        else:
            part = C.PARTITION_SPLIT
        if bsize == C.BLOCK_4X4:
            self._encode_block(blkmap[(r, c)])
            return
        if has_rows and has_cols:
            above = (int(self.a_part[c]) >> bsl) & 1
            left = (int(self.l_part[r]) >> bsl) & 1
            ctx = left * 2 + above
            row_idx = (bsl - 1) * 4 + ctx
            nsym = 4 if bsize == C.BLOCK_8X8 else (
                8 if bsize == C.BLOCK_128X128 else 10)
            self._sym(self.cdf["partition"][row_idx], part, nsym)
        elif has_cols or has_rows:
            # frame-edge partition: a single split_or bool (mirrors the
            # decoder's _split_or gather)
            horz = has_cols  # bottom edge -> HORZ vs SPLIT
            if horz:
                assert part in (C.PARTITION_HORZ, C.PARTITION_SPLIT), part
            else:
                assert part in (C.PARTITION_VERT, C.PARTITION_SPLIT), part
            from easyav1.video.av1.tile import TileDecoder
            above = (int(self.a_part[c]) >> bsl) & 1
            left = (int(self.l_part[r]) >> bsl) & 1
            ctx = left * 2 + above
            row_idx = (bsl - 1) * 4 + ctx
            cdf_row = self.cdf["partition"][row_idx]
            psplit = TileDecoder.edge_split_prob(cdf_row, bsize, horz)
            self.enc.encode_bool(int(part == C.PARTITION_SPLIT), psplit)
        else:
            if part != C.PARTITION_SPLIT:
                raise NotImplementedError("corner must be SPLIT")
        h4 = C.BLOCK_H4[bsize]
        sub = partition_subsize(part, bsize)

        def _ctx(rr, cc, subsize, over):
            self.a_part[cc:cc + C.BLOCK_W4[over]] = _PART_ABOVE[subsize]
            self.l_part[rr:rr + C.BLOCK_H4[over]] = _PART_LEFT[subsize]

        if part == C.PARTITION_NONE:
            self._encode_block(blk)
            _ctx(r, c, bsize, bsize)
        elif part == C.PARTITION_HORZ:
            self._encode_block(blkmap[(r, c)])
            if (r + half) < self.mi_rows:
                self._encode_block(blkmap[(r + half, c)])
            _ctx(r, c, sub, bsize)
        elif part == C.PARTITION_VERT:
            self._encode_block(blkmap[(r, c)])
            if (c + half) < self.mi_cols:
                self._encode_block(blkmap[(r, c + half)])
            _ctx(r, c, sub, bsize)
        elif part == C.PARTITION_HORZ_A:
            self._encode_block(blkmap[(r, c)])
            self._encode_block(blkmap[(r, c + half)])
            self._encode_block(blkmap[(r + half, c)])
            _ctx(r, c, sq, sub)
            _ctx(r + half, c, sub, sub)
        elif part == C.PARTITION_HORZ_B:
            self._encode_block(blkmap[(r, c)])
            self._encode_block(blkmap[(r + half, c)])
            self._encode_block(blkmap[(r + half, c + half)])
            _ctx(r, c, sub, sub)
            _ctx(r + half, c, sq, sub)
        elif part == C.PARTITION_VERT_A:
            self._encode_block(blkmap[(r, c)])
            self._encode_block(blkmap[(r + half, c)])
            self._encode_block(blkmap[(r, c + half)])
            _ctx(r, c, sq, sub)
            _ctx(r, c + half, sub, sub)
        elif part == C.PARTITION_VERT_B:
            self._encode_block(blkmap[(r, c)])
            self._encode_block(blkmap[(r, c + half)])
            self._encode_block(blkmap[(r + half, c + half)])
            _ctx(r, c, sub, sub)
            _ctx(r, c + half, sq, sub)
        elif part == C.PARTITION_HORZ_4:
            q4 = half >> 1
            for i in range(4):
                rr = r + i * q4
                if rr >= self.mi_rows:
                    break
                self._encode_block(blkmap[(rr, c)])
            _ctx(r, c, sub, bsize)
        elif part == C.PARTITION_VERT_4:
            q4 = half >> 1
            for i in range(4):
                cc = c + i * q4
                if cc >= self.mi_cols:
                    break
                self._encode_block(blkmap[(r, cc)])
            _ctx(r, c, sub, bsize)
        else:  # PARTITION_SPLIT
            self._encode_partition(r, c, sub, blkmap)
            self._encode_partition(r, c + half, sub, blkmap)
            self._encode_partition(r + half, c, sub, blkmap)
            self._encode_partition(r + half, c + half, sub, blkmap)
            if bsize == C.BLOCK_8X8:
                # 4x4 leaves don't recurse: the parent writes their ctx
                _ctx(r, c, sub, bsize)

    def _encode_block(self, blk: EncBlock):
        r, c, bsize = blk.r, blk.c, blk.bsize
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        avail_u = r > 0
        avail_l = c > 0
        has_chroma = True
        if h4 == 1 and (r & 1) == 0:
            has_chroma = False
        if w4 == 1 and (c & 1) == 0:
            has_chroma = False
        skip_ctx = (int(self.a_skip[c]) if avail_u else 0) + \
                   (int(self.l_skip[r]) if avail_l else 0)
        self._sym(self.cdf["skip"][skip_ctx], int(blk.skip))
        if not blk.skip and self.cdef_bits is not None:
            for rr in range(r & ~15, r + h4, 16):
                for cc in range(c & ~15, c + w4, 16):
                    if (rr, cc) not in self.cdef_done:
                        v = self.cdef_vals.get((rr, cc), 0)
                        for i in range(self.cdef_bits - 1, -1, -1):
                            self.enc.encode_bool_equi((v >> i) & 1)
                        self.cdef_done[(rr, cc)] = v
        self._emit_deltas_hook(blk)
        above_mode = int(self.a_mode[c]) if avail_u else C.DC_PRED
        left_mode = int(self.l_mode[r]) if avail_l else C.DC_PRED
        self._sym(self.cdf["kf_y_mode"][T.INTRA_MODE_CONTEXT[above_mode]]
                  [T.INTRA_MODE_CONTEXT[left_mode]], blk.y_mode)
        if bsize >= C.BLOCK_8X8 and C.V_PRED <= blk.y_mode <= C.D67_PRED:
            self._sym(self.cdf["angle_delta"][blk.y_mode - C.V_PRED],
                      blk.angle_y + 3)
        if has_chroma:
            if getattr(self, "lossless", False):
                # lossless: CfL only when the chroma plane block is 4x4
                cfl_allowed = (w4 >> 1) <= 1 and (h4 >> 1) <= 1
            else:
                cfl_allowed = w4 * 4 <= 32 and h4 * 4 <= 32
            uv_mode = blk.uv_mode
            if blk.cfl is not None:
                assert cfl_allowed
                uv_mode = C.UV_CFL_PRED
            row = self.cdf["uv_mode"][1 if cfl_allowed else 0][blk.y_mode]
            self._sym(row, uv_mode, 14 if cfl_allowed else 13)
            if uv_mode == C.UV_CFL_PRED:
                au, av = blk.cfl
                su = 0 if au == 0 else (1 if au < 0 else 2)
                sv = 0 if av == 0 else (1 if av < 0 else 2)
                joint = su * 3 + sv - 1
                self._sym(self.cdf["cfl_sign"][0], joint)
                if su:
                    self._sym(self.cdf["cfl_alpha"][(3 if su == 2 else 0)
                                                    + sv], abs(au) - 1)
                if sv:
                    self._sym(self.cdf["cfl_alpha"][(3 if sv == 2 else 0)
                                                    + su], abs(av) - 1)
            if bsize >= C.BLOCK_8X8 and C.V_PRED <= uv_mode <= C.D67_PRED:
                self._sym(self.cdf["angle_delta"][uv_mode - C.V_PRED],
                          blk.angle_uv + 3)
        # palette flags + colors (mirrors TileDecoder palette_mode_info)
        pal_y_colors = None
        if (getattr(self, "screen_tools", False) and bsize >= C.BLOCK_8X8
                and w4 * 4 <= 64 and h4 * 4 <= 64):
            sz_ctx = (w4 * 4).bit_length() + (h4 * 4).bit_length() - 8
            if blk.y_mode == C.DC_PRED:
                pctx = int(int(self.a_pal_sz[0][c]) > 0) \
                    + int(int(self.l_pal_sz[0][r]) > 0)
                use_pal = blk.palette_y is not None
                self._sym(self.cdf["palette_y_mode"][sz_ctx][pctx],
                          int(use_pal))
                if use_pal:
                    pal_y_colors = list(blk.palette_y[0])
                    n = len(pal_y_colors)
                    self._sym(self.cdf["palette_y_size"][sz_ctx], n - 2)
                    self._emit_palette_colors(0, r, c, pal_y_colors)
            if has_chroma and (blk.uv_mode == C.DC_PRED
                               and blk.cfl is None):
                pctx = int(pal_y_colors is not None)
                self._sym(self.cdf["palette_uv_mode"][pctx], 0)
        self._pending_palette = (pal_y_colors, blk.palette_y[1]) \
            if pal_y_colors is not None else None
        # filter_intra flag (mirrors TileDecoder._intra_mode_info; only
        # coded when the sequence enables the tool)
        if (getattr(getattr(self, "seq", None), "enable_filter_intra",
                    False)
                and blk.y_mode == C.DC_PRED
                and getattr(self, "_pending_palette", None) is None
                and C.BLOCK_W4[bsize] * 4 <= 32
                and C.BLOCK_H4[bsize] * 4 <= 32):
            fi = getattr(blk, "filter_intra", None)
            self._sym(self.cdf["filter_intra_use"][bsize],
                      int(fi is not None))
            if fi is not None:
                self._sym(self.cdf["filter_intra_mode"][0], fi, 5)
        # palette tokens (decoder reads them before tx size)
        if getattr(self, "_pending_palette", None) is not None:
            colors, pmap = self._pending_palette
            self._pending_palette = None
            self._emit_palette_map(len(colors), pmap, False)
            self.a_pal_sz[0][c:c + w4] = len(colors)
            self.l_pal_sz[0][r:r + h4] = len(colors)
            self.a_pal[0][c:c + w4, :len(colors)] = colors
            self.l_pal[0][r:r + h4, :len(colors)] = colors
        elif getattr(self, "screen_tools", False):
            self.a_pal_sz[0][c:c + w4] = 0
            self.l_pal_sz[0][r:r + h4] = 0
            self.a_pal_sz[1][c:c + w4] = 0
            self.l_pal_sz[1][r:r + h4] = 0
        tx_size = T.MAX_TX_SIZE_RECT[bsize]
        if getattr(self, "lossless", False):
            tx_size = C.TX_4X4
            blk.tx_depth = 0
        elif self.tx_mode_select and bsize != C.BLOCK_4X4:
            depth_tab = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4,
                         2, 2, 3, 3, 4, 4]
            max_depth = depth_tab[bsize]
            cat = max(0, min(T.TX_SIZE_SQR_UP[tx_size] - 1, 3))
            max_tx_w = T.TX_WIDTH[tx_size]
            max_tx_h = T.TX_HEIGHT[tx_size]
            ctx = int(int(self.a_txw[c]) >= max_tx_w) \
                + int(int(self.l_txh[r]) >= max_tx_h)
            nsym = 2 if cat == 0 else min(max_depth, 2) + 1
            self._sym(self.cdf["tx_size"][cat][ctx], blk.tx_depth, nsym)
        for _ in range(blk.tx_depth):
            tx_size = T.SPLIT_TX_SIZE[tx_size]
        if not blk.skip:
            self._encode_residual(blk, tx_size, has_chroma)
        else:
            self.a_lvl[0][c:c + w4] = 0
            self.l_lvl[0][r:r + h4] = 0
            self.a_sign[0][c:c + w4] = 0
            self.l_sign[0][r:r + h4] = 0
            if has_chroma:
                cx, cy = c >> 1, r >> 1
                cw, ch = max(1, w4 >> 1), max(1, h4 >> 1)
                for p in (1, 2):
                    self.a_lvl[p][cx:cx + cw] = 0
                    self.l_lvl[p][cy:cy + ch] = 0
                    self.a_sign[p][cx:cx + cw] = 0
                    self.l_sign[p][cy:cy + ch] = 0
        self.a_mode[c:c + w4] = blk.y_mode
        self.l_mode[r:r + h4] = blk.y_mode
        self.a_skip[c:c + w4] = int(blk.skip)
        self.l_skip[r:r + h4] = int(blk.skip)
        self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
        self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]

    def _encode_residual(self, blk, tx_size, has_chroma):
        # spec 5.11.34 residual(): blocks wider/taller than 64px split
        # into 64x64 chunks with planes interleaved PER CHUNK (mirror of
        # the decoder's _residual); luma tx index is block-raster, the
        # chroma tx index is chroma-block-raster
        r, c = blk.r, blk.c
        coeff_lists = blk.luma_coeffs or [[]]
        tx_ctx = (T.TX_SIZE_SQR[tx_size] + T.TX_SIZE_SQR_UP[tx_size] + 1) >> 1
        w4 = C.BLOCK_W4[blk.bsize]
        h4 = C.BLOCK_H4[blk.bsize]
        sw = T.TX_W4[tx_size]
        sh = T.TX_H4[tx_size]
        uv_tx = self._uv_tx(blk.bsize) if has_chroma else 0
        if has_chroma:
            uv_ctx = (T.TX_SIZE_SQR[uv_tx]
                      + T.TX_SIZE_SQR_UP[uv_tx] + 1) >> 1
            cc = blk.chroma_coeffs or [[], []]
            cw4 = max(1, w4 >> 1)
            ch4 = max(1, h4 >> 1)
            usw, ush = T.TX_W4[uv_tx], T.TX_H4[uv_tx]
            clists = []
            for plane in (1, 2):
                lists = cc[plane - 1] if plane - 1 < len(cc) else []
                # back-compat: a flat [(lvl, sign), ...] list means
                # "first tx only"; a list of lists is one per chroma tx
                if lists and isinstance(lists[0], tuple):
                    lists = [lists]
                clists.append(lists)
        ntx_row = w4 // sw if sw else 0
        for cy4 in range(0, h4, 16):
            for cx4 in range(0, w4, 16):
                cw4_full = min(16, w4 - cx4)
                ch4_full = min(16, h4 - cy4)
                for yy in range(cy4, cy4 + ch4_full, sh):
                    for xx in range(cx4, cx4 + cw4_full, sw):
                        idx = (yy // sh) * ntx_row + (xx // sw)
                        coeffs = (coeff_lists[idx]
                                  if idx < len(coeff_lists) else [])
                        self._encode_txb(0, c + xx, r + yy, tx_size,
                                         tx_ctx, blk, coeffs)
                if not has_chroma:
                    continue
                ccw = max(1, cw4_full >> 1)
                cch = max(1, ch4_full >> 1)
                cbase_x = cx4 >> 1
                cbase_y = cy4 >> 1
                ntx_crow = cw4 // usw if usw else 0
                for plane in (1, 2):
                    lists = clists[plane - 1]
                    for vy in range(cbase_y, cbase_y + cch, ush):
                        for vx in range(cbase_x, cbase_x + ccw, usw):
                            ci = (vy // ush) * ntx_crow + (vx // usw)
                            co = lists[ci] if ci < len(lists) else []
                            self._encode_txb(plane, (c >> 1) + vx,
                                             (r >> 1) + vy, uv_tx,
                                             uv_ctx, blk, co)

    def _uv_tx(self, bsize) -> int:
        if getattr(self, "lossless", False):
            return C.TX_4X4
        w4 = max(1, C.BLOCK_W4[bsize] >> 1)
        h4 = max(1, C.BLOCK_H4[bsize] >> 1)
        for b in range(C.BLOCK_SIZES_ALL):
            if C.BLOCK_W4[b] == w4 and C.BLOCK_H4[b] == h4:
                tx = T.MAX_TX_SIZE_RECT[b]
                while T.TX_WIDTH[tx] > 32 or T.TX_HEIGHT[tx] > 32:
                    tx = T.SPLIT_TX_SIZE[tx]
                return tx
        raise ValueError

    def _encode_txb(self, plane, x4, y4, tx_size, tx_ctx, blk, coeffs):
        ptype = 1 if plane else 0
        cdf = self.cdf
        # txb_skip ctx (mirror of decoder)
        tw4, th4 = T.TX_W4[tx_size], T.TX_H4[tx_size]
        if plane == 0:
            bw4 = C.BLOCK_W4[blk.bsize]
            bh4 = C.BLOCK_H4[blk.bsize]
            if tw4 == bw4 and th4 == bh4:
                ctx = 0
            else:
                top = 0
                left = 0
                for i in range(min(tw4, self.mi_cols - x4)):
                    top |= int(self.a_lvl[0][x4 + i])
                for i in range(min(th4, self.mi_rows - y4)):
                    left |= int(self.l_lvl[0][y4 + i])
                top &= 63
                left &= 63
                mx_ = min(top | left, 4)
                mn_ = min(min(top, left), 4)
                tab = [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                       [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]]
                ctx = tab[mn_][mx_]
        else:
            above = 0
            left_nz = 0
            for i in range(tw4):
                if x4 + i < len(self.a_lvl[plane]) and self.a_lvl[plane][x4 + i]:
                    above = 1
            for i in range(th4):
                if y4 + i < len(self.l_lvl[plane]) and self.l_lvl[plane][y4 + i]:
                    left_nz = 1
            bw4 = max(1, C.BLOCK_W4[blk.bsize] >> 1)
            bh4 = max(1, C.BLOCK_H4[blk.bsize] >> 1)
            # libaom av1_get_txb_ctx: offset 10 when the chroma plane
            # block is larger than the tx, else 7
            ctx = (10 if bw4 * bh4 > tw4 * th4 else 7) + above + left_nz
        all_zero = 0 if coeffs else 1
        self._sym(cdf["txb_skip"][tx_ctx][ctx], all_zero)
        if all_zero:
            self._set_coef_ctx(plane, x4, y4, T.TX_W4[tx_size],
                               T.TX_H4[tx_size], 0, 0)
            return
        # tx type: TX_MODE_LARGEST tx for <=16x16 has a coded type; keep
        # blocks >= 32x32 to avoid coding it (set 0).
        # tx type symbol: luma only — chroma tx type is DERIVED from the
        # uv mode, never coded
        is_inter = (not getattr(self, "frame_is_intra", True)
                    and getattr(blk, "is_inter", False))
        tx_type = C.DCT_DCT
        if getattr(self, "lossless", False):
            pass    # lossless: WHT implied, no tx-type symbol
        elif is_inter:
            tx_set = T.get_tx_set_inter(tx_size, False) if plane == 0 else 0
            if tx_set != 0:
                lst = (T.TX_SET_INTER_1 if tx_set == 1 else
                       T.TX_SET_INTER_2 if tx_set == 2 else T.TX_SET_INTER_3)
                tx_type = blk.tx_type if blk.tx_type in lst else C.DCT_DCT
                sym = lst.index(tx_type)
                sq = T.TX_SIZE_SQR[tx_size]
                key = f"inter_ext_tx_set{tx_set}"
                self._sym(self.cdf[key][sq], sym, len(lst))
            elif plane != 0:
                # inter chroma: co-located luma tx type clamped by set
                uv_set = T.get_tx_set_inter(tx_size, False)
                if uv_set != 0:
                    lst = (T.TX_SET_INTER_1 if uv_set == 1 else
                           T.TX_SET_INTER_2 if uv_set == 2
                           else T.TX_SET_INTER_3)
                    tx_type = blk.tx_type if blk.tx_type in lst \
                        else C.DCT_DCT
        else:
            tx_set = T.get_tx_set_intra(tx_size, False) if plane == 0 else 0
            if tx_set != 0:
                lst = T.TX_SET_INTRA_1 if tx_set == 1 else T.TX_SET_INTRA_2
                tx_type = blk.tx_type if blk.tx_type in lst else C.DCT_DCT
                sym = lst.index(tx_type)
                sq = T.TX_SIZE_SQR[tx_size]
                key = "intra_ext_tx_set1" if tx_set == 1 else "intra_ext_tx_set2"
                self._sym(self.cdf[key][sq][blk.y_mode], sym, len(lst))
        tx_cls = T.tx_type_class(tx_type)
        eob = len(coeffs)
        self._encode_eob(tx_size, ptype, eob, tx_cls)
        # coefficients in reverse scan order
        scan = T.get_scan(tx_size, tx_type)
        tw = T.TX_WIDTH[T.ADJUSTED_TX_SIZE[tx_size]]
        th = T.TX_HEIGHT[T.ADJUSTED_TX_SIZE[tx_size]]
        bwl = tw.bit_length() - 1
        levels = np.zeros(th * tw, np.int32)
        from easyav1.video.av1.tile import TileDecoder
        base_offsets = (T.coeff_base_ctx_offset(tx_size).reshape(-1)
                        if tx_cls == T.TX_CLASS_2D else None)
        for ci in range(eob - 1, -1, -1):
            level, sign = coeffs[ci]
            pos = int(scan[ci])
            if ci == eob - 1:
                ctx_eob = TileDecoder._coeff_base_eob_ctx(ci, tw, th)
                sym = min(level, 3) - 1
                self._sym(cdf["coeff_base_eob"][tx_ctx][ptype][ctx_eob], sym)
            else:
                bctx = TileDecoder._coeff_base_ctx(levels, pos, bwl, th,
                                                   tx_cls, base_offsets)
                sym = min(level, 3)
                self._sym(cdf["coeff_base"][tx_ctx][ptype][bctx], sym)
            if min(level, 3) > 2:
                brctx = TileDecoder._coeff_br_ctx(levels, pos, bwl,
                                                  tx_cls)
                br_tx = min(tx_ctx, C.TX_32X32)
                rem = min(level, 15) - 3
                for _ in range(4):
                    k = min(rem, 3)
                    self._sym(cdf["coeff_br"][br_tx][ptype][brctx], k)
                    rem -= k
                    if k < 3:
                        break
            # ctx arrays see the pre-golomb cap, mirroring the decoder
            levels[pos] = min(level, 15)
        culp = 0
        dc_cat = 0
        for ci in range(eob):
            level, sign = coeffs[ci]
            culp += level
            if level == 0:
                continue
            pos = int(scan[ci])
            if pos == 0:
                sctx = self._dc_sign_ctx(plane, x4, y4,
                                         T.TX_W4[tx_size], T.TX_H4[tx_size])
                self._sym(cdf["dc_sign"][ptype][sctx], sign)
                dc_cat = 2 if sign else 1
            else:
                self.enc.encode_bool_equi(sign)
            if level >= 15:
                # exp-golomb suffix, emitted after the sign (decoder reads
                # it in the forward sign pass when base+br saturate at 15)
                v = level - 15 + 1
                nbits = v.bit_length() - 1
                for _ in range(nbits):
                    self.enc.encode_bool_equi(0)
                self.enc.encode_bool_equi(1)
                for i in range(nbits - 1, -1, -1):
                    self.enc.encode_bool_equi((v >> i) & 1)
        culp = min(culp, 63)
        self._set_coef_ctx(plane, x4, y4, T.TX_W4[tx_size], T.TX_H4[tx_size],
                           culp, dc_cat)

    def _dc_sign_ctx(self, plane, x4, y4, w4, h4):
        total = 0
        for i in range(w4):
            if x4 + i < len(self.a_sign[plane]):
                s = int(self.a_sign[plane][x4 + i])
                total += 1 if s == 1 else (-1 if s == 2 else 0)
        for i in range(h4):
            if y4 + i < len(self.l_sign[plane]):
                s = int(self.l_sign[plane][y4 + i])
                total += 1 if s == 1 else (-1 if s == 2 else 0)
        if total == 0:
            return 0
        return 1 if total < 0 else 2

    def _set_coef_ctx(self, plane, x4, y4, w4, h4, cul, dc_cat):
        # clip writes to the frame's plane-cell grid (mirrors the tile
        # decoder / libaom av1_set_entropy_contexts): state must not be
        # left in cells past the bottom/right frame edge
        if plane:
            w4 = min(w4, ((self.mi_cols + 1) >> 1) - x4)
            h4 = min(h4, ((self.mi_rows + 1) >> 1) - y4)
        else:
            w4 = min(w4, self.mi_cols - x4)
            h4 = min(h4, self.mi_rows - y4)
        self.a_lvl[plane][x4:x4 + w4] = cul
        self.l_lvl[plane][y4:y4 + h4] = cul
        self.a_sign[plane][x4:x4 + w4] = dc_cat
        self.l_sign[plane][y4:y4 + h4] = dc_cat

    def _encode_eob(self, tx_size, ptype, eob, tx_cls=0):
        adj = T.ADJUSTED_TX_SIZE[tx_size]
        area = T.TX_WIDTH[adj] * T.TX_HEIGHT[adj]
        key = {16: "eob_multi16", 32: "eob_multi32", 64: "eob_multi64",
               128: "eob_multi128", 256: "eob_multi256",
               512: "eob_multi512", 1024: "eob_multi1024"}[area]
        if eob <= 2:
            eob_pt = eob
            extra = None
        else:
            eob_pt = (eob - 1).bit_length() + 1
            extra = eob - ((1 << (eob_pt - 2)) + 1)
        cls_ctx = 0 if tx_cls == T.TX_CLASS_2D else 1
        self._sym(self.cdf[key][ptype][cls_ctx], eob_pt - 1)
        if eob_pt >= 3:
            shift = eob_pt - 2
            bit = (extra >> (shift - 1)) & 1
            tx_ctx = (T.TX_SIZE_SQR[tx_size] + T.TX_SIZE_SQR_UP[tx_size] + 1) >> 1
            self._sym(self.cdf["eob_extra"][tx_ctx][ptype][eob_pt - 3], bit)
            for i in range(1, shift):
                self.enc.encode_bool_equi((extra >> (shift - 1 - i)) & 1)


def make_ivf(frames: List[bytes], w: int, h: int) -> bytes:
    """Minimal IVF container for raw AV1 temporal units."""
    out = bytearray()
    out += b"DKIF"
    out += (0).to_bytes(2, "little")
    out += (32).to_bytes(2, "little")
    out += b"AV01"
    out += w.to_bytes(2, "little")
    out += h.to_bytes(2, "little")
    out += (30).to_bytes(4, "little")   # timebase den
    out += (1).to_bytes(4, "little")    # timebase num
    out += len(frames).to_bytes(4, "little")
    out += (0).to_bytes(4, "little")
    for i, f in enumerate(frames):
        out += len(f).to_bytes(4, "little")
        out += i.to_bytes(8, "little")
        out += f
    return bytes(out)


def encode_frame(w: int, h: int, base_q: int,
                 blocks: List[EncBlock], adapt: bool = False,
                 tx_mode_select: bool = False,
                 edge_filter: bool = False,
                 lf_levels=(0, 0), cdef=None,
                 lr=None, lr_units=None, fg=None,
                 intrabc: bool = False, screen: bool = False,
                 superres_denom=None) -> bytes:
    """Full temporal unit: TD + seq hdr + frame OBU.

    cdef: None or (damping, [(ypri, ysec, uvpri, uvsec), ...]) with 1, 2,
    4 or 8 strength entries; cdef_idx literals are emitted per 64x64 at
    the first non-skip block (index 0 always, matching the decoder)."""
    seq = write_sequence_header(w, h, edge_filter=edge_filter, cdef=cdef,
                                restoration=lr is not None,
                                film_grain=fg is not None,
                                superres=superres_denom is not None)
    # with superres the frame is CODED at the downscaled width (the
    # decoder upscales back to w; spec 5.9.8 / 7.16)
    wd = ((w * 8 + superres_denom // 2) // superres_denom
          if superres_denom else w)
    bw = BitWriter()
    write_frame_header_bits(bw, base_q, disable_cdf_update=not adapt,
                            tx_mode_select=tx_mode_select,
                            lf_levels=lf_levels, cdef=cdef, w=wd, h=h,
                            lr=lr, fg=fg, intrabc=intrabc, screen=screen,
                            superres_seq=superres_denom is not None,
                            superres_denom=superres_denom)
    bw.byte_align()
    header_bytes = bw.bytes()
    cdef_bits = None
    cdef_vals = None
    if cdef is not None:
        cdef_bits = {1: 0, 2: 1, 4: 2, 8: 3}[len(cdef[1])]
        cdef_vals = cdef[2] if len(cdef) > 2 else None
    if intrabc:
        assert cdef is None and lr is None and lf_levels[:2] == (0, 0)
        from easyav1.video.av1.av1_enc_inter import IntraBcTileEncoder
        tenc = IntraBcTileEncoder(w, h, base_q, adapt=adapt,
                                  tx_mode_select=tx_mode_select)
    else:
        tenc = SimpleTileEncoder(wd, h, base_q, adapt=adapt,
                                 tx_mode_select=tx_mode_select,
                                 cdef_bits=cdef_bits, cdef_vals=cdef_vals,
                                 lr_types=lr, lr_units=lr_units)
        tenc.screen_tools = screen
    tile_data = tenc.encode_blocks(blocks)
    frame_payload = header_bytes + tile_data
    return (obu(C.OBU_TEMPORAL_DELIMITER, b"")
            + obu(C.OBU_SEQUENCE_HEADER, seq)
            + obu(C.OBU_FRAME, frame_payload))
