"""AV1 tile symbol decoder (host, sequential — the msac side of the
host/device split per SURVEY.md §7).

Intra-frame path: partition tree, intra mode info, tx sizes, coefficient
decode with full context modeling. Produces a FramePlan: dense mode-info
arrays plus the per-transform-block coefficient list that the
reconstruction stage (numpy reference, device kernels) consumes.

Spec references: §5.11 (tile group / decode partition / mode info /
residual / coeffs), §8.3 (coefficient contexts).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.cdf import CdfContext
from easyav1.video.av1.headers import FrameHeader, SequenceHeader
from easyav1.video.av1.msac import Msac
from easyav1.video.av1 import warp as warp_mod


@dataclasses.dataclass
class TxBlock:
    plane: int
    x: int          # pixel position within the plane
    y: int
    tx_size: int
    tx_type: int
    eob: int
    coeffs: np.ndarray  # (h, w) int32 dequantized coefficients
    lossless: bool = False
    levels: Optional[list] = None   # [(level, sign)] scan order (debug)


@dataclasses.dataclass
class BlockRecord:
    """One coded block in decode order (recon replays this sequence)."""

    r: int
    c: int
    bsize: int
    y_mode: int
    uv_mode: int
    angle_y: int
    angle_uv: int
    skip: bool
    tx_size: int
    uv_tx_size: int
    has_chroma: bool
    cfl_alphas: Optional[Tuple[int, int]] = None
    filter_intra: Optional[int] = None
    partition: int = 0
    tx_blocks: List[TxBlock] = dataclasses.field(default_factory=list)
    # inter fields
    is_inter: bool = False
    ref_frame: Tuple[int, int] = (0, -1)
    mv: Tuple[int, int] = (0, 0)          # (row, col) 1/8-pel
    interp_filter: Tuple[int, int] = (0, 0)
    inter_mode: int = 0
    ref_mv_idx: int = 0
    # var-tx luma leaves [(x4off, y4off, tx_size)] when is_inter
    var_txs: Optional[list] = None
    # motion mode: C.SIMPLE / C.OBMC_MOTION / C.WARPED
    motion_mode: int = 0
    # local warp: (wmmat[6], (alpha,beta,gamma,delta)) or None
    warp: Optional[tuple] = None
    # compound prediction
    mv2: Tuple[int, int] = (0, 0)         # second-list mv (row, col)
    compound_type: int = 0                # C.COMPOUND_*
    compound_idx: int = 1
    wedge_idx: int = 0
    wedge_sign: int = 0
    mask_type: int = 0
    skip_mode: bool = False
    # interintra: (-1 when off); ii_wedge selects the wedge blend
    interintra_mode: int = -1
    ii_wedge: int = 0
    ii_wedge_idx: int = 0


@dataclasses.dataclass
class FramePlan:
    """Everything recon needs, in decode order."""

    width: int
    height: int
    mi_cols: int
    mi_rows: int
    subsampling_x: int
    subsampling_y: int
    y_mode: np.ndarray          # (mi_rows, mi_cols) int8
    uv_mode: np.ndarray
    angle_y: np.ndarray
    angle_uv: np.ndarray
    skip: np.ndarray
    bsize: np.ndarray
    blocks: List[BlockRecord] = dataclasses.field(default_factory=list)
    palette: dict = dataclasses.field(default_factory=dict)
    cfl_alphas: dict = dataclasses.field(default_factory=dict)  # (mir,mic) -> (signU? ..)
    filter_intra: dict = dataclasses.field(default_factory=dict)
    # every tx visited during decode (including all_zero ones):
    # (plane, x, y, tx_size) in plane pixel coords — loop filter tx grids
    lf_txs: List[Tuple[int, int, int, int]] = \
        dataclasses.field(default_factory=list)
    # cdef strength index per 64x64 unit: (mi_r & ~15, mi_c & ~15) -> idx
    cdef_idx: dict = dataclasses.field(default_factory=dict)
    # loop restoration per unit: (plane, urow, ucol) -> RESTORE_* type,
    # wiener taps [pass][3], sgr (set, xqd0, xqd1)
    lr_type: dict = dataclasses.field(default_factory=dict)
    lr_wiener: dict = dataclasses.field(default_factory=dict)
    lr_sgr: dict = dataclasses.field(default_factory=dict)


# Partition context lookup: stored value = 64 - 2*mi_width — high bits
# set STRICTLY ABOVE the neighbor's own size level, so a parent with
# block-size-log bsl reads (value >> bsl) & 1 == 1 iff the neighbor block
# is STRICTLY SMALLER than the parent size (verified against real libaom
# streams and dav1d's al_part_ctx constants 0x10/0x18/0x1c/0x1e/0x1f,
# which are the same values on an 8x8-unit bit scale).
_PART_ABOVE = [max(0, 64 - 2 * C.BLOCK_W4[b]) for b in range(22)]
_PART_LEFT = [max(0, 64 - 2 * C.BLOCK_H4[b]) for b in range(22)]

# spec Size_Group_Lookup (y_mode cdf context for non-key frames)
SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
              0, 0, 1, 1, 2, 2]

# loop restoration coding constants (spec 5.11.58)
_WIENER_TAPS_MIN = [-5, -23, -17]
_WIENER_TAPS_MAX = [10, 8, 46]
_WIENER_TAPS_K = [1, 2, 3]
_WIENER_TAPS_MID = [3, -7, 15]
_SGRPROJ_XQD_MIN = [-96, -32]
_SGRPROJ_XQD_MAX = [31, 95]
_SGRPROJ_XQD_MID = [-32, 31]
# per-set pass radii (Sgr_Params: sets 0-9 both, 10-13 no pass0,
# 14-15 no pass1)
_SGR_RADII = [(2, 1)] * 10 + [(0, 1)] * 4 + [(2, 0)] * 2

# Partition subsize table (spec Partition_Subsize[10][BLOCK_SIZES_ALL]),
# entries only needed for square parents 8x8..128x128.
_SQ = [C.BLOCK_8X8, C.BLOCK_16X16, C.BLOCK_32X32, C.BLOCK_64X64,
       C.BLOCK_128X128]


def partition_subsize(partition: int, bsize: int) -> int:
    i = _SQ.index(bsize)
    if partition == C.PARTITION_NONE:
        return bsize
    if partition == C.PARTITION_SPLIT:
        return [C.BLOCK_4X4, C.BLOCK_8X8, C.BLOCK_16X16, C.BLOCK_32X32,
                C.BLOCK_64X64][i]
    if partition == C.PARTITION_HORZ or partition == C.PARTITION_HORZ_A \
            or partition == C.PARTITION_HORZ_B:
        return [C.BLOCK_8X4, C.BLOCK_16X8, C.BLOCK_32X16, C.BLOCK_64X32,
                C.BLOCK_128X64][i]
    if partition == C.PARTITION_VERT or partition == C.PARTITION_VERT_A \
            or partition == C.PARTITION_VERT_B:
        return [C.BLOCK_4X8, C.BLOCK_8X16, C.BLOCK_16X32, C.BLOCK_32X64,
                C.BLOCK_64X128][i]
    if partition == C.PARTITION_HORZ_4:
        return [-1, C.BLOCK_16X4, C.BLOCK_32X8, C.BLOCK_64X16, -1][i]
    if partition == C.PARTITION_VERT_4:
        return [-1, C.BLOCK_4X16, C.BLOCK_8X32, C.BLOCK_16X64, -1][i]
    raise ValueError(partition)


def mi_wlog2(b):
    return C.BLOCK_W4[b].bit_length() - 1


def mi_hlog2(b):
    return C.BLOCK_H4[b].bit_length() - 1


class TileDecoder:
    def __init__(self, seq: SequenceHeader, hdr: FrameHeader,
                 cdf: CdfContext, plan: FramePlan):
        self.seq = seq
        self.hdr = hdr
        self.cdf = cdf.t
        self.plan = plan
        # projected temporal motion field (set by the backend when
        # use_ref_frame_mvs; None disables the temporal candidate scan)
        self.tpl_mv = None
        self.tpl_off = None
        self.bitdepth = seq.color.bitdepth
        self.num_planes = seq.color.num_planes
        self.ssx = seq.color.subsampling_x
        self.ssy = seq.color.subsampling_y
        self.mi_cols = hdr.mi_cols
        self.mi_rows = hdr.mi_rows
        self.sb_log2 = 5 if seq.use_128x128_superblock else 4
        self.sb_size = (C.BLOCK_128X128 if seq.use_128x128_superblock
                        else C.BLOCK_64X64)

    # -- per-tile state ----------------------------------------------------

    def _init_tile(self, col_start4, col_end4, row_start4, row_end4):
        n4w = col_end4 - col_start4
        n4h = row_end4 - row_start4
        self.mi_col_start = col_start4
        self.mi_col_end = col_end4
        self.mi_row_start = row_start4
        self.mi_row_end = row_end4
        # above contexts indexed by absolute mi col; left by absolute mi row
        self.a_part = np.zeros(self.mi_cols, np.int32)
        self.l_part = np.zeros(self.mi_rows, np.int32)
        self.a_mode = np.full(self.mi_cols, C.DC_PRED, np.int32)
        self.l_mode = np.full(self.mi_rows, C.DC_PRED, np.int32)
        self.a_skip = np.zeros(self.mi_cols, np.int32)
        self.l_skip = np.zeros(self.mi_rows, np.int32)
        # tx dims for tx_size ctx (zero-init: unavailable counts as 0)
        self.a_txw = np.zeros(self.mi_cols, np.int32)
        self.l_txh = np.zeros(self.mi_rows, np.int32)
        # coefficient contexts per plane: cul levels (0..63) and dc sign
        # category (0 none, 1 positive?, 2 negative) per 4-px unit
        self.a_lvl = [np.zeros(self.mi_cols, np.int32) for _ in range(3)]
        self.l_lvl = [np.zeros(self.mi_rows, np.int32) for _ in range(3)]
        self.a_sign = [np.zeros(self.mi_cols, np.int32) for _ in range(3)]
        self.l_sign = [np.zeros(self.mi_rows, np.int32) for _ in range(3)]
        self.cur_qindex = self.hdr.quant.base_q_idx
        # inter decode state (per-4x4): ref pair, mvs, modes, interp,
        # skip-mode, decoded coverage (for has_top_right)
        self.ref_frames0 = np.full((self.mi_rows, self.mi_cols), -1, np.int8)
        self.ref_frames1 = np.full((self.mi_rows, self.mi_cols), -1, np.int8)
        self.comp_group_grid = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.comp_idx_grid = np.ones((self.mi_rows, self.mi_cols), np.int8)
        self.mvs = np.zeros((self.mi_rows, self.mi_cols, 2, 2), np.int16)
        self.modes = np.zeros((self.mi_rows, self.mi_cols), np.int16)
        self.interp = np.zeros((self.mi_rows, self.mi_cols, 2), np.int8)
        self.skip_mode_g = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.intrabc_g = np.zeros((self.mi_rows, self.mi_cols), bool)
        self.decoded_mi = np.zeros((self.mi_rows, self.mi_cols), bool)
        self.tx_types = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        # palette state: per-4px-unit sizes + stored colors (dav1d al_pal)
        self.a_pal_sz = [np.zeros(self.mi_cols, np.int32) for _ in range(2)]
        self.l_pal_sz = [np.zeros(self.mi_rows, np.int32) for _ in range(2)]
        self.a_pal = [np.zeros((self.mi_cols, 8), np.int32)
                      for _ in range(3)]
        self.l_pal = [np.zeros((self.mi_rows, 8), np.int32)
                      for _ in range(3)]
        from easyav1.video.av1.refmvs import RefMvFinder
        self.refmv = RefMvFinder(self)

    # -- entry -------------------------------------------------------------

    def decode_tile(self, data: bytes, tile_row: int, tile_col: int) -> None:
        hdr = self.hdr
        t = hdr.tile
        sb_shift = self.sb_log2  # sb size in mi units (log2)
        col_start = t.col_starts[tile_col] << sb_shift
        col_end = min(t.col_starts[tile_col + 1] << sb_shift, self.mi_cols)
        row_start = t.row_starts[tile_row] << sb_shift
        row_end = min(t.row_starts[tile_row + 1] << sb_shift, self.mi_rows)
        self._init_tile(col_start, col_end, row_start, row_end)
        # expose per-mi inter grids to recon (OBMC neighbor lookups)
        self.plan.mvs_grid = self.mvs
        self.plan.ref0_grid = self.ref_frames0
        self.plan.ref1_grid = self.ref_frames1
        self.plan.interp_grid = self.interp
        self.msac = Msac(data, allow_update_cdf=not hdr.disable_cdf_update)
        # loop-restoration predictors reset per tile (spec decode_tile)
        self.lr_ref_wiener = [[list(_WIENER_TAPS_MID) for _ in range(2)]
                              for _ in range(3)]
        self.lr_ref_sgr = [list(_SGRPROJ_XQD_MID) for _ in range(3)]
        # delta-q/lf state resets per tile (spec decode_tile:
        # CurrentQIndex = base_q_idx, DeltaLF[*] = 0)
        self.cur_qindex = hdr.quant.base_q_idx
        sb_mi = 1 << sb_shift
        for r in range(row_start, row_end, sb_mi):
            for c in range(col_start, col_end, sb_mi):
                self.read_deltas = hdr.delta_q_present
                self._read_lr(r, c)
                self._decode_partition(r, c, self.sb_size)

    # -- loop restoration params (spec 5.11.57-58 read_lr) -----------------

    def _read_lr(self, r: int, c: int) -> None:
        hdr = self.hdr
        lr = getattr(hdr, "lr", None)
        if lr is None or not lr.uses_lr \
                or getattr(hdr, "allow_intrabc", False):
            return
        w4 = 1 << (5 if self.seq.use_128x128_superblock else 4)
        for plane in range(self.seq.color.num_planes):
            if lr.frame_restoration_type[plane] == C.RESTORE_NONE:
                continue
            ssx = self.seq.color.subsampling_x if plane else 0
            ssy = self.seq.color.subsampling_y if plane else 0
            unit_size = lr.loop_restoration_size[plane]
            ph = (hdr.frame_height + ssy) >> ssy
            pw = (hdr.upscaled_width + ssx) >> ssx
            unit_rows = max((ph + (unit_size >> 1)) // unit_size, 1)
            unit_cols = max((pw + (unit_size >> 1)) // unit_size, 1)
            # no superres: numerator = MI_SIZE >> ss, denominator = unit
            num = 4 >> ssy
            den = unit_size
            ur0 = (r * num + den - 1) // den
            ur1 = min(unit_rows, ((r + w4) * num + den - 1) // den)
            num = 4 >> ssx
            uc0 = (c * num + den - 1) // den
            uc1 = min(unit_cols, ((c + w4) * num + den - 1) // den)
            for urow in range(ur0, ur1):
                for ucol in range(uc0, uc1):
                    self._read_lr_unit(plane, urow, ucol)

    def _read_lr_unit(self, plane: int, urow: int, ucol: int) -> None:
        hdr = self.hdr
        msac = self.msac
        frt = hdr.lr.frame_restoration_type[plane]
        if frt == C.RESTORE_WIENER:
            rtype = (C.RESTORE_WIENER
                     if msac.decode_symbol(self.cdf["wiener_restore"][0])
                     else C.RESTORE_NONE)
        elif frt == C.RESTORE_SGRPROJ:
            rtype = (C.RESTORE_SGRPROJ
                     if msac.decode_symbol(self.cdf["sgrproj_restore"][0])
                     else C.RESTORE_NONE)
        else:
            rtype = [C.RESTORE_NONE, C.RESTORE_WIENER, C.RESTORE_SGRPROJ][
                msac.decode_symbol(self.cdf["switchable_restore"][0])]
        self.plan.lr_type[(plane, urow, ucol)] = rtype
        if rtype == C.RESTORE_WIENER:
            taps = [[0, 0, 0], [0, 0, 0]]
            for p in range(2):
                first = 1 if plane else 0
                for j in range(first, 3):
                    ref = self.lr_ref_wiener[plane][p][j]
                    v = msac.decode_signed_subexp_with_ref(
                        _WIENER_TAPS_MIN[j], _WIENER_TAPS_MAX[j] + 1,
                        ref, _WIENER_TAPS_K[j])
                    taps[p][j] = v
                    self.lr_ref_wiener[plane][p][j] = v
            self.plan.lr_wiener[(plane, urow, ucol)] = taps
        elif rtype == C.RESTORE_SGRPROJ:
            sgr_set = msac.decode_literal(4)
            xqd = [0, 0]
            for i in range(2):
                radius = _SGR_RADII[sgr_set][i]
                ref = self.lr_ref_sgr[plane][i]
                if radius:
                    v = msac.decode_signed_subexp_with_ref(
                        _SGRPROJ_XQD_MIN[i], _SGRPROJ_XQD_MAX[i] + 1,
                        ref, 4)
                else:
                    v = 0
                    if i == 1:
                        # (1 << SGRPROJ_PRJ_BITS) - xqd0, clipped
                        v = max(_SGRPROJ_XQD_MIN[i],
                                min(_SGRPROJ_XQD_MAX[i],
                                    128 - self.lr_ref_sgr[plane][0]))
                xqd[i] = v
                self.lr_ref_sgr[plane][i] = v
            self.plan.lr_sgr[(plane, urow, ucol)] = (sgr_set, xqd[0], xqd[1])

    # -- partition tree ----------------------------------------------------

    def _decode_partition(self, r: int, c: int, bsize: int) -> None:
        if r >= self.mi_row_end or c >= self.mi_col_end:
            return
        w4 = C.BLOCK_W4[bsize]
        half = w4 >> 1
        has_rows = (r + half) < self.mi_row_end
        has_cols = (c + half) < self.mi_col_end
        bsl = mi_wlog2(bsize)

        if bsize == C.BLOCK_4X4:
            partition = C.PARTITION_NONE
        elif has_rows and has_cols:
            above = (int(self.a_part[c]) >> bsl) & 1
            left = (int(self.l_part[r]) >> bsl) & 1
            ctx = left * 2 + above
            row_idx = (bsl - 1) * 4 + ctx
            nsym = 4 if bsize == C.BLOCK_8X8 else (
                8 if bsize == C.BLOCK_128X128 else 10)
            cdf_row = self.cdf["partition"][row_idx]
            partition = self._decode_ragged(cdf_row, nsym)
        elif has_cols:
            # bottom edge: HORZ vs SPLIT via derived bool
            partition = (C.PARTITION_SPLIT if self._split_or(
                r, c, bsize, bsl, horz=True) else C.PARTITION_HORZ)
        elif has_rows:
            partition = (C.PARTITION_SPLIT if self._split_or(
                r, c, bsize, bsl, horz=False) else C.PARTITION_VERT)
        else:
            partition = C.PARTITION_SPLIT

        if not hasattr(self.plan, "part_log"):
            self.plan.part_log = []
        self.plan.part_log.append((r, c, bsize, partition))
        self._cur_partition = partition
        sub = partition_subsize(partition, bsize) if bsize >= C.BLOCK_8X8 \
            else bsize
        half_px = half
        q = half >> 1

        if partition == C.PARTITION_NONE:
            self._decode_block(r, c, sub)
        elif partition == C.PARTITION_HORZ:
            self._decode_block(r, c, sub)
            if has_rows:
                self._decode_block(r + half, c, sub)
        elif partition == C.PARTITION_VERT:
            self._decode_block(r, c, sub)
            if has_cols:
                self._decode_block(r, c + half, sub)
        elif partition == C.PARTITION_SPLIT:
            self._decode_partition(r, c, sub)
            self._decode_partition(r, c + half, sub)
            self._decode_partition(r + half, c, sub)
            self._decode_partition(r + half, c + half, sub)
        elif partition == C.PARTITION_HORZ_A:
            sq = partition_subsize(C.PARTITION_SPLIT, bsize)
            self._decode_block(r, c, sq)
            self._decode_block(r, c + half, sq)
            self._decode_block(r + half, c, sub)
        elif partition == C.PARTITION_HORZ_B:
            sq = partition_subsize(C.PARTITION_SPLIT, bsize)
            self._decode_block(r, c, sub)
            self._decode_block(r + half, c, sq)
            self._decode_block(r + half, c + half, sq)
        elif partition == C.PARTITION_VERT_A:
            sq = partition_subsize(C.PARTITION_SPLIT, bsize)
            self._decode_block(r, c, sq)
            self._decode_block(r + half, c, sq)
            self._decode_block(r, c + half, sub)
        elif partition == C.PARTITION_VERT_B:
            sq = partition_subsize(C.PARTITION_SPLIT, bsize)
            self._decode_block(r, c, sub)
            self._decode_block(r, c + half, sq)
            self._decode_block(r + half, c + half, sq)
        elif partition == C.PARTITION_HORZ_4:
            for i in range(4):
                rr = r + i * q
                if rr >= self.mi_row_end:
                    break
                self._decode_block(rr, c, sub)
        elif partition == C.PARTITION_VERT_4:
            for i in range(4):
                cc = c + i * q
                if cc >= self.mi_col_end:
                    break
                self._decode_block(r, cc, sub)

        # partition context update (libaom update_ext_partition_context)
        if bsize >= C.BLOCK_8X8:
            if partition == C.PARTITION_SPLIT and bsize != C.BLOCK_8X8:
                pass  # handled by recursion
            elif partition in (C.PARTITION_HORZ_A, C.PARTITION_HORZ_B,
                               C.PARTITION_VERT_A, C.PARTITION_VERT_B):
                sq = partition_subsize(C.PARTITION_SPLIT, bsize)
                if partition == C.PARTITION_HORZ_A:
                    self._update_part_ctx(r, c, sq, sub)
                    self._update_part_ctx(r + half, c, sub, sub)
                elif partition == C.PARTITION_HORZ_B:
                    self._update_part_ctx(r, c, sub, sub)
                    self._update_part_ctx(r + half, c, sq, sub)
                elif partition == C.PARTITION_VERT_A:
                    self._update_part_ctx(r, c, sq, sub)
                    self._update_part_ctx(r, c + half, sub, sub)
                else:
                    self._update_part_ctx(r, c, sub, sub)
                    self._update_part_ctx(r, c + half, sq, sub)
            else:
                self._update_part_ctx(r, c, sub, bsize)

    def _update_part_ctx(self, r, c, subsize, bsize):
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        self.a_part[c:c + w4] = _PART_ABOVE[subsize]
        self.l_part[r:r + h4] = _PART_LEFT[subsize]

    def _decode_ragged(self, cdf_row: list, nsym: int) -> int:
        """Decode from a CDF row stored wider than its symbol count."""
        if len(cdf_row) == nsym + 1:
            return self.msac.decode_symbol(cdf_row)
        sub = cdf_row[:nsym - 1] + [0, cdf_row[-1]]
        sym = self.msac.decode_symbol(sub)
        cdf_row[:nsym - 1] = sub[:nsym - 1]
        cdf_row[-1] = sub[-1]
        return sym

    def _split_or(self, r, c, bsize, bsl, horz: bool) -> bool:
        """Edge partitions: derive P(split) by gathering partition-cdf mass
        (spec §9.3 split_or_horz / split_or_vert)."""
        above = (int(self.a_part[c]) >> bsl) & 1
        left = (int(self.l_part[r]) >> bsl) & 1
        ctx = left * 2 + above
        row_idx = (bsl - 1) * 4 + ctx
        cdf_row = self.cdf["partition"][row_idx]
        psplit = self.edge_split_prob(cdf_row, bsize, horz)
        return bool(self.msac.decode_bool(psplit))

    @staticmethod
    def edge_split_prob(cdf_row, bsize, horz: bool) -> int:
        """Edge-partition split probability: the bool is 'does the VISIBLE
        half contain a mid-edge', so psplit = 32768 - P{types whose visible
        half is unsplit}: {NONE, dir, dir_B, dir_4} (dir = HORZ for the
        bottom edge, VERT for the right edge; dir_B's second split lies in
        the hidden half).  Calibrated bit-exactly against dav1d via
        pristine-state probability sweeps."""
        if horz:
            parts = [C.PARTITION_NONE, C.PARTITION_HORZ]
            extra = [C.PARTITION_HORZ_B, C.PARTITION_HORZ_4]
        else:
            parts = [C.PARTITION_NONE, C.PARTITION_VERT]
            extra = [C.PARTITION_VERT_B, C.PARTITION_VERT_4]
        if bsize == C.BLOCK_8X8:
            nsym = 4
        elif bsize == C.BLOCK_128X128:
            nsym = 8
            parts += extra[:1]
        else:
            nsym = 10
            parts += extra
        return 32768 - TileDecoder._gather(cdf_row, parts, nsym)

    @staticmethod
    def _gather(cdf_row: list, symbols: list, nsym: int) -> int:
        """Sum of P(symbol) in q15 from an icdf row."""
        total = 0
        for s in symbols:
            hi = 32768 if s == 0 else cdf_row[s - 1]
            lo = 0 if s >= nsym - 1 else cdf_row[s]
            if s == nsym - 1:
                lo = 0
            total += hi - lo
        return total

    # -- block decode ------------------------------------------------------

    def _decode_block(self, r: int, c: int, bsize: int) -> None:
        import os
        if os.environ.get("BLK_LOG"):
            print(f"DECBLK ({r},{c}) bs={bsize} @{self.msac.bit_pos}")
        w4 = min(C.BLOCK_W4[bsize], self.mi_col_end - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_row_end - r)
        full_w4 = C.BLOCK_W4[bsize]
        full_h4 = C.BLOCK_H4[bsize]
        plan = self.plan
        msac = self.msac
        hdr = self.hdr

        avail_u = r > self.mi_row_start
        avail_l = c > self.mi_col_start

        # HasChroma (spec 5.11.15)
        has_chroma = self.num_planes > 1
        if has_chroma:
            if self.ssy and full_h4 == 1 and (r & 1) == 0:
                has_chroma = False
            if self.ssx and full_w4 == 1 and (c & 1) == 0:
                has_chroma = False

        # skip mode (spec read_skip_mode), then skip
        self.skip_mode_flag = False
        if (not hdr.frame_is_intra and hdr.skip_mode_present
                and C.BLOCK_W4[bsize] * 4 >= 8
                and C.BLOCK_H4[bsize] * 4 >= 8):
            sm_ctx = 0
            if avail_u:
                sm_ctx += int(self.skip_mode_g[r - 1, c])
            if avail_l:
                sm_ctx += int(self.skip_mode_g[r, c - 1])
            self.skip_mode_flag = bool(
                msac.decode_symbol(self.cdf["skip_mode"][sm_ctx]))
        if self.skip_mode_flag:
            skip = 1
        else:
            skip_ctx = 0
            if avail_u:
                skip_ctx += int(self.a_skip[c])
            if avail_l:
                skip_ctx += int(self.l_skip[r])
            skip = msac.decode_symbol(self.cdf["skip"][skip_ctx])

        # cdef index (spec read_cdef): ONE literal at the block's anchor
        # 64x64 unit, copied to every unit the block covers — a 128px
        # block reads a single cdef_idx, not four
        hdr = self.hdr
        if (not skip and self.seq.enable_cdef
                and not hdr.coded_lossless
                and not getattr(hdr, "allow_intrabc", False)):
            mask = ~15
            r1 = r & mask
            c1 = c & mask
            if self.plan.cdef_idx.get((r1, c1), -1) == -1:
                v = msac.decode_literal(hdr.cdef.bits)
                for rr in range(r1, r + C.BLOCK_H4[bsize], 16):
                    for cc in range(c1, c + C.BLOCK_W4[bsize], 16):
                        self.plan.cdef_idx[(rr, cc)] = v

        # deltas (delta_q / delta_lf) — read at first block of superblock
        if self.read_deltas:
            self._delta_rc = (r, c)
            self._read_deltas(bsize, skip)
        self.read_deltas = False

        # mode info: keyframe intra, inter-frame intra, or inter
        use_intrabc = False
        if hdr.frame_is_intra:
            is_inter = False
            if getattr(hdr, "allow_intrabc", False):
                use_intrabc = bool(
                    msac.decode_symbol(self.cdf["intrabc"][0]))
        else:
            is_inter = self._read_is_inter(r, c, bsize, skip, avail_u,
                                           avail_l)

        if use_intrabc:
            # intra block copy (spec 5.11.19 read_intrabc_info, libaom
            # decodemv.c read_intrabc_info / assign_dv): DC modes,
            # BILINEAR filter, DV from the INTRA_FRAME mv stack with a
            # fixed fallback, coded with the dedicated ndv contexts at
            # forced integer precision
            y_mode = uv_mode = C.DC_PRED
            angle_y = angle_uv = 0
            cfl_alpha_u = cfl_alpha_v = 0
            use_filter_intra = False
            filter_intra_mode = 0
            ref_frame = (C.INTRA_FRAME, C.NONE_FRAME)
            block_mode = C.NEWMV
            interp = (C.BILINEAR, C.BILINEAR)
            st = self.refmv.find(r, c, bsize, ref_frame, False)

            def _lower(m):
                return tuple(v + (-1 if v > 0 else 1) if (v & 1) else v
                             for v in m)

            dv_ref = _lower(st.mvs[0][0])
            if dv_ref == (0, 0):
                dv_ref = _lower(st.mvs[1][0])
            if dv_ref == (0, 0):
                # av1_find_ref_dv: one SB up, or (left - 256px) in the
                # first SB row of the tile
                mib = 32 if self.seq.use_128x128_superblock else 16
                if r - mib < self.mi_row_start:
                    dv_ref = (0, (-4 * mib - 256) * 8)
                else:
                    dv_ref = (-4 * mib * 8, 0)
            dv_ref = ((dv_ref[0] >> 3) * 8, (dv_ref[1] >> 3) * 8)
            mv = self._read_mv(dv_ref, prefix="dv", force_int=True)
            is_inter = True
            self._last_ref_mv_idx = 0
            self._last_motion_mode = C.SIMPLE
            self._last_warp = None
            self._last_mv2 = (0, 0)
            self._last_comp = (0, 1, 0, 0, 0, 0)
            self._last_interintra = (-1, 0, 0)
        elif not is_inter:
            (y_mode, angle_y, uv_mode, angle_uv, cfl_alpha_u, cfl_alpha_v,
             use_filter_intra, filter_intra_mode) = \
                self._intra_mode_info(r, c, bsize, has_chroma, avail_u,
                                      avail_l)
            ref_frame = (C.INTRA_FRAME, C.NONE_FRAME)
            mv = (0, 0)
            interp = (C.EIGHTTAP, C.EIGHTTAP)
            block_mode = y_mode
        else:
            (block_mode, ref_frame, mv, interp) = \
                self._inter_mode_info(r, c, bsize, avail_u, avail_l)
            y_mode = C.DC_PRED
            uv_mode = C.DC_PRED
            angle_y = angle_uv = 0
            cfl_alpha_u = cfl_alpha_v = 0
            use_filter_intra = False
            filter_intra_mode = 0

        # record mode info
        self._cur_block = BlockRecord(
            r=r, c=c, bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
            partition=getattr(self, "_cur_partition", 0),
            skip_mode=bool(self.skip_mode_flag),
            angle_y=angle_y, angle_uv=angle_uv, skip=bool(skip),
            tx_size=0, uv_tx_size=0, has_chroma=has_chroma,
            cfl_alphas=((cfl_alpha_u, cfl_alpha_v)
                        if uv_mode == C.UV_CFL_PRED else None),
            filter_intra=filter_intra_mode if use_filter_intra else None,
            is_inter=is_inter, ref_frame=ref_frame, mv=mv,
            interp_filter=interp,
            inter_mode=block_mode if is_inter else 0,
            ref_mv_idx=getattr(self, "_last_ref_mv_idx", 0)
            if is_inter else 0,
            motion_mode=getattr(self, "_last_motion_mode", C.SIMPLE)
            if is_inter else C.SIMPLE,
            warp=getattr(self, "_last_warp", None) if is_inter else None,
            mv2=getattr(self, "_last_mv2", (0, 0)) if is_inter else (0, 0),
            compound_type=getattr(self, "_last_comp",
                                  (0, 1, 0, 0, 0, 0))[2]
            if is_inter else 0,
            compound_idx=getattr(self, "_last_comp",
                                 (0, 1, 0, 0, 0, 0))[1]
            if is_inter else 1,
            wedge_idx=getattr(self, "_last_comp", (0, 1, 0, 0, 0, 0))[3]
            if is_inter else 0,
            wedge_sign=getattr(self, "_last_comp", (0, 1, 0, 0, 0, 0))[4]
            if is_inter else 0,
            mask_type=getattr(self, "_last_comp", (0, 1, 0, 0, 0, 0))[5]
            if is_inter else 0,
            interintra_mode=getattr(self, "_last_interintra",
                                    (-1, 0, 0))[0] if is_inter else -1,
            ii_wedge=getattr(self, "_last_interintra", (-1, 0, 0))[1]
            if is_inter else 0,
            ii_wedge_idx=getattr(self, "_last_interintra", (-1, 0, 0))[2]
            if is_inter else 0,
        )
        plan.blocks.append(self._cur_block)

        # palette tokens (spec: right after mode info, before tx size)
        palette = getattr(self, "_last_palette", None) \
            if not is_inter else None
        self._last_palette = None
        if palette is not None:
            pal_y, pal_cb, pal_cr = palette
            on_w4 = min(full_w4, self.mi_cols - c)
            on_h4 = min(full_h4, self.mi_rows - r)
            map_y = map_uv = None
            if pal_y is not None:
                map_y = self._read_palette_map(len(pal_y), on_w4 * 4,
                                               on_h4 * 4, uv=False)
            if pal_cb is not None:
                cw4 = max(1, (on_w4 + self.ssx) >> self.ssx)
                ch4 = max(1, (on_h4 + self.ssy) >> self.ssy)
                map_uv = self._read_palette_map(len(pal_cb), cw4 * 4,
                                                ch4 * 4, uv=True)
            plan.palette[(r, c)] = (pal_y, pal_cb, pal_cr, map_y, map_uv)

        plan.y_mode[r:r + h4, c:c + w4] = y_mode
        plan.uv_mode[r:r + h4, c:c + w4] = uv_mode
        plan.angle_y[r:r + h4, c:c + w4] = angle_y
        plan.angle_uv[r:r + h4, c:c + w4] = angle_uv
        plan.skip[r:r + h4, c:c + w4] = skip
        plan.bsize[r:r + h4, c:c + w4] = bsize
        if uv_mode == C.UV_CFL_PRED:
            plan.cfl_alphas[(r, c)] = (cfl_alpha_u, cfl_alpha_v)
        if use_filter_intra:
            plan.filter_intra[(r, c)] = filter_intra_mode

        # inter decode-state grids (scans by later blocks)
        self.ref_frames0[r:r + h4, c:c + w4] = ref_frame[0]
        self.ref_frames1[r:r + h4, c:c + w4] = ref_frame[1]
        self.mvs[r:r + h4, c:c + w4, 0, 0] = mv[0]
        self.mvs[r:r + h4, c:c + w4, 0, 1] = mv[1]
        mv2g = getattr(self, "_last_mv2", (0, 0)) if is_inter else (0, 0)
        self.mvs[r:r + h4, c:c + w4, 1, 0] = mv2g[0]
        self.mvs[r:r + h4, c:c + w4, 1, 1] = mv2g[1]
        comp = getattr(self, "_last_comp", (0, 1, 0, 0, 0, 0)) \
            if is_inter else (0, 1, 0, 0, 0, 0)
        self.comp_group_grid[r:r + h4, c:c + w4] = comp[0]
        self.comp_idx_grid[r:r + h4, c:c + w4] = comp[1]
        self.modes[r:r + h4, c:c + w4] = block_mode
        self.interp[r:r + h4, c:c + w4, 0] = interp[0]
        self.interp[r:r + h4, c:c + w4, 1] = interp[1]
        self.decoded_mi[r:r + h4, c:c + w4] = True
        self.skip_mode_g[r:r + h4, c:c + w4] = int(self.skip_mode_flag)
        self.intrabc_g[r:r + h4, c:c + w4] = use_intrabc

        # tx size + residual
        if not is_inter:
            tx_size = self._read_tx_size(r, c, bsize, skip, avail_u,
                                         avail_l)
            self._cur_block.tx_size = tx_size
            self._cur_block.uv_tx_size = (self._uv_tx_size(bsize)
                                          if has_chroma else 0)
            if not skip:
                self._residual(r, c, bsize, tx_size, has_chroma)
            else:
                self._clear_coef_ctx(r, c, bsize, tx_size, has_chroma)
            self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
            self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]
        else:
            tx_size = T.MAX_TX_SIZE_RECT[bsize]
            if hdr.coded_lossless:
                tx_size = C.TX_4X4
            self._cur_block.uv_tx_size = (self._uv_tx_size(bsize)
                                          if has_chroma else 0)
            if skip or hdr.tx_mode != C.TX_MODE_SELECT \
                    or hdr.coded_lossless:
                # uniform max tx; txfm ctx arrays get the full dims
                self._cur_block.tx_size = tx_size
                var_txs = [(xx, yy, tx_size)
                           for yy in range(0, min(h4, self.mi_row_end - r),
                                           T.TX_H4[tx_size])
                           for xx in range(0, min(w4, self.mi_col_end - c),
                                           T.TX_W4[tx_size])]
                if skip:
                    # skipped inter blocks publish the BLOCK dims to the
                    # txfm-split contexts (libaom set_txfm_ctxs)
                    self.a_txw[c:c + w4] = C.BLOCK_W4[bsize] * 4
                    self.l_txh[r:r + h4] = C.BLOCK_H4[bsize] * 4
                else:
                    self.a_txw[c:c + w4] = T.TX_WIDTH[tx_size]
                    self.l_txh[r:r + h4] = T.TX_HEIGHT[tx_size]
            else:
                var_txs = self._read_var_tx(r, c, bsize)
                self._cur_block.tx_size = tx_size  # max (for lf grids)
            self._cur_block.var_txs = var_txs
            if not skip:
                self._residual_inter(r, c, bsize, var_txs, has_chroma)
            else:
                self._clear_coef_ctx(r, c, bsize, tx_size, has_chroma)

        # context updates
        self.a_mode[c:c + w4] = y_mode if not is_inter else C.DC_PRED
        self.l_mode[r:r + h4] = y_mode if not is_inter else C.DC_PRED
        self.a_skip[c:c + w4] = skip
        self.l_skip[r:r + h4] = skip
        # palette size/color contexts (zeroed for non-palette blocks)
        pal_y = pal_cb = pal_cr = None
        if palette is not None:
            pal_y, pal_cb, pal_cr = palette
        self.a_pal_sz[0][c:c + w4] = len(pal_y) if pal_y else 0
        self.l_pal_sz[0][r:r + h4] = len(pal_y) if pal_y else 0
        self.a_pal_sz[1][c:c + w4] = len(pal_cb) if pal_cb else 0
        self.l_pal_sz[1][r:r + h4] = len(pal_cb) if pal_cb else 0
        if pal_y:
            self.a_pal[0][c:c + w4, :len(pal_y)] = pal_y
            self.l_pal[0][r:r + h4, :len(pal_y)] = pal_y
        if pal_cb:
            self.a_pal[1][c:c + w4, :len(pal_cb)] = pal_cb
            self.l_pal[1][r:r + h4, :len(pal_cb)] = pal_cb
        if pal_cr:
            self.a_pal[2][c:c + w4, :len(pal_cr)] = pal_cr
            self.l_pal[2][r:r + h4, :len(pal_cr)] = pal_cr

    # -- intra mode info (both frame types) ---------------------------------

    def _intra_mode_info(self, r, c, bsize, has_chroma, avail_u, avail_l):
        msac = self.msac
        hdr = self.hdr
        if hdr.frame_is_intra:
            above_mode = int(self.a_mode[c]) if avail_u else C.DC_PRED
            left_mode = int(self.l_mode[r]) if avail_l else C.DC_PRED
            actx = T.INTRA_MODE_CONTEXT[above_mode]
            lctx = T.INTRA_MODE_CONTEXT[left_mode]
            y_mode = msac.decode_symbol(self.cdf["kf_y_mode"][actx][lctx])
        else:
            y_mode = msac.decode_symbol(
                self.cdf["y_mode"][SIZE_GROUP[bsize]])

        angle_y = 0
        if bsize >= C.BLOCK_8X8 and C.V_PRED <= y_mode <= C.D67_PRED:
            angle_y = msac.decode_symbol(
                self.cdf["angle_delta"][y_mode - C.V_PRED]) - 3

        uv_mode = C.DC_PRED
        angle_uv = 0
        cfl_alpha_u = cfl_alpha_v = 0
        if has_chroma:
            if self.hdr.coded_lossless:
                # lossless: CfL only when the chroma plane block is 4x4
                # (libaom is_cfl_allowed; spec get_plane_residual_size)
                cfl_allowed = (max(1, C.BLOCK_W4[bsize] >> self.ssx) == 1
                               and max(1, C.BLOCK_H4[bsize] >> self.ssy)
                               == 1)
            else:
                cfl_allowed = (C.BLOCK_W4[bsize] * 4 <= 32
                               and C.BLOCK_H4[bsize] * 4 <= 32)
            row = self.cdf["uv_mode"][1 if cfl_allowed else 0][y_mode]
            nsym = 14 if cfl_allowed else 13
            uv_mode = self._decode_ragged(row, nsym)
            if uv_mode == C.UV_CFL_PRED:
                sign_joint = msac.decode_symbol(self.cdf["cfl_sign"][0])
                cfl_alpha_u, cfl_alpha_v = self._read_cfl_alphas(sign_joint)
            if bsize >= C.BLOCK_8X8 and C.V_PRED <= uv_mode <= C.D67_PRED:
                angle_uv = msac.decode_symbol(
                    self.cdf["angle_delta"][uv_mode - C.V_PRED]) - 3

        # palette (spec palette_mode_info, dav1d read_pal_plane/uv)
        self._last_palette = None
        hdr = self.hdr
        if (getattr(hdr, "allow_screen_content_tools", False)
                and bsize >= C.BLOCK_8X8
                and C.BLOCK_W4[bsize] * 4 <= 64
                and C.BLOCK_H4[bsize] * 4 <= 64):
            sz_ctx = mi_wlog2(bsize) + mi_hlog2(bsize) - 2
            pal_y = None
            pal_cb = pal_cr = None
            if y_mode == C.DC_PRED:
                pctx = int(int(self.a_pal_sz[0][c]) > 0) \
                    + int(int(self.l_pal_sz[0][r]) > 0)
                if msac.decode_symbol(
                        self.cdf["palette_y_mode"][sz_ctx][pctx]):
                    n = msac.decode_symbol(
                        self.cdf["palette_y_size"][sz_ctx]) + 2
                    pal_y = self._read_palette_colors(0, r, c, n)
            if has_chroma and uv_mode == C.DC_PRED:
                pctx = int(pal_y is not None)
                if msac.decode_symbol(self.cdf["palette_uv_mode"][pctx]):
                    n = msac.decode_symbol(
                        self.cdf["palette_uv_size"][sz_ctx]) + 2
                    pal_cb = self._read_palette_colors(1, r, c, n)
                    pal_cr = self._read_palette_cr(n)
            if pal_y is not None or pal_cb is not None:
                self._last_palette = (pal_y, pal_cb, pal_cr)

        use_filter_intra = False
        filter_intra_mode = 0
        if (self.seq.enable_filter_intra and y_mode == C.DC_PRED
                and (self._last_palette is None
                     or self._last_palette[0] is None)
                and C.BLOCK_W4[bsize] * 4 <= 32
                and C.BLOCK_H4[bsize] * 4 <= 32):
            use_filter_intra = bool(msac.decode_symbol(
                self.cdf["filter_intra_use"][bsize]))
            if use_filter_intra:
                filter_intra_mode = msac.decode_symbol(
                    self.cdf["filter_intra_mode"][0])
        return (y_mode, angle_y, uv_mode, angle_uv, cfl_alpha_u,
                cfl_alpha_v, use_filter_intra, filter_intra_mode)

    # -- palette (spec 5.11.46-52, dav1d decode.c read_pal_*) --------------

    def _read_palette_colors(self, plane, r, c, n):
        """Y (plane 0) / CB (plane 1) palette colors: cache-reuse bools,
        then ascending delta coding; returns the merged sorted list."""
        msac = self.msac
        bd = self.seq.color.bitdepth
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
        used = []
        for cval in cache:
            if len(used) >= n:
                break
            if msac.decode_bool_equi():
                used.append(cval)
        if len(used) == n:
            return list(used)
        mind = 1 if plane == 0 else 0
        mx = (1 << bd) - 1
        new = [msac.decode_literal(bd)]
        if len(used) + len(new) < n:
            bits = bd - 3 + msac.decode_literal(2)
            prev = new[0]
            while len(used) + len(new) < n:
                delta = msac.decode_literal(bits) + mind
                prev = min(prev + delta, mx)
                new.append(prev)
                if prev + mind >= mx:
                    while len(used) + len(new) < n:
                        new.append(mx)
                    break
                bits = min(bits, 1 + (mx - prev - mind).bit_length() - 1)
        # merge two ascending lists
        out = []
        ui = ni = 0
        while ui < len(used) and ni < len(new):
            if used[ui] <= new[ni]:
                out.append(used[ui])
                ui += 1
            else:
                out.append(new[ni])
                ni += 1
        out.extend(used[ui:])
        out.extend(new[ni:])
        return out

    def _read_palette_cr(self, n):
        """CR palette: optional wraparound signed-delta coding."""
        msac = self.msac
        bd = self.seq.color.bitdepth
        mx = (1 << bd) - 1
        if msac.decode_bool_equi():
            bits = bd - 4 + msac.decode_literal(2)
            prev = msac.decode_literal(bd)
            out = [prev]
            for _ in range(n - 1):
                delta = msac.decode_literal(bits)
                if delta and msac.decode_bool_equi():
                    delta = -delta
                prev = (prev + delta) & mx
                out.append(prev)
            return out
        return [msac.decode_literal(bd) for _ in range(n)]

    def _read_palette_map(self, n, w, h, uv):
        """Color index map over (h, w) pixels: NS first symbol, then
        wave-front diagonals with neighbor-ordered symbols (dav1d
        read_pal_indices/order_palette)."""
        msac = self.msac
        m = np.zeros((h, w), np.int32)
        m[0, 0] = msac._decode_ns(n)
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
                    elif top == tl or lft == tl:
                        ctx = 2
                        order0 = [tl, lft if top == tl else top]
                    else:
                        ctx = 1
                        # score sort with ties broken by color value
                        # (libaom av1_get_palette_color_index_context):
                        # left/top both score 2 -> smaller color first
                        order0 = [min(lft, top), max(lft, top), tl]
                order = order0 + [k for k in range(8)
                                  if k not in order0]
                sym = self._decode_ragged(cdfs[ctx], n)
                m[y, x] = order[sym]
        return m

    # -- inter mode info ------------------------------------------------------

    def _read_is_inter(self, r, c, bsize, skip, avail_u, avail_l):
        if self.skip_mode_flag:
            return True
        # ctx from neighbor intra/inter (spec intra_inter ctx)
        if avail_u and avail_l:
            above_intra = int(self.ref_frames0[r - 1, c]) == C.INTRA_FRAME
            left_intra = int(self.ref_frames0[r, c - 1]) == C.INTRA_FRAME
            ctx = 3 if (above_intra and left_intra) else \
                int(above_intra or left_intra)
        elif avail_u or avail_l:
            nb_intra = (int(self.ref_frames0[r - 1, c]) == C.INTRA_FRAME
                        if avail_u
                        else int(self.ref_frames0[r, c - 1])
                        == C.INTRA_FRAME)
            ctx = 2 * int(nb_intra)
        else:
            ctx = 0
        return bool(self.msac.decode_symbol(self.cdf["intra_inter"][ctx]))

    def _count_refs(self, r, c, avail_u, avail_l):
        counts = [0] * 8
        for rr, cc, av in ((r - 1, c, avail_u), (r, c - 1, avail_l)):
            if not av:
                continue
            f0 = int(self.ref_frames0[rr, cc])
            f1 = int(self.ref_frames1[rr, cc])
            if f0 > C.INTRA_FRAME:
                counts[f0] += 1
            if f1 > C.INTRA_FRAME:
                counts[f1] += 1
        return counts

    @staticmethod
    def _ref_ctx(c0, c1):
        if c0 == c1:
            return 1
        return 0 if c0 < c1 else 2

    def _is_backward(self, ref):
        return C.BWDREF_FRAME <= ref <= C.ALTREF_FRAME

    def _nb_info(self, rr, cc):
        """(ref0, ref1, is_inter, has_second, is_uni_comp) of neighbor."""
        f0 = int(self.ref_frames0[rr, cc])
        f1 = int(self.ref_frames1[rr, cc])
        is_inter = f0 > C.INTRA_FRAME
        has2 = f1 > C.INTRA_FRAME
        uni = has2 and not (self._is_backward(f0) ^ self._is_backward(f1))
        return f0, f1, is_inter, has2, uni

    def _compound_mode_ctx(self, st, r, c):
        """Context for the inter_compound_mode symbol (libaom
        compound_mode_ctx_map in av1_mode_context_analyzer)."""
        return self._COMP_MODE_CTX_MAP[st.ref_mv_ctx >> 1][
            min(st.new_mv_ctx, 4)]

    def _comp_mode_ctx(self, r, c, avail_u, avail_l):
        """libaom av1_get_reference_mode_context."""
        bw = self._is_backward
        if avail_u and avail_l:
            a0, a1, ainter, a2, _ = self._nb_info(r - 1, c)
            l0, l1, linter, l2, _ = self._nb_info(r, c - 1)
            if not a2 and not l2:
                return int(bw(a0)) ^ int(bw(l0))
            if not a2:
                return 2 + int(bw(a0) or not ainter)
            if not l2:
                return 2 + int(bw(l0) or not linter)
            return 4
        if avail_u or avail_l:
            e0, e1, einter, e2, _ = self._nb_info(
                r - 1 if avail_u else r, c if avail_u else c - 1)
            if not e2:
                return int(bw(e0))
            return 3
        return 1

    def _comp_ref_type_ctx(self, r, c, avail_u, avail_l):
        """libaom av1_get_comp_reference_type_context."""
        bw = self._is_backward
        if avail_u and avail_l:
            a0, a1, ainter, a2, auni = self._nb_info(r - 1, c)
            l0, l1, linter, l2, luni = self._nb_info(r, c - 1)
            if not ainter and not linter:
                return 2
            if not ainter or not linter:
                i0, i1, _, i2, iuni = (self._nb_info(r, c - 1) if not ainter
                                       else self._nb_info(r - 1, c))
                if not i2:
                    return 2
                return 1 + 2 * int(iuni)
            a_sg = not a2
            l_sg = not l2
            if a_sg and l_sg:
                return 1 + 2 * int(not (bw(a0) ^ bw(l0)))
            if a_sg or l_sg:
                # one single, one compound
                cuni = luni if a_sg else auni
                if not cuni:
                    return 1
                return 3 + int(not (bw(a0) ^ bw(l0)))
            # both compound
            if not auni and not luni:
                return 0
            if not auni or not luni:
                return 2
            return 3 + int((a0 == C.BWDREF_FRAME) == (l0 == C.BWDREF_FRAME))
        if avail_u or avail_l:
            e0, e1, einter, e2, euni = self._nb_info(
                r - 1 if avail_u else r, c if avail_u else c - 1)
            if not einter:
                return 2
            if not e2:
                return 2
            return 4 * int(euni)
        return 2

    def _comp_group_ctx(self, r, c, avail_u, avail_l):
        """libaom get_comp_group_idx_context."""
        above = left = 0
        if avail_u:
            if int(self.ref_frames1[r - 1, c]) > C.INTRA_FRAME:
                above = int(self.comp_group_grid[r - 1, c])
            elif int(self.ref_frames0[r - 1, c]) == C.ALTREF_FRAME:
                above = 3
        if avail_l:
            if int(self.ref_frames1[r, c - 1]) > C.INTRA_FRAME:
                left = int(self.comp_group_grid[r, c - 1])
            elif int(self.ref_frames0[r, c - 1]) == C.ALTREF_FRAME:
                left = 3
        return min(5, above + left)

    def _comp_index_ctx(self, r, c, ref_frame, avail_u, avail_l):
        """libaom get_comp_index_context."""
        hdr = self.hdr
        fwd = abs(self.refmv._rel_dist_pub(
            hdr.order_hints[ref_frame[1]], hdr.order_hint))
        bck = abs(self.refmv._rel_dist_pub(
            hdr.order_hint, hdr.order_hints[ref_frame[0]]))
        above = left = 0
        if avail_u:
            if int(self.ref_frames1[r - 1, c]) > C.INTRA_FRAME:
                above = int(self.comp_idx_grid[r - 1, c])
            elif int(self.ref_frames0[r - 1, c]) == C.ALTREF_FRAME:
                above = 1
        if avail_l:
            if int(self.ref_frames1[r, c - 1]) > C.INTRA_FRAME:
                left = int(self.comp_idx_grid[r, c - 1])
            elif int(self.ref_frames0[r, c - 1]) == C.ALTREF_FRAME:
                left = 1
        return above + left + 3 * int(fwd == bck)

    def _read_ref_frames(self, r, c, bsize, skip_mode, avail_u, avail_l):
        hdr = self.hdr
        msac = self.msac
        if skip_mode:
            return tuple(hdr.skip_mode_frames)
        comp_allowed = (min(C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]) * 4 >= 8)
        if getattr(hdr, "reference_select", False) and comp_allowed:
            ctx = self._comp_mode_ctx(r, c, avail_u, avail_l)
            if msac.decode_symbol(self.cdf["comp_inter"][ctx]):
                return self._read_comp_refs(r, c, avail_u, avail_l)
        # single reference: p1/p2/p3/p4/p5/p6 tree with count contexts
        cnt = self._count_refs(r, c, avail_u, avail_l)
        fwd = cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME] + \
            cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME]
        bwd = cnt[C.BWDREF_FRAME] + cnt[C.ALTREF2_FRAME] + \
            cnt[C.ALTREF_FRAME]
        sr = self.cdf["single_ref"]
        if msac.decode_symbol(sr[self._ref_ctx(fwd, bwd)][0]):  # p1: bwd
            ctx2 = self._ref_ctx(cnt[C.ALTREF2_FRAME]
                                 + cnt[C.BWDREF_FRAME],
                                 cnt[C.ALTREF_FRAME])
            if msac.decode_symbol(sr[ctx2][1]):                 # p2: ALTREF
                return (C.ALTREF_FRAME, C.NONE_FRAME)
            ctx6 = self._ref_ctx(cnt[C.BWDREF_FRAME],
                                 cnt[C.ALTREF2_FRAME])
            if msac.decode_symbol(sr[ctx6][5]):                 # p6
                return (C.ALTREF2_FRAME, C.NONE_FRAME)
            return (C.BWDREF_FRAME, C.NONE_FRAME)
        ctx3 = self._ref_ctx(cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME],
                             cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME])
        if msac.decode_symbol(sr[ctx3][2]):                     # p3
            ctx5 = self._ref_ctx(cnt[C.LAST3_FRAME], cnt[C.GOLDEN_FRAME])
            if msac.decode_symbol(sr[ctx5][4]):                 # p5
                return (C.GOLDEN_FRAME, C.NONE_FRAME)
            return (C.LAST3_FRAME, C.NONE_FRAME)
        ctx4 = self._ref_ctx(cnt[C.LAST_FRAME], cnt[C.LAST2_FRAME])
        if msac.decode_symbol(sr[ctx4][3]):                     # p4
            return (C.LAST2_FRAME, C.NONE_FRAME)
        return (C.LAST_FRAME, C.NONE_FRAME)

    def _read_comp_refs(self, r, c, avail_u, avail_l):
        """Compound reference pair (spec read_ref_frames compound arm)."""
        msac = self.msac
        cnt = self._count_refs(r, c, avail_u, avail_l)
        fwd = cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME] + \
            cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME]
        bwd = cnt[C.BWDREF_FRAME] + cnt[C.ALTREF2_FRAME] + \
            cnt[C.ALTREF_FRAME]
        tctx = self._comp_ref_type_ctx(r, c, avail_u, avail_l)
        uni = msac.decode_symbol(self.cdf["comp_ref_type"][tctx]) == 0
        ucr = self.cdf["uni_comp_ref"]
        if uni:
            if msac.decode_symbol(ucr[self._ref_ctx(fwd, bwd)][0]):
                return (C.BWDREF_FRAME, C.ALTREF_FRAME)
            ctx1 = self._ref_ctx(cnt[C.LAST2_FRAME],
                                 cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME])
            if msac.decode_symbol(ucr[ctx1][1]):
                ctx2 = self._ref_ctx(cnt[C.LAST3_FRAME],
                                     cnt[C.GOLDEN_FRAME])
                if msac.decode_symbol(ucr[ctx2][2]):
                    return (C.LAST_FRAME, C.GOLDEN_FRAME)
                return (C.LAST_FRAME, C.LAST3_FRAME)
            return (C.LAST_FRAME, C.LAST2_FRAME)
        cr = self.cdf["comp_ref"]
        cb = self.cdf["comp_bwdref"]
        ctx0 = self._ref_ctx(cnt[C.LAST_FRAME] + cnt[C.LAST2_FRAME],
                             cnt[C.LAST3_FRAME] + cnt[C.GOLDEN_FRAME])
        if msac.decode_symbol(cr[ctx0][0]):
            ctx2 = self._ref_ctx(cnt[C.LAST3_FRAME], cnt[C.GOLDEN_FRAME])
            ref0 = (C.GOLDEN_FRAME if msac.decode_symbol(cr[ctx2][2])
                    else C.LAST3_FRAME)
        else:
            ctx1 = self._ref_ctx(cnt[C.LAST_FRAME], cnt[C.LAST2_FRAME])
            ref0 = (C.LAST2_FRAME if msac.decode_symbol(cr[ctx1][1])
                    else C.LAST_FRAME)
        bctx0 = self._ref_ctx(cnt[C.BWDREF_FRAME] + cnt[C.ALTREF2_FRAME],
                              cnt[C.ALTREF_FRAME])
        if msac.decode_symbol(cb[bctx0][0]):
            ref1 = C.ALTREF_FRAME
        else:
            bctx1 = self._ref_ctx(cnt[C.BWDREF_FRAME],
                                  cnt[C.ALTREF2_FRAME])
            ref1 = (C.ALTREF2_FRAME if msac.decode_symbol(cb[bctx1][1])
                    else C.BWDREF_FRAME)
        return (ref0, ref1)

    # compound_mode_ctx_map (libaom av1_mode_context_analyzer); recovered
    # from libaom .rodata and pinned empirically vs dav1d with forced-ctx
    # probes (NEW_NEWMV symbol decodes uniquely per ctx).
    _COMP_MODE_CTX_MAP = [[0, 1, 1, 1, 1],
                          [1, 2, 3, 4, 4],
                          [4, 4, 5, 6, 7]]

    def _drl_ctx(self, st, idx):
        if st.weights[idx] >= 640:
            return 0 if st.weights[idx + 1] >= 640 else 1
        return 2

    def _read_inter_mode(self, st):
        msac = self.msac
        if not msac.decode_symbol(self.cdf["newmv"][st.new_mv_ctx]):
            return C.NEWMV
        if not msac.decode_symbol(self.cdf["zeromv"][st.zero_mv_ctx]):
            return C.GLOBALMV
        if not msac.decode_symbol(self.cdf["refmv"][st.ref_mv_ctx]):
            return C.NEARESTMV
        return C.NEARMV

    def _read_drl(self, st, mode):
        msac = self.msac
        ref_mv_idx = 0
        if mode in (C.NEWMV, C.NEW_NEWMV):
            for idx in range(2):
                if st.num_found > idx + 1:
                    if not msac.decode_symbol(
                            self.cdf["drl"][self._drl_ctx(st, idx)]):
                        break
                    ref_mv_idx = idx + 1
        elif mode in (C.NEARMV, C.NEAR_NEARMV, C.NEAR_NEWMV,
                      C.NEW_NEARMV):
            ref_mv_idx = 1
            for idx in range(1, 3):
                if st.num_found > idx + 1:
                    if not msac.decode_symbol(
                            self.cdf["drl"][self._drl_ctx(st, idx)]):
                        break
                    ref_mv_idx = idx + 1
        return ref_mv_idx

    def _read_mv_component(self, comp, prefix="mv", force_int=None):
        msac = self.msac
        hdr = self.hdr
        cdf = self.cdf
        if force_int is None:
            force_int = getattr(hdr, "force_integer_mv", 0)
        hp_allowed = hdr.allow_high_precision_mv and prefix == "mv"
        sign = msac.decode_symbol(cdf[f"{prefix}_sign_{comp}"][0])
        mv_class = msac.decode_symbol(cdf[f"{prefix}_classes_{comp}"][0])
        if mv_class == 0:
            int_bit = msac.decode_symbol(cdf[f"{prefix}_class0_{comp}"][0])
            if force_int:
                fr = 3
            else:
                fr = msac.decode_symbol(
                    cdf[f"{prefix}_class0_fr_{comp}"][int_bit])
            if hp_allowed:
                hp = msac.decode_symbol(
                    cdf[f"{prefix}_class0_hp_{comp}"][0])
            else:
                hp = 1
            mag = ((int_bit << 3) | (fr << 1) | hp) + 1
        else:
            d = 0
            for i in range(mv_class):
                d |= msac.decode_symbol(
                    cdf[f"{prefix}_bits_{comp}"][i]) << i
            mag = 2 << (mv_class + 2)           # CLASS0_SIZE << (cls+2)
            if force_int:
                fr = 3
            else:
                fr = msac.decode_symbol(cdf[f"{prefix}_fr_{comp}"][0])
            if hp_allowed:
                hp = msac.decode_symbol(cdf[f"{prefix}_hp_{comp}"][0])
            else:
                hp = 1
            mag += ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag

    def _read_mv(self, pred, prefix="mv", force_int=None):
        joint = self.msac.decode_symbol(self.cdf[f"{prefix}_joint"][0])
        dr = dc = 0
        if joint in (C.MV_JOINT_HZVNZ, C.MV_JOINT_HNZVNZ):
            dr = self._read_mv_component(0, prefix, force_int)
        if joint in (C.MV_JOINT_HNZVZ, C.MV_JOINT_HNZVNZ):
            dc = self._read_mv_component(1, prefix, force_int)
        return (pred[0] + dr, pred[1] + dc)

    def _read_interp_filter(self, r, c, ref_frame, avail_u, avail_l):
        hdr = self.hdr
        if hdr.interpolation_filter != C.SWITCHABLE:
            f = hdr.interpolation_filter
            return (f, f)
        filters = []
        n_dirs = 2 if getattr(self.seq, "enable_dual_filter", False) else 1
        for d in range(n_dirs):
            ctx = ((d & 1) * 2 + int(ref_frame[1] > C.INTRA_FRAME)) * 4
            left_type = 3
            above_type = 3
            if avail_l and (int(self.ref_frames0[r, c - 1]) == ref_frame[0]
                            or int(self.ref_frames1[r, c - 1])
                            == ref_frame[0]):
                left_type = int(self.interp[r, c - 1, d])
            if avail_u and (int(self.ref_frames0[r - 1, c]) == ref_frame[0]
                            or int(self.ref_frames1[r - 1, c])
                            == ref_frame[0]):
                above_type = int(self.interp[r - 1, c, d])
            if left_type == above_type:
                ctx += left_type
            elif left_type == 3:
                ctx += above_type
            elif above_type == 3:
                ctx += left_type
            else:
                ctx += 3
            filters.append(self._decode_ragged(
                self.cdf["switchable_interp"][ctx], 3))
        if n_dirs == 1:
            filters.append(filters[0])
        return tuple(filters)

    # per-list component modes for the compound inter modes
    _COMP_COMPONENTS = {
        C.NEAREST_NEARESTMV: (C.NEARESTMV, C.NEARESTMV),
        C.NEAR_NEARMV: (C.NEARMV, C.NEARMV),
        C.NEAREST_NEWMV: (C.NEARESTMV, C.NEWMV),
        C.NEW_NEARESTMV: (C.NEWMV, C.NEARESTMV),
        C.NEAR_NEWMV: (C.NEARMV, C.NEWMV),
        C.NEW_NEARMV: (C.NEWMV, C.NEARMV),
        C.GLOBAL_GLOBALMV: (C.GLOBALMV, C.GLOBALMV),
        C.NEW_NEWMV: (C.NEWMV, C.NEWMV),
    }

    def _assign_comp_mvs(self, mode, st, idx):
        mvs = []
        for i, m in enumerate(self._COMP_COMPONENTS[mode]):
            if m == C.NEARESTMV:
                mv = st.mvs[0][i]
            elif m == C.NEARMV:
                mv = st.mvs[idx][i]
            elif m == C.GLOBALMV:
                mv = st.global_mvs[i]
            else:                        # NEWMV component
                pred = self.refmv._lower_precision(st.mvs[idx][i])
                mv = self._read_mv(pred)
            mvs.append((int(mv[0]), int(mv[1])))
        return mvs

    def _inter_mode_info(self, r, c, bsize, avail_u, avail_l):
        ref_frame = self._read_ref_frames(r, c, bsize,
                                          self.skip_mode_flag,
                                          avail_u, avail_l)
        is_compound = ref_frame[1] > C.INTRA_FRAME
        st = self.refmv.find(r, c, bsize, ref_frame, is_compound)
        ref_mv_idx = 0
        mv2 = (0, 0)
        if self.skip_mode_flag:
            mode = C.NEAREST_NEARESTMV
            mv, mv2 = st.mvs[0][0], st.mvs[0][1]
        elif is_compound:
            cctx = self._compound_mode_ctx(st, r, c)
            sym = self.msac.decode_symbol(
                self.cdf["inter_compound_mode"][cctx])
            mode = C.NEAREST_NEARESTMV + sym
            ref_mv_idx = self._read_drl(st, mode)
            mv, mv2 = self._assign_comp_mvs(mode, st, ref_mv_idx)
        else:
            mode = self._read_inter_mode(st)
            ref_mv_idx = self._read_drl(st, mode)
            if mode == C.NEWMV:
                pred = self.refmv._lower_precision(st.mvs[ref_mv_idx][0])
                mv = self._read_mv(pred)
            elif mode == C.NEARESTMV:
                mv = st.mvs[0][0]
            elif mode == C.NEARMV:
                mv = st.mvs[ref_mv_idx][0]
            else:                        # GLOBALMV
                mv = st.global_mvs[0]
        self._last_interintra = (-1, 0, 0)
        # interintra (spec read_interintra_mode: coded before motion
        # mode for single-ref 8x8..32x32 blocks when the sequence
        # enables the tool)
        interintra_mode = -1
        ii_wedge = 0
        ii_wedge_idx = 0
        if (getattr(self.seq, "enable_interintra_compound", False)
                and not self.skip_mode_flag
                and ref_frame[1] == C.NONE_FRAME
                and C.NEARESTMV <= mode <= C.NEWMV
                and C.BLOCK_8X8 <= bsize <= C.BLOCK_32X32):
            szg = SIZE_GROUP[bsize]
            if self.msac.decode_symbol(self.cdf["interintra"][szg]):
                interintra_mode = self.msac.decode_symbol(
                    self.cdf["interintra_mode"][szg])
                ref_frame = (ref_frame[0], C.INTRA_FRAME)
                from easyav1.video.av1.wedge import wedge_allowed
                if wedge_allowed(bsize):
                    ii_wedge = self.msac.decode_symbol(
                        self.cdf["wedge_interintra"][bsize])
                    if ii_wedge:
                        ii_wedge_idx = self._decode_ragged(
                            self.cdf["wedge_idx"][bsize], 16)
        self._last_interintra = (interintra_mode, ii_wedge, ii_wedge_idx)

        # motion mode (spec read_motion_mode / libaom motion_mode_allowed)
        motion_mode = C.SIMPLE
        self._last_warp = None
        hdr = self.hdr
        if (getattr(hdr, "is_motion_mode_switchable", False)
                and not self.skip_mode_flag
                and ref_frame[1] == C.NONE_FRAME):
            cands = self._find_warp_samples(r, c, bsize, ref_frame[0],
                                            avail_u, avail_l)
            glob_block = (mode == C.GLOBALMV
                          and min(C.BLOCK_W4[bsize],
                                  C.BLOCK_H4[bsize]) * 4 >= 8
                          and hdr.gm_type[ref_frame[0]] > C.TRANSLATION
                          and not hdr.force_integer_mv)
            if (min(C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]) * 4 >= 8
                    and not glob_block
                    and self._has_overlappable(r, c, bsize, avail_u,
                                               avail_l)):
                warp_ok = (len(cands) >= 1
                           and getattr(hdr, "allow_warped_motion", False)
                           and not hdr.force_integer_mv)
                if warp_ok:
                    motion_mode = self.msac.decode_symbol(
                        self.cdf["motion_mode"][bsize])
                else:
                    motion_mode = (C.OBMC_MOTION if self.msac.decode_symbol(
                        self.cdf["obmc"][bsize]) else C.SIMPLE)
            if motion_mode == C.WARPED:
                # libaom av1_selectSamples: threshold trim, keep >= 1
                bw = C.BLOCK_W4[bsize] * 4
                bh = C.BLOCK_H4[bsize] * 4
                thresh = max(16, min(112, max(bw, bh)))
                if len(cands) > 1:
                    sel = [p for p in cands
                           if (abs(p[2] - p[0] - mv[1])
                               + abs(p[3] - p[1] - mv[0])) <= thresh]
                    if not sel:
                        sel = cands[:1]
                else:
                    sel = cands
                mat = warp_mod.find_affine_int(
                    sel[:8], r, c, bsize, (int(mv[0]), int(mv[1])))
                shear = warp_mod.get_shear_params(mat) if mat else None
                if mat is not None and shear is not None:
                    self._last_warp = (mat, shear)
                # invalid warp -> translational fallback at recon
        # compound type (spec read_compound_type)
        comp_group_idx = 0
        compound_idx = 1
        comp_type = C.COMPOUND_AVERAGE
        wedge_idx = 0
        wedge_sign = 0
        mask_type = 0
        if ref_frame[1] > C.INTRA_FRAME and not self.skip_mode_flag:
            masked_ok = getattr(self.seq, "enable_masked_compound", False)
            if masked_ok:
                gctx = self._comp_group_ctx(r, c, avail_u, avail_l)
                comp_group_idx = self.msac.decode_symbol(
                    self.cdf["comp_group_idx"][gctx])
            if comp_group_idx == 0:
                if getattr(self.seq, "enable_jnt_comp", False):
                    ictx = self._comp_index_ctx(r, c, ref_frame,
                                                avail_u, avail_l)
                    compound_idx = self.msac.decode_symbol(
                        self.cdf["compound_index"][ictx])
                    comp_type = (C.COMPOUND_AVERAGE if compound_idx
                                 else C.COMPOUND_DISTANCE)
            else:
                if T.WEDGE_BITS[bsize] > 0:
                    comp_type = (C.COMPOUND_WEDGE
                                 if self.msac.decode_symbol(
                                     self.cdf["compound_type"][bsize]) == 0
                                 else C.COMPOUND_DIFFWTD)
                else:
                    comp_type = C.COMPOUND_DIFFWTD
                if comp_type == C.COMPOUND_WEDGE:
                    wedge_idx = self._decode_ragged(
                        self.cdf["wedge_idx"][bsize], 16)
                    wedge_sign = self.msac.decode_bool_equi()
                else:
                    mask_type = self.msac.decode_bool_equi()
        self._last_comp = (comp_group_idx, compound_idx, comp_type,
                           wedge_idx, wedge_sign, mask_type)
        # interpolation filter: not coded for warped / non-translational
        # global blocks (spec needs_interp_filter: a large GLOBALMV
        # block reads it ONLY when GmType == TRANSLATION; IDENTITY also
        # suppresses the read, and GLOBAL_GLOBALMV checks both refs)
        large = min(C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]) * 4 >= 8
        nontrans_global = False
        if large and mode == C.GLOBALMV:
            nontrans_global = (hdr.gm_type[ref_frame[0]]
                               != C.TRANSLATION)
        elif large and mode == C.GLOBAL_GLOBALMV:
            nontrans_global = (
                hdr.gm_type[ref_frame[0]] != C.TRANSLATION
                and hdr.gm_type[ref_frame[1]] != C.TRANSLATION)
        if (self.skip_mode_flag or motion_mode == C.WARPED
                or nontrans_global):
            f = (C.EIGHTTAP if hdr.interpolation_filter == C.SWITCHABLE
                 else hdr.interpolation_filter)
            interp = (f, f)
        else:
            interp = self._read_interp_filter(r, c, ref_frame, avail_u,
                                              avail_l)
        self._last_ref_mv_idx = ref_mv_idx
        self._last_motion_mode = motion_mode
        self._last_mv2 = (int(mv2[0]), int(mv2[1]))
        return int(mode), ref_frame, (int(mv[0]), int(mv[1])), interp

    def _find_warp_samples(self, r, c, bsize, ref, avail_u, avail_l):
        """Warp sample gathering (spec §7.10.4 / libaom av1_findSamples).
        Returns CandList entries (x8, y8, x8+mvx, y8+mvy) in ABSOLUTE
        1/8-pel luma coords (center of each candidate block)."""
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        cands = []
        do_tl = True
        do_tr = True

        def match(rr, cc):
            return (int(self.ref_frames0[rr, cc]) == ref
                    and int(self.ref_frames1[rr, cc]) == C.NONE_FRAME)

        def rec(rr, cc, row_off, sign_r, col_off, sign_c):
            nb = int(self.plan.bsize[rr, cc])
            bw = C.BLOCK_W4[nb] * 4
            bh = C.BLOCK_H4[nb] * 4
            x = (c + col_off) * 4 + sign_c * (bw >> 1) - 1
            y = (r + row_off) * 4 + sign_r * (bh >> 1) - 1
            mvr = int(self.mvs[rr, cc, 0, 0])
            mvc = int(self.mvs[rr, cc, 0, 1])
            cands.append((x * 8, y * 8, x * 8 + mvc, y * 8 + mvr))

        if avail_u:
            src_w = C.BLOCK_W4[int(self.plan.bsize[r - 1, c])]
            if w4 <= src_w:
                col_off = -(c % src_w)
                if col_off < 0:
                    do_tl = False
                if col_off + src_w > w4:
                    do_tr = False
                if match(r - 1, c):
                    rec(r - 1, c, 0, -1, col_off, 1)
            else:
                i = 0
                while i < min(w4, self.mi_col_end - c) and len(cands) < 8:
                    src_w = C.BLOCK_W4[int(self.plan.bsize[r - 1, c + i])]
                    if match(r - 1, c + i):
                        rec(r - 1, c + i, 0, -1, i, 1)
                    i += min(w4, src_w)
        if avail_l and len(cands) < 8:
            src_h = C.BLOCK_H4[int(self.plan.bsize[r, c - 1])]
            if h4 <= src_h:
                row_off = -(r % src_h)
                if row_off < 0:
                    do_tl = False
                if match(r, c - 1):
                    rec(r, c - 1, row_off, 1, 0, -1)
            else:
                i = 0
                while i < min(h4, self.mi_row_end - r) and len(cands) < 8:
                    src_h = C.BLOCK_H4[int(self.plan.bsize[r + i, c - 1])]
                    if match(r + i, c - 1):
                        rec(r + i, c - 1, i, 1, 0, -1)
                    i += min(h4, src_h)
        if do_tl and avail_u and avail_l and len(cands) < 8 \
                and match(r - 1, c - 1):
            rec(r - 1, c - 1, 0, -1, 0, -1)
        if do_tr and len(cands) < 8 and self._has_tr(r, c, bsize) \
                and c + w4 < self.mi_col_end and match(r - 1, c + w4):
            rec(r - 1, c + w4, 0, -1, w4, 1)
        return cands

    def _has_overlappable(self, r, c, bsize, avail_u, avail_l):
        """Spec has_overlappable_candidates (5.11.27): samples only the
        ODD cell of each 8px step — `RefFrames[r-1][(c+i)|1]`, i += 2.
        An even/odd inter/intra mix at 4x4 granularity therefore differs
        from scanning every cell (conformance-verified vs dav1d)."""
        if avail_u:
            for i in range(0, min(C.BLOCK_W4[bsize],
                                  self.mi_col_end - c), 2):
                cc = min((c + i) | 1, self.mi_col_end - 1)
                if int(self.ref_frames0[r - 1, cc]) > C.INTRA_FRAME:
                    return True
        if avail_l:
            for i in range(0, min(C.BLOCK_H4[bsize],
                                  self.mi_row_end - r), 2):
                rr = min((r + i) | 1, self.mi_row_end - 1)
                if int(self.ref_frames0[rr, c - 1]) > C.INTRA_FRAME:
                    return True
        return False

    # -- inter var-tx tree + residual ----------------------------------------

    def _txfm_split_ctx(self, r, c, bsize, tx_size):
        txw = T.TX_WIDTH[tx_size]
        txh = T.TX_HEIGHT[tx_size]
        above = r > self.mi_row_start and int(self.a_txw[c]) < txw
        left = c > self.mi_col_start and int(self.l_txh[r]) < txh
        max_rect = T.MAX_TX_SIZE_RECT[bsize]
        max_sq = T.TX_SIZE_SQR_UP[max_rect]
        cat = ((T.TX_SIZE_SQR_UP[tx_size] != max_sq and max_sq > C.TX_8X8)
               + (C.TX_SIZES - 1 - max_sq) * 2)
        return cat * 3 + int(above) + int(left)

    def _read_var_tx(self, r, c, bsize):
        """spec read_var_tx_size over the block; returns luma leaves
        [(x4off, y4off, tx_size)] in raster order of max-tx units."""
        leaves = []
        max_tx = T.MAX_TX_SIZE_RECT[bsize]
        w4 = min(C.BLOCK_W4[bsize], self.mi_col_end - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_row_end - r)
        sw = T.TX_W4[max_tx]
        sh = T.TX_H4[max_tx]
        for yy in range(0, h4, sh):
            for xx in range(0, w4, sw):
                self._var_tx_node(r, c, bsize, xx, yy, max_tx, 0, leaves)
        return leaves

    def _var_tx_node(self, r, c, bsize, xx, yy, tx_size, depth, leaves):
        # spec read_var_tx_size: nodes past the frame edge read NOTHING
        # (split subnodes of a straddling unit can land out of frame)
        if r + yy >= self.mi_rows or c + xx >= self.mi_cols:
            return
        msac = self.msac
        split = False
        if depth < 2 and tx_size != C.TX_4X4:
            ctx = self._txfm_split_ctx(r + yy, c + xx, bsize, tx_size)
            split = bool(msac.decode_symbol(
                self.cdf["txfm_partition"][ctx]))
        if split:
            sub = T.SPLIT_TX_SIZE[tx_size]
            sw = T.TX_W4[sub]
            sh = T.TX_H4[sub]
            for dy in range(0, T.TX_H4[tx_size], sh):
                for dx in range(0, T.TX_W4[tx_size], sw):
                    self._var_tx_node(r, c, bsize, xx + dx, yy + dy, sub,
                                      depth + 1, leaves)
        else:
            leaves.append((xx, yy, tx_size))
            # txfm ctx arrays updated with the leaf dims
            tw4 = T.TX_W4[tx_size]
            th4 = T.TX_H4[tx_size]
            self.a_txw[c + xx:c + xx + tw4] = T.TX_WIDTH[tx_size]
            self.l_txh[r + yy:r + yy + th4] = T.TX_HEIGHT[tx_size]

    def _residual_inter(self, r, c, bsize, var_txs, has_chroma):
        # spec 5.11.34: 64x64 chunks, var-tx leaves + chroma per chunk
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        for cy4 in range(0, h4, 16):
            for cx4 in range(0, w4, 16):
                cw4 = min(16, w4 - cx4)
                ch4 = min(16, h4 - cy4)
                rr = r + cy4
                cc = c + cx4
                for (xx, yy, tx) in var_txs:
                    if not (cx4 <= xx < cx4 + cw4
                            and cy4 <= yy < cy4 + ch4):
                        continue
                    if (r + yy >= self.mi_row_end
                            or c + xx >= self.mi_col_end):
                        continue
                    self._transform_block(0, (c + xx) * 4, (r + yy) * 4,
                                          tx, r, c)
                if has_chroma and self.num_planes > 1:
                    tx = self._uv_tx_size(bsize)
                    pw4 = max(1, min(cw4, self.mi_col_end - cc)
                              >> self.ssx)
                    ph4 = max(1, min(ch4, self.mi_row_end - rr)
                              >> self.ssy)
                    if min(cw4, self.mi_col_end - cc) <= 0 or \
                       min(ch4, self.mi_row_end - rr) <= 0:
                        continue
                    cx = (cc >> self.ssx) * 4
                    cy = (rr >> self.ssy) * 4
                    for plane in (1, 2):
                        for yy in range(0, ph4, T.TX_H4[tx]):
                            for xx in range(0, pw4, T.TX_W4[tx]):
                                self._transform_block(plane, cx + xx * 4,
                                                      cy + yy * 4, tx,
                                                      r, c)

    def _is_inside(self, r, c):
        return (self.mi_row_start <= r < self.mi_row_end
                and self.mi_col_start <= c < self.mi_col_end
                and self.decoded_mi[r, c])

    def _has_tr(self, r, c, bsize):
        bw4 = C.BLOCK_W4[bsize]
        rr, cc = r - 1, c + bw4
        if rr < 0 or cc >= self.mi_cols:
            return False
        return bool(self.decoded_mi[rr, cc])

    def _filter_intra_cdf(self, bsize):

        # filter_intra use cdf indexed by block size; table not yet
        # located in the binary — fall back to a per-size uniform cdf.
        key = "_filter_intra_use"
        if key not in self.cdf:
            self.cdf[key] = [[16384, 0, 0] for _ in range(22)]
        return self.cdf[key][bsize]

    def _read_cfl_alphas(self, sign_joint) -> Tuple[int, int]:
        # joint sign: 8 symbols = 3*3-1 (not both zero); spec §5.11.45.
        # CFL_SIGN_ZERO=0, CFL_SIGN_NEG=1, CFL_SIGN_POS=2.
        sign_u = (sign_joint + 1) // 3
        sign_v = (sign_joint + 1) % 3
        alpha_u = alpha_v = 0
        if sign_u != 0:
            ctx = (3 if sign_u == 2 else 0) + sign_v
            idx = self.msac.decode_symbol(self.cdf["cfl_alpha"][ctx]) + 1
            alpha_u = -idx if sign_u == 1 else idx
        if sign_v != 0:
            ctx = (3 if sign_v == 2 else 0) + sign_u
            idx = self.msac.decode_symbol(self.cdf["cfl_alpha"][ctx]) + 1
            alpha_v = -idx if sign_v == 1 else idx
        return alpha_u, alpha_v

    def _read_deltas(self, bsize, skip):
        hdr = self.hdr
        msac = self.msac
        if bsize == self.sb_size and skip:
            return
        events = []
        if hdr.delta_q_present:
            delta_q_abs = msac.decode_symbol(self.cdf["delta_q"][0])
            rem_bits = None
            sign = None
            if delta_q_abs == 3:
                rem_bits = msac.decode_literal(3) + 1
                delta_q_abs = msac.decode_literal(rem_bits) + (1 << rem_bits) + 1
            if delta_q_abs:
                sign = msac.decode_bool_equi()
                delta = -delta_q_abs if sign else delta_q_abs
                self.cur_qindex = max(1, min(255,
                                             self.cur_qindex
                                             + (delta << hdr.delta_q_res)))
            events.append(("q", delta_q_abs, rem_bits, sign))
        if hdr.delta_lf_present:
            count = 4 if (hdr.delta_lf_multi and self.num_planes > 1) else \
                (2 if hdr.delta_lf_multi else 1)
            cdfs = (self.cdf["delta_lf_multi"] if hdr.delta_lf_multi
                    else [self.cdf["delta_lf"][0]])
            for i in range(count):
                row = cdfs[i] if hdr.delta_lf_multi else cdfs[0]
                v = msac.decode_symbol(row)
                rem_bits = None
                sign = None
                if v == 3:
                    rem_bits = msac.decode_literal(3) + 1
                    v = msac.decode_literal(rem_bits) + (1 << rem_bits) + 1
                if v:
                    sign = msac.decode_bool_equi()  # lf deltas unused yet
                events.append(("lf", i, v, rem_bits, sign))
        if events:
            if not hasattr(self.plan, "delta_events"):
                self.plan.delta_events = {}
            self.plan.delta_events[self._delta_rc] = events

    # -- tx size -----------------------------------------------------------

    def _read_tx_size(self, r, c, bsize, skip, avail_u, avail_l) -> int:
        hdr = self.hdr
        if hdr.coded_lossless:
            return C.TX_4X4
        max_rect = T.MAX_TX_SIZE_RECT[bsize]
        if bsize == C.BLOCK_4X4:
            return C.TX_4X4
        # intra: allowSelect = !skip || !is_inter == always true (spec
        # read_block_tx_size) - the depth symbol is coded even for skips
        if hdr.tx_mode != C.TX_MODE_SELECT:
            return max_rect
        # depth count allowed
        max_depth = self._max_tx_depth(bsize)
        cat = T.TX_SIZE_SQR_UP[max_rect] - 1
        cat = max(0, min(cat, 3))
        max_tx_w = T.TX_WIDTH[max_rect]
        max_tx_h = T.TX_HEIGHT[max_rect]
        above = int(self.a_txw[c]) >= max_tx_w
        left = int(self.l_txh[r]) >= max_tx_h
        # libaom get_tx_size_context: INTER neighbors contribute their
        # BLOCK dims, not their published leaf-tx dims
        if avail_u and int(self.ref_frames0[r - 1, c]) > C.INTRA_FRAME:
            nb = int(self.plan.bsize[r - 1, c])
            above = C.BLOCK_W4[nb] * 4 >= max_tx_w
        if avail_l and int(self.ref_frames0[r, c - 1]) > C.INTRA_FRAME:
            nb = int(self.plan.bsize[r, c - 1])
            left = C.BLOCK_H4[nb] * 4 >= max_tx_h
        ctx = int(above) + int(left)
        row = self.cdf["tx_size"][cat][ctx]
        nsym = min(max_depth, 2) + 1
        if cat == 0:
            depth = self._decode_ragged(row, 2)
        else:
            depth = self._decode_ragged(row, nsym)
        tx = max_rect
        for _ in range(depth):
            tx = T.SPLIT_TX_SIZE[tx]
        return tx

    @staticmethod
    def _max_tx_depth(bsize) -> int:
        # spec Max_Tx_Depth table
        depth_tab = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4,
                     2, 2, 3, 3, 4, 4]
        return depth_tab[bsize]

    # -- residual ----------------------------------------------------------

    def _residual(self, r, c, bsize, tx_size, has_chroma):
        # spec 5.11.34 residual(): blocks wider/taller than 64px are
        # split into 64x64 chunks with the planes interleaved PER CHUNK
        # (only 128-wide/high blocks have >1 chunk)
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        for cy4 in range(0, h4, 16):
            for cx4 in range(0, w4, 16):
                cw4_full = min(16, w4 - cx4)
                ch4_full = min(16, h4 - cy4)
                rr = r + cy4
                cc = c + cx4
                for plane in range(self.num_planes if has_chroma else 1):
                    if plane == 0:
                        tx = tx_size
                        px = cc * 4
                        py = rr * 4
                        pw4 = min(cw4_full, self.mi_col_end - cc)
                        ph4 = min(ch4_full, self.mi_row_end - rr)
                    else:
                        tx = self._uv_tx_size(bsize)
                        px = (cc >> self.ssx) * 4
                        py = (rr >> self.ssy) * 4
                        pw4 = max(1, min(cw4_full, self.mi_col_end - cc)
                                  >> self.ssx)
                        ph4 = max(1, min(ch4_full, self.mi_row_end - rr)
                                  >> self.ssy)
                    if pw4 <= 0 or ph4 <= 0:
                        continue
                    step_x = T.TX_W4[tx]
                    step_y = T.TX_H4[tx]
                    for yy in range(0, ph4, step_y):
                        for xx in range(0, pw4, step_x):
                            self._transform_block(plane, px + xx * 4,
                                                  py + yy * 4, tx, r, c)

    def _uv_tx_size(self, bsize) -> int:
        # chroma: max rect tx of the subsampled block size, clamped to
        # 32; lossless forces 4x4 on every plane (spec get_tx_size)
        if self.hdr.coded_lossless:
            return C.TX_4X4
        w4 = max(1, C.BLOCK_W4[bsize] >> self.ssx)
        h4 = max(1, C.BLOCK_H4[bsize] >> self.ssy)
        for b in range(C.BLOCK_SIZES_ALL):
            if C.BLOCK_W4[b] == w4 and C.BLOCK_H4[b] == h4:
                tx = T.MAX_TX_SIZE_RECT[b]
                while T.TX_WIDTH[tx] > 32 or T.TX_HEIGHT[tx] > 32:
                    tx = T.SPLIT_TX_SIZE[tx]
                return tx
        raise ValueError(f"no uv block for {bsize}")

    def _clear_coef_ctx(self, r, c, bsize, tx_size, has_chroma):
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        self.a_lvl[0][c:c + w4] = 0
        self.l_lvl[0][r:r + h4] = 0
        self.a_sign[0][c:c + w4] = 0
        self.l_sign[0][r:r + h4] = 0
        if has_chroma:
            cx = c >> self.ssx
            cy = r >> self.ssy
            cw = max(1, w4 >> self.ssx)
            ch = max(1, h4 >> self.ssy)
            for p in (1, 2):
                self.a_lvl[p][cx:cx + cw] = 0
                self.l_lvl[p][cy:cy + ch] = 0
                self.a_sign[p][cx:cx + cw] = 0
                self.l_sign[p][cy:cy + ch] = 0

    # -- coefficients ------------------------------------------------------

    def _transform_block(self, plane, x, y, tx_size, blk_r, blk_c):
        msac = self.msac
        cdf = self.cdf
        adj = T.ADJUSTED_TX_SIZE[tx_size]
        tw = T.TX_WIDTH[adj]
        th = T.TX_HEIGHT[adj]
        full_w = T.TX_WIDTH[tx_size]
        full_h = T.TX_HEIGHT[tx_size]
        x4 = x >> 2
        y4 = y >> 2
        ptype = 1 if plane else 0
        tx_ctx = (T.TX_SIZE_SQR[tx_size]
                  + T.TX_SIZE_SQR_UP[tx_size] + 1) >> 1  # libaom get_txsize_entropy_ctx
        self.plan.lf_txs.append((plane, x, y, tx_size))

        # txb skip context
        ctx = self._txb_skip_ctx(plane, x4, y4, tx_size, blk_r, blk_c)
        all_zero = msac.decode_symbol(cdf["txb_skip"][tx_ctx][ctx])
        w4 = full_w >> 2
        h4 = full_h >> 2
        if all_zero:
            self._set_coef_ctx(plane, x4, y4, w4, h4, 0, 0)
            return

        # transform type
        if plane == 0:
            tx_type = self._read_tx_type(x4, y4, tx_size, blk_r, blk_c)
            tw4g = min(T.TX_W4[tx_size], self.mi_cols - x4)
            th4g = min(T.TX_H4[tx_size], self.mi_rows - y4)
            self.tx_types[y4:y4 + th4g, x4:x4 + tw4g] = tx_type
        else:
            tx_type = self._uv_tx_type(tx_size, blk_r, blk_c)
        tx_cls = T.tx_type_class(tx_type)
        scan = T.get_scan(tx_size, tx_type)

        # eob
        eob = self._read_eob(tx_size, ptype, tx_cls)

        # levels
        bwl = tw.bit_length() - 1  # log2 of adjusted width
        levels = np.zeros(th * tw, dtype=np.int32)
        base_offsets = (T.coeff_base_ctx_offset(tx_size).reshape(-1)
                        if tx_cls == T.TX_CLASS_2D else None)
        culp = 0
        for ci in range(eob - 1, -1, -1):
            pos = int(scan[ci])
            if ci == eob - 1:
                ctx_eob = self._coeff_base_eob_ctx(ci, tw, th)
                level = msac.decode_symbol(
                    cdf["coeff_base_eob"][tx_ctx][ptype][ctx_eob]) + 1
            else:
                bctx = self._coeff_base_ctx(levels, pos, bwl, th, tx_cls,
                                            base_offsets)
                level = msac.decode_symbol(
                    cdf["coeff_base"][tx_ctx][ptype][bctx])
            if level > 2:
                brctx = self._coeff_br_ctx(levels, pos, bwl, tx_cls)
                br_tx = min(tx_ctx, C.TX_32X32)
                for _ in range(4):
                    k = msac.decode_symbol(
                        cdf["coeff_br"][br_tx][ptype][brctx])
                    level += k
                    if k < 3:
                        break
            levels[pos] = level
        # signs + dequant
        qidx = self.cur_qindex
        seg_q = qidx  # segmentation qindex adjustments not yet wired
        dc_dq = T.dc_q(seg_q + self._dq_delta(plane, True), self.bitdepth)
        ac_dq = T.ac_q(seg_q + self._dq_delta(plane, False), self.bitdepth)
        lossless = self.hdr.coded_lossless
        shift = self._dq_shift(tx_size)
        coeffs = np.zeros(th * tw, dtype=np.int64)
        dc_category = 0
        rec_levels = []
        for ci in range(eob):
            pos = int(scan[ci])
            level = int(levels[pos])
            if level == 0:
                rec_levels.append((0, 0))
                continue
            if pos == 0:
                sctx = self._dc_sign_ctx(plane, x4, y4, w4, h4)
                sign = msac.decode_symbol(cdf["dc_sign"][ptype][sctx])
            else:
                sign = msac.decode_bool_equi()
            if level == 15:  # base 3 + br 12: golomb suffix (spec: read
                # in this forward pass, after the sign)
                level += msac.decode_golomb()
            rec_levels.append((level, sign))
            dqv = dc_dq if pos == 0 else ac_dq
            v = (level * dqv) & 0xFFFFFF
            v >>= shift
            # spec §7.13.3: dequantized coefficients are clipped to the
            # signed (bitdepth+8)-bit range before the inverse transform
            lim = 1 << (self.bitdepth + 7)
            coeffs[pos] = -min(v, lim) if sign else min(v, lim - 1)
            if pos == 0:
                dc_category = 2 if sign else 1
            culp += level
        culp = min(culp, 63)
        self._set_coef_ctx(plane, x4, y4, w4, h4, culp, dc_category)
        import os
        if os.environ.get("TXB_LOG"):
            print(f"DEC txb p{plane} ({x4},{y4}) tx{tx_size} "
                  f"end@{self.msac.bit_pos} eob={eob}")
        self._cur_block.tx_blocks.append(TxBlock(
            plane=plane, x=x, y=y, tx_size=tx_size, tx_type=tx_type,
            eob=eob, coeffs=coeffs.reshape(th, tw).astype(np.int32),
            lossless=lossless, levels=rec_levels))

    def _dq_delta(self, plane, is_dc) -> int:
        q = self.hdr.quant
        if plane == 0:
            return q.delta_q_y_dc if is_dc else 0
        if plane == 1:
            return q.delta_q_u_dc if is_dc else q.delta_q_u_ac
        return q.delta_q_v_dc if is_dc else q.delta_q_v_ac

    @staticmethod
    def _dq_shift(tx_size) -> int:
        """Spec dqDenom (libaom av1_get_tx_scale): keyed on tx AREA —
        >256 pels shifts 1, >1024 shifts 2 (so TX_32X8 shifts 0 and
        TX_16X64 shifts 1; verified vs libdav1d)."""
        pels = T.TX_WIDTH[tx_size] * T.TX_HEIGHT[tx_size]
        return (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)

    def _txb_skip_ctx(self, plane, x4, y4, tx_size, blk_r, blk_c) -> int:
        tw4 = T.TX_W4[tx_size]
        th4 = T.TX_H4[tx_size]
        if plane == 0:
            bsize = int(self.plan.bsize[blk_r, blk_c])
            bw4 = C.BLOCK_W4[bsize]
            bh4 = C.BLOCK_H4[bsize]
            if tw4 == bw4 and th4 == bh4:
                return 0
            top = 0
            left = 0
            # neighbor cul-levels are OR-ed (libaom get_txb_skip_ctx),
            # then ctx = tab[min(top,left)][top|left] with 4-clamps
            for i in range(min(tw4, self.mi_cols - x4)):
                top |= int(self.a_lvl[0][x4 + i])
            for i in range(min(th4, self.mi_rows - y4)):
                left |= int(self.l_lvl[0][y4 + i])
            top &= 63
            left &= 63
            mx = min(top | left, 4)
            mn = min(min(top, left), 4)
            skip_ctx_tab = [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5],
                            [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                            [1, 4, 4, 4, 6]]
            return skip_ctx_tab[mn][mx]
        # chroma
        above = 0
        left_nz = 0
        for i in range(tw4):
            if x4 + i < len(self.a_lvl[plane]) and self.a_lvl[plane][x4 + i]:
                above = 1
        for i in range(th4):
            if y4 + i < len(self.l_lvl[plane]) and self.l_lvl[plane][y4 + i]:
                left_nz = 1
        bsize = int(self.plan.bsize[blk_r, blk_c])
        bw4 = max(1, C.BLOCK_W4[bsize] >> self.ssx)
        bh4 = max(1, C.BLOCK_H4[bsize] >> self.ssy)
        # libaom av1_get_txb_ctx: offset 10 when the chroma plane block
        # is LARGER than the tx (multi-tx chroma, e.g. lossless >=16x16),
        # else 7
        base = 10 if bw4 * bh4 > tw4 * th4 else 7
        return base + above + left_nz

    def _read_tx_type(self, x4, y4, tx_size, blk_r, blk_c) -> int:
        hdr = self.hdr
        if hdr.coded_lossless:
            return C.DCT_DCT
        if self._cur_block.is_inter:
            tx_set = T.get_tx_set_inter(tx_size, hdr.reduced_tx_set)
            if tx_set == 0:
                return C.DCT_DCT
            sq = T.TX_SIZE_SQR[tx_size]
            if tx_set == 1:
                row = self.cdf["inter_ext_tx_set1"][sq]
                return T.TX_SET_INTER_1[self._decode_ragged(row, 16)]
            if tx_set == 2:
                row = self.cdf["inter_ext_tx_set2"][sq]
                return T.TX_SET_INTER_2[self._decode_ragged(row, 12)]
            row = self.cdf["inter_ext_tx_set3"][sq]
            return T.TX_SET_INTER_3[self._decode_ragged(row, 2)]
        tx_set = T.get_tx_set_intra(tx_size, hdr.reduced_tx_set)
        if tx_set == 0:
            return C.DCT_DCT
        y_mode = int(self.plan.y_mode[blk_r, blk_c])
        if (blk_r, blk_c) in self.plan.filter_intra:
            # libaom fimode_to_intradir: {DC, V, H, D157, DC(PAETH)}
            fi = self.plan.filter_intra[(blk_r, blk_c)]
            intra_dir = [C.DC_PRED, C.V_PRED, C.H_PRED, C.D157_PRED,
                         C.DC_PRED][fi]
        else:
            intra_dir = y_mode
        sq = T.TX_SIZE_SQR[tx_size]
        if tx_set == 1:
            row = self.cdf["intra_ext_tx_set1"][sq][intra_dir]
            sym = self._decode_ragged(row, 7)
            return T.TX_SET_INTRA_1[sym]
        row = self.cdf["intra_ext_tx_set2"][sq][intra_dir]
        sym = self._decode_ragged(row, 5)
        return T.TX_SET_INTRA_2[sym]

    def _uv_tx_type(self, tx_size, blk_r, blk_c) -> int:
        # chroma tx type derived from uv mode (spec compute_tx_type for
        # plane > 0: follows the luma/uv intra mode mapping, clamped by set)
        hdr = self.hdr
        if hdr.coded_lossless:
            return C.DCT_DCT
        if self._cur_block.is_inter:
            # inter chroma: the co-located luma tx type, clamped by set
            t = int(self.tx_types[blk_r, blk_c])
            tx_set = T.get_tx_set_inter(tx_size, hdr.reduced_tx_set)
            if tx_set == 0:
                return C.DCT_DCT
            allowed = (T.TX_SET_INTER_1 if tx_set == 1 else
                       T.TX_SET_INTER_2 if tx_set == 2 else T.TX_SET_INTER_3)
            return t if t in allowed else C.DCT_DCT
        uv_mode = int(self.plan.uv_mode[blk_r, blk_c])
        if uv_mode == C.UV_CFL_PRED:
            uv_mode = C.DC_PRED
        tx_set = T.get_tx_set_intra(tx_size, hdr.reduced_tx_set)
        t = T.INTRA_MODE_TO_TX_TYPE[uv_mode]
        if tx_set == 0:
            return C.DCT_DCT
        allowed = T.TX_SET_INTRA_1 if tx_set == 1 else T.TX_SET_INTRA_2
        return t if t in allowed else C.DCT_DCT

    def _read_eob(self, tx_size, ptype, tx_cls) -> int:
        msac = self.msac
        cdf = self.cdf
        adj = T.ADJUSTED_TX_SIZE[tx_size]
        area = T.TX_WIDTH[adj] * T.TX_HEIGHT[adj]
        cls_ctx = 0 if tx_cls == T.TX_CLASS_2D else 1
        key = {16: "eob_multi16", 32: "eob_multi32", 64: "eob_multi64",
               128: "eob_multi128", 256: "eob_multi256",
               512: "eob_multi512", 1024: "eob_multi1024"}[area]
        eob_pt = msac.decode_symbol(cdf[key][ptype][cls_ctx]) + 1
        if eob_pt < 3:
            return eob_pt
        eob_shift = eob_pt - 2  # number of refinement bits
        eob = (1 << (eob_pt - 2)) + 1
        tx_ctx = (T.TX_SIZE_SQR[tx_size]
                  + T.TX_SIZE_SQR_UP[tx_size] + 1) >> 1  # libaom get_txsize_entropy_ctx
        bit = msac.decode_symbol(
            cdf["eob_extra"][tx_ctx][ptype][eob_pt - 3])
        if bit:
            eob += 1 << (eob_shift - 1)
        for i in range(1, eob_shift):
            if msac.decode_bool_equi():
                eob += 1 << (eob_shift - 1 - i)
        return eob

    @staticmethod
    def _coeff_base_eob_ctx(ci, tw, th) -> int:
        if ci == 0:
            return 0
        n = tw * th
        if ci <= n // 8:
            return 1
        if ci <= n // 4:
            return 2
        return 3

    @staticmethod
    def _coeff_base_ctx(levels, pos, bwl, th, tx_cls, base_offsets) -> int:
        w = 1 << bwl
        row = pos >> bwl
        col = pos & (w - 1)
        mag = 0
        if tx_cls == T.TX_CLASS_2D:
            nbrs = ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0))
        elif tx_cls == T.TX_CLASS_HORIZ:
            # libaom get_nz_mag: {0,1},{1,0} common, then {0,2..4}
            nbrs = ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4))
        else:
            nbrs = ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0))
        for dr, dc in nbrs:
            rr = row + dr
            cc = col + dc
            if rr < th and cc < w:
                mag += min(int(levels[(rr << bwl) + cc]), 3)
        ctx = min((mag + 1) >> 1, 4)
        if tx_cls == T.TX_CLASS_2D:
            if pos == 0:
                return 0
            return ctx + int(base_offsets[pos])
        major = col if tx_cls == T.TX_CLASS_HORIZ else row
        return ctx + T.SIG_COEF_CONTEXTS_2D + min(major, 2) * 5

    @staticmethod
    def _coeff_br_ctx(levels, pos, bwl, tx_cls) -> int:
        w = 1 << bwl
        row = pos >> bwl
        col = pos & (w - 1)
        if tx_cls == T.TX_CLASS_2D:
            nbrs = ((0, 1), (1, 0), (1, 1))
        elif tx_cls == T.TX_CLASS_HORIZ:
            # libaom get_br_ctx: {0,1},{1,0} common, then {0,2}
            nbrs = ((0, 1), (1, 0), (0, 2))
        else:
            nbrs = ((0, 1), (1, 0), (2, 0))
        mag = 0
        th_guess = 1 << 16
        for dr, dc in nbrs:
            rr = row + dr
            cc = col + dc
            if cc < w and (rr << bwl) + cc < len(levels):
                mag += min(int(levels[(rr << bwl) + cc]), 15)
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if tx_cls == T.TX_CLASS_2D:
            if row < 2 and col < 2:
                return mag + 7
            return mag + 14
        major = col if tx_cls == T.TX_CLASS_HORIZ else row
        if major == 0:
            return mag + 7
        return mag + 14

    def _dc_sign_ctx(self, plane, x4, y4, w4, h4) -> int:
        if plane:
            x4 = x4
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
        # writes are clipped to the frame's plane-cell grid (libaom
        # av1_set_entropy_contexts via max_block_wide/high): a tx
        # overhanging the bottom/right frame edge must not leave state
        # in cells past the grid, or a later neighbor ctx read picks up
        # stale levels the reference decoder never sees (the arrays are
        # luma-cell sized, so chroma indices past the plane grid would
        # otherwise land in valid-but-wrong slots)
        if plane:
            w4 = min(w4, ((self.mi_cols + self.ssx) >> self.ssx) - x4)
            h4 = min(h4, ((self.mi_rows + self.ssy) >> self.ssy) - y4)
        else:
            w4 = min(w4, self.mi_cols - x4)
            h4 = min(h4, self.mi_rows - y4)
        self.a_lvl[plane][x4:x4 + w4] = cul
        self.l_lvl[plane][y4:y4 + h4] = cul
        self.a_sign[plane][x4:x4 + w4] = dc_cat
        self.l_sign[plane][y4:y4 + h4] = dc_cat
