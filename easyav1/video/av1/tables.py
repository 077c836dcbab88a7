"""AV1 constant tables: loads the extracted spec tables (tables_data.npz,
see tools/extract_av1_tables.py) and derives the algorithmic ones
(scan orders, coefficient context offsets, transform geometry).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from easyav1.video.av1 import constants as C

_NPZ = Path(__file__).parent / "tables_data.npz"


@functools.lru_cache(maxsize=1)
def data() -> dict:
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# Transform geometry

TX_W4 = C.TX_W4
TX_H4 = C.TX_H4
TX_WIDTH = [4 * w for w in C.TX_W4]
TX_HEIGHT = [4 * h for h in C.TX_H4]

# Tx_Size_Sqr / Tx_Size_Sqr_Up (spec §5.11.47 tables)
TX_SIZE_SQR = [C.TX_4X4, C.TX_8X8, C.TX_16X16, C.TX_32X32, C.TX_64X64,
               C.TX_4X4, C.TX_4X4, C.TX_8X8, C.TX_8X8, C.TX_16X16,
               C.TX_16X16, C.TX_32X32, C.TX_32X32, C.TX_4X4, C.TX_4X4,
               C.TX_8X8, C.TX_8X8, C.TX_16X16, C.TX_16X16]
TX_SIZE_SQR_UP = [C.TX_4X4, C.TX_8X8, C.TX_16X16, C.TX_32X32, C.TX_64X64,
                  C.TX_8X8, C.TX_8X8, C.TX_16X16, C.TX_16X16, C.TX_32X32,
                  C.TX_32X32, C.TX_64X64, C.TX_64X64, C.TX_16X16,
                  C.TX_16X16, C.TX_32X32, C.TX_32X32, C.TX_64X64,
                  C.TX_64X64]

# Adjusted_Tx_Size (spec: 64-dim txs carry coeffs only in a 32x32 corner)
ADJUSTED_TX_SIZE = list(range(C.TX_SIZES_ALL))
ADJUSTED_TX_SIZE[C.TX_64X64] = C.TX_32X32
ADJUSTED_TX_SIZE[C.TX_64X32] = C.TX_32X32
ADJUSTED_TX_SIZE[C.TX_32X64] = C.TX_32X32
ADJUSTED_TX_SIZE[C.TX_64X16] = C.TX_32X16
ADJUSTED_TX_SIZE[C.TX_16X64] = C.TX_16X32

# Split_Tx_Size (spec table: result of splitting a tx size once)
SPLIT_TX_SIZE = [
    C.TX_4X4, C.TX_4X4, C.TX_8X8, C.TX_16X16, C.TX_32X32, C.TX_4X4,
    C.TX_4X4, C.TX_8X8, C.TX_8X8, C.TX_16X16, C.TX_16X16, C.TX_32X32,
    C.TX_32X32, C.TX_4X8, C.TX_8X4, C.TX_8X16, C.TX_16X8, C.TX_16X32,
    C.TX_32X16,
]

# Max_Tx_Size_Rect (spec: largest rect tx fitting each block size)
MAX_TX_SIZE_RECT = [
    C.TX_4X4, C.TX_4X8, C.TX_8X4, C.TX_8X8, C.TX_8X16, C.TX_16X8,
    C.TX_16X16, C.TX_16X32, C.TX_32X16, C.TX_32X32, C.TX_32X64,
    C.TX_64X32, C.TX_64X64, C.TX_64X64, C.TX_64X64, C.TX_64X64,
    C.TX_4X16, C.TX_16X4, C.TX_8X32, C.TX_32X8, C.TX_16X64, C.TX_64X16,
]

# tx class
TX_CLASS_2D = 0
TX_CLASS_HORIZ = 1
TX_CLASS_VERT = 2


def tx_type_class(tx_type: int) -> int:
    if tx_type in (C.V_DCT, C.V_ADST, C.V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (C.H_DCT, C.H_ADST, C.H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


# ---------------------------------------------------------------------------
# Scan orders (spec §5.11.41): diagonal (up-right within anti-diagonals,
# starting bottom-left), plus row-major (mrow) and column-major (mcol).

@functools.lru_cache(maxsize=None)
def diag_scan(w: int, h: int) -> np.ndarray:
    """Default scan (verified against libaom tables): square txs zig-zag
    (odd anti-diagonals start top-right), tall txs uniform top-right
    start, wide txs uniform bottom-left start."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(min(d, h - 1), -1, -1)
                 if 0 <= d - r < w]  # bottom-left -> top-right
        if (w == h and d % 2 == 1) or h > w:
            cells = cells[::-1]
        out.extend(r * w + c for r, c in cells)
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mrow_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mcol_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int32).reshape(h, w).T.reshape(-1)


def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order over the adjusted tx size (spec get_scan)."""
    adj = ADJUSTED_TX_SIZE[tx_size]
    w, h = TX_WIDTH[adj], TX_HEIGHT[adj]
    cls = tx_type_class(tx_type)
    if cls == TX_CLASS_2D:
        return diag_scan(w, h)
    if cls == TX_CLASS_VERT:
        # 1-D vertical transform: energy along rows -> row-major scan
        return mrow_scan(w, h)
    return mcol_scan(w, h)


# ---------------------------------------------------------------------------
# Coefficient base-level context offsets (spec §8.3.2 Coeff_Base_Ctx_Offset).
# Generative rule recovered from libaom's per-position tables:
#   pos (0,0) -> 0; wide tx (w>h): col<2 -> 16; tall: row<2 -> 11;
#   else by clamped row+col: 1 -> 1, 2..3 -> 6, >=4 -> 21.

@functools.lru_cache(maxsize=None)
def coeff_base_ctx_offset(tx_size: int) -> np.ndarray:
    """2D-class sig-coef ctx offsets. The wide/tall band rule keys on the
    REAL tx shape (so TX_64X32 is 'wide' even though its coefficient array
    is the adjusted 32x32) — verified empirically against libdav1d, which
    otherwise desyncs on rect-64 streams."""
    adj = ADJUSTED_TX_SIZE[tx_size]
    w, h = TX_WIDTH[adj], TX_HEIGHT[adj]
    rw, rh = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    out = np.zeros((h, w), dtype=np.int32)
    for r in range(h):
        for c in range(w):
            if r == 0 and c == 0:
                v = 0
            elif rw > rh and c < 2:
                v = 16
            elif rh > rw and r < 2:
                v = 11
            else:
                s = min(r, 4) + min(c, 4)
                v = 1 if s == 1 else (6 if s <= 3 else 21)
            out[r, c] = v
    return out


SIG_COEF_CONTEXTS_2D = 26


@functools.lru_cache(maxsize=None)
def coeff_base_ctx_offset_1d(length: int) -> np.ndarray:
    """1-D tx classes: offset 26 + min(pos, 2) * 5 along the major axis."""
    pos = np.minimum(np.arange(length), 2)
    return (SIG_COEF_CONTEXTS_2D + pos * 5).astype(np.int32)


# ---------------------------------------------------------------------------
# Intra mode context (spec Intra_Mode_Context — for kf y mode cdf indexing)

INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# Mode to tx-type context mapping for intra tx-type coding
# (spec Intra_Mode_To_Tx_Type: DC->DCT, V->ADST?, ...)
INTRA_MODE_TO_TX_TYPE = [
    C.DCT_DCT,    # DC
    C.ADST_DCT,   # V
    C.DCT_ADST,   # H
    C.DCT_DCT,    # D45
    C.ADST_ADST,  # D135
    C.ADST_DCT,   # D113
    C.DCT_ADST,   # D157
    C.DCT_ADST,   # D203
    C.ADST_DCT,   # D67
    C.ADST_ADST,  # SMOOTH
    C.ADST_DCT,   # SMOOTH_V
    C.DCT_ADST,   # SMOOTH_H
    C.ADST_ADST,  # PAETH
]

# Tx set membership lists (spec §5.11.48): symbol order within each set.
TX_SET_INTRA_1 = [C.IDTX, C.DCT_DCT, C.V_DCT, C.H_DCT, C.ADST_ADST,
                  C.ADST_DCT, C.DCT_ADST]
TX_SET_INTRA_2 = [C.IDTX, C.DCT_DCT, C.ADST_ADST, C.ADST_DCT, C.DCT_ADST]
TX_SET_INTER_1 = [C.IDTX, C.V_DCT, C.H_DCT, C.V_ADST, C.H_ADST,
                  C.V_FLIPADST, C.H_FLIPADST, C.DCT_DCT, C.ADST_DCT,
                  C.DCT_ADST, C.FLIPADST_DCT, C.DCT_FLIPADST,
                  C.ADST_ADST, C.FLIPADST_FLIPADST, C.ADST_FLIPADST,
                  C.FLIPADST_ADST]
TX_SET_INTER_2 = [C.IDTX, C.V_DCT, C.H_DCT, C.DCT_DCT, C.ADST_DCT,
                  C.DCT_ADST, C.FLIPADST_DCT, C.DCT_FLIPADST, C.ADST_ADST,
                  C.FLIPADST_FLIPADST, C.ADST_FLIPADST, C.FLIPADST_ADST]
TX_SET_INTER_3 = [C.IDTX, C.DCT_DCT]


def get_tx_set_intra(tx_size: int, reduced_tx_set: bool) -> int:
    """Returns 0 (DCT only), 1 (TX_SET_INTRA_1), or 2 (TX_SET_INTRA_2)."""
    sqr_up = TX_SIZE_SQR_UP[tx_size]
    if sqr_up > C.TX_32X32:
        return 0
    if sqr_up == C.TX_32X32:
        return 0
    if reduced_tx_set:
        return 2
    if TX_SIZE_SQR[tx_size] == C.TX_16X16:
        return 2
    return 1


def get_tx_set_inter(tx_size: int, reduced_tx_set: bool) -> int:
    """Returns 0 (DCT only), 1, 2, or 3 per spec get_ext_tx_set."""
    sqr_up = TX_SIZE_SQR_UP[tx_size]
    if sqr_up > C.TX_32X32:
        return 0
    if sqr_up == C.TX_32X32:
        return 3
    if reduced_tx_set:
        return 3
    if TX_SIZE_SQR[tx_size] == C.TX_16X16:
        return 2
    return 1


# Quantizer helpers -----------------------------------------------------

def dc_q(qindex: int, bitdepth: int = 8) -> int:
    d = data()
    key = {8: "dc_qlookup", 10: "dc_qlookup_10", 12: "dc_qlookup_12"}[bitdepth]
    return int(d[key][max(0, min(255, qindex))])


def ac_q(qindex: int, bitdepth: int = 8) -> int:
    d = data()
    key = {8: "ac_qlookup", 10: "ac_qlookup_10", 12: "ac_qlookup_12"}[bitdepth]
    return int(d[key][max(0, min(255, qindex))])


# wedge availability: 4 bits (16 wedge shapes) for the 9 wedge-capable
# block sizes (libaom av1_wedge_params_lookup), 0 elsewhere
WEDGE_BITS = [0] * 22
for _b in (3, 4, 5, 6, 7, 8, 9, 18, 19):
    WEDGE_BITS[_b] = 4
