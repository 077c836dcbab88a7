#!/usr/bin/env python3
"""Extract AV1 spec-mandated constant tables from the system libaom binary.

The AV1 default CDF tables, dequantizer lookups, etc. are normative spec
constants (AV1 spec §9.4 "Default CDF tables", §7.12 dequant) identical in
every conforming implementation. This environment has no AV1 source trees,
so we recover the constants from the system `libaom.so` .rodata section
(structural extraction: AOM-layout CDF arrays are uint16 rows of
`nsym+1` entries — nsym-1 strictly-decreasing inverse-CDF boundaries, a
zero terminator and a zero adaptation counter).

The extracted values are validated two ways:
 1. structural invariants asserted here (decreasing rows, value ranges);
 2. end-to-end: the decoder using these tables must produce bit-exact
    output vs libdav1d on libaom-encoded fixtures (tests/test_av1*.py) —
    a single wrong table desynchronizes the arithmetic decoder instantly.

Output: easyav1/video/av1/tables_data.npz (committed artifact).
Offsets below are for Debian libaom 3.6.0 and only matter when
regenerating; at runtime only the .npz is used.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3"
OUT = Path(__file__).resolve().parent.parent / \
    "easyav1/video/av1/tables_data.npz"


def load_rodata() -> np.ndarray:
    tmp = "/tmp/_aom_rodata_extract.bin"
    subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                    LIBAOM, tmp], check=True)
    return np.fromfile(tmp, dtype="<u2")


def take_cdf(rod, offset, shape, nsym_per_row=None):
    """Extract a CDF array of `shape` (last dim = CDF_SIZE = width) and
    validate rows: `nsym_per_row(row_index) - 1` leading values strictly
    decreasing, remainder zero."""
    width = shape[-1]
    n_rows = int(np.prod(shape[:-1]))
    arr = rod[offset:offset + n_rows * width].reshape(n_rows, width).copy()
    for i in range(n_rows):
        nsym = nsym_per_row(i) if nsym_per_row else width - 1
        vals = arr[i, :nsym - 1]
        rest = arr[i, nsym - 1:]
        assert np.all(rest == 0), f"row {i}: expected zeros, got {rest}"
        if nsym > 1:
            assert np.all(vals > 0) and np.all(vals < 32768), \
                f"row {i}: out of range {vals}"
            assert np.all(np.diff(vals.astype(np.int32)) < 0), \
                f"row {i}: not decreasing {vals}"
    return arr.reshape(shape)


def icdf(*probs):
    """Build an AOM-layout CDF row from ascending probability boundaries."""
    return [32768 - p for p in probs] + [0, 0]


def pad_rows(rows, width):
    out = np.zeros((len(rows), width), dtype=np.uint16)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def main():
    rod = load_rodata()
    t = {}

    # ---- coefficient CDFs (av1/common/token_cdfs.h layout) ----
    t["coeff_base_eob"] = take_cdf(rod, 26160, (4, 5, 2, 4, 4))
    t["coeff_base"] = take_cdf(rod, 26800, (4, 5, 2, 42, 5))
    t["coeff_br"] = take_cdf(rod, 35200, (4, 5, 2, 21, 5))
    for name, off, syms in [("eob_multi1024", 39408, 11),
                            ("eob_multi512", 39600, 10),
                            ("eob_multi256", 39776, 9),
                            ("eob_multi128", 39936, 8),
                            ("eob_multi64", 40080, 7),
                            ("eob_multi32", 40208, 6),
                            ("eob_multi16", 40320, 5)]:
        t[name] = take_cdf(rod, off, (4, 2, 2, syms + 1))
    t["eob_extra"] = take_cdf(rod, 40416, (4, 5, 2, 9, 3))
    t["txb_skip"] = take_cdf(rod, 41504, (4, 5, 13, 3))
    t["dc_sign"] = take_cdf(rod, 42288, (4, 2, 3, 3))

    # ---- mode CDFs ----
    def pal_syms(i):
        return (i // 5) + 2  # palette sizes 2..8, 5 contexts each

    # NOTE: the blob at 42592 is the UV map-index table and 42912 the Y
    # one (validated empirically: real screen-content streams only
    # decode bit-exact vs dav1d with this assignment)
    t["palette_uv_color_index"] = take_cdf(rod, 42592, (7, 5, 9), pal_syms)
    t["palette_y_color_index"] = take_cdf(rod, 42912, (7, 5, 9), pal_syms)
    t["inter_ext_tx_set1"] = take_cdf(rod, 43684, (4, 17))       # 16 syms
    t["inter_ext_tx_set2"] = take_cdf(rod, 43752, (4, 17),
                                      lambda i: 12)
    t["inter_ext_tx_set3"] = take_cdf(rod, 43820, (4, 17), lambda i: 2)
    t["intra_ext_tx_set1"] = take_cdf(rod, 44772, (4, 13, 17),
                                      lambda i: 7)
    t["intra_ext_tx_set2"] = take_cdf(rod, 45656, (4, 13, 17),
                                      lambda i: 5)

    def part_syms(i):
        ctx = i  # [bsl][4 ctx]: 8x8 first (4 syms), mid (10), 128 (8)
        if ctx < 4:
            return 4
        if ctx >= 16:
            return 8
        return 10

    t["partition"] = take_cdf(rod, 46544, (20, 11), part_syms)
    t["uv_mode"] = take_cdf(rod, 46768, (2, 13, 15),
                            lambda i: 13 if i < 13 else 14)
    t["kf_y_mode"] = take_cdf(rod, 47168, (5, 5, 14))
    t["palette_y_size"] = take_cdf(rod, 47552, (7, 8))
    t["palette_uv_size"] = take_cdf(rod, 47608, (7, 8))
    t["angle_delta"] = take_cdf(rod, 47664, (8, 8))
    # y_mode (non-key frames): 4 block-size-group contexts
    t["y_mode"] = take_cdf(rod, 48448, (4, 14))
    t["switchable_interp"] = take_cdf(rod, 48504, (16, 4),
                                      lambda i: 3)
    t["tx_size"] = take_cdf(rod, 48616, (4, 3, 4),
                            lambda i: 2 if i < 3 else 3)
    # cfl_alpha: 4 contexts extract cleanly at 48705; contexts 4-5 are
    # stored in a packed form not yet decoded - duplicate ctx 3 for now
    # (UNVERIFIED; early fixtures disable cfl via vopt enable-cfl-intra=0).
    cfl4 = take_cdf(rod, 48705, (4, 17))
    t["cfl_alpha"] = np.concatenate([cfl4, cfl4[3:4], cfl4[3:4]], axis=0)
    # wedge_idx: [BLOCK_SIZES_ALL][CDF_SIZE(16)]; uniform rows for
    # non-wedge-capable sizes, data rows at enum positions 3..9 and 18,19.
    t["wedge_idx"] = take_cdf(rod, 43232, (22, 17))
    # motion vector context (entropymv.c nmv_context layout)
    t["mv_joint"] = take_cdf(rod, 48800, (1, 5))
    for ci, base in ((0, 48805), (1, 48874)):
        t[f"mv_classes_{ci}"] = take_cdf(rod, base, (1, 12))
        t[f"mv_class0_fr_{ci}"] = take_cdf(rod, base + 12, (2, 5))
        t[f"mv_fr_{ci}"] = take_cdf(rod, base + 22, (1, 5))
        t[f"mv_sign_{ci}"] = take_cdf(rod, base + 27, (1, 3))
        t[f"mv_class0_hp_{ci}"] = take_cdf(rod, base + 30, (1, 3))
        t[f"mv_hp_{ci}"] = take_cdf(rod, base + 33, (1, 3))
        t[f"mv_class0_{ci}"] = take_cdf(rod, base + 36, (1, 3))
        t[f"mv_bits_{ci}"] = take_cdf(rod, base + 39, (10, 3))
    # raw bool-cluster region kept for later forensic assignment of the
    # remaining inter-frame bool tables (newmv/refmv/comp refs/...).
    t["_raw_region_47728_48302"] = rod[47728:48302].copy()
    t["_raw_region_48568_48800"] = rod[48568:48800].copy()

    # ---- small tables with spec values (verified present in libaom
    # .rodata at 48576/48584/48592/48664/48680 in a packed auxiliary
    # structure; typed here in canonical AOM layout) ----
    t["skip"] = pad_rows([icdf(31671), icdf(16515), icdf(4576)], 3)
    t["intra_inter"] = pad_rows(
        [icdf(806), icdf(16662), icdf(20186), icdf(26538)], 3)
    t["spatial_seg"] = pad_rows(
        [icdf(5622, 7893, 16093, 18233, 27809, 28373, 32533),
         icdf(14274, 18230, 22557, 24935, 29980, 30851, 32344),
         icdf(27527, 28487, 28723, 28890, 32397, 32647, 32679)], 9)
    t["delta_q"] = pad_rows([icdf(28160, 32120, 32677)], 5)
    t["delta_lf"] = pad_rows([icdf(28160, 32120, 32677)], 5)
    t["delta_lf_multi"] = pad_rows([icdf(28160, 32120, 32677)] * 4, 5)
    t["cfl_sign"] = pad_rows(
        [icdf(1418, 2123, 13340, 18405, 26972, 28343, 32294)], 9)
    t["filter_intra_mode"] = pad_rows(
        [icdf(8949, 12776, 17211, 29558)], 6)
    t["inter_compound_mode"] = take_cdf(rod, 48224, (8, 9))

    # ---- dequantization lookups (spec §7.12.2) ----
    t["ac_qlookup"] = rod[151600:151600 + 256].copy()
    t["dc_qlookup"] = rod[152368:152368 + 256].copy()
    assert t["dc_qlookup"][0] == 4 and t["dc_qlookup"][255] == 1336
    assert t["ac_qlookup"][0] == 4 and t["ac_qlookup"][255] == 1828
    # 10/12-bit variants live adjacent; locate by leading values
    rodb = rod.tobytes()

    def find_u16(vals):
        s = np.array(vals, dtype="<u2").tobytes()
        pos = rodb.find(s)
        assert pos >= 0 and pos % 2 == 0, f"table not found: {vals[:4]}"
        return pos // 2

    t["dc_qlookup_10"] = rod[(o := find_u16([4, 9, 10, 13, 15, 17, 20, 22])):o + 256].copy()
    t["ac_qlookup_10"] = rod[(o := find_u16([4, 9, 11, 13, 16, 18, 21, 24])):o + 256].copy()
    t["dc_qlookup_12"] = rod[(o := find_u16([4, 12, 18, 25, 33, 41, 50, 60])):o + 256].copy()
    t["ac_qlookup_12"] = rod[(o := find_u16([4, 13, 19, 27, 35, 44, 54, 64])):o + 256].copy()

    # ---- intra prediction tables (spec §7.11.2) ----
    rod8 = np.fromfile("/tmp/_aom_rodata_extract.bin", dtype=np.uint8)
    # smooth-prediction weights, concatenated for block dims 4,8,16,32,64
    p = rod8.tobytes().find(bytes([255, 149, 85, 64, 255, 197, 146, 105]))
    assert p >= 0
    t["sm_weights"] = rod8[p:p + 4 + 8 + 16 + 32 + 64].copy()
    # directional-mode slope table Dr_Intra_Derivative[90] (nonzero at
    # even angles 2..88 per spec indexing; stored raw)
    o = find_u16([0, 0, 0, 0, 1023, 0, 0, 547]) + 1
    dr = rod[o:o + 90].copy()
    assert dr[3] == 1023 and dr[45] == 64 and dr[6] == 547
    t["dr_intra_derivative"] = dr

    np.savez_compressed(OUT, **t)
    print(f"wrote {OUT} with {len(t)} tables, "
          f"{sum(v.size for v in t.values())} u16 values")


if __name__ == "__main__":
    sys.exit(main())
