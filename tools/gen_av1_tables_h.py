"""Generate native/av1_tables.h from tables_data.npz.

Emits the default CDF tables, scan orders, context-offset tables and
misc lookup tables consumed by the C tile decoder (native/av1_tile.c).
Run from the repo root:  python tools/gen_av1_tables_h.py
"""

import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.cdf import CdfContext


def emit_array(out, name, arr, ctype="uint16_t"):
    arr = np.asarray(arr)
    flat = arr.reshape(-1)
    dims = "".join(f"[{d}]" for d in arr.shape)
    out.append(f"static const {ctype} {name}{dims} = {{")
    line = []
    txt = []
    for v in flat.tolist():
        line.append(str(int(v)))
        if len(line) == 12:
            txt.append("  " + ", ".join(line) + ",")
            line = []
    if line:
        txt.append("  " + ", ".join(line) + ",")
    body = "\n".join(txt)
    # re-nest braces are unnecessary in C if we use flat init with dims --
    # C allows a flat initializer list for nested arrays
    out.append(body)
    out.append("};\n")


def main():
    out = ["/* Generated by tools/gen_av1_tables_h.py — do not edit. */",
           "#pragma once", "#include <stdint.h>", ""]

    d = T.data()

    # per-qctx coef tables + mode tables, flattened via CdfContext
    coef_keys = ["txb_skip", "eob_extra", "dc_sign", "coeff_base_eob",
                 "coeff_base", "coeff_br", "eob_multi16", "eob_multi32",
                 "eob_multi64", "eob_multi128", "eob_multi256",
                 "eob_multi512", "eob_multi1024"]
    for k in coef_keys:
        emit_array(out, f"av1_{k}", d[k])
    mode_keys = ["partition", "kf_y_mode", "y_mode", "uv_mode",
                 "angle_delta", "palette_y_size", "palette_uv_size",
                 "palette_y_color_index", "palette_uv_color_index",
                 "intra_ext_tx_set1", "intra_ext_tx_set2",
                 "inter_ext_tx_set1", "inter_ext_tx_set2",
                 "inter_ext_tx_set3", "tx_size", "skip", "intra_inter",
                 "spatial_seg", "delta_q", "delta_lf", "delta_lf_multi",
                 "cfl_sign", "cfl_alpha", "filter_intra_mode",
                 "switchable_interp", "inter_compound_mode", "wedge_idx",
                 "mv_joint",
                 "newmv", "zeromv", "refmv", "drl", "compound_type",
                 "interintra", "wedge_interintra", "interintra_mode",
                 "motion_mode", "obmc", "single_ref", "comp_ref",
                 "comp_bwdref", "compound_index", "comp_group_idx",
                 "skip_mode", "intrabc", "filter_intra_use",
                 "palette_y_mode", "palette_uv_mode",
                 "switchable_restore", "wiener_restore",
                 "sgrproj_restore", "comp_inter", "comp_ref_type",
                 "uni_comp_ref", "txfm_partition"]
    for k in mode_keys:
        emit_array(out, f"av1_{k}", d[k])
    for ci in range(2):
        for part in ["classes", "class0_fr", "fr", "sign", "class0_hp",
                     "hp", "class0", "bits"]:
            k = f"mv_{part}_{ci}"
            emit_array(out, f"av1_{k}", d[k])
    emit_array(out, "av1_filter_intra_taps", d["filter_intra_taps"],
               "int8_t")

    # inter reconstruction tables
    for k in ["mc_filter_regular8", "mc_filter_smooth8",
              "mc_filter_sharp8", "mc_filter_regular4",
              "mc_filter_smooth4", "mc_filter_bilinear",
              "warped_filter"]:
        emit_array(out, f"av1_{k}", d[k], "int16_t")
    emit_array(out, "av1_div_lut", d["div_lut"], "uint16_t")
    emit_array(out, "av1_ii_weights1d", d["ii_weights1d"], "uint8_t")
    emit_array(out, "av1_gaussian_sequence", d["gaussian_sequence"],
               "int16_t")
    for n in (2, 4, 8, 16, 32):
        emit_array(out, f"av1_obmc_mask_{n}", d[f"obmc_mask_{n}"],
                   "uint8_t")
    emit_array(out, "av1_tx_set_inter_1", np.array(T.TX_SET_INTER_1),
               "int8_t")
    emit_array(out, "av1_tx_set_inter_2", np.array(T.TX_SET_INTER_2),
               "int8_t")
    emit_array(out, "av1_tx_set_inter_3", np.array(T.TX_SET_INTER_3),
               "int8_t")
    # spec Size_Group_Lookup (y_mode ctx on inter frames)
    emit_array(out, "av1_size_group",
               np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
                         0, 0, 1, 1, 2, 2]), "int8_t")
    emit_array(out, "av1_wedge_bits", np.array(T.WEDGE_BITS), "int8_t")

    # quant lookups
    for k in ["dc_qlookup", "ac_qlookup", "dc_qlookup_10", "ac_qlookup_10",
              "dc_qlookup_12", "ac_qlookup_12"]:
        emit_array(out, f"av1_{k}", d[k], "int16_t")

    # scans: [tx_size][class] -> int16 positions (adjusted area), padded
    scans = np.zeros((19, 3, 1024), np.int16)
    scan_len = np.zeros((19, 3), np.int16)
    cls_type = {0: C.DCT_DCT, 1: C.H_DCT, 2: C.V_DCT}  # 2D, HORIZ?, VERT?
    for tx in range(19):
        for cls in range(3):
            # pick a tx_type of each class
            tt = {0: C.DCT_DCT, 1: C.V_DCT, 2: C.H_DCT}[cls]
            # ensure class mapping: 1 = HORIZ class types, 2 = VERT
            if cls == 1:
                tt = C.H_DCT
            elif cls == 2:
                tt = C.V_DCT
            s = T.get_scan(tx, tt)
            scans[tx, cls, :len(s)] = s
            scan_len[tx, cls] = len(s)
    emit_array(out, "av1_scans", scans, "int16_t")
    emit_array(out, "av1_scan_len", scan_len, "int16_t")

    # coeff base ctx offsets (2D class) per tx size, padded 32x32
    offs = np.zeros((19, 1024), np.int8)
    for tx in range(19):
        o = T.coeff_base_ctx_offset(tx).reshape(-1)
        offs[tx, :len(o)] = o
    emit_array(out, "av1_base_ctx_offsets", offs, "int8_t")

    # intra prediction tables
    emit_array(out, "av1_sm_weights", d["sm_weights"], "uint8_t")
    emit_array(out, "av1_dr_intra", d["dr_intra_derivative"], "uint16_t")

    # misc size tables
    emit_array(out, "av1_block_w4", np.array(C.BLOCK_W4[:22]), "int8_t")
    emit_array(out, "av1_block_h4", np.array(C.BLOCK_H4[:22]), "int8_t")
    emit_array(out, "av1_tx_w", np.array(T.TX_WIDTH[:19]), "int8_t")
    emit_array(out, "av1_tx_h", np.array(T.TX_HEIGHT[:19]), "int8_t")
    emit_array(out, "av1_tx_w4", np.array(C.TX_W4[:19]), "int8_t")
    emit_array(out, "av1_tx_h4", np.array(C.TX_H4[:19]), "int8_t")
    emit_array(out, "av1_tx_sqr_up", np.array(T.TX_SIZE_SQR_UP[:19]),
               "int8_t")
    emit_array(out, "av1_tx_sqr", np.array(T.TX_SIZE_SQR[:19]), "int8_t")
    emit_array(out, "av1_adj_tx", np.array(T.ADJUSTED_TX_SIZE[:19]),
               "int8_t")
    emit_array(out, "av1_split_tx", np.array(T.SPLIT_TX_SIZE[:19]),
               "int8_t")
    emit_array(out, "av1_max_tx_rect", np.array(T.MAX_TX_SIZE_RECT[:22]),
               "int8_t")
    emit_array(out, "av1_intra_mode_ctx",
               np.array(T.INTRA_MODE_CONTEXT), "int8_t")
    emit_array(out, "av1_intra_mode_to_tx",
               np.array(T.INTRA_MODE_TO_TX_TYPE), "int8_t")
    emit_array(out, "av1_tx_set_intra_1", np.array(T.TX_SET_INTRA_1),
               "int8_t")
    emit_array(out, "av1_tx_set_intra_2", np.array(T.TX_SET_INTRA_2),
               "int8_t")
    # tx type -> class (0 2D, 1 horiz, 2 vert)
    cls = []
    for tt in range(16):
        c = T.tx_type_class(tt)
        cls.append({T.TX_CLASS_2D: 0, T.TX_CLASS_HORIZ: 1,
                    T.TX_CLASS_VERT: 2}[c])
    emit_array(out, "av1_tx_type_class", np.array(cls), "int8_t")
    # partition ctx values
    emit_array(out, "av1_part_above",
               np.array([max(0, 64 - 2 * C.BLOCK_W4[b]) for b in range(22)]),
               "int8_t")
    emit_array(out, "av1_part_left",
               np.array([max(0, 64 - 2 * C.BLOCK_H4[b]) for b in range(22)]),
               "int8_t")

    with open("easyav1/native/av1_tables.h", "w") as f:
        f.write("\n".join(out))
    print("wrote easyav1/native/av1_tables.h",
          sum(len(l) for l in out) // 1024, "KB")


if __name__ == "__main__":
    main()
