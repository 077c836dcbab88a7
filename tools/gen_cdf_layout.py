"""Generate the shared CDF-state layout for the native decoder.

Emits:
  - easyav1/native/av1_cdf_state.h : `CdfState` struct containing
    EVERY adaptive CDF table of the Python CdfContext (cdf.py), in a
    fixed canonical order, plus generated cdf_init()/cdf_reset_counters()
  - easyav1/native/cdf_layout.py : the same layout as a Python list
    [(key, shape)] so CdfContext <-> C blob conversion is loss-free.

The struct is entirely uint16_t arrays, so its memory image is the
plain concatenation of the tables (no padding) and a single memcpy
round-trips the full entropy state between the C decoder and the
Python reference decoder (spec load_cdfs / save_cdfs; dav1d cdf.c
keeps the same state in its CdfContext).

Run from the repo root: python tools/gen_cdf_layout.py
"""

import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from easyav1.video.av1 import tables as T

# canonical order — MUST match cdf.py CdfContext.default key population
COEF_KEYS = ["txb_skip", "eob_extra", "dc_sign", "coeff_base_eob",
             "coeff_base", "coeff_br", "eob_multi16", "eob_multi32",
             "eob_multi64", "eob_multi128", "eob_multi256",
             "eob_multi512", "eob_multi1024"]
MODE_KEYS = ["partition", "kf_y_mode", "y_mode", "uv_mode",
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
MV_PARTS = ["classes", "class0_fr", "fr", "sign", "class0_hp",
            "hp", "class0", "bits"]


def layout():
    """[(py_key, default_npz_key, shape, per_qctx)] in canonical order."""
    d = T.data()
    out = []
    for k in COEF_KEYS:
        out.append((k, k, d[k].shape[1:], True))
    for k in MODE_KEYS:
        out.append((k, k, d[k].shape, False))
    for ci in range(2):
        for part in MV_PARTS:
            k = f"mv_{part}_{ci}"
            out.append((k, k, d[k].shape, False))
            out.append((f"dv_{part}_{ci}", k, d[k].shape, False))
    out.append(("dv_joint", "mv_joint", d["mv_joint"].shape, False))
    return out


def main():
    lay = layout()

    # --- C header -----------------------------------------------------
    h = ["/* Generated by tools/gen_cdf_layout.py — do not edit.",
         " * Full adaptive-CDF state; memory image == packed table",
         " * concatenation (all uint16), shared with Python via",
         " * native/cdf_layout.py. */",
         "#pragma once", "#include <stdint.h>", "#include <string.h>",
         '#include "av1_tables.h"', "",
         "typedef struct {"]
    for key, _src, shape, _q in lay:
        dims = "".join(f"[{v}]" for v in shape)
        h.append(f"    uint16_t {key}{dims};")
    # trailing pad so 16-lane SIMD loads from the last row stay inside
    # the struct (not part of the interchange blob)
    h.append("    uint16_t simd_pad[16];")
    h.append("} CdfState;")
    h.append("")
    h.append("/* interchange blob excludes the SIMD pad */")
    h.append("#include <stddef.h>")
    h.append("#define CDF_BLOB_SIZE ((int)offsetof(CdfState, simd_pad))")
    h.append("")
    h.append("static void cdf_init(CdfState *c, int qctx) {")
    for key, src, shape, per_q in lay:
        if per_q:
            h.append(f"    memcpy(c->{key}, av1_{src}[qctx], "
                     f"sizeof(c->{key}));")
        else:
            h.append(f"    memcpy(c->{key}, av1_{src}, "
                     f"sizeof(c->{key}));")
    h.append("}")
    h.append("")
    # reset descriptor: (offset in u16 units, row_len, n_rows)
    h.append("typedef struct { uint32_t off; uint16_t row_len; "
             "uint32_t n_rows; } CdfRowDesc;")
    h.append("static const CdfRowDesc cdf_row_descs[] = {")
    off = 0
    for key, _src, shape, _q in lay:
        total = int(np.prod(shape))
        row = int(shape[-1])
        h.append(f"    {{{off}u, {row}, {total // row}u}}, /* {key} */")
        off += total
    h.append("};")
    h.append(f"#define CDF_TOTAL_U16 {off}")
    h.append("#define CDF_N_DESCS (sizeof(cdf_row_descs) / "
             "sizeof(cdf_row_descs[0]))")
    h.append("")
    h.append("/* zero every row's adaptation counter (libaom"
             " av1_reset_cdf_symbol_counters) */")
    h.append("static void cdf_reset_counters(CdfState *c) {")
    h.append("    uint16_t *base = (uint16_t *)c;")
    h.append("    for (size_t t = 0; t < CDF_N_DESCS; t++) {")
    h.append("        const CdfRowDesc *d = &cdf_row_descs[t];")
    h.append("        uint16_t *p = base + d->off + d->row_len - 1;")
    h.append("        for (uint32_t r = 0; r < d->n_rows; r++, "
             "p += d->row_len)")
    h.append("            *p = 0;")
    h.append("    }")
    h.append("}")
    h.append("")
    with open("easyav1/native/av1_cdf_state.h", "w") as f:
        f.write("\n".join(h))

    # --- Python layout -------------------------------------------------
    p = ['"""Generated by tools/gen_cdf_layout.py — do not edit.',
         "",
         "Packed CDF-blob layout shared with native/av1_cdf_state.h:",
         "the C CdfState struct is the plain uint16 concatenation of",
         "these tables in order, so CdfContext <-> blob conversion is",
         'a flat split/concat."""',
         "",
         "import numpy as np",
         "",
         "CDF_LAYOUT = ["]
    total = 0
    for key, _src, shape, _q in lay:
        p.append(f"    ({key!r}, {tuple(int(v) for v in shape)!r}),")
        total += int(np.prod(shape))
    p.append("]")
    p.append(f"CDF_TOTAL_U16 = {total}")
    p.append("CDF_BLOB_BYTES = CDF_TOTAL_U16 * 2")
    p.append("""

def _nest(arr):
    if arr.ndim == 1:
        return [int(v) for v in arr]
    return [_nest(a) for a in arr]


def cdf_to_blob(ctx) -> bytes:
    \"\"\"CdfContext -> packed uint16 blob (native CdfState image).\"\"\"
    parts = []
    for key, shape in CDF_LAYOUT:
        a = np.array(ctx.t[key], np.uint16)
        assert a.shape == shape, (key, a.shape, shape)
        parts.append(a.reshape(-1))
    return np.concatenate(parts).tobytes()


def blob_to_cdf(blob):
    \"\"\"Packed blob -> CdfContext (lists, decoder-mutable).\"\"\"
    from easyav1.video.av1.cdf import CdfContext
    flat = np.frombuffer(blob, np.uint16)
    assert flat.size == CDF_TOTAL_U16, flat.size
    t = {}
    off = 0
    for key, shape in CDF_LAYOUT:
        n = int(np.prod(shape))
        t[key] = _nest(flat[off:off + n].reshape(shape))
        off += n
    return CdfContext(t)
""")
    with open("easyav1/native/cdf_layout.py", "w") as f:
        f.write("\n".join(p))
    print(f"wrote av1_cdf_state.h + cdf_layout.py: {len(lay)} tables, "
          f"{total} u16 ({total * 2 / 1024:.1f} KB)")


if __name__ == "__main__":
    main()
