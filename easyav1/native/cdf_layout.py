"""Generated by tools/gen_cdf_layout.py — do not edit.

Packed CDF-blob layout shared with native/av1_cdf_state.h:
the C CdfState struct is the plain uint16 concatenation of
these tables in order, so CdfContext <-> blob conversion is
a flat split/concat."""

import numpy as np

CDF_LAYOUT = [
    ('txb_skip', (5, 13, 3)),
    ('eob_extra', (5, 2, 9, 3)),
    ('dc_sign', (2, 3, 3)),
    ('coeff_base_eob', (5, 2, 4, 4)),
    ('coeff_base', (5, 2, 42, 5)),
    ('coeff_br', (5, 2, 21, 5)),
    ('eob_multi16', (2, 2, 6)),
    ('eob_multi32', (2, 2, 7)),
    ('eob_multi64', (2, 2, 8)),
    ('eob_multi128', (2, 2, 9)),
    ('eob_multi256', (2, 2, 10)),
    ('eob_multi512', (2, 2, 11)),
    ('eob_multi1024', (2, 2, 12)),
    ('partition', (20, 11)),
    ('kf_y_mode', (5, 5, 14)),
    ('y_mode', (4, 14)),
    ('uv_mode', (2, 13, 15)),
    ('angle_delta', (8, 8)),
    ('palette_y_size', (7, 8)),
    ('palette_uv_size', (7, 8)),
    ('palette_y_color_index', (7, 5, 9)),
    ('palette_uv_color_index', (7, 5, 9)),
    ('intra_ext_tx_set1', (4, 13, 17)),
    ('intra_ext_tx_set2', (4, 13, 17)),
    ('inter_ext_tx_set1', (4, 17)),
    ('inter_ext_tx_set2', (4, 17)),
    ('inter_ext_tx_set3', (4, 17)),
    ('tx_size', (4, 3, 4)),
    ('skip', (3, 3)),
    ('intra_inter', (4, 3)),
    ('spatial_seg', (3, 9)),
    ('delta_q', (1, 5)),
    ('delta_lf', (1, 5)),
    ('delta_lf_multi', (4, 5)),
    ('cfl_sign', (1, 9)),
    ('cfl_alpha', (6, 17)),
    ('filter_intra_mode', (1, 6)),
    ('switchable_interp', (16, 4)),
    ('inter_compound_mode', (8, 9)),
    ('wedge_idx', (22, 17)),
    ('mv_joint', (1, 5)),
    ('newmv', (6, 3)),
    ('zeromv', (2, 3)),
    ('refmv', (6, 3)),
    ('drl', (3, 3)),
    ('compound_type', (22, 3)),
    ('interintra', (4, 3)),
    ('wedge_interintra', (22, 3)),
    ('interintra_mode', (4, 5)),
    ('motion_mode', (22, 4)),
    ('obmc', (22, 3)),
    ('single_ref', (3, 6, 3)),
    ('comp_ref', (3, 3, 3)),
    ('comp_bwdref', (3, 2, 3)),
    ('compound_index', (6, 3)),
    ('comp_group_idx', (6, 3)),
    ('skip_mode', (3, 3)),
    ('intrabc', (1, 3)),
    ('filter_intra_use', (22, 3)),
    ('palette_y_mode', (7, 3, 3)),
    ('palette_uv_mode', (2, 3)),
    ('switchable_restore', (1, 4)),
    ('wiener_restore', (1, 3)),
    ('sgrproj_restore', (1, 3)),
    ('comp_inter', (5, 3)),
    ('comp_ref_type', (5, 3)),
    ('uni_comp_ref', (3, 3, 3)),
    ('txfm_partition', (21, 3)),
    ('mv_classes_0', (1, 12)),
    ('dv_classes_0', (1, 12)),
    ('mv_class0_fr_0', (2, 5)),
    ('dv_class0_fr_0', (2, 5)),
    ('mv_fr_0', (1, 5)),
    ('dv_fr_0', (1, 5)),
    ('mv_sign_0', (1, 3)),
    ('dv_sign_0', (1, 3)),
    ('mv_class0_hp_0', (1, 3)),
    ('dv_class0_hp_0', (1, 3)),
    ('mv_hp_0', (1, 3)),
    ('dv_hp_0', (1, 3)),
    ('mv_class0_0', (1, 3)),
    ('dv_class0_0', (1, 3)),
    ('mv_bits_0', (10, 3)),
    ('dv_bits_0', (10, 3)),
    ('mv_classes_1', (1, 12)),
    ('dv_classes_1', (1, 12)),
    ('mv_class0_fr_1', (2, 5)),
    ('dv_class0_fr_1', (2, 5)),
    ('mv_fr_1', (1, 5)),
    ('dv_fr_1', (1, 5)),
    ('mv_sign_1', (1, 3)),
    ('dv_sign_1', (1, 3)),
    ('mv_class0_hp_1', (1, 3)),
    ('dv_class0_hp_1', (1, 3)),
    ('mv_hp_1', (1, 3)),
    ('dv_hp_1', (1, 3)),
    ('mv_class0_1', (1, 3)),
    ('dv_class0_1', (1, 3)),
    ('mv_bits_1', (10, 3)),
    ('dv_bits_1', (10, 3)),
    ('dv_joint', (1, 5)),
]
CDF_TOTAL_U16 = 9659
CDF_BLOB_BYTES = CDF_TOTAL_U16 * 2


def _nest(arr):
    if arr.ndim == 1:
        return [int(v) for v in arr]
    return [_nest(a) for a in arr]


def cdf_to_blob(ctx) -> bytes:
    """CdfContext -> packed uint16 blob (native CdfState image)."""
    parts = []
    for key, shape in CDF_LAYOUT:
        a = np.array(ctx.t[key], np.uint16)
        assert a.shape == shape, (key, a.shape, shape)
        parts.append(a.reshape(-1))
    return np.concatenate(parts).tobytes()


def blob_to_cdf(blob):
    """Packed blob -> CdfContext (lists, decoder-mutable)."""
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
