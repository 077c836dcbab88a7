"""CDF context state: default init, per-tile copies, frame-level carry.

Parity: dav1d's cdf.c role (SURVEY.md §2d msac/cdf on host). CDF rows are
mutable Python lists (adapted in place by the msac decoder); the context
is deep-copied per tile and saved at frame end from the
context_update_tile_id tile when frame-end update is enabled.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np

from easyav1.video.av1.tables import data


class CdfContext:
    """Nested dict of table name -> nested lists with CDF rows (lists of
    ints) at the leaves."""

    def __init__(self, tables: Dict[str, list]):
        self.t = tables

    @classmethod
    def default(cls, base_q_idx: int) -> "CdfContext":
        """Default CDFs; the coefficient tables are selected by quantizer
        context (spec §5.11.14: qctx from base_q_idx thresholds)."""
        d = data()
        if base_q_idx <= 20:
            qctx = 0
        elif base_q_idx <= 60:
            qctx = 1
        elif base_q_idx <= 120:
            qctx = 2
        else:
            qctx = 3
        t = {}

        def conv(arr):
            if arr.ndim == 1:
                return [int(v) for v in arr]
            return [conv(a) for a in arr]

        coef_keys = ["txb_skip", "eob_extra", "dc_sign", "coeff_base_eob",
                     "coeff_base", "coeff_br", "eob_multi16", "eob_multi32",
                     "eob_multi64", "eob_multi128", "eob_multi256",
                     "eob_multi512", "eob_multi1024"]
        for k in coef_keys:
            t[k] = conv(d[k][qctx])
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
                     # inter-frame tables (tools/extract_inter_tables.py)
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
            t[k] = conv(d[k])
        for ci in range(2):
            for part in ["classes", "class0_fr", "fr", "sign", "class0_hp",
                         "hp", "class0", "bits"]:
                k = f"mv_{part}_{ci}"
                t[k] = conv(d[k])
                # intrabc DVs use an independent nmv context (libaom
                # fc->ndvc) initialized from the same defaults
                t[f"dv_{part}_{ci}"] = conv(d[k])
        t["dv_joint"] = conv(d["mv_joint"])
        return cls(t)

    def copy(self) -> "CdfContext":
        return CdfContext(copy.deepcopy(self.t))

    def reset_counters(self) -> None:
        """Zero every row's adaptation counter (libaom
        av1_reset_cdf_symbol_counters) — done when a frame's entropy
        state is saved for later primary_ref inheritance: probabilities
        carry across frames, counts do not."""
        def walk(x):
            if isinstance(x, list):
                if x and not isinstance(x[0], (list, dict)):
                    x[-1] = 0
                else:
                    for v in x:
                        walk(v)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
        walk(self.t)
