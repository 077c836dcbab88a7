#!/usr/bin/env python3
"""Extract warped-motion / OBMC rodata constants from the system libaom.

These are normative spec constants (AV1 §7.11.3.5 Warp_Filter coeffs,
§7.11.3.8 Div_Lut, §7.11.3.10 Obmc_Mask_*); lifting them from libaom's
.rodata avoids hand-typing 1.5k numbers.  Located by structural
signatures (row sums, monotonicity, exact known prefixes) rather than
fixed offsets, so this is robust across libaom builds.

Appends: warped_filter (193,8) int16, div_lut (257,) uint16,
obmc_mask_{2,4,8,16,32} uint8 to easyav1/video/av1/tables_data.npz.
"""

import subprocess
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3"
OUT = Path(__file__).resolve().parent.parent / \
    "easyav1/video/av1/tables_data.npz"


def main():
    subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                    LIBAOM, "/tmp/_aom_ro.bin"], check=True)
    ro = np.fromfile("/tmp/_aom_ro.bin", dtype=np.uint8)
    r16 = ro[:len(ro) // 2 * 2].view(np.int16)
    ru16 = ro[:len(ro) // 2 * 2].view(np.uint16)

    # ---- av1_warped_filter: first row {0,0,127,1,0,0,0,0}, 193 rows
    # that each sum to 128
    row0 = np.array([0, 0, 127, 1, 0, 0, 0, 0], np.int16)
    wf = None
    for i in range(len(r16) - 193 * 8):
        if np.array_equal(r16[i:i + 8], row0):
            cand = r16[i:i + 193 * 8].reshape(193, 8)
            if np.all(cand.astype(int).sum(1) == 128):
                wf = cand.copy()
                break
    assert wf is not None, "warped filter table not found"

    # ---- div_lut: 257 uint16, 16384 .. 8192 non-increasing
    div = None
    for i in np.where(ru16 == 16384)[0]:
        seq = ru16[i:i + 257]
        if (len(seq) == 257 and seq[-1] == 8192 and 16300 < seq[1] < 16384
                and np.all(np.diff(seq.astype(int)) <= 0)):
            div = seq.copy()
            break
    assert div is not None, "div_lut not found"

    # ---- obmc blend masks (uint8, end in 64s)
    masks = {
        "obmc_mask_2": [45, 64],
        "obmc_mask_4": [39, 50, 59, 64],
        "obmc_mask_8": [36, 42, 48, 53, 57, 61, 64, 64],
        "obmc_mask_16": [34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61,
                         64, 64, 64, 64],
        "obmc_mask_32": [33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50,
                         51, 52, 53, 55, 56, 57, 58, 59, 60, 60, 61, 62,
                         64, 64, 64, 64, 64, 64, 64, 64],
    }
    for name, seq in masks.items():
        s = np.array(seq, np.uint8)
        view = np.lib.stride_tricks.sliding_window_view(ro, len(s))
        hits = np.where((view == s).all(1))[0]
        assert len(hits), f"{name} not found in rodata"

    data = dict(np.load(OUT))
    data["warped_filter"] = wf
    data["div_lut"] = div
    for name, seq in masks.items():
        data[name] = np.array(seq, np.uint8)
    np.savez_compressed(OUT, **data)
    # filter-intra taps (spec 7.11.2.3 Intra_Filter_Taps), located in
    # libaom .rodata by the normative first rows
    rod8 = np.fromfile("/tmp/_aom_ro.bin", dtype=np.int8)
    pat = np.array([-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10, 0, 0, 9, 0, 0],
                   np.int8)
    pos = -1
    for i in range(0, len(rod8) - 320):
        if (rod8[i:i + 16] == pat).all():
            pos = i
            break
    assert pos > 0
    t["filter_intra_taps"] = rod8[pos:pos + 320].reshape(5, 8, 8).copy()
    # interintra smooth-blend 1-D weights (libaom ii_weights1d)
    pat2 = np.array([60, 58, 56, 54, 52, 50, 48, 47, 45, 44], np.uint8)
    rodu = rod8.view(np.uint8)
    pos2 = -1
    for i in range(len(rodu) - 128):
        if (rodu[i:i + 10] == pat2).all():
            pos2 = i
            break
    assert pos2 > 0
    t["ii_weights1d"] = rodu[pos2:pos2 + 128].copy()
    np.savez_compressed(OUT, **t)
    print(f"appended warp/obmc tables -> {OUT}")


if __name__ == "__main__":
    main()
