"""Intra edge-filter/upsample conformance fuzz: directional modes with
angle deltas under enable_intra_edge_filter=1, all block shapes, vs
libdav1d.  Run: python tests/fuzz_intra_edge.py [n_seeds]
"""

import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

from fixtures import CACHE, tool  # noqa: E402
from easyav1.video.av1 import constants as C  # noqa: E402
from av1_synth import (EncBlock, dav1d_decode_ivf, encode_frame,  # noqa: E402
                       make_ivf, my_decode_tu, assert_same)

W = H = 96
DIR_MODES = [C.V_PRED, C.H_PRED, C.D45_PRED, C.D135_PRED, C.D113_PRED,
             C.D157_PRED, C.D203_PRED, C.D67_PRED]


def rand_blocks(rng):
    """Mixed layout (32x32 slots + 16x16 sub-splits); every block gets
    random luma AND chroma (mode, angle delta) and random residual."""
    from fuzz_inter import _split_16
    import numpy as _np
    blocks = []
    occupied = _np.zeros((24, 24), bool)
    layout = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            if occupied[r, c]:
                continue
            if (r % 8 == 0 and c % 8 == 0 and r + 8 <= 24 and c + 8 <= 24
                    and rng.random() < 0.3):
                occupied[r:r + 8, c:c + 8] = True
                layout.append((r, c, C.BLOCK_32X32))
            else:
                occupied[r:r + 4, c:c + 4] = True
                layout.extend(_split_16(rng, r, c))
    for (rr, cc, bsize) in layout:
        mode = int(rng.choice(DIR_MODES + [C.DC_PRED, C.PAETH_PRED,
                                           C.SMOOTH_PRED]))
        ang = 0
        if mode in DIR_MODES and bsize >= C.BLOCK_8X8:
            ang = int(rng.integers(-3, 4))
        uv_mode = int(rng.choice(DIR_MODES + [C.DC_PRED,
                                              C.SMOOTH_PRED]))
        ang_uv = 0
        if uv_mode in DIR_MODES and bsize >= C.BLOCK_8X8:
            ang_uv = int(rng.integers(-3, 4))
        n = int(rng.integers(0, 6))
        blocks.append(EncBlock(
            r=rr, c=cc, bsize=bsize, y_mode=mode, angle_y=ang,
            uv_mode=uv_mode, angle_uv=ang_uv,
            skip=n == 0,
            luma_coeffs=None if n == 0 else
            [[(int(rng.integers(1, 14)), int(rng.integers(0, 2)))
              for _ in range(n)]]))
    return blocks


def run_seed(seed):
    rng = np.random.default_rng(seed)
    blocks = rand_blocks(rng)
    q = int(rng.integers(40, 200))
    tu = encode_frame(W, H, q, blocks, edge_filter=True)
    tag = f"iedge{seed}"
    try:
        dav = dav1d_decode_ivf(make_ivf([tu], W, H), tag)[0]
    except Exception as e:
        return f"REJECT {e}"
    mine = my_decode_tu(tu)
    for pi in ("y", "u", "v"):
        d = np.abs(dav[pi].astype(int) - mine[pi].astype(int))
        if d.max():
            ys, xs = np.nonzero(d)
            return (f"FAIL plane {pi} maxdiff {d.max()} "
                    f"first=({ys[0]},{xs[0]}) n={len(ys)}")
    return None


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    bad = 0
    for s in range(n):
        res = run_seed(s)
        if res:
            print(f"seed {s}: {res}")
            bad += 1
    print(f"done: {bad} failures / {n} seeds")
