"""Randomized AV1 synth conformance fuzzer.

Generates random block layouts / modes / coefficients with the synth
encoder, decodes with both libdav1d and our decoder, and reports
mismatching seeds.  Used interactively during bring-up:

    python tests/fuzz_av1.py 0 200        # seeds 0..199
"""

import random
import sys

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tests")

from easyav1.video.av1 import constants as C
from av1_synth import (EncBlock, assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu)

SQ = {4: C.BLOCK_4X4, 8: C.BLOCK_8X8, 16: C.BLOCK_16X16,
      32: C.BLOCK_32X32, 64: C.BLOCK_64X64}
MODES = [C.DC_PRED, C.V_PRED, C.H_PRED, C.D45_PRED, C.D135_PRED,
         C.D113_PRED, C.D157_PRED, C.D203_PRED, C.D67_PRED,
         C.SMOOTH_PRED, C.SMOOTH_V_PRED, C.SMOOTH_H_PRED, C.PAETH_PRED]


def rand_coeffs(rng, n_max=6, allow_golomb=True):
    n = rng.randint(0, n_max)
    if n == 0:
        return []
    out = []
    for i in range(n):
        hi = 120 if (allow_golomb and rng.random() < 0.1) else 14
        lvl = rng.randint(0, hi) if i < n - 1 else rng.randint(1, hi)
        out.append((lvl, rng.randint(0, 1)))
    return out


def rand_block(rng, r, c, size4, tx_select):
    """Emit EncBlocks covering the size4 x size4 square at (r, c)."""
    blocks = []
    sz = size4 * 4
    choices = ["none"]
    if sz > 8:
        choices += ["split", "horz", "vert"]
    else:
        choices += ["split", "horz", "vert"]
    kind = rng.choice(choices)
    half = size4 // 2

    def mk(rr, cc, bsize):
        skip = rng.random() < 0.4
        ym = rng.choice(MODES)
        kw = dict(y_mode=ym, skip=skip)
        if C.V_PRED <= ym <= C.D67_PRED and bsize >= C.BLOCK_8X8 \
                and rng.random() < 0.5:
            kw["angle_y"] = rng.randint(-3, 3)
        w4, h4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
        cfl_ok = w4 * 4 <= 32 and h4 * 4 <= 32
        has_chroma = not ((h4 == 1 and (rr & 1) == 0) or
                          (w4 == 1 and (cc & 1) == 0))
        if has_chroma and cfl_ok and rng.random() < 0.25:
            au = rng.randint(-16, 16)
            av = rng.randint(-16, 16)
            if au or av:
                kw["cfl"] = (au, av)
        elif has_chroma and rng.random() < 0.3:
            uvm = rng.choice(MODES)
            kw["uv_mode"] = uvm
            if C.V_PRED <= uvm <= C.D67_PRED and bsize >= C.BLOCK_8X8 \
                    and rng.random() < 0.5:
                kw["angle_uv"] = rng.randint(-3, 3)
        if not skip:
            depth = 0
            if tx_select and rng.random() < 0.4 and bsize != C.BLOCK_4X4:
                depth = 1
            kw["tx_depth"] = depth
            if rng.random() < 0.4:
                kw["tx_type"] = rng.choice([0, 1, 2, 3, 9, 10, 11])
            tx = C and None
            # number of luma tx blocks
            from easyav1.video.av1 import tables as T
            txs = T.MAX_TX_SIZE_RECT[bsize]
            for _ in range(depth):
                txs = T.SPLIT_TX_SIZE[txs]
            ntx = (C.BLOCK_W4[bsize] // T.TX_W4[txs]) * \
                  (C.BLOCK_H4[bsize] // T.TX_H4[txs])
            kw["luma_coeffs"] = [rand_coeffs(rng) for _ in range(ntx)]
            if has_chroma and rng.random() < 0.5:
                kw["chroma_coeffs"] = [rand_coeffs(rng, 4),
                                       rand_coeffs(rng, 4)]
        return EncBlock(rr, cc, bsize, **kw)

    if kind == "none" or size4 == 1:
        blocks.append(mk(r, c, SQ[sz]))
    elif kind == "horz":
        hb = {8: C.BLOCK_8X4, 16: C.BLOCK_16X8, 32: C.BLOCK_32X16,
              64: C.BLOCK_64X32}[sz]
        blocks.append(mk(r, c, hb))
        blocks.append(mk(r + half, c, hb))
    elif kind == "vert":
        vb = {8: C.BLOCK_4X8, 16: C.BLOCK_8X16, 32: C.BLOCK_16X32,
              64: C.BLOCK_32X64}[sz]
        blocks.append(mk(r, c, vb))
        blocks.append(mk(r, c + half, vb))
    else:  # split
        if sz == 8:
            for dr in (0, 1):
                for dc in (0, 1):
                    blocks.append(mk(r + dr, c + dc, C.BLOCK_4X4))
        else:
            for dr in (0, half):
                for dc in (0, half):
                    blocks.extend(rand_block(rng, r + dr, c + dc, half,
                                             tx_select))
    return blocks


def run_seed(seed, verbose=False):
    rng = random.Random(seed)
    tx_select = rng.random() < 0.5
    adapt = rng.random() < 0.5
    edge_filter = rng.random() < 0.5
    q = rng.choice([20, 40, 80, 120, 180, 235])
    blocks = rand_block(rng, 0, 0, 16, tx_select)
    tu = encode_frame(64, 64, q, blocks, adapt=adapt,
                      tx_mode_select=tx_select, edge_filter=edge_filter)
    dav = dav1d_decode_ivf(make_ivf([tu], 64, 64), f"fuzz{seed}")[0]
    mine = my_decode_tu(tu)
    bad = 0
    for p in ("y", "u", "v"):
        d = np.abs(dav[p].astype(int) - mine[p].astype(int))
        bad = max(bad, int(d.max()))
    if verbose or bad:
        print(f"seed {seed}: q={q} adapt={adapt} txsel={tx_select} "
              f"blocks={len(blocks)} -> {'OK' if not bad else f'DIFF {bad}'}")
    return bad == 0


if __name__ == "__main__":
    lo = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    hi = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    fails = []
    for s in range(lo, hi):
        try:
            if not run_seed(s):
                fails.append(s)
        except Exception as e:
            print(f"seed {s}: EXC {str(e)[:80]}")
            fails.append(s)
    print(f"{hi - lo} seeds, {len(fails)} failures: {fails[:20]}")
