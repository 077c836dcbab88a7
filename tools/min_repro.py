"""Minimal single-block inter repro explorer: key frame of skip
blocks + one inter frame with a single interesting block, checked vs
dav1d.  Usage: python tools/min_repro.py"""

import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

from fixtures import CACHE, tool  # noqa: E402
from easyav1.container.webm import TrackInfo  # noqa: E402
from easyav1.video.av1 import constants as C  # noqa: E402
from easyav1.video.av1.av1_enc import EncBlock, make_ivf  # noqa: E402
from easyav1.video.av1.av1_enc_inter import (  # noqa: E402
    InterEncBlock, encode_inter_sequence)
from easyav1.video.av1.backend import AV1Backend  # noqa: E402

W = H = 96


def grid(bsize_fill, blocks_override):
    """Fill 24x24 mi with skip fillers except overridden slots."""
    out = []
    taken = np.zeros((24, 24), bool)
    for b in blocks_override:
        w4 = C.BLOCK_W4[b.bsize]
        h4 = C.BLOCK_H4[b.bsize]
        taken[b.r:b.r + h4, b.c:b.c + w4] = True
        out.append(b)
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            if taken[r, c]:
                continue
            out.append(InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                     is_inter=True, ref=C.LAST_FRAME,
                                     mode=C.GLOBALMV, skip=True))
    return sorted(out, key=lambda b: (b.r // 16 * 100 + b.c // 16,
                                      b.r, b.c))


def key_blocks():
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                     luma_coeffs=[[(3 + ((r * 7 + c) % 5), (r + c) & 1)
                                   for _ in range(4)]])
            for r in range(0, 24, 4) for c in range(0, 24, 4)]


def check(tag, blocks, q=188, adapt=False, tx_sel=True):
    frames = [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, grid(None, blocks))]
    tus = encode_inter_sequence(W, H, q, frames, hp_mv=True,
                                adapt=adapt, tx_select=tx_sel)
    p = CACHE / "min_repro.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "min_repro"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(f"{tag}: dav1d REJECT")
        return None
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    bad = 0
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        off = fi * per
        gold = raw[off:off + W * H].reshape(H, W)
        d = np.abs(gold.astype(int) - f.data[0].astype(int))
        if d.max():
            ys, xs = np.nonzero(d)
            print(f"{tag}: FAIL frame {fi} n={len(ys)} "
                  f"first=({ys[0]},{xs[0]}) max={d.max()}")
            bad += 1
            break
    if not bad:
        print(f"{tag}: ok")
    return bad


def full_set(bs, mode, **kw):
    """All sibling blocks needed so the partition tree is complete;
    the first block carries the interesting mode, the rest skip."""
    w4 = C.BLOCK_W4[bs]
    h4 = C.BLOCK_H4[bs]
    if w4 >= 4 and h4 >= 4:
        offs = [(0, 0)]
    else:
        offs = [(dr, dc) for dr in range(0, 4, max(1, h4))
                for dc in range(0, 4, max(1, w4))]
    out = []
    for i, (dr, dc) in enumerate(offs):
        if i == 0:
            out.append(InterEncBlock(r=8 + dr, c=8 + dc, bsize=bs,
                                     is_inter=True, ref=C.LAST_FRAME,
                                     mode=mode, skip=True, **kw))
        else:
            out.append(InterEncBlock(r=8 + dr, c=8 + dc, bsize=bs,
                                     is_inter=True, ref=C.LAST_FRAME,
                                     mode=C.GLOBALMV, skip=True))
    return out


if __name__ == "__main__":
    # sweep: one NEWMV block of each suspicious size
    for bs, name in [(C.BLOCK_16X4, "16X4"), (C.BLOCK_4X16, "4X16"),
                     (C.BLOCK_16X16, "16X16"), (C.BLOCK_8X4, "8X4"),
                     (C.BLOCK_4X8, "4X8"), (C.BLOCK_32X32, "32X32")]:
        check(f"newmv_{name}", full_set(bs, C.NEWMV, mv=(-35, 23)))
        check(f"near2_{name}", full_set(bs, C.NEARMV, ref_mv_idx=2))
        check(f"nearest_{name}", full_set(bs, C.NEARESTMV))


def mv_fuzz(seed, nblk=36):
    """Random NEWMV/NEAR mvs over the grid — isolates refmvs stack
    construction from coeffs."""
    rng = np.random.default_rng(seed)
    blocks = []
    sizes = [C.BLOCK_16X16, C.BLOCK_16X8, C.BLOCK_8X16,
             C.BLOCK_16X4, C.BLOCK_4X16]
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            bs = sizes[int(rng.integers(0, len(sizes)))]
            w4, h4 = C.BLOCK_W4[bs], C.BLOCK_H4[bs]
            for dr in range(0, 4, max(1, h4)):
                for dc in range(0, 4, max(1, w4)):
                    mode = int(rng.choice(
                        [C.NEWMV, C.NEARESTMV, C.NEARMV, C.GLOBALMV],
                        p=[0.5, 0.2, 0.2, 0.1]))
                    b = InterEncBlock(
                        r=r + dr, c=c + dc, bsize=bs, is_inter=True,
                        ref=int(rng.choice([C.LAST_FRAME, C.LAST2_FRAME,
                                            C.GOLDEN_FRAME])),
                        mode=mode, skip=True)
                    if mode == C.NEWMV:
                        b.mv = (int(rng.integers(-48, 49)),
                                int(rng.integers(-48, 49)))
                    if mode == C.NEARMV:
                        b.ref_mv_idx = int(rng.integers(1, 3))
                    blocks.append(b)
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    tus = encode_inter_sequence(W, H, 100, frames, hp_mv=True,
                                adapt=False, tx_select=False)
    p = CACHE / "min_repro.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "min_repro"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(f"mvfuzz{seed}: REJECT")
        return
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        gold = raw[fi * per:fi * per + W * H].reshape(H, W)
        d = np.abs(gold.astype(int) - f.data[0].astype(int))
        if d.max():
            ys, xs = np.nonzero(d)
            print(f"mvfuzz{seed}: FAIL frame {fi} n={len(ys)} "
                  f"first=({ys[0]},{xs[0]})")
            return blocks
    print(f"mvfuzz{seed}: ok")
