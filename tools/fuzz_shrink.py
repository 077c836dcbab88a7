"""Shrink a failing fuzz_inter seed to a minimal block set.
Replaces 16x16 slots with plain skip fillers while the dav1d mismatch
persists, then prints the surviving blocks.
Usage: EASYAV1_NATIVE=0 python tools/fuzz_shrink.py <seed>"""

import json
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
import fuzz_inter as FZ  # noqa: E402


def fails(frames, adapt, tx_sel, q):
    tus = encode_inter_sequence(FZ.W, FZ.H, q, frames, hp_mv=True,
                                adapt=adapt, tx_select=tx_sel)
    p = CACHE / "fuzz_shrink.ivf"
    p.write_bytes(make_ivf(tus, FZ.W, FZ.H))
    prefix = CACHE / "fuzz_shrink"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    if r.returncode != 0:
        return False  # reject: treat as not reproducing
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = FZ.W * FZ.H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        try:
            f = be.decode([tu], 0)[0]
        except Exception:
            return True
        b = fi * per
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = b + (0 if pi == 0 else FZ.W * FZ.H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            if np.abs(gold.astype(int) - f.data[pi].astype(int)).max():
                return True
    return False


def slot_of(b):
    return (b.r // 4 * 4, b.c // 4 * 4)


def filler(slot):
    return [InterEncBlock(r=slot[0], c=slot[1], bsize=C.BLOCK_16X16,
                          is_inter=True, ref=C.LAST_FRAME)]


def kf_filler(slot):
    return [EncBlock(r=slot[0], c=slot[1], bsize=C.BLOCK_16X16)]


def main():
    seed = int(sys.argv[1])
    rng = np.random.default_rng(seed)
    kb = FZ.rand_blocks(rng, intra_frame=True)
    frames = [(C.KEY_FRAME, kb)]
    for _ in range(int(rng.integers(1, 3))):
        frames.append((C.INTER_FRAME, FZ.rand_blocks(rng)))
    adapt = bool(rng.random() < 0.5)
    tx_sel = bool(rng.random() < 0.5)
    q = int(rng.integers(40, 200))
    assert fails(frames, adapt, tx_sel, q), "seed does not reproduce"

    changed = True
    while changed:
        changed = False
        for fi in range(len(frames)):
            ftype, blocks = frames[fi]
            slots = sorted({slot_of(b) for b in blocks})
            # 32x32 blocks occupy 4 slots; group by anchor block
            for s in slots:
                keep, drop = [], []
                for b in blocks:
                    anchor = slot_of(b)
                    big = C.BLOCK_W4[b.bsize] > 4
                    covers = (anchor == s or
                              (big and anchor[0] <= s[0] < anchor[0]
                               + C.BLOCK_H4[b.bsize]
                               and anchor[1] <= s[1] < anchor[1]
                               + C.BLOCK_W4[b.bsize]))
                    (drop if covers else keep)(b) if False else \
                        (drop.append(b) if covers else keep.append(b))
                if not drop:
                    continue
                covered = set()
                for b in drop:
                    a = slot_of(b)
                    for dr in range(0, C.BLOCK_H4[b.bsize] or 1, 4):
                        for dc in range(0, C.BLOCK_W4[b.bsize] or 1, 4):
                            covered.add((a[0] + dr, a[1] + dc))
                mk = kf_filler if ftype == C.KEY_FRAME else filler
                trial = keep + [blk for a in sorted(covered)
                                for blk in mk(a)]
                cand = list(frames)
                cand[fi] = (ftype, trial)
                if fails(cand, adapt, tx_sel, q):
                    frames = cand
                    blocks = trial
                    changed = True

    # per-block field simplification
    for fi in range(len(frames)):
        ftype, blocks = frames[fi]
        for i in range(len(blocks)):
            for field, val in (("skip", True), ("luma_coeffs", None),
                               ("chroma_coeffs", None), ("mv", (0, 0)),
                               ("mode", C.NEARESTMV), ("ref", C.LAST_FRAME),
                               ("is_inter", True), ("y_mode", C.DC_PRED),
                               ("ref_mv_idx", 0), ("tx_depth", 0)):
                if not hasattr(blocks[i], field):
                    continue
                old = getattr(blocks[i], field)
                if old == val:
                    continue
                setattr(blocks[i], field, val)
                if not fails(frames, adapt, tx_sel, q):
                    setattr(blocks[i], field, old)

    print(f"MINIMAL (adapt={adapt} tx_sel={tx_sel} q={q}):")
    for fi, (ftype, blocks) in enumerate(frames):
        print(f"frame {fi} type={ftype}:")
        for b in blocks:
            print("  ", b)


if __name__ == "__main__":
    main()
