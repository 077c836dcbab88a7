"""Randomized inter-frame conformance fuzzer: random mode/mv/skip
mixes through the synth encoder, verified bit-exact vs libdav1d and our
decoder.  Run: python tests/fuzz_inter.py [n_seeds]"""

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
    InterEncBlock, encode_inter_sequence, encode_ref_sequence)
from easyav1.video.av1.backend import AV1Backend  # noqa: E402

W = H = 96


def _split_16(rng, r, c):
    """Random sub-layout of one 16x16 slot (4x4 mi), incl. rect, 4:1
    and 8x8-level splits."""
    kind = rng.choice(["n", "h", "v", "h4", "v4", "q"],
                      p=[0.4, 0.12, 0.12, 0.13, 0.13, 0.1])
    if kind == "n":
        return [(r, c, C.BLOCK_16X16)]
    if kind == "h":
        return [(r, c, C.BLOCK_16X8), (r + 2, c, C.BLOCK_16X8)]
    if kind == "v":
        return [(r, c, C.BLOCK_8X16), (r, c + 2, C.BLOCK_8X16)]
    if kind == "h4":
        return [(r + i, c, C.BLOCK_16X4) for i in range(4)]
    if kind == "v4":
        return [(r, c + i, C.BLOCK_4X16) for i in range(4)]
    out = []
    for (rr, cc) in ((r, c), (r, c + 2), (r + 2, c), (r + 2, c + 2)):
        k8 = rng.choice(["n", "h", "v", "q"], p=[0.55, 0.15, 0.15, 0.15])
        if k8 == "n":
            out.append((rr, cc, C.BLOCK_8X8))
        elif k8 == "h":
            out += [(rr, cc, C.BLOCK_8X4), (rr + 1, cc, C.BLOCK_8X4)]
        elif k8 == "v":
            out += [(rr, cc, C.BLOCK_4X8), (rr, cc + 1, C.BLOCK_4X8)]
        else:
            out += [(rr + dr, cc + dc, C.BLOCK_4X4)
                    for dr in (0, 1) for dc in (0, 1)]
    return out


def rand_blocks(rng, intra_frame=False):
    """Mixed grid over 96x96 (24x24 mi): 32x32 / 16x16 slots with
    random rect / 4:1 / small-block sub-layouts."""
    blocks = []
    r = 0
    layout = []
    # choose per-16mi-SB a split pattern
    occupied = np.zeros((24, 24), bool)
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            if occupied[r, c]:
                continue
            if (r % 8 == 0 and c % 8 == 0 and r + 8 <= 24 and c + 8 <= 24
                    and rng.random() < 0.3):
                bsize = C.BLOCK_32X32
                occupied[r:r + 8, c:c + 8] = True
                layout.append((r, c, bsize))
            else:
                occupied[r:r + 4, c:c + 4] = True
                layout.extend(_split_16(rng, r, c))
    for (r, c, bsize) in layout:
        if intra_frame:
            ncoef = int(rng.integers(0, 8))
            blocks.append(EncBlock(
                r=r, c=c, bsize=bsize, skip=ncoef == 0,
                luma_coeffs=None if ncoef == 0 else
                [[(int(rng.integers(1, 9)), int(rng.integers(0, 2)))
                  for _ in range(ncoef)]]))
            continue
        if rng.random() < 0.2:
            # intra block in inter frame (optionally with residual)
            ncoef = int(rng.integers(0, 4))
            blocks.append(InterEncBlock(
                r=r, c=c, bsize=bsize, is_inter=False, skip=ncoef == 0,
                luma_coeffs=None if ncoef == 0 else
                [[(int(rng.integers(1, 9)), int(rng.integers(0, 2)))
                  for _ in range(ncoef)]],
                y_mode=int(rng.choice([C.DC_PRED, C.V_PRED, C.H_PRED,
                                       C.SMOOTH_PRED]))))
            continue
        mode = int(rng.choice([C.NEWMV, C.NEARESTMV, C.NEARMV,
                               C.GLOBALMV],
                              p=[0.4, 0.25, 0.25, 0.1]))
        blk = InterEncBlock(
            r=r, c=c, bsize=bsize, is_inter=True,
            ref=int(rng.choice([C.LAST_FRAME, C.LAST2_FRAME,
                                C.GOLDEN_FRAME, C.ALTREF_FRAME],
                               p=[0.7, 0.1, 0.1, 0.1])),
            mode=mode, skip=bool(rng.random() < 0.6))
        if mode == C.NEWMV:
            blk.mv = (int(rng.integers(-48, 49)),
                      int(rng.integers(-48, 49)))
        if mode == C.NEARMV:
            blk.ref_mv_idx = int(rng.integers(1, 3))
        if not blk.skip:
            n = int(rng.integers(1, 8))
            blk.luma_coeffs = [[(int(rng.integers(1, 9)),
                                 int(rng.integers(0, 2)))
                                for _ in range(n)]]
        yield_ok = True
        blocks.append(blk)
    return blocks


def run_seed(seed):
    rng = np.random.default_rng(seed)
    kb = rand_blocks(rng, intra_frame=True)
    frames = [(C.KEY_FRAME, kb)]
    for _ in range(int(rng.integers(1, 3))):
        frames.append((C.INTER_FRAME, rand_blocks(rng)))
    adapt = bool(rng.random() < 0.5)
    tx_sel = bool(rng.random() < 0.5)
    tus = encode_inter_sequence(W, H, int(rng.integers(40, 200)), frames,
                                hp_mv=True, adapt=adapt, tx_select=tx_sel)
    p = CACHE / "fuzz_inter.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "fuzz_inter"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    if r.returncode != 0:
        return f"seed {seed}: dav1d REJECT (encoder bug)"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    meta = json.loads(prefix.with_suffix(".json").read_text())
    if meta["vframes"] != len(frames):
        return f"seed {seed}: dav1d decoded {meta['vframes']} frames"
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        try:
            f = be.decode([tu], 0)[0]
        except Exception as e:  # noqa: BLE001
            return f"seed {seed}: frame {fi} EXC {type(e).__name__}: {e}"
        b = fi * per
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = b + (0 if pi == 0 else W * H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            d = np.abs(gold.astype(int) - f.data[pi].astype(int))
            if d.max():
                return (f"seed {seed}: frame {fi} plane {pi} maxdiff "
                        f"{d.max()} n={(d > 0).sum()} "
                        f"first={np.argwhere(d > 0)[0].tolist()} "
                        f"(adapt={adapt} txsel={tx_sel})")
    return None


_COMP_MODES = [C.NEAREST_NEARESTMV, C.NEAR_NEARMV, C.NEAREST_NEWMV,
               C.NEW_NEARESTMV, C.NEAR_NEWMV, C.NEW_NEARMV,
               C.GLOBAL_GLOBALMV, C.NEW_NEWMV]
_NEW_COMP = {C.NEAREST_NEWMV, C.NEW_NEARESTMV, C.NEAR_NEWMV,
             C.NEW_NEARMV, C.NEW_NEWMV}


def rand_blocks_comp(rng):
    """Mixed single/compound inter blocks (LAST fwd + BWDREF bwd)."""
    blocks = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            if rng.random() < 0.25:
                # single-ref filler
                mode = int(rng.choice([C.NEARESTMV, C.NEWMV, C.GLOBALMV]))
                blk = InterEncBlock(
                    r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                    ref=int(rng.choice([C.LAST_FRAME, C.BWDREF_FRAME])),
                    mode=mode, skip=bool(rng.random() < 0.7))
                if mode == C.NEWMV:
                    blk.mv = (2 * int(rng.integers(-16, 17)),
                              2 * int(rng.integers(-16, 17)))
            else:
                mode = int(rng.choice(_COMP_MODES))
                blk = InterEncBlock(
                    r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                    ref=C.LAST_FRAME, ref2=C.BWDREF_FRAME,
                    mode=mode, skip=bool(rng.random() < 0.7))
                if mode in _NEW_COMP:
                    blk.mv = (2 * int(rng.integers(-16, 17)),
                              2 * int(rng.integers(-16, 17)))
                    blk.mv2 = (2 * int(rng.integers(-16, 17)),
                               2 * int(rng.integers(-16, 17)))
                if mode in (C.NEAR_NEARMV, C.NEAR_NEWMV, C.NEW_NEARMV):
                    blk.ref_mv_idx = int(rng.integers(1, 3))
                elif mode == C.NEW_NEWMV:
                    blk.ref_mv_idx = int(rng.integers(0, 2))
            if not blk.skip:
                n = int(rng.integers(1, 6))
                blk.luma_coeffs = [[(int(rng.integers(1, 9)),
                                     int(rng.integers(0, 2)))
                                    for _ in range(n)]]
            blocks.append(blk)
    return blocks


def run_seed_comp(seed):
    """Compound-prediction fuzz: key + fwd frame + 1-2 compound frames
    referencing both a past (LAST) and future (BWDREF) slot."""
    rng = np.random.default_rng(10_000 + seed)
    kb = rand_blocks(rng, intra_frame=True)
    f1b = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            f1b.append(InterEncBlock(
                r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                ref=C.LAST_FRAME, mode=C.NEWMV,
                mv=(2 * int(rng.integers(-12, 13)),
                    2 * int(rng.integers(-12, 13))),
                skip=True))
    frames = [dict(type=C.KEY_FRAME, blocks=kb, order_hint=9),
              dict(type=C.INTER_FRAME, blocks=f1b, order_hint=1,
                   refresh=0b10, ref_idx=[0] * 7, err=False)]
    for k in range(int(rng.integers(1, 3))):
        frames.append(dict(type=C.INTER_FRAME, blocks=rand_blocks_comp(rng),
                           order_hint=2 + k, refresh=0b100 << k,
                           ref_idx=[1 + k * 2, 1, 1, 1, 0, 0, 0],
                           err=False))
    carry = bool(rng.random() < 0.7)
    tus = encode_ref_sequence(W, H, int(rng.integers(40, 200)), frames,
                              ref_select=True, carry=carry)
    p = CACHE / "fuzz_comp.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "fuzz_comp"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    if r.returncode != 0:
        return f"seed {seed}: dav1d REJECT (desync)"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        try:
            f = be.decode([tu], 0)[0]
        except Exception as e:  # noqa: BLE001
            return f"seed {seed}: frame {fi} EXC {type(e).__name__}: {e}"
        b = fi * per
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = b + (0 if pi == 0 else W * H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            d = np.abs(gold.astype(int) - f.data[pi].astype(int))
            if d.max():
                return (f"seed {seed}: frame {fi} plane {pi} maxdiff "
                        f"{d.max()} n={(d > 0).sum()} "
                        f"first={np.argwhere(d > 0)[0].tolist()} "
                        f"(carry={carry})")
    return None


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    comp = "comp" in sys.argv[2:]
    runner = run_seed_comp if comp else run_seed
    fails = 0
    for seed in range(n):
        msg = runner(seed)
        if msg:
            print("FAIL", msg)
            fails += 1
            if fails >= 5:
                break
    print(f"done: {fails} failures / {n} seeds"
          + (" (compound)" if comp else ""))
