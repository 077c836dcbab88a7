"""Temporal-MV fuzz with FUTURE references (alt-ref style): an anchor
frame at a later order hint feeds backward motion-field projections
(libaom motion_field_projection dir=0), which real auto-alt-ref
streams exercise.  Run: python tests/fuzz_tmv_future.py [n_seeds]
"""

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
    InterEncBlock, encode_ref_sequence)
from easyav1.video.av1.backend import AV1Backend  # noqa: E402

W = H = 96


def keyblocks(rng):
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                     luma_coeffs=[[(int(rng.integers(1, 10)),
                                    int(rng.integers(0, 2)))
                                   for _ in range(int(rng.integers(2, 10)))]])
            for r in range(0, 24, 4) for c in range(0, 24, 4)]


def interblocks(rng, refs, comp_ref2=-1):
    out = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            if comp_ref2 > 0 and rng.random() < 0.25:
                out.append(InterEncBlock(
                    r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                    skip_mode=True, skip=True))
                continue
            if comp_ref2 > 0 and rng.random() < 0.45:
                mode = int(rng.choice(
                    [C.NEAREST_NEARESTMV, C.NEAR_NEARMV, C.NEW_NEWMV],
                    p=[0.4, 0.3, 0.3]))
                b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                  is_inter=True, ref=C.LAST_FRAME,
                                  ref2=comp_ref2, mode=mode,
                                  skip=bool(rng.random() < 0.5))
                if mode == C.NEW_NEWMV:
                    b.mv = (int(rng.integers(-60, 61)) * 2,
                            int(rng.integers(-60, 61)) * 2)
                    b.mv2 = (int(rng.integers(-60, 61)) * 2,
                             int(rng.integers(-60, 61)) * 2)
                if mode == C.NEAR_NEARMV:
                    b.ref_mv_idx = int(rng.integers(1, 3))
                if not b.skip:
                    b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                       int(rng.integers(0, 2)))
                                      for _ in range(
                                          int(rng.integers(1, 6)))]]
                out.append(b)
                continue
            mode = int(rng.choice([C.NEWMV, C.NEARESTMV, C.NEARMV,
                                   C.GLOBALMV], p=[0.4, 0.3, 0.2, 0.1]))
            b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                              ref=int(rng.choice(list(refs))), mode=mode,
                              skip=bool(rng.random() < 0.5))
            if mode == C.NEWMV:
                b.mv = (int(rng.integers(-60, 61)) * 2,
                        int(rng.integers(-60, 61)) * 2)
            if mode == C.NEARMV:
                b.ref_mv_idx = int(rng.integers(1, 3))
            if not b.skip:
                b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                   int(rng.integers(0, 2)))
                                  for _ in range(int(rng.integers(1, 6)))]]
            out.append(b)
    return out


def build(seed):
    """KEY(h0, slot0) -> anchor INTER(h8, slot1, refs key) ->
    INTER(h2, slot2, LAST=key BWD/ALT=anchor) -> INTER(h4, LAST=h2
    frame, ALT=anchor): backward + multi-source projections."""
    rng = np.random.default_rng(seed)
    frames = [dict(type=C.KEY_FRAME, blocks=keyblocks(rng), order_hint=0)]
    frames.append(dict(type=C.INTER_FRAME, blocks=interblocks(
        rng, (C.LAST_FRAME,)), order_hint=8, refresh=1 << 1,
        ref_idx=[0] * 7, err=False, use_rfm=True))
    # ALTREF = slot1 (hint 8): ref_idx[ALTREF-LAST=6] = 1
    frames.append(dict(type=C.INTER_FRAME, blocks=interblocks(
        rng, (C.LAST_FRAME, C.ALTREF_FRAME), comp_ref2=C.ALTREF_FRAME),
        order_hint=2,
        refresh=1 << 2, ref_idx=[0, 0, 0, 0, 1, 0, 1], err=False,
        use_rfm=True, skip_mode=True))
    frames.append(dict(type=C.INTER_FRAME, blocks=interblocks(
        rng, (C.LAST_FRAME, C.ALTREF_FRAME), comp_ref2=C.ALTREF_FRAME),
        order_hint=4,
        refresh=1 << 3, ref_idx=[2, 0, 0, 0, 1, 0, 1], err=False,
        use_rfm=True, skip_mode=True))
    frames.append(dict(type=C.INTER_FRAME, blocks=interblocks(
        rng, (C.LAST_FRAME, C.LAST2_FRAME, C.ALTREF_FRAME),
        comp_ref2=C.ALTREF_FRAME),
        order_hint=6, refresh=1 << 4, ref_idx=[3, 2, 0, 0, 1, 0, 1],
        err=False, use_rfm=True, skip_mode=True))
    return frames


def run_seed(seed):
    frames = build(seed)
    try:
        tus = encode_ref_sequence(W, H, 70, frames, carry=True,
                                  ref_select=True)
    except Exception as e:
        return f"ENC-ERR {e}"
    p = CACHE / "fuzz_tmvf.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "fuzz_tmvf"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    if r.returncode != 0:
        return "REJECT"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = fi * per + (0 if pi == 0 else W * H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            d = np.abs(gold.astype(int) - f.data[pi].astype(int))
            if d.max():
                return (f"FAIL frame {fi} plane {pi} maxdiff {d.max()} "
                        f"n={(d != 0).sum()}")
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
