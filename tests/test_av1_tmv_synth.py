"""Temporal MV (use_ref_frame_mvs) synth conformance: order-hint chains
with per-slot motion fields, projected candidates and cross-frame CDF
carry, all round-tripped through libdav1d and our decoder.

The encoder mirrors the decoder's cross-frame state (encode_ref_sequence),
so any semantic drift in mfmv.py / the temporal scan shows up as a
pixel mismatch against dav1d.
"""

import subprocess

import numpy as np

from fixtures import CACHE, tool
from easyav1.container.webm import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_ref_sequence)
from easyav1.video.av1.backend import AV1Backend

W = H = 96


def _keyblocks(rng):
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                     luma_coeffs=[[(int(rng.integers(1, 10)),
                                    int(rng.integers(0, 2)))
                                   for _ in range(int(rng.integers(2, 10)))]])
            for r in range(0, 24, 4) for c in range(0, 24, 4)]


def _interblocks(rng, refs=(C.LAST_FRAME,)):
    out = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            mode = int(rng.choice([C.NEWMV, C.NEARESTMV, C.NEARMV]))
            b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                              ref=int(rng.choice(list(refs))), mode=mode,
                              skip=bool(rng.random() < 0.4))
            if mode == C.NEWMV:
                b.mv = (int(rng.integers(-24, 25)) * 2,
                        int(rng.integers(-24, 25)) * 2)
            if mode == C.NEARMV:
                b.ref_mv_idx = int(rng.integers(1, 3))
            if not b.skip:
                b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                   int(rng.integers(0, 2)))
                                  for _ in range(int(rng.integers(1, 8)))]]
            out.append(b)
    return out


def _check(frames, tag):
    tus = encode_ref_sequence(W, H, 70, frames, carry=True)
    p = CACHE / f"tmvsyn_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"tmvsyn_{tag}"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    assert r.returncode == 0, f"{tag}: dav1d rejected the stream"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = fi * per + (0 if pi == 0 else W * H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            d = np.abs(gold.astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, \
                f"{tag} frame {fi} plane {pi}: maxdiff {d.max()}"


def test_tmv_chain_single_slot():
    for seed in (0, 2, 6, 7, 11):
        rng = np.random.default_rng(seed)
        frames = [dict(type=C.KEY_FRAME, blocks=_keyblocks(rng),
                       order_hint=0)]
        for i in range(1, 4):
            frames.append(dict(type=C.INTER_FRAME, blocks=_interblocks(rng),
                               order_hint=i, err=False, use_rfm=True))
        _check(frames, f"s{seed}")


def test_tmv_chain_multi_slot():
    rng = np.random.default_rng(11)
    frames = [dict(type=C.KEY_FRAME, blocks=_keyblocks(rng), order_hint=0)]
    for i in range(1, 6):
        ref_idx = [max(0, i - 1), max(0, i - 2), max(0, i - 3),
                   max(0, i - 4), 0, 0, 0]
        frames.append(dict(
            type=C.INTER_FRAME,
            blocks=_interblocks(rng, refs=(C.LAST_FRAME, C.LAST2_FRAME,
                                           C.GOLDEN_FRAME)),
            order_hint=i, refresh=1 << i, ref_idx=ref_idx,
            err=False, use_rfm=True))
    _check(frames, "multislot")
