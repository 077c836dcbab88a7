"""128x128-superblock synthesized-bitstream conformance: sb128 streams
written by the synthetic encoders (key + inter frames, 128x128 blocks,
temporal-mv chains), decoded by BOTH libdav1d and our decoder and
compared bit-exact.  This locks the >64px residual chunk interleave
(spec 5.11.34) on the WRITE side as well — the mirrored writer bug it
guards against produced streams libaom rejects outright."""

import subprocess
import sys

import numpy as np

from fixtures import CACHE, tool
from easyav1.container.webm import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_ref_sequence)
from easyav1.video.av1.backend import AV1Backend

W = H = 256
MI = W // 4


def _check(frames, tag):
    tus = encode_ref_sequence(W, H, 70, frames, carry=True, sb128=True)
    p = CACHE / f"sb128syn_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"sb128syn_{tag}"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    assert r.returncode == 0, f"{tag}: dav1d rejected the stream"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw = W // 2
    per = W * H + 2 * cw * (H // 2)
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    off = 0
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        for pi, (dw, dh) in enumerate(((W, H), (cw, H // 2),
                                       (cw, H // 2))):
            g = raw[off:off + dw * dh].reshape(dh, dw)
            off += dw * dh
            d = np.abs(g.astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, \
                f"{tag} frame {fi} plane {pi}: maxdiff {d.max()}"


def _keyblocks(rng):
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_128X128, skip=False,
                     luma_coeffs=[[(int(rng.integers(1, 9)),
                                    int(rng.integers(0, 2)))
                                   for _ in range(int(rng.integers(1, 6)))]])
            for r in range(0, MI, 32) for c in range(0, MI, 32)]


def _interblocks(rng, refs=(C.LAST_FRAME,)):
    out = []
    for r in range(0, MI, 32):
        for c in range(0, MI, 32):
            mode = int(rng.choice([C.NEWMV, C.NEARESTMV, C.NEARMV,
                                   C.GLOBALMV]))
            b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_128X128,
                              is_inter=True,
                              ref=int(rng.choice(list(refs))), mode=mode,
                              skip=bool(rng.random() < 0.3))
            if mode == C.NEWMV:
                b.mv = (int(rng.integers(-100, 101)) * 8,
                        int(rng.integers(-100, 101)) * 8)
            if mode == C.NEARMV:
                b.ref_mv_idx = int(rng.integers(1, 3))
            if not b.skip:
                b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                   int(rng.integers(0, 2)))
                                  for _ in range(int(rng.integers(1, 8)))]]
            out.append(b)
    return out


def test_sb128_key_tx64_levels():
    # single-coeff TX_64X64 blocks at every base-range boundary level
    for lvl in range(1, 9):
        kb = [EncBlock(r=r, c=c, bsize=C.BLOCK_128X128, skip=False,
                       luma_coeffs=[[(lvl, 0)]])
              for r in (0, 32) for c in (0, 32)]
        _check([dict(type=C.KEY_FRAME, blocks=kb, order_hint=0)],
               f"lv{lvl}")


def test_sb128_tmv_chain():
    for seed in (0, 3, 5):
        rng = np.random.default_rng(seed)
        frames = [dict(type=C.KEY_FRAME, blocks=_keyblocks(rng),
                       order_hint=0)]
        for i in range(1, 5):
            slot_of = lambda oh: max(0, oh) % 8
            ref_idx = [slot_of(i - 2), slot_of(i - 3), slot_of(i - 4),
                       slot_of(i - 1), slot_of(i - 1), slot_of(i - 1),
                       slot_of(i - 1)]
            frames.append(dict(
                type=C.INTER_FRAME,
                blocks=_interblocks(rng, (C.LAST_FRAME, C.LAST2_FRAME,
                                          C.GOLDEN_FRAME)),
                order_hint=i, refresh=1 << (i % 8), ref_idx=ref_idx,
                err=False, use_rfm=True))
        _check(frames, f"tmv{seed}")
