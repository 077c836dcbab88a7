"""Inter-frame conformance for 4:1 (HORZ_4/VERT_4) partitions:
inter 16X4/4X16/8X32/32X8 blocks with motion + residuals, and
intra-in-inter blocks inside 4:1 groups (the failure shape seen on
real cpu-used<=4 libaom streams)."""

import json
import subprocess

import numpy as np
import pytest

from easyav1.container.webm import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_inter_sequence)
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool

W = H = 64


def key_blocks():
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                     luma_coeffs=[[(4 + r + c, (r + c) & 1)]])
            for r in range(0, 16, 4) for c in range(0, 16, 4)]


def run_case(tag, frames, hp_mv=True, q=100):
    tus = encode_inter_sequence(W, H, q, frames, hp_mv=hp_mv)
    p = CACHE / f"synth_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"synth_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    assert meta["vframes"] == len(frames)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 32 * 32
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        planes = [raw[b:b + W * H].reshape(H, W),
                  raw[b + W * H:b + W * H + 32 * 32].reshape(32, 32),
                  raw[b + W * H + 32 * 32:b + per].reshape(32, 32)]
        for pi, pname in enumerate("yuv"):
            d = np.abs(planes[pi].astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def fill16(skip_rc):
    """16x16 NEARESTMV fillers for every 16x16 slot not in skip_rc."""
    return [InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                          ref=C.LAST_FRAME)
            for r in range(0, 16, 4) for c in range(0, 16, 4)
            if (r, c) not in skip_rc]


def test_inter_horz4_16x4_skip():
    """Inter HORZ_4 16X4 strips, no residual."""
    strips = [InterEncBlock(r=i, c=0, bsize=C.BLOCK_16X4, is_inter=True,
                            ref=C.LAST_FRAME, mode=C.NEWMV, mv=(-8, 24))
              for i in range(4)]
    run_case("ip4_h16skip",
             [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, strips + fill16({(0, 0)}))])


def test_inter_horz4_16x4_coeffs():
    """Inter 16X4 strips with residuals (TX_16X4 inter coef path)."""
    strips = [InterEncBlock(r=i, c=0, bsize=C.BLOCK_16X4, is_inter=True,
                            ref=C.LAST_FRAME, mode=C.NEWMV, mv=(-8, 24),
                            skip=False,
                            luma_coeffs=[[(2 + i, i & 1), (1, 0)]])
              for i in range(4)]
    run_case("ip4_h16c",
             [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, strips + fill16({(0, 0)}))])


def test_inter_vert4_4x16_coeffs():
    strips = [InterEncBlock(r=0, c=i, bsize=C.BLOCK_4X16, is_inter=True,
                            ref=C.LAST_FRAME, mode=C.NEWMV, mv=(4, -12),
                            skip=False, luma_coeffs=[[(3, i & 1)]])
              for i in range(4)]
    run_case("ip4_v16c",
             [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, strips + fill16({(0, 0)}))])


def test_inter_4to1_32_coeffs():
    strips = [InterEncBlock(r=2 * i, c=0, bsize=C.BLOCK_32X8,
                            is_inter=True, ref=C.LAST_FRAME, mode=C.NEWMV,
                            mv=(6, 10), skip=False,
                            luma_coeffs=[[(1 + i, 0)]])
              for i in range(4)]
    vstrips = [InterEncBlock(r=8, c=8 + 2 * i, bsize=C.BLOCK_8X32,
                             is_inter=True, ref=C.LAST_FRAME,
                             mode=C.NEARESTMV, skip=False,
                             luma_coeffs=[[(2, 1)]])
               for i in range(4)]
    rest = [InterEncBlock(r=0, c=8, bsize=C.BLOCK_32X32, is_inter=True,
                          ref=C.LAST_FRAME),
            InterEncBlock(r=8, c=0, bsize=C.BLOCK_32X32, is_inter=True,
                          ref=C.LAST_FRAME)]
    run_case("ip4_32c",
             [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, strips + vstrips + rest)])


def test_intra_in_inter_after_4to1():
    """Intra DC blocks with residuals inside/after a 16X4 HORZ_4 group
    (matches the first solidly-wrong block on real streams)."""
    strips = [
        InterEncBlock(r=0, c=0, bsize=C.BLOCK_16X4, is_inter=True,
                      ref=C.LAST_FRAME, mode=C.NEWMV, mv=(-8, 24),
                      skip=False, luma_coeffs=[[(3, 0)]]),
        InterEncBlock(r=1, c=0, bsize=C.BLOCK_16X4, is_inter=False,
                      skip=False, luma_coeffs=[[(5, 1), (2, 0)]]),
        InterEncBlock(r=2, c=0, bsize=C.BLOCK_16X4, is_inter=False,
                      skip=False, luma_coeffs=[[(4, 0)]]),
        InterEncBlock(r=3, c=0, bsize=C.BLOCK_16X4, is_inter=True,
                      ref=C.LAST_FRAME, mode=C.NEARESTMV),
    ]
    run_case("ip4_intra",
             [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, strips + fill16({(0, 0)}))])
