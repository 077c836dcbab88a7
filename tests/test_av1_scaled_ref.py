"""Scaled-reference motion compensation (spec 7.11.3.3-4): an inter
frame coded at a different resolution than its reference predicts
through the 1/1024-pel stepping scaled convolve.  Streams are written
by the synthetic inter encoder with frame_size_override (the coded
size differs from the key frame), decoded by BOTH libdav1d and our
decoder, and compared bit-exact per frame.

Reference parity: easyav1 gets this from dav1d mc.c put_8tap_scaled
(resize-mode / superres-inter streams)."""

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


def key_blocks(seed=3, ncoef=6):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(0, 16, 4):
        for c in range(0, 16, 4):
            coeffs = [[(int(rng.integers(1, 8)), int(rng.integers(0, 2)))
                       for _ in range(ncoef)]]
            out.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                                luma_coeffs=coeffs))
    return out


def inter_grid(cw, ch, mv=(12, -20), **kw):
    return [InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                          ref=C.LAST_FRAME, mode=C.NEWMV, mv=mv, **kw)
            for r in range(0, ch // 4, 4) for c in range(0, cw // 4, 4)]


def run_scaled(tag, coded, mv=(12, -20), q=100):
    cw, ch = coded
    frames = [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, inter_grid(cw, ch, mv=mv), (cw, ch))]
    tus = encode_inter_sequence(W, H, q, frames, hp_mv=True)
    p = CACHE / f"synth_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"synth_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    assert meta["vframes"] == 2
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    off = 0
    for fi, (tu, (fw, fh)) in enumerate(zip(tus, [(W, H), (cw, ch)])):
        f = be.decode([tu], 0)[0]
        cw2, ch2 = fw // 2, fh // 2
        planes = []
        for dw, dh in ((fw, fh), (cw2, ch2), (cw2, ch2)):
            planes.append(raw[off:off + dw * dh].reshape(dh, dw))
            off += dw * dh
        for pi, pname in enumerate("yuv"):
            assert f.data[pi].shape == planes[pi].shape, (
                f"{tag} frame {fi} {pname}: shape {f.data[pi].shape} "
                f"vs {planes[pi].shape}")
            d = np.abs(planes[pi].astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def test_scaled_ref_downscale():
    # inter frame at 3/4 the reference size in both axes
    run_scaled("sc_ds", (48, 48))


def test_scaled_ref_half():
    # the 2x limit case
    run_scaled("sc_half", (32, 32), mv=(8, 8))


def test_scaled_ref_anamorphic():
    # width-only scaling
    run_scaled("sc_ana", (48, 64), mv=(-16, 24))


def test_scaled_ref_zero_mv():
    run_scaled("sc_z", (48, 48), mv=(0, 0))
