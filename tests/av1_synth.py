"""Synthesized-bitstream conformance helpers: encode with our minimal
AV1 encoder, decode with BOTH libdav1d and our decoder, compare."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import List

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, encode_frame, make_ivf
from easyav1.video.av1.backend import AV1Backend
from easyav1.container.webm import TrackInfo

from fixtures import CACHE, tool


def dav1d_decode_ivf(ivf: bytes, tag: str):
    CACHE.mkdir(parents=True, exist_ok=True)
    p = CACHE / f"synth_{tag}.ivf"
    p.write_bytes(ivf)
    prefix = CACHE / f"synth_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    meta = json.loads((prefix.with_suffix(".json")).read_text())
    w, h = meta["width"], meta["height"]
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * ch
    frames = []
    for i in range(meta["vframes"]):
        b = i * per
        frames.append({
            "y": raw[b:b + w * h].reshape(h, w),
            "u": raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
            "v": raw[b + w * h + cw * ch:b + per].reshape(ch, cw),
        })
    return frames


def my_decode_tu(tu: bytes):
    track = TrackInfo(number=1, type=None, codec_id="V_AV1")
    be = AV1Backend(track)
    frames = be.decode([tu], 0)
    assert frames, "no frame decoded"
    f = frames[0]
    return {"y": f.data[0], "u": f.data[1], "v": f.data[2]}


def synth_compare(blocks: List[EncBlock], w: int, h: int, q: int, tag: str):
    """Returns (dav1d_frame, my_frame); asserts both succeed."""
    tu = encode_frame(w, h, q, blocks)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    return dav, mine


def assert_same(dav, mine, tag=""):
    for p in ("y", "u", "v"):
        d = np.abs(dav[p].astype(int) - mine[p].astype(int))
        assert d.max() == 0, (
            f"{tag} plane {p}: max diff {d.max()} at "
            f"{np.argwhere(d > 0)[:5].tolist()}; "
            f"dav1d {dav[p][:4,:6].tolist()} mine {mine[p][:4,:6].tolist()}")
