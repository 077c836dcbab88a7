"""Multi-tile-group conformance: a frame's tiles may arrive split
across several OBU_TILE_GROUP OBUs (spec 5.11.1 tile_group header with
tg_start/tg_end).  The backend must accumulate tile groups until the
one carrying the last tile arrives before decoding the frame.

Reference parity: easyav1 feeds whole packets to dav1d which does the
same accumulation internally (dav1d decode.c dav1d_parse_obus)."""

import hashlib
import subprocess

import numpy as np

from fixtures import CACHE, tool
from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1 import constants as C
from easyav1.video.av1.backend import AV1Backend
from easyav1.video.av1.headers import split_obus


def _fixture(w, h, frames, gop, n_tg, tile_cols=1, tile_rows=1):
    args_tail = [f"w={w}", f"h={h}", "fps=30", f"frames={frames}",
                 f"gop={gop}", "crf=30", "audio_secs=0", "content=1",
                 f"vopt:tile-columns={tile_cols}",
                 f"vopt:tile-rows={tile_rows}",
                 f"vopt:aom-params=num-tile-groups={n_tg}"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"multitg_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)]
                           + args_tail, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    prefix = CACHE / out.stem
    if not prefix.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out), str(prefix)],
                       check=True, capture_output=True)
    return out, prefix


def _roundtrip(w, h, frames, gop, n_tg, tile_cols=1, tile_rows=1):
    out, prefix = _fixture(w, h, frames, gop, n_tg, tile_cols, tile_rows)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * ch
    dmx = WebMDemuxer(str(out))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt)
    fi = 0
    saw_multi_tg = False
    while (p := dmx.read_packet()) is not None:
        if p.track != vt.number:
            continue
        for fr in p.frames:
            n_tgs = sum(1 for o in split_obus(fr)
                        if o.type == C.OBU_TILE_GROUP)
            saw_multi_tg |= n_tgs > 1
            for f in be.decode([fr], 0):
                off = fi * per
                for pi, (dw, dh) in enumerate(((w, h), (cw, ch),
                                               (cw, ch))):
                    gold = raw[off:off + dw * dh].reshape(dh, dw)
                    off += dw * dh
                    d = np.abs(gold.astype(int)
                               - f.data[pi].astype(int))
                    assert d.max() == 0, \
                        f"frame {fi} plane {pi} maxdiff {d.max()}"
                fi += 1
    assert fi == frames
    assert saw_multi_tg, "fixture did not produce multi-TG frames"


def test_multitg_intra():
    # 2x2 tiles split into 4 tile groups, all-intra
    _roundtrip(320, 240, 3, 1, 4)


def test_multitg_inter():
    # inter frames with 2 tile groups over 2x1 tiles
    _roundtrip(320, 240, 6, 100, 2, tile_cols=1, tile_rows=0)


def test_multitg_640_2tg():
    # larger frame, 4x1 tiles in 2 groups (2 tiles per group)
    _roundtrip(640, 360, 3, 100, 2, tile_cols=2, tile_rows=0)
