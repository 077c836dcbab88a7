"""Frame-parallel decode (EASYAV1_FRAME_PARALLEL=1): frame N's C recon
runs on a worker thread while frame N+1's entropy decode runs on the
caller thread (dav1d frame-threading analog, reference
cmake/dav1d.cmake thread_task.c).  Every stream must decode bit-exact
vs the serial path: CDF chaining, ref planes, temporal MVs, film grain
and show_existing all cross the phase boundary."""

import os

import numpy as np
import pytest

from easyav1.container import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool


def _decode_all(path, fp: bool, max_frames=200):
    os.environ["EASYAV1_PIPE"] = "native"
    if fp:
        os.environ["EASYAV1_FRAME_PARALLEL"] = "1"
    else:
        os.environ.pop("EASYAV1_FRAME_PARALLEL", None)
    try:
        dmx = WebMDemuxer(str(path))
        vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
        pkts = []
        while (p := dmx.read_packet()) is not None:
            if p.track == vt.number:
                pkts.extend(p.frames)
        be = AV1Backend(vt)
        out = []
        for pk in pkts[:max_frames]:
            for f in be.decode([pk], 0):
                out.append([np.asarray(pl).copy() for pl in f.data])
        be.flush()
        return out
    finally:
        os.environ.pop("EASYAV1_FRAME_PARALLEL", None)


def _fixture(tag, **kw):
    import hashlib
    import subprocess

    args = [f"{k.replace('_','-')}={v}" for k, v in kw.items()]
    tail = ["fps=10", "audio_secs=0", "vopt:lag-in-frames=0"] + args
    ph = hashlib.sha1(" ".join(tail).encode()).hexdigest()[:8]
    out = CACHE / f"fpar_{tag}_{ph}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)] + tail,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    return out


def _assert_equal(a, b, tag):
    assert len(a) == len(b) > 0, tag
    for k, (fa, fb) in enumerate(zip(a, b)):
        for p, (x, y) in enumerate(zip(fa, fb)):
            assert np.array_equal(x, y), f"{tag} frame {k} plane {p}"


def test_fp_inter_chain():
    """Long inter chain: every frame's recon depends on the pipelined
    previous frame's ref planes."""
    fx = _fixture("inter", w=320, h=192, frames=24, gop=24, crf=36)
    _assert_equal(_decode_all(fx, False), _decode_all(fx, True),
                  "inter")


def test_fp_keyframes_and_seeky_gop():
    fx = _fixture("gop4", w=160, h=128, frames=16, gop=4, crf=30)
    _assert_equal(_decode_all(fx, False), _decode_all(fx, True),
                  "gop4")


def test_fp_film_grain():
    """Grain applies on the worker after recon; refs stay grain-free."""
    fx = _fixture("grain", w=160, h=128, frames=8, gop=8, crf=30,
                  **{"vopt:denoise-noise-level": 12})
    _assert_equal(_decode_all(fx, False), _decode_all(fx, True),
                  "grain")


def test_fp_altref_show_existing():
    """lag-in-frames enables alt-refs + show_existing_frame, whose
    output frame is a still-pending pipelined picture."""
    import hashlib
    import subprocess

    tail = ["fps=10", "audio_secs=0", "w=192", "h=128", "frames=16",
            "gop=16", "crf=34", "vopt:lag-in-frames=8",
            "vopt:auto-alt-ref=1"]
    ph = hashlib.sha1(" ".join(tail).encode()).hexdigest()[:8]
    fx = CACHE / f"fpar_altref_{ph}.webm"
    if not fx.exists():
        r = subprocess.run([str(tool("make_fixture")), str(fx)] + tail,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    _assert_equal(_decode_all(fx, False), _decode_all(fx, True),
                  "altref")


@pytest.mark.parametrize("threads", [1, 3])
def test_fp_with_tile_threads(threads, monkeypatch):
    """Frame pipeline composed with the tile-parallel entropy pool."""
    monkeypatch.setenv("EASYAV1_THREADS", str(threads))
    fx = _fixture("mt", w=320, h=192, frames=10, gop=10, crf=36,
                  **{"vopt:tile-columns": 1, "vopt:tile-rows": 1})
    _assert_equal(_decode_all(fx, False), _decode_all(fx, True),
                  f"mt{threads}")
