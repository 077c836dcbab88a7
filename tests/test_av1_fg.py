"""Film grain synthesis conformance (spec §7.18.3): synthesized
streams with exact grain parameters + real libaom denoise-grain
streams, all decoded by libdav1d and our decoder, compared bit-exact."""

import subprocess

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from av1_synth import (EncBlock, assert_same, dav1d_decode_ivf, encode_frame,
                       make_ivf, my_decode_tu)
from fixtures import CACHE, tool


def blocks_with_texture(w4, h4, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(0, h4, 4):
        for c in range(0, w4, 4):
            n = int(rng.integers(2, 9))
            coeffs = [[(int(rng.integers(1, 12)), int(rng.integers(0, 2)))
                       for _ in range(n)]]
            out.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                                luma_coeffs=coeffs))
    return out


def roundtrip(tag, fg, w=64, h=64, q=60):
    blocks = blocks_with_texture(2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3))
    tu = encode_frame(w, h, q, blocks, fg=fg)
    dav = dav1d_decode_ivf(make_ivf([tu], w, h), tag)[0]
    mine = my_decode_tu(tu)
    assert_same(dav, mine, tag)


def test_fg_luma_lag0():
    roundtrip("fg_l0", {"seed": 1234, "y_points": [(0, 64), (255, 64)],
                        "lag": 0})


def test_fg_luma_lag1():
    roundtrip("fg_l1", {"seed": 999,
                        "y_points": [(0, 80), (128, 60), (255, 40)],
                        "lag": 1, "ar_y": [10, 20, 15, -5]})


def test_fg_luma_lag3_overlap():
    ar3 = [((i * 37) % 41) - 20 for i in range(24)]
    roundtrip("fg_l3", {"seed": 3381, "y_points": [(0, 100), (255, 100)],
                        "lag": 3, "ar_y": ar3, "ar_coeff_shift": 8,
                        "overlap": True})


def test_fg_chroma():
    roundtrip("fg_c", {"seed": 31, "y_points": [(0, 70), (255, 70)],
                       "cb_points": [(0, 50), (255, 60)],
                       "cr_points": [(0, 40)],
                       "lag": 1, "ar_y": [1, 2, 3, 4],
                       "ar_cb": [2, 2, 2, 2, 10],
                       "ar_cr": [0, 1, 0, 1, -8], "overlap": True,
                       "cb_mult": 150, "cb_luma_mult": 180,
                       "cb_offset": 300})


def test_fg_chroma_scaling_from_luma():
    roundtrip("fg_csl", {"seed": 55, "y_points": [(0, 60), (255, 60)],
                         "chroma_scaling_from_luma": True, "lag": 1,
                         "ar_y": [3, 3, 3, 3], "ar_cb": [1, 1, 1, 1, 5],
                         "ar_cr": [2, 2, 2, 2, -3]})


def test_fg_clip_restricted():
    roundtrip("fg_clip", {"seed": 4096,
                          "y_points": [(0, 120), (255, 120)], "lag": 1,
                          "ar_y": [8, -8, 8, -8], "overlap": True,
                          "clip_restricted": True})


def test_fg_real_params_96():
    """Parameter set observed from a real libaom denoise encode (8 luma
    points, lag 3, scaling shift 11, overlap), three block rows."""
    roundtrip("fg_real96", {
        "seed": 3381,
        "y_points": [(0, 137), (54, 137), (81, 138), (94, 137),
                     (107, 133), (174, 83), (228, 53), (255, 53)],
        "cb_points": [(0, 24), (54, 24), (81, 23), (121, 24), (255, 24)],
        "cr_points": [(0, 16), (255, 16)],
        "scaling_shift": 11, "lag": 3,
        "ar_y": [-2, -4, -7, -15, -5, -1, -1, -8, -12, -12, -28, -8, -7,
                 -3, -8, -11, -28, -14, -24, -4, -3, -15, -24, -16],
        "ar_cb": [-2, 4, 16, 43, 5, -10, -6, -4, 3, 31, 66, 14, -1, 2, 0,
                  -2, 4, -3, -6, 12, 3, 6, -1, -46, 10],
        "ar_cr": [-2, 4, 16, 43, 5, -10, -6, -4, 3, 31, 66, 14, -1, 2, 0,
                  -2, 4, -3, -6, 12, 3, 6, -1, -46, 10],
        "ar_coeff_shift": 7, "overlap": True}, w=96, h=96)


def test_fg_real_stream():
    """Real libaom encode with denoise-noise-level grain (screen content
    tools off so palette stays out of scope here)."""
    import hashlib
    args_tail = ["w=160", "h=128", "fps=10", "frames=2", "gop=1", "crf=30",
                 "audio_secs=0", "cpu-used=5", "content=1",
                 "vopt:denoise-noise-level=50",
                 "vopt:enable-restoration=0", "vopt:enable-palette=0",
                 "vopt:enable-filter-intra=0", "vopt:enable-intrabc=0",
                 "vopt:lag-in-frames=0"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"fgreal_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)]
                           + args_tail, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    prefix = CACHE / out.stem
    if not prefix.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out), str(prefix)],
                       check=True, capture_output=True)
    from easyav1.container.webm import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    w, h = 160, 128
    cw, ch = 80, 64
    per = w * h + 2 * cw * ch
    dmx = WebMDemuxer(str(out))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt)
    fi = 0
    while (p := dmx.read_packet()) is not None:
        if p.track != vt.number:
            continue
        for fr in p.frames:
            for f in be.decode([fr], 0):
                off = fi * per
                for pi, (dw, dh) in enumerate(((w, h), (cw, ch), (cw, ch))):
                    gold = raw[off:off + dw * dh].reshape(dh, dw)
                    off += dw * dh
                    d = np.abs(gold.astype(int) - f.data[pi].astype(int))
                    assert d.max() == 0, \
                        f"frame {fi} plane {pi} maxdiff {d.max()}"
                fi += 1
    assert fi == 2
