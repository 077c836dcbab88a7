"""High-bitdepth (10/12) and non-4:2:0 (4:4:4, 4:2:2, monochrome)
conformance on real libaom streams vs the dav1d oracle (BASELINE
config 4 is 4K 10-bit; dav1d ships all bitdepths via -Dbitdepths=All,
reference README.md:136)."""

import subprocess
import numpy as np
import pytest

from fixtures import CACHE, tool
from easyav1.api import EasyAV1


def fixture(tag, **kv):
    out = CACHE / f"hbd_{tag}.webm"
    if not out.exists():
        args = [str(tool("make_fixture")), str(out)]
        args += [f"{k.replace('_','-') if k.startswith('vopt') else k}={v}"
                 for k, v in kv.items()]
        r = subprocess.run(args, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-400:]
        r = subprocess.run([str(tool("oracle")), str(out),
                            str(CACHE / f"hbd_{tag}")],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-400:]
    return out


def check(tag, max_frames=8, **kv):
    import json
    out = fixture(tag, **kv)
    meta = json.loads((CACHE / f"hbd_{tag}.json").read_text())
    depth = meta["depth"]
    ssx, ssy = meta["ss_x"], meta["ss_y"]
    dt = np.uint16 if depth > 8 else np.uint8
    raw = np.fromfile(CACHE / f"hbd_{tag}.yuv", dtype=dt)
    w, h = meta["width"], meta["height"]
    mono = kv.get("ss") == "mono"
    cw = (w + (1 << ssx) - 1) >> ssx
    ch = (h + (1 << ssy) - 1) >> ssy
    per = w * h + (0 if mono else 2 * cw * ch)
    av = EasyAV1(str(out))
    n = 0
    while not av.is_finished() and n < max_frames:
        av.decode_next()
        if av.has_video_frame():
            f = av.get_video_frame()
            off = n * per
            gold = [raw[off:off + w * h].reshape(h, w)]
            if not mono:
                gold.append(raw[off + w * h:off + w * h + cw * ch]
                            .reshape(ch, cw))
                gold.append(raw[off + w * h + cw * ch:off + per]
                            .reshape(ch, cw))
            for p, g in enumerate(gold):
                got = np.asarray(f.data[p])
                d = np.abs(g.astype(int) - got.astype(int))
                assert d.max() == 0, \
                    (tag, n, p, d.max(), np.argwhere(d > 0)[:4].tolist())
            n += 1
    assert n == meta["vframes"], (n, meta["vframes"])


BASE = dict(w=96, h=96, fps=10, frames=4, crf=35, audio_secs=0)


def test_10bit_intra():
    check("10i", **BASE, gop=1, bitdepth=10)


def test_10bit_inter():
    check("10p", **BASE, gop=100, bitdepth=10)


def test_10bit_postfilters():
    check("10pf", w=128, h=96, fps=10, frames=4, crf=45, audio_secs=0,
          gop=100, bitdepth=10)


def test_12bit_intra():
    check("12i", **BASE, gop=1, bitdepth=12)


def test_444_intra():
    check("444i", **BASE, gop=1, ss=444)


def test_444_inter():
    check("444p", **BASE, gop=100, ss=444)


def test_422_intra():
    check("422i", **BASE, gop=1, ss=422)


def test_422_inter():
    check("422p", **BASE, gop=100, ss=422)


def test_mono_intra():
    check("monoi", **BASE, gop=1, ss="mono")


def test_444_10bit():
    check("444x10", **BASE, gop=100, ss=444, bitdepth=10)
