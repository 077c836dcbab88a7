"""AV1 conformance against real libaom-encoded fixtures.

Each fixture is encoded by libaom (via the make_fixture tool) with a
restricted feature set matching what the decoder supports so far, then
decoded by BOTH libdav1d (the oracle) and our decoder; every plane must
be bit-exact, including the deblocking loop filter.
"""

import subprocess

import numpy as np
import pytest

from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool

BASE_OPTS = [
    "vopt:enable-cdef=0", "vopt:enable-restoration=0",
    "vopt:use-intra-dct-only=1", "vopt:enable-filter-intra=0",
    "vopt:enable-intra-edge-filter=0", "vopt:enable-angle-delta=0",
    "vopt:enable-palette=0", "vopt:deltaq-mode=0", "vopt:enable-cfl-intra=0",
]


def real_fixture(tag, w, h, crf=30, frames=1, extra=()):
    out = CACHE / f"real_{tag}.webm"
    if not out.exists():
        extra = list(extra)
        # an explicit restoration flag means the caller supplies its own
        # complete feature set instead of the restricted BASE_OPTS
        base = ([] if any("restoration" in e for e in extra)
                else BASE_OPTS)
        args = [str(tool("make_fixture")), str(out),
                f"w={w}", f"h={h}", "fps=10", f"frames={frames}", "gop=1",
                f"crf={crf}", "audio_secs=0"] + base + extra
        r = subprocess.run(args, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    prefix = CACHE / f"real_{tag}"
    if not prefix.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out), str(prefix)],
                       check=True, capture_output=True)
    return out, prefix


def assert_exact(tag, w, h, crf=30, frames=1, extra=()):
    out, prefix = real_fixture(tag, w, h, crf, frames, extra)
    dmx = WebMDemuxer(str(out))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * ch
    be = AV1Backend(vt)
    for fi, pk in enumerate(pkts):
        f = be.decode([pk], 0)[0]
        b = fi * per
        gold = [raw[b:b + w * h].reshape(h, w),
                raw[b + w * h:b + w * h + cw * ch].reshape(ch, cw),
                raw[b + w * h + cw * ch:b + per].reshape(ch, cw)]
        for i, pname in enumerate("yuv"):
            d = np.abs(gold[i].astype(int) - f.data[i].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} plane {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def test_real_64():
    assert_exact("64", 64, 64)


def test_real_64_hiq():
    assert_exact("64hiq", 64, 64, crf=10)


def test_real_64_loq():
    assert_exact("64loq", 64, 64, crf=50)


def test_real_128():
    assert_exact("128", 128, 128)


def test_real_odd_size():
    assert_exact("odd", 66, 50)


def test_real_176x144():
    assert_exact("qcif", 176, 144)


def test_real_multiframe():
    assert_exact("multi", 96, 96, frames=3)


NEAR_DEFAULT = [
    "vopt:enable-restoration=0", "vopt:enable-filter-intra=0",
    "vopt:enable-palette=0",
]


def test_real_near_default():
    """Everything the intra toolset supports: all tx types, angle deltas,
    intra edge filter, CfL, deblocking and CDEF (incl cdef_bits > 0)."""
    assert_exact("neardflt", 96, 96, extra=NEAR_DEFAULT)


def test_real_near_default_noisy():
    assert_exact("neardflt0", 96, 96, crf=20,
                 extra=NEAR_DEFAULT + ["content=0"])


def test_real_near_default_qcif():
    assert_exact("neardflt_qcif", 176, 144, crf=35,
                 extra=NEAR_DEFAULT + ["content=0"])


def test_real_odd_cdef():
    """Odd dims + CDEF: LF must stop at the visible frame while CDEF
    reads the unfiltered mi-aligned extension rows/cols as taps."""
    assert_exact("oddcdef", 84, 52, crf=30, frames=2,
                 extra=("vopt:enable-restoration=0", "vopt:enable-palette=0",
                        "vopt:enable-filter-intra=0", "vopt:enable-cdef=1"))


def test_real_screen_tune():
    """tune-content=screen: allow_screen_content_tools=1 (palette flag
    syntax present), force_integer_mv, TX_MODE_LARGEST; must route
    around the native tile decoder (no screen-content syntax there)."""
    assert_exact("scrtune", 96, 96, extra=(
        "content=3", "vopt:aom-params=tune-content=screen",
        "vopt:enable-restoration=0", "vopt:lag-in-frames=0",
        "vopt:cpu-used=2"))


def test_real_screen_repeat_tile():
    """Screen tune over a repeated 4-colour noise tile (palette +
    screen syntax stress at very low qindex)."""
    assert_exact("scrtile", 128, 128, extra=(
        "content=4", "vopt:aom-params=tune-content=screen",
        "vopt:enable-restoration=0", "vopt:lag-in-frames=0",
        "vopt:cpu-used=1"))
