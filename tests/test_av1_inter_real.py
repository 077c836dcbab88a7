"""Inter-frame AV1 conformance against real libaom-encoded streams.

Covers the inter toolset end-to-end vs the libdav1d oracle: NEWMV /
NEAREST / NEAR / GLOBAL modes, refmvs stacks + drl, var-tx trees,
inter residuals, OBMC, warped motion, CDF inheritance via
primary_ref_frame, temporal MV projection (use_ref_frame_mvs), and
compound (bidirectional) prediction incl. distance-weighted blending.
Masked compound (wedge/diffwtd), interintra and loop restoration stay
disabled (not yet implemented).
"""

import subprocess

import numpy as np
import pytest

from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool

# decoder-scope restrictions (features not implemented yet)
SCOPE_OPTS = [
    "vopt:enable-restoration=0", "vopt:enable-palette=0",
    "vopt:enable-filter-intra=0", "vopt:enable-intrabc=0",
    "vopt:aom-params=enable-onesided-comp=0",
    "vopt:lag-in-frames=0",       # no alt-refs -> single-ref prediction
]

# compound scope: alt-refs enabled (bidirectional prediction), masked
# compound (wedge/diffwtd) and interintra still out of scope.
# cpu-used=2 + auto-alt-ref: the cpu-used=8 default disables the
# compound tools entirely (verified: zero two-ref blocks emitted).
COMP_SCOPE = [
    "vopt:enable-restoration=0", "vopt:enable-palette=0",
    "vopt:enable-filter-intra=0", "vopt:enable-intrabc=0",
    "vopt:lag-in-frames=8", "vopt:auto-alt-ref=1", "cpu-used=2",
]
COMP_BASE = ("enable-masked-comp=0:enable-interintra-comp=0:"
             "enable-onesided-comp=0")


def inter_fixture(tag, w=96, h=96, crf=40, frames=4, gop=100, extra=(),
                  scope=None):
    args_tail = [f"w={w}", f"h={h}", "fps=10", f"frames={frames}",
                 f"gop={gop}", f"crf={crf}", "audio_secs=0"] \
        + (SCOPE_OPTS if scope is None else scope) + list(extra)
    # key the cache on the full parameter set so edited scopes
    # invalidate stale fixtures
    import hashlib
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    tag = f"{tag}_{phash}"
    out = CACHE / f"ireal_{tag}.webm"
    if not out.exists():
        args = [str(tool("make_fixture")), str(out)] + args_tail
        r = subprocess.run(args, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    prefix = CACHE / f"ireal_{tag}"
    if not prefix.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out), str(prefix)],
                       check=True, capture_output=True)
    return out, prefix


def assert_exact(tag, **kw):
    out, prefix = inter_fixture(tag, **kw)
    w = kw.get("w", 96)
    h = kw.get("h", 96)
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


def test_inter_plain():
    """No order hints / motion modes: base single-ref inter path."""
    assert_exact("plain", extra=(
        "vopt:aom-params=enable-order-hint=0:enable-obmc=0:"
        "enable-warped-motion=0:enable-global-motion=0",))


def test_inter_error_resilient():
    """Error-resilient frames: default CDFs, no temporal mvs, OBMC."""
    assert_exact("er", extra=(
        "vopt:error-resilience=1",
        "vopt:aom-params=enable-order-hint=0:enable-global-motion=0",))


def test_inter_motion_modes():
    """OBMC + local warp with order hints off."""
    assert_exact("mm", crf=30, frames=6, extra=(
        "vopt:aom-params=enable-order-hint=0:enable-global-motion=0",))


def test_inter_cdf_inheritance():
    """primary_ref_frame entropy inheritance across frames."""
    assert_exact("inh", crf=24, extra=(
        "vopt:aom-params=enable-order-hint=0:enable-obmc=0:"
        "enable-warped-motion=0:enable-global-motion=0",))


def test_inter_temporal_mvs():
    """Order hints + use_ref_frame_mvs temporal projection."""
    assert_exact("tmv", crf=30, frames=6, extra=(
        "vopt:aom-params=enable-order-hint=1:enable-ref-frame-mvs=1:"
        "enable-global-motion=0",))


def test_inter_hbd_like_full():
    """Everything in scope at once, longer sequence."""
    assert_exact("full", crf=36, frames=8, extra=(
        "vopt:aom-params=enable-order-hint=1:enable-ref-frame-mvs=1:"
        "enable-global-motion=0",))


def test_inter_cdef_on():
    """Inter frames with CDEF enabled."""
    assert_exact("cdef", crf=30, frames=4, extra=(
        "vopt:enable-cdef=1",
        "vopt:aom-params=enable-order-hint=1:enable-ref-frame-mvs=1:"
        "enable-global-motion=0",))


def test_inter_odd_size():
    """Partial superblocks on both edges."""
    assert_exact("odd", w=84, h=52, crf=30, frames=4, extra=(
        "vopt:aom-params=enable-order-hint=1:enable-ref-frame-mvs=1:"
        "enable-global-motion=0",))


def test_comp_basic():
    """Alt-refs -> bidirectional compound prediction, motion modes and
    global motion off."""
    assert_exact("comp_basic", frames=6, scope=COMP_SCOPE, extra=(
        "vopt:aom-params=" + COMP_BASE + ":enable-dist-wtd-comp=0:"
        "enable-obmc=0:enable-warped-motion=0:enable-global-motion=0",))


def test_comp_motion_modes():
    """Compound + OBMC + warped motion + global motion together."""
    assert_exact("comp_mm", frames=6, scope=COMP_SCOPE, extra=(
        "vopt:aom-params=" + COMP_BASE + ":enable-dist-wtd-comp=0",))


def test_comp_dist_wtd():
    """Distance-weighted (jnt_comp) compound blocks."""
    assert_exact("comp_jnt", frames=6, scope=COMP_SCOPE, extra=(
        "vopt:aom-params=" + COMP_BASE,))


def test_comp_long():
    """Longer compound sequence at lower crf (denser mode mix)."""
    assert_exact("comp_long", frames=12, crf=30, scope=COMP_SCOPE,
                 extra=("vopt:aom-params=" + COMP_BASE,))


def test_comp_odd_size():
    """Compound prediction with partial superblocks on both edges."""
    assert_exact("comp_odd", w=94, h=98, frames=6, scope=COMP_SCOPE,
                 extra=("vopt:aom-params=" + COMP_BASE,))


# masked compound: wedge + diffwtd on, interintra still out of scope
MASKED_BASE = "enable-interintra-comp=0"


def test_comp_wedge_diffwtd():
    """Wedge + difference-weighted compound blocks (lower crf densifies
    the masked-mode mix)."""
    assert_exact("comp_masked", frames=8, crf=30, scope=COMP_SCOPE, extra=(
        "vopt:aom-params=" + MASKED_BASE + ":enable-dist-wtd-comp=0:"
        "enable-obmc=0:enable-warped-motion=0:enable-global-motion=0",))


def test_comp_masked_all_modes():
    """Masked compound together with OBMC/warp/global/jnt_comp."""
    assert_exact("comp_masked_all", frames=8, crf=26, scope=COMP_SCOPE,
                 extra=("vopt:aom-params=" + MASKED_BASE,))


def test_comp_masked_odd_size():
    """Masked compound with partial superblocks on both frame edges."""
    assert_exact("comp_masked_odd", w=94, h=98, frames=8, crf=30,
                 scope=COMP_SCOPE,
                 extra=("vopt:aom-params=" + MASKED_BASE,))
