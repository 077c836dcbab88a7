"""Device inter reconstruction (mc_jax): MC + itx + intra scan +
postfilters on device, bit-exact vs the native C recon.

Reference role: dav1d mc_tmpl.c (cmake/dav1d.cmake:1001-1015) — the
device pipe must reproduce the C pipeline (itself dav1d-bit-exact,
tests/test_native_inter.py) exactly.
"""

import os

import numpy as np
import pytest

from fixtures import make_fixture

# inter fixture without the features the device path gates on
# (OBMC, warp, masked compound, interintra, palette, restoration)
_VOPTS = [
    "enable-obmc=0", "enable-masked-comp=0", "enable-interintra-comp=0",
    "enable-global-motion=0", "enable-restoration=0", "enable-palette=0",
    "enable-filter-intra=0", "enable-intrabc=0",
    "aom-params=enable-warped-motion=0",
]


def _decode_all(path, pipe, copy=True):
    os.environ["EASYAV1_PIPE"] = pipe
    try:
        from easyav1.container import TrackType, WebMDemuxer
        from easyav1.video.av1.backend import AV1Backend

        d = WebMDemuxer(str(path))
        vt = d.tracks_of_type(TrackType.VIDEO)[0]
        pkts = []
        while (p := d.read_packet()) is not None:
            if p.track == vt.number:
                pkts.extend(p.frames)
        be = AV1Backend(vt)
        out = []
        for pk in pkts:
            for f in be.decode([pk], 0):
                out.append([np.asarray(pl).copy() if copy
                            else np.asarray(pl) for pl in f.data])
        return out
    finally:
        os.environ["EASYAV1_PIPE"] = "native"


@pytest.mark.slow
def test_device_inter_bitexact():
    fx = make_fixture(w=320, h=180, fps=30, frames=12, gop=999, crf=30,
                      audio_secs=0, content=1, vopt=_VOPTS)
    ref = _decode_all(fx, "native")
    import easyav1.native as nat

    nat._DEVICE_INTER_STATS["frames"] = 0
    nat._DEVICE_INTER_STATS["fallbacks"] = 0
    dev = _decode_all(fx, "pallas")
    assert len(ref) == len(dev) == 12
    # the device MC path must actually run (not silently fall back)
    assert nat._DEVICE_INTER_STATS["frames"] >= 8, \
        nat._DEVICE_INTER_STATS
    for i, (a, b) in enumerate(zip(ref, dev)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (
                f"frame {i} plane {p}: "
                f"{np.abs(x.astype(int) - y.astype(int)).max()}")


@pytest.mark.slow
def test_device_inter_compound_present():
    """The fixture must exercise compound prediction on the device
    path (otherwise the pair kernel is dead code in this suite)."""
    fx = make_fixture(w=320, h=180, fps=30, frames=12, gop=999, crf=30,
                      audio_secs=0, content=1, vopt=_VOPTS)
    from easyav1.video.av1.recon import mc_jax

    seen = {"pairs": 0, "singles": 0}
    orig = mc_jax.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if plan is not None:
            seen["pairs"] += sum(v.shape[0]
                                 for v in plan["pairs"].values())
            seen["singles"] += sum(v.shape[0]
                                   for v in plan["singles"].values())
        return plan

    mc_jax.export_inter_plan = spy
    try:
        _decode_all(fx, "pallas")
    finally:
        mc_jax.export_inter_plan = orig
    assert seen["singles"] > 100, seen


def test_native_frames_stay_valid_while_held():
    """Zero-copy display planes must remain valid while the caller
    holds them (numpy collapses view bases, so the recycling gate must
    check the backing allocation, not just the plane array).
    Regression: frames 0-2 of a 12-frame decode were overwritten when
    all frames were held as views."""
    fx = make_fixture(w=320, h=180, fps=30, frames=12, gop=999, crf=30,
                      audio_secs=0, content=1, vopt=_VOPTS)
    held = _decode_all(fx, "native", copy=False)
    copies = _decode_all(fx, "native", copy=True)
    for i, (a, b) in enumerate(zip(held, copies)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), f"frame {i} plane {p}"


@pytest.mark.slow
def test_device_resident_decode():
    """Resident mode: frames + refs stay on device, per-frame device
    hashes match the host-side hash of the native decode, and display
    pull materializes bit-exact planes."""
    from easyav1.video.av1.recon.resident import (decode_resident,
                                                      frame_hash_host)

    fx = make_fixture(w=320, h=180, fps=30, frames=8, gop=999, crf=30,
                      audio_secs=0, content=1, vopt=_VOPTS)
    ref = _decode_all(fx, "native")
    n, wall, hashes, frames = decode_resident(fx, max_frames=8)
    assert n == len(ref) == 8
    for i, rf in enumerate(ref):
        assert frame_hash_host(rf) == hashes[i], f"frame {i} hash"
    # display pull on demand (no earlier materialization)
    got = [np.asarray(pl) for pl in frames[3].data]
    for p, (x, y) in enumerate(zip(ref[3], got)):
        assert np.array_equal(x, y), f"frame 3 plane {p}"


@pytest.mark.slow
def test_device_masked_compound_bitexact():
    """Wedge + diffwtd compound on the device pair kernel: must decode with ZERO per-frame C fallbacks and match the
    native recon (itself dav1d-bit-exact via test_av1_inter_real
    test_comp_wedge_diffwtd)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_av1_inter_real import COMP_SCOPE, inter_fixture

    fx, _ = inter_fixture(
        "comp_masked", frames=8, crf=30, scope=COMP_SCOPE, extra=(
            "vopt:aom-params=enable-interintra-comp=0:"
            "enable-dist-wtd-comp=0:enable-obmc=0:"
            "enable-warped-motion=0:enable-global-motion=0",))
    ref = _decode_all(fx, "native")
    import easyav1.native as nat

    nat._DEVICE_INTER_STATS["frames"] = 0
    nat._DEVICE_INTER_STATS["fallbacks"] = 0
    dev = _decode_all(fx, "pallas")
    assert len(ref) == len(dev) == 8
    assert nat._DEVICE_INTER_STATS["fallbacks"] == 0, \
        nat._DEVICE_INTER_STATS
    assert nat._DEVICE_INTER_STATS["frames"] >= 7
    for i, (a, b) in enumerate(zip(ref, dev)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (
                f"frame {i} plane {p}: "
                f"{np.abs(x.astype(int) - y.astype(int)).max()}")


@pytest.mark.slow
def test_device_obmc_bitexact():
    """OBMC blocks on the device path: base prediction
    without residual, batched above/left overlay blends, deferred
    residual — bit-exact vs the C recon (av1_mc.h apply_obmc, itself
    dav1d-verified via test_av1_inter_real test_inter_motion_modes)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_av1_inter_real import inter_fixture

    fx, prefix = inter_fixture(
        "obmc_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-warped-motion=0:enable-interintra-comp=0:"
               "enable-dist-wtd-comp=0",))
    ref = _decode_all(fx, "native")
    # anchor the C side to the dav1d oracle dump for this fixture
    raw = np.fromfile(str(prefix) + ".yuv", dtype=np.uint8)
    w_, h_ = 192, 128
    per = w_ * h_ + 2 * (w_ // 2) * (h_ // 2)
    for i, fr in enumerate(ref):
        gold = raw[i * per:i * per + w_ * h_].reshape(h_, w_)
        assert np.array_equal(gold, fr[0]), f"oracle frame {i}"
    import easyav1.native as nat

    nat._DEVICE_INTER_STATS["frames"] = 0
    nat._DEVICE_INTER_STATS["fallbacks"] = 0
    dev = _decode_all(fx, "pallas")
    assert len(ref) == len(dev) == 8
    assert nat._DEVICE_INTER_STATS["fallbacks"] == 0, \
        nat._DEVICE_INTER_STATS
    for i, (a, b) in enumerate(zip(ref, dev)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (
                f"frame {i} plane {p}: "
                f"{np.abs(x.astype(int) - y.astype(int)).max()}")


@pytest.mark.slow
def test_device_obmc_overlays_present():
    """The OBMC fixture must actually emit overlay units."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_av1_inter_real import inter_fixture
    from easyav1.video.av1.recon import mc_jax

    fx, _ = inter_fixture(
        "obmc_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-warped-motion=0:enable-interintra-comp=0:"
               "enable-dist-wtd-comp=0",))
    seen = {"ov": 0}
    orig = mc_jax.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if plan is not None:
            seen["ov"] += sum(v.shape[0]
                              for v in plan["obmc_above"].values())
            seen["ov"] += sum(v.shape[0]
                              for v in plan["obmc_left"].values())
        return plan

    mc_jax.export_inter_plan = spy
    try:
        _decode_all(fx, "pallas")
    finally:
        mc_jax.export_inter_plan = orig
    assert seen["ov"] > 0, "fixture emitted no OBMC overlays"


@pytest.mark.slow
def test_device_warp_bitexact():
    """Local warped motion + OBMC mixed on the device path: the warp
    kernel (av1_mc.h warp_affine_u16 role) must be bit-exact with zero
    fallbacks, anchored to the dav1d oracle."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_av1_inter_real import inter_fixture

    fx, prefix = inter_fixture(
        "warp_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-interintra-comp=0:enable-dist-wtd-comp=0",))
    ref = _decode_all(fx, "native")
    raw = np.fromfile(str(prefix) + ".yuv", dtype=np.uint8)
    w_, h_ = 192, 128
    per = w_ * h_ + 2 * (w_ // 2) * (h_ // 2)
    for i, fr in enumerate(ref):
        gold = raw[i * per:i * per + w_ * h_].reshape(h_, w_)
        assert np.array_equal(gold, fr[0]), f"oracle frame {i}"
    import easyav1.native as nat

    nat._DEVICE_INTER_STATS["frames"] = 0
    nat._DEVICE_INTER_STATS["fallbacks"] = 0
    dev = _decode_all(fx, "pallas")
    assert len(ref) == len(dev) == 8
    assert nat._DEVICE_INTER_STATS["fallbacks"] == 0, \
        nat._DEVICE_INTER_STATS
    for i, (a, b) in enumerate(zip(ref, dev)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (
                f"frame {i} plane {p}: "
                f"{np.abs(x.astype(int) - y.astype(int)).max()}")


@pytest.mark.slow
def test_device_warp_units_present():
    """The warp fixture must actually emit warp sub-units."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_av1_inter_real import inter_fixture
    from easyav1.video.av1.recon import mc_jax

    fx, _ = inter_fixture(
        "warp_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-interintra-comp=0:enable-dist-wtd-comp=0",))
    seen = {"warp": 0}
    orig = mc_jax.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if plan is not None:
            seen["warp"] += sum(v.shape[0]
                                for v in plan["warps"].values())
        return plan

    mc_jax.export_inter_plan = spy
    try:
        _decode_all(fx, "pallas")
    finally:
        mc_jax.export_inter_plan = orig
    assert seen["warp"] > 0, "fixture emitted no warp units"


@pytest.mark.slow
def test_device_interintra_bitexact():
    """Interintra compound on the device path: the C exporter emits
    the intra half as pred units (blend pack in u[23]); the scan
    blends against the staged inter pred with wedge/decay masks
    (av1_mc.h interintra_blend role).  Dense synthetic interintra
    stream (dav1d-verified by test_av1_interintra); zero fallbacks."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import fuzz_tmv_future as FZ
    from fixtures import CACHE
    from easyav1.container.webm import TrackInfo
    from easyav1.video.av1 import constants as C
    from easyav1.video.av1.av1_enc import make_ivf
    from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                     encode_ref_sequence)
    from easyav1.video.av1.backend import AV1Backend
    from easyav1.video.av1.wedge import wedge_allowed

    rng = np.random.default_rng(5)
    blocks = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            mode = int(rng.choice([C.NEWMV, C.NEARESTMV]))
            b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                              is_inter=True, ref=C.LAST_FRAME,
                              mode=mode, skip=bool(rng.random() < 0.3))
            if mode == C.NEWMV:
                b.mv = (2 * int(rng.integers(-30, 31)),
                        2 * int(rng.integers(-30, 31)))
            if rng.random() < 0.8:
                b.interintra_mode = int(rng.integers(0, 4))
                if wedge_allowed(C.BLOCK_16X16) and rng.random() < 0.5:
                    b.ii_wedge = 1
                    b.ii_wedge_idx = int(rng.integers(0, 16))
            if not b.skip:
                b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                   int(rng.integers(0, 2)))
                                  for _ in range(3)]]
            blocks.append(b)
    frames = [dict(type=C.KEY_FRAME, blocks=FZ.keyblocks(rng),
                   order_hint=0),
              dict(type=C.INTER_FRAME, blocks=blocks, order_hint=1,
                   refresh=2, ref_idx=[0] * 7, err=False)]
    tus = encode_ref_sequence(FZ.W, FZ.H, 70, frames, carry=True,
                              interintra=True)

    def decode(pipe):
        os.environ["EASYAV1_PIPE"] = pipe
        try:
            be = AV1Backend(TrackInfo(number=1, type=None,
                                      codec_id="V_AV1"))
            out = []
            for tu in tus:
                for f in be.decode([tu], 0):
                    out.append([np.asarray(pl).copy() for pl in f.data])
            return out
        finally:
            os.environ["EASYAV1_PIPE"] = "native"

    ref = decode("native")
    import easyav1.native as nat

    nat._DEVICE_INTER_STATS["frames"] = 0
    nat._DEVICE_INTER_STATS["fallbacks"] = 0
    dev = decode("pallas")
    assert len(ref) == len(dev) == 2
    assert nat._DEVICE_INTER_STATS["fallbacks"] == 0, \
        nat._DEVICE_INTER_STATS
    for i, (a, b) in enumerate(zip(ref, dev)):
        for p, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (
                f"frame {i} plane {p}: "
                f"{np.abs(x.astype(int) - y.astype(int)).max()}")
