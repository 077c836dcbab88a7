"""Device intra executor (DeviceRecon, the lax.scan unit executor).

Random pred-unit programs (all classes, edge filters, upsampling,
zone1/2/3 angles, CfL with clipped non-pow2 ac blocks) are replayed by
both exec_ref.UnitExecutor and DeviceRecon.predict; outputs must be
bit-identical.  Seeds include past regressions of the executors: zone2
left base_y < -2 clamp, upsample interleave, edge slot -2 zero-init.

The pipe-level tests decode whole streams with EASYAV1_PIPE=pallas and
compare every frame with the native C decode: a frame either runs on
the device executor or declines to C, and must match either way.
"""

import numpy as np
import pytest

from easyav1.video.av1.recon.exec_ref import UnitExecutor
from easyav1.video.av1.recon import jax_exec as JX

MIR, MIC = 30, 26
SSX = SSY = 1


def _base_layer(plane):
    ph = (MIR * 4) >> (SSY if plane else 0)
    pw = (MIC * 4) >> (SSX if plane else 0)
    out = []
    for y in range(0, ph, 16):
        for x in range(0, pw, 16):
            w = min(16, pw - x) // 4 * 4
            h = min(16, ph - y) // 4 * 4
            out.append([plane, x, y, w, h, 0, 0, int(y > 0),
                        int(x > 0), 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0])
    return np.array(out, np.int32)


def _rand_units(n, plane, rng):
    """Random units confined to 64-row (32 chroma) superblock rows, so
    every unit's edges were reconstructed by earlier units."""
    ph = (MIR * 4) >> (SSY if plane else 0)
    pw = (MIC * 4) >> (SSX if plane else 0)
    sh = 64 >> (1 if plane else 0)
    units = []
    for _ in range(n):
        w = min(int(2 ** rng.integers(2, 6)), 32)
        h = min(int(2 ** rng.integers(2, 6)), 32)
        x = int(rng.integers(0, (pw - w) // 4 + 1)) * 4
        strip = int(rng.integers(0, ph // sh))
        y = strip * sh + int(rng.integers(0, (sh - h) // 4 + 1)) * 4
        y = min(y, ph - h)
        cls = int(rng.integers(0, 9))
        ang = 0
        if cls == 3:
            zone = rng.integers(0, 3)
            rngs = {0: range(36, 88, 3), 1: range(93, 178, 3),
                    2: range(183, 268, 3)}[int(zone)]
            ang = int(rng.choice(list(rngs)))
        ha, hl = int(y > 0), int(x > 0)
        htr = int(rng.integers(0, 2)) if ha else 0
        hbl = int(rng.integers(0, 2)) if hl else 0
        if hbl and (y % sh) + 2 * h > sh:
            hbl = 0
        sa = int(rng.integers(0, 4)) if cls == 3 else 0
        sl = int(rng.integers(0, 4)) if cls == 3 else 0
        ua = int(rng.integers(0, 2)) if cls == 3 and w + h <= 16 else 0
        ul = int(rng.integers(0, 2)) if cls == 3 and w + h <= 16 else 0
        cf = int(rng.integers(0, 2)) \
            if cls == 3 and 90 < ang < 180 and ha and hl else 0
        alpha = acx = acy = acw = ach = 0
        if cls == 8 and plane:
            alpha = int(rng.integers(-16, 17))
            offx = 4 * int(rng.integers(0, 2)) \
                if (x >= 4 and w <= 28) else 0
            offy = 4 * int(rng.integers(0, 2)) \
                if (y % sh >= 4 and h <= 28) else 0
            acx, acy = x - offx, y - offy
            acw, ach = offx + w, offy + h
            if rng.integers(0, 2) and ach > 4:
                ach -= 4
            if rng.integers(0, 2) and acw > 4:
                acw -= 4
        units.append([plane, x, y, w, h, cls, ang, ha, hl, htr, hbl,
                      sa, sl, ua, ul, cf, alpha, acx, acy, acw, ach,
                      0, 0, 0])
    return np.array(units, np.int32)


@pytest.mark.parametrize("seed", [301, 304, 305, 317, 310])
def test_scan_vs_exec_ref(seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    plane = int(rng.integers(0, 3))
    base = _base_layer(plane)
    rand = _rand_units(8, plane, rng)
    sh = 64 >> (1 if plane else 0)
    nstrip = -(-((MIR * 4) >> (1 if plane else 0)) // sh)
    parts = []
    for st in range(nstrip):
        parts.append(base[base[:, 2] // sh == st])
        parts.append(rand[rand[:, 2] // sh == st])
    units = np.concatenate(parts)

    ex = UnitExecutor(MIR, MIC, SSX, SSY, 8, 3)
    resid = [rng.integers(-50, 51, d).astype(np.int64)
             for d in ex.dims]
    gold = ex.run(units, resid)

    dr = JX.DeviceRecon(MIR, MIC, SSX, SSY, 8, 3)
    rpad = []
    for p, (ph, pw) in enumerate(dr.dims):
        r = np.zeros(JX.pad_dims(ph, pw, dr.ws[p]), np.int32)
        r[JX.PAD:JX.PAD + ph, JX.PAD:JX.PAD + pw] = resid[p]
        rpad.append(jnp.asarray(r))
    outs = dr.predict(JX.preprocess_units(units, dr.dims), rpad)
    got = dr.crop(outs)[plane]
    d = np.abs(got.astype(np.int64) - gold[plane])
    assert d.max() == 0, (
        f"plane {plane}: maxdiff {d.max()} at "
        f"{np.argwhere(d > 0)[:4].tolist()}")


def _decode(monkeypatch, pipe, fx=None, tus=None, n=None):
    """Every displayed frame's planes from decoding a fixture file (or
    raw temporal units) with EASYAV1_PIPE=pipe."""
    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.container.webm import TrackInfo
    from easyav1.video.av1.backend import AV1Backend

    monkeypatch.setenv("EASYAV1_PIPE", pipe)
    if fx is not None:
        d = WebMDemuxer(str(fx))
        vt = d.tracks_of_type(TrackType.VIDEO)[0]
        tus = []
        while (p := d.read_packet()) is not None:
            if p.track == vt.number:
                tus.extend(p.frames)
    else:
        vt = TrackInfo(number=1, type=None, codec_id="V_AV1")
    be = AV1Backend(vt)
    out = []
    for tu in tus[:n]:
        for f in be.decode([tu], 0):
            out.append([np.asarray(pl).copy() for pl in f.data])
    return out


def _assert_same(a, b, tag=""):
    assert len(a) == len(b) > 0, tag
    for fa, fb in zip(a, b):
        for x, y in zip(fa, fb):
            assert np.array_equal(x, y), tag


def test_device_lossless_safe(monkeypatch):
    """Lossless (WHT) frames run on the device pipe (the host residual
    composer handles itx_wht4); frames the executor still declines must
    fall back to C bit-exactly either way."""
    from fixtures import make_fixture

    fx = make_fixture(w=128, h=96, fps=10, frames=3, gop=1, crf=0,
                      audio_secs=0, vopt=["lossless=1"])
    a = _decode(monkeypatch, "native", fx)
    b = _decode(monkeypatch, "pallas", fx)
    assert len(a) == 3
    _assert_same(a, b)


def test_device_palette_runs_exact(monkeypatch):
    """Palette intra frames run on device as cls-10 literal units and
    must match the native decode exactly."""
    from test_av1_palette_synth import W, H, _pal_block
    from easyav1.video.av1.av1_enc import EncBlock, encode_frame
    from easyav1.video.av1 import constants as C

    rng = np.random.default_rng(0)
    blocks = []
    for r in range(0, 16, 4):
        for c in range(0, 16, 4):
            if (r, c) == (0, 0):
                blocks.append(_pal_block(0, 0, C.BLOCK_16X16, 4, 1))
            else:
                blocks.append(EncBlock(
                    r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                    luma_coeffs=[[(int(rng.integers(1, 9)), 0)
                                  for _ in range(4)]]))
    tus = [encode_frame(W, H, 60, blocks, adapt=True, screen=True)]
    _assert_same(_decode(monkeypatch, "native", tus=tus),
                 _decode(monkeypatch, "pallas", tus=tus))


def test_device_intrabc_runs_exact(monkeypatch):
    """allow_intrabc frames run on device as cls-11 units (dynamic
    slices of the partially reconstructed plane) and must match the
    native decode exactly."""
    import test_av1_intrabc as TI
    from easyav1.video.av1 import constants as C

    rng = np.random.default_rng(3)
    blocks = TI._intra_fill(rng, 48)
    placed = 0
    for c in range(0, 16, 4):
        dv = ((0 - 48) * 4 * 8, 0)
        if TI.dv_valid(48, c, C.BLOCK_16X16, dv):
            blocks.append(TI.EncBlock(r=48, c=c, bsize=C.BLOCK_16X16,
                                      skip=True, dv=dv))
            placed += 1
    for r in range(48, TI.H // 4, 4):
        for c in range(0, TI.W // 4, 4):
            if r == 48 and c < placed * 4:
                continue
            blocks.append(TI.EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                      skip=True))
    assert placed > 0
    tus = [TI.encode_frame(TI.W, TI.H, 60, blocks, intrabc=True)]
    _assert_same(_decode(monkeypatch, "native", tus=tus),
                 _decode(monkeypatch, "pallas", tus=tus))


FORMATS = [("444", dict(ss=444)), ("422", dict(ss=422)),
           ("mono", dict(ss="mono")), ("10b", dict(bitdepth=10))]


@pytest.mark.parametrize("tag,kv", FORMATS, ids=[f[0] for f in FORMATS])
def test_device_format_sweep_intra(monkeypatch, tag, kv):
    """Every pixel format either runs on the device executor or
    declines to C; output must match the native path regardless."""
    from test_av1_hbd import BASE, fixture

    fx = fixture(tag + "i", **BASE, gop=1, **kv)
    _assert_same(_decode(monkeypatch, "native", fx, n=4),
                 _decode(monkeypatch, "pallas", fx, n=4), tag)


@pytest.mark.parametrize("tag,kv", FORMATS, ids=[f[0] for f in FORMATS])
def test_device_format_sweep_inter(monkeypatch, tag, kv):
    """The same run-or-decline-must-match check for INTER frames
    through the device MC path (the gop spans the clip, so frames 2+
    are inter)."""
    from test_av1_hbd import BASE, fixture

    fx = fixture(tag + "p", **BASE, gop=100, **kv)
    _assert_same(_decode(monkeypatch, "native", fx, n=5),
                 _decode(monkeypatch, "pallas", fx, n=5), tag)
