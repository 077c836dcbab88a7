"""Loop restoration conformance on real libaom streams (cpu-used=2
keyframes exercise wiener + sgrproj units) vs the libdav1d oracle."""

import subprocess

import numpy as np

from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool


def lr_fixture(tag, w, h, crf, frames=1, extra=()):
    import hashlib
    args_tail = [f"w={w}", f"h={h}", "fps=10", f"frames={frames}",
                 "gop=100", f"crf={crf}", "audio_secs=0", "cpu-used=2",
                 "vopt:enable-restoration=1", "vopt:enable-palette=0",
                 "vopt:enable-filter-intra=0", "vopt:enable-intrabc=0",
                 "vopt:lag-in-frames=0"] + list(extra)
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"lreal_{tag}_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)] + args_tail,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    prefix = CACHE / out.stem
    if not prefix.with_suffix(".yuv").exists():
        subprocess.run([str(tool("oracle")), str(out), str(prefix)],
                       check=True, capture_output=True)
    return out, prefix


def assert_exact(tag, w, h, crf, frames=1, extra=()):
    out, prefix = lr_fixture(tag, w, h, crf, frames, extra)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
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
                dims = [(w, h), (cw, ch), (cw, ch)]
                off = fi * per
                for pi, (dw, dh) in enumerate(dims):
                    gold = raw[off:off + dw * dh].reshape(dh, dw)
                    off += dw * dh
                    d = np.abs(gold.astype(int) - f.data[pi].astype(int))
                    assert d.max() == 0, (
                        f"{tag} frame {fi} plane {pi}: maxdiff {d.max()}")
                fi += 1
    assert fi == frames


def test_lr_real_sgr():
    assert_exact("sgr", 96, 96, 30)


def test_lr_real_mixed_units():
    """Several units, wiener + sgr + none across planes."""
    assert_exact("mix", 320, 200, 40)


def test_lr_real_wiener():
    assert_exact("wiener", 200, 320, 18)


def test_lr_real_synthetic_content():
    assert_exact("noise", 160, 160, 35, extra=("content=1",))


def test_lr_real_pallas_pipe(monkeypatch):
    """Real libaom LR streams through the full device pipe: loop
    restoration runs device-resident (lr_jax.apply_device) after the
    device LF+CDEF, no C-recon fallback, bit-exact vs dav1d."""
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    assert_exact("mix", 320, 200, 40)
    assert native._PIPE_STATS["frames"] > 0
    assert native._PIPE_STATS["fallbacks"] == 0


def test_lr_real_pallas_pipe_inter(monkeypatch):
    """Inter frames with LR through the jax MC device pipe."""
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    assert_exact("interlr", 160, 128, 32, frames=4,
                 extra=("gop=4",))
    assert native._PIPE_STATS["frames"] >= 4
    assert native._PIPE_STATS["fallbacks"] == 0
