"""Filter-intra (recursive intra prediction, spec 7.11.2.3)
conformance: real libaom all-intra streams with the tool enabled
(default), decoded bit-exact vs libdav1d.

Reference parity: easyav1 decodes via dav1d (src/easyav1.c); this
covers dav1d ipred.c filter_intra + parse (decode.c)."""

import hashlib
import subprocess

import numpy as np

from fixtures import CACHE, tool


def _roundtrip(cpu, w=96, h=96, frames=3):
    args_tail = [f"w={w}", f"h={h}", "fps=10", f"frames={frames}",
                 "gop=1", "crf=30", "audio_secs=0", f"cpu-used={cpu}",
                 "vopt:enable-restoration=0", "vopt:enable-palette=0",
                 "vopt:enable-intrabc=0", "vopt:lag-in-frames=0"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"fi_{phash}.webm"
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
                off = fi * per
                for pi, (dw, dh) in enumerate(((w, h), (cw, ch),
                                               (cw, ch))):
                    gold = raw[off:off + dw * dh].reshape(dh, dw)
                    off += dw * dh
                    d = np.abs(gold.astype(int)
                               - f.data[pi].astype(int))
                    assert d.max() == 0, \
                        f"cpu{cpu} frame {fi} plane {pi} {d.max()}"
                fi += 1
    assert fi == frames


def test_filter_intra_cpu4():
    _roundtrip(4)


def test_filter_intra_cpu5_odd():
    _roundtrip(5, w=94, h=98)


def test_filter_intra_pallas_pipe(monkeypatch):
    """Filter-intra through the device pipe: the scan kernels run the
    4x2-patch recurrence as a sequential in-kernel loop (cls-9 units
    carry the filter mode); no C-recon fallback, bit-exact vs dav1d."""
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    _roundtrip(4)
    assert native._PIPE_STATS["frames"] > 0
    assert native._PIPE_STATS["fallbacks"] == 0


def test_filter_intra_pallas_pipe_inter(monkeypatch):
    """Filter-intra blocks inside inter frames via the jax MC pipe's
    sequential intra scan."""
    import hashlib
    import subprocess

    from easyav1 import native
    from easyav1.container.webm import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    args_tail = ["w=128", "h=96", "fps=10", "frames=4", "gop=4",
                 "crf=30", "audio_secs=0", "cpu-used=4",
                 "vopt:enable-restoration=0", "vopt:enable-palette=0",
                 "vopt:enable-intrabc=0", "vopt:lag-in-frames=0"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"fii_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)]
                           + args_tail, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    dmx = WebMDemuxer(str(out))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt)
    want = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            for fr in p.frames:
                for f in be.decode([fr], 0):
                    want.append([np.asarray(x).copy() for x in f.data])
    monkeypatch.setenv("EASYAV1_PIPE", "pallas")
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    dmx = WebMDemuxer(str(out))
    be = AV1Backend(dmx.tracks_of_type(TrackType.VIDEO)[0])
    got = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            for fr in p.frames:
                for f in be.decode([fr], 0):
                    got.append([np.asarray(x).copy() for x in f.data])
    assert native._PIPE_STATS["fallbacks"] == 0
    assert len(want) == len(got) > 0
    for k, (fa, fb) in enumerate(zip(want, got)):
        for pi, (a, b) in enumerate(zip(fa, fb)):
            assert np.array_equal(a, b), f"frame {k} plane {pi}"
