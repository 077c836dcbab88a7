"""128x128-block conformance: the spec's residual() (5.11.34) splits
blocks wider/taller than 64px into 64x64 chunks with the planes (and
inter var-tx leaves) interleaved PER CHUNK.  Reading all luma txs and
then chroma desyncs the arithmetic decoder on any stream with a rich
128-px block — which libaom emits for >=0.25MP frames (sb-size=128 is
its default at 1080p).

Reference parity: easyav1 decodes via dav1d (src/easyav1.c); covers
dav1d decode.c read_coef_blocks' 64px chunk loops."""

import hashlib
import subprocess

import numpy as np

from fixtures import CACHE, tool


def _roundtrip(w, h, frames, gop, content=1):
    args_tail = [f"w={w}", f"h={h}", "fps=30", f"frames={frames}",
                 f"gop={gop}", "crf=30", "audio_secs=0",
                 f"content={content}", "vopt:sb-size=128"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"sb128_{phash}.webm"
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
                        f"frame {fi} plane {pi} {d.max()}"
                fi += 1
    assert fi == frames


def test_sb128_intra_rich():
    # rich 128x128 intra blocks (diagonal-stripe content)
    _roundtrip(512, 512, 2, 1)


def test_sb128_inter():
    # inter frames with 128-px blocks + var-tx chunking
    _roundtrip(512, 512, 5, 100)


def test_sb128_odd_size():
    # partial superblocks on both axes.  Regression for the chroma
    # intra-edge filter-type lookup: the neighbour uv_mode must be read
    # at the chroma-aligned bottom-right mi (libaom chroma_left_mbmi) —
    # a sub-8x8 neighbour pair stores its uv_mode only in the carrier.
    _roundtrip(500, 380, 3, 100)


def test_sb128_inter_720p():
    # regression for two formerly-open gaps fixed together: (a) spec
    # read_var_tx_size returns WITHOUT reading for split subnodes past
    # the frame edge (the bottom partial superblock row straddles), and
    # (b) spec needs_interp_filter suppresses the interp-filter symbol
    # for large GLOBALMV blocks whose GmType != TRANSLATION (IDENTITY
    # included).  Either bug desyncs this stream from frame 4.
    _roundtrip(1280, 720, 8, 9999)
