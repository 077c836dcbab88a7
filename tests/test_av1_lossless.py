"""Lossless (coded_lossless, inverse WHT) conformance: real libaom
lossless=1 streams, intra and inter, decoded bit-exact vs libdav1d.

Reference parity: easyav1 decodes via dav1d (src/easyav1.c); covers
dav1d itx.c WHT_WHT + the lossless header/parse gates."""

import hashlib
import subprocess

import numpy as np

from fixtures import CACHE, tool


def _fixture(w, h, frames, gop):
    # crf=0 is required for libaom to honour lossless=1: with crf>0 the
    # stream is silently NOT coded_lossless (discovered the hard way —
    # these fixtures originally used crf=40 and never exercised the WHT)
    args_tail = [f"w={w}", f"h={h}", "fps=10", f"frames={frames}",
                 f"gop={gop}", "crf=0", "audio_secs=0",
                 "vopt:lossless=1", "vopt:enable-restoration=0",
                 "vopt:enable-palette=0", "vopt:enable-filter-intra=0",
                 "vopt:enable-intrabc=0", "vopt:lag-in-frames=0"]
    phash = hashlib.sha1(" ".join(args_tail).encode()).hexdigest()[:8]
    out = CACHE / f"ll_{phash}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)]
                           + args_tail, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    return out


def _roundtrip(w, h, frames, gop):
    out = _fixture(w, h, frames, gop)
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


def test_lossless_intra():
    _roundtrip(96, 96, 3, 1)


def test_lossless_inter_odd():
    _roundtrip(94, 98, 5, 100)


def test_lossless_coded_flag():
    """The crf=0 fixture must actually be coded_lossless (guards against
    libaom silently ignoring lossless=1 at crf>0)."""
    import numpy as np
    from easyav1.container.webm import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend
    from easyav1.video.av1 import constants as C
    from easyav1.video.av1.headers import (split_obus,
                                               parse_sequence_header,
                                               HeaderParser)
    path = _fixture(96, 96, 3, 1)
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt)
    p = dmx.read_packet()
    while p.track != vt.number:
        p = dmx.read_packet()
    for obu in split_obus(p.frames[0]):
        if obu.type == C.OBU_SEQUENCE_HEADER:
            be.seq = parse_sequence_header(obu.payload)
            be.hp = HeaderParser(be.seq)
        elif obu.type == C.OBU_FRAME:
            hdr = be._parse_frame_header(obu.payload)
            assert hdr.coded_lossless
            return
    raise AssertionError("no frame OBU found")


def test_lossless_synth_multitx_cfl():
    """Synth regression for the two lossless entropy bugs fixed here:
    (a) CfL allowed only when the chroma plane block is 4x4 under
    lossless (libaom is_cfl_allowed), i.e. uv_mode uses the 13-symbol
    CDF for >=16x16 blocks; (b) chroma txb_skip context offset is 10
    (not 7) when the chroma block holds multiple txs
    (libaom av1_get_txb_ctx). Both only bite with 4x4 txs inside
    >=16x16 blocks — i.e. coded_lossless streams."""
    import numpy as np
    from av1_synth import synth_compare
    from easyav1.video.av1.av1_enc import EncBlock
    from easyav1.video.av1 import constants as C
    blocks = []
    for r in range(0, 24, 8):
        for c in range(0, 24, 8):
            lc = [[(1 + (k + i) % 6, (k + i) & 1) for i in range(5)]
                  for k in range(64)]
            blocks.append(EncBlock(r, c, C.BLOCK_32X32, y_mode=C.DC_PRED,
                                   skip=0, luma_coeffs=lc))
    dav, mine = synth_compare(blocks, 96, 96, 0, "ll_mtx")
    for pl in "yuv":
        d = int(np.abs(dav[pl].astype(int) - mine[pl].astype(int)).max())
        assert d == 0, f"plane {pl} maxdiff {d}"
