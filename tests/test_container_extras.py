"""Demux long tail: BlockAdditions + ContentEncodings recognition.

Reference parity: nestegg.c:1753 (block additional parse) and
nestegg.c:1252,1606 (track ContentEncodings: header-strip compression
applied per block, encrypted tracks refused cleanly).
"""

import numpy as np

from easyav1.container import TrackType, WebMDemuxer
from easyav1.container.mux import MuxTrack, WebMMuxer
from easyav1.io.stream import MemoryStream


def _mux_with(track_kwargs=None, additions=None, n=4):
    m = WebMMuxer()
    m.add_track(MuxTrack(1, TrackType.VIDEO, "V_AV1", width=64,
                         height=64, **(track_kwargs or {})))
    rng = np.random.default_rng(7)
    frames_in = []
    for i in range(n):
        fr = bytes(rng.integers(0, 256, 50, dtype=np.uint8))
        frames_in.append(fr)
        m.add_packet(1, i * 33_000_000, [fr], keyframe=(i == 0),
                     blockgroup=True,
                     additions=additions(i) if additions else None)
    return m.finalize(), frames_in


def test_block_additions_roundtrip():
    alpha = {i: bytes([0xA0 + i]) * 20 for i in range(4)}
    data, frames_in = _mux_with(
        additions=lambda i: {1: alpha[i], 7: b"meta" + bytes([i])})
    d = WebMDemuxer(MemoryStream(data))
    got = []
    while (p := d.read_packet()) is not None:
        got.append(p)
    assert len(got) == 4
    for i, p in enumerate(got):
        assert p.frames == [frames_in[i]]
        assert p.additions == {1: alpha[i], 7: b"meta" + bytes([i])}


def test_block_additions_absent_is_none():
    data, _ = _mux_with()
    d = WebMDemuxer(MemoryStream(data))
    p = d.read_packet()
    assert p is not None and p.additions is None


def test_encrypted_track_skipped_cleanly():
    data, _ = _mux_with(track_kwargs={"encrypted": True})
    d = WebMDemuxer(MemoryStream(data))
    t = d.tracks[1]
    assert t.encrypted
    # packets of the encrypted track are dropped, stream ends cleanly
    assert d.read_packet() is None


def test_unsupported_compression_skipped():
    data, _ = _mux_with(track_kwargs={"compression_algo": 0})  # zlib
    d = WebMDemuxer(MemoryStream(data))
    assert d.tracks[1].unsupported_encoding
    assert d.read_packet() is None


def test_header_strip_compression_reprepended():
    prefix = b"\x12\x00\x0a"
    data, frames_in = _mux_with(track_kwargs={"strip_bytes": prefix})
    d = WebMDemuxer(MemoryStream(data))
    assert d.tracks[1].strip_bytes == prefix
    got = []
    while (p := d.read_packet()) is not None:
        got.extend(p.frames)
    assert got == [prefix + f for f in frames_in]


def test_mixed_tracks_encrypted_one_skipped():
    """An encrypted track must not block a clear one (warn-and-continue
    parity: easyav1.c track-init behavior)."""
    m = WebMMuxer()
    m.add_track(MuxTrack(1, TrackType.VIDEO, "V_AV1", width=64,
                         height=64, encrypted=True))
    m.add_track(MuxTrack(2, TrackType.AUDIO, "A_VORBIS",
                         sample_rate=48000.0, channels=2))
    for i in range(3):
        m.add_packet(1, i * 33_000_000, [b"x" * 40], keyframe=True,
                     blockgroup=True)
        m.add_packet(2, i * 33_000_000, [bytes([i]) * 25], keyframe=True)
    d = WebMDemuxer(MemoryStream(m.finalize()))
    got = []
    while (p := d.read_packet()) is not None:
        got.append(p.track)
    assert got == [2, 2, 2]
