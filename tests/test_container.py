"""WebM demuxer tests: real (libavformat-muxed) files + crafted edge cases."""

import numpy as np
import pytest

from easyav1.container import WebMDemuxer, TrackType
from easyav1.container.mux import WebMMuxer, MuxTrack
from easyav1.container import webm as W
from easyav1.io.stream import MemoryStream

from fixtures import make_fixture, oracle_decode


@pytest.fixture(scope="module")
def av_fixture():
    return make_fixture(w=160, h=120, fps=30, frames=12, audio_secs=0.5)


def test_tracks_and_metadata(av_fixture):
    d = WebMDemuxer(str(av_fixture))
    video = d.tracks_of_type(TrackType.VIDEO)
    audio = d.tracks_of_type(TrackType.AUDIO)
    assert len(video) == 1 and len(audio) == 1
    assert video[0].codec_id == "V_AV1"
    assert video[0].width == 160 and video[0].height == 120
    assert audio[0].codec_id == "A_VORBIS"
    assert audio[0].sample_rate == 48000.0
    assert audio[0].channels == 2
    assert d.duration_ns > 0
    headers = audio[0].vorbis_headers()
    assert len(headers) == 3
    assert headers[0][:7] == b"\x01vorbis"
    assert headers[1][:7] == b"\x03vorbis"
    assert headers[2][:7] == b"\x05vorbis"


def test_video_packets_match_oracle(av_fixture):
    golden = oracle_decode(av_fixture)
    d = WebMDemuxer(str(av_fixture))
    vtrack = d.tracks_of_type(TrackType.VIDEO)[0].number
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == vtrack:
            pkts.append(p)
    assert len(pkts) == golden.meta["vframes"]
    # libaom with lag-in-frames=0 emits frames in order; oracle pts are ms.
    for pkt, meta in zip(pkts, golden.frames):
        assert pkt.timestamp_ns // 1_000_000 == meta["pts"]
    assert pkts[0].keyframe
    keyflags = [bool(m["key"]) for m in golden.frames]
    assert [p.keyframe for p in pkts] == keyflags


def test_audio_packets_present(av_fixture):
    d = WebMDemuxer(str(av_fixture))
    atrack = d.tracks_of_type(TrackType.AUDIO)[0].number
    n = 0
    last_ts = -1
    while (p := d.read_packet()) is not None:
        if p.track == atrack:
            assert p.timestamp_ns >= last_ts
            last_ts = p.timestamp_ns
            assert len(p.frames) == 1 and len(p.frames[0]) > 0
            n += 1
    assert n > 10


def test_memory_stream_demux(av_fixture):
    data = av_fixture.read_bytes()
    d = WebMDemuxer(MemoryStream(data))
    n = sum(1 for _ in iter(d.read_packet, None))
    d2 = WebMDemuxer(str(av_fixture))
    n2 = sum(1 for _ in iter(d2.read_packet, None))
    assert n == n2 > 0


def test_cues_and_seek(av_fixture):
    d = WebMDemuxer(str(av_fixture))
    assert d.has_cues()
    cues = d.load_cues()
    assert cues[0].time_ns == 0 or cues[0].time_ns < d.duration_ns
    # Seek to the first cue and stream from there.
    cue = d.find_cue(d.duration_ns)
    assert cue is not None
    d.seek_to_cue(cue)
    p = d.read_packet()
    assert p is not None
    # First packet at a cue cluster for the cue track should be a keyframe.
    vtrack = d.tracks_of_type(TrackType.VIDEO)[0].number
    while p is not None and p.track != vtrack:
        p = d.read_packet()
    assert p is not None and p.keyframe


def test_save_restore_state(av_fixture):
    d = WebMDemuxer(str(av_fixture))
    d.save_state()
    p1 = d.read_packet()
    d.restore_state()
    p2 = d.read_packet()
    assert p1.track == p2.track and p1.timestamp_ns == p2.timestamp_ns
    assert p1.frames == p2.frames


# ---------------------------------------------------------------------------
# Crafted containers: lacing modes, BlockGroups, unknown-size clusters.

def _mux_roundtrip(lacing, blockgroup=False, unknown_size=False):
    rng = np.random.default_rng(42)
    m = WebMMuxer()
    m.add_track(MuxTrack(1, TrackType.AUDIO, "A_VORBIS",
                         codec_private=b"\x02\x01\x01abc",
                         sample_rate=48000.0, channels=2))
    expected = []
    for i in range(10):
        if lacing == 2:  # fixed: equal sizes
            frames = [bytes(rng.integers(0, 256, 300, dtype=np.uint8))
                      for _ in range(3)]
        else:
            frames = [bytes(rng.integers(0, 256, int(sz), dtype=np.uint8))
                      for sz in rng.integers(1, 600, 3)]
        m.add_packet(1, i * 20_000_000, frames, keyframe=True,
                     lacing=lacing, blockgroup=blockgroup)
        expected.append((i * 20_000_000, frames))
    data = m.finalize(unknown_size_clusters=unknown_size)
    d = WebMDemuxer(MemoryStream(data))
    got = []
    while (p := d.read_packet()) is not None:
        got.append((p.timestamp_ns, p.frames))
    assert got == expected


@pytest.mark.parametrize("lacing", [0, 1, 2, 3],
                         ids=["xiph-auto", "xiph", "fixed", "ebml"])
def test_lacing_roundtrip(lacing):
    _mux_roundtrip(lacing)


def test_blockgroup_roundtrip():
    _mux_roundtrip(1, blockgroup=True)


def test_unknown_size_cluster():
    _mux_roundtrip(1, unknown_size=True)


def test_large_xiph_lace_sizes():
    """Sizes >= 255 need multi-byte Xiph lacing."""
    m = WebMMuxer()
    m.add_track(MuxTrack(1, TrackType.AUDIO, "A_VORBIS",
                         sample_rate=48000.0, channels=1))
    frames = [b"a" * 255, b"b" * 510, b"c" * 7]
    m.add_packet(1, 0, frames, lacing=1)
    d = WebMDemuxer(MemoryStream(m.finalize()))
    p = d.read_packet()
    assert p.frames == frames


def test_mux_with_cues_seekable():
    m = WebMMuxer()
    m.add_track(MuxTrack(1, TrackType.VIDEO, "V_AV1", width=64, height=64))
    for i in range(100):
        m.add_packet(1, i * 33_000_000, [b"frame%03d" % i],
                     keyframe=(i % 10 == 0))
    data = m.finalize(cluster_interval_ticks=200)
    d = WebMDemuxer(MemoryStream(data))
    assert d.has_cues()
    cue = d.find_cue(2_000_000_000)
    assert cue is not None
    d.seek_to_cue(cue)
    # Matroska cues point at the *cluster*; scan to the cue's timestamp
    # (this is what the API-layer seek state machine does).
    p = d.read_packet()
    assert p is not None and p.timestamp_ns <= cue.time_ns
    while p is not None and p.timestamp_ns < cue.time_ns:
        p = d.read_packet()
    assert p is not None and p.keyframe and p.timestamp_ns == cue.time_ns
