"""Public API tests (audio-only until the AV1 backend lands)."""

import numpy as np
import pytest

import easyav1
from easyav1 import EasyAV1, init_from_filename, init_from_memory
from easyav1.settings import EasyAV1Status, default_settings

from fixtures import make_fixture, vorbis_oracle_decode, have_vorbis_oracle
from easyav1.container import WebMDemuxer, TrackType


@pytest.fixture(scope="module")
def audio_fixture():
    return make_fixture(frames=0, audio_secs=2.0, channels=2)


def test_init_and_metadata(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    assert av.get_status() == EasyAV1Status.OK
    assert av.has_audio_track() and not av.has_video_track()
    assert av.get_audio_channels() == 2
    assert av.get_audio_sample_rate() == 48000
    assert av.get_total_audio_tracks() == 1
    assert 1900 <= av.get_duration() <= 2300
    av.close()


def test_init_from_memory(audio_fixture):
    av = init_from_memory(audio_fixture.read_bytes())
    assert av.has_audio_track()
    av.close()


def test_decode_next_until_finished(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    n = 0
    samples = 0
    while True:
        st = av.decode_next()
        if st == EasyAV1Status.FINISHED:
            break
        assert st == EasyAV1Status.OK
        n += 1
        f = av.get_audio_frame()
        if f is not None:
            samples += f.samples
        assert n < 10000
    assert av.is_finished()
    assert samples > 90000  # ~2s at 48kHz
    assert av.get_current_timestamp() > 1900
    av.close()


@pytest.mark.skipif(not have_vorbis_oracle(), reason="no minivorbis oracle")
def test_api_pcm_matches_oracle(audio_fixture):
    # collect golden
    d = WebMDemuxer(str(audio_fixture))
    at = d.tracks_of_type(TrackType.AUDIO)[0]
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    golden = vorbis_oracle_decode(at.vorbis_headers() + pkts)

    chunks = []

    def on_audio(frame, userdata):
        chunks.append(np.asarray(frame.pcm).reshape(-1, frame.channels))

    s = default_settings()
    s.audio_callback = on_audio
    av = EasyAV1(str(audio_fixture), s)
    while av.decode_next() == EasyAV1Status.OK:
        pass
    mine = np.concatenate(chunks, axis=0)
    assert mine.shape == golden.shape
    assert np.abs(mine - golden).max() < 5e-6


def test_decode_until_position(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    st = av.decode_until(500)
    assert st == EasyAV1Status.OK
    assert 400 <= av.get_current_timestamp() <= 600
    av.close()


def test_decode_for(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    av.decode_for(300)
    assert 200 <= av.get_current_timestamp() <= 400
    av.close()


def test_seek_audio(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    av.decode_until(300)
    st = av.seek_to_timestamp(1500)
    assert st == EasyAV1Status.OK
    assert av.get_current_timestamp() == 1500
    # decoding continues from the seek point
    st = av.decode_next()
    assert st == EasyAV1Status.OK
    f = av.get_audio_frame()
    assert f is None or f.timestamp >= 1400
    av.close()


def test_seek_backward_and_replay_consistent(audio_fixture):
    """Seeking back to 0 must reproduce the same PCM as the first pass."""
    av = init_from_filename(str(audio_fixture))

    def collect_some():
        out = []
        for _ in range(30):
            if av.decode_next() != EasyAV1Status.OK:
                break
            f = av.get_audio_frame()
            if f is not None:
                out.append(np.asarray(f.pcm).reshape(-1, f.channels))
        return np.concatenate(out, axis=0) if out else np.zeros((0, 2))

    first = collect_some()
    av.seek_to_timestamp(0)
    second = collect_some()
    n = min(len(first), len(second))
    assert n > 1000
    assert np.array_equal(first[:n], second[:n])
    av.close()


def test_playback_thread(audio_fixture):
    import time

    av = init_from_filename(str(audio_fixture))
    assert av.play() == EasyAV1Status.OK
    assert av.is_playing()
    time.sleep(0.4)
    av.stop()
    pos = av.get_current_timestamp()
    # wall-clock paced: should have advanced roughly 0.4s, not the whole file
    assert 250 <= pos <= 900, pos
    assert not av.is_playing()
    av.close()


def test_update_settings_disable_audio(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    s = av.get_current_settings()
    s.enable_audio = False
    with pytest.raises(Exception):
        # no decodable tracks left -> UNSUPPORTED error status
        st = av.update_settings(s)
        if st == EasyAV1Status.ERROR:
            raise RuntimeError("error status")
    av.close()


def test_status_sticky_after_destroy(audio_fixture):
    av = init_from_filename(str(audio_fixture))
    av.close()
    av.close()  # idempotent


def test_bad_data_raises():
    with pytest.raises(Exception):
        init_from_memory(b"not a webm file at all........")


def test_decode_until_without_consumer_terminates():
    """Regression: decode_until over more frames than the frame queue
    holds, with no get_video_frame consumer, must terminate — the
    decode-ahead worker drops the oldest ring entry instead of
    stalling (reference enqueue_video_frame, easyav1.c:2139-2148;
    a frame-queue throttle here livelocked _drain_video)."""
    fx = make_fixture(frames=20, w=64, h=64, fps=10, gop=100,
                      audio_secs=0)
    av = init_from_filename(str(fx))
    st = av.decode_until(1800)
    assert st in (EasyAV1Status.OK, EasyAV1Status.FINISHED)
    assert av.get_current_timestamp() >= 1700
    # the ring holds the newest frames; pulling one still works
    assert av.has_video_frame()
    av.close()
