"""API-level VIDEO integration tests: drive the public
`EasyAV1` surface over a real video+audio WebM and hold every decoded
frame against the dav1d oracle — decode_next loop, decode_until,
seek (fast + exact), and a play() wall-clock smoke.  Complements the
player-process tests (tests/test_player.py) and the audio-only API
tests (tests/test_api.py).

Reference parity: easyav1.h decode/seek/play contract
(easyav1.c:2618-2792, 2961-3260, 2805-2893).
"""

import time

import numpy as np
import pytest

from fixtures import make_fixture, oracle_decode

FPS = 10


@pytest.fixture(scope="module")
def av_fixture():
    fx = make_fixture(w=320, h=180, fps=FPS, frames=20, gop=10, crf=35,
                      audio_secs=2, content=1)
    return fx, oracle_decode(fx)


def _frame_matches(fr, golden, name=""):
    g = golden.video_frames()
    k = round(fr.timestamp * FPS / 1000)
    assert 0 <= k < len(g), (name, fr.timestamp)
    want = g[k]
    assert np.array_equal(np.asarray(fr.data[0]), want["y"]), \
        f"{name}: frame ts={fr.timestamp} luma"
    assert np.array_equal(np.asarray(fr.data[1]), want["u"]), \
        f"{name}: frame ts={fr.timestamp} U"
    return k


def test_api_decode_next_video_vs_oracle(av_fixture):
    from easyav1.api import EasyAV1

    fx, golden = av_fixture
    av = EasyAV1(str(fx))
    assert av.has_video_track() and av.has_audio_track()
    seen = []
    guard = 0
    while not av.is_finished() and guard < 200:
        guard += 1
        av.decode_next()
        if av.has_video_frame():
            fr = av.get_video_frame()
            seen.append(_frame_matches(fr, golden, "decode_next"))
    assert seen == list(range(20)), seen
    av.close()


def test_api_decode_until_vs_oracle(av_fixture):
    from easyav1.api import EasyAV1

    fx, golden = av_fixture
    av = EasyAV1(str(fx))
    av.decode_until(950)        # first 10 frames (ts 0..900)
    got = []
    while av.has_video_frame():
        fr = av.get_video_frame()
        got.append(_frame_matches(fr, golden, "decode_until"))
    # pull-model: frames whose ts <= position; at least the last
    # queued ones must be available and exact
    assert got, "no frames out of decode_until"
    av.close()


def test_api_seek_exact_and_fast(av_fixture):
    from easyav1.api import EasyAV1
    from easyav1.settings import EasyAV1Settings

    fx, golden = av_fixture
    # exact seek: lands on the requested timestamp
    av = EasyAV1(str(fx))
    av.seek_to_timestamp(1500)
    got = []
    guard = 0
    while not av.is_finished() and guard < 100 and len(got) < 5:
        guard += 1
        av.decode_next()
        if av.has_video_frame():
            got.append(_frame_matches(av.get_video_frame(), golden,
                                      "seek-exact"))
    assert got and got[0] == 15, got
    assert got == list(range(got[0], got[0] + len(got)))
    av.close()

    # fast seek: lands at the preceding keyframe (gop=10 -> frame 10)
    st = EasyAV1Settings()
    st.use_fast_seeking = True
    av = EasyAV1(str(fx), st)
    av.seek_to_timestamp(1500)
    got = []
    guard = 0
    while not av.is_finished() and guard < 100 and len(got) < 3:
        guard += 1
        av.decode_next()
        if av.has_video_frame():
            got.append(_frame_matches(av.get_video_frame(), golden,
                                      "seek-fast"))
    assert got and got[0] <= 15, got
    av.close()


def test_api_play_smoke(av_fixture):
    """play() drives a background wall-clock-paced thread; frames must
    come out in order and bit-exact while it runs."""
    from easyav1.api import EasyAV1

    fx, golden = av_fixture
    av = EasyAV1(str(fx))
    av.play()
    seen = []
    t0 = time.time()
    while time.time() - t0 < 3.0 and not av.is_finished():
        if av.has_video_frame():
            fr = av.get_video_frame()
            if fr is not None:
                seen.append(_frame_matches(fr, golden, "play"))
        time.sleep(0.01)
    av.stop()
    av.close()
    assert len(seen) >= 5, seen
    assert seen == sorted(seen), seen
