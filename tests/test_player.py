"""Player tool (tools/easyav1_player.c, terminal sink) driven end to
end over the C ABI: full playback with Y4M dump compared bit-exact to
the dav1d oracle, and interactive stdin controls (seek, pause, loop) —
the integration surface the reference covers with its SDL player
(reference tools/easyav1_player.c)."""

import os
import subprocess
import sysconfig
import time
from pathlib import Path

import numpy as np
import pytest

from fixtures import CACHE, make_fixture, tool

REPO = Path(__file__).resolve().parent.parent


def _build_player():
    out = CACHE / "easyav1_player"
    srcs = [REPO / "tools" / "easyav1_player.c",
            REPO / "easyav1" / "capi" / "easyav1_capi.c"]
    if out.exists() and all(out.stat().st_mtime > s.stat().st_mtime
                            for s in srcs):
        return out
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    cmd = ["gcc", "-O2", "-o", str(out)] + [str(s) for s in srcs] + [
        f"-I{inc}", f"-L{libdir}", f"-lpython{ver}",
        f"-Wl,-rpath,{libdir}", "-lm", "-lpthread", "-ldl", "-lutil"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _fixture():
    fx = make_fixture(frames=20, audio_secs=2.0, w=160, h=120, fps=10,
                      gop=1)
    prefix = CACHE / (fx.stem + "_oracle")
    if not prefix.with_suffix(".yuv").exists():
        r = subprocess.run([str(tool("oracle")), str(fx), str(prefix)],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-300:]
    return fx, prefix


def _parse_y4m(path):
    data = path.read_bytes()
    nl = data.index(b"\n")
    header = data[:nl].decode()
    w = int(header.split(" W")[1].split()[0])
    h = int(header.split(" H")[1].split()[0])
    per = w * h + 2 * (w // 2) * (h // 2)
    frames = []
    pos = nl + 1
    while pos < len(data):
        assert data[pos:pos + 6] == b"FRAME\n", data[pos:pos + 6]
        pos += 6
        frames.append(np.frombuffer(data[pos:pos + per], np.uint8))
        pos += per
    return w, h, frames


def _kv(stdout):
    out = {}
    for line in stdout.splitlines():
        for part in line.split():
            if "=" in part:
                k, v = part.split("=", 1)
                out[k] = v
    return out


def test_player_full_playback_bitexact():
    fx, prefix = _fixture()
    player = _build_player()
    dump = CACHE / "player_dump.y4m"
    r = subprocess.run([str(player), "--dump", str(dump), str(fx)],
                       capture_output=True, text=True, env=_env(),
                       stdin=subprocess.DEVNULL, timeout=300)
    assert r.returncode == 0, r.stderr[-400:]
    kv = _kv(r.stdout)
    assert int(kv["frames"]) == 20
    assert int(kv["audio_cb_frames"]) > 0
    w, h, frames = _parse_y4m(dump)
    assert (w, h, len(frames)) == (160, 120, 20)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = w * h + 2 * (w // 2) * (h // 2)
    for i, fr in enumerate(frames):
        assert (fr == raw[i * per:(i + 1) * per]).all(), f"frame {i}"


def test_player_seek_via_stdin():
    fx, _ = _fixture()
    player = _build_player()
    p = subprocess.Popen([str(player), str(fx)], env=_env(),
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.4)
    p.stdin.write("8")          # seek to 80% of the 2 s stream
    p.stdin.flush()
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0
    kv = _kv(out)
    # seeking forward skips most frames: far fewer than the 20 total
    assert int(kv["frames"]) < 16, kv


def test_player_pause_and_quit():
    fx, _ = _fixture()
    player = _build_player()
    p = subprocess.Popen([str(player), str(fx)], env=_env(),
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.4)
    p.stdin.write(" ")          # pause
    p.stdin.flush()
    time.sleep(0.5)
    p.stdin.write("q")          # quit while paused
    p.stdin.flush()
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0
    kv = _kv(out)
    assert int(kv["frames"]) < 20      # quit before the end


def test_player_help_and_flags():
    player = _build_player()
    r = subprocess.run([str(player), "--help"], capture_output=True,
                       text=True, env=_env(), timeout=60)
    assert r.returncode == 0
    for flag in ("--loop", "--fullscreen", "--keep_aspect_ratio",
                 "--disable_audio", "--disable_video", "--use_fast_seek",
                 "--audio_track", "--video_track", "--audio_offset",
                 "--log-level"):
        assert flag in r.stdout, flag
    r = subprocess.run([str(player), "--bogus"], capture_output=True,
                       text=True, env=_env(), timeout=60)
    assert r.returncode == 1


def test_player_ui_selftest():
    """UI overlay core (tools/player_ui.h): time-bar state machine
    transitions, bitmap-font rasterization and play/pause morph render
    to a deterministic canvas (reference easyav1_player.c:36-49 font,
    :922-1054 time-bar animation, :1056-1120 morph)."""
    player = _build_player()
    r = subprocess.run([str(player), "--ui-selftest"],
                       capture_output=True, text=True, env=_env(),
                       timeout=60)
    assert r.returncode == 0, r.stderr
    out = r.stdout.strip()
    # state machine: hidden -> opening -> open -> closing -> reopen ->
    # held open (exact trace pinned; pos digit = round(pos * 9))
    assert "trace=00 00 10 15 29 29 39 36 33 10 15 29" in out, out
    # canvas hash pins font + morph rasterization
    assert "hash=95730dcb" in out, out
    # run twice: fully deterministic
    r2 = subprocess.run([str(player), "--ui-selftest"],
                        capture_output=True, text=True, env=_env(),
                        timeout=60)
    assert r2.stdout == r.stdout


def test_player_sdl3_sink_compiles():
    """The SDL3 sink (window/texture/time-bar/scrub/file-dialog path)
    must stay compilable — checked against the bundled SDL3 API stub
    (tools/sdl3_stub)."""
    r = subprocess.run(["make", "-C", str(REPO / "tools"),
                        "player-sdl3-check"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
