"""C ABI shim (capi/easyav1.h) end-to-end: compile the smoke tool
against the shim, run it on a real A/V fixture, assert the full surface
behaves (metadata, decode, callbacks, pull path, seek, memory init)."""

import os
import subprocess
import sysconfig
from pathlib import Path

import pytest

from fixtures import CACHE, make_fixture

REPO = Path(__file__).resolve().parent.parent


def _build_smoke():
    out = CACHE / "capi_smoke"
    srcs = [REPO / "tools" / "capi_smoke.c",
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


def test_capi_smoke():
    fx = make_fixture(frames=8, audio_secs=1.0, w=96, h=96, fps=10, gop=1)
    tool = _build_smoke()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([str(tool), str(fx)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    kv = {}
    for line in r.stdout.splitlines():
        for part in line.split():
            if "=" in part:
                k, v = part.split("=", 1)
                kv[k] = v
    assert kv["has_video"] == "1"
    assert kv["has_audio"] == "1"
    assert kv["width"] == "96"
    assert kv["height"] == "96"
    assert kv["fps"] == "10"
    assert int(kv["duration"]) > 0
    assert kv["sample_rate"] == "48000"
    assert kv["channels"] == "2"
    assert kv["decode_status"] == "2"          # FINISHED
    assert int(kv["video_cb_frames"]) == 8
    assert int(kv["audio_cb_frames"]) > 0
    assert int(kv["luma_sum"]) > 0
    assert int(kv["frames_processed"]) == 8
    assert kv["seek_status"] == "1"
    assert kv["pull_frame"] == "1"
    assert kv["pull_w"] == "96"
    assert kv["layout"] == "2"                 # YUV420
    assert kv["mem_init"] == "1"
    assert kv["mem_width"] == "96"
    assert kv["destroyed"] == "1"
