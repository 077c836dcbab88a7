"""chip_smoke.py and the compile-cache helper it shares with the library.

On the CPU: the smoke script must refuse to report success without a
GPU, the committed dav1d MD5s must describe what the host-C decoder
produces under chip_smoke's frame hash, and the cache directory must
follow JAX_COMPILATION_CACHE_DIR.  The `gpu` test runs a short device
decode and skips without a card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from easyav1.utils import compile_cache  # noqa: E402


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"


@pytest.mark.parametrize("env_dir", [None, "elsewhere/cache"])
def test_cache_dir_resolution(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert compile_cache.cache_dir() == want


@pytest.mark.parametrize("name", [f for f, _ in chip_smoke.VIDEO_PHASES])
def test_dav1d_md5_matches_host_c(monkeypatch, name):
    monkeypatch.setenv("EASYAV1_PIPE", "native")
    oracle = json.loads((chip_smoke.BENCH / "dav1d_md5.json").read_text())
    got, _ = chip_smoke.decode_md5s(chip_smoke.BENCH / name, 2, "native",
                                    False)
    assert got == oracle[name]["frames"][:2]


@pytest.mark.gpu
def test_device_pipe_on_gpu(monkeypatch):
    from easyav1 import native

    monkeypatch.setenv("EASYAV1_PIPE", "native")
    name = chip_smoke.INTER
    oracle = json.loads((chip_smoke.BENCH / "dav1d_md5.json").read_text())
    before = native._PIPE_STATS["fallbacks"]
    got, _ = chip_smoke.decode_md5s(chip_smoke.BENCH / name, 3, "pallas",
                                    True)
    assert got == oracle[name]["frames"][:3]
    assert native._PIPE_STATS["fallbacks"] == before
