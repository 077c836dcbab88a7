"""Smoke run of the device decode pipe on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-gpus   # four cards: the multi-stream phase

The default run decodes the committed bench fixtures through the public
`EasyAV1` API with the device pipe on (`EASYAV1_PIPE=pallas`), once with
frames returned to the host and once with frames and references kept on
the device (`EASYAV1_RESIDENT=1`).  Every frame is compared bit-exact
with two references: the host-C decode of the same file in this process,
and the committed per-frame libdav1d MD5s (tests/data/bench/
dav1d_md5.json).  No frame may fall back to the C recon.  A last phase
runs the Vorbis device synthesis on a committed stereo fixture against
the host pipeline.

`--four-gpus` runs only the multi-stream path: copies of a 1080p
fixture decoded on the host, their LF+CDEF postfilter batched in one
jitted step whose stream axis is sharded over a four-card `dp` mesh, and
every frame checked bit-exact against the single-stream decode.

Each phase prints one JSON line with its counts and wall seconds beside
the card's name and power limit.  The last line is
`{"ok": true, "device": {...}}` only when every phase passed; without a
GPU, or when any phase fails, the script prints `"ok": false` and exits
non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
BENCH = REPO / "tests" / "data" / "bench"
INTER = "bench_av1_inter_1920x1080_60.webm"
INTRA = "bench_av1_intra_1920x1080_30.webm"
UHD = "bench_av1_4k_3840x2160_24.webm"
VORBIS = "bench_vorbis_stereo_10s.webm"
# (fixture, frames compared): every inter frame, the first keyframes of
# the all-intra and 4K streams
VIDEO_PHASES = ((INTER, 60), (INTRA, 4), (UHD, 4))
VORBIS_TOL = 5e-6           # libvorbis float32 rounding (tests/test_vorbis.py)
MULTISTREAM_COPIES = 8
MULTISTREAM_FRAMES = 8


def card_info() -> str:
    """`name, power.limit` of every card, read by nvidia-smi in a child
    process that stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = r.stdout.strip().splitlines()
    return " | ".join(lines) if lines else "nvidia-smi printed nothing"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def frame_md5(planes) -> str:
    """MD5 of the visible Y, U, V planes in order (the layout of the
    oracle's I420 output)."""
    import numpy as np

    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p)).tobytes())
    return h.hexdigest()


def decode_md5s(path: Path, n_frames: int, pipe: str, resident: bool):
    """Decode the first n_frames displayed frames of `path` through the
    public API with the given pipe.  Returns (md5s, wall seconds)."""
    from easyav1.api import EasyAV1

    os.environ["EASYAV1_PIPE"] = pipe
    if resident:
        os.environ["EASYAV1_RESIDENT"] = "1"
    else:
        os.environ.pop("EASYAV1_RESIDENT", None)
    md5s = []
    t0 = time.perf_counter()
    av = EasyAV1(str(path))
    try:
        while len(md5s) < n_frames and not av.is_finished():
            av.decode_next()
            while len(md5s) < n_frames and av.has_video_frame():
                md5s.append(frame_md5(av.get_video_frame().data))
    finally:
        av.close()
        os.environ["EASYAV1_PIPE"] = "native"
        os.environ.pop("EASYAV1_RESIDENT", None)
    return md5s, time.perf_counter() - t0


class IntraTimer:
    """Synced wall time of every intra-frame recon (DeviceRecon.run) in
    a phase.  Syncing after each call serialises that frame's device
    work with the host, which a smoke run can afford."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        import jax

        from easyav1.video.av1.recon.jax_exec import DeviceRecon

        self._cls = DeviceRecon
        self._orig = run = DeviceRecon.run
        ms = self.ms

        def timed(rec, *a, **k):
            t0 = time.perf_counter()
            outs = run(rec, *a, **k)
            jax.block_until_ready(outs)
            ms.append((time.perf_counter() - t0) * 1e3)
            return outs

        DeviceRecon.run = timed
        return self

    def __exit__(self, *exc):
        self._cls.run = self._orig


def video_phases(card: str) -> bool:
    from easyav1 import native

    oracle = json.loads((BENCH / "dav1d_md5.json").read_text())
    ok = True
    host = {}
    for name, n in VIDEO_PHASES:
        host[name], wall = decode_md5s(BENCH / name, n, "native", False)
        emit({"phase": f"host-c {name}", "frames": len(host[name]),
              "wall_s": wall, "card": card})
    for resident in (False, True):
        for name, n in VIDEO_PHASES:
            dav1d = oracle[name]["frames"][:n]
            stats0 = dict(native._PIPE_STATS)
            with IntraTimer() as it:
                got, wall = decode_md5s(BENCH / name, n, "pallas",
                                        resident)
            fallbacks = native._PIPE_STATS["fallbacks"] - stats0["fallbacks"]
            m_host = sum(a == b for a, b in zip(got, host[name]))
            m_dav1d = sum(a == b for a, b in zip(got, dav1d))
            passed = (len(got) == n and m_host == n and m_dav1d == n
                      and fallbacks == 0)
            ok &= passed
            emit({"phase": f"device {name}", "resident": resident,
                  "frames": len(got), "match_host_c": m_host,
                  "match_dav1d": m_dav1d, "fallbacks": fallbacks,
                  "wall_s": wall,
                  "intra_recon_ms": [round(v, 3) for v in it.ms],
                  "ok": passed, "card": card})
    return ok


def vorbis_phase(card: str) -> bool:
    import numpy as np

    from easyav1.audio.vorbis import VorbisDecoder
    from easyav1.audio.vorbis.device import VorbisDeviceSynth
    from easyav1.container import TrackType, WebMDemuxer

    dmx = WebMDemuxer(str(BENCH / VORBIS))
    at = dmx.tracks_of_type(TrackType.AUDIO)[0]
    headers = at.vorbis_headers()
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    dec = VorbisDecoder(headers)
    host = np.concatenate([dec.decode_packet_host(pk) for pk in pkts])
    dec = VorbisDecoder(headers)
    blocks = [b for b in map(dec.decode_packet_symbols, pkts)
              if b is not None]
    t0 = time.perf_counter()
    synth = VorbisDeviceSynth(dec.info.channels, dec.info.blocksize0,
                              dec.info.blocksize1,
                              tuple(blocks[0].coupling), chunk=64,
                              band_limit=dec.spectral_band_limits())
    dev = synth.process(blocks)
    wall = time.perf_counter() - t0
    err = float(np.abs(dev - host).max()) if dev.shape == host.shape \
        else float("inf")
    passed = err < VORBIS_TOL
    emit({"phase": f"vorbis-device {VORBIS}",
          "samples": int(host.shape[0]), "channels": int(host.shape[1]),
          "max_abs_err": err, "tol": VORBIS_TOL,
          "matmul_precision": "HIGHEST", "wall_s": wall,
          "ok": passed, "card": card})
    return passed


def multistream_phase(card: str) -> bool:
    import jax

    from easyav1.parallel.mesh import make_mesh
    from easyav1.parallel.multistream_av1 import run_multistream_real

    # the runner batches intra frames only, so the all-intra 1080p
    # fixture supplies the streams
    mesh = make_mesh(len(jax.devices()), tp=1)
    paths = [BENCH / INTRA] * MULTISTREAM_COPIES
    t0 = time.perf_counter()
    ns, total, wall = run_multistream_real(
        mesh, paths, max_frames=MULTISTREAM_FRAMES, check=True)
    emit({"phase": f"multistream {INTRA}", "streams": ns,
          "frames": total, "mesh": dict(mesh.shape),
          "postfilter_wall_s": wall,
          "wall_s": time.perf_counter() - t0, "ok": True, "card": card})
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card multi-stream phase")
    args = ap.parse_args(argv)
    need = 4 if args.four_gpus else 1

    card = card_info()
    print(f"card: {card}", flush=True)
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    print(f"jax: {json.dumps(device)}", flush=True)
    if device["platform"] != "gpu" or device["count"] < need:
        print(f"needs {need} GPU(s); JAX found {device}", flush=True)
        emit({"ok": False, "device": device})
        return 2

    sys.path.insert(0, str(REPO))
    from easyav1.utils import compile_cache

    print(f"compile cache: {compile_cache.enable()}", flush=True)
    phases = ((multistream_phase,) if args.four_gpus
              else (video_phases, vorbis_phase))
    ok = True
    for phase in phases:
        try:
            ok &= phase(card)
        except Exception:  # noqa: BLE001 - report, then fail the run
            traceback.print_exc()
            emit({"phase": phase.__name__, "ok": False, "card": card})
            ok = False
    emit({"ok": ok, "device": device})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
