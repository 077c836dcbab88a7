"""Benchmark entry point.

Prints JSON lines {"metric", "value", "unit", "vs_baseline", ...}; each
line is a complete record and the last one is the superset.

Headline: AV1 1080p inter decode realtime multiple (methodology parity:
tools/easyav1_benchmark.c — realtime multiple = video_length_ms /
total_time_ms, every frame decoded).  Baseline: libdav1d decoding the
SAME file on the same host (via the oracle harness), so vs_baseline is
ours/dav1d apples-to-apples.  Secondary: 1080p intra, 4K, Vorbis and
the 8-stream aggregate, each against its baseline on the same host.

The parent process runs the host phases and never imports JAX.  Every
device phase runs in ONE child process, so one process holds the card;
the phases that decode through the device pipes (intra pipes, device
Vorbis) run only with EASYAV1_BENCH_DEVICE=1.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

# Wall-clock budget: every optional phase checks the remaining budget
# before starting, and the headline JSON line is emitted as soon as the
# native measurements land, so a later stall cannot empty the record.
T_START = time.perf_counter()
BUDGET_S = float(os.environ.get("EASYAV1_BENCH_BUDGET_S", "720"))


def _remaining() -> float:
    return BUDGET_S - (time.perf_counter() - T_START)


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def _vorbis_packets(seconds: float):
    from fixtures import make_fixture
    from easyav1.container import WebMDemuxer, TrackType

    fx = make_fixture(frames=0, audio_secs=seconds, channels=2)
    d = WebMDemuxer(str(fx))
    at = d.tracks_of_type(TrackType.AUDIO)[0]
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    return at.vorbis_headers(), pkts


def bench_vorbis(seconds: float = 30.0) -> dict:
    """Host Vorbis pipeline (C symbols + FFT IMDCT synthesis) against
    libvorbis decoding the same packets on the same host."""
    import struct
    from fixtures import tool
    from easyav1.audio.vorbis import VorbisDecoder

    headers, pkts = _vorbis_packets(seconds)
    with tempfile.TemporaryDirectory() as td:
        inp = Path(td) / "bench_vorbis.pkts"
        outp = Path(td) / "bench_vorbis.pcm"
        with open(inp, "wb") as f:
            allp = headers + pkts
            f.write(struct.pack("<I", len(allp)))
            for p in allp:
                f.write(struct.pack("<I", len(p)))
                f.write(p)
        t0 = time.perf_counter()
        subprocess.run([str(tool("vorbis_oracle")), str(inp), str(outp)],
                       check=True, capture_output=True)
        t_libvorbis = time.perf_counter() - t0

    # best-of-2: host stalls only ever ADD time, so min is the
    # steady-state number
    wall_host = float("inf")
    for _ in range(2):
        dec = VorbisDecoder(headers)
        t0 = time.perf_counter()
        tot = 0
        for pk in pkts:
            tot += dec.decode_packet_host(pk).shape[0]
        wall_host = min(wall_host, time.perf_counter() - t0)
    audio_secs = tot / dec.info.sample_rate
    xrt_host = audio_secs / wall_host
    baseline_xrt = audio_secs / t_libvorbis
    return {
        "metric": "vorbis_decode_xrt",
        "value": round(xrt_host, 2),
        "unit": "x_realtime",
        "vs_baseline": round(xrt_host / baseline_xrt, 3),
        "baseline_xrt_libvorbis": round(baseline_xrt, 2),
        "host_xrt": round(xrt_host, 2),
        "audio_secs": round(audio_secs, 2),
    }


def bench_vorbis_device(seconds: float = 10.0) -> dict:
    """Host symbols + device synthesis, chunked and interleaved: host
    symbol decode feeds the device synth chunk by chunk, so device
    compute and the PCM download overlap host work."""
    from easyav1.audio.vorbis import VorbisDecoder
    from easyav1.audio.vorbis.device import VorbisDeviceSynth

    headers, pkts = _vorbis_packets(seconds)
    dec = VorbisDecoder(headers)
    blocks = [b for b in
              (dec.decode_packet_symbols(pk) for pk in pkts[:8])
              if b is not None]
    synth = VorbisDeviceSynth(dec.info.channels, dec.info.blocksize0,
                              dec.info.blocksize1,
                              tuple(blocks[0].coupling), chunk=512,
                              band_limit=dec.spectral_band_limits())
    synth.process(blocks)  # warm up compile
    synth.reset()
    dec = VorbisDecoder(headers)
    t0 = time.perf_counter()
    synth.begin()
    t_symbols = 0.0
    for pk in pkts:
        ts = time.perf_counter()
        b = dec.decode_packet_symbols(pk)
        t_symbols += time.perf_counter() - ts
        if b is not None:
            synth.feed([b])
    pcm = synth.finish()
    wall = time.perf_counter() - t0
    audio_secs = pcm.shape[0] / dec.info.sample_rate
    return {"vorbis_device_xrt": round(audio_secs / wall, 2),
            "vorbis_symbols_xrt": round(audio_secs / t_symbols, 2)}


def _av1_fixture(w=1920, h=1080, frames=30, fps=30, gop=1, tag="intra",
                 extra=()):
    import subprocess as sp
    from fixtures import CACHE, tool

    # committed copies first: fresh checkouts must not pay minutes of
    # libaom encoding inside the driver's bench budget
    committed = REPO / "tests" / "data" / "bench" / \
        f"bench_av1_{tag}_{w}x{h}_{frames}.webm"
    if committed.exists():
        return committed
    CACHE.mkdir(parents=True, exist_ok=True)
    out = CACHE / f"bench_av1_{tag}_{w}x{h}_{frames}.webm"
    if not out.exists():
        # default-encoded: every libaom tool the encoder picks stays on
        r = sp.run([str(tool("make_fixture")), str(out),
                    f"w={w}", f"h={h}", f"fps={fps}", f"frames={frames}",
                    f"gop={gop}", "crf=30", "audio_secs=0", "content=1",
                    *extra],
                   capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-300:])
    return out


def _touch(frame):
    """Force the decoded pixels into host memory (decode-to-host parity
    with the dav1d baseline; device pipes carry lazy async planes)."""
    if frame is not None:
        for p in frame.data:
            _ = p[0, 0]


def _decode_all(path, pipe, max_frames=None):
    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    if pipe == "native-fp":
        # frame-parallel worker pipeline (dav1d frame-threading
        # analog); only competitive with >= 2 host cores
        os.environ["EASYAV1_PIPE"] = "native"
        os.environ["EASYAV1_FRAME_PARALLEL"] = "1"
    else:
        os.environ["EASYAV1_PIPE"] = pipe
        os.environ.pop("EASYAV1_FRAME_PARALLEL", None)
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    if max_frames is not None:
        pkts = pkts[:max_frames]
    be = AV1Backend(vt)
    # warm-up: device pipes JIT-compile per (tx-size, tx-type, chunk)
    # kernel on first appearance; a few frames cover the working set
    n_warm = 6 if pipe in ("pallas", "device") else 1
    for pk in pkts[:n_warm]:
        for f in be.decode([pk], 0):
            _touch(f)
    t0 = time.perf_counter()
    n = 0
    # bounded decode-ahead window (reference decodes ~10 frames ahead
    # on a thread, easyav1.c:2271-2333): materialization of frame k
    # overlaps decode of frames k+1..k+2, but every frame fully lands
    # in host memory inside the timed region
    pending = deque()
    for pk in pkts:
        for f in be.decode([pk], 0):
            pending.append(f)
            if len(pending) > 2:
                _touch(pending.popleft())
        n += 1
    while pending:
        _touch(pending.popleft())
    wall = time.perf_counter() - t0
    os.environ.pop("EASYAV1_FRAME_PARALLEL", None)
    return n, wall


def bench_av1(frames=30, fps=30) -> dict:
    from fixtures import tool

    # headline: default-encoded 1080p30 INTER stream (the production
    # shape — alt-refs, compound, CDEF, restoration all encoder-chosen)
    inter = _av1_fixture(frames=60, fps=fps, gop=9999, tag="inter")
    # INTERLEAVED best-of-3: the shared VM's speed drifts on a scale of
    # minutes, so timing all dav1d rounds then all of ours would hand
    # whichever side ran in the fast phase a ~20% bias.  Alternating
    # rounds sample the same conditions; stalls only ever ADD time, so
    # min is the steady-state number for both sides.
    t_dav1d_inter = float("inf")
    t_i = float("inf")
    n_i = 0
    for rnd in range(4):
        t0 = time.perf_counter()
        # decode-only ('-'): the baseline must not pay YUV file writes
        subprocess.run([str(tool("oracle")), str(inter), "-"],
                       check=True, capture_output=True)
        t_dav1d_inter = min(t_dav1d_inter, time.perf_counter() - t0)
        n_i, ti_ = _decode_all(inter, "native")
        t_i = min(t_i, ti_)
        if (os.cpu_count() or 1) >= 2:
            # frame-parallel pipeline (frame N recon overlaps frame
            # N+1 entropy on a worker): strictly wins with >=2 cores,
            # competes on equal footing in the same interleaved round
            n2, t2_ = _decode_all(inter, "native-fp")
            if n2 == n_i:
                t_i = min(t_i, t2_)
        if rnd >= 1 and _remaining() < 0.6 * BUDGET_S:
            break
    xrt_i = (n_i / fps) / t_i
    dav1d_xrt_i = (60 / fps) / t_dav1d_inter

    # secondary: all-intra 1080p (keyframe-decode throughput)
    path = _av1_fixture(frames=frames, fps=fps, gop=1, tag="intra")
    t_dav1d = float("inf")
    t_nat = float("inf")
    n_nat = 0
    for rnd in range(4):
        t0 = time.perf_counter()
        subprocess.run([str(tool("oracle")), str(path), "-"],
                       check=True, capture_output=True)
        t_dav1d = min(t_dav1d, time.perf_counter() - t0)
        n_nat, tn_ = _decode_all(path, "native")
        t_nat = min(t_nat, tn_)
        if rnd >= 1 and _remaining() < 0.45 * BUDGET_S:
            break
    intra_xrt = (n_nat / fps) / t_nat
    intra_dav1d_xrt = (n_nat / fps) / t_dav1d
    out = {
        "metric": "av1_1080p30_inter_decode_xrt",
        "value": round(xrt_i, 3),
        "unit": "x_realtime",
        "vs_baseline": round(xrt_i / dav1d_xrt_i, 4),
        "baseline_xrt_dav1d": round(dav1d_xrt_i, 2),
        "fps": round(n_i / t_i, 2),
        "frames": n_i,
        "intra_xrt": round(intra_xrt, 3),
        "intra_vs_dav1d": round(intra_xrt / intra_dav1d_xrt, 4),
        "intra_fps_native": round(n_nat / t_nat, 2),
    }
    return out


def bench_av1_intra_device(frames=30, fps=30) -> dict:
    """The intra device pipes on the 1080p intra fixture: a bounded
    slice (6 warm-up decodes, then the first 12 packets timed, the warm
    packets re-decoded inside the timed region) samples the steady-state
    per-frame rate.  Frames land in host memory inside the timing."""
    path = _av1_fixture(frames=frames, fps=fps, gop=1, tag="intra")
    out = {}
    for pipe in ("pallas", "device"):
        n, wall = _decode_all(path, pipe, max_frames=12)
        out[f"intra_fps_{pipe}"] = round(n / wall, 2)
    return out


def bench_device_resident(frames=16) -> dict:
    """Device-resident decode: frames + refs stay in device memory, only
    per-frame uint32 hashes come back to the host; display is
    pull-on-demand.  Budget-gated by the caller (it pays the one-time
    XLA compiles)."""
    path = _av1_fixture(frames=30, fps=30, gop=1, tag="intra")
    from easyav1.video.av1.recon.resident import decode_resident

    n, wall, hashes, _ = decode_resident(path, max_frames=frames)
    return {"device_resident_fps": round(n / wall, 2),
            "device_resident_frames": n}


def bench_multistream(n_streams=8, chunk=10) -> dict:
    """BASELINE config-5: N concurrent 1080p30 INTER streams (the
    ladder shape) decoded throughput-mode on the host cores through
    the C path — chunked round-robin over N independent decoder
    instances, the scheduling a throughput server uses (dav1d's
    task-pool analog, reference cmake/dav1d.cmake thread_task.c).  The
    device variant is bench_multistream_device.  Reports per-stream fps
    alongside the aggregate."""
    import time as _t

    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    path = _av1_fixture(frames=60, fps=30, gop=9999, tag="inter")
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    frames = len(pkts)

    def run_once():
        decs = [AV1Backend(vt) for _ in range(n_streams)]
        heads = [0] * n_streams
        n_out = 0
        t0 = _t.perf_counter()
        while any(h < frames for h in heads):
            for si, be in enumerate(decs):
                end = min(heads[si] + chunk, frames)
                for k in range(heads[si], end):
                    for f in be.decode([pkts[k]], 0):
                        _touch(f)
                        n_out += 1
                heads[si] = end
        return n_out, _t.perf_counter() - t0

    n1, w1 = run_once()
    n2, w2 = run_once()          # best-of-2 against VM-speed drift
    n_out, wall = (n1, w1) if n1 / w1 >= n2 / w2 else (n2, w2)
    agg = n_out / wall
    return {"multistream_aggregate_fps": round(agg, 2),
            "multistream_per_stream_fps": round(agg / n_streams, 2),
            "multistream_streams": n_streams,
            "multistream_fixture": "1080p30-inter-gop9999",
            "multistream_frames_total": n_out}


def bench_multistream_device(n_streams=8, frames=3) -> dict:
    """Config-5 on the device: N 1080p inter streams decoded through
    the device-resident pipe (C entropy + device MC/residual/LF/CDEF,
    refs in device memory, hash-only returns), round-robin interleaved
    so each stream's host entropy overlaps the others' device work.
    All streams share one kernel-signature set (same geometry), so the
    one-time compile cost is paid once by the warm-up pass."""
    import os

    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend
    from easyav1.video.av1.recon.resident import frame_hash_device

    path = _av1_fixture(frames=60, fps=30, gop=9999, tag="inter")
    prev = {k: os.environ.get(k) for k in
            ("EASYAV1_PIPE", "EASYAV1_RESIDENT")}
    os.environ["EASYAV1_PIPE"] = "pallas"
    os.environ["EASYAV1_RESIDENT"] = "1"
    try:
        dmx = WebMDemuxer(str(path))
        vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
        pkts = []
        while (p := dmx.read_packet()) is not None:
            if p.track == vt.number:
                pkts.extend(p.frames)
        pkts = pkts[:frames]
        # warm-up: full pass (every kernel signature compiles)
        warm = AV1Backend(vt)
        for pk in pkts:
            for f in warm.decode([pk], 0):
                pl = getattr(f.data, "device_planes", None)
                if pl is not None:
                    frame_hash_device(pl)
        decs = [AV1Backend(vt) for _ in range(n_streams)]
        hashes = []
        t0 = time.perf_counter()
        for k, pk in enumerate(pkts):
            for be in decs:
                for f in be.decode([pk], 0):
                    pl = getattr(f.data, "device_planes", None)
                    if pl is not None:
                        hashes.append(frame_hash_device(pl))
        n_dev = len(hashes)
        hashes = [int(h.block_until_ready()) for h in hashes]
        wall = time.perf_counter() - t0
        n_out = n_streams * len(pkts)
        return {
            "multistream_device_fps": round(n_out / wall, 2),
            "multistream_device_streams": n_streams,
            "multistream_device_frames": n_out,
            "multistream_device_on_device": n_dev,
        }
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_device() -> dict:
    """Every device phase, in this one process (the only one that opens
    the card): the opt-in device-pipe phases (EASYAV1_BENCH_DEVICE=1),
    the per-stage postfilter breakdown, resident decode and, budget
    permitting, multistream-device.  Emits a line after each phase."""
    from easyav1.utils import compile_cache

    compile_cache.enable()
    out = {}
    if os.environ.get("EASYAV1_BENCH_DEVICE"):
        for fn in (bench_vorbis_device, bench_av1_intra_device):
            try:
                out.update(fn())
            except Exception as e:  # noqa: BLE001
                out[f"{fn.__name__}_error"] = str(e)[:120]
            _emit(dict(out))
    # per-stage device-time breakdown first (cheapest: ~1 min incl
    # compiles) so a tight budget still records the utilization fields
    try:
        sys.path.insert(0, str(REPO / "tools"))
        from profile_device import profile_postfilter

        st = profile_postfilter(1920, 1080, n_batch=4, reps=2)
        for k2 in ("lf_ms", "cdef_dirs_ms", "cdef_filter_ms",
                   "postfilter_ms", "hash_ms", "h2d_resid_ms"):
            out[f"device_stage_{k2}"] = round(st[k2], 3)
        mb = (1088 * 1920 + 2 * 544 * 960) * 4 * 4 / 1e6
        out["device_postfilter_gbps"] = round(
            mb / max(st["postfilter_ms"], 1e-6), 1)
    except Exception as e:  # noqa: BLE001
        out["device_stage_error"] = str(e)[:120]
    _emit(dict(out))
    # the parent's subprocess timeout salvages partial output on
    # overrun either way
    if _remaining() > 240:
        try:
            out.update(bench_device_resident())
        except Exception as e:  # noqa: BLE001
            out["device_resident_error"] = str(e)[:120]
    else:
        out["device_resident_skipped"] = "budget"
    _emit(dict(out))
    # config-5 on the device pipe: keep the sample tiny
    if _remaining() > 300:
        try:
            out.update(bench_multistream_device())
        except Exception as e:  # noqa: BLE001
            out["multistream_device_error"] = str(e)[:120]
    else:
        out["multistream_device_skipped"] = "budget"
    return out


def bench_av1_4k() -> dict:
    """BASELINE config-4 shape (4K): decode throughput vs dav1d on the
    same host.  Encoded at cpu-used=8 so fixture creation stays cheap;
    the decode side is unaffected by encoder speed settings."""
    from fixtures import tool

    fx = _av1_fixture(w=3840, h=2160, frames=24, fps=30, gop=9999,
                      tag="4k", extra=("vopt:cpu-used=8",))
    # interleaved best-of-3 (see bench_av1): both sides sample the
    # same VM-speed phases
    t_dav1d = float("inf")
    t = float("inf")
    n = 0
    for rnd in range(3):
        t0 = time.perf_counter()
        subprocess.run([str(tool("oracle")), str(fx), "-"],
                       check=True, capture_output=True)
        t_dav1d = min(t_dav1d, time.perf_counter() - t0)
        n, t2 = _decode_all(fx, "native")
        t = min(t, t2)
        if (os.cpu_count() or 1) >= 2:
            n2, t3 = _decode_all(fx, "native-fp")
            if n2 == n:
                t = min(t, t3)
        if rnd >= 1 and _remaining() < 45:
            break
    xrt = (n / 30) / t
    dav1d_xrt = (n / 30) / t_dav1d
    return {"av1_4k_xrt": round(xrt, 3),
            "av1_4k_vs_dav1d": round(xrt / dav1d_xrt, 4),
            "av1_4k_fps": round(n / t, 2)}


def main():
    # Headline first, emitted IMMEDIATELY: if any later phase stalls
    # past the driver's timeout, the perf record still exists.  A
    # second, richer line is emitted at the end; both are valid
    # complete records (the final one is a superset).
    result = bench_av1()
    _emit(result)
    if _remaining() > 60:
        try:
            v = bench_vorbis(10.0)
            result["vorbis_decode_xrt"] = v["value"]
            result["vorbis_vs_libvorbis"] = v["vs_baseline"]
            _emit(result)
        except Exception:
            pass
    else:
        result["vorbis_skipped"] = "budget"
    if _remaining() > 90:
        try:
            result.update(bench_av1_4k())
        except Exception:
            pass
    else:
        result["av1_4k_skipped"] = "budget"
    _emit(result)
    if _remaining() > 300:
        try:
            result.update(bench_multistream())
        except Exception:
            result["multistream_skipped"] = "error"
    else:
        result["multistream_skipped"] = "budget"
    _emit(result)
    # device phases LAST, in one child process under a hard timeout
    # that cannot overrun the remaining budget; every earlier metric is
    # already emitted either way
    rem = _remaining()
    if rem <= 300:
        result["device_skipped"] = "budget"
        _emit(result)
        return
    code = (f"import sys, json; sys.path.insert(0, {str(REPO)!r}); "
            f"sys.path.insert(0, {str(REPO / 'tests')!r}); "
            f"import bench; print(json.dumps(bench.bench_device()), "
            f"flush=True)")
    env = dict(os.environ)
    # the child re-reads its own budget clock; hand it the actually-
    # remaining slice so its internal phase gating matches the timeout
    env["EASYAV1_BENCH_BUDGET_S"] = str(max(rem - 90, 60))
    try:
        stdout = subprocess.run([sys.executable, "-c", code],
                                capture_output=True, text=True, env=env,
                                timeout=max(rem - 60, 60)).stdout
    except subprocess.TimeoutExpired as e:
        # salvage whatever the child already emitted (it prints after
        # each phase)
        stdout = (e.stdout or b"").decode("utf-8", "replace") \
            if isinstance(e.stdout, bytes) else (e.stdout or "")
        result["device_timeout"] = 1
    for line in stdout.strip().splitlines():
        try:
            result.update(json.loads(line))
        except ValueError:
            pass
    _emit(result)


if __name__ == "__main__":
    main()
