"""Capture an XPlane device trace of the device pipes (SURVEY §5.1).

The host-side complement is tools/profile_stages.py (per-stage rdtsc
breakdown of the native path); this tool covers the device side: it
runs the jitted device workloads under jax.profiler.trace so per-kernel
device timing, HLO names and memory traffic land in a TensorBoard/
XProf-loadable logdir.  The reference has no analog (its only
profiling is the benchmark's wall clock, tools/easyav1_benchmark.c:124);
this is the device-side replacement.

Usage: python tools/device_trace.py [logdir] [av1|vorbis|all]
  logdir defaults to $TMPDIR/easyav1_trace; open with
  `tensorboard --logdir <logdir>` (Profile tab) or xprof.
"""

import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def trace_av1(steps: int = 3):
    """AV1 device postfilter (LF + CDEF) on a 1080p-shaped luma frame —
    the flagship device kernel chain (same workload as entry())."""
    from __graft_entry__ import entry

    fn, args = entry()
    out = fn(*args)                      # compile outside the trace
    _block(out)
    for _ in range(steps):
        out = fn(*args)
    _block(out)


def trace_vorbis(steps: int = 3):
    """Vorbis device synthesis (coupling → envelope → IMDCT → OLA)."""
    import numpy as np
    from easyav1.parallel.mesh import make_mesh, MultiStreamVorbisSynth

    mesh = make_mesh(1, tp=1)
    vs = MultiStreamVorbisSynth(mesh, streams=2, channels=2,
                                n0=256, n1=2048, chunk=2)
    args = vs.example_inputs(np.random.default_rng(0))
    out = vs.step(*args)                 # compile outside the trace
    _block(out)
    for _ in range(steps):
        out = vs.step(*args)
    _block(out)


def _block(x):
    import jax
    jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready")
        else a, x)


def main():
    logdir = sys.argv[1] if len(sys.argv) > 1 else str(
        Path(tempfile.gettempdir()) / "easyav1_trace")
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    import jax

    from easyav1.utils import compile_cache

    # repeat trace runs must not repay the JIT compiles before the
    # traced steps
    compile_cache.enable()

    t_start = time.time()
    with jax.profiler.trace(logdir):
        if which in ("av1", "all"):
            trace_av1()
        if which in ("vorbis", "all"):
            trace_vorbis()
    # only count captures from THIS run: the default logdir is reused,
    # so stale xplane files from a prior run must not report success
    n = sum(1 for p in Path(logdir).rglob("*.xplane.pb")
            if p.stat().st_mtime >= t_start - 1)
    print(f"trace written: {logdir} ({n} new xplane file(s); "
          f"open with tensorboard --logdir {logdir})")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
