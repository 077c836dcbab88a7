"""Per-kernel device-time breakdown of the GPU compute path.

Times each device stage of the resident/multistream pipelines in
isolation at a given geometry (default 1080p 8-bit 420), synced, after
a warm-up dispatch: loop filter, CDEF direction search, CDEF filter
(all planes), the fused LF+CDEF step, the frame hash, and the H2D
residual-plane upload.  Batched variants (xN round-robin dispatches in
flight) measure the amortized per-frame cost the multistream device
step would pay.

This is the device half of the observability the reference lacks
(SURVEY §5.1); the host half is tools/profile_stages.py.

Usage: python tools/profile_device.py [--n 8] [--w 1920] [--h 1080]
Prints one JSON dict (also importable: profile_postfilter()) naming the
device it ran on.  Needs a GPU: without one it raises rather than time
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _t(fn, reps=3):
    """median-of-reps synced seconds for fn() -> leaves."""
    import jax

    outs = fn()
    jax.tree_util.tree_map(lambda a: a.block_until_ready(), outs)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = fn()
        jax.tree_util.tree_map(lambda a: a.block_until_ready(), outs)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def profile_postfilter(w=1920, h=1080, bd=8, n_batch=8, reps=3):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from easyav1.video.av1.recon.cdef_jax import (
        CDEF_VERY_LARGE, _dirs_body, _filter_body)
    from easyav1.video.av1.recon.postfilter_fused import (
        _cdef_stage, _lf_stage)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX found {dev.platform}")
    rng = np.random.default_rng(7)
    ah = (h + 7) & ~7
    aw = (w + 7) & ~7
    dims = ((ah, aw), (ah // 2, aw // 2), (ah // 2, aw // 2))
    mi_rows, mi_cols = ah // 4, aw // 4
    uh, uw = (mi_rows + 1) // 2, (mi_cols + 1) // 2

    planes = [jnp.asarray(rng.integers(0, 256, d, np.int32))
              for d in dims]
    # dense LF maps: every edge active at size 8, mid-level limits
    sizes_v, sizes_h, lims_v, lims_h = [], [], [], []
    for p, (ph, pw) in enumerate(dims):
        nev, neh = pw // 4 - 1, ph // 4 - 1
        sizes_v.append(jnp.full(((ph + 3) // 4, nev), 8, jnp.int32))
        sizes_h.append(jnp.full(((pw + 3) // 4, neh), 8, jnp.int32))
        lims_v.append(jnp.full((3, (ph + 3) // 4, nev), 8, jnp.int32))
        lims_h.append(jnp.full((3, (pw + 3) // 4, neh), 8, jnp.int32))
    pri = jnp.full((uh, uw), 4, jnp.int32)
    sec = jnp.full((uh, uw), 2, jnp.int32)
    filt = jnp.ones((uh, uw), jnp.int32)

    res = {}
    lf = _lf_stage(dims, bd)
    res["lf_ms"] = _t(lambda: lf(planes, sizes_v, sizes_h,
                                 lims_v, lims_h), reps) * 1e3

    dirs_fn = jax.jit(_dirs_body(uh, uw, bd - 8))
    lpad = jnp.full((uh * 8 + 4, uw * 8 + 4), CDEF_VERY_LARGE,
                    jnp.int32)
    lpad = lpad.at[2:2 + dims[0][0], 2:2 + dims[0][1]].set(planes[0])
    res["cdef_dirs_ms"] = _t(lambda: dirs_fn(lpad), reps) * 1e3

    dv = jnp.zeros((uh, uw), jnp.int32)
    filt_fns = [jax.jit(_filter_body(dims[p][0], dims[p][1], 1, 1,
                                     min(p, 1), bd, 3 + bd - 8))
                for p in range(3)]
    d0, v0 = dirs_fn(lpad)

    def cdef_filter():
        return [filt_fns[p](planes[p], d0, v0, pri, sec, filt)
                for p in range(3)]
    res["cdef_filter_ms"] = _t(cdef_filter, reps) * 1e3

    fused = _cdef_stage(dims, bd, 1, 1, 3 + bd - 8, True)
    lf_out = lf(planes, sizes_v, sizes_h, lims_v, lims_h)

    def full():
        x = lf(planes, sizes_v, sizes_h, lims_v, lims_h)
        return fused(x, pri, sec, pri, sec, filt)
    res["postfilter_ms"] = _t(full, reps) * 1e3
    del lf_out, dv

    # batched (round-robin dispatch, one device): amortized per frame
    def full_n():
        outs = []
        for _ in range(n_batch):
            x = lf(planes, sizes_v, sizes_h, lims_v, lims_h)
            outs.append(fused(x, pri, sec, pri, sec, filt))
        return outs
    res[f"postfilter_x{n_batch}_ms_per_frame"] = \
        _t(full_n, reps) * 1e3 / n_batch

    from easyav1.video.av1.recon.resident import _hash_kernel
    hk = _hash_kernel(tuple(tuple(d) for d in dims))
    res["hash_ms"] = _t(lambda: hk(list(planes)), reps) * 1e3

    # H2D: int16 residual planes for one frame
    host = [rng.integers(-512, 512, d, np.int16) for d in dims]

    def upload():
        return [jax.device_put(x) for x in host]
    res["h2d_resid_ms"] = _t(upload, reps) * 1e3
    res["h2d_mb"] = sum(x.nbytes for x in host) / 1e6

    res["platform"] = dev.platform
    res["device_kind"] = dev.device_kind
    res["device_count"] = len(jax.devices())
    res["geometry"] = f"{w}x{h}@{bd}"
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--h", type=int, default=1080)
    args = ap.parse_args()
    from easyav1.utils import compile_cache
    compile_cache.enable()
    res = profile_postfilter(args.w, args.h, n_batch=args.n)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
