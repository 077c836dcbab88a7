"""Device-resident decode driver (SURVEY §7 bridge).

In resident mode (EASYAV1_RESIDENT=1) the device pipes keep decoded
frames AND reference planes in device memory: the per-frame
device→host plane download disappears from the decode loop.  What
crosses the host link per frame is the host→device plan upload
(coefficients + unit records) and a single uint32 hash back; display
frames materialize only when a consumer actually indexes them (display
pull, easyav1.c:3509-3571 analog).

`decode_resident` is the benchmark/driver entry: it decodes a stream
through the normal backend (so CDF chaining, refs, tmvs all behave)
and returns per-frame device hashes plus a fetch closure.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional

import numpy as np

_FNV = 16777619
_RK = 2654435761
_CK = 40503


@functools.lru_cache(maxsize=None)
def _hash_kernel(shapes):
    """jit: [planes] -> uint32 position-weighted hash (order + value
    sensitive; wraps mod 2^32 identically to the numpy mirror)."""
    import jax
    import jax.numpy as jnp

    def fn(planes):
        h = jnp.uint32(2166136261)
        for p in planes:
            ph, pw = p.shape
            r = jax.lax.broadcasted_iota(jnp.uint32, (ph, pw), 0)
            c = jax.lax.broadcasted_iota(jnp.uint32, (ph, pw), 1)
            wts = jnp.uint32(1) + r * jnp.uint32(_RK) \
                + c * jnp.uint32(_CK)
            h = h * jnp.uint32(_FNV) \
                + jnp.sum(p.astype(jnp.uint32) * wts)
        return h

    return jax.jit(fn)


def frame_hash_device(planes) -> "object":
    """Async device hash of a frame's device planes (list of 2D
    arrays).  Returns a 0-d device array (block/`int()` later)."""
    k = _hash_kernel(tuple(tuple(p.shape) for p in planes))
    return k(list(planes))


def frame_hash_host(planes: List[np.ndarray]) -> int:
    """Same hash on host numpy planes (verification mirror)."""
    h = np.uint32(2166136261)
    with np.errstate(over="ignore"):
        for p in planes:
            ph, pw = p.shape
            r = np.arange(ph, dtype=np.uint32)[:, None]
            c = np.arange(pw, dtype=np.uint32)[None, :]
            wts = np.uint32(1) + r * np.uint32(_RK) + c * np.uint32(_CK)
            h = h * np.uint32(_FNV) \
                + (p.astype(np.uint32) * wts).sum(dtype=np.uint32)
    return int(h)


def decode_resident(path: str, max_frames: Optional[int] = None):
    """Decode `path` with the device pipe in resident mode.

    Returns (n_frames, wall_seconds, hashes, frames): wall covers
    decode+hash with NO plane downloads; `frames` are the lazy frame
    objects (indexing one pulls its planes D2H on demand)."""
    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    prev_pipe = os.environ.get("EASYAV1_PIPE")
    prev_res = os.environ.get("EASYAV1_RESIDENT")
    os.environ["EASYAV1_PIPE"] = "pallas"
    os.environ["EASYAV1_RESIDENT"] = "1"
    try:
        dmx = WebMDemuxer(str(path))
        vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
        pkts = []
        while (p := dmx.read_packet()) is not None:
            if p.track == vt.number:
                pkts.extend(p.frames)
        if max_frames is not None:
            pkts = pkts[:max_frames]
        be = AV1Backend(vt)
        # warm-up: a full pass so every kernel signature (incl. the
        # sticky fused-residual bucket union, which grows as new
        # (size,type) buckets appear) is compiled before timing
        warm = AV1Backend(vt)
        for pk in pkts:
            for f in warm.decode([pk], 0):
                pl = getattr(f.data, "device_planes", None)
                if pl is not None:
                    frame_hash_device(pl)
        t0 = time.perf_counter()
        hashes = []
        frames = []
        for pk in pkts:
            for f in be.decode([pk], 0):
                frames.append(f)
                pl = getattr(f.data, "device_planes", None)
                if pl is not None:
                    hashes.append(frame_hash_device(pl))
                else:           # fallback frame decoded on host
                    hashes.append(frame_hash_host(list(f.data)))
        # block: all device work (and hash D2H) complete
        hashes = [int(h) if isinstance(h, int) else int(h.block_until_ready())
                  for h in hashes]
        wall = time.perf_counter() - t0
        return len(frames), wall, hashes, frames
    finally:
        for k, v in (("EASYAV1_PIPE", prev_pipe),
                     ("EASYAV1_RESIDENT", prev_res)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
