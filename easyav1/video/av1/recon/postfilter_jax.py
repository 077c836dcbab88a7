"""Fused AV1 device postfilter step (loop filter + CDEF) and its
multi-stream sharded variant.

This is the flagship jittable step for the AV1 path: one call applies
both deblocking passes and CDEF to a luma plane.  The multi-stream
variant maps it over a batch of independent streams sharded across a
device mesh (BASELINE.md config 5: N concurrent 1080p streams batched
on cards) — decode batching needs no collectives, so the dp axis is
pure data parallelism.
"""

from __future__ import annotations

import functools

import numpy as np

from easyav1.video.av1.recon import cdef_jax, lf_jax


@functools.lru_cache(maxsize=None)
def make_postfilter(H: int, W: int, bd: int = 8, damping: int = 5):
    """Returns (fn, example_args): fn is a jittable luma postfilter
    step — LF vertical pass, LF horizontal pass, CDEF — with all
    parameter maps as inputs."""
    import jax
    import jax.numpy as jnp

    lf_v = lf_jax._make_pass_kernel(H, W, bd)
    lf_h = lf_jax._make_pass_kernel(W, H, bd)
    cdef = cdef_jax._make_kernel(H, W, 0, 0, 0, bd, damping)

    def fn(plane, size_v, size_h, limit, blimit, thresh,
           dir_u, var_u, pri_u, sec_u, filt_u):
        x = lf_v(plane, size_v, limit, blimit, thresh)
        x = lf_h(x.T, size_h, limit, blimit, thresh).T
        return cdef(x, dir_u, var_u, pri_u, sec_u, filt_u)

    rng = np.random.default_rng(0)
    nev = (W + 3) // 4 - 1
    neh = (H + 3) // 4 - 1
    uh, uw = (H + 7) // 8, (W + 7) // 8
    mx = (1 << bd) - 1
    args = (
        rng.integers(0, mx + 1, (H, W)).astype(np.int32),
        rng.choice([0, 4, 8, 14], (H, nev)).astype(np.int32),
        rng.choice([0, 4, 8, 14], (W, neh)).astype(np.int32),
        np.int32(3), np.int32(13), np.int32(0),
        rng.integers(0, 8, (uh, uw)).astype(np.int32),
        rng.integers(0, 1 << 14, (uh, uw)).astype(np.int32),
        rng.integers(0, 16, (uh, uw)).astype(np.int32),
        rng.integers(0, 4, (uh, uw)).astype(np.int32),
        rng.integers(0, 2, (uh, uw)).astype(np.int32),
    )
    return fn, args


class MultiStreamPostfilter:
    """Batch the postfilter over independent streams, sharded over the
    mesh's dp axis (jit + NamedSharding; XLA keeps it collective-free)."""

    def __init__(self, mesh, streams: int, H: int, W: int, bd: int = 8):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.streams = streams
        fn, args = make_postfilter(H, W, bd)
        self._example = args

        batched = jax.vmap(fn, in_axes=(0, 0, 0, None, None, None,
                                        0, 0, 0, 0, 0))
        shard = NamedSharding(mesh, P("dp"))
        repl = NamedSharding(mesh, P())
        in_sh = (shard,) * 3 + (repl,) * 3 + (shard,) * 5
        self.step = jax.jit(batched, in_shardings=in_sh,
                            out_shardings=shard)

    def example_inputs(self):
        n = self.streams
        out = []
        for i, a in enumerate(self._example):
            if i in (3, 4, 5):
                out.append(a)
            else:
                out.append(np.broadcast_to(a, (n,) + a.shape).copy())
        return tuple(out)
