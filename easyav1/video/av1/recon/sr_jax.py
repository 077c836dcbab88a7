"""Device superres horizontal upscale (spec §7.16) as a dense matmul.

The upscale is a per-output-column 8-tap filter over clamped source
columns — a fixed linear map of the row — so the whole plane upscales
as one matrix product `src[rows, aw] @ M[aw, dst_w]` where column c of
M carries that output column's 8 filter taps accumulated at their
clamped source indices.  All values are integers |v| < 2^20, so the
f32 matmul is exact only at Precision.HIGHEST (a full f32 mantissa;
TF32 keeps 10 bits and would not be bit-exact), and the
round/shift/clip epilogue reproduces the reference arithmetic
bit-for-bit.

Parity: superres_ref.upscale_plane / native av1_sr.h (both pinned to
dav1d by tests/test_av1_superres.py); reference role: dav1d's
resize/mc upscale templates (cmake/dav1d.cmake:1001-1015).
"""

from __future__ import annotations

import functools

import numpy as np

RS_SUBPEL_BITS = 14
RS_SUBPEL_MASK = (1 << RS_SUBPEL_BITS) - 1
RS_EXTRA_BITS = 8
RS_EXTRA_OFF = 1 << (RS_EXTRA_BITS - 1)
SR_FILTER_BITS = 7


def _sr_filter() -> np.ndarray:
    from easyav1.video.av1.superres_ref import UPSCALE_FILTER
    return np.asarray(UPSCALE_FILTER, np.int32)


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


@functools.lru_cache(maxsize=None)
def upscale_matrix(src_w: int, dst_w: int, aw: int) -> np.ndarray:
    """[aw, dst_w] f32 tap matrix; column c accumulates SR_FILTER taps
    of output column c at their clamped source columns (clamping to
    the mi-aligned width aw, like the scalar reference)."""
    fil = _sr_filter()
    x_step = _trunc_div((src_w << RS_SUBPEL_BITS) + dst_w // 2, dst_w)
    err = x_step * dst_w - (src_w << RS_SUBPEL_BITS)
    x0 = (_trunc_div(-((dst_w - src_w) << (RS_SUBPEL_BITS - 1))
                     + dst_w // 2, dst_w)
          + RS_EXTRA_OFF - _trunc_div(err, 2)) & RS_SUBPEL_MASK
    M = np.zeros((aw, dst_w), np.float32)
    for c in range(dst_w):
        x_qn = x0 - (1 << RS_SUBPEL_BITS) + c * x_step
        base = (x_qn >> RS_SUBPEL_BITS) - 3
        phase = (x_qn & RS_SUBPEL_MASK) >> RS_EXTRA_BITS
        for k in range(8):
            v = min(max(base + k, 0), aw - 1)
            M[v, c] += fil[phase, k]
    return M


@functools.lru_cache(maxsize=None)
def _upscale_fn(src_w: int, dst_w: int, aw: int, bd: int):
    import jax
    import jax.numpy as jnp

    M = upscale_matrix(src_w, dst_w, aw)
    mx = (1 << bd) - 1

    def fn(plane):
        acc = jnp.dot(plane[:, :aw].astype(jnp.float32),
                      jnp.asarray(M),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        acc = acc.astype(jnp.int32)
        v = (acc + (1 << (SR_FILTER_BITS - 1))) >> SR_FILTER_BITS
        return jnp.clip(v, 0, mx)

    return jax.jit(fn)


def upscale_plane_device(plane, src_w: int, dst_w: int, bd: int):
    """Upscale a device (or numpy) int plane [rows, >=aw] to
    [rows, dst_w] int32 on device, bit-exact vs sr_upscale_plane with
    aw = the plane's stored width."""
    aw = int(plane.shape[1])
    return _upscale_fn(src_w, dst_w, aw, bd)(plane)
