"""Batched AV1 inverse transforms on device (JAX, int32, bit-exact).

One jitted kernel per (tx_size, tx_type, bitdepth): takes a batch of
dequantized coefficient blocks [N, adj_h, adj_w] and returns residual
blocks [N, h, w].  The 1-D butterfly kernels are shared with the numpy
reference (itx_ref) — they are namespace-agnostic integer scalar ops
over row slices, so the same verified code traces under jit.  int32 is
sufficient on device: inputs are clamped to ±2^(bd+7) and intermediates
to the normative ±2^(bd+7) range, so products with the 12-bit cos table
stay below 2^30.

Batch sizes are bucketed to powers of two (zero blocks transform to
zero residuals, so padding is free) to bound recompilation.

Parity: easyav1 inherits dav1d's itx_*bpc asm; this is the device
equivalent feeding the device recon path.
"""

from __future__ import annotations

import functools

import numpy as np

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.itx_ref import transform_1d
from easyav1.video.av1.recon_ref import _ROW_SHIFT, _TX_1D


@functools.lru_cache(maxsize=None)
def _make_kernel(tx_size: int, tx_type: int, bitdepth: int):
    import jax
    import jax.numpy as jnp

    w = T.TX_WIDTH[tx_size]
    h = T.TX_HEIGHT[tx_size]
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    adj_w = T.TX_WIDTH[adj]
    adj_h = T.TX_HEIGHT[adj]
    mn = -(1 << (bitdepth + 7))
    mx = (1 << (bitdepth + 7)) - 1
    vkind, hkind = _TX_1D[tx_type]
    rect = abs(w.bit_length() - h.bit_length()) == 1
    shift = _ROW_SHIFT[tx_size]

    def kernel(coeffs):  # [N, adj_h, adj_w] int32 -> [N, h, w] int32
        buf = jnp.zeros(coeffs.shape[:1] + (h, w), jnp.int32)
        buf = buf.at[:, :adj_h, :adj_w].set(coeffs.astype(jnp.int32))
        if rect:
            buf = (buf * 2896 + 2048) >> 12
        # row pass: transform along width; kernels want axis0 = points
        rows = transform_1d(hkind, jnp.transpose(buf, (2, 0, 1)),
                            mn, mx, xp=jnp)              # (w, N, h)
        rows = (rows + ((1 << shift) >> 1)) >> shift
        rows = jnp.clip(rows, mn, mx)
        # col pass: transform along height
        cols = transform_1d(vkind, jnp.transpose(rows, (2, 1, 0)),
                            mn, mx, xp=jnp)              # (h, N, w)
        out = (cols + 8) >> 4
        return jnp.transpose(out, (1, 0, 2))             # (N, h, w)

    return jax.jit(kernel)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def itx_batch(coeffs: np.ndarray, tx_size: int, tx_type: int,
              bitdepth: int = 8) -> np.ndarray:
    """coeffs: [N, adj_h, adj_w] int32 → residuals [N, h, w] int32.

    Pads the batch to the next power of two (static shape menu) and
    crops the result; all-zero pad blocks cost nothing correctness-wise
    since every transform maps 0 → 0.
    """
    n = coeffs.shape[0]
    if n == 0:
        return np.zeros((0, T.TX_HEIGHT[tx_size], T.TX_WIDTH[tx_size]),
                        np.int32)
    if bitdepth > 10:
        # 12-bit inputs reach ±2^19: products with the 12-bit cos table
        # overflow int32, and jnp.int64 needs global x64 — use the int64
        # numpy reference for this rare tier until a pallas i64 kernel
        from easyav1.video.av1.recon_ref import inverse_transform
        from easyav1.video.av1.tile import TxBlock
        outs = [inverse_transform(
            TxBlock(0, 0, 0, tx_size, tx_type, 0,
                    coeffs[i].astype(np.int64)), bitdepth)
            for i in range(n)]
        return np.stack(outs).astype(np.int32)
    kern = _make_kernel(tx_size, tx_type, bitdepth)
    nb = _bucket(n)
    if nb != n:
        coeffs = np.concatenate(
            [coeffs, np.zeros((nb - n,) + coeffs.shape[1:], coeffs.dtype)])
    out = kern(coeffs)
    return np.asarray(out[:n])
