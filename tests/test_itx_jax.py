"""Device (JAX) batched inverse transforms vs the numpy reference.

Every (tx_size, legal tx_type) pair, random dequantized coefficients in
the normative ±2^(bd+7) input range: the jitted int32 kernels must match
the int64 numpy oracle bit-for-bit.
"""

import numpy as np
import pytest

from easyav1.video.av1 import constants as C
from easyav1.video.av1 import tables as T
from easyav1.video.av1.recon.itx_jax import itx_batch
from easyav1.video.av1.recon_ref import _TX_1D, inverse_transform
from easyav1.video.av1.tile import TxBlock


def _legal(tx_size, tx_type):
    # 1-D kinds limited by transform size availability: adst tops out at
    # 16 points, identity at 32, dct at 64 (spec tx-set restrictions make
    # larger combos unreachable anyway)
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    w, h = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
    vk, hk = _TX_1D[tx_type]
    lim = {"dct": 64, "adst": 16, "flipadst": 16, "identity": 32}
    return h <= lim[vk] and w <= lim[hk]


CASES = [(ts, tt) for ts in range(C.TX_SIZES_ALL)
         for tt in sorted(_TX_1D) if _legal(ts, tt)]


@pytest.mark.parametrize("tx_size,tx_type", CASES)
def test_itx_bit_exact(tx_size, tx_type):
    rng = np.random.default_rng(tx_size * 100 + tx_type)
    adj = T.ADJUSTED_TX_SIZE[tx_size]
    aw, ah = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
    bd = 8
    lim = 1 << (bd + 7)
    n = 5
    coeffs = rng.integers(-lim, lim, size=(n, ah, aw)).astype(np.int32)
    # include sparse and extreme blocks
    coeffs[1] = 0
    coeffs[1, 0, 0] = lim - 1
    coeffs[2] = np.where(rng.random((ah, aw)) < 0.9, 0, coeffs[2])
    coeffs[3] = lim - 1
    coeffs[4] = -lim

    got = itx_batch(coeffs, tx_size, tx_type, bd)
    for i in range(n):
        txb = TxBlock(plane=0, x=0, y=0, tx_size=tx_size, tx_type=tx_type,
                      eob=ah * aw, coeffs=coeffs[i].astype(np.int64))
        want = inverse_transform(txb, bd)
        assert np.array_equal(got[i], want), (
            f"tx_size={tx_size} tx_type={tx_type} block {i}: "
            f"maxdiff {np.abs(got[i] - want).max()}")


@pytest.mark.parametrize("bd", [10, 12])
def test_itx_highbd(bd):
    rng = np.random.default_rng(bd)
    lim = 1 << (bd + 7)
    coeffs = rng.integers(-lim, lim, size=(3, 16, 16)).astype(np.int32)
    got = itx_batch(coeffs, C.TX_16X16, C.DCT_DCT, bd)
    for i in range(3):
        txb = TxBlock(plane=0, x=0, y=0, tx_size=C.TX_16X16,
                      tx_type=C.DCT_DCT, eob=256,
                      coeffs=coeffs[i].astype(np.int64))
        want = inverse_transform(txb, bd)
        assert np.array_equal(got[i], want)
