"""Coefficient-context clipping at the frame's bottom edge.

Regression for a real-stream conformance bug (ireal_comp_masked_odd):
at odd frame heights the mi grid (MiRows = 2*ceil(h/8)) extends past
the visible area, and a chroma tx of a bottom-row block can overhang
the plane-cell grid (e.g. a 32X16 block at mi row 24 of a 26-row grid
has a 16x8 chroma tx spanning cells 12-13 of a 13-cell grid).  The
entropy-context writes for such a tx must be clipped to the plane grid
(libaom av1_set_entropy_contexts); an unclipped write lands in a
valid-but-wrong slot of the luma-sized ctx array and poisons the
txb-skip/dc-sign context of a later block in the same row, decoding
different coefficient levels than the reference.  The damage is
sub-visible recon rows, which the loop filter then folds back into the
last visible row.

easyav1 decodes through libdav1d (reference easyav1.c:decode_video),
so conformance is checked against the dav1d oracle with loop filtering
enabled to surface the feedback path.
"""

import subprocess

import numpy as np

from fixtures import CACHE, tool
from easyav1.container import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_inter_sequence)
from easyav1.video.av1.backend import AV1Backend

W, H = 94, 98      # mi grid 24x26; visible 4px rows = 25 -> row 25 is
#                    wholly sub-visible, chroma cell 13 is off-grid


def _key_blocks():
    rng = np.random.default_rng(0)
    out = []
    for r in range(0, 25, 4):
        bs = C.BLOCK_16X16 if r + 4 <= 25 else C.BLOCK_8X8
        step = 4 if bs == C.BLOCK_16X16 else 2
        for c in range(0, 24, step):
            lc = [[(int(rng.integers(1, 12)), int(rng.integers(0, 2)))
                   for _ in range(8)]]
            out.append(EncBlock(r=r, c=c, bsize=bs, skip=False,
                                luma_coeffs=lc))
    return out


def _bottom_row():
    """Bottom mi row: a coeff-bearing 32X16 whose chroma tx overhangs
    the plane grid, then skip blocks, then another 32X16 whose chroma
    ctx would read the stale overhang cell."""
    out = [InterEncBlock(r=r, c=c, bsize=C.BLOCK_8X8, is_inter=True,
                         ref=C.LAST_FRAME, mode=C.NEARESTMV, mv=(0, 0),
                         skip=True)
           for r in range(0, 24, 2) for c in range(0, 24, 2)]
    out.append(InterEncBlock(r=24, c=0, bsize=C.BLOCK_32X16,
                             is_inter=False, y_mode=C.DC_PRED,
                             uv_mode=C.PAETH_PRED, skip=False,
                             chroma_coeffs=[[(2, 0)],
                                            [(6, 0), (0, 0), (0, 0),
                                             (1, 1)]]))
    for c in (8, 10, 12, 14):
        out.append(InterEncBlock(r=24, c=c, bsize=C.BLOCK_8X8,
                                 is_inter=False, y_mode=C.DC_PRED,
                                 uv_mode=C.DC_PRED, skip=True))
    out.append(InterEncBlock(r=24, c=16, bsize=C.BLOCK_32X16,
                             is_inter=False, y_mode=C.V_PRED,
                             uv_mode=C.PAETH_PRED, skip=False,
                             chroma_coeffs=[[(1, 0)],
                                            [(6, 0), (0, 0), (0, 0),
                                             (1, 1)]]))
    return out


def test_bottom_overhang_coef_ctx():
    frames = [(C.KEY_FRAME, _key_blocks()),
              (C.INTER_FRAME, _bottom_row())]
    tus = encode_inter_sequence(W, H, 120, frames,
                                lf=(31, 27, 20, 24, 0))
    p = CACHE / "edgectx.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / "edgectx"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    assert r.returncode == 0, "dav1d rejected the stream"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    cw, ch = (W + 1) // 2, (H + 1) // 2
    per = W * H + 2 * cw * ch
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        planes = [raw[b:b + W * H].reshape(H, W),
                  raw[b + W * H:b + W * H + cw * ch].reshape(ch, cw),
                  raw[b + W * H + cw * ch:b + per].reshape(ch, cw)]
        for pi, pname in enumerate("yuv"):
            d = np.abs(planes[pi].astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"frame {fi} {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")
