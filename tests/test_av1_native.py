"""Native (C) tile decoder vs Python TileDecoder: plan equivalence.

The C decoder (easyav1/native/av1_tile.c) must produce a FramePlan
bit-identical to the Python reference on real libaom streams — every mi
grid, block record, dequantized coefficient, lf tx and cdef index.
The end-to-end dav1d conformance tests in test_av1_real.py then run on
top of whichever path the backend picks.
"""

import numpy as np
import pytest

from easyav1 import native
from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend
from easyav1.video.av1.cdf import CdfContext
from easyav1.video.av1.headers import split_obus
from easyav1.video.av1 import constants as C
from easyav1.video.av1.tile import FramePlan, TileDecoder

from fixtures import CACHE
from test_av1_real import real_fixture, NEAR_DEFAULT


def _new_plan(hdr, seq):
    return FramePlan(
        width=hdr.upscaled_width, height=hdr.frame_height,
        mi_cols=hdr.mi_cols, mi_rows=hdr.mi_rows,
        subsampling_x=seq.color.subsampling_x,
        subsampling_y=seq.color.subsampling_y,
        y_mode=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        uv_mode=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        angle_y=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        angle_uv=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        skip=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        bsize=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
    )


def _plans_for(tag, w, h, crf=30, extra=()):
    out, _ = real_fixture(tag, w, h, crf, 1, extra)
    dmx = WebMDemuxer(str(out))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkt = None
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkt = p.frames[0]
            break
    be = AV1Backend(vt)
    # parse headers + split tiles by reusing backend internals
    hdr = None
    tiles = []
    for obu in split_obus(pkt):
        if obu.type == C.OBU_SEQUENCE_HEADER:
            from easyav1.video.av1.headers import (HeaderParser,
                                                       parse_sequence_header)
            be.seq = parse_sequence_header(obu.payload)
            be.hp = HeaderParser(be.seq)
        elif obu.type == C.OBU_FRAME:
            hdr = be._parse_frame_header(obu.payload)
            byte_off = (hdr.header_bit_offset + 7) // 8
            tiles = be._split_tiles(hdr, [obu.payload[byte_off:]])
    assert hdr is not None
    seq = be.seq

    plan_py = _new_plan(hdr, seq)
    cdf = CdfContext.default(hdr.quant.base_q_idx)
    dec = TileDecoder(seq, hdr, cdf, plan_py)
    for tn, td in enumerate(tiles):
        dec.decode_tile(td, tn // hdr.tile.cols, tn % hdr.tile.cols)

    plan_c = _new_plan(hdr, seq)
    ok = native.decode_frame_native(seq, hdr, plan_c, tiles)
    return ok, plan_py, plan_c


def _assert_plan_equal(plan_py, plan_c):
    for k in ("y_mode", "uv_mode", "angle_y", "angle_uv", "skip", "bsize"):
        a, b = getattr(plan_py, k), getattr(plan_c, k)
        assert np.array_equal(a, b), f"mi grid {k} differs"
    assert plan_py.cdef_idx == plan_c.cdef_idx
    assert plan_py.cfl_alphas == plan_c.cfl_alphas
    assert plan_py.filter_intra == plan_c.filter_intra
    assert plan_py.lf_txs == plan_c.lf_txs
    assert len(plan_py.blocks) == len(plan_c.blocks)
    for i, (bp, bc) in enumerate(zip(plan_py.blocks, plan_c.blocks)):
        for f in ("r", "c", "bsize", "y_mode", "uv_mode", "angle_y",
                  "angle_uv", "skip", "tx_size", "uv_tx_size",
                  "has_chroma", "cfl_alphas", "filter_intra"):
            assert getattr(bp, f) == getattr(bc, f), \
                f"block {i} field {f}: {getattr(bp, f)} != {getattr(bc, f)}"
        assert len(bp.tx_blocks) == len(bc.tx_blocks), f"block {i} tx count"
        for j, (tp, tc) in enumerate(zip(bp.tx_blocks, bc.tx_blocks)):
            for f in ("plane", "x", "y", "tx_size", "tx_type", "eob",
                      "lossless"):
                assert getattr(tp, f) == getattr(tc, f), \
                    f"block {i} tx {j} field {f}"
            assert np.array_equal(tp.coeffs, tc.coeffs), \
                f"block {i} tx {j} coeffs differ"


@pytest.mark.skipif(not native.available(), reason="no native lib")
@pytest.mark.parametrize("tag,w,h,crf,extra", [
    ("64", 64, 64, 30, ()),
    ("64hiq", 64, 64, 10, ()),
    ("odd", 66, 50, 30, ()),
    ("neardflt", 96, 96, 30, tuple(NEAR_DEFAULT)),
    ("neardflt_qcif", 176, 144, 35, tuple(NEAR_DEFAULT + ["content=0"])),
])
def test_native_plan_equivalence(tag, w, h, crf, extra):
    ok, plan_py, plan_c = _plans_for(tag, w, h, crf, extra)
    assert ok, "native decode declined"
    _assert_plan_equal(plan_py, plan_c)
