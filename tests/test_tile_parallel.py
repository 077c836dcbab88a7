"""Tile-parallel entropy decode (dav1d thread_task.c
role, reference cmake/dav1d.cmake:993).

Multi-tile streams decoded with N workers must be bit-exact against
both the sequential path and the dav1d oracle — the merge re-creates
the sequential append order with index relocation, so every downstream
consumer (recon, LF, CDEF, palette) is unchanged.
"""

import os

import numpy as np
import pytest

from test_av1_multitg import _fixture
from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend


def _decode_all(path, threads):
    prev = os.environ.get("EASYAV1_THREADS")
    os.environ["EASYAV1_THREADS"] = str(threads)
    try:
        dmx = WebMDemuxer(str(path))
        vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
        be = AV1Backend(vt)
        frames = []
        while (p := dmx.read_packet()) is not None:
            if p.track != vt.number:
                continue
            for pk in p.frames:
                for f in be.decode([pk], 0):
                    frames.append([np.asarray(pl).copy() for pl in f.data])
        return frames
    finally:
        if prev is None:
            os.environ.pop("EASYAV1_THREADS", None)
        else:
            os.environ["EASYAV1_THREADS"] = prev


@pytest.mark.parametrize("tile_cols,tile_rows,threads", [
    (1, 0, 2), (1, 1, 4), (1, 1, 3), (0, 1, 8)])
def test_tile_parallel_bit_exact(tile_cols, tile_rows, threads):
    # inter + intra mix; libaom tile-columns/tile-rows are log2 values,
    # so (1,1) = a 2x2 tile grid
    w, h = 512, 384
    path, prefix = _fixture(w, h, 6, 3, 1, tile_cols=tile_cols,
                            tile_rows=tile_rows)
    seq = _decode_all(path, 1)
    par = _decode_all(path, threads)
    assert len(seq) == len(par) > 0
    for i, (a, b) in enumerate(zip(seq, par)):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb), f"frame {i}"
    # and the sequential side is oracle-verified by test_av1_multitg's
    # fixtures; compare frame 0 against the dav1d dump here too
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)
    for i, fr in enumerate(par):
        gold = raw[i * per:i * per + w * h].reshape(h, w)
        assert np.array_equal(gold, fr[0]), f"oracle frame {i}"


def test_tile_parallel_single_tile_falls_back():
    path, _ = _fixture(96, 96, 3, 3, 1)
    par = _decode_all(path, 4)          # 1 tile: C entry must not MT
    seq = _decode_all(path, 1)
    for a, b in zip(seq, par):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)
