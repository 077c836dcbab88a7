"""Palette synth conformance vs libdav1d.

The synth encoder mirrors the tile decoder's palette semantics
(mode/size flags, color cache merge, ascending color deltas, NS first
index, wavefront color-index map with score-ordered neighbor symbols),
so any drift in either side shows up as a pixel mismatch against the
dav1d oracle.  Covers sizes 2..8, block sizes 8x8..32x32, color-cache
reuse across adjacent blocks, and structured + random maps (the random
maps exercise every neighbor-context/order combination; the tie-break
rule — equal-score neighbors ordered by ascending color — only shows
on maps where left > top).
"""

import subprocess

import numpy as np

from fixtures import CACHE, tool
from easyav1.container import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, encode_frame, make_ivf
from easyav1.video.av1.backend import AV1Backend

W = H = 64


def _run(tag, blocks, q=60):
    tu = encode_frame(W, H, q, blocks, adapt=True, screen=True)
    p = CACHE / f"palsyn_{tag}.ivf"
    p.write_bytes(make_ivf([tu], W, H))
    prefix = CACHE / f"palsyn_{tag}"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True)
    assert r.returncode == 0, f"{tag}: dav1d rejected the stream"
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    f = be.decode([tu], 0)[0]
    gold = raw[:W * H].reshape(H, W)
    d = np.abs(gold.astype(int) - f.data[0].astype(int))
    assert d.max() == 0, (
        f"{tag}: maxdiff {d.max()} at {np.argwhere(d > 0)[:4].tolist()}")


def _fillers(skip_slots):
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_8X8, skip=True)
            for r in range(0, 16, 2) for c in range(0, 16, 2)
            if (r, c) not in skip_slots]


def _pal_block(r, c, bs, n, seed):
    g = np.random.default_rng(seed)
    colors = sorted(g.choice(np.arange(10, 250), size=n,
                             replace=False).tolist())
    h4, w4 = C.BLOCK_H4[bs] * 4, C.BLOCK_W4[bs] * 4
    m = g.integers(0, n, size=(h4, w4)).astype(np.int32)
    return EncBlock(r=r, c=c, bsize=bs, skip=True, palette_y=(colors, m))


def test_palette_sizes():
    for n in (2, 3, 4, 5, 6, 7, 8):
        blocks = [_pal_block(0, 0, C.BLOCK_16X16, n, 10 + n)]
        blocks += _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
        _run(f"n{n}", blocks)


def test_palette_large_block():
    blocks = [_pal_block(0, 0, C.BLOCK_32X32, 6, 42)]
    blocks += _fillers({(r, c) for r in (0, 2, 4, 6) for c in (0, 2, 4, 6)})
    _run("b32", blocks)


def test_palette_color_cache():
    """Adjacent palette blocks exercise the above/left color cache
    merge + reuse bools."""
    blocks = [_pal_block(0, 0, C.BLOCK_8X8, 4, 20),
              _pal_block(0, 2, C.BLOCK_8X8, 4, 21),
              _pal_block(2, 0, C.BLOCK_8X8, 5, 22),
              _pal_block(2, 2, C.BLOCK_8X8, 3, 23)]
    blocks += _fillers({(0, 0), (0, 2), (2, 0), (2, 2)})
    _run("cache", blocks)


def test_palette_shared_colors_cache_hit():
    """Overlapping color sets force actual cache-hit bools."""
    base = [40, 90, 160, 220]
    m1 = np.random.default_rng(1).integers(0, 4, (8, 8)).astype(np.int32)
    m2 = np.random.default_rng(2).integers(0, 4, (8, 8)).astype(np.int32)
    blocks = [EncBlock(r=0, c=0, bsize=C.BLOCK_8X8, skip=True,
                       palette_y=(base, m1)),
              EncBlock(r=0, c=2, bsize=C.BLOCK_8X8, skip=True,
                       palette_y=(sorted(base[:2] + [120, 200]), m2))]
    blocks += _fillers({(0, 0), (0, 2)})
    _run("sharedcache", blocks)


def test_palette_random_maps():
    for seed in range(6):
        g = np.random.default_rng(100 + seed)
        n = int(g.integers(3, 9))
        blocks = [_pal_block(0, 0, C.BLOCK_16X16, n, 200 + seed)]
        blocks += _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
        _run(f"rand{seed}", blocks)


def _pipe_run(tag, blocks, q=60):
    """Decode through the device pipe (palette blocks export as cls-10
    literal units; the host composer folds the palette prediction into
    the residual planes) and require no C-recon fallback."""
    import os

    from easyav1 import native

    tu = encode_frame(W, H, q, blocks, adapt=True, screen=True)
    os.environ["EASYAV1_PIPE"] = "native"
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    want = [np.asarray(p).copy() for p in be.decode([tu], 0)[0].data]
    native._PIPE_STATS.update(frames=0, fallbacks=0)
    os.environ["EASYAV1_PIPE"] = "pallas"
    try:
        be2 = AV1Backend(TrackInfo(number=1, type=None,
                                   codec_id="V_AV1"))
        got = [np.asarray(p).copy()
               for p in be2.decode([tu], 0)[0].data]
    finally:
        os.environ["EASYAV1_PIPE"] = "native"
    assert native._PIPE_STATS["fallbacks"] == 0, tag
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(a, b), f"{tag} plane {i}"


def test_palette_pallas_pipe():
    for n in (2, 5, 8):
        blocks = [_pal_block(0, 0, C.BLOCK_16X16, n, 10 + n)]
        blocks += _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
        _pipe_run(f"pipe_n{n}", blocks)


def test_palette_pallas_pipe_large():
    """32x32 palette block (multiple tx tiles per literal unit) plus
    non-palette neighbors that read its pixels in the device scan."""
    blocks = [_pal_block(0, 0, C.BLOCK_32X32, 6, 42)]
    blocks += _fillers({(r, c) for r in (0, 2, 4, 6)
                        for c in (0, 2, 4, 6)})
    _pipe_run("pipe_b32", blocks)


def test_palette_pallas_pipe_cache():
    blocks = [_pal_block(0, 0, C.BLOCK_8X8, 4, 20),
              _pal_block(0, 2, C.BLOCK_8X8, 4, 21),
              _pal_block(2, 0, C.BLOCK_8X8, 5, 22),
              _pal_block(2, 2, C.BLOCK_8X8, 3, 23)]
    blocks += _fillers({(0, 0), (0, 2), (2, 0), (2, 2)})
    _pipe_run("pipe_cache", blocks)


def test_palette_pallas_pipe_with_residual():
    """Palette prediction + coded residual in one block: the literal
    fold must add (not replace) the composed residual."""
    g = np.random.default_rng(3)
    m = g.integers(0, 4, size=(16, 16)).astype(np.int32)
    coeffs = [[(3, 0), (2, 1), (1, 0)]]
    blk = EncBlock(r=0, c=0, bsize=C.BLOCK_16X16, skip=False,
                   palette_y=([40, 90, 160, 220], m),
                   luma_coeffs=coeffs)
    blocks = [blk] + _fillers({(r, c) for r in (0, 2) for c in (0, 2)})
    _pipe_run("pipe_resid", blocks)
