"""Inter-frame synthesized-bitstream conformance: encode with the
minimal inter encoder, decode with BOTH libdav1d and our decoder,
compare bit-exact.  Covers ref coding, all four single-ref inter modes,
drl, subpel motion compensation, residuals with inter tx types, and
mv precision variants."""

import json
import subprocess

import numpy as np
import pytest

from easyav1.container.webm import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_inter_sequence)
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool

W = H = 64


def key_blocks(seed=1, bsize=C.BLOCK_16X16, ncoef=6):
    rng = np.random.default_rng(seed)
    step = C.BLOCK_W4[bsize]
    out = []
    for r in range(0, 16, step):
        for c in range(0, 16, step):
            coeffs = [[(int(rng.integers(1, 8)), int(rng.integers(0, 2)))
                       for _ in range(ncoef)]]
            out.append(EncBlock(r=r, c=c, bsize=bsize, skip=False,
                                luma_coeffs=coeffs))
    return out


def run_case(tag, frames, hp_mv=True, q=100):
    tus = encode_inter_sequence(W, H, q, frames, hp_mv=hp_mv)
    p = CACHE / f"synth_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"synth_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    meta = json.loads(prefix.with_suffix(".json").read_text())
    assert meta["vframes"] == len(frames)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 32 * 32
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        planes = [raw[b:b + W * H].reshape(H, W),
                  raw[b + W * H:b + W * H + 32 * 32].reshape(32, 32),
                  raw[b + W * H + 32 * 32:b + per].reshape(32, 32)]
        for pi, pname in enumerate("yuv"):
            d = np.abs(planes[pi].astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def inter_grid(bsize=C.BLOCK_16X16, **kw):
    step = C.BLOCK_W4[bsize]
    return [InterEncBlock(r=r, c=c, bsize=bsize, is_inter=True,
                          ref=C.LAST_FRAME, **kw)
            for r in range(0, 16, step) for c in range(0, 16, step)]


def test_inter_skip_nearest():
    frames = [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, inter_grid(skip=True, mode=C.NEARESTMV))]
    run_case("i_nearest", frames)


def test_inter_newmv_subpel():
    mvs = [(0, 0), (8, 8), (-8, 16), (3, -5), (1, 1), (-1, 7), (16, -24),
           (5, 0), (0, 3), (-2, -2), (11, 13), (-16, 8), (2, 9), (-7, -1),
           (4, 4), (6, -6)]
    blocks = inter_grid(skip=True, mode=C.NEWMV)
    for b, mv in zip(blocks, mvs):
        b.mv = mv
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_newmv", frames)


def test_inter_globalmv():
    frames = [(C.KEY_FRAME, key_blocks()),
              (C.INTER_FRAME, inter_grid(skip=True, mode=C.GLOBALMV))]
    run_case("i_global", frames)


def test_inter_nearmv_drl():
    # populate the stack with distinct neighbor mvs, then NEARMV picks
    # drl indices
    blocks = inter_grid(skip=True, mode=C.NEWMV)
    mvs = [(0, 8), (8, 0), (8, 8), (0, -8)] * 4
    for b, mv in zip(blocks, mvs):
        b.mv = mv
    # last rows: NEARMV with ref_mv_idx 1 where available
    for b in blocks[8:]:
        b.mode = C.NEARMV
        b.ref_mv_idx = 1
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_nearmv", frames)


def test_inter_multi_ref():
    refs = [C.LAST_FRAME, C.LAST2_FRAME, C.LAST3_FRAME, C.GOLDEN_FRAME,
            C.BWDREF_FRAME, C.ALTREF2_FRAME, C.ALTREF_FRAME,
            C.LAST_FRAME] * 2
    blocks = inter_grid(skip=True, mode=C.NEARESTMV)
    for b, ref in zip(blocks, refs):
        b.ref = ref
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_refs", frames)


def test_inter_residual():
    rng = np.random.default_rng(7)
    blocks = inter_grid(skip=False, mode=C.NEWMV)
    for i, b in enumerate(blocks):
        b.mv = (int(rng.integers(-16, 17)), int(rng.integers(-16, 17)))
        b.luma_coeffs = [[(int(rng.integers(1, 10)),
                           int(rng.integers(0, 2))) for _ in range(8)]]
        b.chroma_coeffs = [[(3, 0), (2, 1)], [(4, 0)]] if i % 2 else None
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_resid", frames)


def test_inter_residual_32():
    # 32x32 blocks: inter tx set 3 (IDTX/DCT 2-symbol set)
    rng = np.random.default_rng(8)
    blocks = inter_grid(bsize=C.BLOCK_32X32, skip=False, mode=C.NEWMV)
    for b in blocks:
        b.mv = (int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
        b.luma_coeffs = [[(int(rng.integers(1, 6)),
                           int(rng.integers(0, 2))) for _ in range(5)]]
    frames = [(C.KEY_FRAME, key_blocks(bsize=C.BLOCK_32X32)),
              (C.INTER_FRAME, blocks)]
    run_case("i_resid32", frames)


def test_inter_lowprec_mv():
    # allow_high_precision_mv = 0: quarter-pel diffs (even 1/8 units)
    mvs = [(0, 0), (2, 2), (-4, 8), (6, -2), (2, 0), (0, 6), (10, -12),
           (4, 0)] * 2
    blocks = inter_grid(skip=True, mode=C.NEWMV)
    for b, mv in zip(blocks, mvs):
        b.mv = mv
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_lowprec", frames, hp_mv=False)


def test_inter_three_frames():
    # chain: key -> inter -> inter (second inter references the first)
    b1 = inter_grid(skip=True, mode=C.NEARESTMV)
    b2 = inter_grid(skip=True, mode=C.NEWMV)
    for b in b2:
        b.mv = (4, -4)
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, b1),
              (C.INTER_FRAME, b2)]
    run_case("i_chain", frames)


def test_inter_adaptive_cdf():
    rng = np.random.default_rng(9)
    blocks = inter_grid(skip=False, mode=C.NEWMV)
    for b in blocks:
        b.mv = (int(rng.integers(-12, 13)), int(rng.integers(-12, 13)))
        b.luma_coeffs = [[(int(rng.integers(1, 12)),
                           int(rng.integers(0, 2))) for _ in range(10)]]
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    tus = encode_inter_sequence(W, H, 100, frames, hp_mv=True, adapt=True)
    _compare_tus("i_adapt", tus, 2)


def test_inter_vartx_nosplit():
    rng = np.random.default_rng(10)
    blocks = inter_grid(skip=False, mode=C.NEWMV)
    for b in blocks:
        b.mv = (int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
        b.luma_coeffs = [[(int(rng.integers(1, 8)),
                           int(rng.integers(0, 2))) for _ in range(6)]]
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    tus = encode_inter_sequence(W, H, 100, frames, hp_mv=True,
                                tx_select=True)
    _compare_tus("i_vartx", tus, 2)


def test_inter_switchable_filters():
    rng = np.random.default_rng(11)
    blocks = inter_grid(skip=True, mode=C.NEWMV)
    for i, b in enumerate(blocks):
        b.mv = (int(rng.integers(-10, 11)) , int(rng.integers(-10, 11)))
        b.interp = i % 3              # REGULAR/SMOOTH/SHARP
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    tus = encode_inter_sequence(W, H, 100, frames, hp_mv=True,
                                switchable=True)
    _compare_tus("i_filters", tus, 2)


def _compare_tus(tag, tus, n):
    p = CACHE / f"synth_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"synth_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 32 * 32
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        planes = [raw[b:b + W * H].reshape(H, W),
                  raw[b + W * H:b + W * H + 32 * 32].reshape(32, 32),
                  raw[b + W * H + 32 * 32:b + per].reshape(32, 32)]
        for pi, pname in enumerate("yuv"):
            d = np.abs(planes[pi].astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} {pname}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def test_inter_96_edges():
    # 96x96: partial superblocks on the right/bottom (edge partitions,
    # clipped scans) — reproduces the real-fixture edge desync surface
    w = h = 96
    rng = np.random.default_rng(12)
    kb = []
    ib = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            kb.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                               luma_coeffs=[[(int(rng.integers(1, 8)),
                                              int(rng.integers(0, 2)))
                                             for _ in range(5)]]))
            ib.append(InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                    is_inter=True, ref=C.LAST_FRAME,
                                    skip=True, mode=C.NEWMV,
                                    mv=(int(rng.integers(-10, 11)),
                                        int(rng.integers(-10, 11)))))
    tus = encode_inter_sequence(w, h, 100, [(C.KEY_FRAME, kb),
                                            (C.INTER_FRAME, ib)],
                                hp_mv=True)
    p = CACHE / "synth_i96.ivf"
    p.write_bytes(make_ivf(tus, w, h))
    prefix = CACHE / "synth_i96"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = w * h + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        gold = raw[b:b + w * h].reshape(h, w)
        d = np.abs(gold.astype(int) - f.data[0].astype(int))
        assert d.max() == 0, (
            f"i96 frame {fi}: maxdiff {d.max()} at "
            f"{np.argwhere(d > 0)[:4].tolist()}")


def test_intra_in_inter():
    rng = np.random.default_rng(13)
    blocks = inter_grid(skip=True, mode=C.NEWMV)
    for i, b in enumerate(blocks):
        if i % 3 == 0:
            b.is_inter = False
            b.skip = False
            b.y_mode = [C.DC_PRED, C.V_PRED, C.D45_PRED, C.SMOOTH_PRED][i % 4]
            b.uv_mode = C.DC_PRED
            b.luma_coeffs = [[(int(rng.integers(1, 8)),
                               int(rng.integers(0, 2))) for _ in range(5)]]
        else:
            b.mv = (int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    run_case("i_intra_mix", frames)


def test_intra_in_inter_adapt():
    rng = np.random.default_rng(14)
    blocks = inter_grid(skip=False, mode=C.NEWMV)
    for i, b in enumerate(blocks):
        if i % 2 == 0:
            b.is_inter = False
            b.y_mode = C.D45_PRED if i % 4 == 0 else C.DC_PRED
            b.angle_y = 0
        else:
            b.mv = (int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
        b.luma_coeffs = [[(int(rng.integers(1, 10)),
                           int(rng.integers(0, 2))) for _ in range(8)]]
    frames = [(C.KEY_FRAME, key_blocks()), (C.INTER_FRAME, blocks)]
    tus = encode_inter_sequence(W, H, 100, frames, hp_mv=True, adapt=True,
                                tx_select=True)
    _compare_tus("i_mix_adapt", tus, 2)
