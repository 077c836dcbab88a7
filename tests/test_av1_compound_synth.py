"""Compound-prediction synthesized-bitstream conformance.

Order-hint chains with a past (LAST) and future (BWDREF) reference,
mixed single/compound blocks, all eight compound inter modes, drl,
compound ref-mv stack construction (pair match, extra-search pools,
compound mode contexts), and the compound average recon — all verified
bit-exact against libdav1d (reference behavior: dav1d
src/refmvs.c / src/decode.c compound branches, easyav1 decodes via
dav1d: reference src/easyav1.c).
"""

import subprocess

import numpy as np
import pytest

from easyav1.container.webm import TrackInfo
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import EncBlock, make_ivf
from easyav1.video.av1.av1_enc_inter import (InterEncBlock,
                                                 encode_ref_sequence)
from easyav1.video.av1.backend import AV1Backend

from fixtures import CACHE, tool

W = H = 96

COMP_MODES = [C.NEAREST_NEARESTMV, C.NEAR_NEARMV, C.NEAREST_NEWMV,
              C.NEW_NEARESTMV, C.NEAR_NEWMV, C.NEW_NEARMV,
              C.GLOBAL_GLOBALMV, C.NEW_NEWMV]
NEW_COMP = {C.NEAREST_NEWMV, C.NEW_NEARESTMV, C.NEAR_NEWMV,
            C.NEW_NEARMV, C.NEW_NEWMV}


def key_blocks(seed=6):
    rng = np.random.default_rng(seed)
    return [EncBlock(r=r, c=c, bsize=C.BLOCK_16X16, skip=False,
                     luma_coeffs=[[(int(rng.integers(1, 10)),
                                    int(rng.integers(0, 2)))
                                   for _ in range(5)]])
            for r in range(0, 24, 4) for c in range(0, 24, 4)]


def fwd_blocks(seed=7):
    rng = np.random.default_rng(seed)
    return [InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                          ref=C.LAST_FRAME, mode=C.NEWMV,
                          mv=(2 * int(rng.integers(-12, 13)),
                              2 * int(rng.integers(-12, 13))),
                          skip=True)
            for r in range(0, 24, 4) for c in range(0, 24, 4)]


def chain(f2_blocks):
    """key (slot0, hint 9) -> fwd frame (slot1, hint 1) -> compound
    frame with LAST=slot1 (past) and BWDREF=slot0 (future)."""
    return [dict(type=C.KEY_FRAME, blocks=key_blocks(), order_hint=9),
            dict(type=C.INTER_FRAME, blocks=fwd_blocks(), order_hint=1,
                 refresh=0b10, ref_idx=[0] * 7, err=False),
            dict(type=C.INTER_FRAME, blocks=f2_blocks, order_hint=2,
                 refresh=0b100, ref_idx=[1, 1, 1, 1, 0, 0, 0],
                 err=False)]


def run_case(tag, frames, carry=True):
    tus = encode_ref_sequence(W, H, 70, frames, ref_select=True,
                              carry=carry)
    p = CACHE / f"comp_{tag}.ivf"
    p.write_bytes(make_ivf(tus, W, H))
    prefix = CACHE / f"comp_{tag}"
    subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                   check=True, capture_output=True)
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = W * H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    for fi, tu in enumerate(tus):
        f = be.decode([tu], 0)[0]
        b = fi * per
        for pi, dim in ((0, 96), (1, 48), (2, 48)):
            off = b + (0 if pi == 0 else W * H + (pi - 1) * 48 * 48)
            gold = raw[off:off + dim * dim].reshape(dim, dim)
            d = np.abs(gold.astype(int) - f.data[pi].astype(int))
            assert d.max() == 0, (
                f"{tag} frame {fi} plane {pi}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")


def comp_blk(r, c, mode, mv=None, mv2=None, skip=True, ref_mv_idx=0):
    b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                      ref=C.LAST_FRAME, ref2=C.BWDREF_FRAME,
                      mode=mode, skip=skip)
    if mv is not None:
        b.mv = mv
    if mv2 is not None:
        b.mv2 = mv2
    b.ref_mv_idx = ref_mv_idx
    return b


def nearest_fill(exclude):
    return [InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                          ref=C.LAST_FRAME, mode=C.NEARESTMV, skip=True)
            for r in range(0, 24, 4) for c in range(0, 24, 4)
            if (r, c) not in exclude]


@pytest.mark.parametrize("mode", COMP_MODES,
                         ids=["nst2", "near2", "nst_new", "new_nst",
                              "near_new", "new_near", "gg", "new2"])
def test_comp_mode_empty_pool(mode):
    """Each compound mode at (0,0): the ref-mv stack is built entirely
    by the extra-search (global pairs) -> exercises spec 7.10.2.12."""
    blocks = [comp_blk(0, 0, mode, (4, 12), (-6, 2))]
    blocks += nearest_fill({(0, 0)})
    run_case(f"empty_{mode}", chain(blocks))


@pytest.mark.parametrize("mode", COMP_MODES,
                         ids=["nst2", "near2", "nst_new", "new_nst",
                              "near_new", "new_near", "gg", "new2"])
def test_comp_mode_after_new_neighbor(mode):
    """Each compound mode with a compound-NEW left neighbor: pins the
    compound mode ctx map rows (libaom compound_mode_ctx_map, recovered
    from the libaom binary; the NEW neighbor lowers new_mv_ctx)."""
    blocks = [comp_blk(0, 0, C.NEW_NEWMV, (4, 12), (-6, 2)),
              comp_blk(0, 4, mode, (10, -2), (8, 8))]
    blocks += nearest_fill({(0, 0), (0, 4)})
    run_case(f"afternew_{mode}", chain(blocks))


def test_comp_ctx_both_neighbors_new():
    """close_matches=2 with NEW neighbors above+left (ctx map row 2)."""
    blocks = [comp_blk(0, 0, C.NEAREST_NEARESTMV),
              comp_blk(0, 4, C.NEW_NEWMV, (4, 12), (-6, 2)),
              comp_blk(4, 0, C.NEW_NEWMV, (-6, 2), (4, 12)),
              comp_blk(4, 4, C.NEW_NEWMV, (10, -2), (8, 8))]
    blocks += nearest_fill({(0, 0), (0, 4), (4, 0), (4, 4)})
    run_case("row2", chain(blocks))


def test_comp_drl_and_residuals():
    """drl indices on NEAR-type compound modes plus coded residuals."""
    blocks = [comp_blk(0, 0, C.NEAREST_NEARESTMV),
              comp_blk(0, 4, C.NEAR_NEARMV, ref_mv_idx=1),
              comp_blk(4, 0, C.NEW_NEWMV, (4, 12), (-6, 2),
                       skip=False, ref_mv_idx=0),
              comp_blk(4, 4, C.NEW_NEARMV, (8, 8), None, ref_mv_idx=1)]
    for b in blocks:
        if not b.skip:
            b.luma_coeffs = [[(3, 0), (2, 1), (5, 0)]]
    blocks += nearest_fill({(0, 0), (0, 4), (4, 0), (4, 4)})
    run_case("drl", chain(blocks))


def test_comp_mixed_single_compound():
    """Interleaved single-ref (fwd and bwd) and compound blocks:
    exercises comp_inter flag contexts and ref-pair trees."""
    rng = np.random.default_rng(3)
    blocks = []
    for i, (r, c) in enumerate([(r, c) for r in range(0, 24, 4)
                                for c in range(0, 24, 4)]):
        pick = i % 4
        if pick == 0:
            blocks.append(comp_blk(r, c, C.NEW_NEWMV,
                                   (2 * int(rng.integers(-8, 9)),
                                    2 * int(rng.integers(-8, 9))),
                                   (2 * int(rng.integers(-8, 9)),
                                    2 * int(rng.integers(-8, 9)))))
        elif pick == 1:
            blocks.append(InterEncBlock(
                r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                ref=C.BWDREF_FRAME, mode=C.NEARESTMV, skip=True))
        elif pick == 2:
            blocks.append(comp_blk(r, c, C.NEAREST_NEARESTMV))
        else:
            blocks.append(InterEncBlock(
                r=r, c=c, bsize=C.BLOCK_16X16, is_inter=True,
                ref=C.LAST_FRAME, mode=C.NEARESTMV, skip=True))
    run_case("mixed", chain(blocks))


def test_comp_two_frames_carry():
    """Two consecutive compound frames with entropy-context carry."""
    rng = np.random.default_rng(4)

    def mkblocks(seed):
        rng = np.random.default_rng(seed)
        out = []
        for r in range(0, 24, 4):
            for c in range(0, 24, 4):
                mode = int(rng.choice(COMP_MODES))
                b = comp_blk(r, c, mode)
                if mode in NEW_COMP:
                    b.mv = (2 * int(rng.integers(-10, 11)),
                            2 * int(rng.integers(-10, 11)))
                    b.mv2 = (2 * int(rng.integers(-10, 11)),
                             2 * int(rng.integers(-10, 11)))
                out.append(b)
        return out

    frames = chain(mkblocks(11))
    frames.append(dict(type=C.INTER_FRAME, blocks=mkblocks(12),
                       order_hint=3, refresh=0b1000,
                       ref_idx=[2, 1, 1, 1, 0, 0, 0], err=False))
    run_case("carry2", frames)
