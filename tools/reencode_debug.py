#!/usr/bin/env python3
"""Bitstream round-trip debugger: decode a frame's tile with the Python
TileDecoder, re-encode the decoded plan with the synth encoder, and
byte-compare against the original tile data.  The first differing bit
localizes the first symbol where our read semantics deviate from
libaom/dav1d.  Usage:

    python tools/reencode_debug.py <fixture.webm> <frame_index>
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from easyav1.container.webm import TrackType, WebMDemuxer  # noqa: E402
from easyav1.video.av1 import constants as C  # noqa: E402
from easyav1.video.av1 import tables as T  # noqa: E402
from easyav1.video.av1.av1_enc_inter import InterTileEncoder  # noqa: E402
from easyav1.video.av1.backend import AV1Backend  # noqa: E402
from easyav1.video.av1.cdf import CdfContext  # noqa: E402
from easyav1.video.av1.headers import split_obus  # noqa: E402
from easyav1.video.av1.tile import FramePlan, TileDecoder  # noqa: E402


class PlanReencoder(InterTileEncoder):
    """Re-encodes a decoded FramePlan; block data driven from the plan
    records (modes, mvs, drl indices, per-tx types and levels)."""

    def __init__(self, plan, hdr, seq, **kw):
        super().__init__(plan.width, plan.height, hdr.quant.base_q_idx,
                         hp_mv=hdr.allow_high_precision_mv,
                         adapt=not hdr.disable_cdf_update,
                         tx_mode_select=hdr.tx_mode == C.TX_MODE_SELECT,
                         switchable=hdr.interpolation_filter
                         == C.SWITCHABLE,
                         motion_switch=getattr(
                             hdr, "is_motion_mode_switchable", False),
                         allow_warp=getattr(
                             hdr, "allow_warped_motion", False), **kw)
        self.mi_cols = hdr.mi_cols
        self.mi_rows = hdr.mi_rows
        self.mi_row_end = hdr.mi_rows
        self.mi_col_end = hdr.mi_cols
        self.frame_is_intra = hdr.frame_is_intra
        self.hdr = hdr                       # real header (gm, refmvs)
        self.seq = seq
        self.bitlog = []                     # (bit_pos, r, c)
        self._cdef_done = set()
        # keyframe path: the base encoder emits cdef itself
        if getattr(seq, "enable_cdef", False) and hdr.frame_is_intra \
                and not getattr(hdr, "coded_lossless", False):
            self.cdef_bits = hdr.cdef.bits
            self.cdef_vals = {k: (0 if v < 0 else v)
                              for k, v in plan.cdef_idx.items()}
        self._plan = plan
        self._plan_blocks = {}
        for b in plan.blocks:
            self._plan_blocks[(b.r, b.c)] = b

    def _enc_skip(self, blk):
        super()._enc_skip(blk)
        # cdef index literal (decoder read_cdef): first non-skip block
        # per 64x64 unit
        hdr = self.hdr
        if (not blk.skip and self.seq.enable_cdef
                and not hdr.frame_is_intra
                and not getattr(hdr, "coded_lossless", False)
                and not getattr(hdr, "allow_intrabc", False)):
            r, c, bsize = blk.r, blk.c, blk.bsize
            mask = ~15
            for rr in range(r & mask, r + C.BLOCK_H4[bsize], 16):
                for cc in range(c & mask, c + C.BLOCK_W4[bsize], 16):
                    if (rr, cc) not in self._cdef_done:
                        self._cdef_done.add((rr, cc))
                        v = self._plan.cdef_idx.get((rr, cc), 0)
                        for b_i in range(hdr.cdef.bits - 1, -1, -1):
                            self.enc.encode_bool_equi((v >> b_i) & 1)
        self._emit_deltas_hook(blk)

    def _emit_deltas_hook(self, blk):
        # delta_q / delta_lf replay (decoder read_deltas; recorded per
        # first-block-of-superblock in plan.delta_events)
        ev = getattr(self._plan, "delta_events", {}).get((blk.r, blk.c))
        if ev:
            for e in ev:
                if e[0] == "q":
                    _, absv, rem_bits, sign = e
                    sym = min(absv, 3)
                    self._sym(self.cdf["delta_q"][0], sym, 4)
                    if sym == 3:
                        for b_i in range(2, -1, -1):
                            self.enc.encode_bool_equi(
                                ((rem_bits - 1) >> b_i) & 1)
                        rem = absv - (1 << rem_bits) - 1
                        for b_i in range(rem_bits - 1, -1, -1):
                            self.enc.encode_bool_equi((rem >> b_i) & 1)
                    if absv:
                        self.enc.encode_bool_equi(int(sign))
                else:
                    _, i, absv, rem_bits, sign = e
                    hdr2 = self.hdr
                    row = (self.cdf["delta_lf_multi"][i]
                           if hdr2.delta_lf_multi
                           else self.cdf["delta_lf"][0])
                    sym = min(absv, 3)
                    self._sym(row, sym, 4)
                    if sym == 3:
                        for b_i in range(2, -1, -1):
                            self.enc.encode_bool_equi(
                                ((rem_bits - 1) >> b_i) & 1)
                        rem = absv - (1 << rem_bits) - 1
                        for b_i in range(rem_bits - 1, -1, -1):
                            self.enc.encode_bool_equi((rem >> b_i) & 1)
                    if absv:
                        self.enc.encode_bool_equi(int(sign))

    def _encode_block(self, blk):
        self.bitlog.append((len(self.enc.precarry) * 16, blk.r, blk.c))
        pb = self._plan_blocks[(blk.r, blk.c)]
        self._txmap = {(t.plane, t.x, t.y): t for t in pb.tx_blocks}
        self._pb = pb
        super()._encode_block(blk)

    # -- exact partition replay from plan.part_log (handles AB/4 exts) --

    def encode_blocks(self, blocks):
        from easyav1.video.av1.av1_enc import EncBlock  # noqa
        self._part_idx = 0
        self._blk_by_pos = {(b.r, b.c): b for b in blocks}
        return super().encode_blocks(blocks)

    def _encode_partition(self, r, c, bsize, blkmap):
        from easyav1.video.av1.tile import (partition_subsize,
                                                mi_wlog2, _PART_ABOVE,
                                                _PART_LEFT, TileDecoder)
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        plog = self._plan.part_log
        (er, ec, ebs, part) = plog[self._part_idx]
        assert (er, ec, ebs) == (r, c, bsize), \
            f"part walk desync: log{(er, ec, ebs)} vs {(r, c, bsize)}"
        self._part_idx += 1
        w4 = C.BLOCK_W4[bsize]
        h4 = C.BLOCK_H4[bsize]
        half = w4 >> 1
        q = half >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        bsl = mi_wlog2(bsize)
        if bsize == C.BLOCK_4X4:
            pass
        elif has_rows and has_cols:
            above = (int(self.a_part[c]) >> bsl) & 1
            left = (int(self.l_part[r]) >> bsl) & 1
            row_idx = (bsl - 1) * 4 + left * 2 + above
            nsym = 4 if bsize == C.BLOCK_8X8 else (
                8 if bsize == C.BLOCK_128X128 else 10)
            self._sym(self.cdf["partition"][row_idx], part, nsym)
        elif has_cols or has_rows:
            above = (int(self.a_part[c]) >> bsl) & 1
            left = (int(self.l_part[r]) >> bsl) & 1
            row_idx = (bsl - 1) * 4 + left * 2 + above
            psplit = TileDecoder.edge_split_prob(
                self.cdf["partition"][row_idx], bsize, has_cols)
            self.enc.encode_bool(int(part == C.PARTITION_SPLIT), psplit)
        sub = partition_subsize(part, bsize) if bsize >= C.BLOCK_8X8 \
            else bsize
        sq = partition_subsize(C.PARTITION_SPLIT, bsize) \
            if bsize >= C.BLOCK_8X8 else bsize

        def blk_at(rr, cc):
            return self._blk_by_pos[(rr, cc)]

        if part == C.PARTITION_NONE:
            self._encode_block(blk_at(r, c))
        elif part == C.PARTITION_HORZ:
            self._encode_block(blk_at(r, c))
            if has_rows:
                self._encode_block(blk_at(r + half, c))
        elif part == C.PARTITION_VERT:
            self._encode_block(blk_at(r, c))
            if has_cols:
                self._encode_block(blk_at(r, c + half))
        elif part == C.PARTITION_SPLIT:
            self._encode_partition(r, c, sub, blkmap)
            self._encode_partition(r, c + half, sub, blkmap)
            self._encode_partition(r + half, c, sub, blkmap)
            self._encode_partition(r + half, c + half, sub, blkmap)
        elif part == C.PARTITION_HORZ_A:
            self._encode_block(blk_at(r, c))
            self._encode_block(blk_at(r, c + half))
            self._encode_block(blk_at(r + half, c))
        elif part == C.PARTITION_HORZ_B:
            self._encode_block(blk_at(r, c))
            self._encode_block(blk_at(r + half, c))
            self._encode_block(blk_at(r + half, c + half))
        elif part == C.PARTITION_VERT_A:
            self._encode_block(blk_at(r, c))
            self._encode_block(blk_at(r + half, c))
            self._encode_block(blk_at(r, c + half))
        elif part == C.PARTITION_VERT_B:
            self._encode_block(blk_at(r, c))
            self._encode_block(blk_at(r, c + half))
            self._encode_block(blk_at(r + half, c + half))
        elif part == C.PARTITION_HORZ_4:
            for i in range(4):
                if r + i * q >= self.mi_rows:
                    break
                self._encode_block(blk_at(r + i * q, c))
        elif part == C.PARTITION_VERT_4:
            for i in range(4):
                if c + i * q >= self.mi_cols:
                    break
                self._encode_block(blk_at(r, c + i * q))
        # ctx updates (mirror decoder)
        if bsize >= C.BLOCK_8X8:
            def upd(rr, cc, subsize, bs):
                self.a_part[cc:cc + C.BLOCK_W4[bs]] = _PART_ABOVE[subsize]
                self.l_part[rr:rr + C.BLOCK_H4[bs]] = _PART_LEFT[subsize]
            if part == C.PARTITION_SPLIT and bsize != C.BLOCK_8X8:
                pass
            elif part == C.PARTITION_HORZ_A:
                upd(r, c, sq, sub)
                upd(r + half, c, sub, sub)
            elif part == C.PARTITION_HORZ_B:
                upd(r, c, sub, sub)
                upd(r + half, c, sq, sub)
            elif part == C.PARTITION_VERT_A:
                upd(r, c, sq, sub)
                upd(r, c + half, sub, sub)
            elif part == C.PARTITION_VERT_B:
                upd(r, c, sub, sub)
                upd(r, c + half, sq, sub)
            else:
                upd(r, c, sub, bsize)

    # residual override: levels/types per tx from the plan
    def _encode_txb(self, plane, x4, y4, tx_size, tx_ctx, blk, coeffs):
        import os
        if os.environ.get("TXB_LOG"):
            print(f"ENC txb p{plane} ({x4},{y4}) tx{tx_size} "
                  f"@{len(self.enc.precarry)*16}")
        t = self._txmap.get((plane, x4 * 4, y4 * 4))
        levels = t.levels if t is not None else []
        blk.tx_type = t.tx_type if t is not None else C.DCT_DCT
        super()._encode_txb(plane, x4, y4, tx_size, tx_ctx, blk, levels)

    def _emit_var_tx_nosplit(self, r, c, bsize, tx_size):
        """Emit the ACTUAL var-tx tree from the plan's leaf set."""
        leaves = {(xx, yy): tx for (xx, yy, tx) in (self._pb.var_txs or [])}
        w4 = min(C.BLOCK_W4[bsize], self.mi_cols - c)
        h4 = min(C.BLOCK_H4[bsize], self.mi_rows - r)
        max_tx = T.MAX_TX_SIZE_RECT[bsize]
        if max_tx == C.TX_4X4:
            self.a_txw[c:c + w4] = 4
            self.l_txh[r:r + h4] = 4
            return
        for yy in range(0, h4, T.TX_H4[max_tx]):
            for xx in range(0, w4, T.TX_W4[max_tx]):
                self._var_node(r, c, bsize, xx, yy, max_tx, 0, leaves)

    def _var_node(self, r, c, bsize, xx, yy, tx_size, depth, leaves):
        split = leaves.get((xx, yy)) != tx_size
        if depth < 2 and tx_size != C.TX_4X4:
            txw = T.TX_WIDTH[tx_size]
            txh = T.TX_HEIGHT[tx_size]
            above = (r + yy > 0) and int(self.a_txw[c + xx]) < txw
            left = (c + xx > 0) and int(self.l_txh[r + yy]) < txh
            max_sq = T.TX_SIZE_SQR_UP[T.MAX_TX_SIZE_RECT[bsize]]
            cat = ((T.TX_SIZE_SQR_UP[tx_size] != max_sq
                    and max_sq > C.TX_8X8)
                   + (C.TX_SIZES - 1 - max_sq) * 2)
            ctx = cat * 3 + int(above) + int(left)
            self._sym(self.cdf["txfm_partition"][ctx], int(split))
        else:
            split = False
        if split:
            sub = T.SPLIT_TX_SIZE[tx_size]
            for dy in range(0, T.TX_H4[tx_size], T.TX_H4[sub]):
                for dx in range(0, T.TX_W4[tx_size], T.TX_W4[sub]):
                    self._var_node(r, c, bsize, xx + dx, yy + dy, sub,
                                   depth + 1, leaves)
        else:
            self.a_txw[c + xx:c + xx + T.TX_W4[tx_size]] = \
                T.TX_WIDTH[tx_size]
            self.l_txh[r + yy:r + yy + T.TX_H4[tx_size]] = \
                T.TX_HEIGHT[tx_size]

    def _encode_residual_inter(self, blk, tx_size, has_chroma):
        pb = self._pb
        r, c, bsize = blk.r, blk.c, blk.bsize
        # luma per var-tx leaf
        for (xx, yy, tx) in (pb.var_txs or []):
            if r + yy >= self.mi_rows or c + xx >= self.mi_cols:
                continue
            tx_ctx = (T.TX_SIZE_SQR[tx] + T.TX_SIZE_SQR_UP[tx] + 1) >> 1
            self._encode_txb(0, c + xx, r + yy, tx, tx_ctx, blk, None)
        if has_chroma:
            tx = self._uv_tx(bsize)
            w4 = min(C.BLOCK_W4[bsize], self.mi_cols - c)
            h4 = min(C.BLOCK_H4[bsize], self.mi_rows - r)
            pw4 = max(1, w4 >> 1)
            ph4 = max(1, h4 >> 1)
            cx = (c >> 1) * 2
            cy = (r >> 1) * 2
            tx_ctx = (T.TX_SIZE_SQR[tx] + T.TX_SIZE_SQR_UP[tx] + 1) >> 1
            for plane in (1, 2):
                for yy in range(0, ph4, T.TX_H4[tx]):
                    for xx in range(0, pw4, T.TX_W4[tx]):
                        self._encode_txb(plane, (c >> 1) + xx,
                                         (r >> 1) + yy, tx, tx_ctx, blk,
                                         None)


def blocks_from_plan(plan):
    from easyav1.video.av1.av1_enc_inter import InterEncBlock
    out = []
    for b in plan.blocks:
        eb = InterEncBlock(
            r=b.r, c=b.c, bsize=b.bsize, y_mode=b.y_mode,
            uv_mode=b.uv_mode, skip=b.skip,
            angle_y=b.angle_y, angle_uv=b.angle_uv,
            is_inter=b.is_inter, ref=b.ref_frame[0], mode=b.inter_mode,
            mv=tuple(b.mv), ref_mv_idx=b.ref_mv_idx,
            motion_mode=b.motion_mode, interp=b.interp_filter[0],
            ref2=b.ref_frame[1], mv2=tuple(b.mv2),
            compound_idx=b.compound_idx,
            skip_mode=getattr(b, "skip_mode", False))
        eb.cfl_alphas = b.cfl_alphas
        eb.cfl = b.cfl_alphas
        eb.filter_intra = b.filter_intra
        if not b.is_inter:
            # intra tx depth from tx_size
            tx = T.MAX_TX_SIZE_RECT[b.bsize]
            depth = 0
            while tx != b.tx_size and depth < 2:
                tx = T.SPLIT_TX_SIZE[tx]
                depth += 1
            eb.tx_depth = depth
        out.append(eb)
    return out


def main():
    path, fidx = sys.argv[1], int(sys.argv[2])
    dmx = WebMDemuxer(path)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    be = AV1Backend(vt)
    # fidx counts CODED frames (a packet can bundle a no-show frame
    # with the next shown frame): intercept the fidx-th _decode_frame
    target = {}
    count = [0]
    orig_df = AV1Backend._decode_frame

    class _Stop(Exception):
        pass

    def df(self, hdr_, payloads, ts):
        if count[0] == fidx:
            target["hdr"] = hdr_
            target["tiles"] = self._split_tiles(hdr_, payloads)
            raise _Stop()
        count[0] += 1
        return orig_df(self, hdr_, payloads, ts)
    AV1Backend._decode_frame = df
    try:
        for pk in pkts:
            be.decode([pk], 0)
    except _Stop:
        pass
    finally:
        AV1Backend._decode_frame = orig_df
    hdr = target.get("hdr")
    tiles = target.get("tiles")
    seq = be.seq
    plan = FramePlan(
        width=hdr.upscaled_width, height=hdr.frame_height,
        mi_cols=hdr.mi_cols, mi_rows=hdr.mi_rows,
        subsampling_x=1, subsampling_y=1,
        y_mode=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        uv_mode=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        angle_y=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        angle_uv=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        skip=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8),
        bsize=np.zeros((hdr.mi_rows, hdr.mi_cols), np.int8))
    inherited = None
    if hdr.primary_ref_frame != C.PRIMARY_REF_NONE:
        inherited = be._resolve_saved_cdf(
            hdr.ref_frame_idx[hdr.primary_ref_frame])
    cdf = (inherited.copy() if inherited is not None
           else CdfContext.default(hdr.quant.base_q_idx))
    enc_cdf = (inherited.copy() if inherited is not None
               else CdfContext.default(hdr.quant.base_q_idx))
    dec = TileDecoder(seq, hdr, cdf, plan)
    tpl = None
    if hdr.use_ref_frame_mvs:
        from easyav1.video.av1.mfmv import setup_motion_field
        tpl = setup_motion_field(
            hdr, seq, [s if s.valid else None for s in be.hp.refs],
            be._ref_tmvs)
        dec.tpl_mv, dec.tpl_off = tpl
    dec.decode_tile(tiles[0], 0, 0)
    print(f"decoded {len(plan.blocks)} blocks; consumed "
          f"{dec.msac.bit_pos}/{len(tiles[0]) * 8} bits")

    enc = PlanReencoder(plan, hdr, seq,
                        ref_select=getattr(hdr, "reference_select", False),
                        jnt=getattr(seq, "enable_jnt_comp", False))
    enc.cdf = enc_cdf.t
    if getattr(hdr, "skip_mode_present", False):
        enc.skip_mode_present = True
        enc.skip_mode_frames = tuple(hdr.skip_mode_frames)
    if tpl is not None:
        enc.tpl_mv, enc.tpl_off = tpl
    tile2 = enc.encode_blocks(blocks_from_plan(plan))
    orig = tiles[0]
    n = min(len(orig), len(tile2))
    first_diff = None
    for i in range(n):
        if orig[i] != tile2[i]:
            x = orig[i] ^ tile2[i]
            bit = i * 8 + (7 - x.bit_length() + 1)
            first_diff = i * 8 + (8 - x.bit_length())
            break
    if first_diff is None:
        print(f"re-encode MATCHES for {n} bytes "
              f"(orig {len(orig)}, ours {len(tile2)})")
        return
    print(f"first differing bit: {first_diff} (byte {first_diff // 8})")
    # map to block
    prev = None
    for (bp, r, c) in enc.bitlog:
        if bp > first_diff:
            break
        prev = (bp, r, c)
    print(f"block at/before diff: {prev}")
    nxt = [e for e in enc.bitlog if e[0] > first_diff][:1]
    print(f"next block: {nxt}")


if __name__ == "__main__":
    main()
