"""Real multi-stream AV1 decode with a mesh-sharded device postfilter.

BASELINE config-5 shape (N concurrent streams batched on one chip /
mesh), on REAL bitstream content: each stream is a genuine AV1
temporal unit (from the in-repo synthetic encoder or any other
source), entropy-decoded and reconstructed by the production host
pipeline; the deblocking + CDEF postfilter then runs ONCE for all
streams as a vmapped jit whose stream axis is sharded over the mesh's
``dp`` axis (independent streams: XLA keeps the step collective-free,
each device filters its own streams' planes).

Used by ``__graft_entry__.dryrun_multichip`` and
``tests/test_multistream.py``; both validate the sharded result
bit-exactly against each stream's ordinary single-stream decode.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from easyav1.video.av1 import constants as C


def make_stream_tu(s: int, w: int = 64, h: int = 64) -> bytes:
    """A small real AV1 intra temporal unit with per-stream content,
    quantizer, loop-filter levels and CDEF strengths."""
    from easyav1.video.av1.av1_enc import EncBlock, encode_frame

    rng = np.random.default_rng(1000 + s)
    blocks = []
    for r in range(0, h // 4, 4):
        for c in range(0, w // 4, 4):
            n = int(rng.integers(2, 9))
            coeffs = [[(int(rng.integers(1, 12)),
                        int(rng.integers(0, 2))) for _ in range(n)]]
            blocks.append(EncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                                   skip=False, luma_coeffs=coeffs))
    lf = (2 + (s % 4), 1 + (s % 3))
    cdef = (3, [(1 + (s % 3), 1, 2 - (s & 1), 1)])
    return encode_frame(w, h, 36 + 2 * s, blocks, lf_levels=lf,
                        cdef=cdef)


def decode_tu_unfiltered(tu: bytes):
    """Production python decode of one TU with the postfilters NOT
    applied: returns (seq, hdr, plan, aligned_planes)."""
    from easyav1.container.webm import TrackInfo
    from easyav1.video.av1.backend import AV1Backend
    from easyav1.video.av1.cdf import CdfContext
    from easyav1.video.av1.headers import (parse_sequence_header,
                                               split_obus, HeaderParser)
    from easyav1.video.av1.recon_ref import FrameRecon
    from easyav1.video.av1.tile import FramePlan, TileDecoder

    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    hdr = None
    tiles = None
    for obu in split_obus(tu):
        if obu.type == C.OBU_SEQUENCE_HEADER:
            be.seq = parse_sequence_header(obu.payload)
            be.hp = HeaderParser(be.seq)
        elif obu.type == C.OBU_FRAME:
            hdr = be._parse_frame_header(obu.payload)
            byte_off = (hdr.header_bit_offset + 7) // 8
            tiles = be._split_tiles(hdr, [obu.payload[byte_off:]])
    seq = be.seq
    plan = FramePlan(
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
    cdf = CdfContext.default(hdr.quant.base_q_idx)
    dec = TileDecoder(seq, hdr, cdf, plan)
    for tn, td in enumerate(tiles):
        dec.decode_tile(td, tn // hdr.tile.cols, tn % hdr.tile.cols)
    recon = FrameRecon(seq, hdr, plan)
    aligned = recon.run_aligned()
    return seq, hdr, plan, aligned


def _cdef_idx_grid(plan, mi_rows, mi_cols):
    gh = (mi_rows + 15) // 16
    gw = (mi_cols + 15) // 16
    g = np.full((gh, gw), -1, np.int32)
    for (r, c), idx in plan.cdef_idx.items():
        g[r // 16, c // 16] = idx
    return g


def batched_postfilter(mesh, frames):
    """frames: list of (seq, hdr, plan, aligned_planes) sharing
    geometry and bitdepth.  Runs LF + CDEF for all streams in one
    vmapped jit sharded over the mesh's dp axis; returns per-stream
    filtered planes (numpy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from easyav1.video.av1.lf_ref import LoopFilter
    from easyav1.video.av1.recon.cdef_jax import unit_maps
    from easyav1.video.av1.recon.postfilter_fused import (
        _cdef_stage, _lf_size_maps, _lf_stage)

    seq0, hdr0, _, planes0 = frames[0]
    bd = seq0.color.bitdepth
    num_planes = len(planes0)
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes0)
    ssx, ssy = seq0.color.subsampling_x, seq0.color.subsampling_y
    damping = frames[0][1].cdef.damping + (bd - 8)

    per_stream = []
    for seq, hdr, plan, planes in frames:
        assert hdr.cdef.damping == hdr0.cdef.damping, \
            "streams must share cdef damping (vary strengths instead)"
        lf = LoopFilter(hdr, seq, plan, bd)

        def grids_for(p, shape, lf=lf):
            return lf._build_grids(p, shape)

        sv, sh_, lv, lh = _lf_size_maps(hdr, bd, dims, num_planes,
                                        grids_for)
        cd = hdr.cdef
        cs = bd - 8
        filt, idxm = unit_maps(
            plan.skip, _cdef_idx_grid(plan, hdr.mi_rows, hdr.mi_cols),
            hdr.mi_rows, hdr.mi_cols)
        safe = np.where(idxm >= 0, idxm, 0)
        sel = filt != 0
        mk = lambda v: (np.where(sel, np.array(v, np.int32)[safe], 0)
                        << cs).astype(np.int32)
        per_stream.append((
            [np.ascontiguousarray(p, np.int32) for p in planes],
            sv, sh_, lv, lh,
            mk(cd.y_pri_strength), mk(cd.y_sec_strength),
            mk(cd.uv_pri_strength), mk(cd.uv_sec_strength),
            filt.astype(np.int32)))

    # stack every leaf along the stream axis
    stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                           *per_stream)

    lf_fn = _lf_stage(dims, bd)
    cd_fn = _cdef_stage(dims, bd, ssx, ssy, damping, True)

    def one(args):
        planes, sv, sh_, lv, lh, py, sy, pu, su, filt = args
        x = lf_fn(planes, sv, sh_, lv, lh)
        return cd_fn(x, py, sy, pu, su, filt)

    shard = NamedSharding(mesh, P("dp"))
    step = jax.jit(jax.vmap(one), in_shardings=(shard,),
                   out_shardings=shard)
    out = step(stacked)
    return [[np.asarray(out[p][s]) for p in range(num_planes)]
            for s in range(len(frames))]


def decode_frames_unfiltered_native(path: str, max_frames: int):
    """C entropy + recon of a real WebM stream with LF/CDEF suppressed
    (the device-postfilter split of EASYAV1_PIPE=device, but collected
    for cross-stream batching).  Intra streams only (no ref chain).

    Yields per frame: (seq, hdr, aligned int32 planes,
    lf_grids(plane, shape) closure-ready data, skip_grid, cdef_grid).
    """
    import ctypes

    from easyav1 import native as nat
    from easyav1.container import TrackType, WebMDemuxer

    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    pkts = pkts[:max_frames]

    from easyav1.video.av1.headers import (HeaderParser,
                                               parse_sequence_header,
                                               split_obus)
    lib = nat._load()
    assert lib is not None
    seq = hp = None
    out_frames = []
    for pk in pkts:
        hdr = None
        tiles = None
        for obu in split_obus(pk):
            if obu.type == C.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(obu.payload)
                hp = HeaderParser(seq)
            elif obu.type in (C.OBU_FRAME, C.OBU_FRAME_HEADER):
                hdr = hp.parse_frame_header(obu.payload)
                if obu.type == C.OBU_FRAME:
                    byte_off = (hdr.header_bit_offset + 7) // 8
                    tiles = [obu.payload[byte_off:]]
            elif obu.type == C.OBU_TILE_GROUP:
                tiles = (tiles or []) + [obu.payload]
        if hdr is None or not hdr.frame_is_intra:
            raise ValueError("multistream batch requires intra frames")
        if hdr.tile.cols * hdr.tile.rows > 1:
            # split tile groups like the backend does
            from easyav1.video.av1.backend import AV1Backend
            be = AV1Backend.__new__(AV1Backend)
            be.seq = seq
            tiles = be._split_tiles(hdr, tiles)
        res = nat._run_tiles(lib, seq, hdr, tiles)
        assert res is not None
        out, bufs, _blob, (fp_rc, keep_fp) = res
        rp = nat._build_rp(seq, hdr)
        aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
        ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
        pl = [np.zeros((ah, aw), np.uint16),
              np.zeros((ah >> ssy, aw >> ssx), np.uint16),
              np.zeros((ah >> ssy, aw >> ssx), np.uint16)]
        saved_lf = tuple(rp.lf_level)
        saved_cdef = rp.enable_cdef
        rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
        rp.enable_cdef = 0
        rfl = nat._RefPlanes()
        rc = lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                                 ctypes.byref(fp_rc), ctypes.byref(rfl),
                                 nat._vp(pl[0]), nat._vp(pl[1]),
                                 nat._vp(pl[2]))
        assert rc == 0
        rp.lf_level = (ctypes.c_int32 * 4)(*saved_lf)
        rp.enable_cdef = saved_cdef
        # postfilter params must be snapshotted: `out`/`bufs` are
        # per-geometry pooled buffers reused by the next _run_tiles
        n_pl = seq.color.num_planes
        dims = tuple((int(p.shape[0]), int(p.shape[1]))
                     for p in pl[:n_pl])
        grids = {p: nat._grids_exporter(lib, rp, out)(p, dims[p])
                 for p in range(n_pl)}
        out_frames.append((
            seq, hdr,
            pl[:n_pl],            # uint16: halves the H2D volume;
                                  # postfilter casts to int32 on device
            grids, bufs["grids"]["skip"].copy(), bufs["cdef"].copy()))
    return out_frames


def batched_postfilter_real(mesh, batch):
    """One vmapped, dp-sharded LF+CDEF step over same-geometry frames
    from different streams.  batch: list of
    (seq, hdr, planes, grids, skip_grid, cdef_grid).  Returns
    per-stream filtered planes (device arrays)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from easyav1.video.av1.recon.cdef_jax import unit_maps
    from easyav1.video.av1.recon.postfilter_fused import (
        _cdef_stage, _lf_size_maps, _lf_stage)

    seq0, planes0 = batch[0][0], batch[0][2]
    bd = seq0.color.bitdepth
    num_planes = len(planes0)
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes0)
    ssx, ssy = seq0.color.subsampling_x, seq0.color.subsampling_y

    # CDEF damping is a static kernel parameter: group streams by it
    # and run one vmapped sharded step per group (streams of one
    # config ladder share it; mixed ladders still batch per value)
    by_damp: dict = {}
    for i, (seq, hdr, planes, grids, skip_g, cdef_g) in enumerate(batch):
        by_damp.setdefault(hdr.cdef.damping, []).append(i)

    results = [None] * len(batch)
    n_dp = int(mesh.shape["dp"])
    for damp, idxs in by_damp.items():
        # shard the stream axis over dp when it divides evenly;
        # odd-sized groups run replicated (correct, just unsharded)
        shard = NamedSharding(
            mesh, P("dp") if len(idxs) % n_dp == 0 else P())
        per_stream = []
        for i in idxs:
            seq, hdr, planes, grids, skip_g, cdef_g = batch[i]
            sv, sh_, lv, lh = _lf_size_maps(
                hdr, bd, dims, num_planes, lambda p, shape: grids[p])
            cd = hdr.cdef
            cs = bd - 8
            filt, idxm = unit_maps(skip_g, cdef_g, hdr.mi_rows,
                                   hdr.mi_cols)
            safe = np.where(idxm >= 0, idxm, 0)
            sel = filt != 0
            mk = lambda v: (np.where(sel,
                                     np.array(v, np.int32)[safe], 0)
                            << cs).astype(np.int32)
            per_stream.append((
                [np.asarray(p, np.int32) for p in planes],
                sv, sh_, lv, lh,
                mk(cd.y_pri_strength), mk(cd.y_sec_strength),
                mk(cd.uv_pri_strength), mk(cd.uv_sec_strength),
                filt.astype(np.int32)))
        # pad LF edge maps to the kernel's expected edge count (a
        # stream with LF off has zero-width grids; zero size =
        # identity filtering, so zero-padding is exact)
        for slot in (1, 2, 3, 4):       # sv, sh_, lv, lh
            for p in range(num_planes):
                ph_, pw_ = dims[p]
                ne = (pw_ if slot in (1, 3) else ph_) // 4 - 1
                for ps in per_stream:
                    ps[slot][p] = np.pad(
                        ps[slot][p],
                        [(0, 0)] * (ps[slot][p].ndim - 1)
                        + [(0, max(ne, 0) - ps[slot][p].shape[-1])])
        stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                               *per_stream)
        lf_fn = _lf_stage(dims, bd)
        cd_fn = _cdef_stage(dims, bd, ssx, ssy, damp + (bd - 8), True)

        def one(args):
            planes, sv, sh_, lv, lh, py, sy, pu, su, filt = args
            x = lf_fn(planes, sv, sh_, lv, lh)
            return cd_fn(x, py, sy, pu, su, filt)

        step = jax.jit(jax.vmap(one), in_shardings=(shard,),
                       out_shardings=shard)
        out = step(stacked)
        for k, i in enumerate(idxs):
            results[i] = [out[p][k] for p in range(num_planes)]
    # transpose to [plane][stream] like the callers index: outs[k][p][s]
    return [[results[s][p] for s in range(len(batch))]
            for p in range(num_planes)]


def batched_postfilter_loop(mesh, batch):
    """Per-stream LF+CDEF dispatch, round-robin over the mesh devices
    (dp without collectives: each stream's planes live and filter on
    its own device; all devices run concurrently via async dispatch).
    Same result as batched_postfilter_real, with one dispatch per
    stream instead of one vmapped step."""
    import jax
    import jax.numpy as jnp

    from easyav1.video.av1.recon.cdef_jax import unit_maps
    from easyav1.video.av1.recon.postfilter_fused import (
        _cdef_stage, _lf_size_maps, _lf_stage)

    devices = list(mesh.devices.flat)
    seq0, planes0 = batch[0][0], batch[0][2]
    bd = seq0.color.bitdepth
    num_planes = len(planes0)
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes0)
    ssx, ssy = seq0.color.subsampling_x, seq0.color.subsampling_y

    results = []
    for i, (seq, hdr, planes, grids, skip_g, cdef_g) in enumerate(batch):
        dev = devices[i % len(devices)]
        sv, sh_, lv, lh = _lf_size_maps(
            hdr, bd, dims, num_planes, lambda p, shape: grids[p])
        # LF-off frames carry zero-width edge maps; pad to the
        # kernel's expected edge count (zero size = identity)
        for maps, vert in ((sv, True), (sh_, False), (lv, True),
                           (lh, False)):
            for p in range(num_planes):
                ph_, pw_ = dims[p]
                ne = (pw_ if vert else ph_) // 4 - 1
                maps[p] = np.pad(
                    maps[p], [(0, 0)] * (maps[p].ndim - 1)
                    + [(0, max(ne, 0) - maps[p].shape[-1])])
        cd = hdr.cdef
        cs = bd - 8
        filt, idxm = unit_maps(skip_g, cdef_g, hdr.mi_rows,
                               hdr.mi_cols)
        safe = np.where(idxm >= 0, idxm, 0)
        sel = filt != 0
        mk = lambda v: (np.where(sel, np.array(v, np.int32)[safe], 0)
                        << cs).astype(np.int32)
        put = lambda x: jax.device_put(np.asarray(x), dev)
        pls = [put(p).astype(jnp.int32) for p in planes]
        x = _lf_stage(dims, bd)(
            pls, [put(s) for s in sv], [put(s) for s in sh_],
            [put(s) for s in lv], [put(s) for s in lh])
        out = _cdef_stage(dims, bd, ssx, ssy,
                          cd.damping + cs, True)(
            x, put(mk(cd.y_pri_strength)), put(mk(cd.y_sec_strength)),
            put(mk(cd.uv_pri_strength)), put(mk(cd.uv_sec_strength)),
            put(filt.astype(np.int32)))
        results.append(out)
    # transpose to [plane][stream] like batched_postfilter_real
    return [[results[s][p] for s in range(len(batch))]
            for p in range(num_planes)]


def run_multistream_real(mesh, paths, max_frames: int = 4,
                         check: bool = True):
    """BASELINE config-5 at real scale: decode N real WebM streams
    (C entropy+recon on host, LF+CDEF batched on the mesh), one
    vmapped device step per frame index across all streams.

    Returns (n_streams, total_frames, wall_seconds).  check=True
    verifies every frame bit-exact against the ordinary single-stream
    native decode."""
    import time

    import jax

    streams = [decode_frames_unfiltered_native(p, max_frames)
               for p in paths]
    n_frames = min(len(s) for s in streams)
    t0 = time.perf_counter()
    outs = []
    for k in range(n_frames):
        outs.append(batched_postfilter_real(
            mesh, [s[k] for s in streams]))
    jax.tree_util.tree_map(lambda a: a.block_until_ready(), outs)
    wall = time.perf_counter() - t0
    if check:
        _verify_multistream_real(paths, streams, outs, n_frames)
    return len(paths), len(paths) * n_frames, wall


def _verify_multistream_real(paths, streams, outs, n_frames):
    import os

    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    for s, path in enumerate(paths):
        os.environ["EASYAV1_PIPE"] = "native"
        dmx = WebMDemuxer(str(path))
        vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
        pkts = []
        while (p := dmx.read_packet()) is not None:
            if p.track == vt.number:
                pkts.extend(p.frames)
        be = AV1Backend(vt)
        for k in range(n_frames):
            ref = be.decode([pkts[k]], 0)[0]
            hdr = streams[s][k][1]
            hh, ww = hdr.frame_height, hdr.upscaled_width
            sq = streams[s][k][0]
            cw = (ww + sq.color.subsampling_x) >> sq.color.subsampling_x
            chh = (hh + sq.color.subsampling_y) >> sq.color.subsampling_y
            crops = ((hh, ww), (chh, cw), (chh, cw))
            for p in range(len(ref.data)):
                got = np.asarray(outs[k][p][s])[:crops[p][0],
                                                :crops[p][1]]
                want = np.asarray(ref.data[p]).astype(np.int32)
                assert np.array_equal(got, want), \
                    f"stream {s} frame {k} plane {p}"


def run_multistream(mesh, n_streams: int, w: int = 64, h: int = 64,
                    check: bool = True) -> int:
    """End-to-end: synthesize + decode n_streams real AV1 streams,
    batch the device postfilter over the mesh, and (optionally) verify
    each stream bit-exact vs its ordinary single-stream decode.
    Returns the number of verified streams."""
    from easyav1.container.webm import TrackInfo
    from easyav1.video.av1.backend import AV1Backend

    tus = [make_stream_tu(s, w, h) for s in range(n_streams)]
    frames = [decode_tu_unfiltered(tu) for tu in tus]
    filtered = batched_postfilter(mesh, frames)
    if not check:
        return n_streams
    for s, tu in enumerate(tus):
        be = AV1Backend(TrackInfo(number=1, type=None,
                                  codec_id="V_AV1"))
        ref = be.decode([tu], 0)[0]
        hdr = frames[s][1]
        hh, ww = hdr.frame_height, hdr.upscaled_width
        cw = (ww + frames[s][0].color.subsampling_x) >> \
            frames[s][0].color.subsampling_x
        chh = (hh + frames[s][0].color.subsampling_y) >> \
            frames[s][0].color.subsampling_y
        crops = ((hh, ww), (chh, cw), (chh, cw))
        for p in range(len(ref.data)):
            got = filtered[s][p][:crops[p][0], :crops[p][1]]
            want = np.asarray(ref.data[p]).astype(np.int32)
            d = np.abs(got - want)
            assert d.max() == 0, (
                f"stream {s} plane {p}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")
    return n_streams
