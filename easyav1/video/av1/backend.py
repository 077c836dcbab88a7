"""AV1 decoder backend: OBU stream -> decoded frames.

Fills the dav1d role behind the API layer (reference easyav1.c:2360-2432
decode_video path). Current scope: intra frames (keyframes /
intra-only), 8-bit 4:2:0; the coverage ladder widens with the fixture
ladder in tests/test_av1.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from easyav1.container.webm import TrackInfo
from easyav1.settings import (BitsPerColor, ChromaSamplePosition,
                                  ColorPrimaries, ColorSpace,
                                  MatrixCoefficients, PixelLayout,
                                  TransferCharacteristics)
from easyav1.types import VideoFrame, VideoFrameProperties
from easyav1.video.av1 import constants as C
from easyav1.video.av1.bitreader import BitReader
from easyav1.video.av1.cdf import CdfContext
from easyav1.video.av1.headers import (FrameHeader, HeaderParser,
                                           SequenceHeader, parse_sequence_header,
                                           split_obus)
from easyav1.video.av1.recon_ref import FrameRecon
from easyav1.video.av1.tile import FramePlan, TileDecoder


class AV1DecodeError(Exception):
    pass


class _FpPlanes:
    """Plane list of a frame whose reconstruction is still running on
    the frame-parallel worker; joins on first access (the dav1d
    frame-threading output contract: get_picture blocks until the
    frame task completes).  `which`: "display" = post-grain output
    planes, "ref" = pre-grain cropped recon planes."""

    __slots__ = ("_fut", "_np", "_which")

    def __init__(self, fut, which="display"):
        self._fut = fut
        self._np = None
        self._which = which

    def _mat(self):
        if self._np is None:
            disp, triples = self._fut.result()
            if self._which == "display":
                self._np = disp
            else:
                self._np = [a[:h, :w] for (a, w, h) in triples]
            self._fut = None
        return self._np

    def __len__(self):
        return len(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


class AV1Backend:
    def __init__(self, track: TrackInfo, threads: int = 0):
        self.track = track
        # tile-parallel entropy worker count; 0 = auto (cpu count,
        # dav1d-auto analog easyav1.c:1401-1408), EASYAV1_THREADS
        # still overrides inside native.decode_threads()
        self.threads = threads
        # frame-parallel decode (dav1d frame-threading analog,
        # thread_task.c frame tasks): frame N's C recon runs on a
        # single worker thread while frame N+1's entropy decode runs
        # on the caller thread.  The two phases share no mutable
        # state: entropy alternates buffer-pool generations, recon
        # reads the ref planes of FIFO-earlier frames only.
        import os
        fp_env = os.environ.get("EASYAV1_FRAME_PARALLEL")
        if fp_env is not None:
            self._fp_on = fp_env not in ("", "0")
        else:
            # dav1d default-settings analog (easyav1.c:1401-1408 opens
            # with auto worker count): pipeline frames whenever the
            # host has cores to overlap on and threading wasn't
            # explicitly disabled
            self._fp_on = (os.cpu_count() or 1) >= 2 and threads != 1
        self._fp_exec = None
        self._fp_gen = 0
        self._fp_q: list = []      # in-flight recon futures, FIFO
        self.seq: Optional[SequenceHeader] = None
        self.hp: Optional[HeaderParser] = None
        self._out_refs: List[Optional[VideoFrame]] = [None] * C.NUM_REF_FRAMES
        # reference plane store per slot (cropped uint8 planes)
        self._ref_planes: List[Optional[list]] = [None] * C.NUM_REF_FRAMES
        # uint16 copies for the native C motion-compensation path
        self._ref_u16: List[Optional[list]] = [None] * C.NUM_REF_FRAMES
        # per-slot saved entropy contexts (spec frame_end_update_cdf /
        # load_cdfs via primary_ref_frame)
        self._ref_cdfs: List[Optional[CdfContext]] = \
            [None] * C.NUM_REF_FRAMES
        # per-slot saved 8x8 motion fields (spec SavedMvs/SavedRefFrames)
        self._ref_tmvs: List[Optional[tuple]] = [None] * C.NUM_REF_FRAMES
        # cached device film-grain synthesizer (keyed by grain params)
        self._dev_fg: Optional[tuple] = None

    # -- VideoBackend interface -------------------------------------------

    def decode(self, chunks: List[bytes], timestamp_ms: int) -> List[VideoFrame]:
        frames = []
        for chunk in chunks:
            frames.extend(self._decode_temporal_unit(chunk, timestamp_ms))
        return frames

    def flush(self) -> None:
        self._fp_join()

    # -- frame-parallel machinery -----------------------------------------

    def _fp_join(self) -> None:
        """Wait for all in-flight frame-parallel recons and resolve
        pending ref-slot triples to concrete arrays."""
        for fut in self._fp_q:
            fut.result()
        self._fp_q.clear()
        for i, s in enumerate(self._ref_u16):
            if isinstance(s, tuple) and len(s) == 2 and s[0] == "fut":
                self._ref_u16[i] = s[1].result()[1]

    @staticmethod
    def _fp_resolve(slot):
        if isinstance(slot, tuple) and len(slot) == 2 \
                and slot[0] == "fut":
            return slot[1].result()[1]
        return slot

    def _decode_frame_fp(self, hdr: FrameHeader, tiles, ts: int,
                         init_blob, want_cdf, tpl):
        """Frame-parallel decode attempt: entropy on this thread,
        recon submitted to the worker; returns (handled, frame)."""
        from easyav1 import native

        seq = self.seq
        # two buffer generations: frame N+2's entropy reuses frame N's
        # generation, so frame N's recon must be done before it starts
        # (1 recon running + 1 queued at most)
        while len(self._fp_q) >= 2:
            self._fp_q.pop(0).result()
        eres = native.decode_entropy_native(
            seq, hdr, tiles, cdf_in=init_blob, want_cdf=want_cdf,
            tpl=tpl, threads=self.threads, gen=self._fp_gen)
        if eres is None:
            # C decoder declined: the sync fallbacks need concrete
            # refs, so drain the pipeline first
            self._fp_join()
            return False, None
        self._fp_gen ^= 1
        out, bufs, out_blob, mv_grids, rp_pack = eres
        if self._fp_exec is None:
            from concurrent.futures import ThreadPoolExecutor
            self._fp_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="av1-frame")
        ref_snap = list(self._ref_u16)
        fg = getattr(hdr, "film_grain", None)
        apply_fg = fg is not None and fg.apply_grain

        def work():
            refs = [self._fp_resolve(s) for s in ref_snap]
            planes, ref_triples = native.recon_native_phase(
                seq, hdr, out, bufs, rp_pack, refs)
            disp = planes
            if apply_fg:
                disp = native.film_grain_native(fg, seq, planes)
                if disp is None:
                    from easyav1.video.av1.fg_ref import FilmGrain
                    disp = FilmGrain(fg, seq,
                                     seq.color.bitdepth).apply(planes)
            return disp, ref_triples

        fut = self._fp_exec.submit(work)
        self._fp_q.append(fut)

        if not want_cdf:
            out_blob = (init_blob if init_blob is not None
                        else self._default_blob(hdr.quant.base_q_idx))
        frame = self._make_frame(_FpPlanes(fut), hdr, ts,
                                 grain_done=True)
        from easyav1.video.av1.mfmv import save_tmvs
        if mv_grids is not None:
            tmvs = save_tmvs(hdr, mv_grids[0], mv_grids[1],
                             mv_grids[2])
        else:
            h8 = (hdr.mi_rows + 1) >> 1
            w8 = (hdr.mi_cols + 1) >> 1
            tmvs = (np.full((h8, w8), C.NONE_FRAME, np.int8),
                    np.zeros((h8, w8, 2), np.int16))
        self.hp.update_refs(hdr)
        for i in range(C.NUM_REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self._out_refs[i] = frame
                # pre-grain planes (spec 7.18.1: refs stay grain-free)
                self._ref_planes[i] = _FpPlanes(fut, which="ref")
                self._ref_u16[i] = ("fut", fut)
                self._ref_cdfs[i] = out_blob
                self._ref_tmvs[i] = tmvs
        return True, (frame if hdr.show_frame else None)

    def probe_sequence_header(self, chunks: List[bytes]) -> bool:
        for chunk in chunks:
            try:
                for obu in split_obus(chunk):
                    if obu.type == C.OBU_SEQUENCE_HEADER:
                        return True
            except Exception:  # noqa: BLE001
                return False
        return False

    # ------------------------------------------------------------------

    def _decode_temporal_unit(self, data: bytes, ts: int) -> List[VideoFrame]:
        out = []
        hdr: Optional[FrameHeader] = None
        tile_payloads: List[bytes] = []
        for obu in split_obus(data):
            if obu.type == C.OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(obu.payload)
                self.hp = HeaderParser(self.seq)
            elif obu.type == C.OBU_FRAME_HEADER:
                hdr = self._parse_frame_header(obu.payload)
                if hdr.show_existing_frame:
                    f = self._show_existing(hdr, ts)
                    if f is not None:
                        out.append(f)
                    hdr = None
            elif obu.type == C.OBU_FRAME:
                hdr = self._parse_frame_header(obu.payload)
                offset_bits = hdr.header_bit_offset
                byte_off = (offset_bits + 7) // 8
                tile_payloads = [obu.payload[byte_off:]]
                f = self._decode_frame(hdr, tile_payloads, ts)
                if f is not None:
                    out.append(f)
                hdr = None
                tile_payloads = []
            elif obu.type == C.OBU_TILE_GROUP:
                tile_payloads.append(obu.payload)
                # a frame may split its tiles across several tile-group
                # OBUs (spec 5.11.1); decode once the group carrying the
                # last tile arrives (reference behavior: dav1d
                # accumulates TGs until n_tiles are present)
                if hdr is not None and self._tg_is_last(hdr, obu.payload):
                    f = self._decode_frame(hdr, tile_payloads, ts)
                    if f is not None:
                        out.append(f)
                    hdr = None
                    tile_payloads = []
        return out

    def _parse_frame_header(self, payload: bytes) -> FrameHeader:
        if self.hp is None:
            raise AV1DecodeError("no sequence header before frame header")
        return self.hp.parse_frame_header(payload)

    def _show_existing(self, hdr: FrameHeader, ts: int) -> Optional[VideoFrame]:
        f = self._out_refs[hdr.frame_to_show_map_idx]
        if f is None:
            return None
        return VideoFrame(properties=f.properties, timestamp=ts, data=f.data)

    # ------------------------------------------------------------------

    def _empty_plan(self, hdr: FrameHeader) -> FramePlan:
        seq = self.seq
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

    def _decode_frame(self, hdr: FrameHeader, tile_payloads: List[bytes],
                      ts: int) -> Optional[VideoFrame]:
        seq = self.seq
        plan = None   # built lazily: only the non-native fallbacks use it
        tiles = self._split_tiles(hdr, tile_payloads)
        from easyav1 import native
        from easyav1.native.cdf_layout import blob_to_cdf, cdf_to_blob
        # entropy context: inherit the primary ref's saved state (spec
        # load_cdfs) or reset to the per-q defaults.  States are kept as
        # packed blobs — the same bytes feed the C decoder (CdfState
        # memcpy) and the Python decoder (blob_to_cdf), so the two
        # entropy engines chain interchangeably across frames.
        init_blob: Optional[bytes] = None
        if hdr.primary_ref_frame != C.PRIMARY_REF_NONE:
            init_blob = self._ref_cdfs[
                hdr.ref_frame_idx[hdr.primary_ref_frame]]
        want_cdf = (not hdr.disable_frame_end_update_cdf
                    and hdr.refresh_frame_flags != 0)
        # temporal mv projection (host-side numpy; feeds C and Python)
        tpl = None
        if hdr.use_ref_frame_mvs:
            from easyav1.video.av1.mfmv import setup_motion_field
            tpl = setup_motion_field(
                hdr, seq, [s if s.valid else None for s in self.hp.refs],
                self._ref_tmvs)
        out_blob: Optional[bytes] = None
        planes = None
        nat_grids = None
        planes16 = None
        if self._fp_on:
            handled, f = self._decode_frame_fp(hdr, tiles, ts,
                                               init_blob, want_cdf,
                                               tpl)
            if handled:
                return f
        res = native.decode_and_recon_native(
            seq, hdr, tiles, cdf_in=init_blob, want_cdf=want_cdf,
            tpl=tpl, refs=self._ref_u16, want_u16=True,
            threads=self.threads)
        if res is not None:
            if len(res) == 4:
                planes, out_blob, nat_grids, planes16 = res
            else:
                planes, out_blob, nat_grids = res
        if planes is None:
            plan = self._empty_plan(hdr)
            nres = native.decode_frame_native(
                seq, hdr, plan, tiles, cdf_in=init_blob,
                want_cdf=want_cdf, tpl=tpl, threads=self.threads)
            if nres is None:
                init_cdf = (blob_to_cdf(init_blob)
                            if init_blob is not None
                            else CdfContext.default(hdr.quant.base_q_idx))
                end_cdf = init_cdf
                dec = TileDecoder(seq, hdr, init_cdf, plan)
                if tpl is not None:
                    dec.tpl_mv, dec.tpl_off = tpl
                n_cols = hdr.tile.cols
                update_tid = hdr.tile.context_update_tile_id
                for tile_num, tdata in enumerate(tiles):
                    tcdf = init_cdf.copy()
                    dec.cdf = tcdf.t
                    dec.decode_tile(tdata, tile_num // n_cols,
                                    tile_num % n_cols)
                    if tile_num == update_tid and \
                            not hdr.disable_frame_end_update_cdf:
                        end_cdf = tcdf
                if want_cdf:
                    # spec: saved contexts carry probs, not counts
                    # (av1_reset_cdf_symbol_counters)
                    end_cdf.reset_counters()
                    out_blob = cdf_to_blob(end_cdf)
            elif want_cdf:
                out_blob = nres
            recon = FrameRecon(seq, hdr, plan, refs=self._ref_planes)
            aligned = recon.run_aligned()
            from easyav1.video.av1.lf_ref import LoopFilter
            from easyav1.video.av1.cdef_ref import Cdef
            LoopFilter(hdr, seq, plan, seq.color.bitdepth).apply(aligned)
            uses_lr = getattr(getattr(hdr, "lr", None), "uses_lr", False)
            deblocked = [p.copy() for p in aligned] if uses_lr else None
            Cdef(hdr, seq, plan, seq.color.bitdepth).apply(aligned)
            if getattr(hdr, "use_superres", False):
                # spec 7.16: horizontal upscale between CDEF and LR;
                # LR's deblocked stripe context upscales identically
                from easyav1.video.av1.superres_ref import \
                    superres_upscale
                aligned = superres_upscale(aligned, hdr, seq)
                if deblocked is not None:
                    deblocked = superres_upscale(deblocked, hdr, seq)
            if uses_lr:
                from easyav1.video.av1.lr_ref import LoopRestoration
                LoopRestoration(hdr, seq, plan,
                                seq.color.bitdepth).apply(aligned, deblocked)
            planes = recon.crop(aligned)
        if not want_cdf:
            # spec: when frame-end update is disabled the INIT state is
            # what a later frame inherits
            out_blob = (init_blob if init_blob is not None
                        else self._default_blob(hdr.quant.base_q_idx))
        frame = self._make_frame(planes, hdr, ts)
        # per-8x8 motion storage for later temporal projection
        from easyav1.video.av1.mfmv import save_tmvs
        if nat_grids is not None:
            tmvs = save_tmvs(hdr, nat_grids[0], nat_grids[1],
                             nat_grids[2])
        elif hdr.frame_is_intra \
                or getattr(plan, "ref0_grid", None) is None:
            h8 = (hdr.mi_rows + 1) >> 1
            w8 = (hdr.mi_cols + 1) >> 1
            tmvs = (np.full((h8, w8), C.NONE_FRAME, np.int8),
                    np.zeros((h8, w8, 2), np.int16))
        else:
            tmvs = save_tmvs(hdr, plan.ref0_grid, plan.ref1_grid,
                             plan.mvs_grid)
        self.hp.update_refs(hdr)
        if hdr.refresh_frame_flags:
            # (plane, w, h) triples; native frames hand back their
            # mi-aligned recon buffers (no copy: C MC reads strided)
            u16 = (planes16 if planes16 is not None else
                   [(np.ascontiguousarray(p, np.uint16), p.shape[1],
                     p.shape[0]) for p in planes])
        for i in range(C.NUM_REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self._out_refs[i] = frame
                self._ref_planes[i] = planes
                self._ref_u16[i] = u16
                self._ref_cdfs[i] = out_blob
                self._ref_tmvs[i] = tmvs
        return frame if hdr.show_frame else None

    _DEFAULT_BLOBS: dict = {}

    @classmethod
    def _default_blob(cls, base_q_idx: int) -> bytes:
        """Packed default entropy state for the quantizer context."""
        from easyav1.native.cdf_layout import cdf_to_blob
        qctx = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 \
            else 2 if base_q_idx <= 120 else 3
        blob = cls._DEFAULT_BLOBS.get(qctx)
        if blob is None:
            blob = cdf_to_blob(CdfContext.default(base_q_idx))
            cls._DEFAULT_BLOBS[qctx] = blob
        return blob

    @staticmethod
    def _tg_is_last(hdr: FrameHeader, payload: bytes) -> bool:
        """True if this tile-group OBU carries the frame's last tile
        (tile_group header, spec 5.11.1)."""
        n_tiles = hdr.tile.cols * hdr.tile.rows
        if n_tiles == 1:
            return True
        r = BitReader(payload)
        if not r.f1():          # tile_start_and_end_present_flag
            return True         # single TG with all tiles
        bits = hdr.tile.cols_log2 + hdr.tile.rows_log2
        r.f(bits)               # tg_start
        return r.f(bits) == n_tiles - 1

    def _split_tiles(self, hdr: FrameHeader, payloads: List[bytes]) -> List[bytes]:
        """Tile group parsing (spec §5.11.1)."""
        n_tiles = hdr.tile.cols * hdr.tile.rows
        tiles: List[bytes] = []
        for payload in payloads:
            r = BitReader(payload)
            tg_start, tg_end = 0, n_tiles - 1
            if n_tiles > 1:
                flag = r.f1()
                if flag:
                    bits = hdr.tile.cols_log2 + hdr.tile.rows_log2
                    tg_start = r.f(bits)
                    tg_end = r.f(bits)
            r.byte_align()
            pos = r.pos // 8
            for tn in range(tg_start, tg_end + 1):
                if tn == tg_end:
                    tiles.append(payload[pos:])
                else:
                    size = int.from_bytes(
                        payload[pos:pos + hdr.tile.tile_size_bytes],
                        "little") + 1
                    pos += hdr.tile.tile_size_bytes
                    tiles.append(payload[pos:pos + size])
                    pos += size
        return tiles

    def _make_frame(self, planes, hdr: FrameHeader, ts: int,
                    grain_done: bool = False) -> VideoFrame:
        seq = self.seq
        cc = seq.color
        layout = {(1, 1): PixelLayout.YUV420, (1, 0): PixelLayout.YUV422,
                  (0, 0): PixelLayout.YUV444}.get(
            (cc.subsampling_x, cc.subsampling_y), PixelLayout.UNKNOWN)
        if cc.mono_chrome:
            layout = PixelLayout.YUV400
        props = VideoFrameProperties(
            pixel_layout=layout,
            bits_per_color={8: BitsPerColor.BITS_8, 10: BitsPerColor.BITS_10,
                            12: BitsPerColor.BITS_12}[cc.bitdepth],
            color_space=(ColorSpace.FULL if cc.color_range
                         else ColorSpace.LIMITED),
            color_primaries=_safe_enum(ColorPrimaries, cc.color_primaries),
            transfer_characteristics=_safe_enum(
                TransferCharacteristics, cc.transfer_characteristics),
            matrix_coefficients=_safe_enum(
                MatrixCoefficients, cc.matrix_coefficients),
            chroma_sample_position=_safe_enum(
                ChromaSamplePosition, cc.chroma_sample_position),
            width=hdr.upscaled_width, height=hdr.frame_height,
        )
        fg = getattr(hdr, "film_grain", None)
        out_planes = planes      # keep lazy device planes unmaterialized
        if fg is not None and fg.apply_grain and not grain_done:
            # grain is an output-only transform; reference frames stay
            # grain-free (spec 7.18.1)
            import os
            if os.environ.get("EASYAV1_PIPE", "native") in ("device",
                                                            "pallas"):
                # device pipe: grain synthesized on the device (fg_jax);
                # the synthesizer (grain templates + LUTs) is cached
                # across frames with unchanged grain params
                out_planes = self._film_grain_device(fg, seq, planes)
            else:
                from easyav1 import native
                out_planes = native.film_grain_native(fg, seq, out_planes)
            if out_planes is None:
                from easyav1.video.av1.fg_ref import FilmGrain
                out_planes = FilmGrain(fg, seq, cc.bitdepth).apply(planes)
        return VideoFrame(properties=props, timestamp=ts,
                          data=out_planes)

    def _film_grain_device(self, fg, seq, planes):
        import dataclasses
        key = tuple(tuple(v) if isinstance(v, list) else v
                    for v in (getattr(fg, f.name)
                              for f in dataclasses.fields(fg)))
        if self._dev_fg is None or self._dev_fg[0] != key:
            from easyav1.video.av1.recon.fg_jax import DeviceFilmGrain
            self._dev_fg = (key, DeviceFilmGrain(
                fg, seq, seq.color.bitdepth))
        return self._dev_fg[1].apply(list(planes))


def _safe_enum(enum_cls, value):
    try:
        return enum_cls(value)
    except ValueError:
        return enum_cls(0)
