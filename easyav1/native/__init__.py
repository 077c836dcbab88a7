"""Native (C) hot-path bindings via ctypes.

The AV1 tile symbol decoder is the sequential Amdahl bottleneck of the
decode pipeline (SURVEY.md §2d: msac/entropy decode stays on the host;
the reference keeps it in hand-tuned C/asm).  `decode_tile_native`
produces the exact same FramePlan as the Python TileDecoder; tests
assert bit-identical output on the full fixture corpus.

The shared library is rebuilt on import when sources are newer (plain
gcc; no external build deps).  If no compiler is available the import
still succeeds and `available()` returns False — callers fall back to
the Python tile decoder.
"""

from __future__ import annotations

import ctypes
import weakref
import glob
import sys
import os
import subprocess
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
# EASYAV1_SO: use a prebuilt library (e.g. tools/build/libeasyav1_san.so
# from `make -C tools sanitize`) instead of the gcc-on-import build
_SO = os.environ.get("EASYAV1_SO", os.path.join(_DIR, "libeasyav1.so"))
_SRCS = [os.path.join(_DIR, "av1_tile.c"), os.path.join(_DIR, "av1_recon.c"),
         os.path.join(_DIR, "av1_recon8.c"), os.path.join(_DIR, "vorbis_dec.c")]
# every header participates in the staleness check — a missing entry
# here silently ships a stale .so
_HDRS = sorted(glob.glob(os.path.join(_DIR, "*.h")))


class _TileParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "mi_rows", "mi_cols", "sb128", "bitdepth", "num_planes", "ssx",
        "ssy", "base_q_idx", "dq_y_dc", "dq_u_dc", "dq_u_ac", "dq_v_dc",
        "dq_v_ac", "tx_mode", "reduced_tx_set", "coded_lossless",
        "allow_update_cdf", "enable_cdef", "cdef_bits",
        "enable_filter_intra", "allow_intrabc", "delta_q_present",
        "delta_q_res", "delta_lf_present", "delta_lf_multi", "col_start",
        "col_end", "row_start", "row_end", "qctx", "allow_screen",
        "fill_aux")]


class _FrameParams(ctypes.Structure):
    """Per-frame inter header fields + entropy-state chaining
    (av1_common.h FrameParams)."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "frame_is_intra", "reference_select", "skip_mode_present",
        "skip_mode_frame0", "skip_mode_frame1",
        "allow_high_precision_mv", "force_integer_mv",
        "interpolation_filter", "enable_dual_filter",
        "is_motion_mode_switchable", "allow_warped_motion",
        "enable_interintra_compound", "enable_masked_compound",
        "enable_jnt_comp", "enable_order_hint", "order_hint_bits",
        "order_hint")] + [
        ("order_hints", ctypes.c_int32 * 8),
        ("sign_bias", ctypes.c_int32 * 8),
        ("gm_type", ctypes.c_int32 * 8),
        ("gm_invalid", ctypes.c_int32 * 8),
        ("gm_params", (ctypes.c_int32 * 6) * 8),
        ("ref_frame_idx", ctypes.c_int32 * 8),
        ("lr_uses", ctypes.c_int32),
        ("lr_frame_type", ctypes.c_int32 * 3),
        ("lr_unit_size", ctypes.c_int32 * 3),
        ("frame_width", ctypes.c_int32),
        ("frame_height", ctypes.c_int32),
        ("use_superres", ctypes.c_int32),
        ("downscaled_width", ctypes.c_int32),
        ("use_tpl", ctypes.c_int32),
        ("w8", ctypes.c_int32), ("h8", ctypes.c_int32),
        ("tpl_mv", ctypes.c_void_p), ("tpl_off", ctypes.c_void_p),
        ("cdf_in", ctypes.c_void_p), ("cdf_out", ctypes.c_void_p),
    ]


BLK_FIELDS = 52


class _FgParams(ctypes.Structure):
    """headers.FilmGrainParams mirror (av1_fg.h FgParams)."""

    _fields_ = [
        ("grain_seed", ctypes.c_int32),
        ("num_y_points", ctypes.c_int32),
        ("num_cb_points", ctypes.c_int32),
        ("num_cr_points", ctypes.c_int32),
        ("point_y_value", ctypes.c_int32 * 15),
        ("point_y_scaling", ctypes.c_int32 * 15),
        ("point_cb_value", ctypes.c_int32 * 11),
        ("point_cb_scaling", ctypes.c_int32 * 11),
        ("point_cr_value", ctypes.c_int32 * 11),
        ("point_cr_scaling", ctypes.c_int32 * 11),
        ("chroma_scaling_from_luma", ctypes.c_int32),
        ("grain_scaling", ctypes.c_int32),
        ("ar_coeff_lag", ctypes.c_int32),
        ("ar_coeffs_y", ctypes.c_int32 * 24),
        ("ar_coeffs_cb", ctypes.c_int32 * 25),
        ("ar_coeffs_cr", ctypes.c_int32 * 25),
        ("n_ar_y", ctypes.c_int32),
        ("n_ar_cb", ctypes.c_int32),
        ("n_ar_cr", ctypes.c_int32),
        ("ar_coeff_shift", ctypes.c_int32),
        ("grain_scale_shift", ctypes.c_int32),
        ("cb_mult", ctypes.c_int32),
        ("cb_luma_mult", ctypes.c_int32),
        ("cb_offset", ctypes.c_int32),
        ("cr_mult", ctypes.c_int32),
        ("cr_luma_mult", ctypes.c_int32),
        ("cr_offset", ctypes.c_int32),
        ("overlap_flag", ctypes.c_int32),
        ("clip_to_restricted_range", ctypes.c_int32),
    ]


def film_grain_native(fg, seq, planes):
    """Apply film grain via the C path; returns new planes (dtype of
    the inputs) or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = _FgParams(
        grain_seed=fg.grain_seed, num_y_points=fg.num_y_points,
        num_cb_points=fg.num_cb_points, num_cr_points=fg.num_cr_points,
        chroma_scaling_from_luma=int(fg.chroma_scaling_from_luma),
        grain_scaling=fg.grain_scaling, ar_coeff_lag=fg.ar_coeff_lag,
        n_ar_y=len(fg.ar_coeffs_y), n_ar_cb=len(fg.ar_coeffs_cb),
        n_ar_cr=len(fg.ar_coeffs_cr),
        ar_coeff_shift=fg.ar_coeff_shift,
        grain_scale_shift=fg.grain_scale_shift,
        cb_mult=fg.cb_mult, cb_luma_mult=fg.cb_luma_mult,
        cb_offset=fg.cb_offset, cr_mult=fg.cr_mult,
        cr_luma_mult=fg.cr_luma_mult, cr_offset=fg.cr_offset,
        overlap_flag=int(fg.overlap_flag),
        clip_to_restricted_range=int(fg.clip_to_restricted_range))
    for name, vals in (("point_y_value", fg.point_y_value),
                       ("point_y_scaling", fg.point_y_scaling),
                       ("point_cb_value", fg.point_cb_value),
                       ("point_cb_scaling", fg.point_cb_scaling),
                       ("point_cr_value", fg.point_cr_value),
                       ("point_cr_scaling", fg.point_cr_scaling),
                       ("ar_coeffs_y", fg.ar_coeffs_y),
                       ("ar_coeffs_cb", fg.ar_coeffs_cb),
                       ("ar_coeffs_cr", fg.ar_coeffs_cr)):
        arr = getattr(p, name)
        for i, v in enumerate(vals):
            arr[i] = int(v)
    src = [np.asarray(pl) for pl in planes]
    work = [np.ascontiguousarray(pl, np.uint16) for pl in src]
    luma_orig = np.ascontiguousarray(src[0], np.uint16)
    ptrs = (ctypes.c_void_p * 3)()
    for i in range(3):
        ptrs[i] = _vp(work[i]).value if i < len(work) else None
    h, w = src[0].shape
    mono = int(getattr(seq.color, "mono_chrome", False))
    rc = lib.av1_film_grain(
        ctypes.byref(p), seq.color.bitdepth, seq.color.subsampling_x,
        seq.color.subsampling_y, mono, len(work), ptrs, _vp(luma_orig),
        w, h)
    if rc != 0:
        return None
    return [wk.astype(s.dtype) for wk, s in zip(work, src)]


class _RefPlanes(ctypes.Structure):
    """Reference planes per slot (av1_common.h), in the frame's pel
    dtype (uint8 for the 8bpc recon build, uint16 otherwise): logical
    w/h plus the row stride in elements (the planes may be views into
    the mi-aligned recon buffers, avoiding a per-frame copy)."""

    _fields_ = [
        ("plane", (ctypes.c_void_p * 3) * 8),
        ("w", (ctypes.c_int32 * 3) * 8),
        ("h", (ctypes.c_int32 * 3) * 8),
        ("stride", (ctypes.c_int32 * 3) * 8),
    ]


class _TileDesc(ctypes.Structure):
    """Mirror of TileDesc (av1_tile.c tile-parallel entry)."""
    _fields_ = [
        ("data", ctypes.c_char_p), ("size", ctypes.c_int64),
        ("col_start", ctypes.c_int32), ("col_end", ctypes.c_int32),
        ("row_start", ctypes.c_int32), ("row_end", ctypes.c_int32),
        ("cdf_out", ctypes.c_void_p),
    ]


def decode_threads() -> int:
    """Worker count for tile-parallel entropy decode.  EASYAV1_THREADS
    overrides; 0/unset = auto (cpu count, dav1d-auto analog
    easyav1.c:1401-1408).  The effective count is further capped by the
    frame's tile count inside the C entry."""
    try:
        n = int(os.environ.get("EASYAV1_THREADS", "0"))
    except ValueError:
        n = 0
    if n <= 0:
        n = os.cpu_count() or 1
    return max(1, n)


class _TileOut(ctypes.Structure):
    _fields_ = [
        ("y_mode", ctypes.c_void_p), ("uv_mode", ctypes.c_void_p),
        ("angle_y", ctypes.c_void_p), ("angle_uv", ctypes.c_void_p),
        ("skip", ctypes.c_void_p), ("bsize", ctypes.c_void_p),
        ("blocks", ctypes.c_void_p),
        ("max_blocks", ctypes.c_int64), ("n_blocks", ctypes.c_int64),
        ("txs", ctypes.c_void_p),
        ("max_txs", ctypes.c_int64), ("n_txs", ctypes.c_int64),
        ("coeffs", ctypes.c_void_p),
        ("coeffs_cap", ctypes.c_int64), ("coeffs_used", ctypes.c_int64),
        ("lf_txs", ctypes.c_void_p),
        ("max_lf", ctypes.c_int64), ("n_lf", ctypes.c_int64),
        ("cdef_idx", ctypes.c_void_p),
        ("error", ctypes.c_int32),
        ("ref0_g", ctypes.c_void_p), ("ref1_g", ctypes.c_void_p),
        ("mvs_g", ctypes.c_void_p), ("interp_g", ctypes.c_void_p),
        ("modes_g", ctypes.c_void_p),
        ("intrabc_g", ctypes.c_void_p),
        ("lr_units", ctypes.c_void_p),
        ("max_lr_units", ctypes.c_int64), ("n_lr_units", ctypes.c_int64),
        ("pal_units", ctypes.c_void_p),
        ("max_pal_units", ctypes.c_int64),
        ("n_pal_units", ctypes.c_int64),
        ("pal_maps", ctypes.c_void_p),
        ("pal_maps_cap", ctypes.c_int64),
        ("pal_maps_used", ctypes.c_int64),
    ]


class _ReconParams(ctypes.Structure):
    _fields_ = [
        ("bitdepth", ctypes.c_int32), ("num_planes", ctypes.c_int32),
        ("ssx", ctypes.c_int32), ("ssy", ctypes.c_int32),
        ("mi_rows", ctypes.c_int32), ("mi_cols", ctypes.c_int32),
        ("enable_intra_edge_filter", ctypes.c_int32),
        ("lf_level", ctypes.c_int32 * 4),
        ("lf_sharpness", ctypes.c_int32),
        ("lf_delta_enabled", ctypes.c_int32),
        ("lf_ref_deltas", ctypes.c_int32 * 8),
        ("lf_mode_deltas", ctypes.c_int32 * 2),
        ("enable_cdef", ctypes.c_int32),
        ("cdef_damping", ctypes.c_int32),
        ("cdef_y_pri", ctypes.c_int32 * 8),
        ("cdef_y_sec", ctypes.c_int32 * 8),
        ("cdef_uv_pri", ctypes.c_int32 * 8),
        ("cdef_uv_sec", ctypes.c_int32 * 8),
        ("coded_lossless", ctypes.c_int32),
        ("allow_intrabc", ctypes.c_int32),
        ("frame_width", ctypes.c_int32),
        ("frame_height", ctypes.c_int32),
        ("tile_cols", ctypes.c_int32),
        ("tile_rows", ctypes.c_int32),
        ("tile_col_starts", ctypes.c_int32 * 65),
        ("tile_row_starts", ctypes.c_int32 * 65),
    ]


_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    if "EASYAV1_SO" in os.environ:
        return os.path.exists(_SO)
    try:
        newest_src = max(os.path.getmtime(f) for f in _SRCS + _HDRS)
    except OSError:
        return False
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src:
        return True
    try:
        r = subprocess.run(
            ["gcc", "-O3", "-funroll-loops", "-march=native", "-shared",
             "-fPIC", "-pthread", "-o", _SO] + _SRCS,
            capture_output=True, timeout=900)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("EASYAV1_NATIVE", "1") == "0":
        return None
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.av1_decode_tile.restype = ctypes.c_int
    lib.av1_decode_tile.argtypes = [
        ctypes.POINTER(_TileParams), ctypes.POINTER(_FrameParams),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_TileOut)]
    lib.av1_decode_tiles_mt.restype = ctypes.c_int
    lib.av1_decode_tiles_mt.argtypes = [
        ctypes.POINTER(_TileParams), ctypes.POINTER(_FrameParams),
        ctypes.POINTER(_TileDesc), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_TileOut)]
    lib.av1_cdf_blob_size.restype = ctypes.c_int
    lib.av1_cdf_blob_size.argtypes = []
    lib.av1_compose_residual.restype = ctypes.c_int
    lib.av1_compose_residual.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.av1_recon_frame.restype = ctypes.c_int
    lib.av1_recon_frame.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.POINTER(_FrameParams), ctypes.POINTER(_RefPlanes),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.av1_recon_frame_8.restype = ctypes.c_int
    lib.av1_recon_frame_8.argtypes = lib.av1_recon_frame.argtypes
    lib.av1_lf_grids_export.restype = ctypes.c_int
    lib.av1_lf_grids_export.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
    lib.av1_export_pred_units.restype = ctypes.c_int
    lib.av1_export_pred_units.argtypes = [
        ctypes.POINTER(_ReconParams), ctypes.POINTER(_TileOut),
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.av1_save_tmvs.restype = ctypes.c_int
    lib.av1_save_tmvs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.av1_project_mvfield.restype = ctypes.c_int
    lib.av1_project_mvfield.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.av1_pack8.restype = ctypes.c_int
    lib.av1_pack8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.av1_pack8_8.restype = ctypes.c_int
    lib.av1_pack8_8.argtypes = lib.av1_pack8.argtypes
    lib.av1_film_grain.restype = ctypes.c_int
    lib.av1_film_grain.argtypes = [
        ctypes.POINTER(_FgParams), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p * 3), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]
    lib.vorbis_create.restype = ctypes.c_void_p
    lib.vorbis_create.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.vorbis_destroy.restype = None
    lib.vorbis_destroy.argtypes = [ctypes.c_void_p]
    lib.vorbis_decode_packet.restype = ctypes.c_int
    lib.vorbis_decode_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vorbis_synth_block.restype = ctypes.c_long
    lib.vorbis_synth_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.vorbis_synth_track.restype = ctypes.c_long
    lib.vorbis_synth_track.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vorbis_decode_pcm.restype = ctypes.c_long
    lib.vorbis_decode_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.vorbis_synth_reset.restype = None
    lib.vorbis_synth_reset.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _qctx(base_q_idx: int) -> int:
    if base_q_idx <= 20:
        return 0
    if base_q_idx <= 60:
        return 1
    if base_q_idx <= 120:
        return 2
    return 3


def cdf_blob_size(lib) -> int:
    """sizeof(CdfState); asserted against the generated Python layout."""
    from easyav1.native.cdf_layout import CDF_BLOB_BYTES
    n = lib.av1_cdf_blob_size()
    assert n == CDF_BLOB_BYTES, (n, CDF_BLOB_BYTES)
    return n


def _build_fp(hdr, seq, cdf_in: Optional[bytes], cdf_out, tpl):
    """FrameParams from the parsed headers (+ optional temporal-mv
    projection arrays and CDF chaining buffers).  Returns (fp, keep)
    where `keep` holds buffers that must outlive the C call."""
    fp = _FrameParams(
        frame_is_intra=int(hdr.frame_is_intra),
        reference_select=int(getattr(hdr, "reference_select", False)),
        skip_mode_present=int(getattr(hdr, "skip_mode_present", False)),
        skip_mode_frame0=getattr(hdr, "skip_mode_frames", [0, 0])[0],
        skip_mode_frame1=getattr(hdr, "skip_mode_frames", [0, 0])[1],
        allow_high_precision_mv=int(
            getattr(hdr, "allow_high_precision_mv", False)),
        force_integer_mv=int(getattr(hdr, "force_integer_mv", False)),
        interpolation_filter=getattr(hdr, "interpolation_filter", 0),
        enable_dual_filter=int(getattr(seq, "enable_dual_filter", False)),
        is_motion_mode_switchable=int(
            getattr(hdr, "is_motion_mode_switchable", False)),
        allow_warped_motion=int(
            getattr(hdr, "allow_warped_motion", False)),
        enable_interintra_compound=int(
            getattr(seq, "enable_interintra_compound", False)),
        enable_masked_compound=int(
            getattr(seq, "enable_masked_compound", False)),
        enable_jnt_comp=int(getattr(seq, "enable_jnt_comp", False)),
        enable_order_hint=int(getattr(seq, "enable_order_hint", False)),
        order_hint_bits=getattr(seq, "order_hint_bits", 0),
        order_hint=getattr(hdr, "order_hint", 0),
    )
    keep = []
    oh = getattr(hdr, "order_hints", None)
    if oh is not None:
        fp.order_hints[:len(oh[:8])] = [int(v) for v in oh[:8]]
    sb = getattr(hdr, "ref_frame_sign_bias", None)
    if sb is not None:
        fp.sign_bias[:len(sb[:8])] = [int(v) for v in sb[:8]]
    gm_t = getattr(hdr, "gm_type", [0] * 8)
    gm_p = getattr(hdr, "gm_params", [[0, 0, 1 << 16, 0, 0, 1 << 16]] * 8)
    gm_i = getattr(hdr, "gm_invalid", [False] * 8)
    # bulk-fill the gm block: nested ctypes indexing materialises a
    # fresh array object per [i] access (~22us/frame); flat one-shot
    # slice assignments keep it ~4us
    fp.gm_type[:] = [int(v) for v in gm_t[:8]]
    fp.gm_invalid[:] = [int(v) for v in gm_i[:8]]
    flat = [int(x) for row in gm_p[:8] for x in row]
    ctypes.cast(fp.gm_params,
                ctypes.POINTER(ctypes.c_int32 * 48)).contents[:] = flat
    rfi = getattr(hdr, "ref_frame_idx", [0] * 7)
    # indexed by ref frame 1..7
    fp.ref_frame_idx[1:1 + len(rfi[:7])] = [int(v) for v in rfi[:7]]
    lr = getattr(hdr, "lr", None)
    if lr is not None and getattr(lr, "uses_lr", False):
        fp.lr_uses = 1
        for i in range(3):
            fp.lr_frame_type[i] = int(lr.frame_restoration_type[i])
            fp.lr_unit_size[i] = int(lr.loop_restoration_size[i])
    fp.frame_width = hdr.upscaled_width
    fp.frame_height = hdr.frame_height
    fp.use_superres = int(getattr(hdr, "use_superres", False))
    fp.downscaled_width = hdr.frame_width
    if tpl is not None:
        tpl_mv, tpl_off = tpl
        tpl_mv = np.ascontiguousarray(tpl_mv, np.int16)
        tpl_off = np.ascontiguousarray(tpl_off, np.int8)
        keep += [tpl_mv, tpl_off]
        fp.use_tpl = 1
        fp.h8, fp.w8 = tpl_off.shape
        fp.tpl_mv = _vp(tpl_mv)
        fp.tpl_off = _vp(tpl_off)
    if cdf_in is not None:
        buf = ctypes.create_string_buffer(cdf_in, len(cdf_in))
        keep.append(buf)
        fp.cdf_in = ctypes.cast(buf, ctypes.c_void_p)
    if cdf_out is not None:
        fp.cdf_out = ctypes.cast(cdf_out, ctypes.c_void_p)
    return fp, keep


def _run_tiles(lib, seq, hdr, tiles, cdf_in=None, want_cdf=False,
               tpl=None, fill_aux=False, threads=0, gen=0):
    """Run the C tile decoder over all tiles of a frame.

    Returns (TileOut, bufs, cdf_blob_or_None) or None when the frame
    uses syntax outside the C decoder's scope.  cdf_in: packed CdfState
    blob for inherited entropy state (spec load_cdfs); want_cdf: export
    the end-of-tile state of the context_update_tile_id tile.
    gen: buffer-pool generation — frame-parallel decode alternates 0/1
    so frame N+1's entropy never overwrites the arrays frame N's
    still-running recon reads."""
    mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    q = hdr.quant
    p = _TileParams(
        mi_rows=mi_rows, mi_cols=mi_cols,
        sb128=1 if seq.use_128x128_superblock else 0,
        bitdepth=seq.color.bitdepth, num_planes=seq.color.num_planes,
        ssx=seq.color.subsampling_x, ssy=seq.color.subsampling_y,
        base_q_idx=q.base_q_idx, dq_y_dc=q.delta_q_y_dc,
        dq_u_dc=q.delta_q_u_dc, dq_u_ac=q.delta_q_u_ac,
        dq_v_dc=q.delta_q_v_dc, dq_v_ac=q.delta_q_v_ac,
        tx_mode=hdr.tx_mode, reduced_tx_set=int(hdr.reduced_tx_set),
        coded_lossless=int(hdr.coded_lossless),
        allow_update_cdf=0 if hdr.disable_cdf_update else 1,
        enable_cdef=int(getattr(seq, "enable_cdef", False)),
        cdef_bits=hdr.cdef.bits if hdr.cdef else 0,
        enable_filter_intra=int(getattr(seq, "enable_filter_intra", False)),
        allow_intrabc=int(getattr(hdr, "allow_intrabc", False)),
        delta_q_present=int(hdr.delta_q_present),
        delta_q_res=hdr.delta_q_res,
        delta_lf_present=int(getattr(hdr, "delta_lf_present", False)),
        delta_lf_multi=int(getattr(hdr, "delta_lf_multi", False)),
        qctx=_qctx(q.base_q_idx),
        allow_screen=int(getattr(hdr, "allow_screen_content_tools",
                                 False)),
        fill_aux=int(fill_aux),
    )

    n_mi = mi_rows * mi_cols
    max_blocks = n_mi + 64
    max_txs = 3 * n_mi + 64
    max_lf = 3 * n_mi + 64
    coeffs_cap = 2 * n_mi * 16 + 4096
    # buffer pool keyed by mi dims — the C decoder overwrites every
    # consumed element, so reuse without re-zeroing (cdef grid and the
    # inter-state grids excepted)
    key = (mi_rows, mi_cols, gen)
    bufs = _BUF_POOL.get(key)
    if bufs is None:
        bufs = {
            "grids": {k: np.empty((mi_rows, mi_cols), np.int8)
                      for k in ("y_mode", "uv_mode", "angle_y", "angle_uv",
                                "skip", "bsize")},
            "blocks": np.empty((max_blocks, BLK_FIELDS), np.int32),
            "txs": np.empty((max_txs, 8), np.int32),
            "coeffs": np.empty(coeffs_cap, np.int32),
            "lf": np.empty((max_lf, 4), np.int32),
            "cdef": np.empty(((mi_rows + 15) // 16, (mi_cols + 15) // 16),
                             np.int8),
            "ref0": np.empty((mi_rows, mi_cols), np.int8),
            "ref1": np.empty((mi_rows, mi_cols), np.int8),
            "mvs": np.empty((mi_rows, mi_cols, 2, 2), np.int16),
            "interp": np.empty((mi_rows, mi_cols, 2), np.int8),
            "modes": np.empty((mi_rows, mi_cols), np.int16),
            "intrabc": np.empty((mi_rows, mi_cols), np.int8),
            # LR units: ceil over 64px min unit size per plane, 3 planes
            "lr": np.empty(((mi_rows * 4 // 64 + 2)
                            * (mi_cols * 4 // 64 + 2) * 3 + 64, 13),
                           np.int32),
            # palette: one unit per >=8x8 block; maps bounded by ~1.5x
            # the mi-aligned pixel area (y + subsampled uv)
            "pal": np.empty((n_mi // 4 + 64, 32), np.int32),
            "pal_maps": np.empty(2 * n_mi * 16 + 4096, np.int8),
        }
        _BUF_POOL[key] = bufs
    bufs["cdef"].fill(-1)
    # NOTE: ref0/ref1/mvs/interp/modes need no per-frame init: every
    # in-frame mi cell is overwritten by the per-block MI_FILL in
    # av1_decode_tile (blocks tile the frame), and all C readers
    # (refmvs above/left scans, OBMC, sub8x8 chroma, save_tmvs) only
    # touch cells of already-decoded blocks.  The fills cost ~8 MB of
    # memset per 4K frame (~1.2 ms).
    if getattr(hdr, "allow_intrabc", False):
        # filled/read only under allow_intrabc (screen-content intra)
        bufs["intrabc"].fill(0)
    grids = bufs["grids"]
    # inter/intrabc blocks skip the y/uv mode-grid fill in C (their
    # value is always DC_PRED == 0), so those two grids DO need a
    # per-frame zero here — a 2-plane memset is far cheaper than the
    # per-block row fills it replaces
    grids["y_mode"].fill(0)
    grids["uv_mode"].fill(0)

    out = bufs.get("out_struct")
    if out is None:
        out = _TileOut(
            y_mode=_vp(grids["y_mode"]), uv_mode=_vp(grids["uv_mode"]),
            angle_y=_vp(grids["angle_y"]), angle_uv=_vp(grids["angle_uv"]),
            skip=_vp(grids["skip"]), bsize=_vp(grids["bsize"]),
            blocks=_vp(bufs["blocks"]), max_blocks=max_blocks,
            txs=_vp(bufs["txs"]), max_txs=max_txs,
            coeffs=_vp(bufs["coeffs"]), coeffs_cap=coeffs_cap,
            lf_txs=_vp(bufs["lf"]), max_lf=max_lf,
            cdef_idx=_vp(bufs["cdef"]),
            ref0_g=_vp(bufs["ref0"]), ref1_g=_vp(bufs["ref1"]),
            mvs_g=_vp(bufs["mvs"]), interp_g=_vp(bufs["interp"]),
            modes_g=_vp(bufs["modes"]),
            intrabc_g=_vp(bufs["intrabc"]),
            lr_units=_vp(bufs["lr"]), max_lr_units=bufs["lr"].shape[0],
            pal_units=_vp(bufs["pal"]),
            max_pal_units=bufs["pal"].shape[0],
            pal_maps=_vp(bufs["pal_maps"]),
            pal_maps_cap=bufs["pal_maps"].shape[0])
        bufs["out_struct"] = out
    out.n_blocks = 0
    out.n_txs = 0
    out.coeffs_used = 0
    out.n_lf = 0
    out.error = 0
    out.n_lr_units = 0
    out.n_pal_units = 0
    out.pal_maps_used = 0

    sb_shift = 5 if seq.use_128x128_superblock else 4
    t = hdr.tile
    n_cols = t.cols
    n_tiles = t.cols * t.rows
    if len(tiles) != n_tiles:
        return None
    update_tid = t.context_update_tile_id
    cdf_out_buf = (ctypes.create_string_buffer(cdf_blob_size(lib))
                   if want_cdf else None)
    # one FrameParams for every tile: only cdf_out differs per tile
    # (each tile restarts from cdf_in; the C decoder never writes fp)
    fp, keep = _build_fp(hdr, seq, cdf_in, None, tpl)
    n_threads = (threads if threads > 0 else decode_threads()) \
        if n_tiles > 1 else 1
    if n_threads > 1:
        # tile-parallel path (dav1d thread_task.c analog): workers pull
        # whole tiles; merge relocates append-buffer indices in C
        descs = (_TileDesc * n_tiles)()
        for tile_num, tdata in enumerate(tiles):
            tr, tc = tile_num // n_cols, tile_num % n_cols
            d = descs[tile_num]
            d.data = tdata
            d.size = len(tdata)
            d.col_start = min(t.col_starts[tc] << sb_shift, mi_cols)
            d.col_end = min(t.col_starts[tc + 1] << sb_shift, mi_cols)
            d.row_start = min(t.row_starts[tr] << sb_shift, mi_rows)
            d.row_end = min(t.row_starts[tr + 1] << sb_shift, mi_rows)
            d.cdf_out = (ctypes.cast(cdf_out_buf, ctypes.c_void_p)
                         if (want_cdf and tile_num == update_tid)
                         else None)
        fp.cdf_out = None
        rc = lib.av1_decode_tiles_mt(ctypes.byref(p), ctypes.byref(fp),
                                     descs, n_tiles, n_threads,
                                     ctypes.byref(out))
        if rc != 0:
            return None
    else:
        for tile_num, tdata in enumerate(tiles):
            tr, tc = tile_num // n_cols, tile_num % n_cols
            p.col_start = min(t.col_starts[tc] << sb_shift, mi_cols)
            p.col_end = min(t.col_starts[tc + 1] << sb_shift, mi_cols)
            p.row_start = min(t.row_starts[tr] << sb_shift, mi_rows)
            p.row_end = min(t.row_starts[tr + 1] << sb_shift, mi_rows)
            fp.cdf_out = (ctypes.cast(cdf_out_buf, ctypes.c_void_p)
                          if (want_cdf and tile_num == update_tid)
                          else None)
            rc = lib.av1_decode_tile(ctypes.byref(p), ctypes.byref(fp),
                                     tdata, len(tdata),
                                     ctypes.byref(out))
            if rc != 0:
                return None
    # hand fp back for the recon stage (cdf pointers cleared: their
    # backing buffers die with `keep`); keep rides along so the tpl
    # arrays fp still points at outlive the recon call
    fp.cdf_in = None
    fp.cdf_out = None
    blob = cdf_out_buf.raw if cdf_out_buf is not None else None
    return out, bufs, blob, (fp, keep)


_VP_CACHE: dict = {}


def _vp(a):
    """ctypes data pointer of a numpy array.  Pool buffers are reused
    across frames and ~70 conversions per frame cost ~1ms/frame in
    ctypes plumbing, so cache by id with weakref-identity validation
    (an alive array's data pointer never moves; a recycled id fails
    the `is` check and recomputes)."""
    key = id(a)
    ent = _VP_CACHE.get(key)
    if ent is not None and ent[0]() is a:
        return ent[1]
    # NOT data_as(): that attaches a strong array reference to the
    # returned pointer, which would pin pooled planes through this
    # cache and kill the refcount-gated buffer rotation.  The weakref
    # identity check above is what keeps the cached pointer valid.
    p = ctypes.c_void_p(a.ctypes.data)
    _VP_CACHE[key] = (weakref.ref(a), p)
    if len(_VP_CACHE) > 4096:
        _VP_CACHE.clear()
    return p


_BUF_POOL: dict = {}

_LIBC = ctypes.CDLL(None, use_errno=True)
_MADV_HUGEPAGE = 14
_HUGE = 2 << 20


def _alloc_huge(shape, dtype):
    """np.empty with the backing range 2MB-aligned and madvised
    MADV_HUGEPAGE: frame-sized planes in 4 KB pages thrash the STLB at
    4K (the MC copy walks a new page every row); THP cuts the page
    count 512x.  Harmless no-op where THP is unavailable."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    raw = np.empty(nbytes + _HUGE, np.uint8)
    addr = raw.ctypes.data
    off = (-addr) % _HUGE
    try:
        _LIBC.madvise(ctypes.c_void_p(addr + off),
                      ctypes.c_size_t(nbytes), _MADV_HUGEPAGE)
    except Exception:
        pass
    return raw[off:off + nbytes].view(dtype).reshape(shape)


def decode_frame_native(seq, hdr, plan, tiles: List[bytes], cdf_in=None,
                        want_cdf=False, tpl=None, threads=0):
    """Decode all tiles of a frame into `plan` using the C decoder.

    Returns the end-of-frame CDF blob (bytes) when want_cdf, else True;
    returns None (plan untouched) when the native path is unavailable
    or declines — caller falls back to Python."""
    lib = _load()
    if lib is None:
        return None
    res = _run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                     want_cdf=want_cdf, tpl=tpl, fill_aux=True,
                     threads=threads)
    if res is None:
        return None
    out, bufs, blob, _fpk = res
    from easyav1.video.av1 import constants as C
    from easyav1.video.av1 import tables as T
    from easyav1.video.av1.tile import BlockRecord, TxBlock

    coeffs_buf = bufs["coeffs"]
    txs = bufs["txs"]
    for b in bufs["blocks"][:out.n_blocks]:
        (br, bc, bsize, y_mode, uv_mode, angle_y, angle_uv, skip,
         tx_size, uv_tx, has_chroma, cfl_u, cfl_v, fi, tx_off,
         n_tx) = (int(v) for v in b[:16])
        is_inter = bool(b[16])
        warp = None
        if b[28]:  # BLK_WARP_VALID
            warp = ([int(v) for v in b[29:35]],
                    tuple(int(v) for v in b[35:39]))
        rec = BlockRecord(
            r=br, c=bc, bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
            angle_y=angle_y, angle_uv=angle_uv, skip=bool(skip),
            tx_size=tx_size, uv_tx_size=uv_tx,
            has_chroma=bool(has_chroma),
            cfl_alphas=((cfl_u, cfl_v)
                        if uv_mode == C.UV_CFL_PRED else None),
            filter_intra=fi if fi >= 0 else None,
            is_inter=is_inter,
            ref_frame=(int(b[17]), int(b[18])),
            mv=(int(b[19]), int(b[20])),
            mv2=(int(b[21]), int(b[22])),
            inter_mode=int(b[23]), ref_mv_idx=int(b[24]),
            interp_filter=(int(b[25]), int(b[26])),
            motion_mode=int(b[27]), warp=warp,
            compound_type=int(b[39]), compound_idx=int(b[40]),
            wedge_idx=int(b[41]), wedge_sign=int(b[42]),
            mask_type=int(b[43]),
            interintra_mode=int(b[44]), ii_wedge=int(b[45]),
            ii_wedge_idx=int(b[46]),
            skip_mode=bool(b[47]), partition=int(b[48]))
        for k in range(tx_off, tx_off + n_tx):
            (plane, x, y, tsz, ttyp, eob, coff, lossless) = \
                (int(v) for v in txs[k])
            adj = T.ADJUSTED_TX_SIZE[tsz]
            tw, th = T.TX_WIDTH[adj], T.TX_HEIGHT[adj]
            rec.tx_blocks.append(TxBlock(
                plane=plane, x=x, y=y, tx_size=tsz, tx_type=ttyp,
                eob=eob & 0xFFF,  # high bits: nonzero bounding box
                coeffs=coeffs_buf[coff:coff + tw * th]
                .reshape(th, tw).copy(),
                lossless=bool(lossless)))
        plan.blocks.append(rec)
        if uv_mode == C.UV_CFL_PRED:
            plan.cfl_alphas[(br, bc)] = (cfl_u, cfl_v)
        if fi >= 0:
            plan.filter_intra[(br, bc)] = fi
        if b[49]:      # BLK_PAL: palette unit index + 1
            u = bufs["pal"][b[49] - 1]
            n_y, n_uv = int(u[0]), int(u[1])
            map_y = map_uv = None
            if n_y:
                map_y = bufs["pal_maps"][u[2]:u[2] + u[4] * u[5]] \
                    .reshape(int(u[5]), int(u[4])).astype(np.int32)
            if n_uv:
                map_uv = bufs["pal_maps"][u[3]:u[3] + u[6] * u[7]] \
                    .reshape(int(u[7]), int(u[6])).astype(np.int32)
            plan.palette[(br, bc)] = (
                [int(v) for v in u[8:8 + n_y]] if n_y else None,
                [int(v) for v in u[16:16 + n_uv]] if n_uv else None,
                [int(v) for v in u[24:24 + n_uv]] if n_uv else None,
                map_y, map_uv)
    for lf in bufs["lf"][:out.n_lf]:
        plan.lf_txs.append((int(lf[0]), int(lf[1]), int(lf[2]),
                            int(lf[3])))
    for k, g in bufs["grids"].items():
        getattr(plan, k)[:, :] = g
    # inter decode-state grids (recon OBMC/sub8x8 + backend save_tmvs)
    plan.ref0_grid = bufs["ref0"].copy()
    plan.ref1_grid = bufs["ref1"].copy()
    plan.mvs_grid = bufs["mvs"].copy()
    plan.interp_grid = bufs["interp"].copy()
    # loop-restoration unit params (Python LR fallback stage)
    for u in bufs["lr"][:out.n_lr_units]:
        key = (int(u[0]), int(u[1]), int(u[2]))
        plan.lr_type[key] = int(u[3])
        if u[3] == 2:       # RESTORE_WIENER
            plan.lr_wiener[key] = [[int(u[4]), int(u[5]), int(u[6])],
                                   [int(u[7]), int(u[8]), int(u[9])]]
        elif u[3] == 3:     # RESTORE_SGRPROJ
            plan.lr_sgr[key] = (int(u[10]), int(u[11]), int(u[12]))
    cdef_buf = bufs["cdef"]
    for ur in range(cdef_buf.shape[0]):
        for uc in range(cdef_buf.shape[1]):
            if cdef_buf[ur, uc] != -1:
                plan.cdef_idx[(ur * 16, uc * 16)] = int(cdef_buf[ur, uc])
    return blob if want_cdf else True


def _build_rp(seq, hdr):
    cdef = hdr.cdef

    def pad8(v):
        a = (ctypes.c_int32 * 8)()
        for i in range(min(8, len(v))):
            a[i] = v[i]
        return a

    def starts_mi(starts_sb, mi_max):
        # tile starts, sb -> mi units, clamped to the frame
        sbl = 5 if seq.use_128x128_superblock else 4
        a = (ctypes.c_int32 * 65)()
        for i, s in enumerate(starts_sb[:65]):
            a[i] = min(s << sbl, mi_max)
        return a

    return _ReconParams(
        bitdepth=seq.color.bitdepth, num_planes=seq.color.num_planes,
        ssx=seq.color.subsampling_x, ssy=seq.color.subsampling_y,
        mi_rows=hdr.mi_rows, mi_cols=hdr.mi_cols,
        enable_intra_edge_filter=int(
            getattr(seq, "enable_intra_edge_filter", False)),
        lf_level=(ctypes.c_int32 * 4)(*hdr.lf.level),
        lf_sharpness=hdr.lf.sharpness,
        lf_delta_enabled=int(hdr.lf.delta_enabled),
        lf_ref_deltas=(ctypes.c_int32 * 8)(*hdr.lf.ref_deltas),
        lf_mode_deltas=(ctypes.c_int32 * 2)(*hdr.lf.mode_deltas),
        enable_cdef=int(getattr(seq, "enable_cdef", False)),
        cdef_damping=cdef.damping if cdef else 3,
        cdef_y_pri=pad8(cdef.y_pri_strength if cdef else []),
        cdef_y_sec=pad8(cdef.y_sec_strength if cdef else []),
        cdef_uv_pri=pad8(cdef.uv_pri_strength if cdef else []),
        cdef_uv_sec=pad8(cdef.uv_sec_strength if cdef else []),
        coded_lossless=int(hdr.coded_lossless),
        allow_intrabc=int(getattr(hdr, "allow_intrabc", False)),
        frame_width=hdr.upscaled_width,
        frame_height=hdr.frame_height,
        tile_cols=hdr.tile.cols, tile_rows=hdr.tile.rows,
        tile_col_starts=starts_mi(hdr.tile.col_starts, hdr.mi_cols),
        tile_row_starts=starts_mi(hdr.tile.row_starts, hdr.mi_rows),
    )


def export_frame_bridge(seq, hdr, tiles: List[bytes]):
    """C entropy decode + pred-unit export for the device recon
    pipeline: returns dict(units[n,24], txs[n,8], coeffs[...] int32,
    rp) or None when the native path is unavailable/declines.  The
    arrays are copies (safe to hold across frames for pipelining)."""
    lib = _load()
    if lib is None:
        return None
    if not hdr.frame_is_intra or getattr(hdr, "use_superres", False) \
            or getattr(getattr(hdr, "lr", None), "uses_lr", False):
        return None
    res = _run_tiles(lib, seq, hdr, tiles)
    if res is None:
        return None
    out, bufs, _blob, _fpk = res
    rp = _build_rp(seq, hdr)
    max_units = _max_pred_units(out, hdr)
    units = np.empty((max_units, 24), np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.av1_export_pred_units(ctypes.byref(rp), ctypes.byref(out),
                                   _vp(units), max_units,
                                   ctypes.byref(n_out))
    if rc != 0:
        return None
    return {
        "units": units[:n_out.value],
        "txs": bufs["txs"][:out.n_txs].copy(),
        "coeffs": bufs["coeffs"][:out.coeffs_used].copy(),
        "rp": rp, "out": out, "bufs": bufs,
    }


def decode_entropy_native(seq, hdr, tiles: List[bytes], cdf_in=None,
                          want_cdf=False, tpl=None, threads=0, gen=0):
    """Entropy phase only (frame-parallel decode, dav1d frame-thread
    analog: thread_task.c frame tasks): C tile decode into the
    generation-`gen` buffer set.  Returns (out, bufs, blob, mv_grids,
    rp) or None when the C decoder declines.  The caller may then run
    `recon_native_phase` on another thread while the next frame's
    entropy proceeds in generation 1-gen."""
    lib = _load()
    if lib is None:
        return None
    if os.environ.get("EASYAV1_PIPE", "native") != "native":
        return None
    res = _run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                     want_cdf=want_cdf, tpl=tpl, threads=threads,
                     gen=gen)
    if res is None:
        return None
    out, bufs, blob, (fp_rc, keep_fp) = res
    rp = _build_rp(seq, hdr)
    mv_grids = None
    if not hdr.frame_is_intra:
        mv_grids = (bufs["ref0"], bufs["ref1"], bufs["mvs"])
    return out, bufs, blob, mv_grids, (rp, fp_rc, keep_fp)


def recon_native_phase(seq, hdr, out, bufs, rp_pack, refs):
    """Recon phase of the split path: C recon + postfilters on the
    entropy outputs, 8-bit zero-copy planes.  Thread-safe against a
    concurrent `decode_entropy_native` of the NEXT frame (disjoint
    buffer generations; the C recon and tile decoder share only
    read-only tables).  Returns (planes, ref_triples)."""
    lib = _load()
    rp, fp_rc, keep_fp = rp_pack
    pel8 = seq.color.bitdepth == 8
    pel_dt = np.uint8 if pel8 else np.uint16
    rfl = _RefPlanes()
    keep_refs = []
    if not hdr.frame_is_intra:
        for slot in range(8):
            pls = refs[slot]
            if pls is None:
                continue
            for pi, (arr, lw, lh) in enumerate(pls):
                if isinstance(arr, _DevRef):
                    arr = arr.numpy()
                if arr.dtype != pel_dt or not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr, pel_dt)
                keep_refs.append(arr)
                rfl.plane[slot][pi] = _vp(arr).value
                rfl.w[slot][pi] = lw
                rfl.h[slot][pi] = lh
                rfl.stride[slot][pi] = arr.shape[1]
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
    aw_y = max(aw, hdr.upscaled_width)
    aw_c = max(aw >> ssx, (hdr.upscaled_width + ssx) >> ssx)
    pkey = ("planes", ah, aw_y, aw_c, ssy, int(pel8))
    pool = _BUF_POOL.setdefault(pkey + ("rot",), [])
    pl = None
    for cand in pool:
        if all(sys.getrefcount(a) == 3
               and sys.getrefcount(a.base) == 2 for a in cand):
            pl = cand
            break
    if pl is None:
        pl = (_alloc_huge((ah, aw_y), pel_dt),
              _alloc_huge((ah >> ssy, aw_c), pel_dt),
              _alloc_huge((ah >> ssy, aw_c), pel_dt))
        pool.append(pl)
    py, pu, pv = pl
    recon_fn = lib.av1_recon_frame_8 if pel8 else lib.av1_recon_frame
    rc = recon_fn(ctypes.byref(rp), ctypes.byref(out),
                  ctypes.byref(fp_rc), ctypes.byref(rfl),
                  _vp(py), _vp(pu), _vp(pv))
    del keep_fp, keep_refs
    if rc != 0:
        raise RuntimeError(f"native recon failed rc={rc}")
    n_pl = seq.color.num_planes
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    if pel8:
        planes = []
        ref_triples = []
        for src, (pw_, ph_) in zip((py, pu, pv)[:n_pl],
                                   ((w, h), (cw, ch), (cw, ch))):
            planes.append(src[:ph_, :pw_])
            ref_triples.append((src, pw_, ph_))
        return planes, ref_triples
    dt = np.uint16
    planes = [py[:h, :w].astype(dt)]
    if n_pl > 1:
        planes.append(pu[:ch, :cw].astype(dt))
        planes.append(pv[:ch, :cw].astype(dt))
    ref_triples = [(np.ascontiguousarray(p, pel_dt), p.shape[1],
                    p.shape[0]) for p in planes]
    return planes, ref_triples


def decode_and_recon_native(seq, hdr, tiles: List[bytes], cdf_in=None,
                            want_cdf=False, tpl=None, refs=None,
                            want_u16=False, threads=0):
    """Full native frame path: tile decode + recon + loop filter + CDEF
    in C.  Returns (cropped planes, cdf_blob_or_None, mv_grids), or
    None if the native path is unavailable or declines (caller falls
    back).  mv_grids = (ref0, ref1, mvs) per-4x4 copies for the
    backend's temporal-mv storage (save_tmvs), None on intra frames.
    refs: per-slot triples of (pel plane, logical w, logical h) in
    the bitdepth's pel dtype; each plane may be an mi-aligned recon
    buffer wider than w (the C MC reads with an explicit row stride)."""
    lib = _load()
    if lib is None:
        return None
    # 8bpc streams reconstruct in uint8 planes (av1_recon8.c: half the
    # pixel memory traffic); 10/12bpc and the device/pallas pipes (whose
    # JAX kernels take uint16 planes) use the 16-bit build
    pipe = os.environ.get("EASYAV1_PIPE", "native")
    if pipe != "native":
        from easyav1.utils import compile_cache
        compile_cache.enable()
    pel8 = seq.color.bitdepth == 8 and pipe == "native"
    pel_dt = np.uint8 if pel8 else np.uint16
    rfl = _RefPlanes()
    keep_refs = []
    if not hdr.frame_is_intra:
        if refs is None:
            return None
        for slot in set(hdr.ref_frame_idx):
            if refs[slot] is None:
                return None
        for slot in range(8):
            pls = refs[slot]
            if pls is None:
                continue
            for pi, (arr, lw, lh) in enumerate(pls):
                if isinstance(arr, _DevRef):
                    arr = arr.numpy()     # C fallback: pull from HBM
                if arr.dtype != pel_dt or not arr.flags.c_contiguous:
                    # dtype conversion is exact both ways for 8-bit
                    # streams (samples <= 255); only hit when the pipe
                    # changes mid-stream
                    arr = np.ascontiguousarray(arr, pel_dt)
                keep_refs.append(arr)
                rfl.plane[slot][pi] = _vp(arr).value
                rfl.w[slot][pi] = lw
                rfl.h[slot][pi] = lh
                rfl.stride[slot][pi] = arr.shape[1]
    res = _run_tiles(lib, seq, hdr, tiles, cdf_in=cdf_in,
                     want_cdf=want_cdf, tpl=tpl, threads=threads)
    if res is None:
        return None
    out, bufs, blob, (fp_rc, keep_fp) = res
    rp = _build_rp(seq, hdr)

    mv_grids = None
    if not hdr.frame_is_intra:
        # no copy: the backend's save_tmvs consumes these within the
        # same frame, before the next _run_tiles reuses the buffers
        mv_grids = (bufs["ref0"], bufs["ref1"], bufs["mvs"])
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    if os.environ.get("EASYAV1_PIPE", "native") == "pallas":
        # full device recon: the scan executor for intra frames, the
        # jax MC executor for inter frames.  Superres and loop
        # restoration run on device in both (_device_pipe_finish).
        planes = None
        if hdr.frame_is_intra:
            planes = _device_frame_intra(lib, seq, hdr, out, bufs, rp)
        elif refs is not None:
            planes = _device_frame_inter(lib, seq, hdr, out, bufs,
                                         rp, refs)
        _PIPE_STATS["frames"] += 1
        if planes is None:
            _PIPE_STATS["fallbacks"] += 1
        if planes is not None:
            if isinstance(planes, tuple):   # resident: device refs too
                return planes[0], blob, mv_grids, planes[1]
            return planes, blob, mv_grids
        # fall through to the C recon when the device path declines

    aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
    # superres frames land at the upscaled width (C upscales between
    # CDEF and LR); buffers must fit both the coded and upscaled dims
    aw_y = max(aw, hdr.upscaled_width)
    aw_c = max(aw >> ssx, (hdr.upscaled_width + ssx) >> ssx)
    pkey = ("planes", ah, aw_y, aw_c, ssy, int(pel8))
    def _plane(h_, w_):
        return _alloc_huge((h_, w_), pel_dt)
    zero_copy = want_u16 and seq.color.bitdepth == 8
    if zero_copy:
        # recon covers every mi-aligned pixel, so no zeroing needed;
        # pel planes (uint8 for 8bpc via av1_recon8.c, else uint16):
        # every stage writes clamped pixel values, and narrow planes
        # halve the MC/LF/CDEF/LR/pack memory traffic.
        # Zero-copy refs: the recon target itself is handed to the ref
        # slots (the C MC reads with an explicit row stride and clamps
        # to the logical w/h, so the mi-aligned overhang is never
        # read).  A small rotation of plane sets is kept; a set is
        # reusable once nothing outside the pool references it, which
        # kills the 12 MB/frame u16 ref copy the old single-set scheme
        # paid in av1_pack8 (~2.3 ms/frame at 1080p).
        pool = _BUF_POOL.setdefault(pkey + ("rot",), [])
        pl = None
        for cand in pool:
            # refs on the plane array: pool tuple + genexp binding +
            # getrefcount arg.  ALSO gate on the backing allocation
            # (a.base): numpy collapses view bases, so a consumer-held
            # display view `src[:h,:w]` pins a.base, NOT a — without
            # this check the pool recycled sets whose pixels a held
            # VideoFrame still aliased (first-frames corruption when a
            # caller holds >pool-depth frames)
            if all(sys.getrefcount(a) == 3
                   and sys.getrefcount(a.base) == 2 for a in cand):
                pl = cand
                break
        if pl is None:
            pl = (_plane(ah, aw_y),
                  _plane(ah >> ssy, aw_c),
                  _plane(ah >> ssy, aw_c))
            pool.append(pl)
    else:
        pl = _BUF_POOL.get(pkey)
        if pl is None:
            pl = (_plane(ah, aw_y),
                  _plane(ah >> ssy, aw_c),
                  _plane(ah >> ssy, aw_c))
            _BUF_POOL[pkey] = pl
    py, pu, pv = pl
    device = os.environ.get("EASYAV1_PIPE", "native") == "device" \
        and not getattr(hdr, "use_superres", False)
    saved_lf = tuple(rp.lf_level)
    saved_cdef = rp.enable_cdef
    if device:
        # dense math only in C; loop filter, CDEF and loop restoration
        # run as device (JAX) kernels on the mi-aligned planes
        rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
        rp.enable_cdef = 0
        fp_rc.lr_uses = 0
    recon_fn = lib.av1_recon_frame_8 if pel8 else lib.av1_recon_frame
    rc = recon_fn(ctypes.byref(rp), ctypes.byref(out),
                  ctypes.byref(fp_rc), ctypes.byref(rfl),
                  _vp(py), _vp(pu), _vp(pv))
    del keep_fp, keep_refs
    if rc != 0:
        return None
    n_pl = seq.color.num_planes
    aligned = [py, pu, pv][:n_pl]
    if device:
        # restore the real filter params: the device stages derive
        # their per-block level grids through this rp
        rp.lf_level = (ctypes.c_int32 * 4)(*saved_lf)
        rp.enable_cdef = saved_cdef
        _device_postfilter(seq, hdr, out, bufs, aligned, rp)
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    if zero_copy:
        if pel8:
            # u8 recon planes ARE the display planes: hand back strided
            # views (rows are contiguous, row pitch = mi-aligned width).
            # No pack copy at all; downstream consumers pass
            # pointer+stride (capi) or read via numpy.  The views keep
            # the pooled base planes alive, so the refcount-gated "rot"
            # pool cannot recycle a set the display still holds.
            planes = []
            ref_triples = []
            for src, (pw_, ph_) in zip((py, pu, pv)[:n_pl],
                                       ((w, h), (cw, ch), (cw, ch))):
                planes.append(src[:ph_, :pw_])
                ref_triples.append((src, pw_, ph_))
            return planes, blob, mv_grids, ref_triples
        # u16 recon (kept for the device pipes): pack to u8 display
        # planes from a refcount-gated pool (np.empty every frame
        # page-faults ~12 MB at 4K; measured 38 ms/frame in av1_pack8).
        o8pool = _BUF_POOL.setdefault(pkey + ("o8",), [])
        shapes = ((h, w), (ch, cw), (ch, cw))[:n_pl]
        o8s = None
        for cand in o8pool:
            if (all(sys.getrefcount(a) == 3 for a in cand)
                    and all(a.shape == sh
                            for a, sh in zip(cand, shapes))):
                o8s = cand
                break
        if o8s is None:
            o8s = tuple(np.empty(sh, np.uint8) for sh in shapes)
            if len(o8pool) < 16:
                o8pool.append(o8s)
        planes = []
        ref_triples = []
        for src, o8, (pw_, ph_) in zip((py, pu, pv)[:n_pl], o8s,
                                       ((w, h), (cw, ch), (cw, ch))):
            lib.av1_pack8(_vp(src), src.shape[1], pw_, ph_, _vp(o8), None)
            planes.append(o8)
            ref_triples.append((src, pw_, ph_))
        return planes, blob, mv_grids, ref_triples
    dt = np.uint8 if seq.color.bitdepth == 8 else np.uint16
    planes = [py[:h, :w].astype(dt)]
    if n_pl > 1:
        planes.append(pu[:ch, :cw].astype(dt))
        planes.append(pv[:ch, :cw].astype(dt))
    if want_u16:
        ref_triples = [(np.ascontiguousarray(p, pel_dt),
                        p.shape[1], p.shape[0]) for p in planes]
        return planes, blob, mv_grids, ref_triples
    return planes, blob, mv_grids


_SCAN_RECONS: dict = {}


class _LazyPlanes:
    """Sequence of decoded planes whose device→host download completes
    on first access.  `copy_to_host_async` is issued at construction,
    so the transfer overlaps the caller's next-frame entropy decode —
    the device pipe's analog of the reference's decode-ahead thread
    (easyav1.c:2271-2333) at the frame-data level.

    eager=False (device-resident mode, EASYAV1_RESIDENT=1): no
    transfer is issued at all until a consumer actually indexes the
    planes — frames whose pixels are only hashed/displayed-on-demand
    never leave the device.  `device_planes` exposes the on-device
    arrays for hash/consume-on-device paths."""

    __slots__ = ("_devs", "_np")

    def __init__(self, devs, eager=True):
        self._devs = devs
        self._np = None
        if eager:
            for d in devs:
                d.copy_to_host_async()

    @property
    def device_planes(self):
        return self._devs

    def _mat(self):
        if self._np is None:
            self._np = [np.asarray(d) for d in self._devs]
            self._devs = None
        return self._np

    def __len__(self):
        return len(self._np if self._np is not None else self._devs)

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


def _resident() -> bool:
    return os.environ.get("EASYAV1_RESIDENT", "") not in ("", "0")


class _DevRef:
    """Reference plane resident in device HBM (logical dims, u8/u16).
    `numpy()` materializes (once) for the C recon fallback path."""

    __slots__ = ("dev", "_np")

    def __init__(self, dev):
        self.dev = dev
        self._np = None

    def numpy(self):
        if self._np is None:
            self._np = np.asarray(self.dev)
        return self._np

    # duck-type the bits of ndarray the rfl-marshaling path touches
    @property
    def dtype(self):
        return self.numpy().dtype

    @property
    def shape(self):
        return tuple(self.dev.shape)


def _device_frame_intra(lib, seq, hdr, out, bufs, rp):
    """Device intra recon pipe: the C entropy decoder's per-unit export
    feeds the scan executor (DeviceRecon: residual compose + intra
    prediction, intrabc included); the postfilter chain then runs as
    device kernels.  Returns visible planes, or None when the frame uses
    features the executor lacks (non-4:2:0 CfL) — the caller falls back
    to the C recon (entropy work is shared, not redone)."""
    from easyav1.video.av1.recon.jax_exec import PAD, DeviceRecon

    max_units = _max_pred_units(out, hdr)
    units = np.empty((max_units, 24), np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.av1_export_pred_units(ctypes.byref(rp), ctypes.byref(out),
                                   _vp(units), max_units,
                                   ctypes.byref(n_out))
    if rc != 0:
        return None
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    key = (hdr.mi_rows, hdr.mi_cols, ssx, ssy, seq.color.bitdepth,
           seq.color.num_planes)
    dr = _SCAN_RECONS.get(key)
    if dr is None:
        dr = _SCAN_RECONS[key] = DeviceRecon(*key)
    outs = dr.run(units[:n_out.value], bufs["txs"][:out.n_txs],
                  bufs["coeffs"][:out.coeffs_used],
                  literals=_export_literals(lib, rp, out))
    if outs is None:
        return None
    dev = [outs[p][PAD:PAD + ph, PAD:PAD + pw]
           for p, (ph, pw) in enumerate(dr.dims)]
    dev = _device_pipe_finish(dev, lib, seq, hdr, out, bufs, rp)
    return _device_output(seq, hdr, dev)


def _device_output(seq, hdr, dev):
    """Crop the device pipe's planes to the visible frame in the
    stream's pel dtype.  Resident mode also returns them as the next
    frame's reference planes, kept on the device."""
    import jax.numpy as jnp

    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    w, h = hdr.upscaled_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    dt = jnp.uint8 if seq.color.bitdepth == 8 else jnp.uint16
    final = [dev[0][:h, :w].astype(dt)]
    if seq.color.num_planes > 1:
        final.append(dev[1][:ch, :cw].astype(dt))
        final.append(dev[2][:ch, :cw].astype(dt))
    if _resident():
        # device-resident refs: the next frame's device MC reads these
        # without any host round-trip; the C fallback materializes on
        # demand (_DevRef.numpy)
        rt = [(_DevRef(f), int(f.shape[1]), int(f.shape[0]))
              for f in final]
        return _LazyPlanes(final, eager=False), rt
    return _LazyPlanes(final)


_INTER_RECONS: dict = {}
_DEVICE_INTER_STATS = {"frames": 0, "fallbacks": 0}
# whole-pipe accounting (any EASYAV1_PIPE=pallas frame, intra or
# inter): fallbacks counts frames the device path declined to the C
# recon — tests assert 0 over the supported corpus
_PIPE_STATS = {"frames": 0, "fallbacks": 0}
# cumulative per-phase wall seconds of the device pipes (read by
# tools/profile_resident.py; reset by the caller)
_DEV_PROF: dict = {}


def _prof(name, t0):
    import time as _t

    t1 = _t.perf_counter()
    _DEV_PROF[name] = _DEV_PROF.get(name, 0.0) + (t1 - t0)
    return t1


def _device_frame_inter(lib, seq, hdr, out, bufs, rp, refs):
    """Device inter recon pipe: C entropy decode feeds the jax MC executor
    (subpel/compound MC + residual itx + sequential intra scan on
    device), then loop filter + CDEF as device kernels.  Returns
    visible planes or None (unsupported feature — caller falls back to
    the C recon; entropy work is shared).  `refs` = per-slot
    [(plane u16, lw, lh)] triples as passed to the C recon."""
    from easyav1.video.av1.recon.mc_jax import (
        DeviceInterRecon, export_inter_plan)
    import time as _t

    _tp = _t.perf_counter()
    blocks = bufs["blocks"][:out.n_blocks]
    ref_dims = [None if refs[s] is None else
                (refs[s][0][1], refs[s][0][2]) for s in range(8)]
    # host-visible ref planes (diffwtd mask generation); None per slot
    # when HBM-resident (export falls back only if diffwtd is present)
    host_refs = []
    for s in range(8):
        if refs[s] is None:
            host_refs.append(None)
            continue
        pls = [a for (a, _lw, _lh) in refs[s]]
        host_refs.append(None if any(isinstance(a, _DevRef)
                                     for a in pls) else pls)
    plan_mc = export_inter_plan(seq, hdr, blocks, bufs["ref0"],
                                bufs["mvs"], bufs["interp"], ref_dims,
                                ref_planes=host_refs,
                                bsize_g=bufs["grids"]["bsize"])
    _tp = _prof("plan_export", _tp)
    if plan_mc is None:
        _DEVICE_INTER_STATS["fallbacks"] += 1
        return None
    # intra pred units (inter blocks marked decoded, not exported)
    max_units = _max_pred_units(out, hdr)
    units = np.empty((max_units, 24), np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.av1_export_pred_units(ctypes.byref(rp), ctypes.byref(out),
                                   _vp(units), max_units,
                                   ctypes.byref(n_out))
    _tp = _prof("units_export", _tp)
    if rc != 0:
        return None
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    key = (hdr.mi_rows, hdr.mi_cols, ssx, ssy, seq.color.bitdepth,
           seq.color.num_planes)
    ir = _INTER_RECONS.get(key)
    if ir is None:
        ir = _INTER_RECONS[key] = DeviceInterRecon(*key)
    # stacked logical-size reference planes in dense slot order
    w, h = hdr.frame_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    refs_np = [None] * seq.color.num_planes
    if plan_mc["slots"]:
        for p in range(seq.color.num_planes):
            pw_, ph_ = (w, h) if p == 0 else (cw, ch)
            lst = []
            for s in plan_mc["slots"]:
                a = refs[s][p][0]
                if isinstance(a, _DevRef):
                    lst.append(a.dev)     # HBM-resident, logical dims
                else:
                    lst.append(np.ascontiguousarray(a[:ph_, :pw_]))
            refs_np[p] = lst
    _tp = _prof("refs_marshal", _tp)
    outs = ir.run(units[:n_out.value], bufs["txs"][:out.n_txs],
                  bufs["coeffs"][:out.coeffs_used], plan_mc, refs_np,
                  (w, h), literals=_export_literals(lib, rp, out))
    _tp = _prof("ir_run", _tp)
    if outs is None:
        _DEVICE_INTER_STATS["fallbacks"] += 1
        return None
    _DEVICE_INTER_STATS["frames"] += 1
    from easyav1.video.av1.recon.jax_exec import PAD
    dev = [outs[p][PAD:PAD + ph_, PAD:PAD + pw_]
           for p, (ph_, pw_) in enumerate(ir.dims)]
    dev = _device_pipe_finish(dev, lib, seq, hdr, out, bufs, rp)
    _prof("postfilter", _tp)
    return _device_output(seq, hdr, dev)


def _grids_exporter(lib, rp, out):
    """grids_for(plane, shape) closure over the C decoder's exported
    per-4x4-cell loop-filter grids."""
    def grids_for(plane, shape):
        h, w = shape
        gw, gh = (w + 3) >> 2, (h + 3) >> 2
        a = [np.empty((gh, gw), np.uint8) for _ in range(7)]
        rc = lib.av1_lf_grids_export(
            ctypes.byref(rp), ctypes.byref(out), plane, w, h,
            _vp(a[0]), _vp(a[1]), _vp(a[2]), _vp(a[3]), _vp(a[4]),
            _vp(a[5]), _vp(a[6]))
        if rc != 0:
            raise RuntimeError("lf grids export failed")
        return {"txw": a[0].astype(np.int32), "txh": a[1].astype(np.int32),
                "skip": a[2].astype(np.int32),
                "edge_left": a[3].astype(bool),
                "edge_top": a[4].astype(bool),
                "lvl0": a[5].astype(np.int32),
                "lvl1": a[6].astype(np.int32), "gw": gw, "gh": gh}
    return grids_for


def _max_pred_units(out, hdr):
    """Upper bound on exported pred-unit records: n_lf counts coded
    (non-skip) txs, but skip blocks export units too (one per tx
    tile), so bound by the 4x4 grid: <= mi_rows*mi_cols luma +
    2*mi_rows*mi_cols chroma (4:4:4 worst case) + interintra extras."""
    return max(int(out.n_lf) * 2,
               3 * int(hdr.mi_rows) * int(hdr.mi_cols)) + 256


def _export_literals(lib, rp, out):
    """Palette-prediction patches for the device pipes: (recs[N,6],
    pix int32) or None when the frame has no palette blocks."""
    if out.n_pal_units <= 0:
        return None
    # worst case: a 64x64 palette block tiled by 4x4 txs = 256 luma +
    # 2*64 chroma records
    max_recs = int(out.n_pal_units) * 512 + 64
    max_pix = int(out.pal_maps_used) * 4 + 4096
    recs = np.empty((max_recs, 6), np.int32)
    pix = np.empty(max_pix, np.int32)
    n_recs = ctypes.c_int64(0)
    pix_used = ctypes.c_int64(0)
    rc = lib.av1_export_literal_preds(
        ctypes.byref(rp), ctypes.byref(out), _vp(recs),
        ctypes.c_int64(max_recs), ctypes.byref(n_recs), _vp(pix),
        ctypes.c_int64(max_pix), ctypes.byref(pix_used))
    if rc != 0:
        raise RuntimeError("literal pred export overflow")
    return recs[:n_recs.value], pix[:pix_used.value]


def _lr_plan(out, bufs):
    """LR unit params exported by the entropy pass → lr_jax plan."""
    from types import SimpleNamespace

    plan = SimpleNamespace(lr_type={}, lr_wiener={}, lr_sgr={})
    for u in bufs["lr"][:out.n_lr_units]:
        key = (int(u[0]), int(u[1]), int(u[2]))
        plan.lr_type[key] = int(u[3])
        if u[3] == 2:       # RESTORE_WIENER
            plan.lr_wiener[key] = [
                [int(u[4]), int(u[5]), int(u[6])],
                [int(u[7]), int(u[8]), int(u[9])]]
        elif u[3] == 3:     # RESTORE_SGRPROJ
            plan.lr_sgr[key] = (int(u[10]), int(u[11]), int(u[12]))
    return plan


def _device_pipe_finish(dev, lib, seq, hdr, out, bufs, rp):
    """Shared tail of the intra/inter device pipes: LF + CDEF, then
    superres upscale (sr_jax matmul kernel) and loop restoration
    (lr_jax device-resident path) when the frame uses them — the whole
    postfilter chain stays in HBM (no host plane round-trips).
    `dev` = cropped mi-aligned device planes; returns device planes at
    the upscaled width (reference ordering: av1_recon_tmpl.h:1464-1517
    — LF, deblocked snapshot, CDEF, superres of planes AND snapshot,
    LR)."""
    from easyav1.video.av1.recon.postfilter_fused import \
        postfilter_frame

    lr_on = getattr(getattr(hdr, "lr", None), "uses_lr", False) \
        and out.n_lr_units > 0
    sr_on = bool(getattr(hdr, "use_superres", False))
    res = postfilter_frame(dev, hdr, seq, _grids_exporter(lib, rp, out),
                           bufs["grids"]["skip"], bufs["cdef"],
                           want_deblocked=lr_on)
    dev, debl = res if lr_on else (res, None)
    if sr_on:
        from easyav1.video.av1.recon.sr_jax import \
            upscale_plane_device

        ssx = seq.color.subsampling_x
        bd = seq.color.bitdepth
        up = []
        upd = []
        for p in range(len(dev)):
            sx = ssx if p else 0
            src_w = (hdr.frame_width + sx) >> sx
            dst_w = (hdr.upscaled_width + sx) >> sx
            up.append(upscale_plane_device(dev[p], src_w, dst_w, bd))
            if lr_on:
                upd.append(upscale_plane_device(debl[p], src_w, dst_w,
                                                bd))
        dev = up
        debl = upd if lr_on else None
    if lr_on:
        from easyav1.video.av1.recon.lr_jax import \
            DeviceLoopRestoration

        lr = DeviceLoopRestoration(hdr, seq, _lr_plan(out, bufs),
                                   seq.color.bitdepth)
        dev = lr.apply_device(dev, debl)
    return dev


def _device_postfilter(seq, hdr, out, bufs, aligned, rp):
    """Loop filter + CDEF + loop restoration on device using the
    native decoder's grids; results written back into `aligned`."""
    from easyav1.video.av1.recon.postfilter_fused import \
        postfilter_frame

    lib = _load()
    lr_on = getattr(getattr(hdr, "lr", None), "uses_lr", False)
    res = postfilter_frame(aligned, hdr, seq, _grids_exporter(lib, rp, out),
                           bufs["grids"]["skip"], bufs["cdef"],
                           want_deblocked=lr_on)
    dev, debl = res if lr_on else (res, None)
    for p, d in enumerate(dev):
        if d is not aligned[p]:
            aligned[p][:, :] = np.asarray(d)
    if lr_on:
        from types import SimpleNamespace

        from easyav1.video.av1.recon.lr_jax import \
            DeviceLoopRestoration

        plan = SimpleNamespace(lr_type={}, lr_wiener={}, lr_sgr={})
        for u in bufs["lr"][:out.n_lr_units]:
            key = (int(u[0]), int(u[1]), int(u[2]))
            plan.lr_type[key] = int(u[3])
            if u[3] == 2:       # RESTORE_WIENER
                plan.lr_wiener[key] = [
                    [int(u[4]), int(u[5]), int(u[6])],
                    [int(u[7]), int(u[8]), int(u[9])]]
            elif u[3] == 3:     # RESTORE_SGRPROJ
                plan.lr_sgr[key] = (int(u[10]), int(u[11]), int(u[12]))
        DeviceLoopRestoration(hdr, seq, plan, seq.color.bitdepth).apply(
            aligned, [np.asarray(d) for d in debl])
