"""AV1 OBU framing and header parsing (spec §5.5 sequence header,
§5.9 frame header). Host-side, sequential — parity with dav1d's
obu.c/getbits.c role (SURVEY.md §2d: "host (C++)" disposition; Python
here, hot paths live in the entropy/coef layer, not header parse).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from easyav1.video.av1 import constants as C
from easyav1.video.av1.bitreader import AV1BitstreamError, BitReader


# ---------------------------------------------------------------------------
# OBU framing (§5.3)

@dataclasses.dataclass
class OBU:
    type: int
    temporal_id: int
    spatial_id: int
    payload: bytes


def split_obus(data: bytes) -> List[OBU]:
    """Split a temporal unit (low-overhead format, as stored in WebM
    blocks) into OBUs."""
    obus = []
    pos = 0
    n = len(data)
    while pos < n:
        b0 = data[pos]
        if b0 & 0x80:
            raise AV1BitstreamError("forbidden bit set in obu header")
        obu_type = (b0 >> 3) & 0xF
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            e = data[pos]
            tid = (e >> 5) & 7
            sid = (e >> 3) & 3
            pos += 1
        if has_size:
            size = 0
            for i in range(8):
                byte = data[pos]
                pos += 1
                size |= (byte & 0x7F) << (7 * i)
                if not (byte & 0x80):
                    break
        else:
            size = n - pos
        obus.append(OBU(obu_type, tid, sid, bytes(data[pos:pos + size])))
        pos += size
    return obus


# ---------------------------------------------------------------------------
# Sequence header (§5.5)

@dataclasses.dataclass
class ColorConfig:
    bitdepth: int = 8
    mono_chrome: bool = False
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False

    @property
    def num_planes(self) -> int:
        return 1 if self.mono_chrome else 3


@dataclasses.dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: bool = False
    reduced_still_picture_header: bool = False
    operating_point_idc: List[int] = dataclasses.field(default_factory=lambda: [0])
    seq_level_idx: List[int] = dataclasses.field(default_factory=lambda: [0])
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    force_screen_content_tools: int = 0
    force_integer_mv: int = 0
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    color: ColorConfig = dataclasses.field(default_factory=ColorConfig)
    film_grain_params_present: bool = False
    decoder_model_info_present: bool = False
    equal_picture_interval: bool = True
    buffer_delay_length: int = 0
    buffer_removal_time_length: int = 0
    frame_presentation_time_length: int = 0


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    r = BitReader(payload)
    s = SequenceHeader()
    s.seq_profile = r.f(3)
    s.still_picture = bool(r.f1())
    s.reduced_still_picture_header = bool(r.f1())
    if s.reduced_still_picture_header:
        s.seq_level_idx = [r.f(5)]
        s.operating_point_idc = [0]
    else:
        timing_info_present = r.f1()
        decoder_model_info_present = False
        if timing_info_present:
            r.f(32)  # num_units_in_display_tick
            r.f(32)  # time_scale
            s.equal_picture_interval = bool(r.f1())
            if s.equal_picture_interval:
                r.uvlc()  # num_ticks_per_picture_minus_1
            decoder_model_info_present = bool(r.f1())
            if decoder_model_info_present:
                s.buffer_delay_length = r.f(5) + 1
                r.f(32)  # num_units_in_decoding_tick
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        s.decoder_model_info_present = decoder_model_info_present
        initial_display_delay_present = r.f1()
        cnt = r.f(5) + 1
        s.operating_point_idc = []
        s.seq_level_idx = []
        for _ in range(cnt):
            s.operating_point_idc.append(r.f(12))
            level = r.f(5)
            s.seq_level_idx.append(level)
            if level > 7:
                r.f1()  # seq_tier
            if decoder_model_info_present:
                if r.f1():  # decoder_model_present_for_this_op
                    r.f(s.buffer_delay_length)  # decoder_buffer_delay
                    r.f(s.buffer_delay_length)  # encoder_buffer_delay
                    r.f1()  # low_delay_mode_flag
            if initial_display_delay_present:
                if r.f1():
                    r.f(4)  # initial_display_delay_minus_1
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_frame_width = r.f(s.frame_width_bits) + 1
    s.max_frame_height = r.f(s.frame_height_bits) + 1
    if s.reduced_still_picture_header:
        s.frame_id_numbers_present = False
    else:
        s.frame_id_numbers_present = bool(r.f1())
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.f(4) + 2
        s.additional_frame_id_length = r.f(3) + 1
    s.use_128x128_superblock = bool(r.f1())
    s.enable_filter_intra = bool(r.f1())
    s.enable_intra_edge_filter = bool(r.f1())
    if s.reduced_still_picture_header:
        s.force_screen_content_tools = C.SELECT_SCREEN_CONTENT_TOOLS
        s.force_integer_mv = C.SELECT_INTEGER_MV
    else:
        s.enable_interintra_compound = bool(r.f1())
        s.enable_masked_compound = bool(r.f1())
        s.enable_warped_motion = bool(r.f1())
        s.enable_dual_filter = bool(r.f1())
        s.enable_order_hint = bool(r.f1())
        if s.enable_order_hint:
            s.enable_jnt_comp = bool(r.f1())
            s.enable_ref_frame_mvs = bool(r.f1())
        if r.f1():  # seq_choose_screen_content_tools
            s.force_screen_content_tools = C.SELECT_SCREEN_CONTENT_TOOLS
        else:
            s.force_screen_content_tools = r.f1()
        if s.force_screen_content_tools > 0:
            if r.f1():  # seq_choose_integer_mv
                s.force_integer_mv = C.SELECT_INTEGER_MV
            else:
                s.force_integer_mv = r.f1()
        else:
            s.force_integer_mv = C.SELECT_INTEGER_MV
        if s.enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = bool(r.f1())
    s.enable_cdef = bool(r.f1())
    s.enable_restoration = bool(r.f1())
    s.color = _parse_color_config(r, s.seq_profile)
    s.film_grain_params_present = bool(r.f1())
    return s


def _parse_color_config(r: BitReader, profile: int) -> ColorConfig:
    c = ColorConfig()
    high_bitdepth = r.f1()
    if profile == 2 and high_bitdepth:
        c.bitdepth = 12 if r.f1() else 10
    else:
        c.bitdepth = 10 if high_bitdepth else 8
    if profile == 1:
        c.mono_chrome = False
    else:
        c.mono_chrome = bool(r.f1())
    if r.f1():  # color_description_present
        c.color_primaries = r.f(8)
        c.transfer_characteristics = r.f(8)
        c.matrix_coefficients = r.f(8)
    if c.mono_chrome:
        c.color_range = r.f1()
        c.subsampling_x = c.subsampling_y = 1
        return c
    if (c.color_primaries == 1 and c.transfer_characteristics == 13
            and c.matrix_coefficients == 0):
        c.color_range = 1
        c.subsampling_x = c.subsampling_y = 0
    else:
        c.color_range = r.f1()
        if profile == 0:
            c.subsampling_x = c.subsampling_y = 1
        elif profile == 1:
            c.subsampling_x = c.subsampling_y = 0
        else:
            if c.bitdepth == 12:
                c.subsampling_x = r.f1()
                c.subsampling_y = r.f1() if c.subsampling_x else 0
            else:
                c.subsampling_x = 1
                c.subsampling_y = 0
        if c.subsampling_x and c.subsampling_y:
            c.chroma_sample_position = r.f(2)
    c.separate_uv_delta_q = bool(r.f1())
    return c


# ---------------------------------------------------------------------------
# Frame header (§5.9)

@dataclasses.dataclass
class TileInfo:
    cols: int = 1
    rows: int = 1
    cols_log2: int = 0
    rows_log2: int = 0
    col_starts: List[int] = dataclasses.field(default_factory=list)  # in sb
    row_starts: List[int] = dataclasses.field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 1


@dataclasses.dataclass
class QuantizationParams:
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclasses.dataclass
class SegmentationParams:
    enabled: bool = False
    update_map: bool = False
    temporal_update: bool = False
    update_data: bool = False
    feature_enabled: List[List[bool]] = dataclasses.field(
        default_factory=lambda: [[False] * C.SEG_LVL_MAX
                                 for _ in range(C.MAX_SEGMENTS)])
    feature_data: List[List[int]] = dataclasses.field(
        default_factory=lambda: [[0] * C.SEG_LVL_MAX
                                 for _ in range(C.MAX_SEGMENTS)])
    seg_id_pre_skip: bool = False
    last_active_seg_id: int = 0


@dataclasses.dataclass
class LoopFilterParams:
    level: List[int] = dataclasses.field(default_factory=lambda: [0, 0, 0, 0])
    sharpness: int = 0
    delta_enabled: bool = False
    ref_deltas: List[int] = dataclasses.field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    mode_deltas: List[int] = dataclasses.field(default_factory=lambda: [0, 0])


@dataclasses.dataclass
class CdefParams:
    damping: int = 3
    bits: int = 0
    y_pri_strength: List[int] = dataclasses.field(default_factory=lambda: [0])
    y_sec_strength: List[int] = dataclasses.field(default_factory=lambda: [0])
    uv_pri_strength: List[int] = dataclasses.field(default_factory=lambda: [0])
    uv_sec_strength: List[int] = dataclasses.field(default_factory=lambda: [0])


@dataclasses.dataclass
class LrParams:
    frame_restoration_type: List[int] = dataclasses.field(
        default_factory=lambda: [C.RESTORE_NONE] * 3)
    loop_restoration_size: List[int] = dataclasses.field(
        default_factory=lambda: [256, 256, 256])
    uses_lr: bool = False


@dataclasses.dataclass
class FilmGrainParams:
    apply_grain: bool = False
    grain_seed: int = 0
    update_grain: bool = True
    num_y_points: int = 0
    point_y_value: List[int] = dataclasses.field(default_factory=list)
    point_y_scaling: List[int] = dataclasses.field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    num_cb_points: int = 0
    point_cb_value: List[int] = dataclasses.field(default_factory=list)
    point_cb_scaling: List[int] = dataclasses.field(default_factory=list)
    num_cr_points: int = 0
    point_cr_value: List[int] = dataclasses.field(default_factory=list)
    point_cr_scaling: List[int] = dataclasses.field(default_factory=list)
    grain_scaling: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: List[int] = dataclasses.field(default_factory=list)
    ar_coeffs_cb: List[int] = dataclasses.field(default_factory=list)
    ar_coeffs_cr: List[int] = dataclasses.field(default_factory=list)
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


@dataclasses.dataclass
class FrameHeader:
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = 0
    frame_type: int = C.KEY_FRAME
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = False
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = False
    current_frame_id: int = 0
    frame_size_override: bool = False
    order_hint: int = 0
    primary_ref_frame: int = C.PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: List[int] = dataclasses.field(default_factory=lambda: [0] * 7)
    ref_order_hint: List[int] = dataclasses.field(default_factory=lambda: [0] * 8)
    frame_width: int = 0
    frame_height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = C.SUPERRES_NUM
    use_superres: bool = False
    mi_cols: int = 0
    mi_rows: int = 0
    allow_intrabc: bool = False
    allow_high_precision_mv: bool = False
    interpolation_filter: int = C.EIGHTTAP
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    order_hints: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 8)
    ref_frame_sign_bias: List[bool] = dataclasses.field(
        default_factory=lambda: [False] * 8)
    disable_frame_end_update_cdf: bool = False
    tile: TileInfo = dataclasses.field(default_factory=TileInfo)
    quant: QuantizationParams = dataclasses.field(default_factory=QuantizationParams)
    seg: SegmentationParams = dataclasses.field(default_factory=SegmentationParams)
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    coded_lossless: bool = False
    all_lossless: bool = False
    lossless_segs: List[bool] = dataclasses.field(default_factory=lambda: [False] * 8)
    lf: LoopFilterParams = dataclasses.field(default_factory=LoopFilterParams)
    cdef: CdefParams = dataclasses.field(default_factory=CdefParams)
    lr: LrParams = dataclasses.field(default_factory=LrParams)
    tx_mode: int = C.ONLY_4X4
    reference_select: bool = False
    skip_mode_present: bool = False
    skip_mode_frames: List[int] = dataclasses.field(default_factory=lambda: [0, 0])
    allow_warped_motion: bool = False
    reduced_tx_set: bool = False
    gm_type: List[int] = dataclasses.field(default_factory=lambda: [C.IDENTITY] * 8)
    gm_params: List[List[int]] = dataclasses.field(
        default_factory=lambda: [[0, 0, 1 << 16, 0, 0, 1 << 16][:] for _ in range(8)])
    gm_invalid: List[bool] = dataclasses.field(default_factory=lambda: [False] * 8)
    film_grain: FilmGrainParams = dataclasses.field(default_factory=FilmGrainParams)
    header_bit_offset: int = 0  # bit position after the uncompressed header

    @property
    def frame_is_intra(self) -> bool:
        return self.frame_type in (C.KEY_FRAME, C.INTRA_ONLY_FRAME)


@dataclasses.dataclass
class RefFrameState:
    """Saved per reference slot (the parts header parsing needs)."""

    valid: bool = False
    frame_id: int = 0
    order_hint: int = 0
    # the frame's own OrderHints view (spec SavedOrderHints)
    saved_order_hints: Optional[List[int]] = None
    frame_type: int = C.KEY_FRAME
    upscaled_width: int = 0
    frame_width: int = 0
    frame_height: int = 0
    render_width: int = 0
    render_height: int = 0
    mi_cols: int = 0
    mi_rows: int = 0
    header: Optional[FrameHeader] = None  # for loading contexts
    film_grain: Optional[FilmGrainParams] = None


class HeaderParser:
    """Stateful frame header parser: tracks reference slots across frames."""

    def __init__(self, seq: SequenceHeader):
        self.seq = seq
        self.refs = [RefFrameState() for _ in range(C.NUM_REF_FRAMES)]

    # -- helpers -------------------------------------------------------

    def get_relative_dist(self, a: int, b: int) -> int:
        seq = self.seq
        if not seq.enable_order_hint:
            return 0
        diff = a - b
        m = 1 << (seq.order_hint_bits - 1)
        return (diff & (m - 1)) - (diff & m)

    # -- main entry ----------------------------------------------------

    def parse_frame_header(self, payload: bytes) -> FrameHeader:
        seq = self.seq
        r = BitReader(payload)
        h = FrameHeader()
        id_len = (seq.delta_frame_id_length + seq.additional_frame_id_length
                  if seq.frame_id_numbers_present else 0)

        if seq.reduced_still_picture_header:
            h.frame_type = C.KEY_FRAME
            h.show_frame = True
            frame_is_intra = True
        else:
            h.show_existing_frame = bool(r.f1())
            if h.show_existing_frame:
                h.frame_to_show_map_idx = r.f(3)
                if seq.decoder_model_info_present and not seq.equal_picture_interval:
                    r.f(seq.frame_presentation_time_length)
                if seq.frame_id_numbers_present:
                    r.f(id_len)  # display_frame_id
                ref = self.refs[h.frame_to_show_map_idx]
                h.frame_type = ref.frame_type
                if ref.frame_type == C.KEY_FRAME:
                    h.refresh_frame_flags = 0xFF
                    # showing a key frame refreshes everything
                    self._update_refs_show_existing(h)
                else:
                    h.refresh_frame_flags = 0
                h.header_bit_offset = r.pos
                return h
            h.frame_type = r.f(2)
            frame_is_intra = h.frame_type in (C.KEY_FRAME, C.INTRA_ONLY_FRAME)
            h.show_frame = bool(r.f1())
            if h.show_frame and seq.decoder_model_info_present \
                    and not seq.equal_picture_interval:
                r.f(seq.frame_presentation_time_length)
            if h.show_frame:
                h.showable_frame = h.frame_type != C.KEY_FRAME
            else:
                h.showable_frame = bool(r.f1())
            if h.frame_type == C.SWITCH_FRAME or (
                    h.frame_type == C.KEY_FRAME and h.show_frame):
                h.error_resilient_mode = True
            else:
                h.error_resilient_mode = bool(r.f1())

        if h.frame_type == C.KEY_FRAME and h.show_frame:
            for ref in self.refs:
                ref.valid = False

        h.disable_cdf_update = bool(r.f1())
        if seq.force_screen_content_tools == C.SELECT_SCREEN_CONTENT_TOOLS:
            h.allow_screen_content_tools = bool(r.f1())
        else:
            h.allow_screen_content_tools = bool(seq.force_screen_content_tools)
        if h.allow_screen_content_tools:
            if seq.force_integer_mv == C.SELECT_INTEGER_MV:
                h.force_integer_mv = bool(r.f1())
            else:
                h.force_integer_mv = bool(seq.force_integer_mv)
        else:
            h.force_integer_mv = False
        if frame_is_intra:
            h.force_integer_mv = True
        if seq.frame_id_numbers_present:
            h.current_frame_id = r.f(id_len)
        if h.frame_type == C.SWITCH_FRAME:
            h.frame_size_override = True
        elif seq.reduced_still_picture_header:
            h.frame_size_override = False
        else:
            h.frame_size_override = bool(r.f1())
        if seq.enable_order_hint:
            h.order_hint = r.f(seq.order_hint_bits)
        if frame_is_intra or h.error_resilient_mode:
            h.primary_ref_frame = C.PRIMARY_REF_NONE
        else:
            h.primary_ref_frame = r.f(3)
        if seq.decoder_model_info_present:
            if r.f1():  # buffer_removal_time_present
                for idc in seq.operating_point_idc:
                    # in_temporal/spatial_layer checks omitted: read for all
                    r.f(seq.buffer_removal_time_length)
        if h.frame_type == C.SWITCH_FRAME or (
                h.frame_type == C.KEY_FRAME and h.show_frame):
            h.refresh_frame_flags = 0xFF
        else:
            h.refresh_frame_flags = r.f(8)
        if not frame_is_intra or h.refresh_frame_flags != 0xFF:
            if h.error_resilient_mode and seq.enable_order_hint:
                for i in range(C.NUM_REF_FRAMES):
                    h.ref_order_hint[i] = r.f(seq.order_hint_bits)
                    if h.ref_order_hint[i] != self.refs[i].order_hint:
                        self.refs[i].valid = False

        if frame_is_intra:
            self._frame_size(r, h)
            self._render_size(r, h)
            if h.allow_screen_content_tools and h.upscaled_width == h.frame_width:
                h.allow_intrabc = bool(r.f1())
        else:
            frame_refs_short_signaling = False
            if seq.enable_order_hint:
                frame_refs_short_signaling = bool(r.f1())
                if frame_refs_short_signaling:
                    last_frame_idx = r.f(3)
                    gold_frame_idx = r.f(3)
                    self._set_frame_refs(h, last_frame_idx, gold_frame_idx)
            for i in range(C.REFS_PER_FRAME):
                if not frame_refs_short_signaling:
                    h.ref_frame_idx[i] = r.f(3)
                if seq.frame_id_numbers_present:
                    r.f(seq.delta_frame_id_length)  # delta_frame_id_minus_1
            if h.frame_size_override and not h.error_resilient_mode:
                found = False
                for i in range(C.REFS_PER_FRAME):
                    if r.f1():
                        ref = self.refs[h.ref_frame_idx[i]]
                        h.upscaled_width = ref.upscaled_width
                        h.frame_height = ref.frame_height
                        h.render_width = ref.render_width
                        h.render_height = ref.render_height
                        h.frame_width = h.upscaled_width
                        self._superres_params(r, h)
                        self._compute_image_size(h)
                        found = True
                        break
                if not found:
                    self._frame_size(r, h)
                    self._render_size(r, h)
            else:
                self._frame_size(r, h)
                self._render_size(r, h)
            if h.force_integer_mv:
                h.allow_high_precision_mv = False
            else:
                h.allow_high_precision_mv = bool(r.f1())
            if r.f1():  # is_filter_switchable
                h.interpolation_filter = C.SWITCHABLE
            else:
                h.interpolation_filter = r.f(2)
            h.is_motion_mode_switchable = bool(r.f1())
            if h.error_resilient_mode or not seq.enable_ref_frame_mvs:
                h.use_ref_frame_mvs = False
            else:
                h.use_ref_frame_mvs = bool(r.f1())
            # OrderHints[ref] / sign bias (spec 5.9.2 tail; used by the
            # temporal mv projection and extra-search sign flips)
            h.order_hints = [0] * 8
            h.ref_frame_sign_bias = [False] * 8
            if seq.enable_order_hint:
                for i in range(C.REFS_PER_FRAME):
                    rh = self.refs[h.ref_frame_idx[i]].order_hint
                    h.order_hints[C.LAST_FRAME + i] = rh
                    h.ref_frame_sign_bias[C.LAST_FRAME + i] = \
                        self.get_relative_dist(rh, h.order_hint) > 0

        if seq.reduced_still_picture_header or h.disable_cdf_update:
            h.disable_frame_end_update_cdf = True
        else:
            h.disable_frame_end_update_cdf = bool(r.f1())

        self._tile_info(r, h)
        self._quantization_params(r, h)
        self._segmentation_params(r, h)
        self._delta_q_params(r, h)
        self._delta_lf_params(r, h)
        self._compute_lossless(h)
        self._loop_filter_params(r, h)
        self._cdef_params(r, h)
        self._lr_params(r, h)
        # read_tx_mode
        if h.coded_lossless:
            h.tx_mode = C.ONLY_4X4
        else:
            h.tx_mode = C.TX_MODE_SELECT if r.f1() else C.TX_MODE_LARGEST
        # frame_reference_mode
        if frame_is_intra:
            h.reference_select = False
        else:
            h.reference_select = bool(r.f1())
        self._skip_mode_params(r, h, frame_is_intra)
        if frame_is_intra or h.error_resilient_mode or not seq.enable_warped_motion:
            h.allow_warped_motion = False
        else:
            h.allow_warped_motion = bool(r.f1())
        h.reduced_tx_set = bool(r.f1())
        self._global_motion_params(r, h, frame_is_intra)
        self._film_grain_params(r, h)
        h.header_bit_offset = r.pos
        return h

    # -- frame size ----------------------------------------------------

    def _frame_size(self, r: BitReader, h: FrameHeader) -> None:
        seq = self.seq
        if h.frame_size_override:
            h.frame_width = r.f(seq.frame_width_bits) + 1
            h.frame_height = r.f(seq.frame_height_bits) + 1
        else:
            h.frame_width = seq.max_frame_width
            h.frame_height = seq.max_frame_height
        h.upscaled_width = h.frame_width
        self._superres_params(r, h)
        self._compute_image_size(h)

    def _superres_params(self, r: BitReader, h: FrameHeader) -> None:
        if self.seq.enable_superres:
            h.use_superres = bool(r.f1())
        else:
            h.use_superres = False
        if h.use_superres:
            h.superres_denom = r.f(3) + C.SUPERRES_DENOM_MIN
        else:
            h.superres_denom = C.SUPERRES_NUM
        h.upscaled_width = h.frame_width
        h.frame_width = (h.upscaled_width * C.SUPERRES_NUM
                         + h.superres_denom // 2) // h.superres_denom

    @staticmethod
    def _compute_image_size(h: FrameHeader) -> None:
        h.mi_cols = 2 * ((h.frame_width + 7) >> 3)
        h.mi_rows = 2 * ((h.frame_height + 7) >> 3)

    def _render_size(self, r: BitReader, h: FrameHeader) -> None:
        if r.f1():  # render_and_frame_size_different
            h.render_width = r.f(16) + 1
            h.render_height = r.f(16) + 1
        else:
            h.render_width = h.upscaled_width
            h.render_height = h.frame_height

    def _set_frame_refs(self, h: FrameHeader, last_idx: int, gold_idx: int) -> None:
        """set_frame_refs (spec §7.8): derive the 7 refs from order hints."""
        seq = self.seq
        h.ref_frame_idx = [-1] * 7
        h.ref_frame_idx[0] = last_idx
        h.ref_frame_idx[C.GOLDEN_FRAME - C.LAST_FRAME] = gold_idx
        used = [False] * C.NUM_REF_FRAMES
        used[last_idx] = True
        used[gold_idx] = True
        cur_hint = h.order_hint
        shifted = [0] * C.NUM_REF_FRAMES
        for i in range(C.NUM_REF_FRAMES):
            shifted[i] = cur_hint + 2 * self.get_relative_dist(
                self.refs[i].order_hint, cur_hint)
        last_hint = shifted[last_idx]
        gold_hint = shifted[gold_idx]
        # ALTREF: most future unused
        for name, cmp_latest in ((C.ALTREF_FRAME, True), (C.BWDREF_FRAME, False),
                                 (C.ALTREF2_FRAME, False)):
            best = -1
            best_hint = None
            for i in range(C.NUM_REF_FRAMES):
                if used[i] or shifted[i] <= cur_hint:
                    continue
                if name == C.ALTREF_FRAME:
                    if best_hint is None or shifted[i] > best_hint:
                        best, best_hint = i, shifted[i]
                else:
                    if best_hint is None or shifted[i] < best_hint:
                        best, best_hint = i, shifted[i]
            if best >= 0:
                h.ref_frame_idx[name - C.LAST_FRAME] = best
                used[best] = True
        # remaining past frames, most recent first
        ref_order = [C.LAST2_FRAME, C.LAST3_FRAME, C.BWDREF_FRAME,
                     C.ALTREF2_FRAME, C.ALTREF_FRAME]
        for name in ref_order:
            if h.ref_frame_idx[name - C.LAST_FRAME] >= 0:
                continue
            best = -1
            best_hint = None
            for i in range(C.NUM_REF_FRAMES):
                if used[i]:
                    continue
                if best_hint is None or shifted[i] > best_hint:
                    best, best_hint = i, shifted[i]
            if best >= 0:
                h.ref_frame_idx[name - C.LAST_FRAME] = best
                used[best] = True
        # fill leftovers with the earliest frame
        earliest = 0
        eh = shifted[0]
        for i in range(1, C.NUM_REF_FRAMES):
            if shifted[i] < eh:
                earliest, eh = i, shifted[i]
        for i in range(7):
            if h.ref_frame_idx[i] < 0:
                h.ref_frame_idx[i] = earliest

    # -- tiles ---------------------------------------------------------

    def _tile_info(self, r: BitReader, h: FrameHeader) -> None:
        seq = self.seq
        t = TileInfo()
        sb_shift = 5 if seq.use_128x128_superblock else 4
        sb_cols = (h.mi_cols + (1 << sb_shift) - 1) >> sb_shift
        sb_rows = (h.mi_rows + (1 << sb_shift) - 1) >> sb_shift
        sb_size = sb_shift + 2
        max_tile_width_sb = C.MAX_TILE_WIDTH >> sb_size
        max_tile_area_sb = C.MAX_TILE_AREA >> (2 * sb_size)
        min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
        max_log2_tile_cols = _tile_log2(1, min(sb_cols, C.MAX_TILE_COLS))
        max_log2_tile_rows = _tile_log2(1, min(sb_rows, C.MAX_TILE_ROWS))
        min_log2_tiles = max(min_log2_tile_cols,
                             _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
        uniform = bool(r.f1())
        if uniform:
            t.cols_log2 = min_log2_tile_cols
            while t.cols_log2 < max_log2_tile_cols:
                if r.f1():
                    t.cols_log2 += 1
                else:
                    break
            tile_width_sb = (sb_cols + (1 << t.cols_log2) - 1) >> t.cols_log2
            t.col_starts = list(range(0, sb_cols, tile_width_sb)) + [sb_cols]
            t.cols = len(t.col_starts) - 1
            min_log2_tile_rows = max(min_log2_tiles - t.cols_log2, 0)
            t.rows_log2 = min_log2_tile_rows
            while t.rows_log2 < max_log2_tile_rows:
                if r.f1():
                    t.rows_log2 += 1
                else:
                    break
            tile_height_sb = (sb_rows + (1 << t.rows_log2) - 1) >> t.rows_log2
            t.row_starts = list(range(0, sb_rows, tile_height_sb)) + [sb_rows]
            t.rows = len(t.row_starts) - 1
        else:
            widest = 0
            t.col_starts = [0]
            start_sb = 0
            while start_sb < sb_cols:
                max_width = min(sb_cols - start_sb, max_tile_width_sb)
                w = r.ns(max_width) + 1
                widest = max(widest, w)
                start_sb += w
                t.col_starts.append(start_sb)
            t.cols = len(t.col_starts) - 1
            t.cols_log2 = _tile_log2(1, t.cols)
            if min_log2_tiles > 0:
                max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
            else:
                max_tile_area_sb = sb_rows * sb_cols
            max_tile_height_sb = max(max_tile_area_sb // widest, 1)
            t.row_starts = [0]
            start_sb = 0
            while start_sb < sb_rows:
                max_height = min(sb_rows - start_sb, max_tile_height_sb)
                hh = r.ns(max_height) + 1
                start_sb += hh
                t.row_starts.append(start_sb)
            t.rows = len(t.row_starts) - 1
            t.rows_log2 = _tile_log2(1, t.rows)
        if t.cols_log2 > 0 or t.rows_log2 > 0:
            t.context_update_tile_id = r.f(t.rows_log2 + t.cols_log2)
            t.tile_size_bytes = r.f(2) + 1
        h.tile = t

    # -- quant / seg / deltas -----------------------------------------

    def _quantization_params(self, r: BitReader, h: FrameHeader) -> None:
        q = QuantizationParams()
        q.base_q_idx = r.f(8)
        q.delta_q_y_dc = _read_delta_q(r)
        if self.seq.color.num_planes > 1:
            if self.seq.color.separate_uv_delta_q:
                diff_uv_delta = bool(r.f1())
            else:
                diff_uv_delta = False
            q.delta_q_u_dc = _read_delta_q(r)
            q.delta_q_u_ac = _read_delta_q(r)
            if diff_uv_delta:
                q.delta_q_v_dc = _read_delta_q(r)
                q.delta_q_v_ac = _read_delta_q(r)
            else:
                q.delta_q_v_dc = q.delta_q_u_dc
                q.delta_q_v_ac = q.delta_q_u_ac
        q.using_qmatrix = bool(r.f1())
        if q.using_qmatrix:
            q.qm_y = r.f(4)
            q.qm_u = r.f(4)
            if not self.seq.color.separate_uv_delta_q:
                q.qm_v = q.qm_u
            else:
                q.qm_v = r.f(4)
        h.quant = q

    def _segmentation_params(self, r: BitReader, h: FrameHeader) -> None:
        s = SegmentationParams()
        s.enabled = bool(r.f1())
        if s.enabled:
            if h.primary_ref_frame == C.PRIMARY_REF_NONE:
                s.update_map = True
                s.temporal_update = False
                s.update_data = True
            else:
                s.update_map = bool(r.f1())
                if s.update_map:
                    s.temporal_update = bool(r.f1())
                s.update_data = bool(r.f1())
            if s.update_data:
                for i in range(C.MAX_SEGMENTS):
                    for j in range(C.SEG_LVL_MAX):
                        enabled = bool(r.f1())
                        s.feature_enabled[i][j] = enabled
                        value = 0
                        if enabled:
                            bits = C.SEGMENTATION_FEATURE_BITS[j]
                            limit = C.SEGMENTATION_FEATURE_MAX[j]
                            if C.SEGMENTATION_FEATURE_SIGNED[j]:
                                value = r.su(1 + bits)
                                value = max(-limit, min(limit, value))
                            elif bits:
                                value = min(r.f(bits), limit)
                        s.feature_data[i][j] = value
            elif h.primary_ref_frame != C.PRIMARY_REF_NONE:
                # inherit from the primary reference frame
                prev = self.refs[h.ref_frame_idx[h.primary_ref_frame]].header
                if prev is not None:
                    s.feature_enabled = [row[:] for row in prev.seg.feature_enabled]
                    s.feature_data = [row[:] for row in prev.seg.feature_data]
        for i in range(C.MAX_SEGMENTS):
            if any(s.feature_enabled[i]):
                s.last_active_seg_id = i
                if s.feature_enabled[i][C.SEG_LVL_SKIP] or \
                        s.feature_enabled[i][C.SEG_LVL_GLOBALMV]:
                    s.seg_id_pre_skip = True
        h.seg = s

    def _delta_q_params(self, r: BitReader, h: FrameHeader) -> None:
        if h.quant.base_q_idx > 0:
            h.delta_q_present = bool(r.f1())
        if h.delta_q_present:
            h.delta_q_res = r.f(2)

    def _delta_lf_params(self, r: BitReader, h: FrameHeader) -> None:
        if h.delta_q_present:
            if not h.allow_intrabc:
                h.delta_lf_present = bool(r.f1())
            if h.delta_lf_present:
                h.delta_lf_res = r.f(2)
                h.delta_lf_multi = bool(r.f1())

    def _compute_lossless(self, h: FrameHeader) -> None:
        coded_lossless = True
        for seg in range(C.MAX_SEGMENTS):
            qidx = _get_qindex(h, seg, ignore_delta_q=True)
            lossless = (qidx == 0 and h.quant.delta_q_y_dc == 0
                        and h.quant.delta_q_u_ac == 0 and h.quant.delta_q_u_dc == 0
                        and h.quant.delta_q_v_ac == 0 and h.quant.delta_q_v_dc == 0)
            h.lossless_segs[seg] = lossless
            if not lossless:
                coded_lossless = False
        h.coded_lossless = coded_lossless
        h.all_lossless = coded_lossless and h.frame_width == h.upscaled_width

    # -- filters -------------------------------------------------------

    def _loop_filter_params(self, r: BitReader, h: FrameHeader) -> None:
        lf = LoopFilterParams()
        if h.primary_ref_frame != C.PRIMARY_REF_NONE:
            prev = self.refs[h.ref_frame_idx[h.primary_ref_frame]].header
            if prev is not None:
                lf.ref_deltas = prev.lf.ref_deltas[:]
                lf.mode_deltas = prev.lf.mode_deltas[:]
        if h.coded_lossless or h.allow_intrabc:
            lf.ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
            lf.mode_deltas = [0, 0]
            h.lf = lf
            return
        lf.level[0] = r.f(6)
        lf.level[1] = r.f(6)
        if self.seq.color.num_planes > 1:
            if lf.level[0] or lf.level[1]:
                lf.level[2] = r.f(6)
                lf.level[3] = r.f(6)
        lf.sharpness = r.f(3)
        lf.delta_enabled = bool(r.f1())
        if lf.delta_enabled:
            if r.f1():  # delta_update
                for i in range(C.NUM_REF_FRAMES):
                    if r.f1():
                        lf.ref_deltas[i] = r.su(7)
                for i in range(2):
                    if r.f1():
                        lf.mode_deltas[i] = r.su(7)
        h.lf = lf

    def _cdef_params(self, r: BitReader, h: FrameHeader) -> None:
        cd = CdefParams()
        if h.coded_lossless or h.allow_intrabc or not self.seq.enable_cdef:
            h.cdef = cd
            return
        cd.damping = r.f(2) + 3
        cd.bits = r.f(2)
        n = 1 << cd.bits
        cd.y_pri_strength = []
        cd.y_sec_strength = []
        cd.uv_pri_strength = []
        cd.uv_sec_strength = []
        for _ in range(n):
            cd.y_pri_strength.append(r.f(4))
            sec = r.f(2)
            cd.y_sec_strength.append(sec + 1 if sec == 3 else sec)
            if self.seq.color.num_planes > 1:
                cd.uv_pri_strength.append(r.f(4))
                sec = r.f(2)
                cd.uv_sec_strength.append(sec + 1 if sec == 3 else sec)
        h.cdef = cd

    def _lr_params(self, r: BitReader, h: FrameHeader) -> None:
        lr = LrParams()
        if h.all_lossless or h.allow_intrabc or not self.seq.enable_restoration:
            h.lr = lr
            return
        remap = [C.RESTORE_NONE, C.RESTORE_SWITCHABLE, C.RESTORE_WIENER,
                 C.RESTORE_SGRPROJ]
        uses_lr = False
        uses_chroma_lr = False
        n_planes = self.seq.color.num_planes
        for p in range(n_planes):
            lr.frame_restoration_type[p] = remap[r.f(2)]
            if lr.frame_restoration_type[p] != C.RESTORE_NONE:
                uses_lr = True
                if p > 0:
                    uses_chroma_lr = True
        lr.uses_lr = uses_lr
        if uses_lr:
            if self.seq.use_128x128_superblock:
                lr_unit_shift = r.f1() + 1
            else:
                lr_unit_shift = r.f1()
                if lr_unit_shift:
                    lr_unit_shift += r.f1()
            lr.loop_restoration_size[0] = 256 >> (2 - lr_unit_shift)
            if self.seq.color.subsampling_x and self.seq.color.subsampling_y \
                    and uses_chroma_lr:
                lr_uv_shift = r.f1()
            else:
                lr_uv_shift = 0
            lr.loop_restoration_size[1] = lr.loop_restoration_size[0] >> lr_uv_shift
            lr.loop_restoration_size[2] = lr.loop_restoration_size[1]
        h.lr = lr

    def _skip_mode_params(self, r: BitReader, h: FrameHeader,
                          frame_is_intra: bool) -> None:
        seq = self.seq
        skip_mode_allowed = False
        if not (frame_is_intra or not h.reference_select
                or not seq.enable_order_hint):
            forward_idx = -1
            backward_idx = -1
            forward_hint = backward_hint = 0
            for i in range(C.REFS_PER_FRAME):
                rh = self.refs[h.ref_frame_idx[i]].order_hint
                if self.get_relative_dist(rh, h.order_hint) < 0:
                    if forward_idx < 0 or self.get_relative_dist(rh, forward_hint) > 0:
                        forward_idx = i
                        forward_hint = rh
                elif self.get_relative_dist(rh, h.order_hint) > 0:
                    if backward_idx < 0 or self.get_relative_dist(rh, backward_hint) < 0:
                        backward_idx = i
                        backward_hint = rh
            if forward_idx < 0:
                skip_mode_allowed = False
            elif backward_idx >= 0:
                skip_mode_allowed = True
                h.skip_mode_frames = [
                    C.LAST_FRAME + min(forward_idx, backward_idx),
                    C.LAST_FRAME + max(forward_idx, backward_idx)]
            else:
                second_forward_idx = -1
                second_forward_hint = 0
                for i in range(C.REFS_PER_FRAME):
                    rh = self.refs[h.ref_frame_idx[i]].order_hint
                    if self.get_relative_dist(rh, forward_hint) < 0:
                        if second_forward_idx < 0 or \
                                self.get_relative_dist(rh, second_forward_hint) > 0:
                            second_forward_idx = i
                            second_forward_hint = rh
                if second_forward_idx >= 0:
                    skip_mode_allowed = True
                    h.skip_mode_frames = [
                        C.LAST_FRAME + min(forward_idx, second_forward_idx),
                        C.LAST_FRAME + max(forward_idx, second_forward_idx)]
        if skip_mode_allowed:
            h.skip_mode_present = bool(r.f1())

    # -- global motion -------------------------------------------------

    def _global_motion_params(self, r: BitReader, h: FrameHeader,
                              frame_is_intra: bool) -> None:
        for ref in range(C.LAST_FRAME, C.ALTREF_FRAME + 1):
            h.gm_type[ref] = C.IDENTITY
            h.gm_params[ref] = [0, 0, 1 << C.WARPEDMODEL_PREC_BITS, 0,
                                0, 1 << C.WARPEDMODEL_PREC_BITS]
        if frame_is_intra:
            return
        for ref in range(C.LAST_FRAME, C.ALTREF_FRAME + 1):
            if r.f1():  # is_global
                if r.f1():  # is_rot_zoom
                    gm_type = C.ROTZOOM
                else:
                    gm_type = C.TRANSLATION if r.f1() else C.AFFINE
            else:
                gm_type = C.IDENTITY
            h.gm_type[ref] = gm_type
            if gm_type >= C.ROTZOOM:
                self._read_global_param(r, h, gm_type, ref, 2)
                self._read_global_param(r, h, gm_type, ref, 3)
                if gm_type == C.AFFINE:
                    self._read_global_param(r, h, gm_type, ref, 4)
                    self._read_global_param(r, h, gm_type, ref, 5)
                else:
                    h.gm_params[ref][4] = -h.gm_params[ref][3]
                    h.gm_params[ref][5] = h.gm_params[ref][2]
            if gm_type >= C.TRANSLATION:
                self._read_global_param(r, h, gm_type, ref, 0)
                self._read_global_param(r, h, gm_type, ref, 1)

    def _read_global_param(self, r: BitReader, h: FrameHeader, gm_type: int,
                           ref: int, idx: int) -> None:
        abs_bits = C.GM_ABS_ALPHA_BITS
        prec_bits = C.GM_ALPHA_PREC_BITS
        if idx < 2:
            if gm_type == C.TRANSLATION:
                abs_bits = (C.GM_ABS_TRANS_ONLY_BITS
                            - (0 if h.allow_high_precision_mv else 1))
                prec_bits = (C.GM_TRANS_ONLY_PREC_BITS
                             - (0 if h.allow_high_precision_mv else 1))
            else:
                abs_bits = C.GM_ABS_TRANS_BITS
                prec_bits = C.GM_TRANS_PREC_BITS
        prec_diff = C.WARPEDMODEL_PREC_BITS - prec_bits
        wm_round = (1 << C.WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
        sub = (1 << prec_bits) if idx % 3 == 2 else 0
        mx = 1 << abs_bits
        # previous value as reference (PrevGmParams): from primary ref frame
        # or defaults
        if h.primary_ref_frame == C.PRIMARY_REF_NONE:
            prev = (1 << C.WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
        else:
            prev_hdr = self.refs[h.ref_frame_idx[h.primary_ref_frame]].header
            if prev_hdr is not None:
                prev = prev_hdr.gm_params[ref][idx]
            else:
                prev = (1 << C.WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
        rv = (prev >> prec_diff) - sub
        v = _decode_signed_subexp_with_ref(r, -mx, mx + 1, rv)
        h.gm_params[ref][idx] = (v << prec_diff) + wm_round

    # -- film grain ----------------------------------------------------

    def _film_grain_params(self, r: BitReader, h: FrameHeader) -> None:
        fg = FilmGrainParams()
        seq = self.seq
        if not seq.film_grain_params_present or \
                (not h.show_frame and not h.showable_frame):
            h.film_grain = fg
            return
        fg.apply_grain = bool(r.f1())
        if not fg.apply_grain:
            h.film_grain = fg
            return
        fg.grain_seed = r.f(16)
        if h.frame_type == C.INTER_FRAME:
            fg.update_grain = bool(r.f1())
        if not fg.update_grain:
            ref_idx = r.f(3)
            saved = self.refs[ref_idx].film_grain
            seed = fg.grain_seed
            if saved is not None:
                fg = dataclasses.replace(saved)
            fg.grain_seed = seed
            fg.update_grain = False
            h.film_grain = fg
            return
        fg.num_y_points = r.f(4)
        for _ in range(fg.num_y_points):
            fg.point_y_value.append(r.f(8))
            fg.point_y_scaling.append(r.f(8))
        if seq.color.mono_chrome:
            fg.chroma_scaling_from_luma = False
        else:
            fg.chroma_scaling_from_luma = bool(r.f1())
        if seq.color.mono_chrome or fg.chroma_scaling_from_luma or \
                (seq.color.subsampling_x == 1 and seq.color.subsampling_y == 1
                 and fg.num_y_points == 0):
            fg.num_cb_points = 0
            fg.num_cr_points = 0
        else:
            fg.num_cb_points = r.f(4)
            for _ in range(fg.num_cb_points):
                fg.point_cb_value.append(r.f(8))
                fg.point_cb_scaling.append(r.f(8))
            fg.num_cr_points = r.f(4)
            for _ in range(fg.num_cr_points):
                fg.point_cr_value.append(r.f(8))
                fg.point_cr_scaling.append(r.f(8))
        fg.grain_scaling = r.f(2) + 8
        fg.ar_coeff_lag = r.f(2)
        num_pos_luma = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
        if fg.num_y_points:
            for _ in range(num_pos_luma):
                fg.ar_coeffs_y.append(r.f(8) - 128)
        if fg.chroma_scaling_from_luma or fg.num_cb_points:
            for _ in range(num_pos_luma + (1 if fg.num_y_points else 0)):
                fg.ar_coeffs_cb.append(r.f(8) - 128)
        if fg.chroma_scaling_from_luma or fg.num_cr_points:
            for _ in range(num_pos_luma + (1 if fg.num_y_points else 0)):
                fg.ar_coeffs_cr.append(r.f(8) - 128)
        fg.ar_coeff_shift = r.f(2) + 6
        fg.grain_scale_shift = r.f(2)
        if fg.num_cb_points:
            fg.cb_mult = r.f(8)
            fg.cb_luma_mult = r.f(8)
            fg.cb_offset = r.f(9)
        if fg.num_cr_points:
            fg.cr_mult = r.f(8)
            fg.cr_luma_mult = r.f(8)
            fg.cr_offset = r.f(9)
        fg.overlap_flag = bool(r.f1())
        fg.clip_to_restricted_range = bool(r.f1())
        h.film_grain = fg

    # -- reference updates --------------------------------------------

    def update_refs(self, h: FrameHeader) -> None:
        """decode_frame_wrapup reference updates (spec §7.20 subset)."""
        for i in range(C.NUM_REF_FRAMES):
            if h.refresh_frame_flags & (1 << i):
                ref = self.refs[i]
                ref.valid = True
                ref.frame_id = h.current_frame_id
                ref.order_hint = h.order_hint
                ref.frame_type = h.frame_type
                ref.upscaled_width = h.upscaled_width
                ref.frame_width = h.frame_width
                ref.frame_height = h.frame_height
                ref.render_width = h.render_width
                ref.render_height = h.render_height
                ref.mi_cols = h.mi_cols
                ref.mi_rows = h.mi_rows
                ref.header = h
                ref.film_grain = h.film_grain
                ref.saved_order_hints = list(getattr(h, "order_hints",
                                                     [0] * 8))

    def _update_refs_show_existing(self, h: FrameHeader) -> None:
        src = self.refs[h.frame_to_show_map_idx]
        for i in range(C.NUM_REF_FRAMES):
            if h.refresh_frame_flags & (1 << i):
                self.refs[i] = dataclasses.replace(src)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _read_delta_q(r: BitReader) -> int:
    if r.f1():
        return r.su(7)
    return 0


def _get_qindex(h: FrameHeader, segment_id: int, ignore_delta_q: bool = False,
                current_q_index: Optional[int] = None) -> int:
    base = h.quant.base_q_idx if current_q_index is None else current_q_index
    if h.seg.enabled and h.seg.feature_enabled[segment_id][C.SEG_LVL_ALT_Q]:
        data = h.seg.feature_data[segment_id][C.SEG_LVL_ALT_Q]
        return max(0, min(255, base + data))
    return max(0, min(255, base))


def _decode_subexp(r: BitReader, num_syms: int) -> int:
    i = 0
    mk = 0
    k = 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return r.ns(num_syms - mk) + mk
        if r.f1():
            i += 1
            mk += a
        else:
            return r.f(b2) + mk


def _inverse_recenter(r: int, v: int) -> int:
    # spec 4.10.x / dav1d inv_recenter: odd v steps BELOW the ref
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _decode_unsigned_subexp_with_ref(r: BitReader, mx: int, ref: int) -> int:
    v = _decode_subexp(r, mx)
    if (ref << 1) <= mx:
        return _inverse_recenter(ref, v)
    return mx - 1 - _inverse_recenter(mx - 1 - ref, v)


def _decode_signed_subexp_with_ref(r: BitReader, low: int, high: int,
                                   ref: int) -> int:
    x = _decode_unsigned_subexp_with_ref(r, high - low, ref - low)
    return x + low
