"""Streaming WebM (Matroska subset) demuxer.

Functional parity target: the vendored nestegg demuxer
(/root/reference/ext/nestegg/nestegg.c) as used by easyav1:
Info/Tracks/SeekHead/Cues/Cluster parsing, SimpleBlock + BlockGroup,
all four lacing modes (none/Xiph/fixed/EBML, nestegg.c:1324-1486),
keyframe detection, lazy cue loading (nestegg.c:1961) and cue-based
cluster seeking (nestegg.c:2377-2435). Fresh implementation: a flat
streaming scanner with an explicit cluster context instead of nestegg's
descriptor-table recursive-descent parser.

Timestamps: Matroska stores timecodes scaled by TimecodeScale (ns per
tick, default 1_000_000 → ticks are ms). This module exposes nanoseconds;
the API layer converts to ms (parity: easyav1.c:343-359).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from easyav1.container import ebml
from easyav1.container.ebml import EBMLReader, EBMLError, EOF, UNKNOWN_SIZE
from easyav1.io.stream import Stream, open_stream

# ---------------------------------------------------------------------------
# Element IDs (RFC 8794 / Matroska spec)

ID_EBML = 0x1A45DFA3
ID_DOCTYPE = 0x4282
ID_SEGMENT = 0x18538067
ID_SEEKHEAD = 0x114D9B74
ID_SEEK = 0x4DBB
ID_SEEKID = 0x53AB
ID_SEEKPOSITION = 0x53AC
ID_INFO = 0x1549A966
ID_TIMECODESCALE = 0x2AD7B1
ID_DURATION = 0x4489
ID_TRACKS = 0x1654AE6B
ID_TRACKENTRY = 0xAE
ID_TRACKNUMBER = 0xD7
ID_TRACKUID = 0x73C5
ID_TRACKTYPE = 0x83
ID_FLAGLACING = 0x9C
ID_DEFAULTDURATION = 0x23E383
ID_CODECID = 0x86
ID_CODECPRIVATE = 0x63A2
ID_CODECDELAY = 0x56AA
ID_SEEKPREROLL = 0x56BB
ID_VIDEO = 0xE0
ID_PIXELWIDTH = 0xB0
ID_PIXELHEIGHT = 0xBA
ID_DISPLAYWIDTH = 0x54B0
ID_DISPLAYHEIGHT = 0x54BA
ID_STEREOMODE = 0x53B8
ID_ALPHAMODE = 0x53C0
ID_AUDIO = 0xE1
ID_SAMPLINGFREQUENCY = 0xB5
ID_OUTPUTSAMPLINGFREQUENCY = 0x78B5
ID_CHANNELS = 0x9F
ID_BITDEPTH = 0x6264
ID_CLUSTER = 0x1F43B675
ID_TIMECODE = 0xE7
ID_SIMPLEBLOCK = 0xA3
ID_BLOCKGROUP = 0xA0
ID_BLOCK = 0xA1
ID_BLOCKDURATION = 0x9B
ID_REFERENCEBLOCK = 0xFB
ID_DISCARDPADDING = 0x75A2
# BlockAdditions (alpha planes etc.; parity: nestegg.c:1753 block
# additional parse)
ID_BLOCKADDITIONS = 0x75A1
ID_BLOCKMORE = 0xA6
ID_BLOCKADDID = 0xEE
ID_BLOCKADDITIONAL = 0xA5
# ContentEncodings (encryption/compression recognition; parity:
# nestegg.c:1252,1606 — nestegg tracks the encoding to strip headers
# and to refuse encrypted payloads cleanly)
ID_CONTENTENCODINGS = 0x6D80
ID_CONTENTENCODING = 0x6240
ID_CONTENTENCODINGTYPE = 0x5033
ID_CONTENTCOMPRESSION = 0x5034
ID_CONTENTCOMPALGO = 0x4254
ID_CONTENTCOMPSETTINGS = 0x4255
ID_CONTENTENCRYPTION = 0x5035
ID_CUES = 0x1C53BB6B
ID_CUEPOINT = 0xBB
ID_CUETIME = 0xB3
ID_CUETRACKPOSITIONS = 0xB7
ID_CUETRACK = 0xF7
ID_CUECLUSTERPOSITION = 0xF1
ID_CUERELATIVEPOSITION = 0xF0
ID_CUEBLOCKNUMBER = 0x5378
ID_VOID = 0xEC
ID_CRC32 = 0xBF

# Top-level (Segment-child) ids that terminate an unknown-size cluster.
_L1_IDS = frozenset(
    {ID_SEEKHEAD, ID_INFO, ID_TRACKS, ID_CLUSTER, ID_CUES, 0x1254C367,
     0x1043A770, 0x1941A469}
)


class TrackType(enum.IntEnum):
    VIDEO = 1
    AUDIO = 2
    # Matroska defines more (subtitle=17 etc.); others are ignored.


# Codec IDs (parity: nestegg.h:71-76; easyav1 accepts only AV1 + Vorbis,
# easyav1.c:1330,1354 — rejection happens in the API layer, not here).
CODEC_AV1 = "V_AV1"
CODEC_VP8 = "V_VP8"
CODEC_VP9 = "V_VP9"
CODEC_VORBIS = "A_VORBIS"
CODEC_OPUS = "A_OPUS"


@dataclasses.dataclass
class TrackInfo:
    number: int
    type: Optional[TrackType]
    codec_id: str
    codec_private: bytes = b""
    codec_delay_ns: int = 0
    seek_preroll_ns: int = 0
    default_duration_ns: int = 0
    # video
    width: int = 0
    height: int = 0
    display_width: int = 0
    display_height: int = 0
    # audio
    sample_rate: float = 0.0
    channels: int = 0
    bit_depth: int = 0
    # ContentEncodings state: an encrypted track's blocks are skipped
    # with a warning (we cannot decrypt); header-stripping compression
    # (the only compression WebM allows) re-prepends strip_bytes to
    # every frame; any other compression algo marks the track
    # unsupported and its blocks are skipped likewise
    encrypted: bool = False
    strip_bytes: bytes = b""
    unsupported_encoding: bool = False

    def vorbis_headers(self) -> List[bytes]:
        """Split Xiph-laced CodecPrivate into the 3 Vorbis header packets
        (parity: nestegg_track_codec_data, nestegg.c:2529)."""
        data = self.codec_private
        if not data:
            return []
        count = data[0] + 1
        pos = 1
        sizes = []
        for _ in range(count - 1):
            size = 0
            while True:
                b = data[pos]
                pos += 1
                size += b
                if b != 255:
                    break
            sizes.append(size)
        out = []
        for size in sizes:
            out.append(data[pos:pos + size])
            pos += size
        out.append(data[pos:])
        return out


@dataclasses.dataclass
class CuePoint:
    time_ns: int
    track: int
    cluster_pos: int  # relative to segment payload start
    block_number: int = 0


@dataclasses.dataclass
class Packet:
    """One demuxed block: possibly several laced frames sharing a timestamp.

    Parity: nestegg_packet (chunked data, nestegg.c:1490) as consumed by
    easyav1's packet queue (easyav1.c:97-115).
    """

    track: int
    timestamp_ns: int
    keyframe: bool
    frames: List[bytes]
    discard_padding_ns: int = 0
    duration_ns: int = 0
    # BlockAdditions payloads keyed by BlockAddID (e.g. 1 = alpha
    # plane bitstream for VP8/VP9/AV1 alpha WebM); None when absent
    additions: Optional[Dict[int, bytes]] = None


class WebMError(EBMLError):
    pass


class WebMDemuxer:
    """Pull demuxer: init parses headers up to the first Cluster, then
    read_packet() streams blocks. seek_to_cue() repositions to a cue point."""

    def __init__(self, source, max_init_scan: int = 1 << 30):
        self.stream: Stream = open_stream(source)
        self.reader = EBMLReader(self.stream)
        self.timecode_scale = 1_000_000  # ns per tick (default: ticks = ms)
        self.duration_ticks: float = 0.0
        self.tracks: Dict[int, TrackInfo] = {}
        self._segment_start = 0
        self._segment_end: Optional[int] = None
        self._first_cluster_pos: Optional[int] = None
        self._cues_pos: Optional[int] = None  # absolute, from SeekHead
        self._cues: Optional[List[CuePoint]] = None
        self._cluster_end: Optional[int] = None
        self._cluster_time: Optional[int] = None
        self._in_cluster = False
        self._saved_state: Optional[Tuple] = None
        self._enc_warned: set = set()
        self._parse_init(max_init_scan)

    # -- init --------------------------------------------------------------

    def _parse_init(self, max_scan: int) -> None:
        r = self.reader
        eid, size = r.read_element_header()
        if eid != ID_EBML:
            raise WebMError(f"not an EBML stream (leading id {eid:#x})")
        end = r.tell() + size
        doctype = "matroska"
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_DOCTYPE:
                doctype = r.read_string(csize)
            else:
                r.skip(csize)
        if doctype not in ("webm", "matroska"):
            raise WebMError(f"unsupported doctype {doctype!r}")

        eid, size = r.read_element_header()
        if eid != ID_SEGMENT:
            raise WebMError(f"no Segment (got {eid:#x})")
        self._segment_start = r.tell()
        self._segment_end = None if size == UNKNOWN_SIZE else r.tell() + size

        # Scan Segment children until the first Cluster.
        while not self._at_segment_end():
            pos = r.tell()
            try:
                cid, csize = r.read_element_header()
            except EOF:
                break
            if cid == ID_CLUSTER:
                self._first_cluster_pos = pos
                r.seek(pos)
                break
            if cid == ID_SEEKHEAD:
                self._parse_seekhead(csize)
            elif cid == ID_INFO:
                self._parse_info(csize)
            elif cid == ID_TRACKS:
                self._parse_tracks(csize)
            elif cid == ID_CUES:
                self._parse_cues(csize)
            else:
                if csize == UNKNOWN_SIZE:
                    raise WebMError(f"unknown-size element {cid:#x} before clusters")
                r.skip(csize)
        if not self.tracks:
            raise WebMError("no Tracks element found")

    def _at_segment_end(self) -> bool:
        if self._segment_end is not None and self.reader.tell() >= self._segment_end:
            return True
        return self.reader.at_eof()

    def _parse_seekhead(self, size: int) -> None:
        r = self.reader
        end = r.tell() + size
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_SEEK:
                sub_end = r.tell() + csize
                seek_id = None
                seek_pos = None
                while r.tell() < sub_end:
                    sid, ssize = r.read_element_header()
                    if sid == ID_SEEKID:
                        seek_id = r.read_uint(ssize)
                    elif sid == ID_SEEKPOSITION:
                        seek_pos = r.read_uint(ssize)
                    else:
                        r.skip(ssize)
                if seek_id == ID_CUES and seek_pos is not None:
                    self._cues_pos = self._segment_start + seek_pos
            else:
                r.skip(csize)

    def _parse_info(self, size: int) -> None:
        r = self.reader
        end = r.tell() + size
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_TIMECODESCALE:
                self.timecode_scale = r.read_uint(csize)
            elif cid == ID_DURATION:
                self.duration_ticks = r.read_float(csize)
            else:
                r.skip(csize)

    def _parse_tracks(self, size: int) -> None:
        r = self.reader
        end = r.tell() + size
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_TRACKENTRY:
                self._parse_track_entry(csize)
            else:
                r.skip(csize)

    def _parse_track_entry(self, size: int) -> None:
        r = self.reader
        end = r.tell() + size
        t = TrackInfo(number=0, type=None, codec_id="")
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_TRACKNUMBER:
                t.number = r.read_uint(csize)
            elif cid == ID_TRACKTYPE:
                raw = r.read_uint(csize)
                t.type = TrackType(raw) if raw in (1, 2) else None
            elif cid == ID_CODECID:
                t.codec_id = r.read_string(csize)
            elif cid == ID_CODECPRIVATE:
                t.codec_private = r.read_bytes(csize)
            elif cid == ID_CODECDELAY:
                t.codec_delay_ns = r.read_uint(csize)
            elif cid == ID_SEEKPREROLL:
                t.seek_preroll_ns = r.read_uint(csize)
            elif cid == ID_DEFAULTDURATION:
                t.default_duration_ns = r.read_uint(csize)
            elif cid == ID_CONTENTENCODINGS:
                self._parse_content_encodings(t, csize)
            elif cid == ID_VIDEO:
                vend = r.tell() + csize
                while r.tell() < vend:
                    vid, vsize = r.read_element_header()
                    if vid == ID_PIXELWIDTH:
                        t.width = r.read_uint(vsize)
                    elif vid == ID_PIXELHEIGHT:
                        t.height = r.read_uint(vsize)
                    elif vid == ID_DISPLAYWIDTH:
                        t.display_width = r.read_uint(vsize)
                    elif vid == ID_DISPLAYHEIGHT:
                        t.display_height = r.read_uint(vsize)
                    else:
                        r.skip(vsize)
            elif cid == ID_AUDIO:
                aend = r.tell() + csize
                while r.tell() < aend:
                    aid, asize = r.read_element_header()
                    if aid == ID_SAMPLINGFREQUENCY:
                        t.sample_rate = r.read_float(asize)
                    elif aid == ID_CHANNELS:
                        t.channels = r.read_uint(asize)
                    elif aid == ID_BITDEPTH:
                        t.bit_depth = r.read_uint(asize)
                    else:
                        r.skip(asize)
            else:
                r.skip(csize)
        if t.number:
            self.tracks[t.number] = t

    def _parse_content_encodings(self, t: TrackInfo, size: int) -> None:
        """ContentEncodings (parity role: nestegg.c:1252 track encoding
        descriptors + :1606 per-block application).  WebM permits only
        header-stripping compression; encryption and other compression
        algos mark the track so its blocks are skipped cleanly."""
        r = self.reader
        end = r.tell() + size
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid != ID_CONTENTENCODING:
                r.skip(csize)
                continue
            eend = r.tell() + csize
            while r.tell() < eend:
                eid, esize = r.read_element_header()
                if eid == ID_CONTENTENCRYPTION:
                    t.encrypted = True
                    r.skip(esize)
                elif eid == ID_CONTENTCOMPRESSION:
                    cend = r.tell() + esize
                    algo = 0
                    settings = b""
                    while r.tell() < cend:
                        fid, fsize = r.read_element_header()
                        if fid == ID_CONTENTCOMPALGO:
                            algo = r.read_uint(fsize)
                        elif fid == ID_CONTENTCOMPSETTINGS:
                            settings = r.read_bytes(fsize)
                        else:
                            r.skip(fsize)
                    if algo == 3:       # header stripping
                        t.strip_bytes = settings
                    else:               # zlib/bzlib/lzo1x: not in WebM
                        t.unsupported_encoding = True
                else:
                    r.skip(esize)

    def _parse_cues(self, size: int) -> None:
        r = self.reader
        end = r.tell() + size
        cues: List[CuePoint] = []
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_CUEPOINT:
                pend = r.tell() + csize
                time_ticks = 0
                while r.tell() < pend:
                    pid, psize = r.read_element_header()
                    if pid == ID_CUETIME:
                        time_ticks = r.read_uint(psize)
                    elif pid == ID_CUETRACKPOSITIONS:
                        tend = r.tell() + psize
                        track = 0
                        cluster_pos = 0
                        block_number = 0
                        while r.tell() < tend:
                            tid, tsize = r.read_element_header()
                            if tid == ID_CUETRACK:
                                track = r.read_uint(tsize)
                            elif tid == ID_CUECLUSTERPOSITION:
                                cluster_pos = r.read_uint(tsize)
                            elif tid == ID_CUEBLOCKNUMBER:
                                block_number = r.read_uint(tsize)
                            else:
                                r.skip(tsize)
                        cues.append(
                            CuePoint(
                                time_ns=time_ticks * self.timecode_scale,
                                track=track,
                                cluster_pos=cluster_pos,
                                block_number=block_number,
                            )
                        )
                    else:
                        r.skip(psize)
            else:
                r.skip(csize)
        self._cues = cues

    # -- metadata accessors --------------------------------------------------

    @property
    def duration_ns(self) -> int:
        return int(self.duration_ticks * self.timecode_scale)

    def tracks_of_type(self, track_type: TrackType) -> List[TrackInfo]:
        return [t for t in self.tracks.values() if t.type == track_type]

    # -- cues ----------------------------------------------------------------

    def load_cues(self) -> List[CuePoint]:
        """Lazy cue load via SeekHead (parity: ne_init_cue_points,
        nestegg.c:1961): jump to the Cues element, parse, and return."""
        if self._cues is not None:
            return self._cues
        if self._cues_pos is None:
            self._cues = []
            return self._cues
        r = self.reader
        saved = r.tell()
        saved_state = (self._in_cluster, self._cluster_end, self._cluster_time)
        try:
            r.seek(self._cues_pos)
            cid, csize = r.read_element_header()
            if cid == ID_CUES:
                self._parse_cues(csize)
            else:
                self._cues = []
        except (EOF, EBMLError):
            self._cues = []
        finally:
            r.seek(saved)
            self._in_cluster, self._cluster_end, self._cluster_time = saved_state
        return self._cues

    def has_cues(self) -> bool:
        return bool(self.load_cues())

    def find_cue(self, timestamp_ns: int, track: Optional[int] = None) -> Optional[CuePoint]:
        """Last cue point with time <= timestamp (parity:
        get_closest_cue_point easyav1.c:2929 / ne_find_cue_point_for_tstamp).
        Falls back to the first cue if the timestamp precedes all cues."""
        cues = self.load_cues()
        if track is not None:
            tcues = [c for c in cues if c.track == track]
            cues = tcues or cues
        if not cues:
            return None
        best = cues[0]
        for c in cues:
            if c.time_ns <= timestamp_ns and c.time_ns >= best.time_ns:
                best = c
        return best

    def seek_to_cue(self, cue: CuePoint) -> None:
        """Reposition the stream to the cue's cluster (parity:
        nestegg_offset_seek, nestegg.c:2377)."""
        self.reader.seek(self._segment_start + cue.cluster_pos)
        self._in_cluster = False
        self._cluster_end = None
        self._cluster_time = None

    def seek_to_start(self) -> None:
        if self._first_cluster_pos is None:
            raise WebMError("no clusters in stream")
        self.reader.seek(self._first_cluster_pos)
        self._in_cluster = False
        self._cluster_end = None
        self._cluster_time = None

    # -- packet streaming ----------------------------------------------------

    def save_state(self) -> None:
        """Snapshot parse position for error recovery (parity: ne_ctx_save
        before each nestegg_read_packet, nestegg.c:2897-2900)."""
        self._saved_state = (
            self.reader.tell(), self._in_cluster, self._cluster_end,
            self._cluster_time,
        )

    def restore_state(self) -> None:
        """Parity: nestegg_read_reset (nestegg.c:2881)."""
        if self._saved_state is None:
            return
        pos, in_cluster, cluster_end, cluster_time = self._saved_state
        self.reader.seek(pos)
        self._in_cluster = in_cluster
        self._cluster_end = cluster_end
        self._cluster_time = cluster_time

    def read_packet(self) -> Optional[Packet]:
        """Next block as a Packet, or None at end of stream."""
        r = self.reader
        while True:
            if self._in_cluster and self._cluster_end is not None \
                    and r.tell() >= self._cluster_end:
                self._in_cluster = False
            if self._at_segment_end():
                return None
            pos = r.tell()
            try:
                cid, csize = r.read_element_header()
            except EOF:
                return None
            if cid == ID_CLUSTER:
                self._in_cluster = True
                self._cluster_end = None if csize == UNKNOWN_SIZE else r.tell() + csize
                self._cluster_time = None
                continue
            if not self._in_cluster:
                if csize == UNKNOWN_SIZE:
                    raise WebMError(f"unknown-size element {cid:#x} outside cluster")
                r.skip(csize)
                continue
            # Inside a cluster.
            if self._cluster_end is None and cid in _L1_IDS:
                # Unknown-size cluster terminated by the next level-1 element.
                self._in_cluster = False
                r.seek(pos)
                continue
            if cid == ID_TIMECODE:
                self._cluster_time = r.read_uint(csize)
            elif cid == ID_SIMPLEBLOCK:
                pkt = self._parse_block(r.read_bytes(csize), simple=True)
                if pkt is not None:
                    return pkt
            elif cid == ID_BLOCKGROUP:
                pkt = self._parse_block_group(csize)
                if pkt is not None:
                    return pkt
            else:
                if csize == UNKNOWN_SIZE:
                    raise WebMError(f"unknown-size element {cid:#x} in cluster")
                r.skip(csize)

    def _parse_block_group(self, size: int) -> Optional[Packet]:
        r = self.reader
        end = r.tell() + size
        block_data = None
        duration_ticks = 0
        has_reference = False
        discard_padding = 0
        additions: Optional[Dict[int, bytes]] = None
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid == ID_BLOCK:
                block_data = r.read_bytes(csize)
            elif cid == ID_BLOCKDURATION:
                duration_ticks = r.read_uint(csize)
            elif cid == ID_REFERENCEBLOCK:
                r.skip(csize)
                has_reference = True
            elif cid == ID_DISCARDPADDING:
                discard_padding = r.read_sint(csize)
            elif cid == ID_BLOCKADDITIONS:
                additions = self._parse_block_additions(csize)
            else:
                r.skip(csize)
        if block_data is None:
            return None
        pkt = self._parse_block(block_data, simple=False)
        if pkt is None:
            return None
        # In a BlockGroup, keyframe-ness = absence of ReferenceBlock
        # (Matroska semantics; parity: nestegg.c block group handling).
        pkt.keyframe = not has_reference
        pkt.discard_padding_ns = discard_padding
        pkt.duration_ns = duration_ticks * self.timecode_scale
        pkt.additions = additions
        return pkt

    def _parse_block_additions(self, size: int) -> Dict[int, bytes]:
        """BlockAdditions -> {BlockAddID: payload} (parity:
        nestegg.c:1753 block_additional parse; BlockAddID defaults
        to 1, the alpha-channel convention in WebM)."""
        r = self.reader
        end = r.tell() + size
        out: Dict[int, bytes] = {}
        while r.tell() < end:
            cid, csize = r.read_element_header()
            if cid != ID_BLOCKMORE:
                r.skip(csize)
                continue
            mend = r.tell() + csize
            add_id = 1
            payload = b""
            while r.tell() < mend:
                mid, msize = r.read_element_header()
                if mid == ID_BLOCKADDID:
                    add_id = r.read_uint(msize)
                elif mid == ID_BLOCKADDITIONAL:
                    payload = r.read_bytes(msize)
                else:
                    r.skip(msize)
            out[add_id] = payload
        return out

    def _parse_block(self, data: bytes, simple: bool) -> Optional[Packet]:
        """Block payload: track vint, s16 relative timecode, flags, lacing,
        frame data (parity: ne_read_block + lacing readers,
        nestegg.c:1252-1536)."""
        track, pos = ebml.read_block_vint(data, 0)
        if track not in self.tracks:
            return None
        tinfo = self.tracks[track]
        if tinfo.encrypted or tinfo.unsupported_encoding:
            # cannot decrypt / decompress: skip the block cleanly with
            # a one-time warning (parity: nestegg refuses encrypted
            # payloads rather than handing out ciphertext)
            if track not in self._enc_warned:
                self._enc_warned.add(track)
                from easyav1.utils.log import Logger
                why = "encrypted" if tinfo.encrypted \
                    else "unsupported ContentEncoding"
                Logger().warning(
                    f"track {track}: {why}; skipping its blocks")
            return None
        rel = int.from_bytes(data[pos:pos + 2], "big", signed=True)
        flags = data[pos + 2]
        pos += 3
        keyframe = bool(flags & 0x80) if simple else False
        lacing = (flags >> 1) & 0x3  # 0 none, 1 Xiph, 2 fixed, 3 EBML

        if self._cluster_time is None:
            self._cluster_time = 0
        abs_ticks = self._cluster_time + rel
        timestamp_ns = abs_ticks * self.timecode_scale

        frames: List[bytes] = []
        if lacing == 0:
            frames.append(data[pos:])
        else:
            count = data[pos] + 1
            pos += 1
            if count > 256:
                raise WebMError("too many laced frames")
            sizes: List[int] = []
            if lacing == 1:  # Xiph
                for _ in range(count - 1):
                    sz = 0
                    while True:
                        b = data[pos]
                        pos += 1
                        sz += b
                        if b != 255:
                            break
                    sizes.append(sz)
            elif lacing == 2:  # fixed
                total = len(data) - pos
                if total % count:
                    raise WebMError("fixed lacing size not divisible")
                sizes = [total // count] * (count - 1)
            else:  # EBML
                first, pos = ebml.read_block_vint(data, pos)
                sizes.append(first)
                prev = first
                for _ in range(count - 2):
                    delta, pos = ebml.read_block_svint(data, pos)
                    prev += delta
                    sizes.append(prev)
            for sz in sizes:
                frames.append(data[pos:pos + sz])
                pos += sz
            frames.append(data[pos:])  # last frame: remainder
        if tinfo.strip_bytes:
            # header-stripping compression: the muxer removed this
            # prefix from every frame (nestegg.c:1606 role)
            frames = [tinfo.strip_bytes + f for f in frames]
        return Packet(
            track=track,
            timestamp_ns=timestamp_ns,
            keyframe=keyframe,
            frames=frames,
        )
