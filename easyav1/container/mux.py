"""Minimal WebM muxer.

Used by the test suite to craft edge-case containers the ffmpeg muxer will
not produce (Xiph/fixed/EBML lacing, unknown-size clusters, BlockGroups),
and usable as a standalone remux feature. Writes Info/Tracks/Clusters/Cues
with seekable cue points.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

from easyav1.container import webm as W
from easyav1.container.ebml import encode_id, encode_vint, encode_unknown_size


def _elem(eid: int, payload: bytes) -> bytes:
    return encode_id(eid) + encode_vint(len(payload)) + payload


def _uint(value: int) -> bytes:
    n = max(1, (value.bit_length() + 7) // 8)
    return value.to_bytes(n, "big")


def _sint(value: int) -> bytes:
    n = 1
    while not (-(1 << (8 * n - 1)) <= value < (1 << (8 * n - 1))):
        n += 1
    return value.to_bytes(n, "big", signed=True)


def _float(value: float) -> bytes:
    return struct.pack(">d", value)


def xiph_lace_sizes(sizes: Sequence[int]) -> bytes:
    out = bytearray()
    for s in sizes:
        while s >= 255:
            out.append(255)
            s -= 255
        out.append(s)
    return bytes(out)


class MuxTrack:
    def __init__(self, number: int, track_type: W.TrackType, codec_id: str,
                 codec_private: bytes = b"", width: int = 0, height: int = 0,
                 sample_rate: float = 0.0, channels: int = 0,
                 default_duration_ns: int = 0, codec_delay_ns: int = 0,
                 encrypted: bool = False, strip_bytes: bytes = b"",
                 compression_algo: int = -1):
        self.number = number
        self.type = track_type
        self.codec_id = codec_id
        self.codec_private = codec_private
        self.width = width
        self.height = height
        self.sample_rate = sample_rate
        self.channels = channels
        self.default_duration_ns = default_duration_ns
        self.codec_delay_ns = codec_delay_ns
        # ContentEncodings test knobs: encryption marker, header-strip
        # prefix (algo 3), or an explicit (unsupported) compression algo
        self.encrypted = encrypted
        self.strip_bytes = strip_bytes
        self.compression_algo = compression_algo


class WebMMuxer:
    """Collects packets, then writes a complete WebM file with cues."""

    def __init__(self, timecode_scale: int = 1_000_000):
        self.timecode_scale = timecode_scale
        self.tracks: List[MuxTrack] = []
        # (timestamp_ticks, track, keyframe, [frames], lacing, is_blockgroup)
        self._blocks: List[tuple] = []

    def add_track(self, track: MuxTrack) -> None:
        self.tracks.append(track)

    def add_packet(self, track: int, timestamp_ns: int, frames: Sequence[bytes],
                   keyframe: bool = True, lacing: int = 0,
                   blockgroup: bool = False,
                   additions: Optional[dict] = None) -> None:
        ticks = timestamp_ns // self.timecode_scale
        if additions:
            blockgroup = True   # BlockAdditions require a BlockGroup
        self._blocks.append((ticks, track, keyframe, list(frames), lacing,
                             blockgroup, additions))

    # -- block encoding ----------------------------------------------------

    @staticmethod
    def _encode_block_payload(track: int, rel_ticks: int, keyframe: bool,
                              frames: Sequence[bytes], lacing: int,
                              simple: bool) -> bytes:
        assert 1 <= track < 127
        out = bytearray()
        out += bytes([0x80 | track])
        out += rel_ticks.to_bytes(2, "big", signed=True)
        flags = 0
        if simple and keyframe:
            flags |= 0x80
        if len(frames) > 1 and lacing == 0:
            lacing = 1  # must lace
        if len(frames) == 1:
            lacing = 0
        flags |= (lacing & 3) << 1
        out += bytes([flags])
        if lacing == 0:
            out += frames[0]
        else:
            out += bytes([len(frames) - 1])
            if lacing == 1:  # Xiph
                out += xiph_lace_sizes([len(f) for f in frames[:-1]])
            elif lacing == 2:  # fixed
                sz = len(frames[0])
                assert all(len(f) == sz for f in frames)
            else:  # EBML
                sizes = [len(f) for f in frames]
                out += encode_vint(sizes[0])
                prev = sizes[0]
                for s in sizes[1:-1]:
                    delta = s - prev
                    # signed vint: value + bias, pick smallest length
                    n = 1
                    while not (-(1 << (7 * n - 1)) + 1 <= delta <= (1 << (7 * n - 1)) - 1):
                        n += 1
                    bias = (1 << (7 * n - 1)) - 1
                    out += encode_vint(delta + bias, n)
                    prev = s
            for f in frames:
                out += f
        return bytes(out)

    # -- document assembly -------------------------------------------------

    def _track_entry(self, t: MuxTrack) -> bytes:
        payload = _elem(W.ID_TRACKNUMBER, _uint(t.number))
        payload += _elem(W.ID_TRACKUID, _uint(t.number))
        payload += _elem(W.ID_TRACKTYPE, _uint(int(t.type)))
        payload += _elem(W.ID_CODECID, t.codec_id.encode())
        if t.codec_private:
            payload += _elem(W.ID_CODECPRIVATE, t.codec_private)
        if t.default_duration_ns:
            payload += _elem(W.ID_DEFAULTDURATION, _uint(t.default_duration_ns))
        if t.codec_delay_ns:
            payload += _elem(W.ID_CODECDELAY, _uint(t.codec_delay_ns))
        if t.encrypted or t.strip_bytes or t.compression_algo >= 0:
            enc = _elem(W.ID_CONTENTENCODINGTYPE,
                        _uint(1 if t.encrypted else 0))
            if t.encrypted:
                enc += _elem(W.ID_CONTENTENCRYPTION,
                             _elem(0x47E1, _uint(5)))  # AESSettings stub
            elif t.strip_bytes:
                comp = _elem(W.ID_CONTENTCOMPALGO, _uint(3))
                comp += _elem(W.ID_CONTENTCOMPSETTINGS, t.strip_bytes)
                enc += _elem(W.ID_CONTENTCOMPRESSION, comp)
            else:
                comp = _elem(W.ID_CONTENTCOMPALGO,
                             _uint(t.compression_algo))
                enc += _elem(W.ID_CONTENTCOMPRESSION, comp)
            payload += _elem(
                W.ID_CONTENTENCODINGS,
                _elem(W.ID_CONTENTENCODING, enc))
        if t.type == W.TrackType.VIDEO:
            v = _elem(W.ID_PIXELWIDTH, _uint(t.width))
            v += _elem(W.ID_PIXELHEIGHT, _uint(t.height))
            payload += _elem(W.ID_VIDEO, v)
        elif t.type == W.TrackType.AUDIO:
            a = _elem(W.ID_SAMPLINGFREQUENCY, _float(t.sample_rate))
            a += _elem(W.ID_CHANNELS, _uint(t.channels))
            payload += _elem(W.ID_AUDIO, a)
        return _elem(W.ID_TRACKENTRY, payload)

    def finalize(self, cluster_interval_ticks: int = 1000,
                 unknown_size_clusters: bool = False) -> bytes:
        """Assemble the full WebM byte string."""
        ebml_header = _elem(
            W.ID_EBML,
            _elem(0x4286, _uint(1)) + _elem(0x42F7, _uint(1)) +
            _elem(0x42F2, _uint(4)) + _elem(0x42F3, _uint(8)) +
            _elem(W.ID_DOCTYPE, b"webm") +
            _elem(0x4287, _uint(4)) + _elem(0x4285, _uint(2)),
        )

        blocks = sorted(self._blocks, key=lambda b: b[0])
        max_ticks = blocks[-1][0] if blocks else 0

        info = _elem(W.ID_TIMECODESCALE, _uint(self.timecode_scale))
        info += _elem(W.ID_DURATION, _float(float(max_ticks + 1)))
        info += _elem(0x4D80, b"easyav1")  # MuxingApp
        info += _elem(0x5741, b"easyav1")  # WritingApp
        info_elem = _elem(W.ID_INFO, info)

        tracks_elem = _elem(
            W.ID_TRACKS, b"".join(self._track_entry(t) for t in self.tracks)
        )

        video_tracks = {t.number for t in self.tracks if t.type == W.TrackType.VIDEO}
        cue_track = min(video_tracks) if video_tracks else (
            self.tracks[0].number if self.tracks else 1)

        # Group blocks into clusters; collect cue info.
        clusters: List[bytes] = []
        cue_entries: List[tuple] = []  # (time_ticks, cluster_index)
        cluster_groups: List[List[tuple]] = []
        cur: List[tuple] = []
        cur_start: Optional[int] = None
        for b in blocks:
            ticks, track, keyframe = b[0], b[1], b[2]
            if cur_start is None:
                cur_start = ticks
            # New cluster on interval or on a cue-track keyframe, so cue
            # points land on clusters that start with their keyframe.
            if cur and (ticks - cur_start >= cluster_interval_ticks
                        or (track == cue_track and keyframe)):
                cluster_groups.append(cur)
                cur = []
                cur_start = ticks
            cur.append(b)
        if cur:
            cluster_groups.append(cur)

        for group in cluster_groups:
            base = group[0][0]
            clusters.append(self._encode_cluster_group(group, base, unknown_size_clusters))
            kf = next((g for g in group if g[1] == cue_track and g[2]), None)
            if kf is not None:
                cue_entries.append((kf[0], len(clusters) - 1))

        # SeekHead → Cues (written after the clusters). Fixed 8-byte
        # position payload so the SeekHead size is stable while we compute
        # the actual offset below.
        def _seekhead(cues_offset: int) -> bytes:
            seek = _elem(W.ID_SEEKID, _uint(W.ID_CUES))
            seek += _elem(W.ID_SEEKPOSITION, cues_offset.to_bytes(8, "big"))
            return _elem(W.ID_SEEKHEAD, _elem(W.ID_SEEK, seek))

        # Compute cluster offsets relative to segment payload start.
        head = _seekhead(0) + info_elem + tracks_elem
        offsets = []
        pos = len(head)
        for c in clusters:
            offsets.append(pos)
            pos += len(c)
        cues_offset = pos
        cues_payload = b""
        for time_ticks, ci in cue_entries:
            ctp = _elem(W.ID_CUETRACK, _uint(cue_track))
            ctp += _elem(W.ID_CUECLUSTERPOSITION, _uint(offsets[ci]))
            cp = _elem(W.ID_CUETIME, _uint(time_ticks))
            cp += _elem(W.ID_CUETRACKPOSITIONS, ctp)
            cues_payload += _elem(W.ID_CUEPOINT, cp)
        cues_elem = _elem(W.ID_CUES, cues_payload) if cues_payload else b""

        head = _seekhead(cues_offset) + info_elem + tracks_elem
        segment_payload = head + b"".join(clusters) + cues_elem
        segment = encode_id(W.ID_SEGMENT) + encode_vint(len(segment_payload), 8) \
            + segment_payload
        return ebml_header + segment

    def _encode_cluster_group(self, group: List[tuple], base_ticks: int,
                              unknown_size: bool) -> bytes:
        payload = _elem(W.ID_TIMECODE, _uint(base_ticks))
        for ticks, track, keyframe, frames, lacing, blockgroup, adds \
                in group:
            rel = ticks - base_ticks
            if blockgroup:
                block = self._encode_block_payload(track, rel, keyframe, frames,
                                                  lacing, simple=False)
                bg = _elem(W.ID_BLOCK, block)
                if not keyframe:
                    bg += _elem(W.ID_REFERENCEBLOCK, _sint(-1))
                if adds:
                    mores = b""
                    for add_id, data in sorted(adds.items()):
                        more = _elem(W.ID_BLOCKADDID, _uint(add_id))
                        more += _elem(W.ID_BLOCKADDITIONAL, data)
                        mores += _elem(W.ID_BLOCKMORE, more)
                    bg += _elem(W.ID_BLOCKADDITIONS, mores)
                payload += _elem(W.ID_BLOCKGROUP, bg)
            else:
                block = self._encode_block_payload(track, rel, keyframe, frames,
                                                  lacing, simple=True)
                payload += _elem(W.ID_SIMPLEBLOCK, block)
        if unknown_size:
            return encode_id(W.ID_CLUSTER) + encode_unknown_size(8) + payload
        return _elem(W.ID_CLUSTER, payload)
