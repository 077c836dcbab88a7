#!/usr/bin/env python3
"""Postfilter isolation probe.

Rewrites a fixture so that selected decode-order frames have their
loop-filter levels and/or CDEF strengths zeroed in the frame header
(width-safe for CDEF; LF levels are re-spliced since zeroing drops the
chroma-level fields), appends a show_existing_frame for the target
slot, runs the dav1d oracle, and diffs our decode of the SAME modified
stream.  This separates reconstruction bugs from loop-filter bugs from
CDEF bugs on a per-frame basis: identical refs, single variable.

Usage:
  python tools/filter_probe.py <fixture.webm> <decode_order_idx> <slot>
         [lf|cdef|both]
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from easyav1.container.mux import MuxTrack, WebMMuxer  # noqa: E402
from easyav1.container.webm import TrackType, WebMDemuxer  # noqa: E402
from easyav1.video.av1.headers import (HeaderParser,  # noqa: E402
                                           parse_sequence_header)


def split_obus_off(data):
    """[(type, header_start, payload_off, payload_len)]"""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        b0 = data[pos]
        t = (b0 >> 3) & 0xF
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        hs = pos
        pos += 1
        if ext:
            pos += 1
        if has_size:
            size = 0
            i = 0
            while True:
                byte = data[pos]
                pos += 1
                size |= (byte & 0x7F) << (7 * i)
                i += 1
                if not (byte & 0x80):
                    break
        else:
            size = n - pos
        out.append((t, hs, pos, size))
        pos += size
    return out


def bits_of(data):
    return [(data[i >> 3] >> (7 - (i & 7))) & 1 for i in range(len(data) * 8)]


def pack(bits):
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i >> 3] |= 0x80 >> (i & 7)
    return bytes(out)


def leb128(n):
    o = b""
    while True:
        b = n & 0x7F
        n >>= 7
        o += bytes([b | (0x80 if n else 0)])
        if not n:
            return o


def obu(t, payload):
    return bytes([(t << 3) | 0x02]) + leb128(len(payload)) + payload


class Rewriter:
    """Tracks header-parser ref state across the whole stream while
    rewriting the filter params of selected decode-order frames."""

    def __init__(self, targets, zero_lf=True, zero_cdef=True):
        self.targets = targets
        self.zero_lf = zero_lf
        self.zero_cdef = zero_cdef
        self.hp = None
        self.frame_no = -1
        self.spans = {}
        self._orig_lf = HeaderParser._loop_filter_params
        self._orig_cdef = HeaderParser._cdef_params
        spans = self.spans
        orig_lf, orig_cdef = self._orig_lf, self._orig_cdef

        def lf_hook(hp_self, r, h):
            s = r.pos
            orig_lf(hp_self, r, h)
            spans["lf"] = (s, r.pos, [h.lf.level[i] for i in range(4)])

        def cdef_hook(hp_self, r, h):
            s = r.pos
            orig_cdef(hp_self, r, h)
            spans["cdef"] = (s, r.pos)

        HeaderParser._loop_filter_params = lf_hook
        HeaderParser._cdef_params = cdef_hook

    def restore(self):
        HeaderParser._loop_filter_params = self._orig_lf
        HeaderParser._cdef_params = self._orig_cdef

    def rewrite_tu(self, tu):
        chunks = []
        for (t, hs, poff, ln) in split_obus_off(tu):
            payload = tu[poff:poff + ln]
            raw = tu[hs:poff + ln]
            if t == 1:
                self.hp = HeaderParser(parse_sequence_header(payload))
                chunks.append(raw)
                continue
            if t not in (3, 6) or self.hp is None:
                chunks.append(raw)
                continue
            self.spans.clear()
            hdr = self.hp.parse_frame_header(payload)
            self.hp.update_refs(hdr)
            if getattr(hdr, "show_existing_frame", False):
                chunks.append(raw)
                continue
            self.frame_no += 1
            if self.frame_no not in self.targets or "lf" not in self.spans:
                chunks.append(raw)
                continue
            bits = bits_of(payload)
            hdr_end = hdr.header_bit_offset
            new_hdr = bits[:hdr_end]
            if self.zero_lf:
                lf_s, lf_e, levels = self.spans["lf"]
                had_uv = bool(levels[0] or levels[1])
                tail = lf_s + 12 + (12 if had_uv else 0)
                new_hdr = (bits[:lf_s] + [0] * 12 + bits[tail:lf_e]
                           + bits[lf_e:hdr_end])
            delta = len(new_hdr) - hdr_end
            if self.zero_cdef and "cdef" in self.spans:
                cs, ce = self.spans["cdef"]
                for bit in range(cs + 4, ce):
                    new_hdr[bit + delta] = 0
            if t == 3:
                new_hdr.append(1)
                while len(new_hdr) % 8:
                    new_hdr.append(0)
                new_payload = pack(new_hdr)
            else:
                while len(new_hdr) % 8:
                    new_hdr.append(0)
                new_payload = pack(new_hdr) + payload[(hdr_end + 7) // 8:]
            ohdr = bytes([tu[hs]])
            if tu[hs] & 0x04:
                ohdr += tu[hs + 1:hs + 2]
            chunks.append(ohdr + leb128(len(new_payload)) + new_payload)
        return b"".join(chunks)


def main():
    import os
    os.environ.setdefault("EASYAV1_NATIVE", "0")
    from easyav1.video.av1.backend import AV1Backend
    from fixtures import tool

    src = sys.argv[1]
    target = int(sys.argv[2])
    slot = int(sys.argv[3])
    what = sys.argv[4] if len(sys.argv) > 4 else "both"

    dmx = WebMDemuxer(src)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.append(p)

    rw = Rewriter({target}, zero_lf=what in ("lf", "both"),
                  zero_cdef=what in ("cdef", "both"))
    new_pkts = []
    done_pkt = None
    for pi, p in enumerate(pkts):
        new_pkts.append([rw.rewrite_tu(f) for f in p.frames])
        if rw.frame_no >= target and done_pkt is None:
            done_pkt = pi
    rw.restore()
    # truncate after the target frame's packet so the show_existing
    # displays the target's slot before later frames overwrite it
    if done_pkt is not None:
        new_pkts = new_pkts[:done_pkt + 1]

    tu_show = obu(2, b"") + obu(3, bytes([(1 << 7) | (slot << 4) | (1 << 3)]))
    mx = WebMMuxer()
    mx.add_track(MuxTrack(vt.number, TrackType.VIDEO, "V_AV1",
                          codec_private=getattr(vt, "codec_private", b"")
                          or b"", width=vt.width, height=vt.height))
    ts = 0
    for i, frames in enumerate(new_pkts):
        mx.add_packet(vt.number, ts, frames, keyframe=(i == 0))
        ts += 33_333_333
    mx.add_packet(vt.number, ts, [tu_show], keyframe=False)
    out = "/tmp/filter_probe.webm"
    Path(out).write_bytes(mx.finalize())
    subprocess.run([str(tool("oracle")), out, "/tmp/filter_probe"],
                   check=True, capture_output=True)

    be = AV1Backend(vt)
    for frames in new_pkts:
        be.decode(frames, 0)
    ours = be._ref_planes[slot]
    w, h = vt.width, vt.height
    cw, chh = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * chh
    raw = np.fromfile("/tmp/filter_probe.yuv", dtype=np.uint8)
    nf = raw.size // per
    b0 = (nf - 1) * per
    gold = [raw[b0:b0 + w * h].reshape(h, w).astype(int),
            raw[b0 + w * h:b0 + w * h + cw * chh].reshape(chh, cw)
            .astype(int),
            raw[b0 + w * h + cw * chh:b0 + per].reshape(chh, cw)
            .astype(int)]
    for i, nm in enumerate("yuv"):
        d = np.abs(gold[i] - ours[i].astype(int))
        print(f"[{what} zeroed, frame {target}] plane {nm}: "
              f"maxdiff {d.max()} nbad {(d > 0).sum()} "
              f"{np.argwhere(d > 0)[:8].tolist()}")


if __name__ == "__main__":
    main()
