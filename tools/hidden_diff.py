#!/usr/bin/env python3
"""Per-decode-order-frame conformance localizer.

For every frame in a fixture (including no-show alt-refs), builds a
derived WebM that forces the frame's display via a show_existing_frame
OBU, runs the dav1d oracle on it, and diffs our reconstruction of that
frame (the ref-slot plane) against the oracle's.  Reports the first
mis-reconstructed frame in decode order and the blocks covering the
bad pixels — turning "frame N is wrong somewhere upstream" into "block
(r,c) of decode-order frame K is wrong".

Usage: python tools/hidden_diff.py <fixture.webm> [golden_prefix]
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from easyav1.container.mux import MuxTrack, WebMMuxer  # noqa: E402
from easyav1.container.webm import TrackType, WebMDemuxer  # noqa: E402
from easyav1.video.av1 import constants as C  # noqa: E402


def leb128(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def obu(t: int, payload: bytes) -> bytes:
    return bytes([(t << 3) | 0x02]) + leb128(len(payload)) + payload


def show_existing_tu(slot: int) -> bytes:
    # show_existing_frame=1 (1 bit) + frame_to_show_map_idx (3 bits)
    # + trailing bit; assumes no frame ids / no equal-frame-size probe
    payload = bytes([(1 << 7) | (slot << 4) | (1 << 3)])
    return obu(2, b"") + obu(3, payload)


def mux_prefix_plus_show(vt, pkts, upto, slot, dst):
    mx = WebMMuxer()
    mx.add_track(MuxTrack(vt.number, TrackType.VIDEO, "V_AV1",
                          codec_private=getattr(vt, "codec_private", b"")
                          or b"", width=vt.width, height=vt.height))
    ts = 0
    for i, p in enumerate(pkts[:upto + 1]):
        mx.add_packet(vt.number, ts, p.frames, keyframe=(i == 0))
        ts += 33_333_333
    mx.add_packet(vt.number, ts, [show_existing_tu(slot)], keyframe=False)
    Path(dst).write_bytes(mx.finalize())


def main():
    import easyav1.video.av1.backend as B
    import easyav1.video.av1.tile as tilemod
    from easyav1.video.av1.backend import AV1Backend
    from fixtures import tool

    src = sys.argv[1]
    dmx = WebMDemuxer(src)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.append(p)

    # trace (hdr, plan) per python-tile-decoded frame
    frames_meta = []  # (pkt_idx, hdr, plan)
    cur_pkt = [0]
    orig_td = tilemod.TileDecoder.__init__

    def patched(self, seq, hdr, cdf, plan, *a, **k):
        frames_meta.append((cur_pkt[0], hdr, plan))
        return orig_td(self, seq, hdr, cdf, plan, *a, **k)

    tilemod.TileDecoder.__init__ = patched
    import os
    os.environ["EASYAV1_NATIVE"] = "0"

    be = AV1Backend(vt)
    snapshots = []  # decode-order: (pkt_idx, hdr, plan, slot, planes)
    for pi, p in enumerate(pkts):
        cur_pkt[0] = pi
        n_before = len(frames_meta)
        be.decode(p.frames, 0)
        for (pj, hdr, plan) in frames_meta[n_before:]:
            slot = None
            for s in range(C.NUM_REF_FRAMES):
                if hdr.refresh_frame_flags & (1 << s):
                    slot = s
                    break
            planes = be._ref_planes[slot] if slot is not None else None
            snapshots.append((pj, hdr, plan, slot,
                              [pl.copy() for pl in planes]
                              if planes is not None else None))

    w, h = vt.width, vt.height
    cw, chh = (w + 1) // 2, (h + 1) // 2
    per = w * h + 2 * cw * chh
    for di, (pi, hdr, plan, slot, planes) in enumerate(snapshots):
        if planes is None:
            print(f"decode-order {di}: no refresh slot, skipped")
            continue
        tmp = f"/tmp/hidden_{di}.webm"
        pref = f"/tmp/hidden_{di}"
        mux_prefix_plus_show(vt, pkts, pi, slot, tmp)
        subprocess.run([str(tool("oracle")), tmp, pref], check=True,
                       capture_output=True)
        raw = np.fromfile(pref + ".yuv", dtype=np.uint8)
        nshown = raw.size // per
        b = (nshown - 1) * per
        gold = raw[b:b + w * h].reshape(h, w)
        d = np.abs(gold.astype(int) - planes[0].astype(int))
        status = f"maxdiff {d.max():3d} nbad {(d > 0).sum()}"
        print(f"decode-order {di} (pkt {pi}, order_hint "
              f"{getattr(hdr, 'order_hint', '?')}, slot {slot}): {status}")
        if d.max() > 0:
            bad = d > 0
            shown = 0
            for blk in plan.blocks:
                y0, x0 = blk.r * 4, blk.c * 4
                h4 = C.BLOCK_H4[blk.bsize] * 4
                w4 = C.BLOCK_W4[blk.bsize] * 4
                reg = bad[y0:y0 + h4, x0:x0 + w4]
                if reg.any():
                    print(f"    blk r={blk.r} c={blk.c} bs={blk.bsize} "
                          f"inter={blk.is_inter} mode={blk.inter_mode} "
                          f"refs={blk.ref_frame} ctype={blk.compound_type} "
                          f"cidx={blk.compound_idx} mm={blk.motion_mode} "
                          f"ii={blk.interintra_mode} mv={blk.mv} "
                          f"mv2={blk.mv2} nbad={reg.sum()} "
                          f"maxd={d[y0:y0 + h4, x0:x0 + w4].max()}")
                    shown += 1
                    if shown >= 12:
                        print("    ...")
                        break
            return
    print("all decode-order frames match")


if __name__ == "__main__":
    main()
