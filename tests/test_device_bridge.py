"""Device-pipeline bridge: per-pred-unit export + data-driven executor.

The C entropy decoder exports one record per intra pred unit
(av1_recon.c:av1_export_pred_units) with every irregular decision
resolved host-side; recon/exec_ref.py replays them.  These tests pin
the contract: the replayed planes must equal the native C recon
bit-for-bit (raw recon, loop filter and CDEF off).  The device executor
(recon/jax_exec.py) implements the same contract.
"""

import ctypes

import numpy as np
import pytest

from fixtures import make_fixture
import easyav1.native as nat
from easyav1.container.webm import TrackType, WebMDemuxer
from easyav1.video.av1.backend import AV1Backend


def _first_keyframe_compare(path):
    lib = nat._load()
    if lib is None:
        pytest.skip("native library unavailable")
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    p = dmx.read_packet()
    while p.track != vt.number:
        p = dmx.read_packet()
    be = AV1Backend(vt)
    done = {}

    orig = nat.decode_and_recon_native

    def hook(seq, hdr, tiles, **kw):
        res = nat._run_tiles(lib, seq, hdr, tiles)
        if res is None:
            return orig(seq, hdr, tiles, **kw)
        out, bufs, _blob, _fpk = res
        rp = nat._build_rp(seq, hdr)
        rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
        rp.enable_cdef = 0
        aw, ah = hdr.mi_cols * 4, hdr.mi_rows * 4
        ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
        gold = [np.empty((ah, aw), np.uint16),
                np.empty((ah >> ssy, aw >> ssx), np.uint16),
                np.empty((ah >> ssy, aw >> ssx), np.uint16)]
        fp_rc, _keep = nat._build_fp(hdr, seq, None, None, None)
        rc = lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                                 ctypes.byref(fp_rc),
                                 ctypes.byref(nat._RefPlanes()),
                                 *(nat._vp(g) for g in gold))
        assert rc == 0
        br = nat.export_frame_bridge(seq, hdr, tiles)
        assert br is not None, "bridge export declined"
        from easyav1.video.av1.recon.exec_ref import UnitExecutor
        ex = UnitExecutor(hdr.mi_rows, hdr.mi_cols, ssx, ssy,
                          seq.color.bitdepth, seq.color.num_planes)
        res_pl = ex.residual_planes(br["txs"], br["coeffs"])
        planes = ex.run(br["units"], res_pl)
        for i, nm in enumerate("yuv"[:seq.color.num_planes]):
            d = np.abs(planes[i] - gold[i].astype(np.int64))
            assert d.max() == 0, (
                f"{nm}: maxdiff {d.max()} at "
                f"{np.argwhere(d > 0)[:4].tolist()}")
        done["ok"] = True
        raise SystemExit(0)

    nat.decode_and_recon_native = hook
    try:
        be.decode(p.frames, 0)
    except SystemExit:
        pass
    finally:
        nat.decode_and_recon_native = orig
    assert done.get("ok"), "native path never ran (fixture not eligible)"


# fixtures must be native-path eligible: intra, single tile, no screen
# content, no superres, no loop restoration
_SCOPE = dict(fps=10, frames=1, gop=1, audio_secs=0,
              vopt=["enable-restoration=0", "enable-palette=0",
                    "enable-intrabc=0", "enable-filter-intra=0"])


def test_bridge_exec_plain():
    _first_keyframe_compare(make_fixture(
        w=96, h=96, crf=30, content=1,
        **{**_SCOPE, "vopt": _SCOPE["vopt"] + ["enable-cdef=0"]}))


def test_bridge_exec_cdef_fixture():
    _first_keyframe_compare(make_fixture(
        w=128, h=96, crf=45, content=1,
        **{**_SCOPE, "vopt": _SCOPE["vopt"] + ["enable-cdef=1"]}))
