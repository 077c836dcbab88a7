"""One-sided distance-weighted compound (jnt_comp with both refs in
the past) vs the dav1d oracle.

Regression for a real conformance bug found in round 4: the
quant-dist lookup table carried {13,3},{15,1} in rows 2-3 instead of
{12,4},{13,3}, and the ratio comparison was inverted — latent because
libaom's bidirectional ladders only ever produced row-0/1 weights with
the forward reference nearer.  enable-onesided-comp + cpu-used=1
exercises distance ratios 1.5..3.5 with the BACKWARD list nearer,
which hits every row of the table (weights validated pair-by-pair
against libdav1d; av1_mc.h dist_weights, recon_ref._dist_weights,
mc_jax._dist_weights_np all share the fixed ladder).
"""

import numpy as np
import pytest

from test_av1_inter_real import inter_fixture


def _decode_all(path):
    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend

    d = WebMDemuxer(str(path))
    vt = d.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    be = AV1Backend(vt)
    out = []
    for pk in pkts:
        for f in be.decode([pk], 0):
            out.append([np.asarray(pl).copy() for pl in f.data])
    return out


@pytest.mark.parametrize("tag,kw", [
    ("obmc_dev3", dict(w=192, h=128, crf=26, frames=8, extra=(
        "vopt:cpu-used=1",
        "vopt:aom-params=enable-global-motion=0:"
        "enable-warped-motion=0:enable-interintra-comp=0",))),
    ("jnt_onesided2", dict(w=160, h=96, crf=30, frames=10, extra=(
        "vopt:cpu-used=2",
        "vopt:aom-params=enable-global-motion=0:"
        "enable-interintra-comp=0",))),
])
def test_onesided_jnt_bitexact(tag, kw):
    fx, prefix = inter_fixture(tag, **kw)
    frames = _decode_all(fx)
    raw = np.fromfile(str(prefix) + ".yuv", dtype=np.uint8)
    w_, h_ = kw["w"], kw["h"]
    per = w_ * h_ + 2 * ((w_ + 1) // 2) * ((h_ + 1) // 2)
    assert len(frames) > 0
    for i, fr in enumerate(frames):
        gold = raw[i * per:i * per + w_ * h_].reshape(h_, w_)
        d = np.abs(gold.astype(int) - fr[0].astype(int))
        assert d.max() == 0, f"{tag} frame {i}: maxdiff {d.max()} " \
                             f"({(d > 0).sum()} px)"
