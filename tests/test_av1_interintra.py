"""Interintra compound conformance (spec 7.11.3.13): synth streams\nwith smooth/wedge interintra blocks, decoded bit-exact vs libdav1d.\n\nReference parity: easyav1 decodes via dav1d (src/easyav1.c); this\ncovers dav1d recon interintra + decode.c read_interintra_mode."""

import sys, subprocess
sys.path.insert(0,'tests'); sys.path.insert(0,'.')
import numpy as np
import fuzz_tmv_future as FZ
from fixtures import CACHE, tool
from easyav1.video.av1 import constants as C
from easyav1.video.av1.av1_enc import make_ivf
from easyav1.video.av1.av1_enc_inter import encode_ref_sequence, InterEncBlock
from easyav1.container.webm import TrackInfo
from easyav1.video.av1.backend import AV1Backend

def run(seed, tag):
    rng = np.random.default_rng(seed)
    blocks=[]
    sizes=[C.BLOCK_8X8, C.BLOCK_16X16, C.BLOCK_8X16, C.BLOCK_16X8, C.BLOCK_32X32]
    occupied=np.zeros((24,24),bool)
    for r in range(0,24,4):
        for c in range(0,24,4):
            if occupied[r,c]: continue
            if r%8==0 and c%8==0 and r+8<=24 and c+8<=24 and rng.random()<0.25:
                bs=C.BLOCK_32X32; occupied[r:r+8,c:c+8]=True
                cells=[(r,c,bs)]
            else:
                occupied[r:r+4,c:c+4]=True
                bs=int(rng.choice(sizes[:4]))
                if bs==C.BLOCK_16X16: cells=[(r,c,bs)]
                elif bs==C.BLOCK_8X16: cells=[(r,c,bs),(r,c+2,bs)]
                elif bs==C.BLOCK_16X8: cells=[(r,c,bs),(r+2,c,bs)]
                else: cells=[(r+dr,c+dc,bs) for dr in (0,2) for dc in (0,2)]
            for (rr,cc,bsz) in cells:
                mode=int(rng.choice([C.NEWMV,C.NEARESTMV,C.NEARMV]))
                b=InterEncBlock(r=rr,c=cc,bsize=bsz,is_inter=True,ref=C.LAST_FRAME,
                                mode=mode,skip=bool(rng.random()<0.4))
                if mode==C.NEWMV: b.mv=(2*int(rng.integers(-40,41)),2*int(rng.integers(-40,41)))
                if rng.random()<0.5 and C.BLOCK_8X8<=bsz<=C.BLOCK_32X32:
                    b.interintra_mode=int(rng.integers(0,4))
                    from easyav1.video.av1.wedge import wedge_allowed
                    if wedge_allowed(bsz) and rng.random()<0.5:
                        b.ii_wedge=1; b.ii_wedge_idx=int(rng.integers(0,16))
                if not b.skip:
                    b.luma_coeffs=[[(int(rng.integers(1,9)),int(rng.integers(0,2))) for _ in range(3)]]
                blocks.append(b)
    frames=[dict(type=C.KEY_FRAME, blocks=FZ.keyblocks(rng), order_hint=0),
            dict(type=C.INTER_FRAME, blocks=blocks, order_hint=1, refresh=2,
                 ref_idx=[0]*7, err=False)]
    tus=encode_ref_sequence(FZ.W,FZ.H,70,frames,carry=True,interintra=True)
    p=CACHE/"iisyn.ivf"; p.write_bytes(make_ivf(tus,FZ.W,FZ.H))
    r=subprocess.run([str(tool("oracle")),str(p),str(CACHE/"iisyn")],capture_output=True)
    if r.returncode!=0:
        print(tag,"REJECT"); return
    raw=np.fromfile((CACHE/"iisyn").with_suffix(".yuv"),dtype=np.uint8)
    per=FZ.W*FZ.H+2*48*48
    be=AV1Backend(TrackInfo(number=1,type=None,codec_id="V_AV1"))
    for fi,tu in enumerate(tus):
        f=be.decode([tu],0)[0]
        for pi,dim in ((0,96),(1,48),(2,48)):
            off=fi*per+(0 if pi==0 else FZ.W*FZ.H+(pi-1)*48*48)
            gold=raw[off:off+dim*dim].reshape(dim,dim)
            m=int(np.abs(gold.astype(int)-f.data[pi].astype(int)).max())
            if m:
                d=np.abs(gold.astype(int)-f.data[pi].astype(int))
                ys,xs=np.nonzero(d)
                print(tag,f"frame{fi} plane{pi} maxdiff {m} first=({ys[0]},{xs[0]}) n={len(ys)}"); return
    print(tag,"exact")
def _run_assert(seed):
    import io, contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(seed, f"seed{seed}")
    out = buf.getvalue()
    assert "exact" in out, out


def test_interintra_seed0():
    _run_assert(0)


def test_interintra_seed1():
    _run_assert(1)


def test_interintra_seed2():
    _run_assert(2)
