"""Debug helper: re-run a fuzz_inter seed, print per-block mismatch
info (parse-order) for the first failing frame.
Usage: python tools/fuzz_debug.py <seed> [comp]"""

import json
import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

from fixtures import CACHE, tool  # noqa: E402
from easyav1.container.webm import TrackInfo  # noqa: E402
from easyav1.video.av1 import constants as C  # noqa: E402
from easyav1.video.av1 import recon_ref  # noqa: E402
from easyav1.video.av1.av1_enc import make_ivf  # noqa: E402
from easyav1.video.av1.av1_enc_inter import encode_inter_sequence  # noqa: E402
from easyav1.video.av1.backend import AV1Backend  # noqa: E402
import fuzz_inter as FZ  # noqa: E402

NAMES = {v: k for k, v in vars(C).items()
         if k.startswith("BLOCK_") and isinstance(v, int)
         and k != "BLOCK_SIZES_ALL"}


def main():
    seed = int(sys.argv[1])
    rng = np.random.default_rng(seed)
    kb = FZ.rand_blocks(rng, intra_frame=True)
    frames = [(C.KEY_FRAME, kb)]
    for _ in range(int(rng.integers(1, 3))):
        frames.append((C.INTER_FRAME, FZ.rand_blocks(rng)))
    adapt = bool(rng.random() < 0.5)
    tx_sel = bool(rng.random() < 0.5)
    q = int(rng.integers(40, 200))
    tus = encode_inter_sequence(FZ.W, FZ.H, q, frames,
                                hp_mv=True, adapt=adapt, tx_select=tx_sel)
    p = CACHE / "fuzz_dbg.ivf"
    p.write_bytes(make_ivf(tus, FZ.W, FZ.H))
    prefix = CACHE / "fuzz_dbg"
    r = subprocess.run([str(tool("oracle")), str(p), str(prefix)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print("dav1d REJECT:", r.stderr[-800:])
        # dump the intended block list of each frame
        for fi, (ft, blks) in enumerate(frames):
            print(f"--- frame {fi} type {ft} ({len(blks)} blocks)")
        return
    raw = np.fromfile(prefix.with_suffix(".yuv"), dtype=np.uint8)
    per = FZ.W * FZ.H + 2 * 48 * 48
    be = AV1Backend(TrackInfo(number=1, type=None, codec_id="V_AV1"))
    caps = []
    oi = recon_ref.FrameRecon.__init__

    def cap(self, *a, **k):
        oi(self, *a, **k)
        caps.append(self)
    recon_ref.FrameRecon.__init__ = cap
    for fi, tu in enumerate(tus):
        caps.clear()
        f = be.decode([tu], 0)[0]
        b = fi * per
        gold = raw[b:b + FZ.W * FZ.H].reshape(FZ.H, FZ.W)
        d = np.abs(gold.astype(int) - f.data[0].astype(int))
        if not d.max():
            continue
        print(f"frame {fi} (adapt={adapt} txsel={tx_sel} q={q}) "
              f"nbad={(d > 0).sum()}")
        rc = caps[0] if caps else None
        if rc is None:
            print("  (native path, rerun with EASYAV1_NATIVE=0)")
            return
        intended = {(bl.r, bl.c): bl for bl in frames[fi][1]}
        for idx, blk in enumerate(rc.plan.blocks):
            y, x = blk.r * 4, blk.c * 4
            hh = C.BLOCK_H4[blk.bsize] * 4
            ww = C.BLOCK_W4[blk.bsize] * 4
            sub = d[y:y + hh, x:x + ww]
            want = intended.get((blk.r, blk.c))
            tag = ""
            if want is None or want.bsize != blk.bsize:
                tag = " STRUCT-MISMATCH"
            if (sub > 0).sum() or tag:
                print(f"  #{idx} ({blk.r},{blk.c}) {NAMES[blk.bsize]:11s}"
                      f" ref={blk.ref_frame} mode={blk.inter_mode}"
                      f" skip={blk.skip} mm={blk.motion_mode}"
                      f" ymode={blk.y_mode}"
                      f" bad={(sub > 0).sum()}/{sub.size}{tag}")
        return


if __name__ == "__main__":
    main()
