"""Per-stage wall-time breakdown of the native AV1 decode path.

Decodes a bench-shaped fixture through the production pipeline and
prints where the time goes: entropy decode (av1_decode_tile), block
reconstruction (split intra / inter / itx), loop filter, CDEF,
superres+LR, plus the Python orchestration remainder.  This is the
profiling harness the reference lacks (SURVEY §5.1: its only tool is
the benchmark's per-frame wall clock, tools/easyav1_benchmark.c:124).

Usage: python tools/profile_stages.py [1080|4k|intra] [frames]
"""

import ctypes
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

STAGE_NAMES = [
    "block recon (pred+itx)",
    "loop filter",
    "cdef",
    "superres+lr",
    "  inter pred (in 0)",
    "  inter itx (in flush)",
    "  intra pred (in 0)",
    "  itx (in 0)",
]


def _tsc_hz():
    import ctypes as ct
    from easyav1 import native
    nl = native._load()
    if not hasattr(nl, "av1_rdtsc"):
        return 2.1e9  # /proc/cpuinfo model nominal
    nl.av1_rdtsc.restype = ct.c_uint64
    t0 = time.perf_counter()
    c0 = nl.av1_rdtsc()
    time.sleep(0.05)
    c1 = nl.av1_rdtsc()
    return (c1 - c0) / (time.perf_counter() - t0)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "1080"
    import bench
    from easyav1.container import TrackType, WebMDemuxer
    from easyav1.video.av1.backend import AV1Backend
    from easyav1 import native

    if which == "4k":
        path = bench._av1_fixture(w=3840, h=2160, frames=24, fps=30,
                                  gop=9999, tag="4k",
                                  extra=("vopt:cpu-used=8",))
    elif which == "intra":
        path = bench._av1_fixture(frames=30, fps=30, gop=1, tag="intra")
    else:
        path = bench._av1_fixture(frames=60, fps=30, gop=9999, tag="inter")

    lib = native._load()
    lib.av1_get_stage_times.restype = None
    lib.av1_get_stage_times.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.av1_get_tile_time.restype = ctypes.c_double
    lib.av1_get_tile_time.argtypes = []

    buf = (ctypes.c_double * 8)()
    lib.av1_get_stage_times(buf)  # reset
    lib.av1_get_tile_time()
    try:
        lib.cdef_set_profile(1)
    except AttributeError:
        pass
    try:
        lib.av1_set_stage_profile(1)
    except AttributeError:
        pass

    os.environ["EASYAV1_PIPE"] = "native"
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    be = AV1Backend(vt)
    for pk in pkts[:1]:
        for f in be.decode([pk], 0):
            bench._touch(f)
    lib.av1_get_stage_times(buf)
    lib.av1_get_tile_time()
    try:
        _ts = (ctypes.c_uint64 * 24)()
        lib.av1_get_tile_stats(_ts)
    except AttributeError:
        pass

    t0 = time.perf_counter()
    n = 0
    for pk in pkts[1:]:
        for f in be.decode([pk], 0):
            bench._touch(f)
        n += 1
    wall = time.perf_counter() - t0

    lib.av1_get_stage_times(buf)
    tile_t = lib.av1_get_tile_time()
    stages = list(buf)
    accounted = tile_t + sum(stages[:4])

    print(f"fixture: {path.name}  frames={n}  wall={wall*1000:.1f} ms "
          f"({n/wall:.2f} fps)")
    print(f"{'stage':<28}{'ms':>9}{'%wall':>8}")
    print(f"{'entropy decode (tile)':<28}{tile_t*1000:>9.1f}"
          f"{100*tile_t/wall:>7.1f}%")
    for i, nm in enumerate(STAGE_NAMES):
        if stages[i] == 0:
            continue
        print(f"{nm:<28}{stages[i]*1000:>9.1f}{100*stages[i]/wall:>7.1f}%")
    print(f"{'python/orchestration rest':<28}"
          f"{(wall-accounted)*1000:>9.1f}{100*(wall-accounted)/wall:>7.1f}%")

    # entropy internals: where the tile-decode stage time goes
    try:
        lib.av1_get_tile_stats.restype = None
        lib.av1_get_tile_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        ts_ = (ctypes.c_uint64 * 24)()
        lib.av1_get_tile_stats(ts_)
        hz = _tsc_hz()
        if ts_[8]:
            blk, mode_i, resid = ts_[0] / hz, ts_[1] / hz, ts_[2] / hz
            print(f"\nentropy internals (stage {tile_t*1000:.1f} ms):")
            print(f"  blocks {ts_[8]}  inter {ts_[9]}  coded {ts_[10]}  "
                  f"txs {ts_[12]}  eob-sum {ts_[11]}")
            print(f"  decode_block total {blk*1000:9.1f} ms")
            print(f"  inter mode-info    {mode_i*1000:9.1f} ms")
            print(f"  residual (coefs)   {resid*1000:9.1f} ms")
            grids, txp = ts_[3] / hz, ts_[4] / hz
            print(f"    mi-grid fill     {grids*1000:9.1f} ms")
            print(f"    tx-size/var-tx   {txp*1000:9.1f} ms")
            print(f"  other block parse  "
                  f"{(blk-mode_i-resid-grids-txp)*1000:9.1f} ms")
            print(f"  partition/sb walk  {(tile_t-blk)*1000:9.1f} ms")
            if ts_[16]:
                lvt, sgt = ts_[20] / hz, ts_[21] / hz
                nsym = ts_[16] + ts_[17] + ts_[18] + ts_[11]
                print(f"  level pass         {lvt*1000:9.1f} ms  "
                      f"(base {ts_[16]}  br {ts_[17]})")
                print(f"  sign/deq pass      {sgt*1000:9.1f} ms  "
                      f"(signs {ts_[18]}  golomb {ts_[19]})")
                print(f"  ~cyc/level-symbol  "
                      f"{ts_[20]/max(1, ts_[16]+ts_[17]+ts_[12]):9.1f}"
                      f"  (symbols/coef "
                      f"{(ts_[16]+ts_[17])/max(1, ts_[11]):.2f})")
                del nsym
    except AttributeError:
        pass

    # CDEF internals: where the cdef stage time goes
    try:
        lib.cdef_get_stats.restype = None
        lib.cdef_get_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        cs = (ctypes.c_int64 * 24)()
        lib.cdef_get_stats(cs)
        hz = _tsc_hz()
        print(f"\nCDEF internals (stage {stages[2]*1000:.1f} ms):")
        print(f"  luma blocks {cs[0]}  chroma blocks {cs[1]}  "
              f"pri-calls {cs[2]}  sec-calls {cs[3]}  positions {cs[4]}")
        print(f"  band-filtered: luma {cs[6]}  chroma {cs[7]}")
        print(f"  stripe refill  {cs[5]/hz*1000:9.1f} ms")
        print(f"  dir search     {cs[10]/hz*1000:9.1f} ms  ({cs[11]} calls)")
        print(f"  uv-paired flt  {cs[8]/hz*1000:9.1f} ms  ({cs[9]} calls)")
        print(f"  per-pos filter {cs[12]/hz*1000:9.1f} ms")
        print(f"  band luma      {cs[13]/hz*1000:9.1f} ms")
        print(f"  band chroma    {cs[14]/hz*1000:9.1f} ms")
        print(f"  classify       {cs[16]/hz*1000:9.1f} ms")
        filtw = (cs[17] - cs[10] - cs[8] - cs[12]) / hz
        print(f"  filter-walk ovh{filtw*1000:9.1f} ms"
              "  (walk total - dir - uvflt - perpos)")
        bandm = (cs[18] - cs[13] - cs[14]) / hz
        print(f"  band mask ovh  {bandm*1000:9.1f} ms")
        print(f"  dir-band chroma{cs[19]/hz*1000:9.1f} ms  "
              f"({cs[20]} passes)")
        print(f"  dir-band luma  {cs[21]/hz*1000:9.1f} ms  "
              f"({cs[22]} passes)")
    except AttributeError:
        pass

    # MC path breakdown (pixels / cycles / calls per subpel path)
    try:
        lib.av1_get_mc_stats.restype = None
        lib.av1_get_mc_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        mc = (ctypes.c_uint64 * 64)()
        lib.av1_get_mc_stats(mc)
        names = ["int-mv", "h-only", "v-only", "2d"]
        tot_cyc = sum(mc[4:8]) + mc[15]
        if tot_cyc:
            print(f"\nMC paths ({stages[4]*1000:.1f} ms total):")
            print(f"{'path':<10}{'Mpx':>8}{'calls':>9}{'Mcyc':>9}"
                  f"{'cyc/px':>8}{'%mc':>6}")
            for i, nm in enumerate(names):
                if not mc[8 + i]:
                    continue
                print(f"{nm:<10}{mc[i]/1e6:>8.2f}{mc[8+i]:>9}"
                      f"{mc[4+i]/1e6:>9.1f}"
                      f"{mc[4+i]/max(mc[i],1):>8.1f}"
                      f"{100*mc[4+i]/tot_cyc:>5.1f}%")
            if mc[14]:
                print(f"{'warp':<10}{mc[14]/1e6:>8.2f}{'':>9}"
                      f"{mc[15]/1e6:>9.1f}"
                      f"{mc[15]/max(mc[14],1):>8.1f}"
                      f"{100*mc[15]/tot_cyc:>5.1f}%")
            print(f"compound px: {mc[12]/1e6:.2f}M   "
                  f"obmc px: {mc[13]/1e6:.2f}M")
            if mc[16]:
                print(f"int-mv memcpy branch: {mc[16]/1e6:.2f} Mpx "
                      f"{mc[17]/1e6:.1f} Mcyc "
                      f"({mc[17]/max(mc[16],1):.1f} cyc/px)")
            wn = ["<16", "16-63", "32-63", "64-127", ">=128"]
            if any(mc[18 + k] for k in range(5)):
                print("immediate NT-store copies (per block width):")
                for k in range(5):
                    if mc[18 + k]:
                        print(f"  w{wn[k]:<9} {mc[38+k]:>9} calls "
                              f"{mc[18+k]/1e6:>9.2f} Mpx "
                              f"{mc[28+k]/1e6:>8.1f} Mcyc "
                              f"{mc[28+k]/max(mc[18+k],1):>6.1f} cyc/px")
            if any(mc[23 + k] for k in range(5)):
                print("immediate memcpy copies (per block width):")
                for k in range(5):
                    if mc[23 + k]:
                        print(f"  w{wn[k]:<9} {mc[43+k]:>9} calls "
                              f"{mc[23+k]/1e6:>9.2f} Mpx "
                              f"{mc[33+k]/1e6:>8.1f} Mcyc "
                              f"{mc[33+k]/max(mc[23+k],1):>6.1f} cyc/px")
            if mc[58]:
                names = ["<16", "16-63", "64-255", "256-1023", ">=1024"]
                print(f"flush bands ({mc[58]} entries merged):")
                for k in range(5):
                    if mc[48 + k]:
                        print(f"  w{names[k]:<9} {mc[48+k]:>9} bands "
                              f"{mc[53+k]/1e6:>9.2f} Mpx "
                              f"{mc[59+k]/1e6:>8.1f} Mcyc "
                              f"{mc[59+k]/max(mc[53+k],1):>6.1f} cyc/px")
    except AttributeError:
        pass


if __name__ == "__main__":
    main()
