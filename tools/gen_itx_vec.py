#!/usr/bin/env python3
"""Generate easyav1/native/av1_itx_vec.h: GCC-vector-extension
variants of the scalar inverse-transform kernels in av1_itx.h.

The scalar kernels clamp every intermediate to [-(1<<(bd+7)),
(1<<(bd+7))-1] and the dequantized inputs to +/-1<<(bd+7), so for
bd == 8 every product against the <=4096 cos/adst constants fits in
int32 (|x|<=2^16 * 4096 = 2^28; worst adst4 3-term sums ~2^30.5).
That lets the column pass run 8 (or 4) columns per vector with plain
int32 lane arithmetic — bit-exact with the int64 scalar path for
8-bit streams.  Higher bitdepths keep the scalar path.

The transformation is purely textual (int64_t -> vector type,
r12/ihalf/icl/irot -> vector helpers, function names suffixed), so the
vector kernels stay line-for-line in sync with the verified scalar
ones; regenerate after editing av1_itx.h."""

import re
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / \
    "easyav1/native/av1_itx.h"
OUT = SRC.parent / "av1_itx_vec.h"

text = SRC.read_text()

# grab everything from inv_dct4 onward (helpers cos128/r12/etc. and the
# tables stay shared with av1_itx.h)
start = text.index("static void inv_dct4")
body = text[start:]
# drop the trailing itx_1d dispatcher; regenerated per variant below
body = body[:body.index("/* kind: 0 dct, 1 adst, 2 flipadst")]
# itx_bitrev/OddSched/odd_sched32 are type-independent; keep the
# shared definitions from av1_itx.h instead of duplicating them
cut0 = body.index("static int itx_bitrev")
cut1 = body.index("static void odd_merge")
body = body[:cut0] + body[cut1:]

HEADER = '''\
/* GENERATED by tools/gen_itx_vec.py from av1_itx.h — do not edit.
 *
 * int32 GCC-vector variants of the inverse-transform kernels (8 and 4
 * lanes), used for the bd==8 column pass: every scalar intermediate is
 * clamped to +/-2^15 and the constants are <=4096, so int32 lanes are
 * exact.  Included by av1_recon.c after av1_itx.h. */
#pragma once

#include <stdint.h>
#include <string.h>

typedef int32_t v8si __attribute__((vector_size(32), aligned(4)));
typedef int32_t v4si __attribute__((vector_size(16), aligned(4)));
'''

VAR_HELPERS = '''
static inline {V} vr12_{S}({V} x) {{ return (x + 2048) >> 12; }}
static inline {V} vihalf_{S}({V} x) {{ return (x * 181 + 128) >> 8; }}
static inline {V} vicl_{S}({V} x, {V} mn, {V} mx) {{
    {V} m = x < mn;
    x = (x & ~m) | (mn & m);
    m = x > mx;
    return (x & ~m) | (mx & m);
}}
static inline void virot_{S}({V} a, {V} b, int phi, {V} *lo, {V} *hi) {{
    int32_t c0 = (int32_t)cos128(64 - phi), c1 = (int32_t)cos128(phi);
    *lo = vr12_{S}(a * c0 - b * c1);
    *hi = vr12_{S}(a * c1 + b * c0);
}}
'''


def variant(vtype, suffix):
    s = body
    # function definitions & calls: suffix the kernel names
    for fn in ["inv_dct4", "inv_dct8", "inv_dct16", "inv_dct32",
               "inv_dct64", "inv_adst4", "inv_adst8", "inv_adst16",
               "inv_identity", "odd_merge"]:
        s = re.sub(rf"\b{fn}\(", f"{fn}_{suffix}(", s)
    # irot -> virot
    s = s.replace("irot(", f"virot_{suffix}(")
    # helper calls
    s = re.sub(r"\br12\(", f"vr12_{suffix}(", s)
    s = re.sub(r"\bihalf\(", f"vihalf_{suffix}(", s)
    s = re.sub(r"\bicl\(", f"vicl_{suffix}(", s)
    # element type
    s = s.replace("int64_t", vtype)
    # odd_merge's memcpy element size already transformed via int64_t
    # (sizeof(int64_t) -> sizeof(vtype)); nothing else to do.
    # cos128 lookups inside odd_sched32/init blocks were NOT captured
    # (they live before inv_dct4 or use int32 tables) except the
    # dct64 init block, which uses int8/int32 only — but the generated
    # odd_sched32 reference must keep its shared name:
    s = s.replace(f"odd_sched32_{suffix}", "odd_sched32")
    # the flip in itx_1d is emitted separately
    dispatch = f'''
static void itx_1d_{suffix}(int kind, {vtype} *c, int n, {vtype} mn,
                            {vtype} mx) {{
    if (kind == 3) {{ inv_identity_{suffix}(c, n); return; }}
    if (kind == 0) {{
        switch (n) {{
        case 4: inv_dct4_{suffix}(c, mn, mx); return;
        case 8: inv_dct8_{suffix}(c, mn, mx); return;
        case 16: inv_dct16_{suffix}(c, mn, mx); return;
        case 32: inv_dct32_{suffix}(c, mn, mx); return;
        default: inv_dct64_{suffix}(c, mn, mx); return;
        }}
    }}
    switch (n) {{
    case 4: inv_adst4_{suffix}(c, mn, mx); break;
    case 8: inv_adst8_{suffix}(c, mn, mx); break;
    default: inv_adst16_{suffix}(c, mn, mx); break;
    }}
    if (kind == 2) {{
        for (int i = 0; i < n / 2; i++) {{
            {vtype} t = c[i];
            c[i] = c[n - 1 - i];
            c[n - 1 - i] = t;
        }}
    }}
}}
'''
    return VAR_HELPERS.format(V=vtype, S=suffix) + s + dispatch


out = HEADER + variant("v8si", "v8") + variant("v4si", "v4")
# the generated odd_merge uses itx_bitrev/odd_sched32/OddSched from
# av1_itx.h (shared); the duplicated static init tables in inv_dct64
# get distinct names automatically via function-local statics.
OUT.write_text(out)
print(f"wrote {OUT} ({len(out.splitlines())} lines)")
