/* AV1 inverse transforms, C (int64 math, bit-exact).
 *
 * Port of the verified numpy reference (easyav1/video/av1/itx_ref.py,
 * spec §7.13.2-3): integer butterfly DCT 4..64, ADST 4/8/16, flip-ADST,
 * identity; normative rounding (round2 at 12 bits, 181/256 for 1/sqrt2)
 * and intermediate clamping.  Header-only so av1_recon.c inlines it.
 */
#pragma once

#include <stdint.h>
#include <string.h>

/* cos128 table: round(4096*cos(i*pi/128)), i=0..64 */
static const int32_t itx_cos[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897, 799, 700, 601, 501, 401, 301, 201, 101, 0};

static int64_t cos128(int angle) {
    int a = angle & 255;
    if (a <= 64) return itx_cos[a];
    if (a <= 128) return -itx_cos[128 - a];
    if (a <= 192) return -itx_cos[a - 128];
    return itx_cos[256 - a];
}

static int64_t r12(int64_t x) { return (x + 2048) >> 12; }
static int64_t ihalf(int64_t x) { return (x * 181 + 128) >> 8; }

static int64_t icl(int64_t x, int64_t mn, int64_t mx) {
    return x < mn ? mn : (x > mx ? mx : x);
}

static void irot(int64_t a, int64_t b, int phi, int64_t *lo, int64_t *hi) {
    *lo = r12(a * cos128(64 - phi) - b * cos128(phi));
    *hi = r12(a * cos128(phi) + b * cos128(64 - phi));
}

/* All kernels: in-place on c[0..n-1] with intermediate clamp [mn, mx]. */

static void inv_dct4(int64_t *c, int64_t mn, int64_t mx) {
    int64_t in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    int64_t t0 = ihalf(in0 + in2);
    int64_t t1 = ihalf(in0 - in2);
    int64_t t2 = r12(in1 * 1567 - in3 * 3784);
    int64_t t3 = r12(in1 * 3784 + in3 * 1567);
    c[0] = icl(t0 + t3, mn, mx);
    c[1] = icl(t1 + t2, mn, mx);
    c[2] = icl(t1 - t2, mn, mx);
    c[3] = icl(t0 - t3, mn, mx);
}

static void inv_dct8(int64_t *c, int64_t mn, int64_t mx) {
    int64_t t[4];
    for (int i = 0; i < 4; i++) t[i] = c[2 * i];
    inv_dct4(t, mn, mx);
    int64_t in1 = c[1], in3 = c[3], in5 = c[5], in7 = c[7];
    int64_t t4a = r12(in1 * 799 - in7 * 4017);
    int64_t t7a = r12(in1 * 4017 + in7 * 799);
    int64_t t5a = r12(in5 * 3406 - in3 * 2276);
    int64_t t6a = r12(in5 * 2276 + in3 * 3406);
    int64_t t4 = icl(t4a + t5a, mn, mx);
    int64_t t5b = icl(t4a - t5a, mn, mx);
    int64_t t7 = icl(t7a + t6a, mn, mx);
    int64_t t6b = icl(t7a - t6a, mn, mx);
    int64_t t5 = ihalf(t6b - t5b);
    int64_t t6 = ihalf(t6b + t5b);
    int64_t o[4] = {t4, t5, t6, t7};
    for (int i = 0; i < 4; i++) c[i] = icl(t[i] + o[3 - i], mn, mx);
    for (int i = 0; i < 4; i++) c[4 + i] = icl(t[3 - i] - o[i], mn, mx);
}

static void inv_dct16(int64_t *c, int64_t mn, int64_t mx) {
    int64_t t[8];
    for (int i = 0; i < 8; i++) t[i] = c[2 * i];
    inv_dct8(t, mn, mx);
    int64_t t8a, t15a, t9a, t14a, t10a, t13a, t11a, t12a;
    irot(c[1], c[15], 4, &t8a, &t15a);
    irot(c[9], c[7], 36, &t9a, &t14a);
    irot(c[5], c[11], 20, &t10a, &t13a);
    irot(c[13], c[3], 52, &t11a, &t12a);
    int64_t t8 = icl(t8a + t9a, mn, mx);
    int64_t t9 = icl(t8a - t9a, mn, mx);
    int64_t t10 = icl(t11a - t10a, mn, mx);
    int64_t t11 = icl(t11a + t10a, mn, mx);
    int64_t t12 = icl(t12a + t13a, mn, mx);
    int64_t t13 = icl(t12a - t13a, mn, mx);
    int64_t t14 = icl(t15a - t14a, mn, mx);
    int64_t t15 = icl(t15a + t14a, mn, mx);
    t9a = r12(t14 * 1567 - t9 * 3784);
    t14a = r12(t14 * 3784 + t9 * 1567);
    t10a = r12(-(t13 * 3784 + t10 * 1567));
    t13a = r12(t13 * 1567 - t10 * 3784);
    t8a = icl(t8 + t11, mn, mx);
    int64_t t9b = icl(t9a + t10a, mn, mx);
    int64_t t10b = icl(t9a - t10a, mn, mx);
    t11a = icl(t8 - t11, mn, mx);
    t12a = icl(t15 - t12, mn, mx);
    int64_t t13b = icl(t14a - t13a, mn, mx);
    int64_t t14b = icl(t14a + t13a, mn, mx);
    t15a = icl(t15 + t12, mn, mx);
    int64_t t10c = ihalf(t13b - t10b);
    int64_t t13c = ihalf(t13b + t10b);
    int64_t t11b = ihalf(t12a - t11a);
    int64_t t12b = ihalf(t12a + t11a);
    int64_t o[8] = {t8a, t9b, t10c, t11b, t12b, t13c, t14b, t15a};
    for (int i = 0; i < 8; i++) c[i] = icl(t[i] + o[7 - i], mn, mx);
    for (int i = 0; i < 8; i++) c[8 + i] = icl(t[7 - i] - o[i], mn, mx);
}

static void inv_dct32(int64_t *c, int64_t mn, int64_t mx) {
    int64_t t[16];
    for (int i = 0; i < 16; i++) t[i] = c[2 * i];
    inv_dct16(t, mn, mx);
    static const int phis[8] = {2, 34, 18, 50, 10, 42, 26, 58};
    static const int firsts[8] = {1, 17, 9, 25, 5, 21, 13, 29};
    int64_t ta[16];
    for (int j = 0; j < 8; j++) {
        int64_t lo, hi;
        irot(c[firsts[j]], c[32 - firsts[j]], phis[j], &lo, &hi);
        ta[j] = lo;
        ta[15 - j] = hi;
    }
    int64_t t16 = icl(ta[0] + ta[1], mn, mx);
    int64_t t17 = icl(ta[0] - ta[1], mn, mx);
    int64_t t18 = icl(ta[3] - ta[2], mn, mx);
    int64_t t19 = icl(ta[3] + ta[2], mn, mx);
    int64_t t20 = icl(ta[4] + ta[5], mn, mx);
    int64_t t21 = icl(ta[4] - ta[5], mn, mx);
    int64_t t22 = icl(ta[7] - ta[6], mn, mx);
    int64_t t23 = icl(ta[7] + ta[6], mn, mx);
    int64_t t24 = icl(ta[8] + ta[9], mn, mx);
    int64_t t25 = icl(ta[8] - ta[9], mn, mx);
    int64_t t26 = icl(ta[11] - ta[10], mn, mx);
    int64_t t27 = icl(ta[11] + ta[10], mn, mx);
    int64_t t28 = icl(ta[12] + ta[13], mn, mx);
    int64_t t29 = icl(ta[12] - ta[13], mn, mx);
    int64_t t30 = icl(ta[15] - ta[14], mn, mx);
    int64_t t31 = icl(ta[15] + ta[14], mn, mx);
    int64_t t17a = r12(t30 * 799 - t17 * 4017);
    int64_t t30a = r12(t30 * 4017 + t17 * 799);
    int64_t t18a = r12(-(t29 * 4017 + t18 * 799));
    int64_t t29a = r12(t29 * 799 - t18 * 4017);
    int64_t t21a = r12(t26 * 3406 - t21 * 2276);
    int64_t t26a = r12(t26 * 2276 + t21 * 3406);
    int64_t t22a = r12(-(t25 * 2276 + t22 * 3406));
    int64_t t25a = r12(t25 * 3406 - t22 * 2276);
    int64_t t16a = icl(t16 + t19, mn, mx);
    int64_t t17b = icl(t17a + t18a, mn, mx);
    int64_t t18b = icl(t17a - t18a, mn, mx);
    int64_t t19a = icl(t16 - t19, mn, mx);
    int64_t t20a = icl(t23 - t20, mn, mx);
    int64_t t21b = icl(t22a - t21a, mn, mx);
    int64_t t22b = icl(t22a + t21a, mn, mx);
    int64_t t23a = icl(t23 + t20, mn, mx);
    int64_t t24a = icl(t24 + t27, mn, mx);
    int64_t t25b = icl(t25a + t26a, mn, mx);
    int64_t t26b = icl(t25a - t26a, mn, mx);
    int64_t t27a = icl(t24 - t27, mn, mx);
    int64_t t28a = icl(t31 - t28, mn, mx);
    int64_t t29b = icl(t30a - t29a, mn, mx);
    int64_t t30b = icl(t30a + t29a, mn, mx);
    int64_t t31a = icl(t31 + t28, mn, mx);
    int64_t t18c = r12(t29b * 1567 - t18b * 3784);
    int64_t t29c = r12(t29b * 3784 + t18b * 1567);
    int64_t t19b = r12(t28a * 1567 - t19a * 3784);
    int64_t t28b = r12(t28a * 3784 + t19a * 1567);
    int64_t t20b = r12(-(t27a * 3784 + t20a * 1567));
    int64_t t27b = r12(t27a * 1567 - t20a * 3784);
    int64_t t21c = r12(-(t26b * 3784 + t21b * 1567));
    int64_t t26c = r12(t26b * 1567 - t21b * 3784);
    int64_t u16 = icl(t16a + t23a, mn, mx);
    int64_t u17 = icl(t17b + t22b, mn, mx);
    int64_t u18 = icl(t18c + t21c, mn, mx);
    int64_t u19 = icl(t19b + t20b, mn, mx);
    int64_t u20 = icl(t19b - t20b, mn, mx);
    int64_t u21 = icl(t18c - t21c, mn, mx);
    int64_t u22 = icl(t17b - t22b, mn, mx);
    int64_t u23 = icl(t16a - t23a, mn, mx);
    int64_t u24 = icl(t31a - t24a, mn, mx);
    int64_t u25 = icl(t30b - t25b, mn, mx);
    int64_t u26 = icl(t29c - t26c, mn, mx);
    int64_t u27 = icl(t28b - t27b, mn, mx);
    int64_t u28 = icl(t28b + t27b, mn, mx);
    int64_t u29 = icl(t29c + t26c, mn, mx);
    int64_t u30 = icl(t30b + t25b, mn, mx);
    int64_t u31 = icl(t31a + t24a, mn, mx);
    int64_t v20 = ihalf(u27 - u20);
    int64_t v27 = ihalf(u27 + u20);
    int64_t v21 = ihalf(u26 - u21);
    int64_t v26 = ihalf(u26 + u21);
    int64_t v22 = ihalf(u25 - u22);
    int64_t v25 = ihalf(u25 + u22);
    int64_t v23 = ihalf(u24 - u23);
    int64_t v24 = ihalf(u24 + u23);
    int64_t o[16] = {u16, u17, u18, u19, v20, v21, v22, v23,
                     v24, v25, v26, v27, u28, u29, u30, u31};
    for (int i = 0; i < 16; i++) c[i] = icl(t[i] + o[15 - i], mn, mx);
    for (int i = 0; i < 16; i++) c[16 + i] = icl(t[15 - i] - o[i], mn, mx);
}

static int itx_bitrev(int j, int bits) {
    int out = 0;
    for (int b = 0; b < bits; b++) { out = (out << 1) | (j & 1); j >>= 1; }
    return out;
}

/* generic odd-part merge of the inverse DCT (itx_ref._odd_merge), with
   the m=32 rotation schedule (angles + action per lane) precomputed
   once — the schedule is pure index math, identical across calls */
typedef struct {
    /* per level L (1..3 before the final-halves level): per lane i of
       m/2: action 0 none / 1 rot-a / 2 rot-b, and the cos pair */
    int8_t act[3][16];
    int32_t c_ang[3][16], c_co[3][16];
} OddSched;

static const OddSched *odd_sched32(void) {
    static OddSched sc;
    static int init = 0;
    if (!init) {
        int m = 32, lg = 5;
        for (int L = 1; L <= 3; L++) {
            int size = 1 << (L + 1);
            int base = 1 << (L + 6 - lg);
            int nq_bits = lg - L - 2;
            for (int i = 0; i < m / 2; i++) {
                int qq = i >> (L + 1);
                int ang = base * (1 + 4 * itx_bitrev(qq, nq_bits));
                int rr = i % size;
                int a = 0;
                if (size / 4 <= rr && rr < size / 2) a = 1;
                else if (size / 2 <= rr && rr < 3 * size / 4) a = 2;
                sc.act[L - 1][i] = (int8_t)a;
                sc.c_ang[L - 1][i] = (int32_t)cos128(ang);
                sc.c_co[L - 1][i] = (int32_t)cos128(64 - ang);
            }
        }
        init = 1;
    }
    return &sc;
}

static void odd_merge(int64_t *s, int m, int64_t mn, int64_t mx) {
    const OddSched *sc = odd_sched32();
    int64_t tmp[32];
    for (int g = 0; g < m / 2; g++) {
        int64_t a = s[2 * g], b = s[2 * g + 1];
        if (g % 2 == 0) {
            s[2 * g] = icl(a + b, mn, mx);
            s[2 * g + 1] = icl(a - b, mn, mx);
        } else {
            s[2 * g] = icl(b - a, mn, mx);
            s[2 * g + 1] = icl(b + a, mn, mx);
        }
    }
    for (int L = 1; L <= 4; L++) {
        int size = 1 << (L + 1);
        if (L == 4) {       /* final level: 1/sqrt2 halves */
            for (int i = m / 4; i < m / 2; i++) {
                int64_t a = s[i], b = s[m - 1 - i];
                s[i] = ihalf(b - a);
                s[m - 1 - i] = ihalf(b + a);
            }
            break;
        }
        const int8_t *act = sc->act[L - 1];
        const int32_t *cang = sc->c_ang[L - 1];
        const int32_t *cco = sc->c_co[L - 1];
        for (int i = 0; i < m / 2; i++) {
            int j = m - 1 - i;
            int64_t a = s[i], b = s[j];
            if (act[i] == 1) {
                s[i] = r12(b * cco[i] - a * cang[i]);
                s[j] = r12(b * cang[i] + a * cco[i]);
            } else if (act[i] == 2) {
                s[i] = r12(-(b * cang[i] + a * cco[i]));
                s[j] = r12(b * cco[i] - a * cang[i]);
            }
        }
        for (int gi = 0; gi < m / size; gi++) {
            int basei = gi * size;
            for (int i = 0; i < size / 2; i++) {
                int lo_i = basei + i;
                int hi_i = basei + size - 1 - i;
                if (gi % 2 == 0) {
                    tmp[lo_i] = icl(s[lo_i] + s[hi_i], mn, mx);
                    tmp[hi_i] = icl(s[lo_i] - s[hi_i], mn, mx);
                } else {
                    tmp[lo_i] = icl(s[hi_i] - s[lo_i], mn, mx);
                    tmp[hi_i] = icl(s[hi_i] + s[lo_i], mn, mx);
                }
            }
        }
        memcpy(s, tmp, sizeof(int64_t) * (size_t)m);
    }
}

static void inv_dct64(int64_t *c, int64_t mn, int64_t mx) {
    int64_t t[32];
    for (int i = 0; i < 32; i++) t[i] = c[2 * i];
    inv_dct32(t, mn, mx);
    static int8_t i0_tab[16];
    static int32_t cphi[16], ccophi[16];
    static int init = 0;
    if (!init) {
        for (int j = 0; j < 16; j++) {
            int phi = 1 + 4 * itx_bitrev(j, 4);
            i0_tab[j] = (int8_t)(1 + 2 * itx_bitrev(j, 5));
            cphi[j] = (int32_t)cos128(phi);
            ccophi[j] = (int32_t)cos128(64 - phi);
        }
        init = 1;
    }
    int64_t o[32];
    for (int j = 0; j < 16; j++) {
        int i0 = i0_tab[j];
        int64_t a = c[i0], b = c[64 - i0];
        o[j] = r12(a * ccophi[j] - b * cphi[j]);
        o[31 - j] = r12(a * cphi[j] + b * ccophi[j]);
    }
    odd_merge(o, 32, mn, mx);
    for (int i = 0; i < 32; i++) c[i] = icl(t[i] + o[31 - i], mn, mx);
    for (int i = 0; i < 32; i++) c[32 + i] = icl(t[31 - i] - o[i], mn, mx);
}

static void inv_adst4(int64_t *c, int64_t mn, int64_t mx) {
    (void)mn; (void)mx;
    int64_t in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    int64_t s0 = 1321 * in0;
    int64_t s1 = 2482 * in0;
    int64_t s2 = 3344 * in1;
    int64_t s3 = 3803 * in2;
    int64_t s4 = 1321 * in2;
    int64_t s5 = 2482 * in3;
    int64_t s6 = 3803 * in3;
    int64_t b7 = (in0 - in2) + in3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = 3344 * b7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    c[0] = r12(s0 + s3);
    c[1] = r12(s1 + s3);
    c[2] = r12(s2);
    c[3] = r12(s0 + s1 - s3);
}

static void inv_adst8(int64_t *c, int64_t mn, int64_t mx) {
    int64_t in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    int64_t in4 = c[4], in5 = c[5], in6 = c[6], in7 = c[7];
    int64_t t0a = r12(4076 * in7 + 401 * in0);
    int64_t t1a = r12(401 * in7 - 4076 * in0);
    int64_t t2a = r12(3612 * in5 + 1931 * in2);
    int64_t t3a = r12(1931 * in5 - 3612 * in2);
    int64_t t4a = r12(2598 * in3 + 3166 * in4);
    int64_t t5a = r12(3166 * in3 - 2598 * in4);
    int64_t t6a = r12(1189 * in1 + 3920 * in6);
    int64_t t7a = r12(3920 * in1 - 1189 * in6);
    int64_t t0 = icl(t0a + t4a, mn, mx);
    int64_t t1 = icl(t1a + t5a, mn, mx);
    int64_t t2 = icl(t2a + t6a, mn, mx);
    int64_t t3 = icl(t3a + t7a, mn, mx);
    int64_t t4 = icl(t0a - t4a, mn, mx);
    int64_t t5 = icl(t1a - t5a, mn, mx);
    int64_t t6 = icl(t2a - t6a, mn, mx);
    int64_t t7 = icl(t3a - t7a, mn, mx);
    t4a = r12(3784 * t4 + 1567 * t5);
    t5a = r12(1567 * t4 - 3784 * t5);
    t6a = r12(-(1567 * t6) + 3784 * t7);
    t7a = r12(3784 * t6 + 1567 * t7);
    int64_t out0 = icl(t0 + t2, mn, mx);
    int64_t out7 = -icl(t1 + t3, mn, mx);
    int64_t t2b = icl(t0 - t2, mn, mx);
    int64_t t3b = icl(t1 - t3, mn, mx);
    int64_t out1 = -icl(t4a + t6a, mn, mx);
    int64_t out6 = icl(t5a + t7a, mn, mx);
    int64_t t6b = icl(t4a - t6a, mn, mx);
    int64_t t7b = icl(t5a - t7a, mn, mx);
    c[0] = out0;
    c[1] = out1;
    c[2] = ihalf(t6b + t7b);
    c[3] = -ihalf(t2b + t3b);
    c[4] = ihalf(t2b - t3b);
    c[5] = -ihalf(t6b - t7b);
    c[6] = out6;
    c[7] = out7;
}

static void inv_adst16(int64_t *c, int64_t mn, int64_t mx) {
    int64_t x[16];
    memcpy(x, c, sizeof(x));
    int64_t t0a = r12(4091 * x[15] + 201 * x[0]);
    int64_t t1a = r12(201 * x[15] - 4091 * x[0]);
    int64_t t2a = r12(3973 * x[13] + 995 * x[2]);
    int64_t t3a = r12(995 * x[13] - 3973 * x[2]);
    int64_t t4a = r12(3703 * x[11] + 1751 * x[4]);
    int64_t t5a = r12(1751 * x[11] - 3703 * x[4]);
    int64_t t6a = r12(3290 * x[9] + 2440 * x[6]);
    int64_t t7a = r12(2440 * x[9] - 3290 * x[6]);
    int64_t t8a = r12(2751 * x[7] + 3035 * x[8]);
    int64_t t9a = r12(3035 * x[7] - 2751 * x[8]);
    int64_t t10a = r12(2106 * x[5] + 3513 * x[10]);
    int64_t t11a = r12(3513 * x[5] - 2106 * x[10]);
    int64_t t12a = r12(1380 * x[3] + 3857 * x[12]);
    int64_t t13a = r12(3857 * x[3] - 1380 * x[12]);
    int64_t t14a = r12(601 * x[1] + 4052 * x[14]);
    int64_t t15a = r12(4052 * x[1] - 601 * x[14]);
    int64_t t0 = icl(t0a + t8a, mn, mx);
    int64_t t1 = icl(t1a + t9a, mn, mx);
    int64_t t2 = icl(t2a + t10a, mn, mx);
    int64_t t3 = icl(t3a + t11a, mn, mx);
    int64_t t4 = icl(t4a + t12a, mn, mx);
    int64_t t5 = icl(t5a + t13a, mn, mx);
    int64_t t6 = icl(t6a + t14a, mn, mx);
    int64_t t7 = icl(t7a + t15a, mn, mx);
    int64_t t8 = icl(t0a - t8a, mn, mx);
    int64_t t9 = icl(t1a - t9a, mn, mx);
    int64_t t10 = icl(t2a - t10a, mn, mx);
    int64_t t11 = icl(t3a - t11a, mn, mx);
    int64_t t12 = icl(t4a - t12a, mn, mx);
    int64_t t13 = icl(t5a - t13a, mn, mx);
    int64_t t14 = icl(t6a - t14a, mn, mx);
    int64_t t15 = icl(t7a - t15a, mn, mx);
    t8a = r12(4017 * t8 + 799 * t9);
    t9a = r12(799 * t8 - 4017 * t9);
    t10a = r12(2276 * t10 + 3406 * t11);
    t11a = r12(3406 * t10 - 2276 * t11);
    t12a = r12(-(799 * t12) + 4017 * t13);
    t13a = r12(4017 * t12 + 799 * t13);
    t14a = r12(-(3406 * t14) + 2276 * t15);
    t15a = r12(2276 * t14 + 3406 * t15);
    int64_t t0b = icl(t0 + t4, mn, mx);
    int64_t t1b = icl(t1 + t5, mn, mx);
    int64_t t2b = icl(t2 + t6, mn, mx);
    int64_t t3b = icl(t3 + t7, mn, mx);
    int64_t t4b = icl(t0 - t4, mn, mx);
    int64_t t5b = icl(t1 - t5, mn, mx);
    int64_t t6b = icl(t2 - t6, mn, mx);
    int64_t t7b = icl(t3 - t7, mn, mx);
    int64_t t8b = icl(t8a + t12a, mn, mx);
    int64_t t9b = icl(t9a + t13a, mn, mx);
    int64_t t10b = icl(t10a + t14a, mn, mx);
    int64_t t11b = icl(t11a + t15a, mn, mx);
    int64_t t12b = icl(t8a - t12a, mn, mx);
    int64_t t13b = icl(t9a - t13a, mn, mx);
    int64_t t14b = icl(t10a - t14a, mn, mx);
    int64_t t15b = icl(t11a - t15a, mn, mx);
    int64_t t4c = r12(3784 * t4b + 1567 * t5b);
    int64_t t5c = r12(1567 * t4b - 3784 * t5b);
    int64_t t6c = r12(-(1567 * t6b) + 3784 * t7b);
    int64_t t7c = r12(3784 * t6b + 1567 * t7b);
    int64_t t12c = r12(3784 * t12b + 1567 * t13b);
    int64_t t13c = r12(1567 * t12b - 3784 * t13b);
    int64_t t14c = r12(-(1567 * t14b) + 3784 * t15b);
    int64_t t15c = r12(3784 * t14b + 1567 * t15b);
    int64_t x0 = icl(t0b + t2b, mn, mx);
    int64_t x1 = icl(t1b + t3b, mn, mx);
    int64_t x2 = icl(t0b - t2b, mn, mx);
    int64_t x3 = icl(t1b - t3b, mn, mx);
    int64_t x4 = icl(t4c + t6c, mn, mx);
    int64_t x5 = icl(t5c + t7c, mn, mx);
    int64_t x6 = icl(t4c - t6c, mn, mx);
    int64_t x7 = icl(t5c - t7c, mn, mx);
    int64_t x8 = icl(t8b + t10b, mn, mx);
    int64_t x9 = icl(t9b + t11b, mn, mx);
    int64_t x10 = icl(t8b - t10b, mn, mx);
    int64_t x11 = icl(t9b - t11b, mn, mx);
    int64_t x12 = icl(t12c + t14c, mn, mx);
    int64_t x13 = icl(t13c + t15c, mn, mx);
    int64_t x14 = icl(t12c - t14c, mn, mx);
    int64_t x15 = icl(t13c - t15c, mn, mx);
    int64_t y2 = ihalf(x2 + x3), y3 = ihalf(x2 - x3);
    int64_t y6 = ihalf(x6 + x7), y7 = ihalf(x6 - x7);
    int64_t y10 = ihalf(x10 + x11), y11 = ihalf(x10 - x11);
    int64_t y14 = ihalf(x14 + x15), y15 = ihalf(x14 - x15);
    c[0] = x0;   c[1] = -x8;  c[2] = x12;  c[3] = -x4;
    c[4] = y6;   c[5] = -y14; c[6] = y10;  c[7] = -y2;
    c[8] = y3;   c[9] = -y11; c[10] = y15; c[11] = -y7;
    c[12] = x5;  c[13] = -x13; c[14] = x9; c[15] = -x1;
}

static void inv_identity(int64_t *c, int n) {
    if (n == 4) {
        for (int i = 0; i < 4; i++) c[i] = (c[i] * 5793 + 2048) >> 12;
    } else if (n == 8) {
        for (int i = 0; i < 8; i++) c[i] = c[i] * 2;
    } else if (n == 16) {
        for (int i = 0; i < 16; i++) c[i] = (c[i] * 2 * 5793 + 2048) >> 12;
    } else {
        for (int i = 0; i < n; i++) c[i] = c[i] * 4;
    }
}

/* kind: 0 dct, 1 adst, 2 flipadst, 3 identity; in-place on c[0..n-1] */
static void itx_1d(int kind, int64_t *c, int n, int64_t mn, int64_t mx) {
    if (kind == 3) { inv_identity(c, n); return; }
    if (kind == 0) {
        switch (n) {
        case 4: inv_dct4(c, mn, mx); return;
        case 8: inv_dct8(c, mn, mx); return;
        case 16: inv_dct16(c, mn, mx); return;
        case 32: inv_dct32(c, mn, mx); return;
        default: inv_dct64(c, mn, mx); return;
        }
    }
    switch (n) {
    case 4: inv_adst4(c, mn, mx); break;
    case 8: inv_adst8(c, mn, mx); break;
    default: inv_adst16(c, mn, mx); break;
    }
    if (kind == 2) {   /* flipadst: reverse output */
        for (int i = 0; i < n / 2; i++) {
            int64_t t = c[i];
            c[i] = c[n - 1 - i];
            c[n - 1 - i] = t;
        }
    }
}
