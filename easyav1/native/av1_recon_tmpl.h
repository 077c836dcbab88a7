/* AV1 frame reconstruction, loop filter and CDEF — native host path.
 *
 * Port of the verified numpy references (recon_ref.py, lf_ref.py,
 * cdef_ref.py; spec §7.11/§7.13/§7.14/§7.15), consuming the TileOut
 * arrays produced by av1_tile.c.  Tests assert the output planes are
 * bit-identical to the numpy pipeline (which is itself bit-exact vs
 * libdav1d on the fixture corpus).
 *
 * This is the production decode path (SURVEY.md §7 stage 3 host side);
 * the JAX kernels in easyav1/video/av1/recon/ are the device path
 * for the same math.
 *
 * Compiled TWICE, like dav1d's templated dense-stage units
 * (cmake/dav1d.cmake:1001-1015): av1_recon.c builds the 16-bit-pel
 * body (10/12bpc streams, plain symbol names) and av1_recon8.c the
 * 8-bit-pel body (uint8 planes, `_8`-suffixed exports via BDFN) —
 * halving pixel memory traffic for 8bpc streams on the
 * bandwidth-bound host.  Pel-independent exports compile once, in the
 * 16-bit unit.
 */
#ifndef BDFN
#define BDFN(name) name
#endif

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "av1_common.h"
#include "av1_itx.h"
#include "av1_itx_vec.h"
#include "av1_tables.h"

#include <time.h>

/* cumulative per-stage wall times (profiling; av1_get_stage_times),
   shared by both pel builds.  Per-frame stages accumulate seconds
   directly (av1_stage_times); the per-block / per-transform sub-stage
   timers are rdtsc ticks (av1_stage_ticks) gated behind rc_profile —
   clock_gettime is ~180 cycles on this host and two calls per
   transform were costing whole milliseconds per frame in production */
#if PEL_BITS == 16
double av1_stage_times[8];
uint64_t av1_stage_ticks[8];
int rc_profile;

void av1_set_stage_profile(int on) { rc_profile = on; }

void av1_get_stage_times(double *out) {
    static double tsc_hz;
    int any_ticks = 0;
    for (int i = 0; i < 8; i++) any_ticks |= av1_stage_ticks[i] != 0;
    if (any_ticks && tsc_hz == 0.0) {
        /* one-time tick->seconds calibration (profiling path only) */
        struct timespec a, b;
        clock_gettime(CLOCK_MONOTONIC, &a);
        uint64_t c0 = __builtin_ia32_rdtsc();
        double el;
        do {
            clock_gettime(CLOCK_MONOTONIC, &b);
            el = (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
        } while (el < 0.005);
        tsc_hz = (double)(__builtin_ia32_rdtsc() - c0) / el;
    }
    for (int i = 0; i < 8; i++) {
        out[i] = av1_stage_times[i]
                 + (tsc_hz ? av1_stage_ticks[i] / tsc_hz : 0.0);
        av1_stage_times[i] = 0.0;
        av1_stage_ticks[i] = 0;
    }
}

/* rdtsc exposed for the profiler's cycle->seconds calibration */
uint64_t av1_rdtsc(void) { return __builtin_ia32_rdtsc(); }
#else
extern double av1_stage_times[8];
extern uint64_t av1_stage_ticks[8];
extern int rc_profile;
#endif

static double rc_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

/* hot-path sub-stage timer: zero cost unless profiling is enabled */
static inline uint64_t rc_tick(void) {
    return __builtin_expect(rc_profile, 0) ? __builtin_ia32_rdtsc() : 0;
}
static inline void rc_tick_add(int slot, uint64_t t0) {
    if (__builtin_expect(rc_profile, 0))
        av1_stage_ticks[slot] += __builtin_ia32_rdtsc() - t0;
}

static int rmin(int a, int b) { return a < b ? a : b; }
static int rmax(int a, int b) { return a > b ? a : b; }
static int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
static int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

#ifdef __AVX2__
#include <immintrin.h>
#endif

enum { DC_PRED = 0, V_PRED = 1, H_PRED = 2, D45_PRED = 3, D67_PRED = 8,
       SMOOTH_PRED = 9, SMOOTH_V_PRED = 10, SMOOTH_H_PRED = 11,
       PAETH_PRED = 12, UV_CFL = 13 };

/* row shift per tx size (recon_ref._ROW_SHIFT) */
static const int8_t ROW_SHIFT[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1,
                                     1, 1, 1, 2, 2, 2, 2};

/* 1-D kinds per tx type (vertical, horizontal); 0 dct 1 adst 2 flip 3 id */
static const int8_t TX_1D[16][2] = {
    {0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {0, 2}, {2, 2}, {1, 2},
    {2, 1}, {3, 3}, {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};

/* ------------------------------------------------------------------ */
/* 2-D inverse transform (recon_ref.inverse_transform)                 */

/* inverse 4x4 Walsh-Hadamard (recon_ref lossless arm,
 * aom_iwht4x4_16_add): input >> 2, row butterflies, column pass */
static void wht4_1d(int64_t *v) {
    int64_t a = v[0], c_ = v[1], d = v[2], b = v[3];
    a = a + c_;
    d = d - b;
    int64_t e = (a - d) >> 1;
    b = e - b;
    c_ = e - c_;
    a = a - b;
    d = d + c_;
    v[0] = a; v[1] = b; v[2] = c_; v[3] = d;
}

static void itx_wht4(const int32_t *coeffs, int32_t *out) {
    int64_t t[4][4];
    for (int i = 0; i < 4; i++) {
        int64_t v[4] = {coeffs[i * 4 + 0] >> 2, coeffs[i * 4 + 1] >> 2,
                        coeffs[i * 4 + 2] >> 2, coeffs[i * 4 + 3] >> 2};
        wht4_1d(v);
        for (int j = 0; j < 4; j++) t[i][j] = v[j];
    }
    for (int j = 0; j < 4; j++) {
        int64_t v[4] = {t[0][j], t[1][j], t[2][j], t[3][j]};
        wht4_1d(v);
        for (int i = 0; i < 4; i++) out[i * 4 + j] = (int32_t)v[i];
    }
}

/* DC-only DCT_DCT: the 1-D inverse DCT of [v, 0, ...] is uniformly
 * ihalf(v) at every size (even halves recurse to dct4's ihalf, odd
 * halves are all zero), so the whole 2-D transform collapses to one
 * constant. Mirrors the exact clamp/round chain of the generic path. */
static inline int64_t itx_ihalf64(int64_t x) { return (x * 181 + 128) >> 8; }

static int32_t itx_dc_value(int64_t v0, int tx_size, int64_t mn,
                            int64_t mx) {
    int w = av1_tx_w[tx_size], h = av1_tx_h[tx_size];
    int lw = 0, lh = 0;
    for (int v = w; v > 1; v >>= 1) lw++;
    for (int v = h; v > 1; v >>= 1) lh++;
    if ((lw > lh ? lw - lh : lh - lw) == 1)
        v0 = (v0 * 2896 + 2048) >> 12;
    int shift = ROW_SHIFT[tx_size];
    int64_t r = icl(itx_ihalf64(v0), mn, mx);           /* row pass */
    r = icl((r + ((1 << shift) >> 1)) >> shift, mn, mx); /* row shift */
    r = icl(itx_ihalf64(r), mn, mx);                    /* col pass */
    return (int32_t)((r + 8) >> 4);
}

/* detects [v, 0, ...] (dense aw x ah coefficient layout) */
static inline int itx_is_dc_only(const int32_t *coeffs, int tx_size) {
    int adj = av1_adj_tx[tx_size];
    int n = av1_tx_w[adj] * av1_tx_h[adj];
    for (int i = 1; i < n; i++)
        if (coeffs[i]) return 0;
    return 1;
}

/* bd==8 full-int32 path: both 1-D passes run 8 lanes per GCC vector
 * (rows via a transposed slab for the row pass, columns directly);
 * bit-exact with the scalar int64 kernels — see av1_itx_vec.h. */
static void itx_2d_v(const int32_t *coeffs, int tx_size, int tx_type,
                     int32_t *out /* h*w */, int nzpack) {
    int w = av1_tx_w[tx_size], h = av1_tx_h[tx_size];
    int adj = av1_adj_tx[tx_size];
    int aw = av1_tx_w[adj], ah = av1_tx_h[adj];
    if (tx_type == 0
        && (nzpack >= 0 ? (nzpack & 0xfff) == 1
                        : itx_is_dc_only(coeffs, tx_size))) {
        int32_t dc = itx_dc_value(coeffs[0], tx_size, -(1 << 15),
                                  (1 << 15) - 1);
        for (int i = 0; i < w * h; i++) out[i] = dc;
        return;
    }
    int32_t mn32 = -(1 << 15), mx32 = (1 << 15) - 1;
    int vkind = TX_1D[tx_type][0], hkind = TX_1D[tx_type][1];

    /* nonzero extent: from the entropy decoder's packed bounding box
       when available, else a rescan; tail rows beyond nzh are never
       staged, transformed, or zero-filled */
    int nzh, nzw = aw;
    if (nzpack >= 0) {
        nzh = (nzpack >> 12) & 63;
        nzw = (nzpack >> 18) & 63;
        if (nzh > h) nzh = h;
        if (nzw > aw) nzw = aw;
    } else {
        nzh = ah < h ? ah : h;
        while (nzh > 0) {
            const int32_t *row = coeffs + (nzh - 1) * aw;
            int any = 0;
            for (int j = 0; j < aw; j++)
                if (row[j]) { any = 1; break; }
            if (any) break;
            nzh--;
        }
    }
    int32_t b32[64 * 64];
    for (int i = 0; i < nzh; i++) {
        memcpy(b32 + i * w, coeffs + i * aw, sizeof(int32_t) * nzw);
        for (int j = nzw; j < w; j++) b32[i * w + j] = 0;
    }
    int lw = 0, lh = 0;
    for (int v = w; v > 1; v >>= 1) lw++;
    for (int v = h; v > 1; v >>= 1) lh++;
    if ((lw > lh ? lw - lh : lh - lw) == 1)
        for (int i = 0; i < nzh * w; i++)
            b32[i] = (b32[i] * 2896 + 2048) >> 12;
    int shift = ROW_SHIFT[tx_size];
    int rnd = (1 << shift) >> 1;
    v8si vmn = mn32 - (v8si){0}, vmx = mx32 - (v8si){0};
    if (nzh >= 3) {
        /* row pass on transposed 8-row slabs; pays off from ~3 rows
         * up at every width (the scalar fallback re-runs the whole
         * int64 1-D kernel per row, the slab runs it once per 8) */
        for (int i0 = 0; i0 < nzh; i0 += 8) {
            int nr = nzh - i0 < 8 ? nzh - i0 : 8;
            v8si tb[64];
#ifdef __AVX2__
            if ((w & 7) == 0) {
                /* register 8x8 transposes: the scalar gather/scatter
                   staging was ~2x the whole transform's cost at w=32
                   (2*8*w strided int32 moves per slab) */
                const __m256i z = _mm256_setzero_si256();
                for (int j = 0; j < w; j += 8) {
                    const int32_t *sp = b32 + (int64_t)i0 * w + j;
                    __m256i r0 = _mm256_loadu_si256((const __m256i *)sp);
                    __m256i r1 = nr > 1 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + w)) : z;
                    __m256i r2 = nr > 2 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 2 * w)) : z;
                    __m256i r3 = nr > 3 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 3 * w)) : z;
                    __m256i r4 = nr > 4 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 4 * w)) : z;
                    __m256i r5 = nr > 5 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 5 * w)) : z;
                    __m256i r6 = nr > 6 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 6 * w)) : z;
                    __m256i r7 = nr > 7 ? _mm256_loadu_si256(
                        (const __m256i *)(sp + 7 * w)) : z;
                    __m256i t0 = _mm256_unpacklo_epi32(r0, r1);
                    __m256i t1 = _mm256_unpackhi_epi32(r0, r1);
                    __m256i t2 = _mm256_unpacklo_epi32(r2, r3);
                    __m256i t3 = _mm256_unpackhi_epi32(r2, r3);
                    __m256i t4 = _mm256_unpacklo_epi32(r4, r5);
                    __m256i t5 = _mm256_unpackhi_epi32(r4, r5);
                    __m256i t6 = _mm256_unpacklo_epi32(r6, r7);
                    __m256i t7 = _mm256_unpackhi_epi32(r6, r7);
                    __m256i s0 = _mm256_unpacklo_epi64(t0, t2);
                    __m256i s1 = _mm256_unpackhi_epi64(t0, t2);
                    __m256i s2 = _mm256_unpacklo_epi64(t1, t3);
                    __m256i s3 = _mm256_unpackhi_epi64(t1, t3);
                    __m256i s4 = _mm256_unpacklo_epi64(t4, t6);
                    __m256i s5 = _mm256_unpackhi_epi64(t4, t6);
                    __m256i s6 = _mm256_unpacklo_epi64(t5, t7);
                    __m256i s7 = _mm256_unpackhi_epi64(t5, t7);
                    __m256i *tj = (__m256i *)&tb[j];
                    tj[0] = _mm256_permute2x128_si256(s0, s4, 0x20);
                    tj[1] = _mm256_permute2x128_si256(s1, s5, 0x20);
                    tj[2] = _mm256_permute2x128_si256(s2, s6, 0x20);
                    tj[3] = _mm256_permute2x128_si256(s3, s7, 0x20);
                    tj[4] = _mm256_permute2x128_si256(s0, s4, 0x31);
                    tj[5] = _mm256_permute2x128_si256(s1, s5, 0x31);
                    tj[6] = _mm256_permute2x128_si256(s2, s6, 0x31);
                    tj[7] = _mm256_permute2x128_si256(s3, s7, 0x31);
                }
                itx_1d_v8(hkind, tb, w, vmn, vmx);
                for (int j = 0; j < w; j += 8) {
                    __m256i *tj = (__m256i *)&tb[j];
                    for (int k = 0; k < 8; k++) {
                        v8si v = (tb[j + k] + rnd) >> shift;
                        tb[j + k] = vicl_v8(v, vmn, vmx);
                    }
                    __m256i t0 = _mm256_unpacklo_epi32(tj[0], tj[1]);
                    __m256i t1 = _mm256_unpackhi_epi32(tj[0], tj[1]);
                    __m256i t2 = _mm256_unpacklo_epi32(tj[2], tj[3]);
                    __m256i t3 = _mm256_unpackhi_epi32(tj[2], tj[3]);
                    __m256i t4 = _mm256_unpacklo_epi32(tj[4], tj[5]);
                    __m256i t5 = _mm256_unpackhi_epi32(tj[4], tj[5]);
                    __m256i t6 = _mm256_unpacklo_epi32(tj[6], tj[7]);
                    __m256i t7 = _mm256_unpackhi_epi32(tj[6], tj[7]);
                    __m256i s0 = _mm256_unpacklo_epi64(t0, t2);
                    __m256i s1 = _mm256_unpackhi_epi64(t0, t2);
                    __m256i s2 = _mm256_unpacklo_epi64(t1, t3);
                    __m256i s3 = _mm256_unpackhi_epi64(t1, t3);
                    __m256i s4 = _mm256_unpacklo_epi64(t4, t6);
                    __m256i s5 = _mm256_unpackhi_epi64(t4, t6);
                    __m256i s6 = _mm256_unpacklo_epi64(t5, t7);
                    __m256i s7 = _mm256_unpackhi_epi64(t5, t7);
                    __m256i o0 = _mm256_permute2x128_si256(s0, s4, 0x20);
                    __m256i o1 = _mm256_permute2x128_si256(s1, s5, 0x20);
                    __m256i o2 = _mm256_permute2x128_si256(s2, s6, 0x20);
                    __m256i o3 = _mm256_permute2x128_si256(s3, s7, 0x20);
                    __m256i o4 = _mm256_permute2x128_si256(s0, s4, 0x31);
                    __m256i o5 = _mm256_permute2x128_si256(s1, s5, 0x31);
                    __m256i o6 = _mm256_permute2x128_si256(s2, s6, 0x31);
                    __m256i o7 = _mm256_permute2x128_si256(s3, s7, 0x31);
                    int32_t *dp = b32 + (int64_t)i0 * w + j;
                    __m256i ov[8] = {o0, o1, o2, o3, o4, o5, o6, o7};
                    for (int r = 0; r < nr; r++)
                        _mm256_storeu_si256(
                            (__m256i *)(dp + (int64_t)r * w), ov[r]);
                }
                continue;
            }
#endif
            for (int j = 0; j < w; j++) {
                int32_t tmp[8] = {0};
                for (int r = 0; r < nr; r++)
                    tmp[r] = b32[(i0 + r) * w + j];
                memcpy(&tb[j], tmp, sizeof(tmp));
            }
            itx_1d_v8(hkind, tb, w, vmn, vmx);
            for (int j = 0; j < w; j++) {
                v8si v = (tb[j] + rnd) >> shift;
                v = vicl_v8(v, vmn, vmx);
                int32_t tmp[8];
                memcpy(tmp, &v, sizeof(tmp));
                for (int r = 0; r < nr; r++)
                    b32[(i0 + r) * w + j] = tmp[r];
            }
        }
    } else {
        int64_t vec[64];
        int64_t mn = -(int64_t)(1 << 15), mx = (1 << 15) - 1;
        for (int i = 0; i < nzh; i++) {
            for (int j = 0; j < w; j++) vec[j] = b32[i * w + j];
            itx_1d(hkind, vec, w, mn, mx);
            for (int j = 0; j < w; j++) {
                int64_t v = (vec[j] + rnd) >> shift;
                b32[i * w + j] = (int32_t)icl(v, mn, mx);
            }
        }
    }
    /* column pass (rows >= nzh were never staged: all-zero inputs) */
    if (w >= 8) {
        v8si col[64];
        const v8si vz = (v8si){0};
        for (int j = 0; j < w; j += 8) {
            for (int i = 0; i < nzh; i++)
                memcpy(&col[i], b32 + i * w + j, sizeof(v8si));
            for (int i = nzh; i < h; i++) col[i] = vz;
            itx_1d_v8(vkind, col, h, vmn, vmx);
            for (int i = 0; i < h; i++) {
                v8si o = (col[i] + 8) >> 4;
                memcpy(out + i * w + j, &o, sizeof(v8si));
            }
        }
    } else {
        v4si col[64];
        const v4si vz4 = (v4si){0};
        v4si vmn4 = mn32 - (v4si){0}, vmx4 = mx32 - (v4si){0};
        for (int i = 0; i < nzh; i++)
            memcpy(&col[i], b32 + i * 4, sizeof(v4si));
        for (int i = nzh; i < h; i++) col[i] = vz4;
        itx_1d_v4(vkind, col, h, vmn4, vmx4);
        for (int i = 0; i < h; i++) {
            v4si o = (col[i] + 8) >> 4;
            memcpy(out + i * 4, &o, sizeof(v4si));
        }
    }
}

static void itx_2d(const int32_t *coeffs, int tx_size, int tx_type,
                   int bitdepth, int32_t *out /* h*w */, int nzpack) {
    if (bitdepth == 8) {
        itx_2d_v(coeffs, tx_size, tx_type, out, nzpack);
        return;
    }
    int w = av1_tx_w[tx_size], h = av1_tx_h[tx_size];
    int adj = av1_adj_tx[tx_size];
    int aw = av1_tx_w[adj], ah = av1_tx_h[adj];
    int64_t mn = -((int64_t)1 << (bitdepth + 7));
    int64_t mx = ((int64_t)1 << (bitdepth + 7)) - 1;
    if (tx_type == 0
        && (nzpack >= 0 ? (nzpack & 0xfff) == 1
                        : itx_is_dc_only(coeffs, tx_size))) {
        int32_t dc = itx_dc_value(coeffs[0], tx_size, mn, mx);
        for (int i = 0; i < w * h; i++) out[i] = dc;
        return;
    }
    int vkind = TX_1D[tx_type][0], hkind = TX_1D[tx_type][1];

    int64_t buf[64 * 64];
    memset(buf, 0, sizeof(int64_t) * (size_t)(w * h));
    for (int i = 0; i < ah; i++)
        for (int j = 0; j < aw; j++)
            buf[i * w + j] = coeffs[i * aw + j];

    /* rectangular scaling when the aspect ratio is 2:1 */
    int lw = 0, lh = 0;
    for (int v = w; v > 1; v >>= 1) lw++;
    for (int v = h; v > 1; v >>= 1) lh++;
    if ((lw > lh ? lw - lh : lh - lw) == 1)
        for (int i = 0; i < w * h; i++)
            buf[i] = (buf[i] * 2896 + 2048) >> 12;

    /* zero rows transform to zero rows (all 1-D kernels are linear),
       so the row pass only needs the coefficient-carrying prefix —
       from the entropy decoder's packed bounding box when available */
    int nzh;
    if (nzpack >= 0) {
        nzh = (nzpack >> 12) & 63;
        if (nzh > h) nzh = h;
    } else {
        nzh = ah < h ? ah : h;
        while (nzh > 0) {
            const int64_t *row = buf + (nzh - 1) * w;
            int any = 0;
            for (int j = 0; j < w; j++)
                if (row[j]) { any = 1; break; }
            if (any) break;
            nzh--;
        }
    }

    /* row pass along the width, then row shift + clamp */
    int shift = ROW_SHIFT[tx_size];
    int64_t vec[64];
    for (int i = 0; i < nzh; i++) {
        memcpy(vec, buf + i * w, sizeof(int64_t) * (size_t)w);
        itx_1d(hkind, vec, w, mn, mx);
        for (int j = 0; j < w; j++) {
            int64_t v = (vec[j] + ((1 << shift) >> 1)) >> shift;
            buf[i * w + j] = icl(v, mn, mx);
        }
    }
    /* column pass along the height, then final shift 4 */
    for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) vec[i] = buf[i * w + j];
        itx_1d(vkind, vec, h, mn, mx);
        for (int i = 0; i < h; i++)
            out[i * w + j] = (int32_t)((vec[i] + 8) >> 4);
    }
}

/* ------------------------------------------------------------------ */
/* intra prediction (recon_ref._predict_intra)                         */

/* Deferred integer-MV copy plan: skip blocks whose prediction is a
 * plain inside-the-ref block copy are queued instead of copied block
 * by block, then flushed as (y,x)-sorted, x-merged row bands — the
 * per-block z-order copy pattern is DRAM-latency-bound at 4K (64-byte
 * strided rows defeat the hardware prefetcher) while merged full-width
 * bands stream at memcpy speed.  Entries are only queued for pixels
 * nothing reads before the flush: the plan is flushed before any
 * intra / intra-block-copy block and at end of frame (inter
 * prediction, OBMC, compound and sub8x8 chroma read *reference*
 * frames only, never the plane under reconstruction). */
typedef struct {
    int32_t y, x, w, h;
    const pel *src;
    int64_t ss;
    int32_t nt;                  /* stream stores (no residual re-read) */
} CopyEnt;

typedef struct {
    CopyEnt *e;
    int n, cap;
} CopyPlan;

/* residuals of copy-deferred blocks, applied (per plane) after the
 * plane's copies land, band-interleaved so the freshly copied rows
 * are still cache-resident when the residual reads them back */
typedef struct {
    const int32_t *b;            /* block record */
    int32_t y;                   /* plane y of the block */
} ResidEnt;

typedef struct {
    ResidEnt *e;
    int n, cap;
} ResidPlan;

typedef struct {
    const ReconParams *rp;
    const TileOut *o;
    pel *planes[3];
    int pw[3], ph[3];            /* mi-aligned plane dims */
    uint8_t *decoded[3];         /* 4x4 BlockDecoded bitmaps */
    int dw[3], dh[3];
    int cur_fi;
    int error;
    /* inter reconstruction inputs (NULL for intra-only frames) */
    const FrameParams *fp;
    const RefPlanes *refs;
    /* per-block tx-record index (generation-tagged so no per-block
       clearing is needed; see recon_block) */
    int32_t txmap_idx[3][32 * 32];
    int32_t txmap_gen[3][32 * 32];
    int32_t txgen;
    /* current block's tile bounds, luma mi units (recon_set_tile) */
    int t_rs, t_re, t_cs, t_ce;
    CopyPlan cplan[3];
    ResidPlan rplan[3];
} Recon;

/* cache tile bounds of the block at (r, c); tiles are few (<=64 per
 * axis) so a linear scan per block is cheap */
static void recon_set_tile(Recon *rc, int r, int c) {
    const ReconParams *rp = rc->rp;
    if (rp->tile_cols <= 1 && rp->tile_rows <= 1) {
        rc->t_rs = 0; rc->t_re = rp->mi_rows;
        rc->t_cs = 0; rc->t_ce = rp->mi_cols;
        return;
    }
    int i = 0;
    while (i + 1 < rp->tile_cols && c >= rp->tile_col_starts[i + 1]) i++;
    rc->t_cs = rp->tile_col_starts[i];
    rc->t_ce = rp->tile_col_starts[i + 1];
    i = 0;
    while (i + 1 < rp->tile_rows && r >= rp->tile_row_starts[i + 1]) i++;
    rc->t_rs = rp->tile_row_starts[i];
    rc->t_re = rp->tile_row_starts[i + 1];
}


/* tile top/left edge of the current block in PLANE pixel coords */
static inline int tile_top_px(const Recon *rc, int plane) {
    return (rc->t_rs * 4) >> (plane ? rc->rp->ssy : 0);
}
static inline int tile_left_px(const Recon *rc, int plane) {
    return (rc->t_cs * 4) >> (plane ? rc->rp->ssx : 0);
}

static int avail_cell(const Recon *rc, int plane, int rr, int cc) {
    if (rr < 0 || cc < 0 || rr >= rc->dh[plane] || cc >= rc->dw[plane])
        return 0;
    /* tile-bounded: a decoded cell in another tile is not a neighbor */
    int sy = plane ? rc->rp->ssy : 0, sx = plane ? rc->rp->ssx : 0;
    int mr = rr << sy, mc = cc << sx;
    if (mr < rc->t_rs || mr >= rc->t_re || mc < rc->t_cs
        || mc >= rc->t_ce)
        return 0;
    return rc->decoded[plane][rr * rc->dw[plane] + cc];
}

/* spec get_filter_type: above/left BLOCK neighbour used a smooth mode.
 * For chroma the neighbours are libaom's chroma_above_mbmi /
 * chroma_left_mbmi: the mi at the chroma-aligned BOTTOM-RIGHT cell,
 * stepped up/left — above reads row r0-1 at col c0|ssx, left reads
 * col c0-1 at row r0|ssy.  A sub-8x8 neighbour pair stores its coded
 * uv_mode only in the carrier (bottom-right) mi, so the top-row cell
 * the naive lookup hits holds no chroma mode. */
static int filter_type(const Recon *rc, int br, int bc, int plane) {
    const int8_t *modes = plane == 0 ? rc->o->y_mode : rc->o->uv_mode;
    int mc = rc->rp->mi_cols;
    int ra = br, ca = bc, rl = br, cl = bc;
    if (plane) {
        int r0 = br & ~rc->rp->ssy, c0 = bc & ~rc->rp->ssx;
        ra = r0;
        ca = c0 | rc->rp->ssx;
        rl = r0 | rc->rp->ssy;
        cl = c0;
    }
    int above = 0, left = 0;
    if (ra > rc->t_rs) {
        int m = modes[(ra - 1) * mc + ca];
        above = m >= SMOOTH_PRED && m <= SMOOTH_H_PRED;
    }
    if (cl > rc->t_cs) {
        int m = modes[rl * mc + (cl - 1)];
        left = m >= SMOOTH_PRED && m <= SMOOTH_H_PRED;
    }
    return (above || left) ? 1 : 0;
}

static int filter_strength(int blk_wh, int delta, int ftype) {
    int d = delta < 0 ? -delta : delta;
    int s = 0;
    if (ftype == 0) {
        if (blk_wh <= 8) { if (d >= 56) s = 1; }
        else if (blk_wh <= 12) { if (d >= 40) s = 1; }
        else if (blk_wh <= 16) { if (d >= 40) s = 1; }
        else if (blk_wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (blk_wh <= 32) {
            s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else s = 3;
    } else {
        if (blk_wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
        else if (blk_wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
        else if (blk_wh <= 24) { if (d >= 4) s = 3; }
        else s = 3;
    }
    return s;
}

static const int8_t EDGE_KERNELS[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

/* in-place 5-tap smoothing over edge[start..start+sz-1]; first element
   unfiltered (spec intra_edge_filter) */
static void edge_filter(int32_t *edge, int start, int sz, int strength) {
    if (strength == 0 || sz <= 1) return;
    const int8_t *kern = EDGE_KERNELS[strength - 1];
    int32_t orig[521];
    for (int k = 0; k < sz; k++) orig[k] = edge[start + k];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = i - 2 + j;
            if (k < 0) k = 0;
            if (k > sz - 1) k = sz - 1;
            s += kern[j] * orig[k];
        }
        edge[start + i] = (s + 8) >> 4;
    }
}

static int use_upsample(int w, int h, int delta, int ftype) {
    int d = delta < 0 ? -delta : delta;
    if (d <= 0 || d >= 40) return 0;
    return ftype ? (w + h) <= 8 : (w + h) <= 16;
}

/* spec upsample_intra_edge; corner at start-1 moves to start-2 */
static void upsample_edge(int32_t *edge, int start, int num_px, int bd) {
    int mx = (1 << bd) - 1;
    int32_t dup[262];
    dup[0] = edge[start - 1];
    dup[1] = edge[start - 1];
    for (int i = 0; i < num_px; i++) dup[2 + i] = edge[start + i];
    dup[num_px + 2] = dup[num_px + 1];
    edge[start - 2] = dup[0];
    for (int i = 0; i < num_px; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = (s + 8) >> 4;
        if (s < 0) s = 0;
        if (s > mx) s = mx;
        edge[start + 2 * i - 1] = s;
        edge[start + 2 * i] = dup[i + 2];
    }
}

#define OFF 2

static void directional(const uint16_t *dr, int p_angle,
                        const int32_t *A, const int32_t *L, int w, int h,
                        int up_above, int up_left, int64_t *out) {
    if (p_angle < 90) {
        int dx = dr[p_angle];
        int max_base = (w + h - 1) << up_above;
        for (int i = 0; i < h; i++) {
            int idx = (i + 1) * dx;
            for (int j = 0; j < w; j++) {
                int base = (idx >> (6 - up_above)) + (j << up_above);
                if (base >= max_base) {
                    out[i * w + j] = A[OFF + max_base];
                } else {
                    int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                    out[i * w + j] = (A[OFF + base] * (32 - shift)
                                      + A[OFF + base + 1] * shift + 16) >> 5;
                }
            }
        }
    } else if (p_angle > 180) {
        int dy = dr[270 - p_angle];
        int max_base = (w + h - 1) << up_left;
        for (int j = 0; j < w; j++) {
            int idy = (j + 1) * dy;
            for (int i = 0; i < h; i++) {
                int base = (idy >> (6 - up_left)) + (i << up_left);
                if (base >= max_base) {
                    out[i * w + j] = L[OFF + max_base];
                } else {
                    int shift = ((idy * (1 << up_left)) >> 1) & 0x1F;
                    out[i * w + j] = (L[OFF + base] * (32 - shift)
                                      + L[OFF + base + 1] * shift + 16) >> 5;
                }
            }
        }
    } else {  /* zone 2: 90 < pAngle < 180 */
        int dx = dr[180 - p_angle];
        int dy = dr[p_angle - 90];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int idx = (j << 6) - (i + 1) * dx;
                int base = idx >> (6 - up_above);
                if (base >= -(1 << up_above)) {
                    int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                    out[i * w + j] = (A[OFF + base] * (32 - shift)
                                      + A[OFF + base + 1] * shift + 16) >> 5;
                } else {
                    int idy = (i << 6) - (j + 1) * dy;
                    int base_y = idy >> (6 - up_left);
                    int shift = ((idy * (1 << up_left)) >> 1) & 0x1F;
                    out[i * w + j] = (L[OFF + base_y] * (32 - shift)
                                      + L[OFF + base_y + 1] * shift
                                      + 16) >> 5;
                }
            }
    }
}

static const int8_t SM_OFFS[65] = {
    [4] = 0, [8] = 4, [16] = 12, [32] = 28, [64] = 60};

static void smooth_pred(int mode, const int32_t *A, const int32_t *L,
                        int w, int h, int64_t *out) {
    const uint8_t *wy = av1_sm_weights + SM_OFFS[h];
    const uint8_t *wx = av1_sm_weights + SM_OFFS[w];
    int64_t below = L[h - 1], right = A[w - 1];
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            if (mode == SMOOTH_PRED) {
                int64_t num = (int64_t)wy[i] * A[j]
                              + (256 - wy[i]) * below
                              + (int64_t)wx[j] * L[i]
                              + (256 - wx[j]) * right;
                out[i * w + j] = (num + 256) >> 9;
            } else if (mode == SMOOTH_V_PRED) {
                int64_t num = (int64_t)wy[i] * A[j] + (256 - wy[i]) * below;
                out[i * w + j] = (num + 128) >> 8;
            } else {
                int64_t num = (int64_t)wx[j] * L[i] + (256 - wx[j]) * right;
                out[i * w + j] = (num + 128) >> 8;
            }
        }
}

/* recursive filter intra (spec 7.11.2.3; recon_ref._filter_intra_pred) */
static void predict_filter_intra(Recon *rc, int plane, int x, int y,
                                 int w, int h, int fi_mode,
                                 int64_t *out) {
    const ReconParams *rp = rc->rp;
    pel *buf = rc->planes[plane];
    int pw = rc->pw[plane];
    int bd = rp->bitdepth;
    int base = 1 << (bd - 1);
    int have_above = y > tile_top_px(rc, plane);
    int have_left = x > tile_left_px(rc, plane);
    int max_x = pw - 1;
    int64_t W[65 * 65];
    int ws = w + 1;
    if (have_above) {
        for (int i = 0; i < w; i++)
            W[1 + i] = buf[(y - 1) * pw + rmin(x + i, max_x)];
    } else {
        int64_t f = have_left ? buf[y * pw + x - 1] : base - 1;
        for (int i = 0; i < w; i++) W[1 + i] = f;
    }
    if (have_left) {
        for (int i = 0; i < h; i++)
            W[(1 + i) * ws] = buf[(y + i) * pw + x - 1];
    } else {
        int64_t f = have_above ? W[1] : base + 1;
        for (int i = 0; i < h; i++) W[(1 + i) * ws] = f;
    }
    if (have_above && have_left) W[0] = buf[(y - 1) * pw + x - 1];
    else if (have_above) W[0] = W[1];
    else if (have_left) W[0] = W[ws];
    else W[0] = base;
    int64_t mx = (1 << bd) - 1;
    for (int y0 = 0; y0 < h; y0 += 2)
        for (int x0 = 0; x0 < w; x0 += 4) {
            int64_t p[8];
            p[0] = W[y0 * ws + x0];
            p[1] = W[y0 * ws + x0 + 1];
            p[2] = W[y0 * ws + x0 + 2];
            p[3] = W[y0 * ws + x0 + 3];
            p[4] = W[y0 * ws + x0 + 4];
            p[5] = W[(y0 + 1) * ws + x0];
            p[6] = W[(y0 + 2) * ws + x0];
            p[7] = 0;
            for (int k = 0; k < 8; k++) {
                int64_t v = 0;
                for (int i = 0; i < 8; i++)
                    v += (int64_t)av1_filter_intra_taps[fi_mode][k][i]
                         * p[i];
                v = (v + 8) >> 4;   /* dav1d: plain arithmetic shift */
                v = lmax(0, lmin(mx, v));
                W[(y0 + 1 + (k >> 2)) * ws + x0 + 1 + (k & 3)] = v;
            }
        }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            out[i * w + j] = W[(1 + i) * ws + 1 + j];
}

static void predict_intra(Recon *rc, int br, int bc, int plane, int x,
                          int y, int w, int h, int mode, int angle_delta,
                          int64_t *out) {
    const ReconParams *rp = rc->rp;
    pel *buf = rc->planes[plane];
    int pw = rc->pw[plane], ph = rc->ph[plane];
    int bd = rp->bitdepth;
    int base = 1 << (bd - 1);
    int have_above = y > tile_top_px(rc, plane);
    int have_left = x > tile_left_px(rc, plane);
    int max_x = pw - 1, max_y = ph - 1;

    int is_dir = mode >= V_PRED && mode <= D67_PRED;
    int p_angle = 0;
    if (is_dir) {
        static const int16_t BASE_ANGLES[8] = {90, 180, 45, 135, 113, 157,
                                               203, 67};
        p_angle = BASE_ANGLES[mode - V_PRED] + angle_delta * 3;
    }

    int need_edge = 2 * rmax(w, h) + 1;
    int32_t above[OFF + 2 * 258 + 2], left[OFF + 2 * 258 + 2];
    int esz = OFF + 2 * need_edge + 2;
    memset(above, 0, sizeof(int32_t) * (size_t)esz);
    memset(left, 0, sizeof(int32_t) * (size_t)esz);

    int x4 = x >> 2, y4 = y >> 2;
    int have_tr = avail_cell(rc, plane, y4 - 1, x4 + (w >> 2));
    int have_bl = avail_cell(rc, plane, y4 + (h >> 2), x4 - 1);

    if (have_above) {
        int n_main = w, n_ext = have_tr ? w : 0;
        for (int i = 0; i < n_main + n_ext; i++)
            above[OFF + i] = buf[(y - 1) * pw + rmin(x + i, max_x)];
        for (int i = n_main + n_ext; i < need_edge; i++)
            above[OFF + i] = above[OFF + n_main + n_ext - 1];
    } else {
        int fill = have_left ? buf[y * pw + (x - 1)] : base - 1;
        for (int i = OFF; i < esz; i++) above[i] = fill;
    }
    if (have_left) {
        int n_main = h, n_ext = have_bl ? h : 0;
        for (int i = 0; i < n_main + n_ext; i++)
            left[OFF + i] = buf[rmin(y + i, max_y) * pw + (x - 1)];
        for (int i = n_main + n_ext; i < need_edge; i++)
            left[OFF + i] = left[OFF + n_main + n_ext - 1];
    } else {
        int fill = have_above ? buf[(y - 1) * pw + x] : base + 1;
        for (int i = OFF; i < esz; i++) left[i] = fill;
    }
    int corner;
    if (have_above && have_left) corner = buf[(y - 1) * pw + (x - 1)];
    else if (have_above) corner = buf[(y - 1) * pw + x];
    else if (have_left) corner = buf[y * pw + (x - 1)];
    else corner = base;
    above[OFF - 1] = corner;
    left[OFF - 1] = corner;

    int up_above = 0, up_left = 0;
    if (is_dir && p_angle != 90 && p_angle != 180
        && rp->enable_intra_edge_filter) {
        int ft = filter_type(rc, br, bc, plane);
        if (90 < p_angle && p_angle < 180 && (w + h) >= 24
            && have_above && have_left) {
            int s = (left[OFF] * 5 + above[OFF - 1] * 6
                     + above[OFF] * 5 + 8) >> 4;
            above[OFF - 1] = s;
            left[OFF - 1] = s;
        }
        if (have_above) {
            int strength = filter_strength(w + h, p_angle - 90, ft);
            int num_px = rmin(w, pw - x) + (p_angle < 90 ? h : 0) + 1;
            edge_filter(above, OFF - 1, num_px, strength);
        }
        if (have_left) {
            int strength = filter_strength(w + h, p_angle - 180, ft);
            int num_px = rmin(h, ph - y) + (p_angle > 180 ? w : 0) + 1;
            edge_filter(left, OFF - 1, num_px, strength);
        }
        up_above = use_upsample(w, h, p_angle - 90, ft);
        if (up_above)
            upsample_edge(above, OFF, w + (p_angle < 90 ? h : 0), bd);
        up_left = use_upsample(w, h, p_angle - 180, ft);
        if (up_left)
            upsample_edge(left, OFF, h + (p_angle > 180 ? w : 0), bd);
    }

    const int32_t *A = above + OFF;
    const int32_t *L = left + OFF;

    if (mode == DC_PRED) {
        int64_t avg;
        if (have_above && have_left) {
            int64_t s = 0;
            for (int j = 0; j < w; j++) s += A[j];
            for (int i = 0; i < h; i++) s += L[i];
            avg = (s + ((w + h) >> 1)) / (w + h);
        } else if (have_above) {
            int64_t s = 0;
            for (int j = 0; j < w; j++) s += A[j];
            avg = (s + (w >> 1)) / w;
        } else if (have_left) {
            int64_t s = 0;
            for (int i = 0; i < h; i++) s += L[i];
            avg = (s + (h >> 1)) / h;
        } else avg = base;
        for (int i = 0; i < w * h; i++) out[i] = avg;
    } else if (is_dir && p_angle == 90) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) out[i * w + j] = A[j];
    } else if (is_dir && p_angle == 180) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) out[i * w + j] = L[i];
    } else if (mode == PAETH_PRED) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int64_t b = A[j], l = L[i];
                int64_t p = b + l - corner;
                int64_t pb = p > b ? p - b : b - p;
                int64_t pl = p > l ? p - l : l - p;
                int64_t pc = p > corner ? p - corner : corner - p;
                out[i * w + j] = (pl <= pb && pl <= pc) ? l
                                 : (pb <= pc ? b : corner);
            }
    } else if (mode >= SMOOTH_PRED && mode <= SMOOTH_H_PRED) {
        smooth_pred(mode, A, L, w, h, out);
    } else {
        directional(av1_dr_intra, p_angle, above, left, w, h,
                    up_above, up_left, out);
    }
}

/* ------------------------------------------------------------------ */
/* inter reconstruction (MC/compound/OBMC/warp), same TU               */

#include "av1_mc.h"

/* ------------------------------------------------------------------ */
/* block reconstruction driver (recon_ref._recon_block/_recon_tx)      */

static void cfl_ac_block(Recon *rc, int cx, int cy, int cw, int chh,
                         int64_t *ac /* chh*cw */) {
    const ReconParams *rp = rc->rp;
    const pel *luma = rc->planes[0];
    int pw = rc->pw[0];
    int ly = cy << rp->ssy, lx = cx << rp->ssx;
    int64_t total = 0;
    for (int i = 0; i < chh; i++)
        for (int j = 0; j < cw; j++) {
            int64_t v;
            int yy = ly + (i << rp->ssy), xx = lx + (j << rp->ssx);
            if (rp->ssx && rp->ssy)
                v = ((int64_t)luma[yy * pw + xx]
                     + luma[yy * pw + xx + 1]
                     + luma[(yy + 1) * pw + xx]
                     + luma[(yy + 1) * pw + xx + 1]) << 1;
            else if (rp->ssx)
                v = ((int64_t)luma[yy * pw + xx]
                     + luma[yy * pw + xx + 1]) << 2;
            else
                v = (int64_t)luma[yy * pw + xx] << 3;
            ac[i * cw + j] = v;
            total += v;
        }
    int log2sz = 0;
    for (int v = cw; v > 1; v >>= 1) log2sz++;
    for (int v = chh; v > 1; v >>= 1) log2sz++;
    int64_t avg = (total + ((int64_t)1 << (log2sz - 1))) >> log2sz;
    for (int i = 0; i < chh * cw; i++) ac[i] -= avg;
}

static void recon_tx(Recon *rc, int br, int bc, int plane, int x, int y,
                     int tx, int mode, int angle_delta,
                     const int32_t *coef_or_null, int tx_type,
                     const int64_t *cfl_ac, int cfl_stride, int cfl_h,
                     int cfl_alpha, const int32_t *pal_u, int lossless,
                     int nzpack) {
    const ReconParams *rp = rc->rp;
    int fw = av1_tx_w[tx], fh = av1_tx_h[tx];
    pel *buf = rc->planes[plane];
    int pw = rc->pw[plane], ph = rc->ph[plane];
    int w = rmin(fw, pw - x), h = rmin(fh, ph - y);
    int64_t mxpix = (1 << rp->bitdepth) - 1;

    int64_t pred[64 * 64];
    int have_pal = 0;
    if (pal_u != NULL) {
        int npal = plane == 0 ? pal_u[0] : pal_u[1];
        if (npal) {
            /* palette prediction (recon_ref._palette_pred): the color
               map is block-relative at plane resolution */
            const int32_t *colors =
                pal_u + (plane == 0 ? 8 : plane == 1 ? 16 : 24);
            const int8_t *map =
                rc->o->pal_maps + pal_u[plane == 0 ? 2 : 3];
            int mw = pal_u[plane == 0 ? 4 : 6];
            int mh = pal_u[plane == 0 ? 5 : 7];
            int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
            int bx = (bc >> ssx) * 4, by = (br >> ssy) * 4;
            for (int i = 0; i < fh; i++) {
                int ry = y - by + i;
                ry = ry < 0 ? 0 : (ry > mh - 1 ? mh - 1 : ry);
                for (int j = 0; j < fw; j++) {
                    int rx = x - bx + j;
                    rx = rx < 0 ? 0 : (rx > mw - 1 ? mw - 1 : rx);
                    pred[i * fw + j] = colors[map[ry * mw + rx]];
                }
            }
            have_pal = 1;
        }
    }
    if (have_pal) {
        /* palette blocks skip intra prediction */
    } else if (plane == 0 && rc->cur_fi >= 0)
        predict_filter_intra(rc, plane, x, y, fw, fh, rc->cur_fi, pred);
    else
        predict_intra(rc, br, bc, plane, x, y, fw, fh, mode, angle_delta,
                      pred);

    if (cfl_ac != NULL && cfl_alpha != 0) {
        for (int i = 0; i < fh && i < cfl_h; i++)
            for (int j = 0; j < fw && j < cfl_stride; j++) {
                int64_t diff = (int64_t)cfl_alpha * cfl_ac[i * cfl_stride + j];
                int64_t mag = diff < 0 ? -diff : diff;
                int64_t scaled = (mag + 32) >> 6;
                if (diff < 0) scaled = -scaled;
                int64_t v = pred[i * fw + j] + scaled;
                pred[i * fw + j] = lmax(0, lmin(mxpix, v));
            }
    }
    if (coef_or_null != NULL) {
        int32_t res[64 * 64];
        uint64_t tx0 = rc_tick();
        if (lossless) itx_wht4(coef_or_null, res);
        else itx_2d(coef_or_null, tx, tx_type, rp->bitdepth, res,
                    nzpack);
        rc_tick_add(7, tx0);
        for (int i = 0; i < fh; i++)
            for (int j = 0; j < fw; j++)
                pred[i * fw + j] += res[i * fw + j];
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            buf[(y + i) * pw + (x + j)] =
                (int32_t)lmax(0, lmin(mxpix, pred[i * fw + j]));
    /* BlockDecoded bitmap over the written cells */
    for (int rr = y >> 2; rr < (y + h + 3) >> 2 && rr < rc->dh[plane]; rr++)
        for (int cc = x >> 2; cc < (x + w + 3) >> 2 && cc < rc->dw[plane];
             cc++)
            rc->decoded[plane][rr * rc->dw[plane] + cc] = 1;
}

/* find the coded tx record for (plane,x,y) within a block, or -1 */
static int64_t find_tx(const TileOut *o, int64_t tx_off, int n_tx,
                       int plane, int x, int y) {
    for (int64_t k = tx_off; k < tx_off + n_tx; k++) {
        const int32_t *rec = o->txs + k * 8;
        if (rec[0] == plane && rec[1] == x && rec[2] == y) return k;
    }
    return -1;
}

static void recon_block(Recon *rc, const int32_t *b) {
    const ReconParams *rp = rc->rp;
    const TileOut *o = rc->o;
    recon_set_tile(rc, b[BLK_R], b[BLK_C]);
    if (b[BLK_IS_INTER]) {
        uint64_t tb0 = rc_tick();
        /* intra block copy and the intra half of interintra read the
           current planes: materialize any deferred copies first */
        if (b[BLK_REF0] == MC_INTRA_FRAME || b[BLK_II_MODE] >= 0)
            copyplan_flush(rc);
        if (recon_block_inter(rc, b)) rc->error = 1;
        rc_tick_add(4, tb0);
        return;
    }
    /* intra prediction reads reconstructed neighbours */
    copyplan_flush(rc);
    uint64_t ti0 = rc_tick();
    int br = b[0], bc = b[1], bsize = b[2];
    rc->cur_fi = b[13];
    int y_mode = b[3], uv_mode = b[4];
    int angle_y = b[5], angle_uv = b[6];
    int tx_size = b[8], uv_tx = b[9], has_chroma = b[10];
    int cfl_u = b[11], cfl_v = b[12];
    int64_t tx_off = b[14];
    int n_tx = b[15];
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int mi_cols = rp->mi_cols, mi_rows = rp->mi_rows;
    const int32_t *pal_u = b[BLK_PAL]
        ? o->pal_units + (int64_t)(b[BLK_PAL] - 1) * 32 : NULL;

    int sw = av1_tx_w4[tx_size], sh = av1_tx_h4[tx_size];
    int lim_h = rmin(h4, mi_rows - br), lim_w = rmin(w4, mi_cols - bc);
    /* O(1) tx-record lookup: index records by (plane, 4x4-rel pos)
     * instead of a linear scan per tx (quadratic on 128px blocks) */
    int base4[3];
    base4[0] = bc;
    base4[1] = base4[2] = (bc >> rp->ssx);
    int basey4[3];
    basey4[0] = br;
    basey4[1] = basey4[2] = (br >> rp->ssy);
    rc->txgen++;
    int32_t gen = rc->txgen;
    for (int64_t k = tx_off; k < tx_off + n_tx; k++) {
        const int32_t *rec = o->txs + k * 8;
        int pl = rec[0];
        int rx = (rec[1] >> 2) - base4[pl];
        int ry = (rec[2] >> 2) - basey4[pl];
        if (pl < 3 && rx >= 0 && rx < 32 && ry >= 0 && ry < 32) {
            rc->txmap_idx[pl][ry * 32 + rx] = (int32_t)(k - tx_off);
            rc->txmap_gen[pl][ry * 32 + rx] = gen;
        }
    }
#define TXAT(pl, px_, py_) \
    ((((py_) >> 2) - basey4[pl]) * 32 + (((px_) >> 2) - base4[pl]))
#define TXFIND(pl, px_, py_) \
    ((((px_) >> 2) - base4[pl] >= 0 && ((px_) >> 2) - base4[pl] < 32 && \
      ((py_) >> 2) - basey4[pl] >= 0 && \
      ((py_) >> 2) - basey4[pl] < 32 && \
      rc->txmap_gen[pl][TXAT(pl, px_, py_)] == gen) \
         ? tx_off + rc->txmap_idx[pl][TXAT(pl, px_, py_)] \
         : -1)
    for (int yy = 0; yy < lim_h; yy += sh)
        for (int xx = 0; xx < lim_w; xx += sw) {
            int x = (bc + xx) * 4, y = (br + yy) * 4;
            int64_t k = TXFIND(0, x, y);
            recon_tx(rc, br, bc, 0, x, y, tx_size, y_mode, angle_y,
                     k >= 0 ? o->coeffs + o->txs[k * 8 + 6] : NULL,
                     k >= 0 ? o->txs[k * 8 + 4] : 0, NULL, 0, 0, 0,
                     pal_u, k >= 0 ? o->txs[k * 8 + 7] : 0,
                     k >= 0 ? o->txs[k * 8 + 5] : -1);
        }
    if (has_chroma && rp->num_planes > 1) {
        int csw = av1_tx_w4[uv_tx], csh = av1_tx_h4[uv_tx];
        int cb4 = rmax(1, lim_w >> rp->ssx);
        int ch4 = rmax(1, lim_h >> rp->ssy);
        int cx = (bc >> rp->ssx) * 4, cy = (br >> rp->ssy) * 4;
        int mode = uv_mode;
        int64_t ac[32 * 32];
        const int64_t *acp = NULL;
        int acw = cb4 * 4;
        if (uv_mode == UV_CFL) {
            mode = DC_PRED;
            cfl_ac_block(rc, cx, cy, cb4 * 4, ch4 * 4, ac);
            acp = ac;
        }
        for (int yy = 0; yy < ch4; yy += csh)
            for (int xx = 0; xx < cb4; xx += csw)
                for (int plane = 1; plane < rp->num_planes; plane++) {
                    int x = cx + xx * 4, y = cy + yy * 4;
                    int64_t k = TXFIND(plane, x, y);
                    recon_tx(rc, br, bc, plane, x, y, uv_tx, mode,
                             angle_uv,
                             k >= 0 ? o->coeffs + o->txs[k * 8 + 6] : NULL,
                             k >= 0 ? o->txs[k * 8 + 4] : 0,
                             acp, acw, ch4 * 4,
                             acp ? (plane == 1 ? cfl_u : cfl_v) : 0,
                             pal_u, k >= 0 ? o->txs[k * 8 + 7] : 0,
                             k >= 0 ? o->txs[k * 8 + 5] : -1);
                }
    }
#undef TXFIND
#undef TXAT
    rc_tick_add(6, ti0);
}

/* ------------------------------------------------------------------ */
/* loop filter (lf_ref.py, spec §7.14) — declared in av1_lf.h part     */

#include "av1_lf.h"
#include "av1_cdef.h"
/* SGR radii shared with the tile decoder's LR syntax tables */
static const int8_t SGR_R0[16] = {2,2,2,2,2,2,2,2,2,2,0,0,0,0,2,2};
static const int8_t SGR_R1[16] = {1,1,1,1,1,1,1,1,1,1,1,1,1,1,0,0};
enum { RESTORE_NONE = 0, RESTORE_WIENER = 2, RESTORE_SGRPROJ = 3 };
#include "av1_lrf.h"
#include "av1_fg.h"
#include "av1_sr.h"

/* ------------------------------------------------------------------ */

/* export the loop-filter grids for one plane (device LF consumes them
   instead of rebuilding from Python block records) */
#if PEL_BITS == 16
int av1_lf_grids_export(const ReconParams *rp, const TileOut *o, int plane,
                        int pw, int ph, uint8_t *txw, uint8_t *txh,
                        uint8_t *skip, uint8_t *edge_left,
                        uint8_t *edge_top, uint8_t *lvl0,
                        uint8_t *lvl1) {
    LfGrids g;
    if (lf_build_grids(rp, o, plane, pw, ph, &g)) return 2;
    size_t n = (size_t)g.gw * g.gh;
    memcpy(txw, g.txw, n);
    memcpy(txh, g.txh, n);
    memcpy(skip, g.skip, n);
    memcpy(edge_left, g.edge_left, n);
    memcpy(edge_top, g.edge_top, n);
    memcpy(lvl0, g.lvl0, n);
    memcpy(lvl1, g.lvl1, n);
    free(g.txw);
    return 0;
}

/* ------------------------------------------------------------------ */
/* Device-pipeline bridge: emit one record per intra pred unit (every
 * visited tx block, decode order), with all irregular scalar decisions
 * resolved host-side (availability, edge filter strengths, upsample
 * flags, resolved angle, CfL geometry).  The device executor (numpy
 * reference recon/exec_ref.py, device executor recon/jax_exec.py)
 * replays these records without re-deriving any block semantics.
 * Field layout must match exec_ref.UF/U_* constants. */

#define UF 24

static void export_tx(Recon *rc, int br, int bc, int plane, int x, int y,
                      int tx, int mode, int angle_delta, int is_cfl,
                      int cfl_alpha, int ac_x, int ac_y, int ac_w,
                      int ac_h, int fi, int32_t *u) {
    const ReconParams *rp = rc->rp;
    int fw = av1_tx_w[tx], fh = av1_tx_h[tx];
    int pw = rc->pw[plane], ph = rc->ph[plane];
    int w = rmin(fw, pw - x), h = rmin(fh, ph - y);
    int have_above = y > tile_top_px(rc, plane);
    int have_left = x > tile_left_px(rc, plane);
    int x4 = x >> 2, y4 = y >> 2;
    int have_tr = avail_cell(rc, plane, y4 - 1, x4 + (fw >> 2));
    int have_bl = avail_cell(rc, plane, y4 + (fh >> 2), x4 - 1);

    int is_dir = mode >= V_PRED && mode <= D67_PRED;
    int p_angle = 0;
    if (is_dir) {
        static const int16_t BA[8] = {90, 180, 45, 135, 113, 157, 203, 67};
        p_angle = BA[mode - V_PRED] + angle_delta * 3;
    }
    int cls;
    if (fi >= 0 && plane == 0) {
        cls = 9;            /* filter-intra: u[6] carries the mode */
        p_angle = fi;
    }
    else if (is_cfl) cls = 8;
    else if (mode == DC_PRED) cls = 0;
    else if (is_dir && p_angle == 90) cls = 1;
    else if (is_dir && p_angle == 180) cls = 2;
    else if (is_dir) cls = 3;
    else if (mode == SMOOTH_PRED) cls = 4;
    else if (mode == SMOOTH_V_PRED) cls = 5;
    else if (mode == SMOOTH_H_PRED) cls = 6;
    else cls = 7;                                /* PAETH */

    int sa = 0, sl = 0, ua = 0, ul = 0, cf = 0;
    if (is_dir && p_angle != 90 && p_angle != 180
        && rp->enable_intra_edge_filter) {
        int ft = filter_type(rc, br, bc, plane);
        if (90 < p_angle && p_angle < 180 && (fw + fh) >= 24
            && have_above && have_left)
            cf = 1;
        if (have_above) sa = filter_strength(fw + fh, p_angle - 90, ft);
        if (have_left) sl = filter_strength(fw + fh, p_angle - 180, ft);
        ua = use_upsample(fw, fh, p_angle - 90, ft);
        ul = use_upsample(fw, fh, p_angle - 180, ft);
    }

    u[0] = plane; u[1] = x; u[2] = y; u[3] = fw; u[4] = fh;
    u[5] = cls; u[6] = p_angle;
    u[7] = have_above; u[8] = have_left; u[9] = have_tr; u[10] = have_bl;
    u[11] = sa; u[12] = sl; u[13] = ua; u[14] = ul; u[15] = cf;
    u[16] = cfl_alpha; u[17] = ac_x; u[18] = ac_y; u[19] = ac_w;
    u[20] = ac_h; u[21] = tx; u[22] = mode; u[23] = 0;

    for (int rr = y >> 2; rr < (y + h + 3) >> 2 && rr < rc->dh[plane]; rr++)
        for (int cc = x >> 2; cc < (x + w + 3) >> 2 && cc < rc->dw[plane];
             cc++)
            rc->decoded[plane][rr * rc->dw[plane] + cc] = 1;
}

static int export_block(Recon *rc, const int32_t *b, int32_t *units,
                        int64_t max_units, int64_t *n) {
    const ReconParams *rp = rc->rp;
    recon_set_tile(rc, b[0], b[1]);
    int br = b[0], bc = b[1], bsize = b[2];
    int y_mode = b[3], uv_mode = b[4];
    int angle_y = b[5], angle_uv = b[6];
    int tx_size = b[8], uv_tx = b[9], has_chroma = b[10];
    int cfl_u = b[11], cfl_v = b[12], fi = b[13];
    int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
    int mi_cols = rp->mi_cols, mi_rows = rp->mi_rows;
    int sw = av1_tx_w4[tx_size], sh = av1_tx_h4[tx_size];
    int lim_h = rmin(h4, mi_rows - br), lim_w = rmin(w4, mi_cols - bc);
    if (b[16]) {
        /* interintra: the intra half is exported as a per-plane pred
           unit (cls DC/V/H/SMOOTH) carrying the blend spec in u[23];
           the device scan blends it against the staged inter pred
           (av1_mc.h interintra_blend role).  Emitted BEFORE the
           decoded marking so its neighbor availability matches the
           C recon's state at this block. */
        if (b[BLK_II_MODE] >= 0) {
            static const int8_t II2M[4] = {DC_PRED, V_PRED, H_PRED,
                                           SMOOTH_PRED};
            int n_pl = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
            for (int plane = 0; plane < n_pl; plane++) {
                int ssx = plane ? rp->ssx : 0;
                int ssy = plane ? rp->ssy : 0;
                int fw = rmax(1, w4 >> ssx) * 4;
                int fh = rmax(1, h4 >> ssy) * 4;
                int tx = -1;
                for (int t = 0; t < 19 && tx < 0; t++)
                    if (av1_tx_w[t] == fw && av1_tx_h[t] == fh) tx = t;
                if (tx < 0) continue;           /* no matching dims */
                if (*n >= max_units) return 1;
                int32_t *u = units + (*n)++ * UF;
                export_tx(rc, br, bc, plane, (bc >> ssx) * 4,
                          (br >> ssy) * 4, tx, II2M[b[BLK_II_MODE]], 0,
                          0, 0, 0, 0, 0, 0, -1, u);
                u[23] = (bsize << 16) | (b[BLK_II_WEDGE] << 12)
                        | (b[BLK_II_WEDGE_IDX] << 4)
                        | (b[BLK_II_MODE] + 1);
            }
        }
        if (b[BLK_INTRABC]) {
            /* intra block copy: emit cls-11 units (the jax scan
               executor predicts them as a dynamic slice of the
               partially reconstructed plane, two-stage bilinear taps
               resolved here — av1_mc.h predict_inter_i32 parity).
               32x32 sub-rects keep units within both scan tiles. */
            int n_pl = (b[BLK_HASCHROMA] && rp->num_planes > 1) ? 3 : 1;
            for (int plane = 0; plane < n_pl; plane++) {
                int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
                int x = (bc >> ssx) * 4, y = (br >> ssy) * 4;
                int full_w = rmax(1, w4 >> ssx) * 4;
                int full_h = rmax(1, h4 >> ssy) * 4;
                int pw = rc->pw[plane], ph = rc->ph[plane];
                int w = rmin(full_w, pw - x), h = rmin(full_h, ph - y);
                int sx0 = (x << 4) + b[BLK_MV_C] * (ssx ? 1 : 2);
                int sy0 = (y << 4) + b[BLK_MV_R] * (ssy ? 1 : 2);
                int fx = sx0 & 15, fy = sy0 & 15;
                const int16_t *fh =
                    mc_filter(b[BLK_INTERP1], full_w) + fx * 8;
                const int16_t *fv =
                    mc_filter(b[BLK_INTERP0], full_h) + fy * 8;
                /* the kernel reads only tap slots 3/4 (bilinear
                   phases of a whole-pel DV: frac is 0 or 8) */
                if (fh[0] | fh[1] | fh[2] | fh[5] | fh[6] | fh[7]
                    | fv[0] | fv[1] | fv[2] | fv[5] | fv[6] | fv[7])
                    return 2;
                int ix = sx0 >> 4, iy = sy0 >> 4;
                /* the kernel replaces the scalar path's per-element
                   edge clamp with zero padding: decline when a live
                   tap could read past the mi-aligned plane */
                if ((fh[4] && ix + w > pw - 1)
                    || (fv[4] && iy + h > ph - 1)
                    || ix < 0 || iy < 0)
                    return 2;
                for (int yy = 0; yy < h; yy += 32)
                    for (int xx = 0; xx < w; xx += 32) {
                        if (*n >= max_units) return 1;
                        int32_t *u = units + (*n)++ * UF;
                        memset(u, 0, sizeof(int32_t) * UF);
                        u[0] = plane;
                        u[1] = x + xx; u[2] = y + yy;
                        u[3] = rmin(32, w - xx);
                        u[4] = rmin(32, h - yy);
                        u[5] = 11;
                        u[6] = ix + xx;       /* src col of sub-rect */
                        u[11] = fh[3]; u[12] = fh[4];
                        u[13] = fv[3]; u[14] = fv[4];
                        u[15] = iy + yy;      /* src row of sub-rect */
                    }
                for (int rr = y >> 2;
                     rr < (y + h + 3) >> 2 && rr < rc->dh[plane]; rr++)
                    for (int cc = x >> 2;
                         cc < (x + w + 3) >> 2 && cc < rc->dw[plane];
                         cc++)
                        rc->decoded[plane][rr * rc->dw[plane] + cc] = 1;
            }
            return 0;
        }
        /* inter block (device MC path recons it): emit no intra units,
           but mark its extent decoded — later intra blocks' above/left/
           tr/bl availability counts inter neighbors as available */
        for (int plane = 0; plane < rp->num_planes; plane++) {
            int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
            int x4 = (bc >> ssx), y4 = (br >> ssy);
            int we = rmax(1, lim_w >> ssx), he = rmax(1, lim_h >> ssy);
            for (int rr = y4; rr < y4 + he && rr < rc->dh[plane]; rr++)
                for (int cc = x4; cc < x4 + we && cc < rc->dw[plane];
                     cc++)
                    rc->decoded[plane][rr * rc->dw[plane] + cc] = 1;
        }
        return 0;
    }
    /* palette planes export as cls-10 "literal" units: the device
       predictor contributes zero and the palette prediction is folded
       into the residual plane by av1_export_literal_preds (clip(0 +
       (pal + resid)) == clip(pal + resid) since the stored pal+resid
       stays far inside int16) */
    const int32_t *pal_u = b[BLK_PAL]
        ? rc->o->pal_units + (int64_t)(b[BLK_PAL] - 1) * 32 : NULL;
    int pal_y = pal_u != NULL && pal_u[0] != 0;
    int pal_uv = pal_u != NULL && pal_u[1] != 0;
    for (int yy = 0; yy < lim_h; yy += sh)
        for (int xx = 0; xx < lim_w; xx += sw) {
            if (*n >= max_units) return 1;
            int32_t *u = units + (*n)++ * UF;
            export_tx(rc, br, bc, 0, (bc + xx) * 4, (br + yy) * 4,
                      tx_size, y_mode, angle_y, 0, 0, 0, 0, 0, 0,
                      pal_y ? -1 : fi, u);
            if (pal_y) u[5] = 10;
        }
    if (has_chroma && rp->num_planes > 1) {
        int csw = av1_tx_w4[uv_tx], csh = av1_tx_h4[uv_tx];
        int cb4 = rmax(1, lim_w >> rp->ssx);
        int ch4 = rmax(1, lim_h >> rp->ssy);
        int cx = (bc >> rp->ssx) * 4, cy = (br >> rp->ssy) * 4;
        int mode = uv_mode, is_cfl = uv_mode == UV_CFL;
        if (is_cfl) mode = DC_PRED;
        for (int yy = 0; yy < ch4; yy += csh)
            for (int xx = 0; xx < cb4; xx += csw)
                for (int plane = 1; plane < rp->num_planes; plane++) {
                    if (*n >= max_units) return 1;
                    int32_t *u = units + (*n)++ * UF;
                    export_tx(rc, br, bc, plane, cx + xx * 4, cy + yy * 4,
                              uv_tx, mode, angle_uv,
                              pal_uv ? 0 : is_cfl,
                              (is_cfl && !pal_uv)
                                  ? (plane == 1 ? cfl_u : cfl_v) : 0,
                              cx, cy, cb4 * 4, ch4 * 4, -1, u);
                    if (pal_uv) u[5] = 10;
                }
    }
    return 0;
}

/* Palette-prediction patches for the device pipe: one record
 * {plane, x, y, w, h, pix_off} per palette-plane tx (same tiling as
 * export_block / the C recon), pixels row-major int32.  The python
 * bridge adds them into the composed residual planes so cls-10 units
 * reconstruct as clip(palette + residual). */
int av1_export_literal_preds(const ReconParams *rp, const TileOut *o,
                             int32_t *recs, int64_t max_recs,
                             int64_t *n_recs, int32_t *pix,
                             int64_t max_pix, int64_t *pix_used) {
    int aw = rp->mi_cols * 4, ah = rp->mi_rows * 4;
    int pw[3], ph[3];
    pw[0] = aw; ph[0] = ah;
    pw[1] = pw[2] = aw >> rp->ssx;
    ph[1] = ph[2] = ah >> rp->ssy;
    int64_t n = 0, used = 0;
    for (int64_t i = 0; i < o->n_blocks; i++) {
        const int32_t *b = o->blocks + i * BLK_FIELDS;
        if (!b[BLK_PAL]) continue;
        const int32_t *pal_u =
            o->pal_units + (int64_t)(b[BLK_PAL] - 1) * 32;
        int br = b[0], bc = b[1], bsize = b[2];
        int w4 = av1_block_w4[bsize], h4 = av1_block_h4[bsize];
        int lim_h = rmin(h4, rp->mi_rows - br);
        int lim_w = rmin(w4, rp->mi_cols - bc);
        for (int plane = 0; plane < rp->num_planes; plane++) {
            int npal = plane == 0 ? pal_u[0] : pal_u[1];
            if (!npal) continue;
            if (plane && !b[BLK_HASCHROMA]) continue;
            int ssx = plane ? rp->ssx : 0, ssy = plane ? rp->ssy : 0;
            const int32_t *colors =
                pal_u + (plane == 0 ? 8 : plane == 1 ? 16 : 24);
            const int8_t *map =
                o->pal_maps + pal_u[plane == 0 ? 2 : 3];
            int mw = pal_u[plane == 0 ? 4 : 6];
            int mh = pal_u[plane == 0 ? 5 : 7];
            int bx = (bc >> ssx) * 4, by = (br >> ssy) * 4;
            int tx = plane == 0 ? b[BLK_TXSZ] : b[BLK_UVTX];
            int sw4 = av1_tx_w4[tx], sh4 = av1_tx_h4[tx];
            int t4w = plane ? rmax(1, lim_w >> ssx) : lim_w;
            int t4h = plane ? rmax(1, lim_h >> ssy) : lim_h;
            for (int yy = 0; yy < t4h; yy += sh4)
                for (int xx = 0; xx < t4w; xx += sw4) {
                    int x = bx + xx * 4, y = by + yy * 4;
                    int fw = av1_tx_w[tx], fh = av1_tx_h[tx];
                    int w = rmin(fw, pw[plane] - x);
                    int h = rmin(fh, ph[plane] - y);
                    if (w <= 0 || h <= 0) continue;
                    if (n >= max_recs
                        || used + (int64_t)w * h > max_pix)
                        return 1;
                    int32_t *r = recs + n++ * 6;
                    r[0] = plane; r[1] = x; r[2] = y;
                    r[3] = w; r[4] = h; r[5] = (int32_t)used;
                    for (int ii = 0; ii < h; ii++) {
                        int ry = y - by + ii;
                        ry = ry < 0 ? 0 : (ry > mh - 1 ? mh - 1 : ry);
                        for (int jj = 0; jj < w; jj++) {
                            int rx = x - bx + jj;
                            rx = rx < 0 ? 0
                                 : (rx > mw - 1 ? mw - 1 : rx);
                            pix[used++] = colors[map[ry * mw + rx]];
                        }
                    }
                }
        }
    }
    *n_recs = n;
    *pix_used = used;
    return 0;
}

int av1_export_pred_units(const ReconParams *rp, const TileOut *o,
                          int32_t *units, int64_t max_units,
                          int64_t *n_out) {
    Recon rc;
    memset(&rc, 0, sizeof(rc));
    rc.rp = rp;
    rc.o = o;
    int aw = rp->mi_cols * 4, ah = rp->mi_rows * 4;
    rc.pw[0] = aw; rc.ph[0] = ah;
    rc.pw[1] = rc.pw[2] = aw >> rp->ssx;
    rc.ph[1] = rc.ph[2] = ah >> rp->ssy;
    for (int p = 0; p < 3; p++) {
        rc.dw[p] = rc.pw[p] >> 2;
        rc.dh[p] = rc.ph[p] >> 2;
        rc.decoded[p] = calloc((size_t)rc.dw[p] * rc.dh[p], 1);
        if (!rc.decoded[p]) {
            for (int q = 0; q < p; q++) free(rc.decoded[q]);
            return 2;
        }
    }
    int64_t n = 0;
    int err = 0;
    for (int64_t i = 0; i < o->n_blocks && !err; i++)
        err = export_block(&rc, o->blocks + i * BLK_FIELDS, units, max_units, &n);
    for (int p = 0; p < 3; p++) free(rc.decoded[p]);
    *n_out = n;
    return err;
}

#endif  /* PEL_BITS == 16: pel-independent exports */

int BDFN(av1_recon_frame)(const ReconParams *rp, const TileOut *o,
                    const FrameParams *fp, const RefPlanes *refs,
                    pel *py, pel *pu, pel *pv) {
    Recon rc;
    memset(&rc, 0, sizeof(rc));
    rc.cur_fi = -1;
    rc.rp = rp;
    rc.o = o;
    rc.fp = fp;
    rc.refs = refs;
    int aw = rp->mi_cols * 4, ah = rp->mi_rows * 4;
    int sr = fp != NULL && fp->use_superres;
    /* caller buffers (upscaled-wide when superres) */
    pel *out_pl[3] = {py, pu, pv};
    int opw[3], oph[3];
    oph[0] = ah;
    oph[1] = oph[2] = ah >> rp->ssy;
    if (sr) {
        opw[0] = fp->frame_width;
        opw[1] = opw[2] = (fp->frame_width + rp->ssx) >> rp->ssx;
        if (opw[0] < aw) opw[0] = aw;
        if (opw[1] < (aw >> rp->ssx)) opw[1] = opw[2] = aw >> rp->ssx;
    } else {
        opw[0] = aw;
        opw[1] = opw[2] = aw >> rp->ssx;
    }
    /* recon/LF/CDEF run at the coded (downscaled) dims: the caller
       buffers directly, or scratch when superres upscaling follows */
    pel *scratch[3] = {NULL, NULL, NULL};
    rc.pw[0] = aw; rc.ph[0] = ah;
    rc.pw[1] = rc.pw[2] = aw >> rp->ssx;
    rc.ph[1] = rc.ph[2] = ah >> rp->ssy;
    for (int p = 0; p < 3; p++) {
        if (sr && p < rp->num_planes) {
            scratch[p] = malloc((size_t)rc.pw[p] * rc.ph[p]
                                * sizeof(pel));
            if (!scratch[p]) {
                for (int q = 0; q < p; q++) free(scratch[q]);
                return 2;
            }
            rc.planes[p] = scratch[p];
        } else {
            rc.planes[p] = out_pl[p];
        }
    }
    for (int p = 0; p < 3; p++) {
        rc.dw[p] = rc.pw[p] >> 2;
        rc.dh[p] = rc.ph[p] >> 2;
        rc.decoded[p] = calloc((size_t)rc.dw[p] * rc.dh[p], 1);
        if (!rc.decoded[p]) {
            for (int q = 0; q < p; q++) free(rc.decoded[q]);
            for (int q = 0; q < 3; q++) free(scratch[q]);
            return 2;
        }
    }
    double t0 = rc_now();
    for (int64_t i = 0; i < o->n_blocks && !rc.error; i++)
        recon_block(&rc, o->blocks + i * BLK_FIELDS);
    copyplan_flush(&rc);
    copyplan_free(&rc);
    for (int p = 0; p < 3; p++) free(rc.decoded[p]);
    if (rc.error) {
        for (int q = 0; q < 3; q++) free(scratch[q]);
        return 3;
    }
    double t1 = rc_now();

    av1_loop_filter(rp, o, rc.planes, rc.pw, rc.ph);
    double t2 = rc_now();
    int use_lr = fp != NULL && fp->lr_uses;
    pel *debl[3] = {NULL, NULL, NULL};
    if (use_lr) {
        /* LR reads the pre-CDEF deblocked rows at stripe boundaries;
           snapshot at the (possibly downscaled) coded dims */
        for (int p = 0; p < rp->num_planes; p++) {
            size_t n = (size_t)rc.pw[p] * rc.ph[p];
            debl[p] = malloc(n * sizeof(pel));
            if (!debl[p]) {
                for (int q = 0; q < p; q++) free(debl[q]);
                for (int q = 0; q < 3; q++) free(scratch[q]);
                return 2;
            }
            memcpy(debl[p], rc.planes[p], n * sizeof(pel));
        }
    }
    av1_cdef(rp, o, rc.planes, rc.pw, rc.ph);
    double t3 = rc_now();
    if (sr) {
        /* spec 7.16: horizontal upscale between CDEF and LR; LR's
           deblocked stripe context upscales identically */
        for (int p = 0; p < rp->num_planes; p++) {
            int sx = p ? rp->ssx : 0;
            int src_w = (fp->downscaled_width + sx) >> sx;
            int dst_w = (fp->frame_width + sx) >> sx;
            sr_upscale_plane(rc.planes[p], rc.pw[p], rc.pw[p],
                             rc.ph[p], src_w, dst_w, rp->bitdepth,
                             out_pl[p], opw[p]);
            if (use_lr) {
                pel *ud = malloc((size_t)opw[p] * oph[p]
                                     * sizeof(pel));
                if (ud == NULL) {
                    for (int q = 0; q < 3; q++) free(scratch[q]);
                    for (int q = 0; q < rp->num_planes; q++)
                        free(debl[q]);
                    return 2;
                }
                sr_upscale_plane(debl[p], rc.pw[p], rc.pw[p], rc.ph[p],
                                 src_w, dst_w, rp->bitdepth, ud,
                                 opw[p]);
                free(debl[p]);
                debl[p] = ud;
            }
            rc.planes[p] = out_pl[p];
            rc.pw[p] = opw[p];
            rc.ph[p] = oph[p];
        }
        for (int q = 0; q < 3; q++) free(scratch[q]);
    }
    if (use_lr) {
        av1_loop_restoration(rp, fp, o, rc.planes, debl, rc.pw, rc.ph);
        for (int p = 0; p < rp->num_planes; p++) free(debl[p]);
    }
    double t4 = rc_now();
    av1_stage_times[0] += t1 - t0;     /* block recon (pred + itx) */
    av1_stage_times[1] += t2 - t1;     /* loop filter */
    av1_stage_times[2] += t3 - t2;     /* cdef */
    av1_stage_times[3] += t4 - t3;     /* cdef->out (superres + lr) */
    return 0;
}

/* ------------------------------------------------------------------ */
/* temporal-mv helpers (mfmv.py save_tmvs / setup_motion_field inner
 * loops; libaom av1_copy_frame_mvs / av1_setup_motion_field) — called
 * from Python with the orchestration (ref selection, order-hint math)
 * staying in mfmv.py */

static const int16_t MF_DIV_MULT[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
    1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744,
    712, 682, 655, 630, 606, 585, 564, 546, 528};

#define MF_LIMIT ((1 << 12) - 1)
#define MF_MAXD 31

#if PEL_BITS == 16
int av1_save_tmvs(int mi_rows, int mi_cols, const int8_t *side /*[9]*/,
                  const int8_t *ref0_grid, const int8_t *ref1_grid,
                  const int16_t *mvs_grid /*(rows,cols,2,2)*/,
                  int8_t *ref8_out, int16_t *mv8_out) {
    int h8 = (mi_rows + 1) >> 1, w8 = (mi_cols + 1) >> 1;
    for (int r = 0; r < h8; r++) {
        int rr = 2 * r + 1 < mi_rows ? 2 * r + 1 : mi_rows - 1;
        int c = 0;
#ifdef __AVX2__
        /* 8 cells at once: the sampled mi columns are 2c+1 stepping 2,
           so a 16-byte load + pshufb picks the 8 ref bytes and four
           32-byte loads + qword permutes pick the 8 mv quads; the
           list-0 / list-1 select is branchless blends.  Bound keeps
           every load inside the current grid row (scalar tail after). */
        if (w8 >= 8) {
            const __m128i pick = _mm_setr_epi8(0, 2, 4, 6, 8, 10, 12, 14,
                                               -1, -1, -1, -1, -1, -1,
                                               -1, -1);
            int8_t tb[16] = {0};
            for (int i = 0; i < 9; i++) tb[i] = side[i];
            const __m128i sidetab = _mm_loadu_si128((const __m128i *)tb);
            const __m256i zero = _mm256_setzero_si256();
            const __m256i nine = _mm256_set1_epi32(9);
            const __m256i none = _mm256_set1_epi32(-1);
            const __m256i mflim = _mm256_set1_epi16(MF_LIMIT);
            const __m256i evenidx =
                _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
            for (; c + 8 <= w8 && 2 * (c + 8) + 1 <= mi_cols; c += 8) {
                int64_t gi0 = (int64_t)rr * mi_cols + 2 * c + 1;
                __m128i g0b = _mm_shuffle_epi8(
                    _mm_loadu_si128((const __m128i *)(ref0_grid + gi0)),
                    pick);
                __m128i g1b = _mm_shuffle_epi8(
                    _mm_loadu_si128((const __m128i *)(ref1_grid + gi0)),
                    pick);
                __m256i g0 = _mm256_cvtepi8_epi32(g0b);
                __m256i g1 = _mm256_cvtepi8_epi32(g1b);
                /* valid ref: 0 < g <= 8 and side[g] == 0 (pshufb with
                   g > 8 indexes low-4-bits garbage, masked by the
                   range compare; negative g yields 0 and is likewise
                   masked by g > 0) */
                __m256i v0 = _mm256_and_si256(
                    _mm256_cmpgt_epi32(g0, zero),
                    _mm256_cmpgt_epi32(nine, g0));
                __m256i v1 = _mm256_and_si256(
                    _mm256_cmpgt_epi32(g1, zero),
                    _mm256_cmpgt_epi32(nine, g1));
                v0 = _mm256_and_si256(
                    v0, _mm256_cmpeq_epi32(
                            _mm256_cvtepi8_epi32(
                                _mm_shuffle_epi8(sidetab, g0b)),
                            zero));
                v1 = _mm256_and_si256(
                    v1, _mm256_cmpeq_epi32(
                            _mm256_cvtepi8_epi32(
                                _mm_shuffle_epi8(sidetab, g1b)),
                            zero));
                /* mv quads of the sampled cells: qwords 0 and 2 of
                   each 32-byte pair */
                const int16_t *mp = mvs_grid + gi0 * 4;
                __m256i p0 = _mm256_permute4x64_epi64(
                    _mm256_loadu_si256((const __m256i *)(mp + 0)), 0x08);
                __m256i p1 = _mm256_permute4x64_epi64(
                    _mm256_loadu_si256((const __m256i *)(mp + 16)), 0x08);
                __m256i p2 = _mm256_permute4x64_epi64(
                    _mm256_loadu_si256((const __m256i *)(mp + 32)), 0x08);
                __m256i p3 = _mm256_permute4x64_epi64(
                    _mm256_loadu_si256((const __m256i *)(mp + 48)), 0x08);
                __m256i q03 = _mm256_inserti128_si256(
                    p0, _mm256_castsi256_si128(p1), 1);
                __m256i q47 = _mm256_inserti128_si256(
                    p2, _mm256_castsi256_si128(p3), 1);
                /* split quads into list-0 / list-1 mv epi32 lanes */
                __m256i a = _mm256_permutevar8x32_epi32(q03, evenidx);
                __m256i b = _mm256_permutevar8x32_epi32(q47, evenidx);
                __m256i mv0 = _mm256_permute2x128_si256(a, b, 0x20);
                __m256i mv1 = _mm256_permute2x128_si256(a, b, 0x31);
                /* |mv| <= MF_LIMIT on both 16-bit components */
                __m256i bad0 = _mm256_cmpgt_epi16(
                    _mm256_abs_epi16(mv0), mflim);
                __m256i bad1 = _mm256_cmpgt_epi16(
                    _mm256_abs_epi16(mv1), mflim);
                __m256i ok0 = _mm256_and_si256(
                    v0, _mm256_cmpeq_epi32(bad0, zero));
                __m256i ok1 = _mm256_and_si256(
                    v1, _mm256_cmpeq_epi32(bad1, zero));
                __m256i refsel = _mm256_blendv_epi8(
                    _mm256_blendv_epi8(none, g0, ok0), g1, ok1);
                __m256i mvsel = _mm256_blendv_epi8(
                    _mm256_blendv_epi8(zero, mv0, ok0), mv1, ok1);
                int64_t o = (int64_t)r * w8 + c;
                _mm256_storeu_si256((__m256i *)(mv8_out + o * 2), mvsel);
                __m256i pk16 = _mm256_packs_epi32(refsel, refsel);
                __m256i pk8 = _mm256_packs_epi16(pk16, pk16);
                int32_t lo = _mm256_extract_epi32(pk8, 0);
                int32_t hi = _mm256_extract_epi32(pk8, 4);
                memcpy(ref8_out + o, &lo, 4);
                memcpy(ref8_out + o + 4, &hi, 4);
            }
        }
#endif
        for (; c < w8; c++) {
            int cc = 2 * c + 1 < mi_cols ? 2 * c + 1 : mi_cols - 1;
            int64_t gi = (int64_t)rr * mi_cols + cc;
            const int16_t *mv = mvs_grid + gi * 4;
            int g0 = ref0_grid[gi], g1 = ref1_grid[gi];
            int ref = -1;       /* NONE_FRAME */
            int16_t m0 = 0, m1 = 0;
            if (g0 > 0 && g0 <= 8 && side[g0] == 0
                && mv[0] <= MF_LIMIT && mv[0] >= -MF_LIMIT
                && mv[1] <= MF_LIMIT && mv[1] >= -MF_LIMIT) {
                ref = g0; m0 = mv[0]; m1 = mv[1];
            }
            if (g1 > 0 && g1 <= 8 && side[g1] == 0
                && mv[2] <= MF_LIMIT && mv[2] >= -MF_LIMIT
                && mv[3] <= MF_LIMIT && mv[3] >= -MF_LIMIT) {
                ref = g1; m0 = mv[2]; m1 = mv[3];
            }
            ref8_out[r * w8 + c] = (int8_t)ref;
            mv8_out[(r * w8 + c) * 2] = m0;
            mv8_out[(r * w8 + c) * 2 + 1] = m1;
        }
    }
    return 0;
}

/* Compose raw residual planes host-side for the device recon pipes:
 * itx of every coded tx written (disjoint rects) into int32 planes at
 * the pipe's pad offsets, uploaded as one plane per frame (the
 * device-side alternative is a batched itx per (size, type) bucket). */
int av1_compose_residual(const int32_t *txs, int64_t n_txs,
                         const int32_t *coeffs, void **planes,
                         const int32_t *strides, const int32_t *hs,
                         int pad_y, int pad_x, int bitdepth,
                         int use_i16) {
    for (int64_t k = 0; k < n_txs; k++) {
        const int32_t *rec = txs + k * 8;
        int plane = rec[0], x = rec[1], y = rec[2];
        int tsz = rec[3], ttyp = rec[4];
        int32_t res[64 * 64];
        if (rec[7]) itx_wht4(coeffs + rec[6], res);
        else itx_2d(coeffs + rec[6], tsz, ttyp, bitdepth, res, rec[5]);
        int fw = av1_tx_w[tsz], fh = av1_tx_h[tsz];
        int st = strides[plane];
        int w = fw, h = fh;
        if (x + pad_x + w > st) w = st - (x + pad_x);
        if (y + pad_y + h > hs[plane]) h = hs[plane] - (y + pad_y);
        if (use_i16) {
            /* residuals fit int16 for bd <= 10 ((±2^(bd+7))>>4):
               halves the H2D upload */
            int16_t *dst = (int16_t *)planes[plane]
                           + (int64_t)(y + pad_y) * st + (x + pad_x);
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++)
                    dst[(int64_t)r * st + c] = (int16_t)res[r * fw + c];
        } else {
            int32_t *dst = (int32_t *)planes[plane]
                           + (int64_t)(y + pad_y) * st + (x + pad_x);
            for (int r = 0; r < h; r++)
                memcpy(dst + (int64_t)r * st, res + r * fw,
                       sizeof(int32_t) * (size_t)w);
        }
    }
    return 0;
}

int av1_project_mvfield(int mi_rows, int mi_cols,
                        const int8_t *ref8, const int16_t *mv8,
                        const int32_t *ref_off /*[9]*/,
                        int start_to_cur, int dir2,
                        int16_t *tpl_mv, int8_t *tpl_off) {
    int h8 = (mi_rows + 1) >> 1, w8 = (mi_cols + 1) >> 1;
    if (start_to_cur > MF_MAXD || start_to_cur < -MF_MAXD)
        ;  /* num clamps below match the numpy path */
    int num = start_to_cur;
    if (num > MF_MAXD) num = MF_MAXD;
    if (num < -MF_MAXD) num = -MF_MAXD;
    int s2c_ok = start_to_cur <= MF_MAXD && start_to_cur >= -MF_MAXD;
    int row_lim = mi_rows >> 1, col_lim = mi_cols >> 1;
#ifdef __AVX2__
    /* 8-lane projection: the per-cell math (scale by num/den in Q14,
       round, clamp, window checks) vectorizes; only the final scatter
       stays scalar, walked in ascending lane order so duplicate
       targets keep the last write exactly like the cell loop */
    if (s2c_ok && w8 >= 8) {
        static int32_t dm32[32];
        if (!dm32[1])
            for (int i = 0; i < 32; i++) dm32[i] = MF_DIV_MULT[i];
        const __m256i zero = _mm256_setzero_si256();
        const __m256i numv = _mm256_set1_epi32(num);
        const __m256i eight = _mm256_set1_epi32(8);
        const __m256i c31 = _mm256_set1_epi32(31);
        const __m256i rnd = _mm256_set1_epi32(8192);
        const __m256i lim = _mm256_set1_epi32((1 << 14) - 1);
        const __m256i nlim = _mm256_set1_epi32(-((1 << 14) - 1));
        const __m256i rowlimv = _mm256_set1_epi32(row_lim);
        const __m256i collimv = _mm256_set1_epi32(col_lim);
        /* ref_off[1..8] as a permute table (lane sr-1) */
        const __m256i offtab =
            _mm256_loadu_si256((const __m256i *)(ref_off + 1));
        const __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
        int32_t rows_s[8], cols_s[8], offs_s[8];
        uint32_t mvp_s[8];
        int w8a = w8 & ~7;
        for (int y = 0; y < h8; y++) {
            int base_y = (y >> 3) << 3;
            const __m256i yv = _mm256_set1_epi32(y);
            const __m256i by0 = _mm256_set1_epi32(base_y);
            const __m256i by1 = _mm256_set1_epi32(base_y + 8);
            int64_t rowbase = (int64_t)y * w8;
            for (int x = 0; x < w8a; x += 8) {
                int64_t i = rowbase + x;
                __m256i sr = _mm256_cvtepi8_epi32(_mm_loadl_epi64(
                    (const __m128i *)(ref8 + i)));
                __m256i srok = _mm256_and_si256(
                    _mm256_cmpgt_epi32(sr, zero),
                    _mm256_cmpgt_epi32(eight,
                                       _mm256_sub_epi32(sr,
                                                        _mm256_set1_epi32(1))));
                if (_mm256_testz_si256(srok, srok)) continue;
                __m256i off = _mm256_permutevar8x32_epi32(
                    offtab, _mm256_sub_epi32(sr, _mm256_set1_epi32(1)));
                __m256i ok = _mm256_and_si256(
                    srok,
                    _mm256_and_si256(
                        _mm256_cmpgt_epi32(off, zero),
                        _mm256_cmpgt_epi32(_mm256_set1_epi32(32), off)));
                if (_mm256_testz_si256(ok, ok)) continue;
                __m256i dm = _mm256_mask_i32gather_epi32(
                    zero, dm32, _mm256_and_si256(off, c31), ok, 4);
                __m256i mvv = _mm256_loadu_si256(
                    (const __m256i *)(mv8 + i * 2));
                __m256i fr = _mm256_srai_epi32(
                    _mm256_slli_epi32(mvv, 16), 16);
                __m256i fc = _mm256_srai_epi32(mvv, 16);
                __m256i tr = _mm256_mullo_epi32(
                    _mm256_mullo_epi32(fr, numv), dm);
                __m256i tc = _mm256_mullo_epi32(
                    _mm256_mullo_epi32(fc, numv), dm);
                __m256i pr = _mm256_sign_epi32(
                    _mm256_srli_epi32(
                        _mm256_add_epi32(_mm256_abs_epi32(tr), rnd), 14),
                    tr);
                __m256i pc = _mm256_sign_epi32(
                    _mm256_srli_epi32(
                        _mm256_add_epi32(_mm256_abs_epi32(tc), rnd), 14),
                    tc);
                pr = _mm256_min_epi32(_mm256_max_epi32(pr, nlim), lim);
                pc = _mm256_min_epi32(_mm256_max_epi32(pc, nlim), lim);
                __m256i roff = _mm256_sign_epi32(
                    _mm256_srli_epi32(_mm256_abs_epi32(pr), 6), pr);
                __m256i coff = _mm256_sign_epi32(
                    _mm256_srli_epi32(_mm256_abs_epi32(pc), 6), pc);
                __m256i xv = _mm256_add_epi32(_mm256_set1_epi32(x), lane);
                __m256i row = dir2 ? _mm256_sub_epi32(yv, roff)
                                   : _mm256_add_epi32(yv, roff);
                __m256i col = dir2 ? _mm256_sub_epi32(xv, coff)
                                   : _mm256_add_epi32(xv, coff);
                /* bounds + the get_block_position window (base_x is
                   constant across the aligned 8-lane chunk) */
                __m256i bx0 = _mm256_set1_epi32((x >> 3) << 3);
                ok = _mm256_and_si256(
                    ok,
                    _mm256_and_si256(
                        _mm256_and_si256(
                            _mm256_cmpgt_epi32(row, _mm256_set1_epi32(-1)),
                            _mm256_cmpgt_epi32(rowlimv, row)),
                        _mm256_and_si256(
                            _mm256_cmpgt_epi32(col, _mm256_set1_epi32(-1)),
                            _mm256_cmpgt_epi32(collimv, col))));
                ok = _mm256_and_si256(
                    ok,
                    _mm256_and_si256(
                        _mm256_and_si256(
                            _mm256_cmpgt_epi32(row,
                                               _mm256_sub_epi32(
                                                   by0,
                                                   _mm256_set1_epi32(1))),
                            _mm256_cmpgt_epi32(by1, row)),
                        _mm256_and_si256(
                            _mm256_cmpgt_epi32(
                                col,
                                _mm256_sub_epi32(bx0,
                                                 _mm256_set1_epi32(9))),
                            _mm256_cmpgt_epi32(
                                _mm256_add_epi32(bx0,
                                                 _mm256_set1_epi32(16)),
                                col))));
                int m = _mm256_movemask_ps(_mm256_castsi256_ps(ok));
                if (!m) continue;
                _mm256_storeu_si256((__m256i *)rows_s, row);
                _mm256_storeu_si256((__m256i *)cols_s, col);
                _mm256_storeu_si256((__m256i *)offs_s, off);
                _mm256_storeu_si256((__m256i *)mvp_s, mvv);
                do {
                    int l = __builtin_ctz(m);
                    m &= m - 1;
                    int64_t t = (int64_t)rows_s[l] * w8 + cols_s[l];
                    memcpy(tpl_mv + t * 2, &mvp_s[l], 4);
                    tpl_off[t] = (int8_t)offs_s[l];
                } while (m);
            }
            for (int x = w8a; x < w8; x++) {
                int64_t i = rowbase + x;
                int sr = ref8[i];
                if (sr <= 0 || sr > 8) continue;
                int off = ref_off[sr];
                if (off <= 0 || off > MF_MAXD) continue;
                int64_t dm = MF_DIV_MULT[off];
                int fr = mv8[i * 2], fc = mv8[i * 2 + 1];
                int64_t tr = (int64_t)fr * num * dm;
                int64_t tc = (int64_t)fc * num * dm;
                int lim_ = (1 << 14) - 1;
                int pr = tr >= 0 ? (int)((tr + 8192) >> 14)
                                 : -(int)((-tr + 8192) >> 14);
                int pc = tc >= 0 ? (int)((tc + 8192) >> 14)
                                 : -(int)((-tc + 8192) >> 14);
                pr = pr < -lim_ ? -lim_ : (pr > lim_ ? lim_ : pr);
                pc = pc < -lim_ ? -lim_ : (pc > lim_ ? lim_ : pc);
                int roff = pr >= 0 ? pr >> 6 : -((-pr) >> 6);
                int coff = pc >= 0 ? pc >> 6 : -((-pc) >> 6);
                int row = dir2 ? y - roff : y + roff;
                int col = dir2 ? x - coff : x + coff;
                if (row < 0 || row >= row_lim || col < 0 || col >= col_lim)
                    continue;
                int base_x = (x >> 3) << 3;
                if (row < base_y || row >= base_y + 8
                    || col < base_x - 8 || col >= base_x + 16)
                    continue;
                int64_t t = (int64_t)row * w8 + col;
                tpl_mv[t * 2] = (int16_t)fr;
                tpl_mv[t * 2 + 1] = (int16_t)fc;
                tpl_off[t] = (int8_t)off;
            }
        }
        return 0;
    }
#endif
    for (int y = 0; y < h8; y++) {
        int base_y = (y >> 3) << 3;
        for (int x = 0; x < w8; x++) {
            int64_t i = (int64_t)y * w8 + x;
            int sr = ref8[i];
            if (sr <= 0 || sr > 8) continue;
            int off = ref_off[sr];
            if (off <= 0 || off > MF_MAXD || !s2c_ok) continue;
            int den = off;  /* <= MF_MAXD already */
            int64_t dm = MF_DIV_MULT[den];
            int fr = mv8[i * 2], fc = mv8[i * 2 + 1];
            int64_t tr = (int64_t)fr * num * dm;
            int64_t tc = (int64_t)fc * num * dm;
            int lim = (1 << 14) - 1;
            int pr = tr >= 0 ? (int)((tr + 8192) >> 14)
                             : -(int)((-tr + 8192) >> 14);
            int pc = tc >= 0 ? (int)((tc + 8192) >> 14)
                             : -(int)((-tc + 8192) >> 14);
            pr = pr < -lim ? -lim : (pr > lim ? lim : pr);
            pc = pc < -lim ? -lim : (pc > lim ? lim : pc);
            int roff = pr >= 0 ? pr >> 6 : -((-pr) >> 6);
            int coff = pc >= 0 ? pc >> 6 : -((-pc) >> 6);
            int row = dir2 ? y - roff : y + roff;
            int col = dir2 ? x - coff : x + coff;
            if (row < 0 || row >= row_lim || col < 0 || col >= col_lim)
                continue;
            int base_x = (x >> 3) << 3;
            if (row < base_y || row >= base_y + 8
                || col < base_x - 8 || col >= base_x + 16)
                continue;
            int64_t t = (int64_t)row * w8 + col;
            tpl_mv[t * 2] = (int16_t)fr;
            tpl_mv[t * 2 + 1] = (int16_t)fc;
            tpl_off[t] = (int8_t)off;
        }
    }
    return 0;
}

#endif  /* PEL_BITS == 16 */

/* pel plane -> u8 display copy (+ optional u16 reference copy) */
int BDFN(av1_pack8)(const pel *p, int stride, int w, int h,
              uint8_t *out8, uint16_t *out16 /* optional */) {
    for (int r = 0; r < h; r++) {
        const pel *row = p + (int64_t)r * stride;
        uint8_t *o8 = out8 + (int64_t)r * w;
        if (out16) {
            uint16_t *o16 = out16 + (int64_t)r * w;
#if PEL_BITS == 16
            memcpy(o16, row, (size_t)w * sizeof(uint16_t));
#else
            for (int c = 0; c < w; c++)
                o16[c] = row[c];
#endif
        }
#if PEL_BITS == 8
        /* planes already carry u8 samples: the display copy is a crop */
        memcpy(o8, row, (size_t)w);
#else
        int c = 0;
#ifdef __AVX2__
        /* 8-bit planes carry values <= 255, so packus is a pure
           narrowing (no saturation in range) */
        for (; c + 32 <= w; c += 32) {
            __m256i a = _mm256_loadu_si256((const __m256i *)(row + c));
            __m256i b = _mm256_loadu_si256(
                (const __m256i *)(row + c + 16));
            __m256i pk = _mm256_permute4x64_epi64(
                _mm256_packus_epi16(a, b), 0xD8);
            _mm256_storeu_si256((__m256i *)(o8 + c), pk);
        }
#endif
        for (; c < w; c++)
            o8[c] = (uint8_t)row[c];
#endif
    }
    return 0;
}
