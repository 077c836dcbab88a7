/* Native Vorbis packet symbol decoder (hot path).
 *
 * Port of the repo's own verified Python reference
 * (easyav1/audio/vorbis/{bitreader,codebook,floor,residue,decoder}.py)
 * to C, mirroring the architecture split of SURVEY.md §7: sequential
 * symbol decode (floors + residues + floor-curve render) on the host,
 * dense synthesis (coupling, floor multiply, IMDCT, overlap-add) on the
 * device.  Reference parity target: the packet->spectrum half of
 * minivorbis' vorbis_synthesis (reference ext/minivorbis/minivorbis.h:
 * 12786 entry, 18246 codebook decode, 16820-16990 residues,
 * 15816/15962 floors).
 *
 * Setup state (codebook code lengths + precomputed VQ vectors, floor /
 * residue / mapping / mode configs) is parsed and validated by the
 * Python headers module once per stream and marshaled into a flat blob;
 * this file only implements the per-packet fast path.
 */

#include <math.h>
#include <setjmp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define LUT_BITS 11

/* ---------------------------------------------------------------- blob IO */

typedef struct {
    const uint8_t *p;
    const uint8_t *end;
} BlobReader;

static uint32_t blob_u32(BlobReader *b) {
    uint32_t v;
    memcpy(&v, b->p, 4);
    b->p += 4;
    return v;
}

static int32_t blob_i32(BlobReader *b) { return (int32_t)blob_u32(b); }

static float blob_f32(BlobReader *b) {
    float v;
    memcpy(&v, b->p, 4);
    b->p += 4;
    return v;
}

/* ------------------------------------------------------------- structures */

typedef struct {
    int dimensions;
    int entries;
    int single_entry;       /* >=0: single-entry book, read single_len bits */
    int single_len;
    int32_t *lut;           /* 1<<LUT_BITS entry ids */
    int8_t *lut_len;
    /* fallback for codes longer than LUT_BITS: arrays sorted by (len,code) */
    int n_long;
    uint32_t *long_codes;   /* (len<<24)|code, sorted */
    int32_t *long_entries;
    float *vectors;         /* entries*dimensions VQ table or NULL */
} Codebook;

typedef struct {
    int type;               /* 0 or 1 */
    /* floor1 */
    int n_classes;
    int n_part;             /* len(partition_class_list) */
    int32_t *partition_class_list;
    int32_t *class_dimensions;
    int32_t *class_subclasses;
    int32_t *class_masterbooks;
    int32_t *subclass_books;     /* n_classes * 8 */
    int multiplier;
    int n_x;
    int32_t *x_list;
    int32_t *sorted_index;
    int32_t *neigh_lo;
    int32_t *neigh_hi;
    int range;
    /* floor0 */
    int order;
    int rate;
    int bark_map_size;
    int amplitude_bits;
    int amplitude_offset;
    int n_books;
    int32_t *book_list;
} Floor;

typedef struct {
    int type;
    int begin, end, partition_size, classifications, classbook;
    int32_t *books;         /* classifications * 8, -1 = unused */
} Residue;

typedef struct {
    int submaps;
    int coupling_steps;
    int32_t *magnitude;
    int32_t *angle;
    int32_t *mux;           /* channels */
    int32_t *submap_floor;
    int32_t *submap_residue;
} Mapping;

typedef struct {
    int blockflag;
    int mapping;
} Mode;

typedef struct {
    int channels;
    int blocksize0, blocksize1;
    int mode_bits;
    int n_books, n_floors, n_residues, n_mappings, n_modes;
    Codebook *books;
    Floor *floors;
    int32_t *floor_types;
    Residue *residues;
    Mapping *mappings;
    Mode *modes;
    float inverse_db[256];
    /* scratch (sized to blocksize1) */
    int32_t *classifs;       /* ch * (max_parts + max_cdim) */
    int classifs_cap;
    int32_t *floor_posts;    /* max posts */
    int32_t *icurve;
    double *lsp;
    /* host synthesis state (lazy-allocated by vorbis_synth_block) */
    float *syn_lap;          /* ch * (blocksize1/2) overlap cache */
    int syn_lap_valid;
    int syn_prev_n;
    float *syn_win[8];       /* key: long<<2 | prev<<1 | next */
    float *syn_spec;         /* ch * blocksize1/2 coupled spectrum */
    float *syn_pcm;          /* ch * blocksize1 windowed imdct */
    float *fft_re, *fft_im;  /* blocksize1 scratch */
    /* per-blocksize tables: [0] -> blocksize0, [1] -> blocksize1 */
    float *tw_pre_re[2], *tw_pre_im[2];   /* n/2 */
    float *tw_post_re[2], *tw_post_im[2]; /* n */
    float *fft_wre[2], *fft_wim[2];       /* n/2 stage twiddles */
    int32_t *fft_brv[2];                  /* n bit-reverse perm */
    /* fused decode->pcm scratch */
    float *dec_res, *dec_floor;           /* ch * blocksize1/2 */
    uint8_t *dec_nores;                   /* ch */
    const Mapping *last_map;              /* mapping of last decoded mode */
} VorbisCtx;

/* --------------------------------------------------------------- bit read */

typedef struct {
    const uint8_t *data;
    long len;
    long pos;
    uint64_t acc;
    int nbits;
    jmp_buf *eop;
} Bits;

static inline uint32_t bits_read(Bits *b, int k) {
    while (b->nbits < k) {
        if (b->pos >= b->len)
            longjmp(*b->eop, 1);
        b->acc |= (uint64_t)b->data[b->pos++] << b->nbits;
        b->nbits += 8;
    }
    uint32_t v = (uint32_t)(b->acc & ((1u << k) - 1));
    b->acc >>= k;
    b->nbits -= k;
    return v;
}

static inline int ilog_(uint32_t x) {
    int n = 0;
    while (x) { n++; x >>= 1; }
    return n;
}

/* codebook scalar decode */
static inline int cb_decode(const Codebook *cb, Bits *b) {
    if (cb->single_entry >= 0) {
        bits_read(b, cb->single_len);
        return cb->single_entry;
    }
    uint64_t acc = b->acc;
    int n = b->nbits;
    long pos = b->pos;
    while (n < LUT_BITS && pos < b->len) {
        acc |= (uint64_t)b->data[pos++] << n;
        n += 8;
    }
    uint32_t idx = (uint32_t)(acc & ((1u << LUT_BITS) - 1));
    int l = cb->lut_len[idx];
    if (l > 0 && l <= n) {
        b->acc = acc >> l;
        b->nbits = n - l;
        b->pos = pos;
        return cb->lut[idx];
    }
    /* slow path: bit-by-bit */
    uint32_t code = 0;
    for (int length = 1; length <= 32; length++) {
        code = (code << 1) | bits_read(b, 1);
        uint32_t key = ((uint32_t)length << 24) | code;
        /* binary search */
        int lo = 0, hi = cb->n_long - 1;
        while (lo <= hi) {
            int mid = (lo + hi) >> 1;
            if (cb->long_codes[mid] < key) lo = mid + 1;
            else if (cb->long_codes[mid] > key) hi = mid - 1;
            else return cb->long_entries[mid];
        }
    }
    longjmp(*b->eop, 2);    /* invalid stream */
}

/* ---------------------------------------------------------------- floor 1 */

static inline int render_point(int x0, int y0, int x1, int y1, int x) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    int ady = dy < 0 ? -dy : dy;
    int err = ady * (x - x0);
    int off = err / adx;
    return dy < 0 ? y0 - off : y0 + off;
}

/* returns 1 if channel used; posts written to ctx->floor_posts encoded
 * as in the python reference (negative -v-1 == "not step2") */
static int floor1_decode(VorbisCtx *ctx, const Floor *f, Bits *b) {
    if (!bits_read(b, 1))
        return 0;
    int rng = f->range;
    int ybits = ilog_((uint32_t)(rng - 1));
    int n_posts = f->n_x;
    int32_t *y = ctx->floor_posts;           /* raw values first */
    int32_t step2[288];
    y[0] = (int32_t)bits_read(b, ybits);
    y[1] = (int32_t)bits_read(b, ybits);
    int off = 2;
    for (int pi = 0; pi < f->n_part; pi++) {
        int cls = f->partition_class_list[pi];
        int cdim = f->class_dimensions[cls];
        int cbits = f->class_subclasses[cls];
        int csub = (1 << cbits) - 1;
        int cval = 0;
        if (cbits)
            cval = cb_decode(&ctx->books[f->class_masterbooks[cls]], b);
        for (int j = 0; j < cdim; j++) {
            int book = f->subclass_books[cls * 8 + (cval & csub)];
            cval >>= cbits;
            if (book >= 0)
                y[off + j] = cb_decode(&ctx->books[book], b);
            else
                y[off + j] = 0;
        }
        off += cdim;
    }
    /* amplitude synthesis */
    int32_t fy[288];
    fy[0] = y[0];
    fy[1] = y[1];
    step2[0] = step2[1] = 1;
    for (int i = 2; i < n_posts; i++) {
        int lo = f->neigh_lo[i], hi = f->neigh_hi[i];
        int predicted = render_point(f->x_list[lo], fy[lo],
                                     f->x_list[hi], fy[hi], f->x_list[i]);
        int val = y[i];
        int highroom = rng - predicted;
        int lowroom = predicted;
        int room = 2 * (highroom < lowroom ? highroom : lowroom);
        if (val) {
            step2[lo] = 1;
            step2[hi] = 1;
            step2[i] = 1;
            if (val >= room) {
                fy[i] = highroom > lowroom ? val - lowroom + predicted
                                           : predicted - val + highroom - 1;
            } else {
                fy[i] = (val & 1) ? predicted - ((val + 1) >> 1)
                                  : predicted + (val >> 1);
            }
        } else {
            step2[i] = 0;
            fy[i] = predicted;
        }
    }
    for (int i = 0; i < n_posts; i++)
        ctx->floor_posts[i] = step2[i] ? fy[i] : -fy[i] - 1;
    return 1;
}

static void render_line(int x0, int y0, int x1, int y1, int32_t *v, int n) {
    int dy = y1 - y0;
    int adx = x1 - x0;
    if (adx <= 0)
        return;
    int end = x1 < n ? x1 : n;
    if (end <= x0)
        return;
    int ady = dy < 0 ? -dy : dy;
    /* incremental Bresenham matching floor((x-x0)*ady/adx) */
    int base = ady / adx;
    int sy = dy < 0 ? -base : base;
    int err = 0;
    int errdelta = ady - base * adx;
    int yv = y0;
    v[x0] = yv;
    for (int x = x0 + 1; x < end; x++) {
        err += errdelta;
        if (err >= adx) {
            err -= adx;
            yv += dy < 0 ? -(base + 1) : base + 1;
        } else {
            yv += sy;
        }
        v[x] = yv;
    }
}

static void floor1_synth(VorbisCtx *ctx, const Floor *f, int n2, float *out) {
    int rng = f->range;
    int mult = f->multiplier;
    int32_t *curve = ctx->icurve;
    int lx = -1, ly = 0;
    int started = 0;
    for (int si = 0; si < f->n_x; si++) {
        int idx = f->sorted_index[si];
        int32_t v = ctx->floor_posts[idx];
        if (v < 0)
            continue;
        int yv = v;
        if (yv > rng - 1) yv = rng - 1;
        int x = f->x_list[idx];
        int y = yv * mult;
        if (!started) {
            started = 1;
            if (x > 0) {
                int e = x < n2 ? x : n2;
                for (int i = 0; i < e; i++)
                    curve[i] = y;
            }
        } else if (lx < n2) {
            render_line(lx, ly, x, y, curve, n2);
        }
        lx = x;
        ly = y;
    }
    if (!started) {
        memset(out, 0, sizeof(float) * n2);
        return;
    }
    for (int i = lx < 0 ? 0 : lx; i < n2; i++)
        curve[i] = ly;
    for (int i = 0; i < n2; i++) {
        int c = curve[i];
        if (c < 0) c = 0;
        if (c > 255) c = 255;
        out[i] = ctx->inverse_db[c];
    }
}

/* ---------------------------------------------------------------- floor 0 */

static double bark_(double x) {
    return 13.1 * atan(0.00074 * x) + 2.24 * atan(1.85e-8 * x * x)
           + 1e-4 * x;
}

static int floor0_decode(VorbisCtx *ctx, const Floor *f, Bits *b,
                         double *amplitude) {
    uint32_t amp = bits_read(b, f->amplitude_bits);
    if ((int)amp <= 0)
        return 0;
    uint32_t booknum = bits_read(b, ilog_((uint32_t)(f->n_books - 1)));
    if ((int)booknum >= f->n_books)
        longjmp(*b->eop, 2);
    const Codebook *book = &ctx->books[f->book_list[booknum]];
    double last = 0.0;
    int got = 0;
    while (got < f->order) {
        int entry = cb_decode(book, b);
        const float *vec = &book->vectors[(size_t)entry * book->dimensions];
        for (int d = 0; d < book->dimensions && got < f->order + book->dimensions;
             d++) {
            ctx->lsp[got++] = (double)vec[d] + last;
        }
        last = ctx->lsp[got - 1];
    }
    *amplitude = (double)amp;
    return 1;
}

static void floor0_synth(VorbisCtx *ctx, const Floor *f, double amplitude,
                         int n2, float *out) {
    int order = f->order;
    int bms = f->bark_map_size;
    double foobar = bark_(f->rate / 2.0);
    double amp_max = (double)((1 << f->amplitude_bits) - 1);
    double cos_lsp[256];
    for (int j = 0; j < order; j++)
        cos_lsp[j] = cos(ctx->lsp[j]);
    for (int i = 0; i < n2; i++) {
        double m = floor(bark_(f->rate / 2.0 / n2 * i) * bms / foobar);
        if (m > bms - 1) m = bms - 1;
        double w = cos(m * (M_PI / bms));
        double p, q;
        if (order & 1) {
            p = 1.0 - w * w;
            q = 0.25;
            for (int j = 1; j < order; j += 2) {
                double t = w - cos_lsp[j];
                p *= 4.0 * t * t;
            }
            for (int j = 0; j < order; j += 2) {
                double t = w - cos_lsp[j];
                q *= 4.0 * t * t;
            }
        } else {
            p = 0.5 * (1.0 - w);
            q = 0.5 * (1.0 + w);
            for (int j = 1; j < order; j += 2) {
                double t = w - cos_lsp[j];
                p *= 4.0 * t * t;
            }
            for (int j = 0; j < order; j += 2) {
                double t = w - cos_lsp[j];
                q *= 4.0 * t * t;
            }
        }
        double linear = exp((amplitude * f->amplitude_offset /
                             (amp_max * sqrt(p + q)) - f->amplitude_offset)
                            * 0.11512925);
        out[i] = (float)linear;
    }
}

/* ---------------------------------------------------------------- residue */

static void residue_decode(VorbisCtx *ctx, const Residue *r, Bits *b,
                           float *v, int ch, long vstride,
                           const uint8_t *do_not_decode, int n) {
    int limit_begin = r->begin < n ? r->begin : n;
    int limit_end = r->end < n ? r->end : n;
    int psize = r->partition_size;
    int n_to_read = limit_end - limit_begin;
    if (n_to_read <= 0)
        return;
    int parts = n_to_read / psize;
    const Codebook *classbook = &ctx->books[r->classbook];
    int cdim = classbook->dimensions;
    int nclass = r->classifications;
    int32_t *classifs = ctx->classifs;
    long crow = parts + cdim;

    jmp_buf eop_local;
    jmp_buf *saved = b->eop;
    b->eop = &eop_local;
    if (setjmp(eop_local)) {
        b->eop = saved;
        return;                 /* EOP inside residue: normal termination */
    }
    for (int p = 0; p < 8; p++) {
        int pc = 0;
        while (pc < parts) {
            if (p == 0) {
                for (int j = 0; j < ch; j++) {
                    if (do_not_decode[j])
                        continue;
                    int temp = cb_decode(classbook, b);
                    for (int i = cdim - 1; i >= 0; i--) {
                        classifs[j * crow + pc + i] = temp % nclass;
                        temp /= nclass;
                    }
                }
            }
            for (int ci = 0; ci < cdim && pc < parts; ci++, pc++) {
                for (int j = 0; j < ch; j++) {
                    if (do_not_decode[j])
                        continue;
                    int vqclass = classifs[j * crow + pc];
                    int book_idx = r->books[vqclass * 8 + p];
                    if (book_idx < 0)
                        continue;
                    const Codebook *book = &ctx->books[book_idx];
                    long offset = limit_begin + (long)pc * psize;
                    float *row = v + j * vstride + offset;
                    int dims = book->dimensions;
                    if (r->type == 0) {
                        int step = psize / dims;
                        for (int k = 0; k < step; k++) {
                            int entry = cb_decode(book, b);
                            const float *vec =
                                &book->vectors[(size_t)entry * dims];
                            for (int d = 0; d < dims; d++)
                                row[k + d * step] += vec[d];
                        }
                    } else {
                        for (int i = 0; i < psize; i += dims) {
                            int entry = cb_decode(book, b);
                            const float *vec =
                                &book->vectors[(size_t)entry * dims];
                            for (int d = 0; d < dims; d++)
                                row[i + d] += vec[d];
                        }
                    }
                }
            }
        }
    }
    b->eop = saved;
}

/* ------------------------------------------------------------------ setup */

static void build_codebook(Codebook *cb, BlobReader *br) {
    cb->dimensions = blob_i32(br);
    cb->entries = blob_i32(br);
    cb->single_entry = blob_i32(br);
    cb->single_len = blob_i32(br);
    int n_codes = blob_i32(br);
    cb->lut = calloc(1u << LUT_BITS, sizeof(int32_t));
    cb->lut_len = calloc(1u << LUT_BITS, sizeof(int8_t));
    cb->n_long = 0;
    cb->long_codes = malloc(sizeof(uint32_t) * (n_codes ? n_codes : 1));
    cb->long_entries = malloc(sizeof(int32_t) * (n_codes ? n_codes : 1));
    for (int i = 0; i < n_codes; i++) {
        int entry = blob_i32(br);
        int len = blob_i32(br);
        uint32_t code = blob_u32(br);
        if (len <= LUT_BITS) {
            /* reverse bits of code (length len) for LSb-first peeking */
            uint32_t rev = 0;
            for (int k = 0; k < len; k++)
                rev |= ((code >> k) & 1u) << (len - 1 - k);
            uint32_t step = 1u << len;
            for (uint32_t idx = rev; idx < (1u << LUT_BITS); idx += step) {
                cb->lut[idx] = entry;
                cb->lut_len[idx] = (int8_t)len;
            }
        }
        /* all codes also go into the fallback list */
        cb->long_codes[cb->n_long] = ((uint32_t)len << 24) | code;
        cb->long_entries[cb->n_long] = entry;
        cb->n_long++;
    }
    /* sort fallback by key (insertion; setup-time only) */
    for (int i = 1; i < cb->n_long; i++) {
        uint32_t k = cb->long_codes[i];
        int32_t e = cb->long_entries[i];
        int j = i - 1;
        while (j >= 0 && cb->long_codes[j] > k) {
            cb->long_codes[j + 1] = cb->long_codes[j];
            cb->long_entries[j + 1] = cb->long_entries[j];
            j--;
        }
        cb->long_codes[j + 1] = k;
        cb->long_entries[j + 1] = e;
    }
    int has_vec = blob_i32(br);
    cb->vectors = NULL;
    if (has_vec) {
        size_t nv = (size_t)cb->entries * cb->dimensions;
        cb->vectors = malloc(sizeof(float) * nv);
        memcpy(cb->vectors, br->p, sizeof(float) * nv);
        br->p += sizeof(float) * nv;
    }
}

static int32_t *blob_arr(BlobReader *br, int n) {
    int32_t *a = malloc(sizeof(int32_t) * (n ? n : 1));
    for (int i = 0; i < n; i++)
        a[i] = blob_i32(br);
    return a;
}

void *vorbis_create(const uint8_t *blob, long blob_len) {
    BlobReader br = {blob, blob + blob_len};
    VorbisCtx *ctx = calloc(1, sizeof(VorbisCtx));
    ctx->channels = blob_i32(&br);
    ctx->blocksize0 = blob_i32(&br);
    ctx->blocksize1 = blob_i32(&br);
    ctx->mode_bits = blob_i32(&br);
    ctx->n_books = blob_i32(&br);
    ctx->books = calloc(ctx->n_books, sizeof(Codebook));
    for (int i = 0; i < ctx->n_books; i++)
        build_codebook(&ctx->books[i], &br);
    ctx->n_floors = blob_i32(&br);
    ctx->floors = calloc(ctx->n_floors, sizeof(Floor));
    ctx->floor_types = malloc(sizeof(int32_t) * ctx->n_floors);
    for (int i = 0; i < ctx->n_floors; i++) {
        Floor *f = &ctx->floors[i];
        f->type = blob_i32(&br);
        ctx->floor_types[i] = f->type;
        if (f->type == 1) {
            f->n_classes = blob_i32(&br);
            f->n_part = blob_i32(&br);
            f->partition_class_list = blob_arr(&br, f->n_part);
            f->class_dimensions = blob_arr(&br, f->n_classes);
            f->class_subclasses = blob_arr(&br, f->n_classes);
            f->class_masterbooks = blob_arr(&br, f->n_classes);
            f->subclass_books = blob_arr(&br, f->n_classes * 8);
            f->multiplier = blob_i32(&br);
            f->n_x = blob_i32(&br);
            f->x_list = blob_arr(&br, f->n_x);
            f->sorted_index = blob_arr(&br, f->n_x);
            f->neigh_lo = blob_arr(&br, f->n_x);
            f->neigh_hi = blob_arr(&br, f->n_x);
            f->range = blob_i32(&br);
        } else {
            f->order = blob_i32(&br);
            f->rate = blob_i32(&br);
            f->bark_map_size = blob_i32(&br);
            f->amplitude_bits = blob_i32(&br);
            f->amplitude_offset = blob_i32(&br);
            f->n_books = blob_i32(&br);
            f->book_list = blob_arr(&br, f->n_books);
        }
    }
    ctx->n_residues = blob_i32(&br);
    ctx->residues = calloc(ctx->n_residues, sizeof(Residue));
    for (int i = 0; i < ctx->n_residues; i++) {
        Residue *r = &ctx->residues[i];
        r->type = blob_i32(&br);
        r->begin = blob_i32(&br);
        r->end = blob_i32(&br);
        r->partition_size = blob_i32(&br);
        r->classifications = blob_i32(&br);
        r->classbook = blob_i32(&br);
        r->books = blob_arr(&br, r->classifications * 8);
    }
    ctx->n_mappings = blob_i32(&br);
    ctx->mappings = calloc(ctx->n_mappings, sizeof(Mapping));
    for (int i = 0; i < ctx->n_mappings; i++) {
        Mapping *m = &ctx->mappings[i];
        m->submaps = blob_i32(&br);
        m->coupling_steps = blob_i32(&br);
        m->magnitude = blob_arr(&br, m->coupling_steps);
        m->angle = blob_arr(&br, m->coupling_steps);
        m->mux = blob_arr(&br, ctx->channels);
        m->submap_floor = blob_arr(&br, m->submaps);
        m->submap_residue = blob_arr(&br, m->submaps);
    }
    ctx->n_modes = blob_i32(&br);
    ctx->modes = calloc(ctx->n_modes, sizeof(Mode));
    for (int i = 0; i < ctx->n_modes; i++) {
        ctx->modes[i].blockflag = blob_i32(&br);
        ctx->modes[i].mapping = blob_i32(&br);
    }
    for (int i = 0; i < 256; i++)
        ctx->inverse_db[i] = blob_f32(&br);

    int n2max = ctx->blocksize1 / 2;
    /* residue type 2 interleaves ch*n2 into one vector */
    long cls_cap = (long)ctx->channels *
                   (n2max * ctx->channels / 1 + 64);
    ctx->classifs = malloc(sizeof(int32_t) * cls_cap);
    ctx->classifs_cap = (int)cls_cap;
    ctx->floor_posts = malloc(sizeof(int32_t) * 512);
    ctx->icurve = malloc(sizeof(int32_t) * n2max);
    ctx->lsp = malloc(sizeof(double) * 512);
    return ctx;
}

void vorbis_destroy(void *h) {
    VorbisCtx *ctx = h;
    if (!ctx)
        return;
    for (int i = 0; i < ctx->n_books; i++) {
        free(ctx->books[i].lut);
        free(ctx->books[i].lut_len);
        free(ctx->books[i].long_codes);
        free(ctx->books[i].long_entries);
        free(ctx->books[i].vectors);
    }
    free(ctx->books);
    for (int i = 0; i < ctx->n_floors; i++) {
        Floor *f = &ctx->floors[i];
        free(f->partition_class_list);
        free(f->class_dimensions);
        free(f->class_subclasses);
        free(f->class_masterbooks);
        free(f->subclass_books);
        free(f->x_list);
        free(f->sorted_index);
        free(f->neigh_lo);
        free(f->neigh_hi);
        free(f->book_list);
    }
    free(ctx->floors);
    free(ctx->floor_types);
    for (int i = 0; i < ctx->n_residues; i++)
        free(ctx->residues[i].books);
    free(ctx->residues);
    for (int i = 0; i < ctx->n_mappings; i++) {
        Mapping *m = &ctx->mappings[i];
        free(m->magnitude);
        free(m->angle);
        free(m->mux);
        free(m->submap_floor);
        free(m->submap_residue);
    }
    free(ctx->mappings);
    free(ctx->modes);
    free(ctx->classifs);
    free(ctx->floor_posts);
    free(ctx->icurve);
    free(ctx->lsp);
    free(ctx->syn_lap);
    free(ctx->syn_spec);
    free(ctx->syn_pcm);
    free(ctx->fft_re);
    free(ctx->fft_im);
    for (int i = 0; i < 8; i++)
        free(ctx->syn_win[i]);
    for (int i = 0; i < 2; i++) {
        free(ctx->tw_pre_re[i]);
        free(ctx->tw_pre_im[i]);
        free(ctx->tw_post_re[i]);
        free(ctx->tw_post_im[i]);
        free(ctx->fft_wre[i]);
        free(ctx->fft_wim[i]);
        free(ctx->fft_brv[i]);
    }
    free(ctx->dec_res);
    free(ctx->dec_floor);
    free(ctx->dec_nores);
    free(ctx);
}

/* ------------------------------------------------------------ packet path */

/* out_residue / out_floor: ch * (blocksize1/2) float32 row-major;
 * out_flags: [n, long, prev, next]; out_no_residue: ch bytes.
 * Returns 1 on decoded audio block, 0 for non-audio packet. */
int vorbis_decode_packet(void *h, const uint8_t *pkt, long pkt_len,
                         float *out_residue, float *out_floor,
                         uint8_t *out_no_residue, int32_t *out_flags) {
    VorbisCtx *ctx = h;
    jmp_buf eop;
    Bits b = {pkt, pkt_len, 0, 0, 0, &eop};
    int ch = ctx->channels;

    int mode_idx, long_block, n, prev_flag = 0, next_flag = 0;
    const Mode *mode;
    const Mapping *map;
    if (setjmp(eop))
        return 0;               /* truncated header: no block */
    if (bits_read(&b, 1) != 0)
        return 0;
    mode_idx = (int)bits_read(&b, ctx->mode_bits);
    if (mode_idx >= ctx->n_modes)
        return 0;
    mode = &ctx->modes[mode_idx];
    map = &ctx->mappings[mode->mapping];
    ctx->last_map = map;
    long_block = mode->blockflag;
    n = long_block ? ctx->blocksize1 : ctx->blocksize0;
    if (long_block) {
        prev_flag = (int)bits_read(&b, 1);
        next_flag = (int)bits_read(&b, 1);
    }
    int n2 = n / 2;
    long stride = ctx->blocksize1 / 2;

    for (int c = 0; c < ch; c++) {
        memset(out_residue + c * stride, 0, sizeof(float) * n2);
        memset(out_floor + c * stride, 0, sizeof(float) * n2);
        out_no_residue[c] = 1;
    }

    /* per-channel floor state: posts (floor1) or lsp+amp (floor0) */
    int32_t posts[8][288];
    double f0_amp[8];
    double f0_lsp[8][256];
    int used[8];
    memset(used, 0, sizeof(used));

    jmp_buf eop2;
    b.eop = &eop2;
    if (!setjmp(eop2)) {
        for (int c = 0; c < ch; c++) {
            int fidx = map->submap_floor[map->mux[c]];
            const Floor *f = &ctx->floors[fidx];
            if (f->type == 1) {
                if (floor1_decode(ctx, f, &b)) {
                    used[c] = 1;
                    memcpy(posts[c], ctx->floor_posts,
                           sizeof(int32_t) * f->n_x);
                }
            } else {
                double amp;
                if (floor0_decode(ctx, f, &b, &amp)) {
                    used[c] = 1;
                    f0_amp[c] = amp;
                    memcpy(f0_lsp[c], ctx->lsp,
                           sizeof(double) * f->order);
                }
            }
            out_no_residue[c] = used[c] ? 0 : 1;
        }
        /* nonzero propagation through coupling */
        uint8_t dnd[8];
        for (int c = 0; c < ch; c++)
            dnd[c] = out_no_residue[c];
        for (int s = 0; s < map->coupling_steps; s++) {
            int m = map->magnitude[s], a = map->angle[s];
            if (!(out_no_residue[m] && out_no_residue[a])) {
                dnd[m] = 0;
                dnd[a] = 0;
            }
        }
        /* residues per submap */
        for (int s = 0; s < map->submaps; s++) {
            int chans[8], nch = 0;
            uint8_t sub_dnd[8];
            for (int c = 0; c < ch; c++)
                if (map->mux[c] == s) {
                    sub_dnd[nch] = dnd[c];
                    chans[nch++] = c;
                }
            const Residue *r = &ctx->residues[map->submap_residue[s]];
            if (r->type == 2) {
                int all = 1;
                for (int i = 0; i < nch; i++)
                    all &= sub_dnd[i];
                if (!all) {
                    /* interleaved single-vector decode into scratch:
                       use out_residue rows then deinterleave */
                    long total = (long)n2 * nch;
                    float *tmp = malloc(sizeof(float) * total);
                    memset(tmp, 0, sizeof(float) * total);
                    uint8_t z = 0;
                    residue_decode(ctx, r, &b, tmp, 1, total, &z, (int)total);
                    for (int i = 0; i < nch; i++) {
                        float *row = out_residue + chans[i] * stride;
                        for (int k = 0; k < n2; k++)
                            row[k] = tmp[(long)k * nch + i];
                    }
                    free(tmp);
                }
            } else {
                /* gather rows */
                float *rows = malloc(sizeof(float) * (size_t)nch * n2);
                memset(rows, 0, sizeof(float) * (size_t)nch * n2);
                residue_decode(ctx, r, &b, rows, nch, n2, sub_dnd, n2);
                for (int i = 0; i < nch; i++)
                    memcpy(out_residue + chans[i] * stride, rows + (long)i * n2,
                           sizeof(float) * n2);
                free(rows);
            }
        }
    }

    /* floor curve synthesis (no bitstream access) */
    for (int c = 0; c < ch; c++) {
        if (!used[c])
            continue;
        int fidx = map->submap_floor[map->mux[c]];
        const Floor *f = &ctx->floors[fidx];
        if (f->type == 1) {
            memcpy(ctx->floor_posts, posts[c], sizeof(int32_t) * f->n_x);
            floor1_synth(ctx, f, n2, out_floor + c * stride);
        } else {
            memcpy(ctx->lsp, f0_lsp[c], sizeof(double) * f->order);
            floor0_synth(ctx, f, f0_amp[c], n2, out_floor + c * stride);
        }
    }

    out_flags[0] = n;
    out_flags[1] = long_block;
    out_flags[2] = prev_flag;
    out_flags[3] = next_flag;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Host synthesis: coupling -> floor multiply -> IMDCT -> window ->    */
/* overlap-add.  C port of the repo's verified Python reference        */
/* (decoder.synthesize_block_host / imdct_fft / build_window); float32 */
/* throughout, matching libvorbis' own synthesis precision (reference  */
/* parity: minivorbis.h vorbis_synthesis_blockin + mdct_backward).     */

static void syn_fft(float *re, float *im, int n, const float *wre,
                    const float *wim, const int32_t *brv) {
    /* iterative radix-2 DIT with e^{+2pi i k/n} twiddles (the
       unnormalized inverse transform the IMDCT identity needs) */
    for (int i = 0; i < n; i++) {
        int j = brv[i];
        if (j > i) {
            float t = re[i]; re[i] = re[j]; re[j] = t;
            t = im[i]; im[i] = im[j]; im[j] = t;
        }
    }
    for (int len = 2; len <= n; len <<= 1) {
        int half = len >> 1, step = n / len;
        for (int i = 0; i < n; i += len) {
            float *restrict r0 = re + i, *restrict i0 = im + i;
            float *restrict r1 = r0 + half, *restrict i1 = i0 + half;
            for (int j = 0; j < half; j++) {
                float wr = wre[j * step], wi = wim[j * step];
                float vr = r1[j] * wr - i1[j] * wi;
                float vi = r1[j] * wi + i1[j] * wr;
                float ur = r0[j], ui = i0[j];
                r0[j] = ur + vr; i0[j] = ui + vi;
                r1[j] = ur - vr; i1[j] = ui - vi;
            }
        }
    }
}

static int syn_size_idx(const VorbisCtx *ctx, int n) {
    return n == ctx->blocksize1 ? 1 : 0;
}

static void syn_tables_init(VorbisCtx *ctx, int n) {
    int si = syn_size_idx(ctx, n);
    if (ctx->tw_pre_re[si])
        return;
    int n2 = n / 2;
    float *pre_re = malloc(sizeof(float) * n2);
    float *pre_im = malloc(sizeof(float) * n2);
    for (int k = 0; k < n2; k++) {
        double ph = M_PI * k * (1.0 / n + 0.5);
        pre_re[k] = (float)cos(ph);
        pre_im[k] = (float)sin(ph);
    }
    float *post_re = malloc(sizeof(float) * n);
    float *post_im = malloc(sizeof(float) * n);
    for (int j = 0; j < n; j++) {
        double ph = M_PI * (j + 0.5 + n / 4.0) / n;
        post_re[j] = (float)cos(ph);
        post_im[j] = (float)sin(ph);
    }
    float *wre = malloc(sizeof(float) * n2);
    float *wim = malloc(sizeof(float) * n2);
    for (int k = 0; k < n2; k++) {
        double ph = 2.0 * M_PI * k / n;
        wre[k] = (float)cos(ph);
        wim[k] = (float)sin(ph);      /* +i exponent */
    }
    int32_t *brv = malloc(sizeof(int32_t) * n);
    int lg = 0;
    for (int v = n; v > 1; v >>= 1) lg++;
    for (int i = 0; i < n; i++) {
        int r = 0;
        for (int b = 0; b < lg; b++) r |= ((i >> b) & 1) << (lg - 1 - b);
        brv[i] = r;
    }
    ctx->tw_pre_re[si] = pre_re; ctx->tw_pre_im[si] = pre_im;
    ctx->tw_post_re[si] = post_re; ctx->tw_post_im[si] = post_im;
    ctx->fft_wre[si] = wre; ctx->fft_wim[si] = wim;
    ctx->fft_brv[si] = brv;
}

static double syn_slope(double j, double width) {
    double s = sin(0.5 * M_PI * (j + 0.5) / width);
    return sin(0.5 * M_PI * s * s);
}

static const float *syn_window(VorbisCtx *ctx, int n, int lb, int pf,
                               int nf) {
    int key = lb ? (4 | (pf << 1) | nf) : 0;
    if (ctx->syn_win[key])
        return ctx->syn_win[key];
    int n0 = ctx->blocksize0, n1 = ctx->blocksize1;
    int left_w = (lb && pf) ? n1 / 2 : n0 / 2;
    int right_w = (lb && nf) ? n1 / 2 : n0 / 2;
    if (!lb) left_w = right_w = n / 2;
    int left_start = n / 4 - left_w / 2;
    int right_start = 3 * n / 4 - right_w / 2;
    float *w = calloc(n, sizeof(float));
    for (int j = 0; j < left_w; j++)
        w[left_start + j] = (float)syn_slope(j, left_w);
    for (int j = left_start + left_w; j < right_start; j++)
        w[j] = 1.0f;
    for (int j = 0; j < right_w; j++)
        w[right_start + j] = (float)syn_slope(right_w - 1 - j, right_w);
    ctx->syn_win[key] = w;
    return w;
}

static void syn_ensure(VorbisCtx *ctx) {
    if (ctx->syn_lap)
        return;
    int ch = ctx->channels, n1 = ctx->blocksize1;
    ctx->syn_lap = calloc((size_t)ch * (n1 / 2), sizeof(float));
    ctx->syn_spec = malloc(sizeof(float) * (size_t)ch * (n1 / 2));
    ctx->syn_pcm = malloc(sizeof(float) * (size_t)ch * n1);
    ctx->fft_re = malloc(sizeof(float) * n1);
    ctx->fft_im = malloc(sizeof(float) * n1);
}

void vorbis_synth_reset(void *h) {
    VorbisCtx *ctx = h;
    ctx->syn_lap_valid = 0;
    ctx->syn_prev_n = 0;
    if (ctx->syn_lap)
        memset(ctx->syn_lap, 0,
               sizeof(float) * (size_t)ctx->channels *
                   (ctx->blocksize1 / 2));
}

/* decode-free position tracking (trackonly seek skip): advances the
 * overlap bookkeeping, zeroing the lap.  Returns the sample count the
 * block would have produced. */
long vorbis_synth_track(void *h, int32_t n) {
    VorbisCtx *ctx = h;
    syn_ensure(ctx);
    if (!ctx->syn_lap_valid) {
        ctx->syn_lap_valid = 1;
        ctx->syn_prev_n = n;
        return 0;
    }
    long out = ctx->syn_prev_n / 4 + n / 4;
    memset(ctx->syn_lap, 0,
           sizeof(float) * (size_t)ctx->channels * (ctx->blocksize1 / 2));
    ctx->syn_prev_n = n;
    return out;
}

/* Synthesize one block: residue/floor rows of `stride` floats per
 * channel (as produced by vorbis_decode_packet), flags = [n, long,
 * prev, next], coupling = steps x (magnitude, angle) in forward order.
 * Writes (L, ch)-interleaved float32 into out; returns L. */
long vorbis_synth_block(void *h, const float *res_in,
                        const float *floor_in, long stride,
                        const int32_t *flags, const int32_t *coup,
                        int32_t steps, float *out) {
    VorbisCtx *ctx = h;
    int n = flags[0], lb = flags[1], pf = flags[2], nf = flags[3];
    int ch = ctx->channels, n2 = n / 2;
    syn_ensure(ctx);
    syn_tables_init(ctx, n);
    int si = syn_size_idx(ctx, n);

    /* inverse coupling (spec 4.3.5, reverse step order) + floor */
    float *spec = ctx->syn_spec;
    for (int c = 0; c < ch; c++)
        memcpy(spec + (size_t)c * n2, res_in + (size_t)c * stride,
               sizeof(float) * n2);
    for (int s = steps - 1; s >= 0; s--) {
        float *M = spec + (size_t)coup[s * 2] * n2;
        float *A = spec + (size_t)coup[s * 2 + 1] * n2;
        for (int k = 0; k < n2; k++) {
            float m = M[k], a = A[k], nm, na;
            if (m > 0) {
                if (a > 0) { nm = m; na = m - a; }
                else       { nm = m + a; na = m; }
            } else {
                if (a > 0) { nm = m; na = m + a; }
                else       { nm = m - a; na = m; }
            }
            M[k] = nm; A[k] = na;
        }
    }

    const float *w = syn_window(ctx, n, lb, pf, nf);
    const float *pre_re = ctx->tw_pre_re[si], *pre_im = ctx->tw_pre_im[si];
    const float *post_re = ctx->tw_post_re[si];
    const float *post_im = ctx->tw_post_im[si];
    for (int c = 0; c < ch; c++) {
        const float *sp = spec + (size_t)c * n2;
        const float *fl = floor_in + (size_t)c * stride;
        float *restrict re = ctx->fft_re, *restrict im = ctx->fft_im;
        for (int k = 0; k < n2; k++) {
            float x = sp[k] * fl[k];
            re[k] = x * pre_re[k];
            im[k] = x * pre_im[k];
        }
        memset(re + n2, 0, sizeof(float) * n2);
        memset(im + n2, 0, sizeof(float) * n2);
        syn_fft(re, im, n, ctx->fft_wre[si], ctx->fft_wim[si],
                ctx->fft_brv[si]);
        float *restrict pcm = ctx->syn_pcm + (size_t)c * n;
        for (int j = 0; j < n; j++)
            pcm[j] = (post_re[j] * re[j] - post_im[j] * im[j]) * w[j];
    }

    int lap_stride = ctx->blocksize1 / 2;
    if (!ctx->syn_lap_valid) {
        for (int c = 0; c < ch; c++)
            memcpy(ctx->syn_lap + (size_t)c * lap_stride,
                   ctx->syn_pcm + (size_t)c * n + n2,
                   sizeof(float) * n2);
        ctx->syn_lap_valid = 1;
        ctx->syn_prev_n = n;
        return 0;
    }
    int prev_n = ctx->syn_prev_n;
    long L = prev_n / 4 + n / 4;
    long avail = L < prev_n / 2 ? L : prev_n / 2;
    int l0 = (n - prev_n) / 4;
    for (int c = 0; c < ch; c++) {
        const float *lap = ctx->syn_lap + (size_t)c * lap_stride;
        const float *pcm = ctx->syn_pcm + (size_t)c * n;
        for (long j = 0; j < L; j++) {
            float v = j < avail ? lap[j] : 0.0f;
            if (l0 >= 0)
                v += pcm[l0 + j];
            else if (j >= -l0)
                v += pcm[j + l0];
            out[j * ch + c] = v;
        }
    }
    for (int c = 0; c < ch; c++) {
        float *lap = ctx->syn_lap + (size_t)c * lap_stride;
        memset(lap, 0, sizeof(float) * lap_stride);
        memcpy(lap, ctx->syn_pcm + (size_t)c * n + n2,
               sizeof(float) * n2);
    }
    ctx->syn_prev_n = n;
    return L;
}

/* Fused packet -> PCM: symbol decode + host synthesis in one call (no
 * intermediate tensors crossing the FFI).  out must hold at least
 * (blocksize1/2) * ch floats, written (L, ch)-interleaved.  Returns the
 * sample count L (0 for the first block), or -1 for non-audio packets. */
long vorbis_decode_pcm(void *h, const uint8_t *pkt, long pkt_len,
                       float *out) {
    VorbisCtx *ctx = h;
    if (!ctx->dec_res) {
        size_t sz = sizeof(float) * (size_t)ctx->channels *
                    (ctx->blocksize1 / 2);
        ctx->dec_res = malloc(sz);
        ctx->dec_floor = malloc(sz);
        ctx->dec_nores = malloc((size_t)ctx->channels);
    }
    int32_t flags[4];
    if (!vorbis_decode_packet(h, pkt, pkt_len, ctx->dec_res,
                              ctx->dec_floor, ctx->dec_nores, flags))
        return -1;
    const Mapping *map = ctx->last_map;
    int32_t coup[512];
    int steps = map->coupling_steps;
    if (steps > 256)
        steps = 256;
    for (int s = 0; s < steps; s++) {
        coup[s * 2] = map->magnitude[s];
        coup[s * 2 + 1] = map->angle[s];
    }
    return vorbis_synth_block(h, ctx->dec_res, ctx->dec_floor,
                              ctx->blocksize1 / 2, flags, coup, steps,
                              out);
}
