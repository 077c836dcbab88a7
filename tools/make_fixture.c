/* make_fixture — synthesize deterministic AV1+Vorbis WebM test fixtures.
 *
 * Test-infrastructure tool: uses the system ffmpeg libraries (libaom-av1
 * encoder, libvorbis encoder, WebM muxer) to produce conformance fixtures
 * for the easyav1 decoder. Mirrors the reference's recommended fixture
 * workflow (reference README.md:105-108: encode with ffmpeg svt-av1+vorbis).
 *
 * Usage:
 *   make_fixture out.webm [key=val ...]
 * keys:
 *   w,h,fps,frames,gop       video geometry (frames=0 disables video)
 *   bitdepth                 8 or 10
 *   crf,cpu-used             quality/speed
 *   audio_rate,channels,audio_secs  audio (audio_secs=0 disables audio)
 *   vorbis_q                 libvorbis quality (-1..10)
 *   vopt:NAME=VAL            pass-through libaom-av1 private option, e.g.
 *                            vopt:enable-cdef=0 vopt:use-intra-dct-only=1
 */
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libavutil/imgutils.h>
#include <libavutil/channel_layout.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static uint32_t rng_state = 0x12345678u;
static uint32_t rng(void) {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 17;
    rng_state ^= rng_state << 5;
    return rng_state;
}

static void die(const char *msg, int err) {
    char buf[256] = {0};
    if (err) av_strerror(err, buf, sizeof buf);
    fprintf(stderr, "make_fixture: %s (%s)\n", msg, buf);
    exit(1);
}

/* Deterministic video content: moving gradients, a bouncing rectangle,
 * mild noise — enough structure to exercise intra, inter and transforms.
 * content kinds: 0 = default xor pattern; 1 = diagonal stripes
 * (directional intra); 2 = smooth ramps with luma-correlated chroma
 * (CfL); 3 = flat colour cells (palette / screen content); 4 = a
 * repeated 32x32 pseudo-noise tile (text-like; rewards intrabc). */
static int g_content = 0;

static void fill_frame(AVFrame *f, int t, int depth) {
    int w = f->width, h = f->height;
    int shift = depth - 8;
    const AVPixFmtDescriptor *desc = av_pix_fmt_desc_get(f->format);
    const int ssx = desc->log2_chroma_w, ssy = desc->log2_chroma_h;
    const int has_chroma = desc->nb_components > 1 && f->data[1];
    const int cw = (w + (1 << ssx) - 1) >> ssx;
    const int ch = (h + (1 << ssy) - 1) >> ssy;
    if (g_content != 0 && depth == 8) {
        for (int y = 0; y < h; y++) {
            uint8_t *row = f->data[0] + y * f->linesize[0];
            for (int x = 0; x < w; x++) {
                int v;
                if (g_content == 1)
                    v = ((x + y + t) / 3 % 2) ? 80 + ((x + y) & 31)
                                              : 170 - ((x - y) & 15);
                else if (g_content == 2)
                    v = 60 + ((x * 3 + y * 2 + 4 * t) % 160);
                else if (g_content == 4) {
                    unsigned hsh = (unsigned)((x & 31) * 374761393u
                                   + (y & 31) * 668265263u + 1013904223u);
                    hsh ^= hsh >> 13; hsh *= 1274126177u; hsh ^= hsh >> 16;
                    static const int pal4[4] = { 32, 96, 160, 224 };
                    v = pal4[hsh & 3];
                } else
                    v = ((x / 16 + y / 16 + t) % 5) * 50 + 20;
                row[x] = (uint8_t)v;
            }
        }
        for (int y = 0; has_chroma && y < ch; y++) {
            uint8_t *u = f->data[1] + y * f->linesize[1];
            uint8_t *v = f->data[2] + y * f->linesize[2];
            const uint8_t *ly = f->data[0] + (y << ssy) * f->linesize[0];
            for (int x = 0; x < cw; x++) {
                if (g_content == 2) {  /* chroma tracks luma -> CfL */
                    u[x] = (uint8_t)(90 + (ly[x << ssx] >> 2));
                    v[x] = (uint8_t)(190 - (ly[x << ssx] >> 2));
                } else if (g_content == 3) {
                    u[x] = (uint8_t)(((x / 8 + y / 8) % 3) * 60 + 70);
                    v[x] = (uint8_t)(((x / 8 + 2 * (y / 8)) % 3) * 60 + 70);
                } else if (g_content == 4) {
                    unsigned hsh = (unsigned)((x & 15) * 2654435761u
                                   + (y & 15) * 40503u + 12345u);
                    hsh ^= hsh >> 11; hsh *= 2246822519u; hsh ^= hsh >> 15;
                    static const int p4u[4] = { 70, 110, 150, 190 };
                    u[x] = (uint8_t)p4u[hsh & 3];
                    v[x] = (uint8_t)p4u[(hsh >> 2) & 3];
                } else {
                    u[x] = (uint8_t)(128 + 50 * sin(0.02 * (x + y)));
                    v[x] = (uint8_t)(128 - 50 * sin(0.02 * (x - y)));
                }
            }
        }
        return;
    }
    for (int y = 0; y < h; y++) {
        if (depth == 8) {
            uint8_t *row = f->data[0] + y * f->linesize[0];
            for (int x = 0; x < w; x++) {
                int v = ((x + 3 * t) & 255) ^ ((y * 2 - t) & 127);
                v = (v + ((rng() >> 28) & 3)) & 255;
                row[x] = (uint8_t)v;
            }
        } else {
            uint16_t *row = (uint16_t *)(f->data[0] + y * f->linesize[0]);
            for (int x = 0; x < w; x++) {
                int v = ((x + 3 * t) & 255) ^ ((y * 2 - t) & 127);
                row[x] = (uint16_t)((v << shift) | (rng() & ((1 << shift) - 1)));
            }
        }
    }
    /* bouncing rectangle on luma */
    int bx = (37 * t) % (w > 64 ? w - 64 : 1), by = (23 * t) % (h > 48 ? h - 48 : 1);
    for (int y = by; y < by + 48 && y < h; y++) {
        if (depth == 8) {
            uint8_t *row = f->data[0] + y * f->linesize[0];
            for (int x = bx; x < bx + 64 && x < w; x++) row[x] = 235;
        } else {
            uint16_t *row = (uint16_t *)(f->data[0] + y * f->linesize[0]);
            for (int x = bx; x < bx + 64 && x < w; x++) row[x] = 235 << shift;
        }
    }
    for (int y = 0; has_chroma && y < ch; y++) {
        if (depth == 8) {
            uint8_t *u = f->data[1] + y * f->linesize[1];
            uint8_t *v = f->data[2] + y * f->linesize[2];
            for (int x = 0; x < cw; x++) {
                u[x] = (uint8_t)(128 + 64 * sin(0.05 * x + 0.1 * t));
                v[x] = (uint8_t)(128 + 64 * cos(0.04 * y - 0.07 * t));
            }
        } else {
            uint16_t *u = (uint16_t *)(f->data[1] + y * f->linesize[1]);
            uint16_t *v = (uint16_t *)(f->data[2] + y * f->linesize[2]);
            for (int x = 0; x < cw; x++) {
                u[x] = (uint16_t)((128 + 64 * sin(0.05 * x + 0.1 * t))) << shift;
                v[x] = (uint16_t)((128 + 64 * cos(0.04 * y - 0.07 * t))) << shift;
            }
        }
    }
}

static void encode_and_mux(AVFormatContext *oc, AVCodecContext *cc,
                           AVStream *st, AVFrame *frame) {
    int ret = avcodec_send_frame(cc, frame);
    if (ret < 0) die("send_frame", ret);
    AVPacket *pkt = av_packet_alloc();
    while ((ret = avcodec_receive_packet(cc, pkt)) >= 0) {
        av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
        pkt->stream_index = st->index;
        ret = av_interleaved_write_frame(oc, pkt);
        if (ret < 0) die("write_frame", ret);
    }
    av_packet_free(&pkt);
    if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) die("receive_packet", ret);
}

int main(int argc, char **argv) {
    if (argc < 2) { fprintf(stderr, "usage: make_fixture out.webm [key=val...]\n"); return 2; }
    const char *outpath = argv[1];
    int w = 320, h = 240, fps = 30, frames = 30, gop = 9999, bitdepth = 8;
    int ss = 420;
    int audio_rate = 48000, channels = 2, cpu_used = 8, audio_kind = 0;
    double audio_secs = 0.0, vorbis_q = 0.4, crf = 35;
    char vopts[32][128]; int n_vopts = 0;

    for (int i = 2; i < argc; i++) {
        char key[64], val[96];
        if (sscanf(argv[i], "vopt:%120[^\n]", vopts[n_vopts]) == 1 && strchr(argv[i], ':')) {
            n_vopts++; continue;
        }
        if (sscanf(argv[i], "%63[^=]=%95s", key, val) != 2) { fprintf(stderr, "bad arg %s\n", argv[i]); return 2; }
        if (!strcmp(key, "w")) w = atoi(val);
        else if (!strcmp(key, "h")) h = atoi(val);
        else if (!strcmp(key, "fps")) fps = atoi(val);
        else if (!strcmp(key, "frames")) frames = atoi(val);
        else if (!strcmp(key, "gop")) gop = atoi(val);
        else if (!strcmp(key, "bitdepth")) bitdepth = atoi(val);
        else if (!strcmp(key, "ss")) ss = !strcmp(val, "mono") ? 400 : atoi(val);
        else if (!strcmp(key, "crf")) crf = atof(val);
        else if (!strcmp(key, "cpu-used")) cpu_used = atoi(val);
        else if (!strcmp(key, "audio_rate")) audio_rate = atoi(val);
        else if (!strcmp(key, "channels")) channels = atoi(val);
        else if (!strcmp(key, "audio_secs")) audio_secs = atof(val);
        else if (!strcmp(key, "audio_kind")) audio_kind = atoi(val);
        else if (!strcmp(key, "content")) g_content = atoi(val);
        else if (!strcmp(key, "vorbis_q")) vorbis_q = atof(val);
        else if (!strcmp(key, "seed")) rng_state = (uint32_t)strtoul(val, 0, 0);
        else { fprintf(stderr, "unknown key %s\n", key); return 2; }
    }

    AVFormatContext *oc = NULL;
    int ret = avformat_alloc_output_context2(&oc, NULL, "webm", outpath);
    if (ret < 0) die("alloc output", ret);

    AVCodecContext *vc = NULL, *ac = NULL;
    AVStream *vst = NULL, *ast = NULL;

    if (frames > 0) {
        const AVCodec *codec = avcodec_find_encoder_by_name("libaom-av1");
        if (!codec) die("no libaom-av1", 0);
        vc = avcodec_alloc_context3(codec);
        vc->width = w; vc->height = h;
        vc->time_base = (AVRational){1, fps};
        vc->framerate = (AVRational){fps, 1};
        switch (ss * 100 + bitdepth) {
            case 42008: vc->pix_fmt = AV_PIX_FMT_YUV420P; break;
            case 42010: vc->pix_fmt = AV_PIX_FMT_YUV420P10LE; break;
            case 42012: vc->pix_fmt = AV_PIX_FMT_YUV420P12LE; break;
            case 42208: vc->pix_fmt = AV_PIX_FMT_YUV422P; break;
            case 42210: vc->pix_fmt = AV_PIX_FMT_YUV422P10LE; break;
            case 42212: vc->pix_fmt = AV_PIX_FMT_YUV422P12LE; break;
            case 44408: vc->pix_fmt = AV_PIX_FMT_YUV444P; break;
            case 44410: vc->pix_fmt = AV_PIX_FMT_YUV444P10LE; break;
            case 44412: vc->pix_fmt = AV_PIX_FMT_YUV444P12LE; break;
            case 40008: vc->pix_fmt = AV_PIX_FMT_GRAY8; break;
            case 40010: vc->pix_fmt = AV_PIX_FMT_GRAY10LE; break;
            case 40012: vc->pix_fmt = AV_PIX_FMT_GRAY12LE; break;
            default: die("bad ss/bitdepth combo", 0);
        }
        vc->gop_size = gop;
        vc->max_b_frames = 0;
        vc->thread_count = 1;
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            vc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        char buf[32];
        snprintf(buf, sizeof buf, "%d", cpu_used);
        av_opt_set(vc->priv_data, "cpu-used", buf, 0);
        snprintf(buf, sizeof buf, "%.0f", crf);
        av_opt_set(vc->priv_data, "crf", buf, 0);
        av_opt_set(vc->priv_data, "usage", "good", 0);
        av_opt_set(vc->priv_data, "lag-in-frames", "0", 0);
        for (int i = 0; i < n_vopts; i++) {
            char *eq = strchr(vopts[i], '=');
            if (!eq) continue;
            *eq = 0;
            ret = av_opt_set(vc->priv_data, vopts[i], eq + 1, 0);
            if (ret < 0) fprintf(stderr, "warning: vopt %s rejected\n", vopts[i]);
        }
        ret = avcodec_open2(vc, codec, NULL);
        if (ret < 0) die("open video codec", ret);
        vst = avformat_new_stream(oc, NULL);
        vst->time_base = (AVRational){1, 1000};
        avcodec_parameters_from_context(vst->codecpar, vc);
    }

    if (audio_secs > 0) {
        const AVCodec *codec = avcodec_find_encoder_by_name("libvorbis");
        if (!codec) die("no libvorbis", 0);
        ac = avcodec_alloc_context3(codec);
        ac->sample_rate = audio_rate;
        av_channel_layout_default(&ac->ch_layout, channels);
        ac->sample_fmt = AV_SAMPLE_FMT_FLTP;
        ac->time_base = (AVRational){1, audio_rate};
        ac->flags |= AV_CODEC_FLAG_QSCALE;
        ac->global_quality = (int)(vorbis_q * FF_QP2LAMBDA * 10);
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            ac->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        ret = avcodec_open2(ac, codec, NULL);
        if (ret < 0) die("open audio codec", ret);
        ast = avformat_new_stream(oc, NULL);
        ast->time_base = (AVRational){1, 1000};
        avcodec_parameters_from_context(ast->codecpar, ac);
    }

    ret = avio_open(&oc->pb, outpath, AVIO_FLAG_WRITE);
    if (ret < 0) die("avio_open", ret);
    ret = avformat_write_header(oc, NULL);
    if (ret < 0) die("write_header", ret);

    if (vc) {
        AVFrame *f = av_frame_alloc();
        f->format = vc->pix_fmt; f->width = w; f->height = h;
        av_frame_get_buffer(f, 0);
        for (int t = 0; t < frames; t++) {
            av_frame_make_writable(f);
            fill_frame(f, t, bitdepth);
            f->pts = t;
            encode_and_mux(oc, vc, vst, f);
        }
        encode_and_mux(oc, vc, vst, NULL);
        av_frame_free(&f);
    }

    if (ac) {
        int64_t total = (int64_t)(audio_secs * audio_rate);
        int fsize = ac->frame_size > 0 ? ac->frame_size : 1024;
        AVFrame *f = av_frame_alloc();
        f->format = ac->sample_fmt;
        av_channel_layout_copy(&f->ch_layout, &ac->ch_layout);
        f->sample_rate = audio_rate;
        f->nb_samples = fsize;
        av_frame_get_buffer(f, 0);
        int64_t pos = 0;
        while (pos < total) {
            av_frame_make_writable(f);
            int n = (int)(total - pos < fsize ? total - pos : fsize);
            f->nb_samples = n;
            for (int c = 0; c < channels; c++) {
                float *d = (float *)f->data[c];
                for (int i = 0; i < n; i++) {
                    double tt = (double)(pos + i) / audio_rate;
                    if (audio_kind == 1) {
                        /* transient-heavy: clicks + noise bursts force
                         * short-block decisions in the encoder */
                        long s = pos + i;
                        double burst = ((s / 3000) % 4 == 0)
                            ? ((double)(int32_t)rng() / 2147483648.0) * 0.5 : 0.0;
                        double click = (s % 4801 < 8) ? 0.9 : 0.0;
                        d[i] = (float)(burst + click
                                     + 0.1 * sin(2 * M_PI * (330 + 20 * c) * tt));
                    } else {
                        d[i] = (float)(0.4 * sin(2 * M_PI * (220 + 40 * c) * tt)
                                     + 0.2 * sin(2 * M_PI * (1000 + 150 * c) * tt + 0.3)
                                     + 0.05 * sin(2 * M_PI * 55 * tt * tt));
                    }
                }
            }
            f->pts = pos;
            pos += n;
            encode_and_mux(oc, ac, ast, f);
        }
        encode_and_mux(oc, ac, ast, NULL);
        av_frame_free(&f);
    }

    av_write_trailer(oc);
    avio_closep(&oc->pb);
    if (vc) avcodec_free_context(&vc);
    if (ac) avcodec_free_context(&ac);
    avformat_free_context(oc);
    return 0;
}
