/* oracle — reference decode of a WebM file via libdav1d + libvorbis.
 *
 * Test-infrastructure tool: produces golden outputs the easyav1 decoder
 * must match (bit-exact video for 8bpc, float tolerance audio — the
 * conformance contract from BASELINE.json / SURVEY.md §4).
 *
 * Usage: oracle in.webm outprefix
 * Writes:
 *   outprefix.json  metadata + per-frame index
 *   outprefix.yuv   concatenated tightly-packed planes, every video frame
 *   outprefix.f32   interleaved float32 PCM, all audio
 */
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/pixdesc.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static void die(const char *msg, int err) {
    char buf[256] = {0};
    if (err) av_strerror(err, buf, sizeof buf);
    fprintf(stderr, "oracle: %s (%s)\n", msg, buf);
    exit(1);
}

typedef struct { FILE *yuv, *pcm, *json; int vframes; long asamples;
                 int w, h, depth, ss_x, ss_y; int a_rate, a_ch;
                 int first; } Sink;

static void dump_video(Sink *s, AVFrame *f) {
    const AVPixFmtDescriptor *d = av_pix_fmt_desc_get(f->format);
    s->w = f->width; s->h = f->height;
    s->depth = d->comp[0].depth;
    s->ss_x = d->log2_chroma_w; s->ss_y = d->log2_chroma_h;
    int bytes = s->depth > 8 ? 2 : 1;
    /* ORACLE_PAD_ROWS=N: dump N extra sub-visible luma rows (N>>ss_y
     * chroma rows) per plane — diagnostic only.  Safe because dav1d
     * allocates pictures with 128-row-aligned height and the decoder
     * reconstructs + postfilters the full mi grid past the crop. */
    const char *padenv = getenv("ORACLE_PAD_ROWS");
    int pad = padenv ? atoi(padenv) : 0;
    for (int p = 0; p < 3; p++) {
        if (!f->data[p]) break;     /* monochrome: no chroma planes */
        int pw = p ? (f->width + (1 << s->ss_x) - 1) >> s->ss_x : f->width;
        int ph = p ? (f->height + (1 << s->ss_y) - 1) >> s->ss_y : f->height;
        ph += p ? pad >> s->ss_y : pad;
        for (int y = 0; y < ph; y++)
            fwrite(f->data[p] + y * f->linesize[p], bytes, pw, s->yuv);
    }
    fprintf(s->json, "%s{\"pts\": %lld, \"key\": %d}",
            s->first ? "" : ",\n    ", (long long)f->pts,
            f->key_frame);
    s->first = 0;
    s->vframes++;
}

static void dump_audio(Sink *s, AVFrame *f) {
    s->a_rate = f->sample_rate;
    s->a_ch = f->ch_layout.nb_channels;
    if (f->format == AV_SAMPLE_FMT_FLT) {
        fwrite(f->data[0], 4, (size_t)f->nb_samples * s->a_ch, s->pcm);
    } else if (f->format == AV_SAMPLE_FMT_FLTP) {
        for (int i = 0; i < f->nb_samples; i++)
            for (int c = 0; c < s->a_ch; c++)
                fwrite((float *)f->data[c] + i, 4, 1, s->pcm);
    } else {
        die("unexpected audio sample format", 0);
    }
    s->asamples += f->nb_samples;
}

static void drain(AVCodecContext *cc, Sink *s, int is_video) {
    AVFrame *f = av_frame_alloc();
    int ret;
    while ((ret = avcodec_receive_frame(cc, f)) >= 0) {
        if (is_video) dump_video(s, f); else dump_audio(s, f);
        av_frame_unref(f);
    }
    av_frame_free(&f);
    if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) die("receive_frame", ret);
}

int main(int argc, char **argv) {
    if (argc != 3) { fprintf(stderr, "usage: oracle in.webm outprefix\n"
                             "       (outprefix '-' = decode only, no"
                             " output files; for fair benchmarking)\n");
        return 2; }
    int no_out = argv[2][0] == '-' && argv[2][1] == 0;
    AVFormatContext *ic = NULL;
    int ret = avformat_open_input(&ic, argv[1], NULL, NULL);
    if (ret < 0) die("open input", ret);
    ret = avformat_find_stream_info(ic, NULL);
    if (ret < 0) die("stream info", ret);

    AVCodecContext *vc = NULL, *ac = NULL;
    int vidx = -1, aidx = -1;
    for (unsigned i = 0; i < ic->nb_streams; i++) {
        AVCodecParameters *par = ic->streams[i]->codecpar;
        if (par->codec_id == AV_CODEC_ID_AV1 && vidx < 0) {
            /* ORACLE_AV1_DECODER=libaom-av1 arbitrates suspected
               libdav1d bugs with a second independent decoder */
            const char *name = getenv("ORACLE_AV1_DECODER");
            if (!name) name = "libdav1d";
            const AVCodec *dec = avcodec_find_decoder_by_name(name);
            if (!dec) die("no av1 decoder", 0);
            vc = avcodec_alloc_context3(dec);
            avcodec_parameters_to_context(vc, par);
            vc->thread_count = 1;
            ret = avcodec_open2(vc, dec, NULL);
            if (ret < 0) die("open dav1d", ret);
            vidx = (int)i;
        } else if (par->codec_id == AV_CODEC_ID_VORBIS && aidx < 0) {
            const AVCodec *dec = avcodec_find_decoder_by_name("vorbis");
            if (!dec) die("no vorbis decoder", 0);
            ac = avcodec_alloc_context3(dec);
            avcodec_parameters_to_context(ac, par);
            ret = avcodec_open2(ac, dec, NULL);
            if (ret < 0) die("open vorbis", ret);
            aidx = (int)i;
        }
    }

    char path[1024];
    Sink s = {0};
    s.first = 1;
    if (no_out) {
        s.yuv = fopen("/dev/null", "wb");
        s.pcm = fopen("/dev/null", "wb");
    } else {
        snprintf(path, sizeof path, "%s.yuv", argv[2]); s.yuv = fopen(path, "wb");
        snprintf(path, sizeof path, "%s.f32", argv[2]); s.pcm = fopen(path, "wb");
    }
    if (no_out) s.json = fopen("/dev/null", "w");
    else { snprintf(path, sizeof path, "%s.json", argv[2]);
           s.json = fopen(path, "w"); }
    fprintf(s.json, "{\n  \"frames\": [");

    AVPacket *pkt = av_packet_alloc();
    while (av_read_frame(ic, pkt) >= 0) {
        if (pkt->stream_index == vidx && vc) {
            /* rescale pts to ms for comparison with easyav1 semantics */
            pkt->pts = av_rescale_q(pkt->pts, ic->streams[vidx]->time_base,
                                    (AVRational){1, 1000});
            ret = avcodec_send_packet(vc, pkt);
            if (ret < 0) die("send v packet", ret);
            drain(vc, &s, 1);
        } else if (pkt->stream_index == aidx && ac) {
            ret = avcodec_send_packet(ac, pkt);
            if (ret < 0) die("send a packet", ret);
            drain(ac, &s, 0);
        }
        av_packet_unref(pkt);
    }
    if (vc) { avcodec_send_packet(vc, NULL); drain(vc, &s, 1); }
    if (ac) { avcodec_send_packet(ac, NULL); drain(ac, &s, 0); }

    fprintf(s.json, "],\n");
    fprintf(s.json, "  \"width\": %d, \"height\": %d, \"depth\": %d,\n"
            "  \"ss_x\": %d, \"ss_y\": %d, \"vframes\": %d,\n"
            "  \"a_rate\": %d, \"a_ch\": %d, \"asamples\": %ld\n}\n",
            s.w, s.h, s.depth, s.ss_x, s.ss_y, s.vframes,
            s.a_rate, s.a_ch, s.asamples);
    fclose(s.json); fclose(s.yuv); fclose(s.pcm);
    av_packet_free(&pkt);
    if (vc) avcodec_free_context(&vc);
    if (ac) avcodec_free_context(&ac);
    avformat_close_input(&ic);
    return 0;
}
