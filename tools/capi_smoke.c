/* C ABI smoke test: exercises the easyav1.h surface end-to-end
 * (init, metadata, decode, pull + push frames, seek, settings,
 * destroy).  Run by tests/test_capi.py; prints key=value lines. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "../easyav1/capi/easyav1.h"

static int g_video_cb_frames = 0;
static int g_audio_cb_frames = 0;
static unsigned long long g_luma_sum = 0;

static void on_video(const easyav1_video_frame *f, void *ud) {
    (void)ud;
    g_video_cb_frames++;
    const unsigned char *y = (const unsigned char *)f->data[0];
    for (unsigned int r = 0; r < f->properties.height; r += 16)
        g_luma_sum += y[r * f->stride[0]];
}

static void on_audio(const easyav1_audio_frame *f, void *ud) {
    (void)ud;
    (void)f;
    g_audio_cb_frames++;
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s file.webm\n", argv[0]);
        return 2;
    }
    easyav1_settings s = easyav1_default_settings();
    s.callbacks.video = on_video;
    s.callbacks.audio = on_audio;

    easyav1_t *av = easyav1_init_from_filename(argv[1], &s);
    if (!av) {
        fprintf(stderr, "init failed\n");
        return 1;
    }
    printf("has_video=%d\n", easyav1_has_video_track(av));
    printf("has_audio=%d\n", easyav1_has_audio_track(av));
    printf("width=%u\n", easyav1_get_video_width(av));
    printf("height=%u\n", easyav1_get_video_height(av));
    printf("fps=%u\n", easyav1_get_video_fps(av));
    printf("duration=%llu\n",
           (unsigned long long)easyav1_get_duration(av));
    printf("sample_rate=%u\n", easyav1_get_audio_sample_rate(av));
    printf("channels=%u\n", easyav1_get_audio_channels(av));

    /* decode everything frame by frame (decode_until from 0 would hit
       the >1s catch-up fast-seek, by design) */
    easyav1_status st = EASYAV1_STATUS_OK;
    while (st == EASYAV1_STATUS_OK)
        st = easyav1_decode_next(av);
    printf("decode_status=%d\n", (int)st);
    printf("video_cb_frames=%d\n", g_video_cb_frames);
    printf("audio_cb_frames=%d\n", g_audio_cb_frames);
    printf("luma_sum=%llu\n", g_luma_sum);
    printf("frames_processed=%llu\n",
           (unsigned long long)easyav1_get_total_video_frames_processed(av));

    /* pull path after a seek back to the start; push callbacks are
       cleared first — with a video callback registered, decode_next's
       push delivery pops the frame queue (reference callback_video,
       easyav1.c:2192-2205) and the pull path would see nothing */
    easyav1_settings snocb = easyav1_get_current_settings(av);
    snocb.callbacks.video = NULL;
    snocb.callbacks.audio = NULL;
    easyav1_update_settings(av, &snocb);
    st = easyav1_seek_to_timestamp(av, 0);
    printf("seek_status=%d\n", (int)st);
    while (st == EASYAV1_STATUS_OK &&
           easyav1_has_video_frame(av) == EASYAV1_FALSE)
        st = easyav1_decode_next(av);
    const easyav1_video_frame *vf = easyav1_get_video_frame(av);
    printf("pull_frame=%d\n", vf != NULL);
    if (vf) {
        printf("pull_w=%u pull_h=%u layout=%d\n", vf->properties.width,
               vf->properties.height, (int)vf->properties.pixel_layout);
    }
    printf("finished=%d\n", easyav1_is_finished(av));

    /* memory init path */
    FILE *f = fopen(argv[1], "rb");
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    void *buf = malloc((size_t)sz);
    if (fread(buf, 1, (size_t)sz, f) != (size_t)sz) return 1;
    fclose(f);
    easyav1_settings s2 = easyav1_default_settings();
    easyav1_t *av2 = easyav1_init_from_memory(buf, (size_t)sz, &s2);
    free(buf);
    printf("mem_init=%d\n", av2 != NULL);
    if (av2) {
        printf("mem_width=%u\n", easyav1_get_video_width(av2));
        easyav1_destroy(&av2);
    }

    easyav1_destroy(&av);
    printf("destroyed=%d\n", av == NULL);
    return 0;
}
