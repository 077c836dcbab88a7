/* Decode benchmark over the easyav1 C API.
 *
 * Methodology parity with the reference benchmark tool
 * (reference tools/easyav1_benchmark.c:79-185): video only, audio
 * disabled, every frame decoded, monotonic wall clock; reports average
 * fps, the realtime multiple (video length / decode time) and the
 * slowest frame.  Re-implemented from scratch against our capi header.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "../easyav1/capi/easyav1.h"

static double now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000.0 + ts.tv_nsec / 1e6;
}

static void usage(const char *argv0) {
    fprintf(stderr,
            "usage: %s [options] file.webm\n"
            "  -a, --audio       decode the audio track too\n"
            "  -t, --track N     video track to decode (default 0)\n"
            "  -q, --quiet       no 1 Hz progress line\n"
            "  -L, --log-level N library log level 0..2\n", argv0);
}

int main(int argc, char **argv) {
    const char *path = NULL;
    int quiet = 0;
    easyav1_settings s = easyav1_default_settings();
    s.enable_audio = EASYAV1_FALSE;
    s.skip_unprocessed_frames = EASYAV1_FALSE;
    s.log_level = EASYAV1_LOG_LEVEL_ERROR;
    for (int i = 1; i < argc; i++) {
        const char *a = argv[i];
        if (!strcmp(a, "-a") || !strcmp(a, "--audio")) {
            s.enable_audio = EASYAV1_TRUE;
        } else if ((!strcmp(a, "-t") || !strcmp(a, "--track"))
                   && i + 1 < argc) {
            s.video_track = (unsigned)atoi(argv[++i]);
        } else if (!strcmp(a, "-q") || !strcmp(a, "--quiet")) {
            quiet = 1;
        } else if ((!strcmp(a, "-L") || !strcmp(a, "--log-level"))
                   && i + 1 < argc) {
            s.log_level = (easyav1_log_level_t)atoi(argv[++i]);
        } else if (!strcmp(a, "-h") || !strcmp(a, "--help")) {
            usage(argv[0]);
            return 0;
        } else if (a[0] != '-') {
            path = a;
        } else {
            usage(argv[0]);
            return 2;
        }
    }
    if (!path) {
        usage(argv[0]);
        return 2;
    }

    easyav1_t *av = easyav1_init_from_filename(path, &s);
    if (!av) {
        fprintf(stderr, "failed to open %s\n", path);
        return 1;
    }
    easyav1_timestamp duration = easyav1_get_duration(av);
    printf("file: %s\n", path);
    printf("video: %ux%u @ %u fps, %llu ms\n",
           easyav1_get_video_width(av), easyav1_get_video_height(av),
           easyav1_get_video_fps(av), (unsigned long long)duration);

    double start = now_ms();
    double slowest = 0.0;
    uint64_t slowest_frame = 0;
    easyav1_timestamp slowest_ts = 0;
    uint64_t frames = 0;

    double last_report = start;
    while (easyav1_get_status(av) == EASYAV1_STATUS_OK) {
        double t0 = now_ms();
        if (easyav1_decode_next(av) != EASYAV1_STATUS_OK)
            break;
        double el = now_ms() - t0;
        frames = easyav1_get_total_video_frames_processed(av);
        if (el > slowest) {
            slowest = el;
            slowest_frame = frames;
            slowest_ts = easyav1_get_current_timestamp(av);
        }
        /* 1 Hz progress (reference easyav1_benchmark.c:135-155) */
        if (!quiet && t0 + el - last_report >= 1000.0) {
            last_report = t0 + el;
            double so_far = (t0 + el - start) / 1000.0;
            printf("\rdecoded %llu frames in %.1f s (%.2f fps, %.3lfx)  ",
                   (unsigned long long)frames, so_far,
                   frames / so_far,
                   easyav1_get_current_timestamp(av)
                       / ((t0 + el - start)));
            fflush(stdout);
        }
    }
    double total = now_ms() - start;
    if (!quiet) printf("\r%*s\r", 64, "");

    printf("frames decoded: %llu\n", (unsigned long long)frames);
    printf("total time: %.0f ms\n", total);
    printf("average fps: %.2f\n", frames / (total / 1000.0));
    printf("realtime multiple: %.3lfx\n", duration / total);
    printf("slowest frame: #%llu at %llu ms took %.2f ms\n",
           (unsigned long long)slowest_frame,
           (unsigned long long)slowest_ts, slowest);

    easyav1_destroy(&av);
    return 0;
}
