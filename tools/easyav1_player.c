/* easyav1_player — interactive player over the easyav1 C ABI.
 *
 * Two video sinks, selected at compile time:
 *
 *   default            terminal sink: headless-friendly interactive
 *                      playback — wall-clock paced decode through
 *                      easyav1_play(), a live status line, stdin
 *                      commands (space pause/resume, 0-9 seek to N*10%,
 *                      f/b seek +/-10 s, l toggle loop, q quit), and an
 *                      optional normative Y4M dump (--dump out.y4m) so
 *                      the rendered output is verifiable bit-by-bit.
 *
 *   -DPLAYER_BACKEND_SDL3   SDL3 window + streaming YUV texture +
 *                      audio stream with the same control flow
 *                      (keyboard seek/pause, click-to-seek progress
 *                      bar, fullscreen toggle, loop-at-end).
 *
 * Parity targets in the reference player (tools/easyav1_player.c):
 * CLI flag table (:141-159), custom stream IO (:272-334), texture +
 * colorspace propagation (:480-659), seek/pause state machine
 * (:841-1120), main loop incl. loop-at-end (:1245-1381).  The code
 * here is written fresh against our capi/easyav1.h.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <time.h>

#include "../easyav1/capi/easyav1.h"

#ifdef PLAYER_BACKEND_SDL3
#include <SDL3/SDL.h>
#endif

#ifndef _WIN32
#include <fcntl.h>
#include <termios.h>
#include <unistd.h>
#endif

#include "player_ui.h"

typedef struct {
    const char *filename;
    const char *dump_path;
    int displaying_help;
    int ui_selftest;
    int loop;
    int fullscreen;
    int keep_aspect_ratio;
    int disable_audio;
    int disable_video;
    int use_fast_seek;
    int audio_track;
    int video_track;
    int audio_offset;
    int log_level;
    int max_seconds;          /* terminal sink: stop after N s (tests) */
} player_options;

typedef enum { OPTION_TYPE_BOOL, OPTION_TYPE_INT, OPTION_TYPE_STR } option_type;

static struct {
    player_options options;
    easyav1_t *av1;
    easyav1_stream stream;
    FILE *file;
    FILE *dump;
    int dump_header_written;
    uint64_t audio_bytes;
    uint64_t audio_frames;
    int paused;
    int quit;
} P;

static const struct {
    const char *name;
    const char *abbr;
    option_type type;
    void *value;
    const char *description;
} option_list[] = {
    { "help", "h", OPTION_TYPE_BOOL, &P.options.displaying_help,
      "Display this help message and exit." },
    { "loop", "l", OPTION_TYPE_BOOL, &P.options.loop,
      "If set, video will loop back to the beginning when it finishes." },
    { "fullscreen", "f", OPTION_TYPE_BOOL, &P.options.fullscreen,
      "Start in fullscreen mode." },
    { "keep_aspect_ratio", "ar", OPTION_TYPE_BOOL, &P.options.keep_aspect_ratio,
      "Keep the video's original aspect ratio regardless of window size." },
    { "disable_audio", "da", OPTION_TYPE_BOOL, &P.options.disable_audio,
      "If set, audio will not play." },
    { "disable_video", "dv", OPTION_TYPE_BOOL, &P.options.disable_video,
      "If set, video will not play." },
    { "use_fast_seek", "fs", OPTION_TYPE_BOOL, &P.options.use_fast_seek,
      "Whether to use a faster, but less accurate, seeking." },
    { "audio_track", "at", OPTION_TYPE_INT, &P.options.audio_track,
      "The audio track to use. If the track doesn't exist, no audio will play." },
    { "video_track", "vt", OPTION_TYPE_INT, &P.options.video_track,
      "The video track to use. If the track doesn't exist, no video will play." },
    { "audio_offset", "ao", OPTION_TYPE_INT, &P.options.audio_offset,
      "Offset in milliseconds between audio and video." },
    { "log-level", "L", OPTION_TYPE_INT, &P.options.log_level,
      "The log level: 0 - default, 1 - errors, 2 - warnings, 3 - info" },
    { "dump", "d", OPTION_TYPE_STR, &P.options.dump_path,
      "Write decoded video to a Y4M file (terminal sink only)." },
    { "ui-selftest", "ui", OPTION_TYPE_BOOL, &P.options.ui_selftest,
      "Run the UI overlay selftest (state machine + font + morph) and exit" },
    { "max_seconds", "ms", OPTION_TYPE_INT, &P.options.max_seconds,
      "Stop playback after this many seconds (0 = play to the end)." },
};

#define OPTION_COUNT (sizeof(option_list) / sizeof(option_list[0]))

static const char *parse_file_name(const char *argv_name)
{
    const char *n = strrchr(argv_name, '/');
    return n ? n + 1 : argv_name;
}

static void display_help(const char *argv_name)
{
    printf("Usage: %s [OPTIONS] <file.webm>\n\nOptions:\n",
           parse_file_name(argv_name));
    for (size_t i = 0; i < OPTION_COUNT; i++) {
        printf("  --%-18s -%-3s %s\n", option_list[i].name,
               option_list[i].abbr, option_list[i].description);
    }
    printf("\nTerminal controls: space=pause/resume  0-9=seek to N*10%%"
           "  f/b=seek +/-10s  l=toggle loop  q=quit\n");
}

static int parse_options(int argc, char **argv)
{
    for (int count = 1; count < argc; count++) {
        if (argv[count][0] != '-') {
            if (count != argc - 1) {
                printf("Unknown argument: \"%s\".\n", argv[count]);
                return 0;
            }
            P.options.filename = argv[count];
            continue;
        }
        int found = 0;
        for (size_t i = 0; i < OPTION_COUNT; i++) {
            int is_long = argv[count][1] == '-' &&
                strcmp(&argv[count][2], option_list[i].name) == 0;
            int is_abbr = strcmp(&argv[count][1], option_list[i].abbr) == 0;
            if (!is_long && !is_abbr) {
                continue;
            }
            found = 1;
            if (option_list[i].type == OPTION_TYPE_BOOL) {
                *(int *)option_list[i].value = 1;
            } else {
                if (count == argc - 1) {
                    printf("Option %s requires an argument.\n", argv[count]);
                    return 0;
                }
                count++;
                if (option_list[i].type == OPTION_TYPE_INT) {
                    *(int *)option_list[i].value = atoi(argv[count]);
                } else {
                    *(const char **)option_list[i].value = argv[count];
                }
            }
            break;
        }
        if (!found) {
            printf("Unknown argument: \"%s\".\nUse \"--help\" for help.\n",
                   argv[count]);
            return 0;
        }
    }
    return 1;
}

/* -- custom stream over stdio (parity: reference SDL_IOStream bridge) */

static int stream_read(void *buffer, size_t size, void *userdata)
{
    FILE *f = (FILE *)userdata;
    return fread(buffer, 1, size, f) == size ? 1 : 0;
}

static int stream_seek(int64_t offset, int origin, void *userdata)
{
    /* 0 on success, -1 on error (reference stream contract) */
    return fseeko((FILE *)userdata, (off_t)offset, origin) == 0 ? 0 : -1;
}

static int64_t stream_tell(void *userdata)
{
    return (int64_t)ftello((FILE *)userdata);
}

/* -- audio sink ------------------------------------------------------ */

#ifdef PLAYER_BACKEND_SDL3
static SDL_AudioStream *g_audio_stream;
#endif

static void audio_callback(const easyav1_audio_frame *frame, void *userdata)
{
    (void)userdata;
    P.audio_bytes += frame->bytes;
    P.audio_frames++;
#ifdef PLAYER_BACKEND_SDL3
    if (g_audio_stream) {
        SDL_PutAudioStreamData(g_audio_stream, frame->pcm.interlaced,
                               (int)frame->bytes);
    }
#endif
}

static int init_easyav1(void)
{
    easyav1_settings settings = easyav1_default_settings();
    settings.callbacks.audio = audio_callback;
    settings.audio_offset_time = P.options.audio_offset;
    settings.video_track = P.options.video_track;
    settings.audio_track = P.options.audio_track;
    settings.enable_audio = !P.options.disable_audio;
    settings.enable_video = !P.options.disable_video;
    settings.use_fast_seeking = P.options.use_fast_seek;
    if (P.options.log_level > 0) {
        if (P.options.log_level > 4) {
            P.options.log_level = 4;
        }
        settings.log_level = (easyav1_log_level_t)(P.options.log_level - 1);
    }

    P.file = fopen(P.options.filename, "rb");
    if (!P.file) {
        printf("Cannot open \"%s\".\n", P.options.filename);
        return 0;
    }
    P.stream.read_func = stream_read;
    P.stream.seek_func = stream_seek;
    P.stream.tell_func = stream_tell;
    P.stream.userdata = P.file;

    P.av1 = easyav1_init_from_custom_stream(&P.stream, &settings);
    if (!P.av1) {
        fclose(P.file);
        return 0;
    }
    return 1;
}

static uint64_t now_ms(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

static void fmt_timestamp(easyav1_timestamp ts, char *buf, size_t size)
{
    unsigned s = (unsigned)(ts / 1000);
    snprintf(buf, size, "%u:%02u:%02u.%03u", s / 3600, (s / 60) % 60,
             s % 60, (unsigned)(ts % 1000));
}

/* -- Y4M dump (terminal sink) ---------------------------------------- */

static void dump_frame(const easyav1_video_frame *frame)
{
    if (!P.dump) {
        return;
    }
    unsigned w = frame->properties.width, h = frame->properties.height;
    int hbd = frame->properties.bits_per_color != EASYAV1_BITS_PER_COLOR_8;
    int bits = frame->properties.bits_per_color == EASYAV1_BITS_PER_COLOR_10
        ? 10 : (frame->properties.bits_per_color ==
                EASYAV1_BITS_PER_COLOR_12 ? 12 : 8);
    unsigned ssx = 1, ssy = 1;
    const char *cs = "420";
    switch (frame->properties.pixel_layout) {
        case EASYAV1_PIXEL_LAYOUT_YUV422: cs = "422"; ssy = 0; break;
        case EASYAV1_PIXEL_LAYOUT_YUV444: cs = "444"; ssx = ssy = 0; break;
        case EASYAV1_PIXEL_LAYOUT_YUV400: cs = "mono"; break;
        default: break;
    }
    if (!P.dump_header_written) {
        if (bits > 8) {
            fprintf(P.dump, "YUV4MPEG2 W%u H%u F30:1 Ip A1:1 C%sp%d\n",
                    w, h, cs, bits);
        } else {
            fprintf(P.dump, "YUV4MPEG2 W%u H%u F30:1 Ip A1:1 C%s\n", w, h,
                    cs);
        }
        P.dump_header_written = 1;
    }
    fprintf(P.dump, "FRAME\n");
    int mono = frame->properties.pixel_layout == EASYAV1_PIXEL_LAYOUT_YUV400;
    for (int p = 0; p < (mono ? 1 : 3); p++) {
        unsigned pw = p ? (w + ssx) >> ssx : w;
        unsigned ph = p ? (h + ssy) >> ssy : h;
        size_t row = (size_t)pw * (hbd ? 2 : 1);
        const uint8_t *src = (const uint8_t *)frame->data[p];
        for (unsigned y = 0; y < ph; y++) {
            fwrite(src + y * frame->stride[p], 1, row, P.dump);
        }
    }
}

#ifndef PLAYER_BACKEND_SDL3

/* -- terminal sink ---------------------------------------------------- */

#ifndef _WIN32
static struct termios g_term_saved;
static int g_term_raw;

static void term_raw_enable(void)
{
    if (!isatty(STDIN_FILENO)) {
        return;
    }
    if (tcgetattr(STDIN_FILENO, &g_term_saved) != 0) {
        return;
    }
    struct termios raw = g_term_saved;
    raw.c_lflag &= ~(ICANON | ECHO);
    raw.c_cc[VMIN] = 0;
    raw.c_cc[VTIME] = 0;
    if (tcsetattr(STDIN_FILENO, TCSANOW, &raw) == 0) {
        g_term_raw = 1;
    }
}

static void term_raw_disable(void)
{
    if (g_term_raw) {
        tcsetattr(STDIN_FILENO, TCSANOW, &g_term_saved);
    }
}

static int term_read_key(void)
{
    int flags = fcntl(STDIN_FILENO, F_GETFL, 0);
    fcntl(STDIN_FILENO, F_SETFL, flags | O_NONBLOCK);
    unsigned char c;
    ssize_t n = read(STDIN_FILENO, &c, 1);
    fcntl(STDIN_FILENO, F_SETFL, flags);
    return n == 1 ? c : -1;
}
#else
static void term_raw_enable(void) {}
static void term_raw_disable(void) {}
static int term_read_key(void) { return -1; }
#endif

static void handle_key(int key)
{
    easyav1_timestamp dur = easyav1_get_duration(P.av1);
    switch (key) {
        case ' ':
        case 'p':
            P.paused = !P.paused;
            if (P.paused) {
                easyav1_stop(P.av1);
            } else {
                easyav1_play(P.av1);
            }
            break;
        case 'f':
            easyav1_seek_forward(P.av1, 10000);
            break;
        case 'b':
            easyav1_seek_backward(P.av1, 10000);
            break;
        case 'l':
            P.options.loop = !P.options.loop;
            break;
        case 'q':
        case 3:                       /* ctrl-c in raw mode */
            P.quit = 1;
            break;
        default:
            if (key >= '0' && key <= '9' && dur > 0) {
                easyav1_seek_to_timestamp(P.av1, dur * (key - '0') / 10);
            }
            break;
    }
}

static int run_player(void)
{
    term_raw_enable();
    if (P.options.dump_path) {
        P.dump = fopen(P.options.dump_path, "wb");
        if (!P.dump) {
            printf("Cannot open dump file \"%s\".\n", P.options.dump_path);
        }
    }

    if (P.dump) {
        /* Dump mode is the deterministic conformance harness: drive
           decode_next directly (every frame, no wall-clock pacing) so
           the Y4M output is bit-exact regardless of host stalls.  The
           interactive path below still exercises easyav1_play(). */
        uint64_t frames = 0;
        while (!P.quit && !easyav1_is_finished(P.av1) &&
               easyav1_get_status(P.av1) != EASYAV1_STATUS_ERROR) {
            if (easyav1_decode_next(P.av1) != EASYAV1_STATUS_OK) {
                break;
            }
            const easyav1_video_frame *frame =
                easyav1_get_video_frame(P.av1);
            if (frame) {
                frames++;
                dump_frame(frame);
            }
        }
        char cur2[32];
        fmt_timestamp(easyav1_get_current_timestamp(P.av1), cur2,
                      sizeof cur2);
        printf("played=%s frames=%llu audio_cb_frames=%llu "
               "audio_bytes=%llu\n",
               cur2, (unsigned long long)frames,
               (unsigned long long)P.audio_frames,
               (unsigned long long)P.audio_bytes);
        fclose(P.dump);
        term_raw_disable();
        return 0;
    }

    if (easyav1_play(P.av1) != EASYAV1_STATUS_OK) {
        term_raw_disable();
        return 6;
    }

    unsigned fps = easyav1_get_video_fps(P.av1);
    if (fps == 0) {
        fps = 30;
    }
    uint64_t min_loop_ms = 500 / fps;
    if (min_loop_ms == 0) {
        min_loop_ms = 1;
    }
    uint64_t frames = 0;
    uint64_t start = now_ms(), last_status = 0;
    char cur[32], tot[32];
    fmt_timestamp(easyav1_get_duration(P.av1), tot, sizeof tot);

    while (!P.quit) {
        int key;
        while ((key = term_read_key()) >= 0) {
            handle_key(key);
        }

        if (easyav1_get_status(P.av1) == EASYAV1_STATUS_ERROR) {
            break;
        }

        if (easyav1_has_video_track(P.av1)) {
            const easyav1_video_frame *frame = easyav1_get_video_frame(P.av1);
            if (frame) {
                frames++;
                dump_frame(frame);
            }
        }

        uint64_t t = now_ms();
        if (t - last_status >= 250) {
            fmt_timestamp(easyav1_get_current_timestamp(P.av1), cur,
                          sizeof cur);
            fprintf(stderr, "\r[%s / %s] frames=%llu audio_cb=%llu%s   ",
                    cur, tot, (unsigned long long)frames,
                    (unsigned long long)P.audio_frames,
                    P.paused ? " [paused]" : "");
            last_status = t;
        }

        if (P.options.max_seconds > 0 &&
            t - start >= (uint64_t)P.options.max_seconds * 1000) {
            P.quit = 1;
        }

        struct timespec req = { 0, (long)min_loop_ms * 1000000L };
        nanosleep(&req, NULL);

        if (easyav1_is_finished(P.av1)) {
            if (P.options.loop && !P.quit) {
                easyav1_seek_to_timestamp(P.av1, 0);
            } else {
                break;
            }
        }
    }

    easyav1_stop(P.av1);
    fmt_timestamp(easyav1_get_current_timestamp(P.av1), cur, sizeof cur);
    fprintf(stderr, "\n");
    printf("played=%s frames=%llu audio_cb_frames=%llu audio_bytes=%llu\n",
           cur, (unsigned long long)frames,
           (unsigned long long)P.audio_frames,
           (unsigned long long)P.audio_bytes);
    if (P.dump) {
        fclose(P.dump);
    }
    term_raw_disable();
    return 0;
}

#else  /* PLAYER_BACKEND_SDL3 */

/* -- SDL3 sink (mirrors the reference player's SDL path) -------------- */

static struct {
    SDL_Window *window;
    SDL_Renderer *renderer;
    SDL_Texture *video;
    unsigned tex_w, tex_h;
    ui_timebar tb;           /* animated time bar (player_ui.h) */
    float morph;             /* 0 = play icon, 1 = pause icon */
    int scrubbing;           /* pointer held on the bar */
    int activity;            /* pointer moved this tick */
} S;

#define TB_HEIGHT 28.0f
#define TB_ICON 18.0f

static SDL_Colorspace frame_colorspace(const easyav1_video_frame *f)
{
    SDL_ColorRange range =
        f->properties.color_space == EASYAV1_COLOR_SPACE_FULL
        ? SDL_COLOR_RANGE_FULL : SDL_COLOR_RANGE_LIMITED;
    SDL_ColorPrimaries prim = SDL_COLOR_PRIMARIES_BT709;
    SDL_TransferCharacteristics tc = SDL_TRANSFER_CHARACTERISTICS_BT709;
    SDL_MatrixCoefficients mtx = SDL_MATRIX_COEFFICIENTS_BT709;
    switch (f->properties.color_primaries) {
        case EASYAV1_COLOR_PRIMARIES_BT601:
            prim = SDL_COLOR_PRIMARIES_BT601; break;
        case EASYAV1_COLOR_PRIMARIES_BT2020:
            prim = SDL_COLOR_PRIMARIES_BT2020; break;
        default: break;
    }
    switch (f->properties.matrix_coefficients) {
        case EASYAV1_MATRIX_COEFFICIENTS_BT601:
            mtx = SDL_MATRIX_COEFFICIENTS_BT601; break;
        case EASYAV1_MATRIX_COEFFICIENTS_BT2020_NCL:
            mtx = SDL_MATRIX_COEFFICIENTS_BT2020_NCL; break;
        default: break;
    }
    return SDL_DEFINE_COLORSPACE(SDL_COLOR_TYPE_YCBCR, range, prim, tc,
                                 mtx, SDL_CHROMA_LOCATION_LEFT);
}

static void ensure_texture(const easyav1_video_frame *f)
{
    if (S.video && S.tex_w == f->properties.width &&
        S.tex_h == f->properties.height) {
        return;
    }
    if (S.video) {
        SDL_DestroyTexture(S.video);
        S.video = NULL;
    }
    /* SDL textures handle YUV420 8-bit; other layouts are skipped,
     * matching the reference player's limitation */
    if (f->properties.pixel_layout != EASYAV1_PIXEL_LAYOUT_YUV420 ||
        f->properties.bits_per_color != EASYAV1_BITS_PER_COLOR_8) {
        return;
    }
    SDL_PropertiesID props = SDL_CreateProperties();
    SDL_SetNumberProperty(props, SDL_PROP_TEXTURE_CREATE_FORMAT_NUMBER,
                          SDL_PIXELFORMAT_IYUV);
    SDL_SetNumberProperty(props, SDL_PROP_TEXTURE_CREATE_ACCESS_NUMBER,
                          SDL_TEXTUREACCESS_STREAMING);
    SDL_SetNumberProperty(props, SDL_PROP_TEXTURE_CREATE_WIDTH_NUMBER,
                          f->properties.width);
    SDL_SetNumberProperty(props, SDL_PROP_TEXTURE_CREATE_HEIGHT_NUMBER,
                          f->properties.height);
    SDL_SetNumberProperty(props, SDL_PROP_TEXTURE_CREATE_COLORSPACE_NUMBER,
                          frame_colorspace(f));
    S.video = SDL_CreateTextureWithProperties(S.renderer, props);
    SDL_DestroyProperties(props);
    S.tex_w = f->properties.width;
    S.tex_h = f->properties.height;
}

/* rasterize UI text via per-pixel rects (tiny overlay, fine at 60fps) */
static void sdl_draw_text(float x, float y, int scale, const char *text)
{
    for (const char *pch = text; *pch; pch++) {
        const uint8_t *g = ui_glyph(*pch);
        if (g) {
            for (int r = 0; r < UI_FONT_H; r++)
                for (int c = 0; c < UI_FONT_W; c++)
                    if ((g[r] >> c) & 1) {
                        SDL_FRect px = { x + (float)(c * scale),
                                         y + (float)(r * scale),
                                         (float)scale, (float)scale };
                        SDL_RenderFillRect(S.renderer, &px);
                    }
        }
        x += (float)((UI_FONT_W + 1) * scale);
    }
}

static void sdl_fill_quad(const ui_quad *q)
{
    int xa = (int)(q->x0 + 0.5f), xb = (int)(q->x1 + 0.5f);
    if (xb <= xa) xb = xa + 1;
    for (int x = xa; x < xb; x++) {
        float f = (float)(x - xa) / (float)(xb - xa);
        float yt = q->yt0 + (q->yt1 - q->yt0) * f;
        float yb = q->yb0 + (q->yb1 - q->yb0) * f;
        SDL_FRect col = { (float)x, yt, 1.0f, yb - yt };
        SDL_RenderFillRect(S.renderer, &col);
    }
}

/* animated time bar: slide-in band with play/pause morph icon,
 * HH:MM:SS / duration overlay and a click+drag scrub area (reference
 * easyav1_player.c:922-1120 feature set, fresh geometry) */
static void draw_time_bar(void)
{
    easyav1_timestamp dur = easyav1_get_duration(P.av1);
    if (dur == 0) {
        return;
    }
    float pos = ui_timebar_step(&S.tb, SDL_GetTicks(), S.activity,
                                P.paused || S.scrubbing);
    S.activity = 0;
    /* play/pause morph eases toward its target every frame */
    float target = P.paused ? 0.0f : 1.0f;
    S.morph += (target - S.morph) * 0.25f;
    if (pos <= 0.0f) {
        return;
    }
    int w, h;
    SDL_GetWindowSize(S.window, &w, &h);
    float top = (float)h - TB_HEIGHT * pos;
    SDL_SetRenderDrawBlendMode(S.renderer, SDL_BLENDMODE_BLEND);
    SDL_FRect band = { 0, top, (float)w, TB_HEIGHT };
    SDL_SetRenderDrawColor(S.renderer, 20, 20, 20, 190);
    SDL_RenderFillRect(S.renderer, &band);
    /* progress groove + fill */
    float gx = TB_ICON * 2.2f, gw = (float)w - gx - 120.0f;
    float frac = (float)easyav1_get_current_timestamp(P.av1) / dur;
    if (frac > 1.0f) frac = 1.0f;
    SDL_FRect groove = { gx, top + TB_HEIGHT / 2 - 2, gw, 4 };
    SDL_SetRenderDrawColor(S.renderer, 80, 80, 80, 255);
    SDL_RenderFillRect(S.renderer, &groove);
    SDL_FRect fill = { gx, top + TB_HEIGHT / 2 - 2, gw * frac, 4 };
    SDL_SetRenderDrawColor(S.renderer, 235, 235, 235, 255);
    SDL_RenderFillRect(S.renderer, &fill);
    /* scrub knob */
    SDL_FRect knob = { gx + gw * frac - 3, top + TB_HEIGHT / 2 - 6,
                       6, 12 };
    SDL_RenderFillRect(S.renderer, &knob);
    /* play/pause morph icon */
    ui_quad l, r;
    ui_play_morph(S.morph, TB_ICON * 1.1f, top + TB_HEIGHT / 2,
                  TB_ICON, &l, &r);
    SDL_SetRenderDrawColor(S.renderer, 235, 235, 235, 255);
    sdl_fill_quad(&l);
    sdl_fill_quad(&r);
    /* time text: current / duration */
    char ts[16], ds[16], line[40];
    ui_fmt_time(easyav1_get_current_timestamp(P.av1), ts);
    ui_fmt_time(dur, ds);
    int n = 0;
    for (const char *pch = ts; *pch; pch++) line[n++] = *pch;
    line[n++] = ' '; line[n++] = '/'; line[n++] = ' ';
    for (const char *pch = ds; *pch; pch++) line[n++] = *pch;
    line[n] = 0;
    sdl_draw_text(gx + gw + 10.0f, top + TB_HEIGHT / 2 - 7.0f, 2,
                  line);
}

static void scrub_to(float mx, int w)
{
    float gx = TB_ICON * 2.2f, gw = (float)w - gx - 120.0f;
    float f = (mx - gx) / gw;
    if (f < 0) f = 0;
    if (f > 1) f = 1;
    easyav1_seek_to_timestamp(P.av1,
        (easyav1_timestamp)(easyav1_get_duration(P.av1) * (double)f));
}

/* file dialog when launched without a path (reference
 * easyav1_player.c:1189-1243 role) */
static struct { char path[4096]; int done; } g_dialog;

static void dialog_cb(void *ud, const char *const *files, int n)
{
    (void)ud; (void)n;
    if (files && files[0]) {
        size_t i = 0;
        for (; files[0][i] && i < sizeof(g_dialog.path) - 1; i++)
            g_dialog.path[i] = files[0][i];
        g_dialog.path[i] = 0;
    }
    g_dialog.done = 1;
}

static const char *pick_file_dialog(void)
{
    if (!SDL_Init(SDL_INIT_VIDEO)) {
        return NULL;
    }
    static const SDL_DialogFileFilter filters[] = {
        { "WebM video", "webm" },
        { "All files", "*" },
    };
    g_dialog.done = 0;
    g_dialog.path[0] = 0;
    SDL_ShowOpenFileDialog(dialog_cb, NULL, NULL, filters, 2, NULL,
                           false);
    while (!g_dialog.done) {
        SDL_Event ev;
        while (SDL_PollEvent(&ev)) {
            if (ev.type == SDL_EVENT_QUIT) {
                return NULL;
            }
        }
        SDL_Delay(20);
    }
    return g_dialog.path[0] ? g_dialog.path : NULL;
}

static int run_player(void)
{
    if (!SDL_Init(SDL_INIT_VIDEO | SDL_INIT_AUDIO)) {
        printf("Failed to initialize SDL: %s\n", SDL_GetError());
        return 4;
    }
    unsigned vw = easyav1_get_video_width(P.av1);
    unsigned vh = easyav1_get_video_height(P.av1);
    S.window = SDL_CreateWindow("easyav1_player", vw ? (int)vw : 960,
                                vh ? (int)vh : 540,
                                SDL_WINDOW_RESIZABLE |
                                (P.options.fullscreen ?
                                 SDL_WINDOW_FULLSCREEN : 0));
    S.renderer = SDL_CreateRenderer(S.window, NULL);
    if (!S.window || !S.renderer) {
        printf("Failed to create window: %s\n", SDL_GetError());
        return 4;
    }

    if (easyav1_has_audio_track(P.av1) && !P.options.disable_audio) {
        SDL_AudioSpec spec = {
            .format = SDL_AUDIO_F32,
            .channels = (int)easyav1_get_audio_channels(P.av1),
            .freq = (int)easyav1_get_audio_sample_rate(P.av1),
        };
        g_audio_stream = SDL_OpenAudioDeviceStream(
            SDL_AUDIO_DEVICE_DEFAULT_PLAYBACK, &spec, NULL, NULL);
        if (g_audio_stream) {
            SDL_ResumeAudioStreamDevice(g_audio_stream);
        }
    }

    if (easyav1_play(P.av1) != EASYAV1_STATUS_OK) {
        return 6;
    }

    unsigned fps = easyav1_get_video_fps(P.av1);
    if (fps == 0) {
        fps = 30;
    }
    uint64_t min_loop_ms = 500 / fps;
    uint64_t last_loop = SDL_GetTicks();

    while (!P.quit) {
        SDL_Event ev;
        while (SDL_PollEvent(&ev)) {
            switch (ev.type) {
                case SDL_EVENT_QUIT:
                    P.quit = 1;
                    break;
                case SDL_EVENT_KEY_DOWN:
                    switch (ev.key.key) {
                        case SDLK_ESCAPE:
                        case SDLK_Q:
                            P.quit = 1;
                            break;
                        case SDLK_SPACE:
                            P.paused = !P.paused;
                            if (P.paused) {
                                easyav1_stop(P.av1);
                            } else {
                                easyav1_play(P.av1);
                            }
                            break;
                        case SDLK_RIGHT:
                            easyav1_seek_forward(P.av1, 10000);
                            break;
                        case SDLK_LEFT:
                            easyav1_seek_backward(P.av1, 10000);
                            break;
                        case SDLK_F:
                            SDL_SetWindowFullscreen(
                                S.window,
                                !(SDL_GetWindowFlags(S.window) &
                                  SDL_WINDOW_FULLSCREEN));
                            break;
                        default:
                            break;
                    }
                    break;
                case SDL_EVENT_MOUSE_MOTION:
                    S.activity = 1;
                    if (S.scrubbing) {
                        int w, h;
                        SDL_GetWindowSize(S.window, &w, &h);
                        scrub_to(ev.motion.x, w);
                    }
                    break;
                case SDL_EVENT_MOUSE_BUTTON_UP:
                    S.scrubbing = 0;
                    break;
                case SDL_EVENT_MOUSE_BUTTON_DOWN: {
                    int w, h;
                    SDL_GetWindowSize(S.window, &w, &h);
                    S.activity = 1;
                    if (S.tb.pos > 0 &&
                        ev.button.y >= h - TB_HEIGHT && w > 0) {
                        if (ev.button.x < TB_ICON * 2.2f) {
                            /* morph icon: toggle play/pause */
                            P.paused = !P.paused;
                            if (P.paused) {
                                easyav1_stop(P.av1);
                            } else {
                                easyav1_play(P.av1);
                            }
                        } else {
                            S.scrubbing = 1;
                            scrub_to(ev.button.x, w);
                        }
                    } else {
                        P.paused = !P.paused;
                        if (P.paused) {
                            easyav1_stop(P.av1);
                        } else {
                            easyav1_play(P.av1);
                        }
                    }
                    break;
                }
                default:
                    break;
            }
        }

        SDL_SetRenderDrawColor(S.renderer, 0, 0, 0, 255);
        SDL_RenderClear(S.renderer);

        if (easyav1_get_status(P.av1) == EASYAV1_STATUS_ERROR) {
            break;
        }

        if (easyav1_has_video_track(P.av1)) {
            const easyav1_video_frame *frame = easyav1_get_video_frame(P.av1);
            if (frame) {
                ensure_texture(frame);
                if (S.video) {
                    SDL_UpdateYUVTexture(
                        S.video, NULL,
                        frame->data[0], (int)frame->stride[0],
                        frame->data[1], (int)frame->stride[1],
                        frame->data[2], (int)frame->stride[2]);
                }
            }
            if (S.video) {
                SDL_FRect dst;
                int w, h;
                SDL_GetWindowSize(S.window, &w, &h);
                dst.x = 0; dst.y = 0; dst.w = (float)w; dst.h = (float)h;
                if (P.options.keep_aspect_ratio && S.tex_w && S.tex_h) {
                    float ar = (float)S.tex_w / S.tex_h;
                    if (w / ar <= h) {
                        dst.h = w / ar;
                        dst.y = (h - dst.h) / 2;
                    } else {
                        dst.w = h * ar;
                        dst.x = (w - dst.w) / 2;
                    }
                }
                SDL_RenderTexture(S.renderer, S.video, NULL, &dst);
            }
        }

        draw_time_bar();
        SDL_RenderPresent(S.renderer);

        uint64_t t = SDL_GetTicks();
        if (t - last_loop < min_loop_ms) {
            SDL_Delay((Uint32)(min_loop_ms - (t - last_loop)));
        }
        last_loop = t;

        if (easyav1_is_finished(P.av1)) {
            if (g_audio_stream) {
                SDL_FlushAudioStream(g_audio_stream);
            }
            if (P.options.loop) {
                easyav1_seek_to_timestamp(P.av1, 0);
            } else {
                break;
            }
        }
    }

    easyav1_stop(P.av1);
    if (g_audio_stream) {
        SDL_DestroyAudioStream(g_audio_stream);
    }
    if (S.video) {
        SDL_DestroyTexture(S.video);
    }
    if (S.renderer) {
        SDL_DestroyRenderer(S.renderer);
    }
    if (S.window) {
        SDL_DestroyWindow(S.window);
    }
    SDL_Quit();
    return 0;
}

#endif  /* PLAYER_BACKEND_SDL3 */

int main(int argc, char **argv)
{
    if (!parse_options(argc, argv)) {
        return 1;
    }
    if (P.options.displaying_help) {
        display_help(argv[0]);
        return 0;
    }
    if (P.options.ui_selftest) {
        char trace[128];
        uint32_t h = ui_selftest(trace, (int)sizeof(trace));
        printf("ui-selftest trace=%s hash=%08x\n", trace, h);
        return 0;
    }
    if (!P.options.filename) {
#ifdef PLAYER_BACKEND_SDL3
        P.options.filename = pick_file_dialog();
#endif
        if (!P.options.filename) {
            printf("Usage: \"%s [OPTIONS] <filename>\"\n",
                   parse_file_name(argv[0]));
            return 2;
        }
    }
    if (!init_easyav1()) {
        printf("Failed to initialize easyav1.\n");
        return 3;
    }

    int rc = run_player();

    easyav1_destroy(&P.av1);
    if (P.file) {
        fclose(P.file);
    }
    return rc;
}
