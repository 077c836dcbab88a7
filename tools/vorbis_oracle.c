/* vorbis_oracle — golden Vorbis decode via libvorbis (minivorbis amalgam).
 *
 * Test-infrastructure tool. Compiled at test time against the reference
 * snapshot's vendored minivorbis header (read-only include path, not
 * vendored here); the resulting float PCM is the exact output easyav1's
 * audio path produces (vorbis_synthesis → blockin → pcmout,
 * reference easyav1.c:2434-2499), making it the conformance target for
 * easyav1's device Vorbis synthesis.
 *
 * Input (file arg 1): u32le packet_count, then per packet u32le len + bytes.
 *   Packets 0..2 must be the three Vorbis headers.
 * Output (file arg 2): u32le channels, u32le rate, u64le sample_count,
 *   then float32le interleaved PCM.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

#define OGG_IMPL
#define VORBIS_IMPL
#include "minivorbis.h"

static void die(const char *msg) { fprintf(stderr, "vorbis_oracle: %s\n", msg); exit(1); }

int main(int argc, char **argv) {
    if (argc != 3) die("usage: vorbis_oracle packets.bin out.bin");
    FILE *in = fopen(argv[1], "rb");
    if (!in) die("open input");
    uint32_t count;
    if (fread(&count, 4, 1, in) != 1) die("read count");

    vorbis_info vi; vorbis_comment vc;
    vorbis_info_init(&vi); vorbis_comment_init(&vc);
    vorbis_dsp_state vd; vorbis_block vb;

    FILE *out = fopen(argv[2], "wb");
    if (!out) die("open output");
    uint64_t total_samples = 0;
    long header_pos = -1;

    for (uint32_t i = 0; i < count; i++) {
        uint32_t len;
        if (fread(&len, 4, 1, in) != 1) die("read len");
        unsigned char *buf = malloc(len);
        if (fread(buf, 1, len, in) != len) die("read packet");
        ogg_packet op = {0};
        op.packet = buf;
        op.bytes = len;
        op.b_o_s = (i == 0);
        op.packetno = i;
        if (i < 3) {
            if (vorbis_synthesis_headerin(&vi, &vc, &op) != 0) die("headerin");
            if (i == 2) {
                if (vorbis_synthesis_init(&vd, &vi) != 0) die("synthesis_init");
                vorbis_block_init(&vd, &vb);
                uint32_t ch = vi.channels, rate = vi.rate;
                fwrite(&ch, 4, 1, out);
                fwrite(&rate, 4, 1, out);
                header_pos = ftell(out);
                fwrite(&total_samples, 8, 1, out);
            }
        } else {
            if (vorbis_synthesis(&vb, &op) == 0)
                vorbis_synthesis_blockin(&vd, &vb);
            float **pcm;
            int n;
            while ((n = vorbis_synthesis_pcmout(&vd, &pcm)) > 0) {
                for (int s = 0; s < n; s++)
                    for (int c = 0; c < vi.channels; c++)
                        fwrite(&pcm[c][s], 4, 1, out);
                total_samples += n;
                vorbis_synthesis_read(&vd, n);
            }
        }
        free(buf);
    }
    fseek(out, header_pos, SEEK_SET);
    fwrite(&total_samples, 8, 1, out);
    fclose(out); fclose(in);
    return 0;
}
