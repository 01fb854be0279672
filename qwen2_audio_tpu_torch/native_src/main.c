/* Native CLI over the port's C ABI shim (qa_capi.cpp) — the drop-in analog
 * of the reference's examples/main binary (examples/main/main.cpp:353-594):
 * load model, load WAV, run whisper_full N times, print the encoder
 * fingerprint each iteration and total elapsed time.
 *
 * Usage: qa_main [-ng] <model.bin> <audio.wav> [iters]
 *   runs on the card; -ng (as the command line's) runs on the CPU, passed
 *   to the shim as whisper_context_params.use_gpu = false.
 */

#include <stdbool.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef void whisper_context;

/* the leading members of whisper.cpp v1.7.1's struct whisper_context_params,
 * which is all the shim reads */
struct whisper_context_params {
    bool use_gpu;
    bool flash_attn;
    int gpu_device;
};

extern whisper_context* whisper_init_from_file_with_params(const char* path, void* params);
extern void whisper_free(whisper_context*);
extern int whisper_full(whisper_context*, void*, const float*, int);
extern void whisper_print_emb_enc(whisper_context*);
extern void whisper_print_timings(whisper_context*);
extern int whisper_n_vocab(whisper_context*);
extern const char* qa_context_device(whisper_context*);

int main(int argc, char** argv) {
    struct whisper_context_params cparams = {true, false, 0};
    const char* pos[3] = {NULL, NULL, NULL};
    int n_pos = 0;
    for (int i = 1; i < argc; i++) {
        if (strcmp(argv[i], "-ng") == 0 || strcmp(argv[i], "--no-gpu") == 0) {
            cparams.use_gpu = false;
        } else if (n_pos < 3) {
            pos[n_pos++] = argv[i];
        } else {
            n_pos = -1;
            break;
        }
    }
    if (n_pos < 2) {
        fprintf(stderr, "usage: %s [-ng] <model.bin> <audio.wav> [iters]\n", argv[0]);
        return 1;
    }
    const char* model = pos[0];
    const char* wav = pos[1];
    int iters = n_pos > 2 ? atoi(pos[2]) : 100;

    whisper_context* ctx = whisper_init_from_file_with_params(model, &cparams);
    if (!ctx) {
        fprintf(stderr, "failed to load model %s\n", model);
        return 2;
    }
    /* where the shim's context really is, as torch names its device */
    const char* device = qa_context_device(ctx);
    if (!device) {
        fprintf(stderr, "cannot read the context's device\n");
        return 2;
    }
    fprintf(stderr, "model loaded: n_vocab=%d (asked for the %s; context on %s)\n",
            whisper_n_vocab(ctx), cparams.use_gpu ? "card" : "cpu", device);

    /* minimal reader for CANONICAL 16-bit PCM mono WAVs (44-byte header) */
    FILE* f = fopen(wav, "rb");
    if (!f) { fprintf(stderr, "no wav %s\n", wav); return 3; }
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    if (size <= 44) { fprintf(stderr, "wav too short: %s\n", wav); fclose(f); return 3; }
    unsigned char hdr[44];
    fseek(f, 0, SEEK_SET);
    if (fread(hdr, 1, 44, f) != 44 || memcmp(hdr, "RIFF", 4) != 0
        || memcmp(hdr + 8, "WAVE", 4) != 0 || memcmp(hdr + 36, "data", 4) != 0
        || hdr[20] != 1 /* PCM */ || hdr[22] != 1 /* mono */
        || hdr[34] != 16 /* bits */) {
        fprintf(stderr, "not a canonical 16-bit mono PCM wav: %s\n", wav);
        fclose(f);
        return 3;
    }
    long n = (size - 44) / 2;
    short* pcm = malloc((size_t)n * 2);
    float* samples = malloc((size_t)n * 4);
    if (!pcm || !samples) { fclose(f); free(pcm); free(samples); return 3; }
    if (fread(pcm, 2, (size_t)n, f) != (size_t)n) {
        fclose(f); free(pcm); free(samples); return 3;
    }
    fclose(f);
    for (long i = 0; i < n; i++) samples[i] = pcm[i] / 32768.0f;
    free(pcm);

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int i = 0; i < iters; i++) {
        if (whisper_full(ctx, NULL, samples, (int)n) != 0) {
            fprintf(stderr, "whisper_full failed\n");
            return 4;
        }
        whisper_print_emb_enc(ctx);
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + (t1.tv_nsec - t0.tv_nsec) / 1e9;
    printf("Elapsed time is %.6f seconds.\n", dt);
    fflush(stdout);
    whisper_print_timings(ctx);

    free(samples);
    whisper_free(ctx);
    return 0;
}
