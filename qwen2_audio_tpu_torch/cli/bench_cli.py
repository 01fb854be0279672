"""Benchmark CLI (≙ whisper.cpp's bench example over the fork's
whisper_bench_memcpy / whisper_bench_ggml_mul_mat entry points,
include/qwen2-whisper.h:517-520).

Usage:  python -m qwen2_audio_tpu_torch.cli.bench_cli [-t threads] [-w what] [-ng]
        what: 0 = all, 1 = encoder, 2 = memcpy, 3 = mul_mat

The products and the encoder run on the card; ``-ng`` runs them on the CPU
(the kernels' plain versions). memcpy is the host's.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench")
    ap.add_argument("-m", "--model", default=None,
                    help="ggml model for the encoder bench (default: "
                         "random tiny weights)")
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-w", "--what", type=int, default=0)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the products and the encoder on the CPU")
    args = ap.parse_args(argv)

    from qwen2_audio_tpu_torch import capi

    if args.what in (0, 2):
        print(capi.whisper_bench_memcpy_str(args.threads), end="")

    if args.what in (0, 3):
        print("mul_mat (dependent chains of 8, CUDA events on the card):")
        print(capi.whisper_bench_ggml_mul_mat_str(args.threads, use_gpu=not args.no_gpu),
              end="")

    if args.what in (0, 1):
        import numpy as np
        from qwen2_audio_tpu_torch.runtime import ContextParams, full_default_params
        cparams = ContextParams(use_gpu=not args.no_gpu)
        if args.model:
            ctx = capi.whisper_init_from_file_with_params(args.model, cparams)
        else:
            import io
            from qwen2_audio_tpu_torch.audio import mel_filterbank
            from qwen2_audio_tpu_torch.config import WHISPER_PRESETS
            from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
            from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
            hp = WHISPER_PRESETS["tiny"]
            buf = io.BytesIO()
            write_encoder_checkpoint(
                buf, random_encoder_params(np.random.default_rng(0), hp),
                hp, mel_filterbank(hp.n_mels), [b"x"] * 64)
            ctx = capi.whisper_init_from_buffer_with_params(buf.getvalue(), cparams)
        samples = np.zeros(16000 * 30, np.float32)
        p = full_default_params()
        ctx.full(p, samples)     # warm-up (the encoder's graph capture on the card)
        t0 = time.perf_counter()
        ctx.full(p, samples)     # ends in a device synchronisation
        dt = time.perf_counter() - t0
        print(f"encoder ({ctx.model_type_readable()}): "
              f"{dt * 1e3:.1f} ms / 30 s clip")
        ctx.print_timings()
    return 0


if __name__ == "__main__":
    sys.exit(main())
