"""Example: end-to-end transcription (wav/mp3 -> mel -> encoder -> Qwen2 decode).

    python -m qwen2_audio_tpu_torch.cli.transcribe model.bin audio.wav [hf_decoder_dir] [-ng]

Without a decoder directory it prints the 20-float encoder fingerprint (the
reference CLI's behaviour); with one it prints timestamped segments, the
audio's 30 s windows decoded in batches (runtime/serving.py). It runs on
the card; ``-ng`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("transcribe")
    ap.add_argument("model")
    ap.add_argument("audio")
    ap.add_argument("decoder", nargs="?", default=None)
    ap.add_argument("-ng", "--no-gpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from qwen2_audio_tpu_torch.audio import read_audio
    from qwen2_audio_tpu_torch.runtime import (ContextParams, WhisperContext,
                                               full_default_params)
    from qwen2_audio_tpu_torch.runtime.serving import transcribe_long_form

    ctx = WhisperContext.init_from_file_with_params(
        args.model, ContextParams(use_gpu=not args.no_gpu))
    samples, _ = read_audio(args.audio)

    if args.decoder:
        from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
        ctx.decoder = load_qwen2_audio(
            args.decoder, device="cpu" if args.no_gpu else None)["bundle"]
        for seg in transcribe_long_form(ctx, samples):
            print(f"[{seg.t0_cs / 100:7.2f}s -> {seg.t1_cs / 100:7.2f}s] {seg.text}")
    else:
        rc = ctx.full(full_default_params(), samples)
        if rc != 0:
            print(f"whisper_full failed rc={rc}", file=sys.stderr)
            return 1
        ctx.print_emb_enc()
    ctx.print_timings()
    return 0


if __name__ == "__main__":
    sys.exit(main())
