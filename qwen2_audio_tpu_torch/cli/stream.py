"""Example: pseudo-streaming transcription with energy VAD segmentation.

Feeds a long wav through a sliding buffer the way whisper.cpp's stream
example drives a microphone: accumulate audio, run the simple energy VAD
(audio/vad.py ≙ examples/common.cpp vad_simple) to detect the end of speech,
then transcribe the finished utterance and emit it incrementally through
StreamingTextDecoder (utils/utf8.py), which handles code points split across
token boundaries.

    python -m qwen2_audio_tpu_torch.cli.stream model.bin long.wav [hf_decoder_dir] [-ng]

Live capture: pass '-' (stdin) or a FIFO path instead of a wav to read raw
s16le 16 kHz mono PCM as a blocking stream, the capture-loop shape of the
reference's SDL microphone source (examples/common-sdl.cpp:1-229
audio_async ring buffer feeding examples/stream.cpp):

    arecord -f S16_LE -r 16000 -c 1 | python -m qwen2_audio_tpu_torch.cli.stream model.bin -

It runs on the card; ``-ng`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

CHUNK_MS = 500
MAX_UTTERANCE_S = 28.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("stream")
    ap.add_argument("model")
    ap.add_argument("audio", help="a wav/mp3 file, '-' (stdin) or a FIFO of s16le PCM")
    ap.add_argument("decoder", nargs="?", default=None)
    ap.add_argument("-ng", "--no-gpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from qwen2_audio_tpu_torch.audio import is_pipe_source, pcm_chunks, read_audio
    from qwen2_audio_tpu_torch.audio.vad import vad_simple
    from qwen2_audio_tpu_torch.runtime import (ContextParams, WhisperContext,
                                               full_default_params)
    from qwen2_audio_tpu_torch.utils.utf8 import StreamingTextDecoder

    ctx = WhisperContext.init_from_file_with_params(
        args.model, ContextParams(use_gpu=not args.no_gpu))
    if args.decoder:
        from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
        ctx.decoder = load_qwen2_audio(
            args.decoder, device="cpu" if args.no_gpu else None)["bundle"]

    rate = 16000
    if is_pipe_source(args.audio):
        # live source: a blocking chunk reader over the pipe, the role of
        # audio_async::get() in the reference's SDL capture loop
        chunks = pcm_chunks(args.audio, rate=rate, chunk_ms=CHUNK_MS)
    else:
        samples, rate = read_audio(args.audio)
        step = rate * CHUNK_MS // 1000
        chunks = (samples[off:off + step] for off in range(0, len(samples), step))
    buf = np.zeros(0, np.float32)
    t_emitted = 0.0

    def flush(buf: np.ndarray, t0: float) -> None:
        if len(buf) < rate:  # < 1 s: the runtime's guard would skip it anyway
            return
        p = full_default_params()
        p.temperature_inc = 0.0
        if ctx.full(p, buf) != 0:
            return
        if ctx.decoder is not None and ctx.state.segments:
            # stream the raw token bytes through the incremental UTF-8
            # decoder (code points can split across byte-level BPE tokens;
            # decoded strings would already hold replacement characters)
            sd = StreamingTextDecoder()
            if ctx.decoder.token_bytes is not None:
                pieces = [ctx.decoder.token_bytes(t) for t in ctx.state.result_tokens]
                text = "".join(sd.push(c) for c in pieces) + sd.flush()
            else:
                text = ctx.full_get_segment_text(0)
        else:
            text = f"<encoded {tuple(ctx.state.embd_enc.shape)}>"
        print(f"[{t0:7.2f}s] {text}", flush=True)

    for piece in chunks:
        buf = np.concatenate([buf, piece])
        speech_ended = vad_simple(buf, rate, last_ms=400, vad_thold=0.6, freq_thold=100.0)
        if speech_ended or len(buf) >= rate * MAX_UTTERANCE_S:
            flush(buf, t_emitted)
            t_emitted += len(buf) / rate
            buf = np.zeros(0, np.float32)

    flush(buf, t_emitted)
    ctx.print_timings()
    return 0


if __name__ == "__main__":
    sys.exit(main())
