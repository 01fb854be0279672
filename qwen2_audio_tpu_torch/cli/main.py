"""The port's CLI, mirroring the reference's examples/main
(examples/main/main.cpp): flag set :32-180, @response-file expansion
:359-383, per-file wav/mp3 load + 100x whisper_full benchmark loop :462-589
printing the 20-float encoder fingerprint each iteration
(whisper_print_emb_enc); with ``--decoder`` the segments and the output
files (txt, vtt, srt, lrc, csv, json, wts).

The context runs on the card (cuda:0); ``-ng`` runs it, and loads the
``--decoder`` checkpoint, on the CPU. On the card a deadline
(utils/watchdog.py, ``DEADLINE_S``) guards the model upload and each file's
``full`` passes: a hung kernel or device read ends the process. ``--rpc
HOST:PORT`` offloads the encode to a server
(``python -m qwen2_audio_tpu_torch.runtime.rpc``, runtime/rpc.py), which
makes the context on its card, or on its CPU with ``-ng``; a
``--decoder`` is local-only and is not used with ``--rpc``.

Usage:  python -m qwen2_audio_tpu_torch.cli -m models/ggml-model.bin -f samples/jfk.wav
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from qwen2_audio_tpu_torch.cli.output_formats import colorize_segment, write_outputs, write_wts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "qwen2-audio-tpu-torch", description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        # exact-match flags only, like the reference's strcmp parser —
        # prefix abbreviation would make --temp ambiguous vs -tpi's long
        # form and silently couple unrelated flags as the surface grows
        allow_abbrev=False)
    a = p.add_argument
    a("-t", "--threads", type=int, default=4,
      help="number of threads (host-side work; the card runs the kernels)")
    a("-p", "--processors", type=int, default=1,
      help="number of parallel chunks (batched encode)")
    a("-ot", "--offset-t", type=int, default=0, help="time offset in ms")
    a("-on", "--offset-n", type=int, default=0, help="segment index offset")
    a("-d", "--duration", type=int, default=0, help="duration to process in ms")
    a("-mc", "--max-context", type=int, default=-1)
    a("-ml", "--max-len", type=int, default=0)
    a("-sow", "--split-on-word", action="store_true")
    a("-bo", "--best-of", type=int, default=5)
    a("-bs", "--beam-size", type=int, default=-1,
      help="beam size (> 1 selects beam-search decoding, ≙ upstream "
           "main.cpp: strategy = beam_size > 1 ? BEAM_SEARCH : GREEDY)")
    a("-ac", "--audio-ctx", type=int, default=0,
      help="audio context size (0 = full 1500)")
    a("-wt", "--word-thold", type=float, default=0.01)
    a("-et", "--entropy-thold", type=float, default=2.40)
    a("-lpt", "--logprob-thold", type=float, default=-1.0)
    a("-tr", "--translate", action="store_true")
    a("-di", "--diarize", action="store_true")
    a("-tdrz", "--tinydiarize", action="store_true")
    a("-nf", "--no-fallback", action="store_true")
    a("-otxt", "--output-txt", action="store_true")
    a("-ovtt", "--output-vtt", action="store_true")
    a("-osrt", "--output-srt", action="store_true")
    a("-olrc", "--output-lrc", action="store_true")
    a("-owts", "--output-words", action="store_true")
    a("-ocsv", "--output-csv", action="store_true")
    a("-oj", "--output-json", action="store_true")
    a("-ojf", "--output-json-full", action="store_true",
      help="JSON output with per-token detail (implies -oj, ≙ reference "
           "main.cpp:151)")
    a("-of", "--output-file", default=None)
    a("-fp", "--font-path", default="/System/Library/Fonts/Supplemental/"
      "Courier New Bold.ttf",
      help="monospace font for the -owts karaoke script")
    a("-np", "--no-prints", action="store_true")
    a("-ps", "--print-special", action="store_true")
    a("-pc", "--print-colors", action="store_true")
    a("-pp", "--print-progress", action="store_true")
    a("-nt", "--no-timestamps", action="store_true")
    a("-l", "--language", default="en")
    a("-dl", "--detect-language", action="store_true")
    a("--prompt", default=None)
    a("-m", "--model", default="models/ggml-model.bin")
    a("-f", "--file", action="append", default=[], help="input WAV file(s)")
    a("--decoder", default=None, metavar="HF_DIR",
      help="attach the Qwen2 text decoder from a HF Qwen2-Audio checkpoint "
           "dir (enables audio->text; without it the CLI runs the encoder "
           "benchmark loop like the reference)")
    a("-oved", "--ov-e-device", default="CPU")
    a("-dtw", "--dtw", default="",
      help="alignment-heads preset for token timestamps")
    a("-ls", "--log-score", action="store_true")
    a("-ng", "--no-gpu", action="store_true",
      help="run on the CPU (the kernels' plain versions) instead of the card")
    a("-fa", "--flash-attn", action="store_true",
      help="kept for the reference's flag set; the encoder attention is "
           "always the attention kernel on the card")
    a("--suppress-regex", default=None)
    a("--grammar", default=None)
    a("--grammar-rule", default=None)
    a("--grammar-penalty", type=float, default=100.0)
    a("--bench-iters", type=int, default=100,
      help="encode iterations (reference hardcodes 100, main.cpp:574)")
    a("--max-new-tokens", type=int, default=128)
    a("--spec-k", type=int, default=-1,
      help="n-gram speculative decoding: drafts verified per forward "
           "(greedy only; exact output). -1 auto (off in whisper_full), 0 off")
    a("-tp", "--temperature", type=float, default=0.0)
    a("-tpi", "--temperature-inc", type=float, default=0.2,
      help="temperature increment for fallback retries (≙ main.cpp:136)")
    a("-debug", "--debug-mode", action="store_true")
    a("--rpc", default=None, metavar="HOST:PORT",
      help="offload to a remote qwen2_audio_tpu_torch.runtime.rpc server "
           "(≙ ggml's RPC backend, ggml-rpc.cpp); -ng asks it for the CPU")
    return p


def estimate_diarization_speaker(stereo: np.ndarray, t0_cs: int, t1_cs: int,
                                 id_only: bool = False) -> str:
    """Stereo channel-energy speaker guess ≙ estimate_diarization_speaker
    (reference examples/main/main.cpp:246-275): compare sum(|ch0|) vs
    sum(|ch1|) over the segment span with a 1.1x margin."""
    n = stereo.shape[0]
    is0 = min(max(t0_cs * 160, 0), n)
    is1 = min(max(t1_cs * 160, 0), n)
    e0 = float(np.abs(stereo[is0:is1, 0]).sum())
    e1 = float(np.abs(stereo[is0:is1, 1]).sum())
    speaker = "0" if e0 > 1.1 * e1 else ("1" if e1 > 1.1 * e0 else "?")
    return speaker if id_only else f"(speaker {speaker})"


def expand_response_files(argv: list[str]) -> list[str]:
    """@file expansion (reference main.cpp:359-383)."""
    out = []
    for arg in argv:
        if arg.startswith("@"):
            with open(arg[1:]) as f:
                out.extend(f.read().split())
        else:
            out.append(arg)
    return out


def build_full_params(args):
    """Flag -> whisper_full_params mapping ≙ reference main.cpp:506-540.
    Every parsed decode-relevant flag lands in a FullParams field here (the
    reference's fork parses some — -on/-ls/--grammar* — that its stripped
    decoder never reads; we plumb them at the CLI layer instead)."""
    from qwen2_audio_tpu_torch.runtime import full_default_params

    fp = full_default_params()
    fp.n_threads = args.threads            # host-side mel/quantize threads
    fp.print_progress = args.print_progress  # ≙ main.cpp wparams mapping
    fp.offset_ms = args.offset_t
    fp.duration_ms = args.duration
    fp.translate = args.translate
    fp.language = args.language
    fp.detect_language = args.detect_language
    fp.audio_ctx = args.audio_ctx
    # ≙ upstream main.cpp: strategy = beam_size > 1 ? BEAM_SEARCH : GREEDY
    if args.beam_size > 1:
        fp.strategy = "beam"
        fp.beam_size = args.beam_size
    fp.best_of = args.best_of
    # ≙ main.cpp:516 — -mc only overrides when >= 0
    if args.max_context >= 0:
        fp.n_max_text_ctx = args.max_context
    fp.thold_pt = args.word_thold          # ≙ main.cpp:521
    fp.tdrz_enable = args.tinydiarize      # ≙ main.cpp:528
    fp.entropy_thold = args.entropy_thold
    fp.logprob_thold = args.logprob_thold
    fp.temperature = args.temperature
    # ≙ main.cpp:534 — -nf zeroes the increment, else -tpi sets it
    fp.temperature_inc = 0.0 if args.no_fallback else args.temperature_inc
    fp.max_new_tokens = args.max_new_tokens
    fp.speculative_k = args.spec_k
    fp.print_special = args.print_special
    fp.no_timestamps = args.no_timestamps
    fp.suppress_regex = args.suppress_regex
    fp.initial_prompt = args.prompt
    fp.debug_mode = args.debug_mode
    # ≙ reference main.cpp:520-522: -owts or -ojf implies token
    # timestamps, -owts a 60-char default wrap
    fp.token_timestamps = (args.output_words or args.output_json_full
                           or args.max_len > 0)
    fp.max_len = (60 if args.output_words and args.max_len == 0
                  else args.max_len)
    fp.split_on_word = args.split_on_word
    return fp


def run(argv: list[str] | None = None):
    """The CLI on ``argv`` (``sys.argv[1:]`` when None): (exit code, the
    context it ran, None where it stopped before making one)."""
    argv = expand_response_files(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)

    if not args.file:
        print("error: no input files specified", file=sys.stderr)
        return 1, None
    from qwen2_audio_tpu_torch.audio import read_audio
    from qwen2_audio_tpu_torch.io.ggml_format import read_ggml_file
    from qwen2_audio_tpu_torch.runtime import ContextParams, WhisperContext
    from qwen2_audio_tpu_torch.runtime.context import print_system_info
    from qwen2_audio_tpu_torch.utils.logging import log_set

    if args.no_prints:
        log_set(lambda level, text, ud: None)

    if args.diarize and args.tinydiarize:
        print("error: cannot use both --diarize and --tinydiarize",
              file=sys.stderr)
        return 1, None
    if args.ov_e_device != "CPU":
        # ≙ main.cpp's -oved: consumed only by the OpenVINO encoder hook,
        # which this build (like a non-OPENVINO reference build) lacks
        print("warning: --ov-e-device is inert (no OpenVINO encoder in "
              "this build) — flag ignored", file=sys.stderr)
    if args.grammar or args.grammar_rule or args.grammar_penalty != 100.0:
        # the reference parses --grammar/--grammar-rule/--grammar-penalty
        # but its grammar engine was stripped with the decoder (only the
        # UTF-8 remnant survives, src/qwen2-whisper.cpp:3602-3658)
        print("warning: --grammar/--grammar-rule are inert (the reference "
              "stripped its grammar engine; only the UTF-8 remnant "
              "remains) — flags ignored", file=sys.stderr)

    cparams = ContextParams(use_gpu=not args.no_gpu, flash_attn=args.flash_attn)
    if args.dtw:
        # ≙ main.cpp:427-453 dtw preset -> context params. The whisper
        # named presets pick (layer, head) pairs of the whisper text
        # decoder; the Qwen2 decoder aligns on all heads of the top-N
        # layers instead (models/dtw.py), so an integer selects N and a
        # whisper preset name falls back to the default top half
        cparams.dtw_token_timestamps = True
        try:
            cparams.dtw_n_top = int(args.dtw)
        except ValueError:
            from qwen2_audio_tpu_torch.models.dtw import ALIGNMENT_HEADS_PRESETS
            if args.dtw not in ALIGNMENT_HEADS_PRESETS:
                print(f"warning: unknown -dtw preset '{args.dtw}'; using "
                      "top-half alignment layers", file=sys.stderr)
            cparams.dtw_n_top = -1
    # the deadline guards device phases only: the host's checkpoint parse,
    # the decoder load and the output files run unguarded; it is cancelled
    # on every way out of its block, an exception included
    def guard(tag: str):
        if args.rpc or not cparams.use_gpu:
            return contextlib.nullcontext()
        from qwen2_audio_tpu_torch.utils.watchdog import DEADLINE_S, guarded
        return guarded(DEADLINE_S, tag)

    if args.rpc:
        from qwen2_audio_tpu_torch.runtime.rpc import RemoteWhisperContext
        ctx = RemoteWhisperContext.connect(args.rpc)
        ctx.load_model_file(args.model, cparams)
        if not args.no_prints:
            print(f"rpc: offloading to {args.rpc} "
                  f"(backend {ctx.server_backend})", file=sys.stderr)
        if args.decoder:
            print("warning: --decoder is local-only and not used with --rpc "
                  "(the server encodes) — flag ignored", file=sys.stderr)
    else:
        model = read_ggml_file(args.model)       # host-side, unguarded
        with guard("cli:init"):                  # the upload to the card
            ctx = WhisperContext(model, cparams)

    if args.decoder and not args.rpc:
        from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
        # the card by default; -ng loads onto the CPU
        ctx.decoder = load_qwen2_audio(
            args.decoder, device="cpu" if args.no_gpu else None)["bundle"]

    if not args.no_prints:
        print(f"system_info: {print_system_info()}", file=sys.stderr)

    for fname in args.file:
        # -di keeps stereo for channel-energy diarization (≙ upstream
        # estimate_diarization_speaker; read_wav keeps 2ch when diarize,
        # main.cpp:469)
        samples, _rate = read_audio(fname, to_mono=not args.diarize)
        stereo = None
        if args.diarize:
            if samples.ndim == 2 and samples.shape[1] == 2:
                stereo = samples
                samples = samples.mean(axis=1)
            else:
                print("warning: --diarize needs stereo input; "
                      f"'{fname}' is mono — skipping diarization",
                      file=sys.stderr)
        if not args.no_prints:
            print(f"processing '{fname}' ({len(samples)} samples, "
                  f"{len(samples) / 16000.0:.1f} sec)", file=sys.stderr)

        fp = build_full_params(args)

        # benchmark + parity loop (reference main.cpp:573-583), the device
        # phase of the per-file work, guarded alone
        with guard(f"cli:full:{os.path.basename(fname)}"):
            t0 = time.perf_counter()
            for _ in range(args.bench_iters):
                if args.processors > 1:
                    rc = ctx.full_parallel(fp, samples, args.processors)
                else:
                    rc = ctx.full(fp, samples)
                if rc != 0:
                    print(f"failed to process audio (rc={rc})", file=sys.stderr)
                    return 10, ctx
                ctx.print_emb_enc()
            elapsed = time.perf_counter() - t0
        print(f"Elapsed time is {elapsed:.6f} seconds.")

        if ctx.decoder is not None:
            for i in range(ctx.full_n_segments()):
                seg = ctx.state.segments[i]
                if stereo is not None:
                    # ≙ whisper_print_segment_callback's diarize branch
                    seg["speaker"] = estimate_diarization_speaker(
                        stereo, seg.get("t0", 0), seg.get("t1", 0))
                if args.print_colors:
                    text = colorize_segment(seg)
                else:
                    text = ctx.full_get_segment_text(i)
                if seg.get("speaker"):
                    text = f"{seg['speaker']}{text}"
                print(text)

        if args.log_score and ctx.decoder is not None and ctx.state.segments:
            # ≙ upstream output_score: token-tab-probability lines in
            # <base>.score.txt
            base = args.output_file or fname
            score_path = f"{base}.score.txt"
            with open(score_path, "w") as f:
                for seg in ctx.state.segments:
                    for tok, p in zip(seg.get("tokens", []),
                                      seg.get("probs", [])):
                        surf = (ctx.decoder.text([int(tok)])
                                if ctx.decoder.detokenize else str(tok))
                        f.write(f"{surf}\t{p:.6f}\n")
            if not args.no_prints:
                print(f"saved token scores to {score_path}", file=sys.stderr)

        if args.output_words and ctx.state.segments:
            base = (args.output_file or fname)
            base = (base[:-4] if base.endswith((".wav", ".mp3"))
                    else base)
            write_wts(f"{base}.wts", ctx.state.segments, fname,
                      int(len(samples) / 16000.0 * 100),
                      font_path=args.font_path)
            if not args.no_prints:
                print(f"saved karaoke script to {base}.wts",
                      file=sys.stderr)

        if ctx.state.segments:
            # write_outputs gates per flag itself
            for path in write_outputs(fname, ctx.state.segments, args):
                if not args.no_prints:
                    print(f"output written to {path}", file=sys.stderr)

    if not args.no_prints:
        ctx.print_timings()
    return 0, ctx


def main(argv: list[str] | None = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
