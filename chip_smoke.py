#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qwen2_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers 32] [--calls 8] [--dec-layers 28]
                          [--new-tokens 32] [--kernels-only]
                          [--cli-only | --surface-only | --tp-only]

(``--layers 4 --calls 2 --dec-layers 2 --new-tokens 8`` is a quick
rehearsal.) Phases, each of which must pass (any failure exits non-zero
before the result lines are printed):
1. build every CUDA kernel from qwen2_audio_tpu_torch/csrc with nvcc
   (sm_90a), in parallel, and print the card's name and power limit; the
   SASS of every tensor-core kernel is checked (cuobjdump): the bf16
   attention tile on wgmma, each instantiation of the dequantizing matmul's
   M > 8 tile (qmm_tile_kernel) on wgmma and not mma.sync, with no ptxas
   note that it serialized the tile's wgmma (C7518, C7514, C7517; its
   registers and spills logged), and each fast-mode instantiation of the
   M <= 8 weight-streaming matmul (qmm_stream_kernel) and of the one-launch
   SwiGLU (swiglu_coop_kernel) on HMMA or HGMMA; the mel kernel on float32
   FMA with no HMMA or HGMMA;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with stated tolerances (the mel kernel on MEL_CASES,
   each also against the float64 oracle; the decode kernels over a
   cache filled with NaN past each stream's position, at the split-KV
   kernel's range edges too, its merge's ticket counters on two streams at
   once and in a graph, bit-equal, and back at 0 after), and time kernel,
   plain version and (where one exists) the one-call library equivalent;
   the four dequantizing-matmul entries at M = 1, 7, 752 and 1500 over the
   decoder's, the lm_head's and the encoder's K x N, in both modes, bf16
   and float32 x, q8_0, symmetric q4_0, q4_1 (mins) and q6_K (group 16),
   and at every one of those cases the panel entry of the same weight in
   contiguous column panels, bit-equal to the strided entry, each timed
   case by CUDA-graph replay beside the library call; the edges of the
   large-M wgmma tile: M = 9, 65, 129, 753, a weight of N = 1296 (a multiple
   of 16, not of the tile's 128 columns) and K = 1312 (a multiple of 32, not
   of the 64-deep stage) in q8_0 (float16 and float32 scales), q4_0 and q6_K,
   float32 x in fast mode, in panels of widths 16, 48 and 432, the K-split
   M <= 8 launch on two streams at once and in a CUDA graph, bit-equal to
   one stream (ticket counters per stream and per capture), the one-launch
   SwiGLU's cooperative launch (grid barrier, tile tickets) likewise on two
   streams at M = 1 and 64 and replayed in a graph at M = 1, 8 and 64, all
   bit-equal, and the M <= 8
   streaming kernel at M = 1 on that N in panels of 16 and 48; the five
   one-launch SwiGLU entries at the decoder's width (K = D = 3584,
   I = 18944) at M = 1, 7, 64 in both modes and M = 2, 5, 8, 9, 12, 16, 32,
   33 in fast mode (FUSED_ROWS),
   bf16 and float32 x, over q8_0, q6_K, q5_1 (mins), symmetric q4_0 and q4_1
   blocks, the split schema
   bit-equal to the fused one, two runs bit-equal, M = 65 refused; every
   M <= 8 case of the streaming matmul and the SwiGLU's FUSED_TIMED_ROWS
   timed by CUDA-graph replay (the back-to-back events' figure beside it),
   with its share of the bound, the SwiGLU beside the two-launch path and
   the path the default takes at that M; the
   exact-integer group matmul: the q8_1 quantizing kernel bit-equal to its
   plain version (M = 1, 7, 752, 1500, bf16 and float32 x, ties and all-zero
   groups), then its three entries (flat int8 values, stacked int8 values
   or nibble bytes, stacked int32 words) at M = 1, 7, 752, 1500 over the
   decoder's, the lm_head's and the encoder's K x N, q8_0, symmetric q4_0 as
   bytes and as words, q4_1 and q5_1 with mins, and at the wgmma tile's edges
   (M = 9, 65, 129, 753, N = 1296, K = 1312 against the 128-deep stage, each
   form, float16 and float32 scales), the flat entry bit-equal to
   the stacked one and the words to the bytes with off 8, two runs
   bit-equal; the lite and unpadded one-shot entries (TPU rows 18, 19), the
   blockwise entry (row 3 without the mask) at d = 64 and 128, exp2 on the
   one-shot, blockwise and causal kernels and pexp16 on the one-shot kernel,
   at the encoder shape (fused-QKV views, bf16 and float32) and on ragged
   keys with NaN past kv_valid, timed against the plain version, the
   default one-shot kernel and bf16 SDPA, and pexp16 and lite on inputs
   where each moves every output by a known step (the kernel must land on
   its own plain version, away from the one without the option, and the
   kernel without the option the other way round); the int8 KV cache's quantizer
   bit-equal to the CPU's over scales that a reciprocal multiply would round
   otherwise, and its one-launch quantize-and-write (kv_append_quant) the
   same; dq16 (scales rounded to bf16 first) on the dequantizing
   entries at M = 1 and 752 over q8_0, symmetric q4_0 and q4_1, the panel
   entry bit-equal, the output moved against dq16 off; and at the shapes
   of beam search and speculative decoding: the decode kernels at B = 5
   over a capacity of 784 (mixed positions, and every stream at one, timed
   beside SDPA), the dequantizing entries strided and in panels at M = 5
   and 8 (timed), the integer entries at M = 5 and 8, the one-launch SwiGLU
   at M = 5, 8 and 9 (timed beside the two-launch path);
3. parity at full width and depth 2, card against CPU in float32: the
   encoder (embedding, dense and from a q8_0 checkpoint), and the Qwen2
   decoder (a 160-position prefill and 8 greedy steps: the same tokens,
   logits within tolerance; a beam-5 search, captured on the card, the
   same tokens; speculative decoding at K = 7 and 8, the greedy tokens;
   the DTW attention tap within TAP_ATOL), dense and with q8_0 (layers and lm_head) and
   q4_0 (layers) weights from the ggml quantizers (a 16-position prefill
   and 4 steps, exact mode), each with the one-launch SwiGLU off, and once
   more with it on (q8_0) and with the decoder panelized (q4_0); in mode
   "int8" the q8_0 encoder and both decoders, and in the default mode a
   decoder of random q4_0 blocks as int32 words (the CPU's greedy tokens
   over a prefill and one step teacher-forced on the card), each card run
   launching the integer entry for every quantized linear and no other;
4. the main path at full width, each path with the launch counters set
   to 0 just before it and read just after (the encoder forward and the
   decode step run as CUDA graphs captured once and replayed; each replay
   adds the launches its capture recorded, ops/graphs.py):
   a. encode: write a random-weight (seed 0) F16 qwen2-audio checkpoint
      with the port's ggml writer, load it through
      capi.whisper_init_from_file_with_params in bf16, run whisper_full on
      a 30 s clip ``--calls`` times; check the launch counts, the output
      shape, finiteness, agreement with the plain attention path, and the
      replayed encode against the eager encoder_forward on the same window
      (bit-equal, the same fingerprint; ms per 30 s clip of each);
   b. audio -> text: attach a random bf16 Qwen2 decoder (seed 0, made on
      the card, ``--dec-layers`` deep) and answer 1 request on a 30 s clip
      through capi.whisper_full with ``--new-tokens`` new tokens, plus one
      request over the int8 KV cache; check the launch counts of the prefill and decode kernels
      and of the int8 cache writes (one a layer and forward, the prefill's
      included) against the prefills and decoder forwards the runs report,
      log the int8-cache request's decode ms per token beside the bf16
      one's and the device kernels of one decode step over each cache, the
      segments, tokens and logits, and, teacher-forced over the same
      tokens, the plain-attention path (cosine per step); each request
      decoded again from its prefill, replayed and as the eager step loop
      (the same tokens, bit-equal log-probabilities and logits, ms per
      token of each, and one forward's device ms by CUDA-graph replays
      between events), decode ms per token with the done flags read every
      1, 4, 8 and 16 steps, the captured steps' capture ms, and one decode
      step over each cache eager and replayed (kernels, host ms to enqueue
      it, host ms to its end);
   c. quantized encode: a checkpoint written as in (a) but CUT_LAYERS deep
      (at most ``--layers``; the cut checkpoint) through io.export.quantize_checkpoint to
      q8_0 and to q4_0, each loaded with keep_quantized=True and run
      through whisper_full: 4 launches of the flat entry per layer and
      clip, the embedding held against the same file loaded dense;
   d. quantized audio -> text: behind each quantized encoder a decoder
      (QUANT_DEC_LAYERS deep, at most ``--dec-layers``) with q8_0 or packed symmetric q4_0
      stacked weights and a quantized lm_head, random block contents made
      on the card, in the storage the
      decode step is tuned for, one request per configuration on one clip:
      q8_0 with the one-launch SwiGLU off (4 launches of the stacked entry
      per layer and decoder forward, one of the flat entry per forward for
      the lm_head, the logits held teacher-forced against the same weights
      dequantized to dense bf16), with it on (one fused launch per layer
      and decode step, the two-launch MLP at the 752-position prefill;
      logits teacher-forced against the switch off), and panelized (fewer
      tokens; the tokens of the first request); q4_0 strided with the
      SwiGLU on, panelized as the JAX loader panelizes (qkv, o, gate_up and
      lm_head in panels, down strided, no fused launch) and panelized with
      gate_up left strided (panels and the one-launch SwiGLU together: the
      strided request's tokens and logits, bit for bit). Every launch count
      is derived from the prefills and decoder forwards the run reports;
      every request is decoded again replayed and as the eager step loop,
      as in (b);
   e. mode "int8" and the word-packed q4_0 form, behind the q8_0 encoder,
      one request each on the same clip: the encoder alone in mode "int8"
      (4 launches of the flat integer entry per layer, none of a
      dequantizing entry; the embedding against the bf16 mode's), audio ->
      text in mode "int8" with the q8_0 and the q4_0 decoder of (d) (4
      launches of the stacked integer entry per layer and forward; the
      lm_head through the flat integer entry, or for q4_0's flat nibbles the
      exact dequantizing one; no fused launch; logits teacher-forced against
      the bf16 mode), and the same q4_0 bytes as int32 words in the default
      mode (the word entry for every linear and the lm_head; teacher-forced
      against the q4_0 request in mode "int8"); each request replayed
      against the eager step loop, as in (b);
   f. behind the bf16 context of (a), before (b): whisper_full on one clip
      under each encoder attention variant (set_attention_variants: lite,
      nopad, exp2, pexp16, single off), the variant's entry launched once
      per layer and call and no other attention entry, each setting
      replaying an encoder graph of its own, the median ms per call, one
      profiled call, the embedding against the default path's.
   g. behind (b)'s bf16 decoder (the bf16 and the int8 cache) and (d)'s
      q8_0 and q4_0 ones (blocks in panels with gate_up strided, the
      one-launch SwiGLU on): a greedy request, a beam-5 request, a request
      with speculative_k 7 and one with token_timestamps and max_len 16,
      each with the launch counters set to 0 just before it and read just
      after; every beam request decoded again captured and as the eager
      host loop (bit-equal tokens and log-probabilities), the speculative
      one captured and eager (bit-equal) with its iterations, its tokens
      the greedy request's or first different at a near tie (SPEC_TIE); the
      timestamps' segments concatenating to the greedy tokens, the times
      non-decreasing within the window; one beam and one verify step's
      device ms and the beam reorder's by graph replays.
   h. serving, HF loading and the w8a8 form: behind (b)'s bf16 decoder
      (bf16 cache, then the int8 cache) and (d)'s strided q8_0 decoder
      (one-launch SwiGLU at its default), transcribe_many over 6 clips of
      12-75 s (10 windows) through POOL_SLOTS slots, POOL_CHUNK tokens a
      chunk, plain and with speculative_k 7 (the int8 cache plain only),
      its EOS a token the windows' own B = 1 greedy streams emit at
      different steps, so that slots finish apart and refill mid-run at
      ragged positions; each run's launches derived from its chunks, its
      segments against each window's B = 1 decode (equal up to a first
      near tie, SPEC_TIE) and again with the chunks run eagerly
      (bit-equal); aggregate tokens/s, ms per chunk, refills, one captured
      pool step's and one verify iteration's device ms (q8_0 also with the
      one-launch SwiGLU off) beside a B = 1 step's; a 28-layer decoder of
      random w8a8 weights made on the card (one request, replayed against
      eager, the int8 product counted once per linear and forward, its
      step against the weights' byte bound); capi.whisper_full_parallel on
      an encoder-only context (120 s in 4 chunks, one B = 4 encode, each
      chunk against a B = 1 encode); a random full-width depth-2 HF
      checkpoint (torch.save, .bin) through io.hf.load_qwen2_audio onto the
      card and onto the CPU for decoder_quant None, q8_0 and w8a8 (the
      trees equal, the embedding and an 8-token request card against CPU).
      Phase 2 adds rows 4/5 at B = POOL_SLOTS with ragged positions, rows
      6-13 and 17 at M = 64, and the w8a8 product (torch._int_mm) exact
      against its plain version at M = 1, 8, 64 and 1500.
   i. after (d): tensor parallelism on the one card, 2 and 4 gloo ranks
      against one process (a 752-position prefill and 8 teacher-forced
      steps of the full-width 2-layer text tower, the slot pools, the
      sharded encoder), then 3 full-width training steps (``--tp-only``
      runs the build and this phase alone).
   j. after (h): the command line (python -m qwen2_audio_tpu_torch.cli) on
      the cut checkpoint with (h)'s HF decoder, bit-equal to capi.whisper_full,
      then the mul_mat bench (``--cli-only``).
   k. after (j): remote offload, the C API shim and the debug utilities on
      the cut checkpoint in float32 (``--surface-only``): the RPC server
      (runtime/rpc.py) as a process of its own, with the port's client,
      native/qa_rpc and the CLI's --rpc against it, the shim's command
      line (native_src/), each bit-equal to a local capi.whisper_full; the
      per-node encoder diff (utils/inspect_graph.py) card against CPU; the
      torch.profiler trace (utils/profiling.py) naming the kernels.
   The quantized paths (c, d) also run with dq16 switched on
   (set_dequant16): three encodes behind each quantized encoder (the
   embedding against the switch off) and one 8-token request per format
   (q8_0 per-projection MLP, q4_0 one-launch SwiGLU), teacher-forced
   against the same configuration with the switch off.
The last two lines of standard output are the kernels JSON line and the
{"ok": true, ...} line. Without a CUDA device the script exits 1.

Tolerances: mel 3e-4 after normalisation (the JAX suite's mel tolerance);
attention (encoder, causal prefill, decode) |kernel - plain| <= atol +
rtol * |plain| elementwise, float32 atol 2e-5 (summation order), bf16
atol 1e-3 + rtol 2**-7 (one bf16 ulp of the output, which rounds once on
each side, plus p's bf16 rounding; a dropped 64-key chunk or a missing
rescale reads 70x or more of it); for the causal prefill and decode
kernels in bf16 also + 2**-8 * (P |V|), the p-weighted mean of |V| (the
plain attention of |V|): each p is rounded to bf16 (2**-9 relative)
against another running maximum in the kernel than in the plain version,
which moves the output by up to that much where few keys carry the row,
as in a causal prefill's first rows (the decode kernels' range-edge cases,
on the streams of at most 128 visible rows; the decode kernels' other
cases are held to the bf16 tolerance alone); the attention variants the encoder
attention's, and under pexp16 also + 2**-8 * (P |V|), in float32 too: s - m
and p are rounded to bf16 against a running maximum (a dropped chunk or a missing
rescale still reads 10x or more, tests/test_torch_fa_variants.py), and
on the option case rms(kernel - its plain version) at most a quarter of
rms(kernel - the plain version without the option), as these tolerances
exceed what pexp16 and lite move; the int8 KV cache's quantizer bit-equal
to the CPU's;
dequantizing matmul |kernel - plain| <= atol + rtol * |plain| with atol
1e-4 * max|plain| (both sides make the same roundings, so only the order
of the float32 sums differs, and the tensor cores add in their own order)
and, for bf16 outputs, rtol 2**-7 and atol 2**-8 * max|plain| (the last
rounding may fall either way); the one-launch SwiGLU the same, and in fast
mode also 2 * gated_rounding_bound (the order of g's and u's sums moves a
gated value across a bf16 rounding boundary now and then: 2**-8 * the row's
max|gated| * max|Wd| for each of two such flips per output);
the exact-integer group matmul the dequantizing matmul's tolerance (xq is
bit-equal, so only the order of the float32 sums differs) and, with mins,
2% of max|dense| against the dense product (q8_1 rounding of x, the JAX
suite's bound, INT8_REL); 2-layer float32 card vs CPU 2e-3 (embedding and decoder
logits), in mode "int8" and for int32 words 1.5% of the largest CPU value
(INT8_PARITY_REL): the two differ where an upstream ulp rounds an xq the
other way, and one such flip of x[m, k] moves every output of row m, by
sx * sw * |q[k, n]|, so that many of the next layers' inputs flip in
turn. On the H100 the decoders stood 0.65-0.89% of the largest value off
the CPU, and the exact mode on the card 2.2-2.4% off the same CPU values
(both distances are logged), so the bound sits between them; the encoder
stood 0.73% off, its exact mode only 0.91%, and no bound separates the
two there. The launch counts do, everywhere: each card run must launch
the integer entries for every quantized linear and nothing else, and
phase 2 holds each entry to 1e-4 of its plain version. A wrong group, scale or
nibble order moves values by O(max); a token may differ only at a
near-tie; the bf16 kernel paths against the
plain-attention paths on the card cosine 0.99, the quantized paths against
their dense counterparts, and mode "int8" against the bf16 mode, the same.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F32_LANES = PEAK_F32 / 2     # float32 instructions a second over all lanes (an fma is 2 flops)
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

MEL_ATOL = 3e-4
ATTN_TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-3, 2.0 ** -7)}   # (atol, rtol)
# the causal kernel's bf16 check adds 2^-8 of the p-weighted mean of |V|: p
# rounded to bf16 against a chunk's running max, where few keys carry a row
P_ROUND = 2.0 ** -8
# the one-shot tile's edge cases add P_ROUND only where at most FEW_KEYS keys
# carry every row (kv_valid <= 64), as one p rounded the other way moves such
# an output by more than ATTN_TOL allows (1.074 of it at Tq 63, d 128,
# kv_valid 50); every other edge case is held to ATTN_TOL alone
FEW_KEYS = 64
# the decode kernels' range-edge cases add P_ROUND for the streams with at
# most FEW_DECODE_ROWS visible rows: p is rounded against a split's own
# maximum (in the parent kernel, a 64-key chunk's running one), and where
# few keys carry an output that cancels, one p rounded the other way moves
# it past ATTN_TOL (1.054 of it at S 2048, pos 64, in both kernels'
# arithmetic); every other decode case is held to ATTN_TOL alone
FEW_DECODE_ROWS = 2 * FEW_KEYS
PARITY_ATOL = 2e-3
# the DTW tap's pre-softmax scores, card against CPU in float32: the logits'
# tolerance (the scores sum over d = 128 products of activations that
# already carry the two devices' summation orders)
TAP_ATOL = PARITY_ATOL
MAIN_COS_MIN = 0.99
DEC_PARITY_PREFILL, DEC_PARITY_STEPS = 160, 8
TEXT_REQUESTS = 1     # audio -> text requests over the bf16 cache (+1 over int8)
QMM_ATOL_F32 = 1e-4   # of max|plain|
QMM_TOL_BF16 = (2.0 ** -8, 2.0 ** -7)   # (atol of max|plain|, rtol)
QUANT_CALLS = 6       # whisper_full calls of each quantized encode path
VARIANT_CALLS = 4     # whisper_full calls under each encoder attention variant (4f)
# encoder depth of the cut checkpoint, which the phases after 4h load (4c,
# 4j, 4k), and decoder depth of the quantized audio -> text paths (4d, 4e):
# their loads, quantizations, subprocesses, eager and teacher-forced passes
# and profiles cost host seconds in proportion to depth, and nothing they
# check depends on it
CUT_LAYERS = 8
QUANT_DEC_LAYERS = 8
QDEC_PARITY_PREFILL, QDEC_PARITY_STEPS = 16, 4
INT8_PARITY_STEPS = 2  # mode "int8" parity: the prefill and one cached step
FUSED_FLIPS = 2       # bf16 roundings of gated that may fall the other way, per output
PANEL_TOKENS = 8      # new tokens of the q8_0 panelized request
INT8_REL = 0.02       # of max|ref|: q8_1 rounding of x (the JAX suite's bound)
INT8_PARITY_REL = 0.015  # of max|cpu|: phase 3 in mode "int8" and for int32 words
BEAM = 5              # beams of the beam requests (FullParams.beam_size's default)
SPEC_K = 7            # speculative_k of phase 4g's speculative requests (verify M = 8)
# phase 4g: where the speculative request's tokens differ from the greedy
# request's, the greedy step's top-2 logit gap at the first difference must
# be at most SPEC_TIE x the widest logit difference, over the greedy tokens,
# between one-position forwards and (K + 1)-position ones (a near tie that
# the other width rounds the other way)
SPEC_TIE = 2.0
TS_MAX_LEN = 16       # max_len of phase 4g's token_timestamps request
POOL_SLOTS = 8        # decode slots of phase 4h's pools (max_streams)
POOL_CHUNK = 16       # tokens a plain chunk (chunk_tokens)
# the pool's clips (seconds): 1 + 3 + 1 + 2 + 2 + 1 = 10 windows of 30 s
POOL_CLIPS = (12.0, 75.0, 20.0, 45.0, 35.0, 15.0)
PARALLEL_PROCESSORS = 4
PARALLEL_COS_MIN = 0.9999     # full_parallel's chunks against B = 1 encodes
HF_TOKENS = 8                 # new tokens of the HF-loaded request, card and CPU
HF_PROMPT = 16                # its prompt: token embeddings, no audio
W8A8_M = (1, 8, 64, 1500)
STACKS_AFTER_S = 1100.0       # seconds of a run after which it prints its stacks
SUBPROCESS_S = 300            # deadline of each command-line subprocess (each takes ~20 s)


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, rounds: int = 7, iters: int = 20) -> float:
    """Device ms of one fn(): the median over ``rounds`` replays of a CUDA
    graph of ``iters`` calls, by CUDA events, so that the host's call rate
    (about 0.11 ms a wrapper call back to back) does not bound a short
    kernel's time. qmm_ab.py times with it too."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 100, batches: int = 5) -> float:
    """Host microseconds a call of fn() takes to enqueue its work (no
    synchronisation inside a batch: the card runs behind), the least over
    ``batches`` batches of ``calls``, as the host's other load only adds."""
    import torch
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def noisy_tone(seconds: float, seed: int, freq: float = 440.0):
    import numpy as np
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * freq * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phase 1: build
# --------------------------------------------------------------------------- #

def build() -> float:
    from qwen2_audio_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "setmaxnreg", "C75")):
                log(f"ptxas[{name}]: {line.strip()}")
    check_tile_ptxas(_build.build_log.get("quant_matmul"))
    check_tile_sass(sass_counts(str(_build._target("quant_matmul")), TILE_SASS_OPS))
    check_tile_ptxas(_build.build_log.get("quant_matmul_int8"), "quant_matmul_int8",
                     "qmm8_tile_kernel", INT8_TILE_KERNELS, spills=False)
    check_int8_sass(sass_counts(str(_build._target("quant_matmul_int8")), INT8_SASS_OPS))
    check_attention_sass(sass_counts(str(_build._target("attention_single")),
                                     ("HGMMA", "HMMA")))
    check_stream_sass({name: sass_counts(str(_build._target(name)), STREAM_SASS_OPS)
                       for name in STREAM_KERNELS})
    check_mel_sass(sass_counts(str(_build._target("mel")), ("FFMA", "HMMA", "HGMMA")))
    return secs


# the dequantizing matmul's fast M > 8 tile: rows of x a unit (16, 32, 64,
# 128, 192, 256) x weight form (int8 values, nibbles)
TILE_KERNELS = 12
TILE_SASS_OPS = ("HGMMA", "HMMA", "LDSM")
# ptxas's notes that it serialized a function's wgmma
WGMMA_SERIAL = ("C7518", "C7514", "C7517")


def ptxas_by_function(text: str) -> dict:
    """{kernel: [ptxas lines]} of a build log (nvcc -Xptxas -v): each line
    goes to the entry function ptxas was compiling or describing, or to the
    one it names."""
    import re
    out, fn = {}, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
        named = re.search(r"function '([^']+)'", line)
        out.setdefault(named.group(1) if named and not m else fn, []).append(line.strip())
    return out


def check_tile_ptxas(text, lib: str = "quant_matmul", kernel: str = "qmm_tile_kernel",
                     want: int = TILE_KERNELS, spills: bool = True) -> None:
    """A large-M tile (the dequantizing qmm_tile_kernel, or the integer
    qmm8_tile_kernel of quant_matmul_int8): logs each instantiation's
    registers and spills, and fails on a ptxas note that it serialized the
    tile's wgmma (WGMMA_SERIAL) and, without ``spills``, on a spill. Nothing
    to read where the library was reused from an earlier build."""
    import re
    if text is None:
        log(f"ptxas[{lib}]: library reused, no build log to check")
        return
    tiles = {fn: lines for fn, lines in ptxas_by_function(text).items() if kernel in fn}
    require(len(tiles) == want, f"{lib}: ptxas compiled {len(tiles)} instantiations of "
            f"{kernel}, not {want}")
    for fn, lines in tiles.items():
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"ptxas[{lib}]: {fn}: {line}")
        bad = [line for line in lines if any(c in line for c in WGMMA_SERIAL)]
        require(not bad, f"{lib}: ptxas serialized the wgmma of {fn}: {bad}")
        spilled = [line for line in lines
                   if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        require(spills or not spilled, f"{lib}: {fn} spills: {spilled}")


def check_tile_sass(counts: dict) -> None:
    """Every instantiation of the dequantizing matmul's fast M > 8 tile
    (qmm_tile_kernel) issues wgmma (HGMMA) and no mma.sync; logs the static
    counts of TILE_SASS_OPS of every kernel of the library; fails where
    cuobjdump is missing (empty counts)."""
    for fn, c in counts.items():
        log(f"sass[quant_matmul]: {fn}: {c}")
    tiles = {fn: c.split() for fn, c in counts.items() if "qmm_tile_kernel" in fn}
    require(len(tiles) == TILE_KERNELS,
            f"quant_matmul: {len(tiles)} instantiations of qmm_tile_kernel in the SASS counts, "
            f"not {TILE_KERNELS} (cuobjdump missing?)")
    require(all("HGMMA" in c and "HMMA" not in c for c in tiles.values()),
            "quant_matmul: an instantiation of qmm_tile_kernel issues no wgmma, or mma.sync")


# the integer group matmul's M > 8 tile: rows of x a unit (16, 32, 64, 128)
# x weight form; its M <= 8 kernel: x type x weight form x (M = 1 or more)
INT8_TILE_KERNELS = 12
INT8_SMALL_KERNELS = 12
INT8_SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "IDP", "FFMA", "FMUL", "FADD", "IADD3",
                 "LDSM", "PRMT", "LDG")


def check_int8_sass(counts: dict) -> None:
    """Every instantiation of the integer matmul's M > 8 tile
    (qmm8_tile_kernel) runs its group dots on wgmma (HGMMA) and none on
    mma.sync (HMMA), and every one of its M <= 8 kernel (qmm8_small_kernel)
    on int8 mma.sync (IMMA) and none on __dp4a (IDP.4A); logs each kernel's
    static counts of those and of the rescale's and the loads' instructions
    (FFMA, FMUL, FADD, IADD3, LDSM, PRMT, LDG); fails where cuobjdump is
    missing (empty counts)."""
    for fn, c in counts.items():
        log(f"sass[quant_matmul_int8]: {fn}: {c}")
    for kernel, want, ok, what in (
            ("qmm8_tile_kernel", INT8_TILE_KERNELS, lambda c: "HGMMA" in c and "HMMA" not in c,
             "issues no wgmma, or mma.sync"),
            ("qmm8_small_kernel", INT8_SMALL_KERNELS, lambda c: "IMMA" in c and "IDP" not in c,
             "issues no int8 mma.sync, or __dp4a")):
        found = {fn: c.split() for fn, c in counts.items() if kernel in fn}
        require(len(found) == want, f"quant_matmul_int8: {len(found)} instantiations of "
                f"{kernel} in the SASS counts, not {want} (cuobjdump missing?)")
        require(all(ok(c) for c in found.values()),
                f"quant_matmul_int8: an instantiation of {kernel} {what}")


def check_mel_sass(counts: dict) -> None:
    """The mel kernel runs float32 FMA and no tensor-core instruction: its
    SASS has FFMA and neither HMMA nor HGMMA; fails where cuobjdump is
    missing (empty counts)."""
    found = {fn: c.split() for fn, c in counts.items() if "mel_log_frames_kernel" in fn}
    for fn, c in found.items():
        log(f"sass[mel]: {fn}: {' '.join(c)}")
    require(len(found) == 1 and all("FFMA" in c for c in found.values()),
            "mel: no SASS counts of mel_log_frames_kernel with FFMA (cuobjdump missing?)")
    require(not any(op in c for c in found.values() for op in ("HMMA", "HGMMA")),
            "mel: the kernel issues tensor-core instructions")


# the weight-streaming kernels (fast mode): library, kernel, instantiations
# (qmm_stream_kernel: x type x packed x dq16; swiglu_coop_kernel: x type x
# packed x mins, at 1 n-tile of 8 rows in fused_mlp and 2, 4 or 8 in
# fused_mlp_rows)
STREAM_KERNELS = {"quant_matmul": ("qmm_stream_kernel", 8),
                  "fused_mlp": ("swiglu_coop_kernel", 8),
                  "fused_mlp_rows": ("swiglu_coop_kernel", 24)}
STREAM_SASS_OPS = ("HMMA", "HGMMA", "F2FP", "F2F", "FFMA", "FMUL", "FADD", "PRMT")


def check_stream_sass(counts: dict) -> None:
    """Every fast-mode instantiation of the two weight-streaming kernels
    (STREAM_KERNELS) runs its products on the tensor cores: it issues HMMA
    or HGMMA. Logs each instantiation's counts of the instructions a
    weight value costs (static counts in the code, not executed ones); fails
    where cuobjdump is missing (empty counts)."""
    for lib, (kernel, want) in STREAM_KERNELS.items():
        found = {fn: c for fn, c in counts[lib].items() if kernel in fn}
        for fn, c in found.items():
            log(f"sass[{lib}]: {fn}: {c}")
        require(len(found) == want, f"{lib}: {len(found)} instantiations of {kernel} in the "
                f"SASS counts, not {want} (cuobjdump missing?)")
        require(all("HMMA" in c.split() or "HGMMA" in c.split() for c in found.values()),
                f"{lib}: an instantiation of {kernel} issues neither HMMA nor HGMMA")


def check_attention_sass(counts: dict) -> None:
    """Every bf16 attention kernel runs its products on wgmma (HGMMA in each
    instantiation of attn_wgmma_kernel, six of them) and none on mma.sync
    (HMMA); fails where cuobjdump is missing (empty counts)."""
    for fn, n in counts.items():
        log(f"sass[attention_single]: {fn}: {n}")
    require(bool(counts), "attention_single: no SASS counts (cuobjdump missing, or "
            "no kernel issues HGMMA or HMMA)")
    wgmma = [fn for fn in counts if "attn_wgmma_kernel" in fn]
    require(len(wgmma) == 6 and all("HGMMA" in counts[fn] for fn in wgmma),
            f"attention_single: {len(wgmma)} wgmma instantiations with HGMMA, not 6")
    require(not any("HMMA" in c.split() for c in counts.values()),
            "attention_single: a kernel still issues mma.sync (HMMA)")


def sass_counts(lib: str, ops: tuple) -> dict:
    """{kernel: "op count ..."} of the SASS instructions named in ops, per
    kernel of a built library that has any (cuobjdump -sass); empty where
    cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=False).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn is not None:
            for op in ops:
                if f" {op}." in line or f" {op} " in line:
                    counts.setdefault(fn, {}).setdefault(op, 0)
                    counts[fn][op] += 1
    return {f: " ".join(f"{op} {n}" for op, n in c.items()) for f, c in counts.items()}


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #

# check_mel's cases: the main path's 30 s clip at 128 mels first (3002
# frames, the timed one), then the edges: 6002 frames, silence (-1.5
# everywhere), full-scale white noise, a tone centred on DFT bin 37 (a wide
# range in one frame: the Hann window leaves bins 36..38, the rest is float32
# rounding), clips shorter than 201 samples, a single-frame launch, frame
# counts one below, at and one above multiples of the kernel's 8 frames a
# CTA, and a filterbank that is not triangular and has an empty row
MEL_CASES = ("30 s, 128 mels", "60 s, 80 mels", "silence", "white noise", "bin tone",
             "100 samples", "200 samples", "one frame", "dense bank, empty row",
             "7 frames", "8 frames", "9 frames", "15 frames", "16 frames", "17 frames")


def _mel_inputs(name: str):
    """(samples, filters) of a MEL_CASES case; samples is None for the
    single-frame launch (400 samples of noise, n_frames = 1)."""
    import numpy as np
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    rng = np.random.default_rng(MEL_CASES.index(name))
    if name.endswith(" frames"):   # 160 c - 280 samples give c content frames
        c = int(name.split()[0])
        return noisy_tone(1.0, seed=c)[:160 * c - 280], mel_filterbank(80 if c < 10 else 128)
    if name == "dense bank, empty row":
        bank = rng.uniform(0, 0.05, (80, 201)).astype(np.float32)
        bank[5] = 0
        return noisy_tone(3.0, seed=13), bank
    bank = mel_filterbank(128 if name in ("30 s, 128 mels", "white noise", "bin tone",
                                          "200 samples") else 80)
    if name == "30 s, 128 mels":
        return noisy_tone(30.0, seed=1), bank
    if name == "60 s, 80 mels":
        return noisy_tone(60.0, seed=12, freq=1000.0), bank
    if name == "silence":
        return np.zeros(16000, np.float32), bank
    if name == "white noise":
        return rng.uniform(-1, 1, 48000).astype(np.float32), bank
    if name == "bin tone":
        return np.cos(2 * np.pi * 1480.0 * np.arange(32000) / 16000).astype(np.float32), bank
    if name == "one frame":
        return None, bank
    return rng.uniform(-0.5, 0.5, int(name.split()[0])).astype(np.float32), bank


def mel_case(device, name: str) -> dict:
    """One MEL_CASES case on the card: the kernel and its plain version on
    the same signal, both normalised (audio/mel.py normalize) and held to
    the float64 oracle, audio/mel.py log_mel_spectrogram_np; for the
    single-frame launch and for clips of at most 200 samples, whose front
    the oracle reflect-pads with fewer than 200 samples where pad_signal
    zero-extends first (as the JAX package does), the same float64 loop over
    pad_signal's frames. Returns the inputs and the three largest
    distances."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.audio.mel import (hann_window, log_mel_spectrogram_np,
                                                 normalize, pad_signal)
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_plain, mel_tables

    samples, filters = _mel_inputs(name)
    if samples is None:
        padded = np.random.default_rng(99).uniform(-0.5, 0.5, 400).astype(np.float32)
        n_len = n_frames = 1
    else:
        padded, n_len, _, n_frames = pad_signal(samples)
    if samples is not None and samples.size > 200:
        oracle = log_mel_spectrogram_np(samples, filters).data
    else:
        frames = np.lib.stride_tricks.sliding_window_view(
            padded.astype(np.float64), 400)[::160][:n_frames] * hann_window()
        spec = np.fft.rfft(frames, axis=-1)
        mel = (spec.real ** 2 + spec.imag ** 2) @ filters.T.astype(np.float64)
        oracle = normalize(torch.from_numpy(np.log10(np.maximum(mel, 1e-10))
                                            .astype(np.float32)), n_len)
    tables = mel_tables(filters, device)
    x = torch.from_numpy(padded).to(device)
    got = normalize(mel_frames(x, tables, n_frames), n_len).cpu()
    want = normalize(mel_frames_plain(x, tables, n_frames), n_len).cpu()
    dist = lambda a, b: (a - b).abs().max().item()   # noqa: E731
    return {"x": x, "tables": tables, "filters": filters, "n_frames": n_frames,
            "got": got, "err_plain": dist(got, want), "err_oracle": dist(got, oracle),
            "plain_err_oracle": dist(want, oracle)}


def check_mel(device) -> dict:
    """Every MEL_CASES case held to MEL_ATOL against the plain version and
    the float64 oracle (silence to -1.5 everywhere); the main case timed by
    graph replay (the kernel, the plain version and, as an orientation
    figure for the DFT part alone, torch.stft over the same frames: cuFFT,
    not a log-mel, and never called by the port)."""
    import math

    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.ops.mel_kernel import (FFT_FLOPS_PER_FRAME, mel_frames,
                                                      mel_frames_plain)

    errs = []
    for name in MEL_CASES:
        c = mel_case(device, name)
        log(f"mel case {name!r}: frames={c['n_frames']} n_mel={len(c['filters'])} "
            f"|kernel - plain|={c['err_plain']:.3e} |kernel - oracle|={c['err_oracle']:.3e} "
            f"|plain - oracle|={c['plain_err_oracle']:.3e} (normalised, tol {MEL_ATOL})")
        require(max(c["err_plain"], c["err_oracle"], c["plain_err_oracle"]) <= MEL_ATOL,
                f"mel case {name!r}: kernel, plain version and oracle disagree")
        if name == "silence":
            require(bool(((c["got"] + 1.5).abs() <= 1e-6).all()),
                    "mel: silence is not -1.5 everywhere")
        errs.append(c["err_plain"])
        if name == MEL_CASES[0]:
            main = c
    x, tables, n, filters = main["x"], main["tables"], main["n_frames"], main["filters"]
    # Least work of the function, not of the kernel's design: a 400-point
    # real FFT (2.5 N log2 N), the window, the power, the filterbank's
    # nonzeros (each bin falls in at most two triangles) and the log, per
    # frame; bytes are the signal and the filterbank in, the frames out.
    nnz = int(np.count_nonzero(filters))
    n_mels = len(filters)
    flops = n * (2.5 * 400 * math.log2(400) + 400 + 3 * 201 + 2 * nnz + n_mels)
    nbytes = 4 * (x.numel() + filters.size + n * n_mels)
    b_ms, b_by = bound(flops, nbytes, PEAK_F32)
    in_ranges = int(tables.weights.numel())
    design = n * (FFT_FLOPS_PER_FRAME + 2 * in_ranges)
    log(f"mel: bound counts {flops / 1e6:.1f} MFLOP (rFFT + {nnz} filterbank "
        f"nonzeros) and {nbytes / 1e6:.2f} MB; the kernel's FFT design does "
        f"{design / 1e6:.2f} MFLOP ({FFT_FLOPS_PER_FRAME} a frame + 2 x {in_ranges} "
        f"weights in the ranges; {design / PEAK_F32 * 1e3:.5f} ms at the f32 peak)")
    ms = graph_ms(lambda: mel_frames(x, tables, n))
    plain_ms = graph_ms(lambda: mel_frames_plain(x, tables, n))
    window = torch.hann_window(400, periodic=True, device=device)
    frames = x[:(n - 1) * 160 + 400]
    stft_ms = graph_ms(lambda: torch.stft(frames, 400, hop_length=160, window=window,
                                          center=False, return_complex=True))
    log(f"mel: {n} frames, {n_mels} mels: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}); torch.stft over the same frames (cuFFT, the DFT "
        f"alone, an orientation figure) {stft_ms:.5f} ms; graph replay, device time")
    return {"name": "mel_log_frames", "route": "cuda",
            "source": "qwen2_audio_tpu_torch/csrc/mel.cu",
            "replaces": "qwen2_audio_tpu/ops/mel_kernel.py:48",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def stream_ticket_mismatches(device, fmt: str, rounds: int = 64) -> tuple[int, int]:
    """The K-split M = 1 streaming matmul at the qkv shape (3584 -> 4608),
    ``rounds`` launches on each of two streams, queued behind a sleep on
    each so that the two streams' launches run at the same time, then one
    replay of a CUDA graph of 4 launches: (outputs that differ from the
    single-stream one's bits, outputs). Launches on two streams, or in a
    graph, count on ticket arrays of their own, so none may differ."""
    import torch
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    K, N = 3584, 4608
    packed = fmt == "q4_0"
    w = _rand_blocks(device, K, N, fmt, seed=70)
    q, sc = w["qs4" if packed else "qs"], w["scales"]
    entry = qm.quant_matmul4 if packed else qm.quant_matmul
    kw = {"fast": True, **({"off": 8} if packed else {})}
    x = torch.randn(1, K, generator=torch.Generator(device=device).manual_seed(71),
                    device=device).to(torch.bfloat16)
    require(qm.stream_plan(1, K, N, qm.sm_count(device))["ksplit"] > 1,
            "tickets: the qkv shape no longer splits K")
    ref = entry(x, q, sc, **kw)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    for s in streams:   # hold both streams until every launch is queued
        with torch.cuda.stream(s):
            torch.cuda._sleep(int(2e8))
    for _ in range(rounds):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(entry(x, q, sc, **kw))
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            captured = [entry(x, q, sc, **kw) for _ in range(4)]
    graph.replay()
    torch.cuda.synchronize()
    outs += captured
    return sum(not torch.equal(o, ref) for o in outs), len(outs)


def swiglu_stream_mismatches(device, fmt: str, rounds: int = 32,
                             dims=(3584, 18944)) -> tuple[int, int]:
    """The one-launch SwiGLU (cooperative: a grid barrier, tile tickets) at
    M = 1 and 64, ``rounds`` launches on each of two streams queued behind a
    sleep on each so that they run at once: (outputs that differ from the
    single-stream one's bits, outputs). Each stream counts on a ticket array
    of its own."""
    import torch
    from qwen2_audio_tpu_torch.ops import fused_mlp as fm
    D, I = dims
    gu, dn = _rand_mlp(device, D, I, D, fmt, seed=72)
    order = ("qs4", "scales") if fmt == "q4_0" else ("qs", "scales")
    entry = fm.fused_mlp4_sym_stacked if fmt == "q4_0" else fm.fused_mlp_stacked
    args = [w[k] for w in (gu, dn) for k in order]
    bad = total = 0
    for M in (1, 64):
        x = torch.randn(M, D, generator=torch.Generator(device=device).manual_seed(73 + M),
                        device=device).to(torch.bfloat16)
        ref = entry(x, *args, 1, fast=True)
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(device) for _ in range(2)]
        outs = []
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(int(1e8))
        for _ in range(rounds):
            for s in streams:
                with torch.cuda.stream(s):
                    outs.append(entry(x, *args, 1, fast=True))
        torch.cuda.synchronize()
        bad += sum(not torch.equal(o, ref) for o in outs)
        total += len(outs)
    return bad, total


def swiglu_graph_mismatches(device, M: int, dims=(3584, 18944)) -> tuple[int, int]:
    """The one-launch SwiGLU at M rows captured three times in a CUDA graph
    (on a side stream, after a warm-up) and replayed three times: (replayed
    outputs that differ from the eager call's bits, outputs)."""
    import torch
    from qwen2_audio_tpu_torch.ops import fused_mlp as fm
    D, I = dims
    gu, dn = _rand_mlp(device, D, I, D, "q8_0", seed=74)
    args = [w[k] for w in (gu, dn) for k in ("qs", "scales")]
    x = torch.randn(M, D, generator=torch.Generator(device=device).manual_seed(75),
                    device=device).to(torch.bfloat16)
    ref = fm.fused_mlp_stacked(x, *args, 1, fast=True)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        fm.fused_mlp_stacked(x, *args, 1, fast=True)
        with torch.cuda.graph(graph):
            outs = [fm.fused_mlp_stacked(x, *args, 1, fast=True) for _ in range(3)]
    bad = 0
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        bad += sum(not torch.equal(o, ref) for o in outs)
    return bad, 3 * len(outs)


def check_stream_tickets(device) -> None:
    for fmt in ("q8_0", "q4_0"):
        bad, total = stream_ticket_mismatches(device, fmt)
        log(f"tickets {fmt}: {total} K-split launches on two streams and in a graph, "
            f"{bad} not bit-equal to the single-stream output")
        require(bad == 0, f"tickets {fmt}: {bad} of {total} outputs differ")
        bad, total = swiglu_stream_mismatches(device, fmt)
        log(f"tickets {fmt}: {total} one-launch SwiGLU launches (M = 1, 64) on two streams, "
            f"{bad} not bit-equal to the single-stream output")
        require(bad == 0, f"SwiGLU tickets {fmt}: {bad} of {total} outputs differ")
    for M in (1, 8, 64):
        bad, total = swiglu_graph_mismatches(device, M)
        log(f"graph: the one-launch SwiGLU at M = {M} replayed {total} times, {bad} not "
            "bit-equal to the eager call")
        require(bad == 0, f"SwiGLU graph M = {M}: {bad} of {total} replays differ")


def _attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed):
    """q, k, v as (B, H, T, d) views; ``fused`` makes them head views of one
    (B, T, 3*H*d) projection output, the encoder's layout."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    if fused:
        qkv = torch.randn(B, T, 3 * H * d, generator=g).to(device, dtype)
        q, k, v = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in qkv.chunk(3, -1))
        q = (q * d ** -0.5)
    else:
        q = (torch.randn(B, H, T, d, generator=g) * d ** -0.5).to(device, dtype)
        k = torch.randn(B, Hkv, T, d, generator=g).to(device, dtype)
        v = torch.randn(B, Hkv, T, d, generator=g).to(device, dtype)
        if kv_valid < T:   # poison the masked tail
            k[:, :, kv_valid:] = 100.0
            v[:, :, kv_valid:] = 100.0
    return q, k, v


def check_attention(device) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops.flash_attention import (attention_single,
                                                           attention_single_plain)

    cases = [  # (dtype, B, H, Hkv, T, d, kv_valid, fused)
        (torch.bfloat16, 1, 20, 20, 1500, 64, 1500, True),
        (torch.float32, 1, 20, 20, 1500, 64, 1500, True),
        (torch.bfloat16, 2, 4, 4, 300, 64, 237, False),
        (torch.float32, 2, 4, 4, 300, 64, 237, False),
        (torch.bfloat16, 1, 8, 2, 200, 128, 200, False),
        (torch.float32, 1, 8, 2, 333, 64, 301, False),
    ]
    main = {}
    for i, (dtype, B, H, Hkv, T, d, kv_valid, fused) in enumerate(cases):
        q, k, v = _attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed=10 + i)
        got = attention_single(q, k, v, kv_valid)
        want = attention_single_plain(q, k, v, kv_valid)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        tname = str(dtype).removeprefix("torch.")
        atol, rtol = ATTN_TOL[tname]
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        log(f"attention {tname} B={B} H={H} Hkv={Hkv} T={T} d={d} "
            f"kv_valid={kv_valid}{' fused-qkv views' if fused else ''}: "
            f"max_abs_err={err:.3e}, {used:.3f} of the tolerance "
            f"(atol {atol} + rtol {rtol:.3g} * |plain|)")
        require(bool(torch.isfinite(got).all()), "attention kernel output not finite")
        require(used <= 1.0, f"attention kernel disagrees with its plain version: "
                f"{used:.3f} of the tolerance")
        if fused:
            flops = 4 * B * T * T * d * H
            nbytes = 4 * B * T * H * d * q.element_size()
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
            b_ms, b_by = bound(flops, nbytes, peak)
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            main[tname] = {
                "name": "attention_single", "route": "cuda",
                "source": "qwen2_audio_tpu_torch/csrc/attention_single.cu",
                "replaces": "qwen2_audio_tpu/ops/flash_attention.py:113",
                "max_abs_err": err,
                "ms": graph_ms(lambda: attention_single(q, k, v)),
                "plain_ms": time_ms(lambda: attention_single_plain(q, k, v), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, scale=1.0)),
            }
            extra = {"events_ms": time_ms(lambda: attention_single(q, k, v)),
                     "host_us": host_us(lambda: attention_single(q, k, v))}
            log(f"attention {tname} at the encoder shape (ms, library_ms: graph "
                "replays; events_ms: back to back; host_us: a call's enqueue): "
                + json.dumps({**{k_: main[tname][k_] for k_ in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}, **extra}))
    check_attention_edges(device)
    return main["bfloat16"], main["float32"]


def _held(got, want, tname: str, what: str, p_abs_v=None,
          any_type: bool = False) -> tuple[float, float]:
    """Max abs error and the share of the elementwise tolerance it uses;
    fails unless the kernel's output is finite and within tolerance.
    ``p_abs_v``: the plain attention of |V|, for the bf16 p-rounding term
    (``any_type``: in float32 too, as pexp16 rounds p to bf16 there)."""
    import torch
    diff = (got.float() - want.float()).abs()
    atol, rtol = ATTN_TOL[tname]
    tol = atol + rtol * want.float().abs()
    extra = ""
    if (tname == "bfloat16" or any_type) and p_abs_v is not None:
        tol = tol + P_ROUND * p_abs_v.float()
        extra = f" + {P_ROUND:.3g} * P|V|"
    used = (diff / tol).max().item()
    log(f"{what}: max_abs_err={diff.max().item():.3e}, {used:.3f} of the "
        f"tolerance (atol {atol} + rtol {rtol:.3g} * |plain|{extra})")
    require(bool(torch.isfinite(got).all()), f"{what}: kernel output not finite")
    require(used <= 1.0, f"{what}: kernel disagrees with its plain version "
            f"({used:.3f} of the tolerance)")
    return diff.max().item(), used


def _edge_case(device, B, H, Hkv, Tq, Tk, d, kv_valid, fused, seed):
    """bf16 q (B, H, Tq, d), k/v (B, Hkv, Tk, d), and k/v with NaN at and
    past kv_valid (what the kernel is given; the clean pair is the plain
    version's). ``fused``: head views of one (B, T, 3 H d) projection output
    (Tq = Tk, H = Hkv), the encoder's layout."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    if fused:
        qkv = torch.randn(B, Tq, 3 * H * d, generator=g).to(device, torch.bfloat16)
        q, k, v = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in qkv.chunk(3, -1))
        q = q * d ** -0.5
        clean = (k.clone(), v.clone())
    else:
        q = (torch.randn(B, H, Tq, d, generator=g) * d ** -0.5).to(device, torch.bfloat16)
        k = torch.randn(B, Hkv, Tk, d, generator=g).to(device, torch.bfloat16)
        v = torch.randn(B, Hkv, Tk, d, generator=g).to(device, torch.bfloat16)
        clean = (k.clone(), v.clone())
    k[:, :, kv_valid:] = float("nan")
    v[:, :, kv_valid:] = float("nan")
    return q, k, v, clean


def _edge_cases():
    """The bf16 tile's edges (128 queries a block, 128 keys a chunk): query
    and key lengths on either side of 64 and 128, Tq != Tk, ragged kv_valid,
    d = 64 and 128, GQA groups of 7 at B = 2, fused-QKV views:
    (B, H, Hkv, Tq, Tk, d, kv_valid, fused)."""
    return [
        (2, 14, 2, 1, 1, 64, 1, False), (2, 14, 2, 63, 63, 128, 50, False),
        (2, 14, 2, 64, 64, 64, 64, False), (2, 14, 2, 65, 65, 128, 1, False),
        (2, 14, 2, 127, 127, 64, 100, False), (2, 14, 2, 128, 128, 128, 127, False),
        (2, 14, 2, 129, 129, 64, 128, False), (2, 14, 2, 129, 129, 128, 129, False),
        (2, 14, 2, 1500, 1500, 64, 1500, False), (1, 14, 2, 1500, 1500, 128, 1337, False),
        (2, 14, 2, 65, 129, 64, 129, False), (2, 14, 2, 1, 1500, 128, 1400, False),
        (2, 7, 1, 129, 1, 64, 1, False), (1, 14, 2, 1500, 63, 64, 63, False),
        (2, 20, 20, 129, 129, 64, 129, True), (2, 20, 20, 1500, 1500, 64, 1201, True),
        (2, 8, 8, 1500, 1500, 128, 1500, True), (2, 8, 8, 127, 127, 128, 65, True),
    ]


def check_attention_edges(device) -> None:
    """The bf16 tile at its edges (``_edge_cases``) against the plain version
    on the clean inputs, with NaN at and past kv_valid in what the kernel
    reads: finite, and within ATTN_TOL, + P_ROUND * P|V| (the causal check's
    term) where at most FEW_KEYS keys carry every row: there one p rounded
    to bf16 the other way (scores summed in another order) moves an output
    by up to 2^-8 of P|V|, more than ATTN_TOL allows at a small output."""
    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    for i, (B, H, Hkv, Tq, Tk, d, kv_valid, fused) in enumerate(_edge_cases()):
        q, k, v, (kc, vc) = _edge_case(device, B, H, Hkv, Tq, Tk, d, kv_valid, fused, 400 + i)
        got = fa.attention_single(q, k, v, kv_valid)
        _held(got, fa.attention_single_plain(q, kc, vc, kv_valid), "bfloat16",
              f"edge single B={B} H={H} Hkv={Hkv} Tq={Tq} Tk={Tk} d={d} kv_valid={kv_valid}"
              + (" fused-qkv views" if fused else ""),
              fa.attention_single_plain(q, kc, vc.abs(), kv_valid)
              if kv_valid <= FEW_KEYS else None)


def _causal_case(device, dtype, B, Hq, Hkv, T, d, seed):
    """q, k, v as (B, H, T, d) head views in the decoder's layout: q and k
    from (B, T, H, d) tensors (the RoPE outputs), v a view into the fused
    QKV projection output."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, T, Hq, d, generator=g).to(device, dtype)
    k = torch.randn(B, T, Hkv, d, generator=g).to(device, dtype)
    qkv = torch.randn(B, T, (Hq + 2 * Hkv) * d, generator=g).to(device, dtype)
    v = qkv[..., (Hq + Hkv) * d:].unflatten(-1, (Hkv, d))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _causal_cases():
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    return [  # (dtype, B, Hq, Hkv, T, d, kv_valid); the first two: the prefill
        (bf, 1, 28, 4, 752, 128, 752), (f32, 1, 28, 4, 752, 128, 752),
        (bf, 2, 28, 4, 333, 128, 333), (f32, 2, 28, 4, 333, 128, 333),
        (bf, 1, 8, 2, 200, 128, 150), (f32, 1, 8, 2, 200, 128, 150),
        # the bf16 tile's edges (128 queries a block, 128 keys a chunk)
        (bf, 2, 14, 2, 1, 128, 1), (bf, 2, 14, 2, 129, 128, 129),
        (bf, 2, 14, 2, 129, 128, 100), (bf, 2, 7, 1, 129, 128, 64),
        (bf, 1, 28, 4, 752, 128, 600), (bf, 2, 28, 4, 752, 128, 751),
        (bf, 2, 14, 2, 65, 128, 65), (bf, 1, 14, 2, 128, 128, 127),
    ]


def check_causal(device, cases=None) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops.flash_attention import (attention_causal,
                                                           attention_causal_plain)
    main = {}
    for i, (dtype, B, Hq, Hkv, T, d, kv_valid) in enumerate(cases or _causal_cases()):
        q, k, v = _causal_case(device, dtype, B, Hq, Hkv, T, d, seed=30 + i)
        kc, vc = k.clone(), v.clone()   # the plain version's; NaN past kv_valid in k, v
        k[:, :, kv_valid:] = float("nan")
        v[:, :, kv_valid:] = float("nan")
        scale = d ** -0.5
        got = attention_causal(q, k, v, scale, kv_valid)
        want = attention_causal_plain(q, kc, vc, scale, kv_valid)
        tname = str(dtype).removeprefix("torch.")
        err, _ = _held(got, want, tname, f"causal {tname} B={B} Hq={Hq} Hkv={Hkv} "
                       f"T={T} d={d} kv_valid={kv_valid}",
                       attention_causal_plain(q, kc, vc.abs(), scale, kv_valid))
        if tname in main:
            continue
        # least work: the visible (query, key) pairs only
        pairs = B * sum(min(r + 1, kv_valid) for r in range(T))
        flops = 4 * d * Hq * pairs
        nbytes = 2 * B * T * (Hq + Hkv) * d * q.element_size()
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        main[tname] = {
            "name": "attention_causal", "route": "cuda",
            "source": "qwen2_audio_tpu_torch/csrc/attention_single.cu",
            "replaces": "qwen2_audio_tpu/ops/flash_attention.py:52",
            "max_abs_err": err,
            "ms": graph_ms(lambda: attention_causal(q, k, v, scale, kv_valid)),
            "plain_ms": time_ms(lambda: attention_causal_plain(q, k, v, scale, kv_valid),
                                iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, scale=scale, enable_gqa=True)),
        }
        extra = {"events_ms": time_ms(lambda: attention_causal(q, k, v, scale, kv_valid)),
                 "host_us": host_us(lambda: attention_causal(q, k, v, scale, kv_valid))}
        log(f"causal {tname} at the prefill shape (ms, library_ms: graph replays): "
            + json.dumps({**{k_: main[tname][k_] for k_ in (
                "ms", "plain_ms", "bound_ms", "library_ms")}, **extra}))
    return main["bfloat16"], main["float32"]


def _variant_cases():
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    enc = (1, 20, 20, 1500, 64, 1500, True)     # the encoder's fused-QKV views
    return [  # (entry, options, dtype, (B, H, Hkv, T, d, kv_valid, fused)); the
        # first case of each entry and option: the encoder shape, in bf16
        ("attention_lite", {}, bf, enc), ("attention_lite", {}, f32, enc),
        ("attention_lite", {"exp2": True}, bf, enc),
        ("attention_lite", {"sm_scale": 0.125}, bf, (2, 4, 4, 300, 64, 237, False)),
        ("attention_lite", {}, bf, (1, 8, 2, 333, 64, 301, False)),
        ("flash_attention_nopad", {}, bf, enc), ("flash_attention_nopad", {}, f32, enc),
        ("flash_attention_nopad", {"exp2": True}, bf, enc),
        ("flash_attention_nopad", {"sm_scale": 0.125}, bf, (1, 8, 2, 333, 64, 333, False)),
        ("attention_blockwise", {}, bf, enc), ("attention_blockwise", {}, f32, enc),
        ("attention_blockwise", {"exp2": True}, bf, enc),
        ("attention_blockwise", {"sm_scale": 0.125}, bf, (1, 8, 2, 200, 128, 150, False)),
        ("attention_blockwise", {"sm_scale": 0.125}, f32, (1, 8, 2, 200, 128, 150, False)),
        ("attention_single", {"exp2": True}, bf, enc),
        ("attention_single", {"exp2": True}, f32, enc),
        ("attention_single", {"pexp16": True}, bf, enc),
        ("attention_single", {"pexp16": True}, f32, enc),
        ("attention_single", {"pexp16": True, "exp2": True}, bf, (2, 4, 4, 300, 64, 237, False)),
        ("attention_single", {"sm_scale": 0.125}, f32, (1, 8, 2, 200, 128, 150, False)),
    ]


def _variant_edge_cases():
    """Each entry and option of ``_variant_cases`` across the bf16 tile's
    edges (128 queries a block, 128 keys a chunk; GQA groups of 7, NaN past
    kv_valid), in its format; held to ATTN_TOL, + P_ROUND where pexp16 is on
    or at most FEW_KEYS keys carry every row, as ``check_attention_edges``."""
    import torch
    bf = torch.bfloat16
    return [
        ("attention_lite", {}, bf, (2, 14, 2, 129, 128, 100, False)),
        ("attention_lite", {"exp2": True}, bf, (2, 14, 2, 1, 64, 1, False)),
        ("attention_lite", {"sm_scale": 0.125}, bf, (2, 14, 2, 1500, 64, 1201, False)),
        ("flash_attention_nopad", {"exp2": True}, bf, (2, 14, 2, 65, 128, 65, False)),
        ("flash_attention_nopad", {"sm_scale": 0.125}, bf, (2, 14, 2, 127, 64, 127, False)),
        ("attention_blockwise", {"exp2": True}, bf, (2, 14, 2, 129, 64, 1, False)),
        ("attention_blockwise", {"sm_scale": 0.125}, bf, (2, 14, 2, 128, 128, 127, False)),
        ("attention_single", {"exp2": True}, bf, (2, 14, 2, 63, 128, 63, False)),
        ("attention_single", {"pexp16": True}, bf, (2, 14, 2, 127, 128, 64, False)),
        ("attention_single", {"pexp16": True, "exp2": True}, bf, (2, 7, 1, 1500, 64, 1499, False)),
        ("attention_single", {"sm_scale": 0.125}, bf, (2, 14, 2, 129, 128, 128, False)),
    ]


def _variant_fns(entry: str, opts: dict, kv_valid: int):
    """The kernel's entry and its plain version for one variant case, each
    taking (q, k, v)."""
    from qwen2_audio_tpu_torch.ops import fa_variants as fv
    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    sc, e2, p16 = opts.get("sm_scale", 1.0), opts.get("exp2", False), opts.get("pexp16", False)
    if entry == "attention_lite":
        return (lambda q, k, v: fv.attention_lite(q, k, v, sm_scale=sc, kv_valid=kv_valid,
                                                  exp2=e2),
                lambda q, k, v: fv.attention_lite_plain(q, k, v, sm_scale=sc,
                                                        kv_valid=kv_valid, exp2=e2))
    if entry == "flash_attention_nopad":
        return (lambda q, k, v: fv.flash_attention_nopad(q, k, v, sm_scale=sc, exp2=e2),
                lambda q, k, v: fa.attention_single_plain(q, k, v, sm_scale=sc, exp2=e2))
    if entry == "attention_blockwise":
        return (lambda q, k, v: fa.attention_blockwise(q, k, v, sc, kv_valid, exp2=e2),
                lambda q, k, v: fa.attention_blockwise_plain(q, k, v, sc, kv_valid, exp2=e2,
                                                             block_k=1536))
    return (lambda q, k, v: fa.attention_single(q, k, v, kv_valid, sm_scale=sc, exp2=e2,
                                                pexp16=p16),
            lambda q, k, v: fa.attention_single_plain(q, k, v, kv_valid, sm_scale=sc,
                                                      exp2=e2, pexp16=p16))


def check_attention_variants(device) -> tuple[dict, dict]:
    """The lite and unpadded entries (TPU rows 18, 19), the blockwise entry
    (row 3 non-causal) and the exp2 / pexp16 options of the one-shot and
    causal kernels against their plain versions, with the tolerances of
    ``check_attention`` (+ P_ROUND * P|V| under pexp16, in float32 too: s - m
    and p are rounded to bf16 against another running maximum); the encoder-shape
    cases timed against the plain version, the default one-shot kernel and
    bf16 SDPA. Q is pre-scaled by d^-0.5 (and LOG2E under exp2) in its own
    type; where ``sm_scale`` is set, Q is unscaled and the kernel scales.
    Kernel, default and SDPA times are graph replays (``graph_ms``).
    Returns the kernels line's entries for rows 18 and 19."""
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import flash_attention as fa

    main, lines, timed = {}, {}, set()
    sdpa = default = None
    cases = [(c, False) for c in _variant_cases()] + [(c, True) for c in _variant_edge_cases()]
    for i, ((entry, opts, dtype, shape), edge) in enumerate(cases):
        B, H, Hkv, T, d, kv_valid, fused = shape
        q, k, v = _attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed=200 + i)
        if not fused and kv_valid < T:      # NaN past kv_valid: never read
            k[:, :, kv_valid:] = float("nan")
            v[:, :, kv_valid:] = float("nan")
        if "sm_scale" in opts:
            q = q * (1.0 / opts["sm_scale"])
        if opts.get("exp2"):
            q = q * torch.tensor(fa.LOG2E, dtype=dtype).item()
        kern, plain = _variant_fns(entry, opts, kv_valid)
        counter = _attention_entries()[entry]
        before = counter.launches
        got, want = kern(q, k, v), plain(q, k, v)
        torch.cuda.synchronize()
        require(counter.launches == before + 1, f"{entry}: not one launch")
        tname = str(dtype).removeprefix("torch.")
        what = (f"{entry} {json.dumps(opts)} {tname} B={B} H={H} Hkv={Hkv} T={T} d={d} "
                f"kv_valid={kv_valid}{' fused-qkv views' if fused else ''}")
        few = edge and kv_valid <= FEW_KEYS
        pv = plain(q, k, v.abs()) if opts.get("pexp16") or few else None
        err, _ = _held(got, want, tname, what, pv, any_type=True)
        key = (entry, json.dumps(opts))
        if not fused or dtype != torch.bfloat16 or key in timed:
            continue
        timed.add(key)
        if sdpa is None:
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            sdpa = graph_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, scale=1.0))
            default = graph_ms(lambda: fa.attention_single(q, k, v))
        flops = 4 * B * T * T * d * H
        b_ms, b_by = bound(flops, 4 * B * T * H * d * q.element_size(), PEAK_BF16)
        t = {"ms": graph_ms(lambda: kern(q, k, v)),
             "plain_ms": time_ms(lambda: plain(q, k, v), iters=5),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa,
             "default_single_ms": default}
        log(f"{what} at the encoder shape: " + json.dumps(t))
        main[key] = t
        if entry in ("attention_lite", "flash_attention_nopad") and not opts:
            name = entry.removeprefix("flash_")
            lines[name] = {"name": name, "route": "cuda",
                           "source": "qwen2_audio_tpu_torch/csrc/attention_single.cu",
                           "replaces": "qwen2_audio_tpu/ops/fa_variants.py:"
                                       + ("105" if name == "attention_lite" else "179"),
                           "max_abs_err": err,
                           **{k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")}}
    c = _causal_case(device, torch.bfloat16, 1, 28, 4, 752, 128, seed=260)
    q = c[0] * torch.tensor(fa.LOG2E, dtype=torch.bfloat16).item()
    scale = 128 ** -0.5
    got = fa.attention_causal(q, c[1], c[2], scale, exp2=True)
    want = fa.attention_causal_plain(q, c[1], c[2], scale, exp2=True)
    _held(got, want, "bfloat16", "attention_causal exp2 bf16 B=1 Hq=28 Hkv=4 T=752 d=128",
          fa.attention_causal_plain(q, c[1], c[2].abs(), scale, exp2=True))
    t2 = graph_ms(lambda: fa.attention_causal(q, c[1], c[2], scale, exp2=True))
    t1 = graph_ms(lambda: fa.attention_causal(c[0], c[1], c[2], scale))
    log(f"attention_causal exp2 at the prefill shape: {t2:.4f} ms against {t1:.4f} "
        "without exp2")
    require(set(lines) == {"attention_lite", "attention_nopad"},
            "attention variants: a kernels-line entry is missing")
    return lines["attention_lite"], lines["attention_nopad"]


def _option_case(device, dtype, B=1, H=20, T=1500, d=64):
    """q, k, v on which pexp16 and lite move every output by a known step:
    key 0 scores 0, every other key -0.69000244 (p = 0.501576, which rounds
    to bf16 0.5, 3.1e-3 low), so the running max is the row's max from the
    first chunk on and the kernel rounds p as the plain version does. bf16:
    V = 1, the default path 0.99609375 (l sums the unrounded p), pexp16 and
    lite 1.0; float32: V = 1 at key 0 only, the default 1.32826e-3, pexp16
    1.33245e-3 (lite computes the default there: p's cast to V's type is no
    cast)."""
    import torch
    q = torch.zeros(B, H, T, d)
    q[..., :2] = 1.0
    k = torch.zeros(B, H, T, d)
    k[..., 1:, 0] = -0.6875
    k[..., 1:, 1] = -0.0025
    v = torch.ones(B, H, T, d) if dtype == torch.bfloat16 else torch.zeros(B, H, T, d)
    v[..., 0, :] = 1.0
    return tuple(x.to(device, dtype) for x in (q, k, v))


def check_option_effects(device) -> None:
    """The tolerances of ``check_attention_variants`` cannot tell a kernel
    that ignores its pexp16 or lite flag from one that applies it: the
    option moves an output by less than they allow. On ``_option_case``'s
    inputs it moves every output by a known step, so the kernel under the
    option must sit on its own plain version and away from the plain
    version without it (rms distance at most a quarter of the other), and
    the kernel with the option off the other way round."""
    import torch
    from qwen2_audio_tpu_torch.ops import fa_variants as fv
    from qwen2_audio_tpu_torch.ops import flash_attention as fa

    default = (fa.attention_single, fa.attention_single_plain)
    cases = [  # (option, dtype, (kernel, plain) with it, (kernel, plain) without it)
        ("pexp16", torch.bfloat16, (functools.partial(fa.attention_single, pexp16=True),
                                    functools.partial(fa.attention_single_plain,
                                                      pexp16=True)), default),
        ("pexp16", torch.float32, (functools.partial(fa.attention_single, pexp16=True),
                                   functools.partial(fa.attention_single_plain,
                                                     pexp16=True)), default),
        ("lite", torch.bfloat16, (functools.partial(fv.attention_lite, sm_scale=1.0),
                                  functools.partial(fv.attention_lite_plain, sm_scale=1.0)),
         default),
    ]
    for option, dtype, (kern, plain), (kern_off, plain_off) in cases:
        q, k, v = _option_case(device, dtype)
        on, off, want, want_off = (f(q, k, v) for f in (kern, kern_off, plain, plain_off))
        torch.cuda.synchronize()
        what = f"{option} {str(dtype).removeprefix('torch.')} on the option case"
        ok, detail = option_followed(on, off, want, want_off)
        log(f"{what}: {detail}")
        require(ok, f"{what}: the kernel does not follow its {option} flag")


def option_followed(on, off, want, want_off) -> tuple[bool, str]:
    """Whether ``on`` (the kernel with an option) sits on ``want`` (its plain
    version) and away from ``want_off`` (the plain version without it), and
    ``off`` (the kernel without it) the other way round: rms distance at
    most a quarter of the other, which must not be 0."""
    def rms(a, b):
        return (a.float() - b.float()).square().mean().sqrt().item()

    near, far = rms(on, want), rms(on, want_off)
    near_off, far_off = rms(off, want_off), rms(off, want)
    detail = (f"kernel with it {near:.3e} from its plain version, {far:.3e} from the "
              f"plain version without it; kernel without it {near_off:.3e} / "
              f"{far_off:.3e}; the flag moves the kernel's output by {rms(on, off):.3e}")
    return far > 0 and near <= 0.25 * far and near_off <= 0.25 * far_off, detail


def _attention_entries() -> dict:
    """The encoder attention's entries by name, each with its launch count."""
    from qwen2_audio_tpu_torch.ops import fa_variants as fv
    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    return {e.__name__: e for e in (fa.attention_single, fa.attention_blockwise,
                                    fv.attention_lite, fv.flash_attention_nopad)}


def reciprocal_misses(n: int, seed: int):
    """n float32 values a for which a * float32(1 / 127) differs from the
    IEEE quotient a / 127: what a division by a Python number on the card
    would round otherwise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = (rng.random(40 * n) * 10.0 ** rng.uniform(-3, 3, 40 * n)).astype(np.float32)
    miss = a[a * (np.float32(1) / np.float32(127)) != a / np.float32(127)]
    if len(miss) < n:
        raise ValueError(f"only {len(miss)} of {n} values found")
    return miss[:n]


def kv_with_scales(amax, seed: int, shape=(2, 64, 4, 128)):
    """A (B, T, H, d) float32 K or V whose vectors have the given amax
    values (cycled), signs and positions random."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    B, T, H, d = shape
    a = np.resize(np.asarray(amax, np.float32), (B, T, H))
    x = (rng.uniform(-1, 1, shape) * a[..., None]).astype(np.float32)
    pos = rng.integers(0, d, (B, T, H))
    sign = rng.choice(np.float32([-1, 1]), (B, T, H))
    np.put_along_axis(x, pos[..., None], (sign * a)[..., None], axis=-1)
    return torch.from_numpy(x)


def _cache_diff(card: list, cpu: list) -> float:
    """The largest |card - cpu| over int8 cache tensors (values, scales),
    infinity where their NaN (never written) entries differ."""
    import torch
    worst = 0.0
    for a, b in zip(card, cpu):
        a = a.cpu()
        if not torch.equal(a.isnan(), b.isnan()):
            return float("inf")
        worst = max(worst, (a.float() - b.float()).nan_to_num().abs().max().item())
    return worst


def check_quantize_kv(device) -> dict:
    """The int8 KV cache's scales and values on the card bit-equal to the
    CPU's, over amax values where a reciprocal multiply rounds otherwise
    than IEEE division (ROADMAP.md section 3): the plain
    quantizer on the card, and the one-launch quantize-and-write
    ``kv_append_quant`` (bf16 and float32 K/V, V a strided view, B 2 at
    positions 3 and 180 of 200, rows past the capacity dropped) against its
    plain route on the CPU. Times the kernel at a decode step (T 1) and a
    752-position prefill (T 752) of the 7B decoder's 4 KV heads; returns
    the decode step's entry."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import _quantize_kv
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    amax = reciprocal_misses(512, seed=7)
    x = kv_with_scales(amax, seed=8)
    (q_c, s_c), (q_g, s_g) = _quantize_kv(x), _quantize_kv(x.to(device))
    a = torch.from_numpy(amax).to(device)
    old = int(((a / 127.0) != (a / torch.full_like(a, 127.0))).sum())
    log(f"quantize_kv: {x.numel() // x.shape[-1]} vectors over {len(amax)} amax values; "
        f"on the card amax / 127.0 (a Python number, the old code) differs from the IEEE "
        f"quotient on {old} of them; "
        f"scales bit-equal {torch.equal(s_g.cpu(), s_c)}, values bit-equal "
        f"{torch.equal(q_g.cpu(), q_c)}")
    require(torch.equal(s_g.cpu(), s_c) and torch.equal(q_g.cpu(), q_c),
            "quantize_kv: the card's int8 cache differs from the CPU's")

    def cache(dev, B=2, S=200, H=4):
        c = [torch.full((B, S, H, 128), -7, dtype=torch.int8, device=dev),
             torch.full((B, S, H), float("nan"), device=dev)]
        return c + [t.clone() for t in c]

    pos = torch.tensor([3, 180], dtype=torch.int32)
    for xdt in (torch.bfloat16, torch.float32):
        kv = torch.cat([x, x.flip(1) * 3.0], dim=-1).to(xdt)   # v: a strided view
        k, v = kv[..., :128].contiguous(), kv[..., 128:]
        want, got = cache("cpu"), cache(device)
        fd.kv_append_quant(k, v, *want, pos)
        fd.kv_append_quant(k.to(device), v.to(device), *got, pos.to(device))
        same = _cache_diff(got, want) == 0.0
        log(f"kv_append_quant ({str(xdt).removeprefix('torch.')} K/V): the card's int8 "
            f"cache bit-equal to the CPU's {same}")
        require(same, "kv_append_quant: the card's int8 cache differs from the CPU's")

    entry = None
    for T in (1, 752):   # a decode step, then a prefill
        g = torch.Generator(device="cpu").manual_seed(T)
        k, v = (torch.randn(1, T, 4, 128, generator=g).to(device, torch.bfloat16)
                for _ in range(2))
        c, posv = cache(device, B=1, S=2048), torch.tensor([783 if T == 1 else 0],
                                                           dtype=torch.int32, device=device)
        c_cpu = [t.cpu() for t in c]
        fd.kv_append_quant_plain(k.cpu(), v.cpu(), *c_cpu, posv.cpu())
        fd.kv_append_quant(k, v, *c, posv)
        err = _cache_diff(c, c_cpu)
        require(err == 0.0, f"kv_append_quant: T={T} differs from its plain version")
        nbytes = 2 * k.numel() * k.element_size() + 2 * k.numel() + 2 * T * 4 * 4 + 4
        b_ms, b_by = bound(0, nbytes, PEAK_F32)
        t = {"name": "kv_append_quant", "route": "cuda",
             "source": "qwen2_audio_tpu_torch/csrc/flash_decode.cu",
             "replaces": "qwen2_audio_tpu/models/qwen2_decoder.py:105",
             "max_abs_err": err,
             "ms": graph_ms(lambda: fd.kv_append_quant(k, v, *c, posv)),
             "plain_ms": time_ms(lambda: fd.kv_append_quant_plain(k, v, *c, posv)),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        log(f"kv_append_quant at T={T} (bf16 K/V, 4 KV heads, d 128), the plain route "
            f"on the card beside it: " + json.dumps(
                {k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms")}))
        entry = entry or t
    return entry


def _decode_case(device, qdt, kvdt, B, S, pos, seed, Hq=28, Hkv=4, d=128):
    """q (B, Hq, d) and a (B, S, Hkv, d) cache whose rows past each stream's
    position hold NaN (int8: junk values and NaN scales)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import _quantize_kv
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, Hq, d, generator=g).to(device, qdt)
    k = torch.randn(B, S, Hkv, d, generator=g)
    v = torch.randn(B, S, Hkv, d, generator=g)
    posv = torch.tensor(pos, dtype=torch.int32)
    past = torch.arange(S)[None, :] > posv[:, None]
    if kvdt == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        kq[past], vq[past] = 127, -128
        ks[past], vs[past] = float("nan"), float("nan")
        cache = (kq, ks, vq, vs)
    else:
        k, v = k.to(kvdt), v.to(kvdt)
        k[past], v[past] = float("nan"), float("nan")
        cache = (k, v)
    return q, [c.to(device) for c in cache], posv.to(device)


def _decode_cases():
    import torch
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    spread = [17, 63, 64, 783]   # one split, one full split, a second split of one row, S - 1
    return [  # (q dtype, cache dtype, B, S, positions); first of each kernel: main
        (bf, bf, 1, 2048, [783]), (bf, i8, 1, 2048, [783]),
        (bf, bf, 1, 784, [783]), (bf, i8, 1, 784, [783]),
        (f32, f32, 1, 784, [783]), (f32, bf, 1, 784, [783]), (f32, i8, 1, 784, [783]),
        (bf, bf, 4, 784, spread), (f32, f32, 4, 784, spread), (bf, i8, 4, 784, spread),
        (bf, bf, 1, 8192, [8191]), (bf, i8, 1, 8192, [8191]),
        *_decode_edge_cases(), *_beam_decode_cases(), *_pool_decode_cases(),
    ]


def _beam_decode_cases():
    """The beam step's shape: B = 5 hypotheses over a capacity of 784 (a
    752-position prefill and 32 tokens), 20 (stream, KV head) clusters: at
    mixed positions (one row, a split's edge, S - 1; the streams of few
    rows with the range-edge cases' p-rounding term) and, as a beam step
    has them, every stream at one position, each over both cache types."""
    import torch
    bf, i8 = torch.bfloat16, torch.int8
    return [(bf, kv, BEAM, 784, pos) for kv in (bf, i8)
            for pos in ([0, 63, 64, 400, 783], [783] * BEAM)]


def _pool_decode_cases():
    """The slot pool's step shape: B = POOL_SLOTS streams over the pool's
    capacity of 2048, each at its own position (a prefill of about 752 plus
    the tokens each has decoded since its refill), over both cache types."""
    import torch
    bf, i8 = torch.bfloat16, torch.int8
    pos = [783, 755, 801, 760, 790, 752, 812, 770][:POOL_SLOTS]
    return [(bf, kv, POOL_SLOTS, 2048, pos) for kv in (bf, i8)]


def _decode_edge_cases():
    """The split-KV kernel's range edges at a capacity of 2048 (16 splits of
    64-row granules at B 1, 4 at B 4): pos 0 (one row, 15 splits empty), 63
    and 64 (one split; a second split of one row), 1023 and 1024 (16 full
    splits; 9 splits of two stages, the last of one row), 2047 (S - 1), and
    B 4 at mixed positions, each over both cache types."""
    import torch
    bf, i8 = torch.bfloat16, torch.int8
    return ([(bf, kv, 1, 2048, [p]) for kv in (bf, i8) for p in (0, 63, 64, 1023, 1024, 2047)]
            + [(bf, kv, 4, 2048, [0, 64, 1024, 2047]) for kv in (bf, i8)])


def decode_p_abs_v(plain, q, cache, posv, scale):
    """P|V|, the plain decode attention over |V|, for the streams with at
    most FEW_DECODE_ROWS visible rows and 0 for the others (None where no
    stream has so few): the p-rounding term of the range-edge cases."""
    few = posv + 1 <= FEW_DECODE_ROWS
    if not bool(few.any()):
        return None
    # |V| past pos is masked by the plain version (int8: |-128| stays -128 there)
    absv = [*cache[:2], cache[2].abs(), *cache[3:]] if len(cache) == 4 else [cache[0],
                                                                             cache[1].abs()]
    return plain(q, *absv, posv, sm_scale=scale).float() * few[:, None, None]


def check_decode_tickets(device, rounds: int = 32) -> None:
    """What the decode kernel's merge assumes: the last CTA of each (stream,
    KV head) finds itself by a ticket counter in an array per stream and per
    graph capture (``quant_matmul.ticket_array``, kind "flash_decode"), and
    leaves it at 0. At the beam step's shape (B = BEAM, capacity 784, every
    stream at 783) and the pool's (B = POOL_SLOTS, capacity 2048, ragged)
    over both caches: ``rounds`` launches on each of two streams at once
    (queued behind a sleep on each) and three launches captured in a CUDA
    graph and replayed, every output bit-equal to the single-stream one, and
    after them every ticket array of the kernel back at 0."""
    import torch
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    bad = total = 0
    for i, (qdt, kvdt, B, S, pos) in enumerate(_beam_decode_cases()[1::2]
                                                + _pool_decode_cases()):
        q, cache, posv = _decode_case(device, qdt, kvdt, B, S, pos, seed=90 + i)
        kern = fd.flash_decode_quant if kvdt == torch.int8 else fd.flash_decode
        run = lambda: kern(q, *cache, posv, sm_scale=128 ** -0.5)   # noqa: E731
        require(fd.decode_plan(B, S, 4, 7, kvdt, n_sm, qdt)["splits"] > 1,
                f"decode tickets: B={B} S={S} no longer splits")
        ref = run()
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(device) for _ in range(2)]
        outs = []
        for st in streams:   # hold both streams until every launch is queued
            with torch.cuda.stream(st):
                torch.cuda._sleep(int(5e7))
        for _ in range(rounds):
            for st in streams:
                with torch.cuda.stream(st):
                    outs.append(run())
        torch.cuda.synchronize()
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            run()
            with torch.cuda.graph(graph):
                captured = [run() for _ in range(3)]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            outs += captured
        bad += sum(not torch.equal(o, ref) for o in outs)
        total += len(outs)
        del graph
    arrays = [t for key, t in qm._tickets.items() if key[0] == "flash_decode"]
    left = sum(int(t.count_nonzero()) for t in arrays)
    log(f"decode tickets: {total} launches at B = {BEAM} and {POOL_SLOTS} on two streams and "
        f"replayed in graphs, {bad} not bit-equal to the single-stream output; "
        f"{len(arrays)} ticket arrays, {left} counters not back at 0")
    require(bad == 0, f"decode tickets: {bad} of {total} outputs differ")
    require(left == 0, f"decode tickets: {left} counters not back at 0 after the runs")


def check_decode(device, cases=None) -> tuple[dict, dict]:
    """Rows 4 and 5 against their plain versions over every case (NaN past
    each stream's position; the range-edge cases with the p-rounding term
    for streams of few rows, ``decode_p_abs_v``), each case's launch plan
    (splits, CTAs holding keys) logged; at B 1 and bf16 q, the first case of each kernel and
    capacity timed by CUDA-graph replays beside bf16 SDPA over the prefix,
    the back-to-back event time and the host's enqueue time logged beside
    them. The first case of each kernel (capacity 2048, pos 783: the audio
    -> text request's) is its main entry; the beam step's (B 5, capacity
    784, every stream at 783) is timed the same way and kept in the entry
    under "B5"."""
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    main, timed, beam, pool = {}, set(), {}, {}
    edges = _decode_edge_cases() + _beam_decode_cases()
    check_decode_tickets(device)
    for i, (qdt, kvdt, B, S, pos) in enumerate(cases or _decode_cases()):
        q, cache, posv = _decode_case(device, qdt, kvdt, B, S, pos, seed=50 + i)
        d = q.shape[-1]
        scale = d ** -0.5
        quant = kvdt == torch.int8
        kern = fd.flash_decode_quant if quant else fd.flash_decode
        plain = fd.flash_decode_quant_plain if quant else fd.flash_decode_plain
        got = kern(q, *cache, posv, sm_scale=scale)
        want = plain(q, *cache, posv, sm_scale=scale)
        tname = str(qdt).removeprefix("torch.")
        Hq, Hkv = q.shape[1], cache[0].shape[2]
        plan = fd.decode_plan(B, S, Hkv, Hq // Hkv, kvdt,
                              torch.cuda.get_device_properties(device).multi_processor_count,
                              qdt)
        what = (f"decode q {tname} cache {str(kvdt).removeprefix('torch.')} B={B} S={S} "
                f"pos={pos} (splits {plan['splits']}, stages {plan['stages']}, "
                f"{plan['ctas_with_keys'](pos)} of {plan['splits'] * Hkv * B} CTAs hold keys)")
        p_abs_v = (decode_p_abs_v(plain, q, cache, posv, scale)
                   if (qdt, kvdt, B, S, pos) in edges else None)
        err, _ = _held(got, want, tname, what, p_abs_v)
        name = "flash_decode_quant" if quant else "flash_decode"
        beam_step = B == BEAM and len(set(pos)) == 1
        pool_step = B == POOL_SLOTS and len(set(pos)) > 1 and S == 2048
        if not (B == 1 or beam_step or pool_step) or qdt != torch.bfloat16 \
                or (name, B, S) in timed:
            continue
        timed.add((name, B, S))
        n = sum(p + 1 for p in pos)   # cache rows the function must read
        nbytes = (2 * n * Hkv * d * cache[0].element_size() + 2 * q.numel() * q.element_size()
                  + (2 * n * Hkv * 4 if quant else 0))
        b_ms, b_by = bound(4 * Hq * d * n, nbytes, PEAK_BF16)
        run = lambda: kern(q, *cache, posv, sm_scale=scale)   # noqa: E731
        lib = None
        if not quant and pool_step:   # each stream's rows by a mask, NaN rows zeroed
            q4 = q[:, :, None]
            kp, vp = (torch.nan_to_num(c).transpose(1, 2) for c in cache)
            mask = (torch.arange(S, device=device)[None, :] <= posv[:, None].long())
            mask = mask[:, None, None, :]
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                q4, kp, vp, attn_mask=mask, scale=scale, enable_gqa=True))
        elif not quant:   # every stream at pos[0]
            q4 = q[:, :, None]
            kp, vp = (c[:, :pos[0] + 1].transpose(1, 2) for c in cache)
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                q4, kp, vp, scale=scale, enable_gqa=True))
        t = {"name": name, "route": "cuda",
             "source": "qwen2_audio_tpu_torch/csrc/flash_decode.cu",
             "replaces": "qwen2_audio_tpu/ops/flash_decode.py:43",
             "max_abs_err": err, "ms": graph_ms(run),
             "plain_ms": time_ms(lambda: plain(q, *cache, posv, sm_scale=scale)),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        log(f"{name} at B={B} S={S} pos={pos[0]} (graph replay; SDPA as library_ms): "
            + json.dumps({**{k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")},
                          "events_ms": time_ms(run, iters=50), "host_us": host_us(run)}))
        keep = {k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
        if beam_step:
            beam[name] = keep
        elif pool_step:
            pool[name] = keep
        else:
            main.setdefault(name, t)
    for name, t in beam.items():
        main[name]["B5"] = t
    for name, t in pool.items():
        main[name][f"B{POOL_SLOTS} ragged"] = t
    return main["flash_decode"], main["flash_decode_quant"]


def _rand_blocks(device, K: int, N: int, fmt: str, seed: int, layers: int = 0) -> dict:
    """Random block contents made on the card: every byte value, -128
    included."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    g = torch.Generator(device=device).manual_seed(seed)
    return random_quant_linear(g, ((layers,) if layers else ()) + (K, N), fmt)


def _quantized(device, K: int, N: int, ttype, seed: int) -> dict:
    """A random dense (K, N) weight through the ggml quantizer."""
    import numpy as np
    from qwen2_audio_tpu_torch.quant.qparams import quantize_array_for_device
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32) * 0.02
    return quantize_array_for_device(w, ttype, device=device)


def check_quant_matmul(device, dims=(3584, 18944, 156032, 1280)) -> dict:
    """The four strided entries against their plain versions and, at every
    case, the panel entry over the same weight in contiguous column panels,
    bit-equal to the strided one; returns the kernels line's entries by
    name, each at one shape of the main path. ``dims``: the decoder's hidden
    and intermediate sizes, its vocabulary and the encoder's width."""
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm

    bf, f32 = torch.bfloat16, torch.float32
    D, I, V, E = dims
    weights = {   # name: (K, N, dict, stacked)
        "qkv q8_0": (D, D + D // 7 * 2, _rand_blocks(device, D, D + D // 7 * 2, "q8_0", 70,
                                                    layers=2), True),
        "gate_up q8_0": (D, 2 * I, _rand_blocks(device, D, 2 * I, "q8_0", 71, layers=2), True),
        "down q4_0": (I, D, _rand_blocks(device, I, D, "q4_0", 72, layers=2), True),
        "gate_up q4_0": (D, 2 * I, _rand_blocks(device, D, 2 * I, "q4_0", 73, layers=2), True),
        "lm_head q8_0": (D, V, _rand_blocks(device, D, V, "q8_0", 74), False),
        "lm_head q4_0": (D, V, _rand_blocks(device, D, V, "q4_0", 75), False),
        "fc1 q8_0": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q8_0, 76), False),
        "fc1 q4_0": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q4_0, 77), False),
        "fc1 q4_1": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q4_1, 78), False),
        "fc2 q6_K": (4 * E, E, _quantized(device, 4 * E, E, GGMLType.Q6_K, 79), False),
    }
    # the large-M tile's edges: N a multiple of 16 and not of the 128-wide
    # tile, K a multiple of 32 and not of the 64-deep stage (K = 1280 for
    # q6_K, whose blocks span 256), f32 scales with group 32
    RK, RN = E + 32, E + 16
    weights["rag q8_0"] = (RK, RN, _rand_blocks(device, RK, RN, "q8_0", 80, layers=2), True)
    weights["rag q4_0"] = (RK, RN, _rand_blocks(device, RK, RN, "q4_0", 81), False)
    weights["rag q6_K"] = (E, RN, _quantized(device, E, RN, GGMLType.Q6_K, 82), False)
    r8 = weights["rag q8_0"][2]
    weights["rag q8_0 f32s"] = (RK, RN, {"qs": r8["qs"], "scales": r8["scales"].float()}, True)
    # panel widths that are not a multiple of the tile's 128 columns
    p = next(f for f in range(2, RN // 16 + 1) if RN // 16 % f == 0)
    panel_bn = {"rag q8_0": RN // p, "rag q4_0": 16, "rag q6_K": 16 * p,
                "rag q8_0 f32s": RN // p}
    panels = {}   # name: the weight in column panels, made at its first case
    cases = [   # (weight, M, x dtype, fast, kernels-line name or None)
        ("qkv q8_0", 1, bf, True, None), ("qkv q8_0", 1, f32, False, None),
        ("qkv q8_0", 7, bf, True, None), ("qkv q8_0", 752, bf, True, None),
        ("qkv q8_0", 752, f32, False, None), ("qkv q8_0", 752, f32, True, None),
        ("gate_up q8_0", 1, bf, True, "quant_matmul_stacked"),
        ("gate_up q8_0", 752, bf, True, None),
        ("down q4_0", 1, bf, True, None), ("down q4_0", 1, f32, False, None),
        ("down q4_0", 7, f32, True, None), ("down q4_0", 752, bf, True, None),
        ("down q4_0", 752, f32, False, None),
        ("gate_up q4_0", 1, bf, True, "quant_matmul4_stacked"),
        ("gate_up q4_0", 752, bf, True, None),
        ("lm_head q8_0", 1, bf, True, "lm_head"), ("lm_head q8_0", 1, f32, False, None),
        ("lm_head q4_0", 1, bf, True, "lm_head"), ("lm_head q4_0", 7, bf, False, None),
        ("fc1 q8_0", 1500, bf, True, "quant_matmul"), ("fc1 q8_0", 1500, f32, False, None),
        ("fc1 q8_0", 7, f32, True, None),
        ("fc1 q4_0", 1500, bf, True, "quant_matmul4"), ("fc1 q4_0", 1500, f32, False, None),
        ("fc1 q4_0", 1, bf, False, None),
        ("fc1 q4_1", 1500, bf, True, None), ("fc1 q4_1", 7, f32, False, None),
        ("fc2 q6_K", 1500, bf, True, None), ("fc2 q6_K", 1500, f32, False, None),
        ("fc2 q6_K", 1, bf, True, None), ("fc2 q6_K", 7, f32, False, None),
        ("gate_up q8_0", 753, bf, True, None), ("fc1 q8_0", 129, bf, True, None),
        ("fc1 q4_1", 65, f32, True, None),
        ("rag q8_0", 9, bf, True, None), ("rag q8_0", 65, f32, True, None),
        ("rag q8_0", 129, bf, True, None), ("rag q8_0", 753, bf, True, None),
        ("rag q8_0", 129, f32, False, None),
        ("rag q4_0", 9, bf, True, None), ("rag q4_0", 65, bf, True, None),
        ("rag q4_0", 753, f32, True, None),
        ("rag q6_K", 129, bf, True, None), ("rag q6_K", 753, f32, True, None),
        ("rag q8_0 f32s", 65, bf, True, None), ("rag q8_0 f32s", 753, f32, True, None),
        # the M <= 8 streaming kernel at N = 1296 (a ragged last column group),
        # in panels of 16 and 48
        ("rag q4_0", 1, bf, True, None), ("rag q6_K", 1, bf, True, None),
        ("rag q8_0 f32s", 1, f32, True, None),
        # the beam step's M = 5 and a K = 7 speculative verify forward's M =
        # 8 (the M <= 8 limit), every entry strided and in panels, timed
        *((w, M, bf, True, "small") for M in (BEAM, 8, 64)
          for w in ("gate_up q8_0", "gate_up q4_0", "lm_head q8_0", "lm_head q4_0")),
        ("qkv q8_0", BEAM, f32, False, None), ("down q4_0", 8, bf, True, None),
    ]
    rows = {"quant_matmul": 207, "quant_matmul_stacked": 474,
            "quant_matmul4": 1010, "quant_matmul4_stacked": 819,
            "quant_matmul_panel": 334, "quant_matmul_panel_stacked": 555,
            "quant_matmul_panel4": 657, "quant_matmul_panel4_stacked": 735}
    # the panel entries' kernels-line shapes: gate_up (stacked) and the lm_head
    panel_lines = {"quant_matmul_stacked", "quant_matmul4_stacked", "lm_head"}
    main = {}
    for i, (wname, M, dtype, fast, line) in enumerate(cases):
        K, N, qw, stacked = weights[wname]
        packed = "qs4" in qw
        off = 8 if packed and "mins" not in qw else 0
        g = torch.Generator(device=device).manual_seed(90 + i)
        x = torch.randn(M, K, generator=g, device=device).to(dtype)
        q, sc = qw["qs4" if packed else "qs"], qw["scales"]
        li = (1,) if stacked else ()
        kw = {"fast": fast, **({"off": off} if packed else {})}
        entry = getattr(qm, "quant_matmul" + ("4" if packed else "")
                        + ("_stacked" if stacked else ""))
        plain = qm.quant_matmul4_plain if packed else qm.quant_matmul_plain
        ql, scl = (q[1], sc[1]) if stacked else (q, sc)
        got = entry(x, q, sc, *li, **kw)
        want = plain(x, ql, scl, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max().item()
        atol, rtol = (QMM_ATOL_F32 * top, 0.0) if dtype == f32 else \
            (QMM_TOL_BF16[0] * top, QMM_TOL_BF16[1])
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        tname = str(dtype).removeprefix("torch.")
        what = (f"{entry.__name__} {wname} K={K} N={N} M={M} x {tname} "
                f"{'fast' if fast else 'exact'} group {K // scl.shape[0]} scales "
                f"{str(sc.dtype).removeprefix('torch.')}")
        log(f"{what}: max_abs_err={diff.max().item():.3e} (max|plain| {top:.3f}), "
            f"{used:.3f} of the tolerance (atol {atol:.3e} + rtol {rtol:.3g} * |plain|)")
        require(got.shape == (M, N) and got.dtype == dtype, f"{what}: shape or type")
        require(bool(torch.isfinite(got).all()), f"{what}: kernel output not finite")
        require(used <= 1.0, f"{what}: kernel disagrees with its plain version "
                f"({used:.3f} of the tolerance)")
        if "mins" in qw and not fast:   # the min term, added outside the kernel
            ref = x.float() @ qm.dequantize_weight(qw)
            rel = ((qm.quant_linear(x, qw).float() - ref).abs().max() / ref.abs().max()).item()
            log(f"{what}: quant_linear with mins vs dense product: {rel:.3e} of max|ref|")
            require(rel <= QMM_ATOL_F32, f"{what}: the min term is off ({rel})")
        # the same values in column panels: the same bits
        if wname not in panels:
            panels[wname] = qm.panelize_weight(qw, panel_bn.get(wname, 0))
        pw = panels[wname]
        pq, psc = pw["qs4_p" if packed else "qs_p"], pw["scales_p"]
        pentry = getattr(qm, "quant_matmul_panel" + ("4" if packed else "")
                         + ("_stacked" if stacked else ""))
        pgot = pentry(x, pq, psc, *li, **kw)
        torch.cuda.synchronize()
        require(torch.equal(pgot, got), f"{what}: {pentry.__name__} over {pq.shape[-3]} "
                f"panels of width {pq.shape[-1]} differs from the strided entry")
        if "mins" in qw:
            require(torch.equal(qm.quant_linear_panel(x, pw, fast=fast),
                                qm.quant_linear(x, qw, fast=fast)),
                    f"{what}: quant_linear_panel differs from quant_linear")
        if line is None and M not in (1, 7, 752, 1500):
            continue   # an edge case: checked, not timed
        # the entry's time beside its bound, its plain version and one
        # torch.matmul on the dequantized weight in x's type
        nbytes = (ql.numel() + scl.numel() * scl.element_size()
                  + (x.numel() + M * N) * x.element_size())
        b_ms, b_by = bound(2.0 * M * K * N, nbytes, PEAK_BF16 if fast else PEAK_F32)
        dense = qm.block_weight(ql, scl, packed=packed, off=off).to(dtype)
        big = K * N > 1e8
        # kernel and library by graph replay (back-to-back calls are bound by
        # the host's call rate near 0.1 ms), at M <= 8 the events' figure
        # beside it
        run = lambda: entry(x, q, sc, *li, **kw)   # noqa: E731
        t = {"ms": graph_ms(run),
             "plain_ms": time_ms(lambda: plain(x, ql, scl, **kw), iters=3 if big else 10,
                                 warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": graph_ms(lambda: x @ dense)}
        if M <= 8:
            t["events_ms"] = time_ms(run, iters=50)
            t["bound_share"] = b_ms / t["ms"]
        del dense
        log(f"{what}: " + json.dumps(t))
        if line in rows:
            main[line] = {"name": line, "route": "cuda",
                          "source": "qwen2_audio_tpu_torch/csrc/quant_matmul.cu",
                          "replaces": f"qwen2_audio_tpu/ops/quant_matmul.py:{rows[line]}",
                          "shape": what, "max_abs_err": diff.max().item(), **t}
        small = {k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")}
        if line == "small":
            main[entry.__name__][f"M{M}"] = {**small, "max_abs_err": diff.max().item()}
        if line in panel_lines or line == "small":
            # the panel entry at the same inputs: the strided case's bound and
            # library time hold for it, its own time and its plain version's
            pplain = qm.quant_matmul_panel4_plain if packed else qm.quant_matmul_panel_plain
            pl_, psl = (pq[1], psc[1]) if stacked else (pq, psc)
            require(torch.equal(pplain(x, pl_, psl, **kw), want),
                    f"{what}: the panel entry's plain version differs from the strided one's")
            prun = lambda: pentry(x, pq, psc, *li, **kw)   # noqa: E731
            pt = {**t, "ms": graph_ms(prun), "events_ms": time_ms(prun, iters=50),
                  "plain_ms": time_ms(lambda: pplain(x, pl_, psl, **kw), iters=3, warmup=1)}
            pt["bound_share"] = b_ms / pt["ms"]
            pwhat = what.replace(entry.__name__, pentry.__name__) + \
                f" panels {pq.shape[-3]} x {pq.shape[-1]}"
            log(f"{pwhat}: " + json.dumps(pt) + f"; strided entry {t['ms']:.4f} ms")
            if line == "small":
                main[pentry.__name__][f"M{M}"] = {
                    **{k_: pt[k_] for k_ in small}, "max_abs_err": diff.max().item()}
                continue
            main[pentry.__name__] = {
                "name": pentry.__name__, "route": "cuda",
                "source": "qwen2_audio_tpu_torch/csrc/quant_matmul.cu",
                "replaces": f"qwen2_audio_tpu/ops/quant_matmul.py:{rows[pentry.__name__]}",
                "shape": pwhat, "max_abs_err": diff.max().item(), "strided_ms": t["ms"], **pt}
    require(set(main) == set(rows), "quant matmul: a kernels-line entry is missing")
    del weights, panels
    torch.cuda.empty_cache()
    return main


def check_dequant16(device, dims=(3584, 18944, 1280)) -> None:
    """The dequantizing entries with ``dq16`` (each scale rounded to bf16
    before the multiply, fast mode) against their plain versions with the
    tolerances of ``check_quant_matmul``, at M = 1 and 752, bf16 and float32
    x, over q8_0, symmetric q4_0 and q4_1; each case also through the panel
    entry (bit-equal) and against dq16 off (float32 x: the outputs must
    differ, or the flag was not taken). gate_up timed with and without it."""
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm

    bf, f32 = torch.bfloat16, torch.float32
    D, I, E = dims
    weights = {   # name: (K, N, dict, stacked)
        "gate_up q8_0": (D, 2 * I, _rand_blocks(device, D, 2 * I, "q8_0", 171, layers=2), True),
        "gate_up q4_0": (D, 2 * I, _rand_blocks(device, D, 2 * I, "q4_0", 172, layers=2), True),
        "fc1 q8_0": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q8_0, 173), False),
        "fc1 q4_0": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q4_0, 174), False),
        "fc1 q4_1": (E, 4 * E, _quantized(device, E, 4 * E, GGMLType.Q4_1, 175), False),
    }
    for i, (wname, M, dtype) in enumerate(
            (w, M, t) for w in weights for M in (1, 752) for t in (bf, f32)):
        K, N, qw, stacked = weights[wname]
        packed = "qs4" in qw
        kw = {"fast": True, **({"off": 8 if "mins" not in qw else 0} if packed else {})}
        g = torch.Generator(device=device).manual_seed(300 + i)
        x = torch.randn(M, K, generator=g, device=device).to(dtype)
        q, sc = qw["qs4" if packed else "qs"], qw["scales"]
        li = (1,) if stacked else ()
        ql, scl = (q[1], sc[1]) if stacked else (q, sc)
        entry = getattr(qm, "quant_matmul" + ("4" if packed else "")
                        + ("_stacked" if stacked else ""))
        plain = qm.quant_matmul4_plain if packed else qm.quant_matmul_plain
        got = entry(x, q, sc, *li, dq16=True, **kw)
        want = plain(x, ql, scl, dq16=True, **kw)
        off16 = entry(x, q, sc, *li, **kw)
        pw = qm.panelize_weight({k_: v for k_, v in qw.items() if k_ != "mins"})
        pentry = getattr(qm, "quant_matmul_panel" + ("4" if packed else "")
                         + ("_stacked" if stacked else ""))
        pgot = pentry(x, pw["qs4_p" if packed else "qs_p"], pw["scales_p"], *li, dq16=True,
                      **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max().item()
        atol, rtol = (QMM_ATOL_F32 * top, 0.0) if dtype == f32 else \
            (QMM_TOL_BF16[0] * top, QMM_TOL_BF16[1])
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        moved = (got.float() - off16.float()).abs().max().item()
        what = (f"{entry.__name__} dq16 {wname} K={K} N={N} M={M} x "
                f"{str(dtype).removeprefix('torch.')} scales "
                f"{str(sc.dtype).removeprefix('torch.')}")
        log(f"{what}: max_abs_err={diff.max().item():.3e} (max|plain| {top:.3f}), "
            f"{used:.3f} of the tolerance; dq16 moves the output by {moved:.3e}")
        require(bool(torch.isfinite(got).all()) and used <= 1.0,
                f"{what}: kernel disagrees with its plain version ({used:.3f})")
        require(torch.equal(pgot, got), f"{what}: {pentry.__name__} differs")
        if dtype == f32:
            require(moved > atol, f"{what}: dq16 did not change the output")
        if dtype == bf and wname.startswith("gate_up"):
            t_on = graph_ms(lambda: entry(x, q, sc, *li, dq16=True, **kw))
            t_off = graph_ms(lambda: entry(x, q, sc, *li, **kw))
            log(f"{what}: {t_on:.4f} ms with dq16, {t_off:.4f} ms without")
    del weights
    torch.cuda.empty_cache()


def _ties_and_zeros(device, M: int, K: int, dtype, seed: int):
    """Random x with an all-zero group in row 0 and, in the last row, a
    group whose max is 127 (sx = 1) holding values on .5 rounding ties."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device)
    x[0, :32] = 0.0
    ties = [127.0] + [0.5, 1.5, 2.5, -3.5, -0.5, 126.5] * 5 + [4.5]
    x[-1, 32:64] = torch.tensor(ties, device=device)
    return x.to(dtype)


def check_quantize_activations(device, Ks=(3584, 18944, 1280)) -> int:
    """The q8_1 quantizing kernel against its plain version on the card:
    xq and sx bit-equal, bf16 and float32 x, M = 1, 7, 752, 1500, as int8
    and in the M > 8 tile's f16 layouts (K's order and the words form's,
    sx transposed in 16-row blocks)."""
    import torch
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for M in (1, 7, 752, 1500):
            for K in Ks:
                x = _ties_and_zeros(device, M, K, dtype, seed=150 + n)
                xq, sx = q8.quantize_activations(x)
                pq, ps = q8.quantize_activations_plain(x)
                torch.cuda.synchronize()
                what = f"quantize_activations M={M} K={K} x {str(dtype).removeprefix('torch.')}"
                require(torch.equal(xq, pq) and torch.equal(sx, ps),
                        f"{what}: xq or sx differs from the plain version "
                        f"({int((xq != pq).sum())} xq, {int((sx != ps).sum())} sx)")
                require(float(sx[0, 0]) == 0.0 and xq[-1, 32:39].tolist()
                        == [127, 0, 2, 2, -4, 0, 126], f"{what}: zero group or ties")
                for form in (q8.STRIDED, q8.WORDS):   # the M > 8 tile's f16 layouts
                    tq, ts = q8._tile_activations(x, form)
                    pq, ps = q8.tile_activations_plain(x, form)
                    torch.cuda.synchronize()
                    require(torch.equal(tq, pq) and torch.equal(ts, ps),
                            f"{what}: the tile's layout {form} differs from its plain version "
                            f"({int((tq != pq).sum())} xq, {int((ts != ps).sum())} sx)")
                n += 1
    log(f"quantize_activations: {n} cases bit-equal to the plain version (ties, zero groups)")
    return n


def check_int8_matmul(device, dims=(3584, 18944, 156032, 1280)) -> dict:
    """Rows 14, 15 and 16, the exact-integer group matmul, against their
    plain versions at M = 1, 7, 752, 1500 over the decoder's, the lm_head's
    and the encoder's K x N, the M > 8 tile's ragged edges, the beam's M = 5
    and a verify's M = 8, and the one-launch M <= 8 kernel's edges (M = 2,
    3, 5, 6, 8 at N = 1296 and 41 groups of K, split unevenly); the
    equalities the design promises (row 14 = row 15 on the same values, row
    16 = row 15 over nibble bytes with off 8 on the same bytes, two runs) bit
    for bit; the M <= 8 kernel's split tickets back at 0; at M = 1, 5, 8, 752
    and 1500 times by CUDA-graph replay beside bound, plain and library.
    Returns the kernels line's three entries."""
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as q4b

    bf, f32 = torch.bfloat16, torch.float32
    D, I, V, E = dims
    check_quantize_activations(device, (D, I, E))

    def b32(qw):
        return {"qs4b": q4b.pack_b32(qw["qs4"]), "scales": qw["scales"]}

    def flat_q4(ttype, seed):   # a real quantizer's q4 blocks, with a leading axis of 1
        return {k: v[None] for k, v in _quantized(device, E, 4 * E, ttype, seed).items()}

    gu4 = _rand_blocks(device, D, 2 * I, "q4_0", 161, layers=2)
    dn4 = _rand_blocks(device, I, D, "q4_0", 162, layers=2)
    fc1_4 = flat_q4(GGMLType.Q4_0, 165)
    weights = {   # name: dict of stacked (L, ...) leaves, or flat leaves
        "qkv q8_0": _rand_blocks(device, D, D + D // 7 * 2, "q8_0", 160, layers=2),
        "gate_up q8_0": _rand_blocks(device, D, 2 * I, "q8_0", 163, layers=2),
        "gate_up q4_0": gu4, "gate_up q4_0 b32": b32(gu4),
        "down q4_0": dn4, "down q4_0 b32": b32(dn4),
        "lm_head q8_0": _rand_blocks(device, D, V, "q8_0", 164),
        "lm_head q4_0 b32": _rand_blocks(device, D, V, "q4_0", 166),
        "fc1 q8_0": _quantized(device, E, 4 * E, GGMLType.Q8_0, 167),
        "fc1 q4_0": fc1_4, "fc1 q4_0 b32": b32(fc1_4),
        "fc1 q4_1": flat_q4(GGMLType.Q4_1, 168),
        "fc2 q5_1": _quantized(device, 4 * E, E, GGMLType.Q5_1, 169),
    }
    weights["lm_head q4_0 b32"] = b32(weights["lm_head q4_0 b32"])
    # the large-M tile's edges: N a multiple of 16 and not of the 128-wide
    # tile, K a multiple of 32 and not of the 128-deep stage, f32 scales
    RK, RN = E + 32, E + 16
    rag4 = _rand_blocks(device, RK, RN, "q4_0", 180, layers=2)
    rag8 = _rand_blocks(device, RK, RN, "q8_0", 181)
    weights.update({"rag q8_0": rag8, "rag q4_0": rag4, "rag q4_0 b32": b32(rag4),
                    "rag q8_0 f32s": {"qs": rag8["qs"], "scales": rag8["scales"].float()}})
    rows = {"quant_matmul_int8": ("quant_matmul_int8.py", 53),
            "quant_matmul_int8_stacked": ("quant_matmul_int8.py", 178),
            "quant_matmul_q4b_stacked": ("quant_matmul_q4b.py", 105)}
    cases = [   # (weight, M, x dtype, kernels-line entry or None)
        ("lm_head q8_0", 1, bf, None), ("lm_head q8_0", 7, f32, None),
        ("fc1 q8_0", 1500, bf, "quant_matmul_int8"), ("fc1 q8_0", 1500, f32, None),
        ("fc1 q8_0", 752, bf, None), ("fc1 q8_0", 1, f32, None),
        ("fc2 q5_1", 1500, bf, None), ("fc2 q5_1", 7, f32, None),
        ("qkv q8_0", 1, bf, None), ("qkv q8_0", 752, f32, None),
        ("gate_up q8_0", 1, bf, "quant_matmul_int8_stacked"), ("gate_up q8_0", 752, bf, None),
        ("gate_up q8_0", 7, f32, None),
        ("down q4_0", 1, bf, None), ("down q4_0", 752, bf, None),
        ("down q4_0 b32", 1, bf, None), ("down q4_0 b32", 752, bf, None),
        ("down q4_0 b32", 7, f32, None),
        ("gate_up q4_0", 1, bf, None), ("gate_up q4_0 b32", 1, bf, "quant_matmul_q4b_stacked"),
        ("gate_up q4_0 b32", 752, bf, None),
        ("lm_head q4_0 b32", 1, bf, None), ("lm_head q4_0 b32", 7, f32, None),
        ("fc1 q4_0", 1500, bf, None), ("fc1 q4_0 b32", 1500, f32, None),
        ("fc1 q4_0 b32", 1500, bf, None),
        ("fc1 q4_1", 1500, bf, None), ("fc1 q4_1", 7, f32, None),
        ("gate_up q8_0", 753, bf, None), ("fc1 q8_0", 129, f32, None),
        ("rag q8_0", 9, bf, None), ("rag q8_0", 65, f32, None), ("rag q8_0", 129, bf, None),
        ("rag q8_0", 753, bf, None), ("rag q4_0", 9, bf, None), ("rag q4_0", 129, bf, None),
        ("rag q4_0", 753, f32, None), ("rag q4_0 b32", 65, bf, None),
        ("rag q4_0 b32", 753, bf, None), ("rag q4_0 b32", 9, f32, None),
        ("rag q8_0 f32s", 129, bf, None), ("rag q8_0 f32s", 753, f32, None),
        # the beam step's M = 5 and a K = 7 verify forward's M = 8
        ("lm_head q8_0", BEAM, bf, None), ("lm_head q8_0", 8, bf, None),
        ("gate_up q8_0", BEAM, bf, None), ("gate_up q8_0", 8, f32, None),
        ("down q4_0", BEAM, bf, None), ("down q4_0", 8, bf, None),
        ("gate_up q4_0 b32", BEAM, bf, None), ("gate_up q4_0 b32", 8, bf, None),
        ("lm_head q4_0 b32", 8, bf, None), ("qkv q8_0", BEAM, f32, None),
        # the M <= 8 kernel's edges: a ragged tile and an uneven K split
        ("rag q8_0", 2, f32, None), ("rag q4_0", 3, bf, None), ("rag q4_0 b32", 6, bf, None),
        ("rag q8_0 f32s", 5, bf, None), ("rag q8_0 f32s", 8, f32, None),
    ]
    main, worst = {}, 0.0
    for i, (wname, M, dtype, line) in enumerate(cases):
        qw = weights[wname]
        form = "qs4b" if "qs4b" in qw else "qs4" if "qs4" in qw else "qs"
        q, sc = qw[form], qw["scales"]
        if form == "qs4b" and q.dim() == 2:   # the flat use: a one-layer view
            q, sc = q[None], sc[None]
        stacked = q.dim() == 3
        K = sc.shape[-2] * 32
        N = q.shape[-1]
        off = 8 if form == "qs4" and "mins" not in qw else 0
        li = (q.shape[0] - 1,) if stacked else ()
        if form == "qs4b":
            entry, kw = q4b.quant_matmul_q4b_stacked, {}
            plain = q4b.quant_matmul_q4b_plain
        elif stacked:
            entry, kw = q8.quant_matmul_int8_stacked, {"off": off}
            plain = (lambda x_, q_, s_: q8.quant_matmul_int8_packed_plain(x_, q_, s_, off=off)) \
                if form == "qs4" else q8.quant_matmul_int8_plain
        else:
            entry, kw, plain = q8.quant_matmul_int8, {}, q8.quant_matmul_int8_plain
        ql, scl = (q[li[0]], sc[li[0]]) if stacked else (q, sc)
        g = torch.Generator(device=device).manual_seed(170 + i)
        x = torch.randn(M, K, generator=g, device=device).to(dtype)
        got = entry(x, q, sc, *li, **kw)
        want = plain(x, ql, scl)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max().item()
        atol, rtol = (QMM_ATOL_F32 * top, 0.0) if dtype == f32 else \
            (QMM_TOL_BF16[0] * top, QMM_TOL_BF16[1])
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        worst = max(worst, used)
        tname = str(dtype).removeprefix("torch.")
        what = (f"{entry.__name__} {wname} K={K} N={N} M={M} x {tname}"
                f"{f' off {off}' if form == 'qs4' else ''} scales "
                f"{str(sc.dtype).removeprefix('torch.')}")
        log(f"{what}: max_abs_err={diff.max().item():.3e} (max|plain| {top:.3f}), "
            f"{used:.3f} of the tolerance (atol {atol:.3e} + rtol {rtol:.3g} * |plain|)")
        require(got.shape == (M, N) and got.dtype == dtype, f"{what}: shape or type")
        require(bool(torch.isfinite(got).all()), f"{what}: kernel output not finite")
        require(used <= 1.0, f"{what}: kernel disagrees with its plain version "
                f"({used:.3f} of the tolerance)")
        require(torch.equal(got, entry(x, q, sc, *li, **kw)), f"{what}: two runs differ")
        if form == "qs4b":   # the words are the nibble bytes of row 15 with off 8
            twin = q8.quant_matmul_int8_stacked(x, q4b.unpack_b32(q), sc, li[0], off=8)
            require(torch.equal(got, twin), f"{what}: differs from row 15 over the same bytes")
        elif form == "qs" and not stacked:   # flat = stacked on the same values
            twin = q8.quant_matmul_int8_stacked(x, q[None], sc[None], 0)
            require(torch.equal(got, twin), f"{what}: differs from row 15 on the same values")
        if "mins" in qw:     # the min term, added outside on the raw x
            lin = q8.quant_linear_int8_stacked(x, qw, li[0]) if stacked else \
                q8.quant_linear_int8(x, qw)
            ref = x.float() @ qm.dequantize_weight({k: v[li[0]] if stacked else v
                                                   for k, v in qw.items()})
            rel = ((lin.float() - ref).abs().max() / ref.abs().max()).item()
            log(f"{what}: with mins against the dense product: {rel:.3e} of max|ref| "
                "(q8_1 rounding of x)")
            require(rel <= INT8_REL, f"{what}: the min term is off ({rel})")
        if line is None and M not in (1, BEAM, 8, 752, 1500):
            continue
        # time by CUDA-graph replay beside the bound (weight + scales + x +
        # out once; 2 M K N int8 operations), the plain version and one
        # torch.matmul on the dequantized weight in x's type
        nbytes = (ql.numel() * ql.element_size() + scl.numel() * scl.element_size()
                  + (x.numel() + M * N) * x.element_size())
        b_ms, b_by = bound(2.0 * M * K * N, nbytes, PEAK_INT8)
        # what the tile could reach, logged beside the row and kept out of the
        # kernels line: ggml's float32 rescale of every (output, group) pair
        # (a multiply and an fma) on the CUDA cores beside the integer
        # products at the int8 peak and the bytes (M > 8; the M <= 8
        # kernel's dots are int32, bound by its bytes)
        r_ms = max(b_ms, 2.0 * M * N * (K // 32) / PEAK_F32_LANES * 1e3) if M > 8 else b_ms
        vals = q4b.unpack_b32(ql) if form == "qs4b" else ql
        dense = qm.block_weight(vals, scl, packed=form != "qs", off=8 if form == "qs4b" else off
                                ).to(dtype)
        t = {"ms": graph_ms(lambda: entry(x, q, sc, *li, **kw)),
             "plain_ms": time_ms(lambda: plain(x, ql, scl), iters=2, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": graph_ms(lambda: x @ dense)}
        del dense
        log(f"{what}: " + json.dumps(t) + f"; bound with the rescale {r_ms:.4f} ms")
        if line is not None:
            src, row = rows[line]
            main[line] = {"name": line, "route": "cuda",
                          "source": "qwen2_audio_tpu_torch/csrc/quant_matmul_int8.cu",
                          "replaces": f"qwen2_audio_tpu/ops/{src}:{row}",
                          "shape": what, "max_abs_err": diff.max().item(), **t}
    log(f"int8 group matmul: {len(cases)} cases, worst {worst:.3f} of the tolerance")
    require(set(main) == set(rows), "int8 group matmul: a kernels-line entry is missing")
    tickets = qm.ticket_array(device, torch.cuda.current_stream().cuda_stream,
                              kind="quant_matmul_int8")
    torch.cuda.synchronize()
    require(int(tickets.abs().sum()) == 0,
            "int8 group matmul: the M <= 8 kernel's split tickets were not left at 0")
    del weights
    torch.cuda.empty_cache()
    return main


def _rand_mlp(device, K: int, I: int, D: int, fmt: str, seed: int, layers: int = 2):
    """Random stacked gate_up (layers, K, 2 I) and down (layers, I, D) block
    dicts of one of the fused kernel's flavours, made on the card: q8_0 and
    packed symmetric q4_0 as ``random_quant_linear`` makes them; "q6_K" int8
    values -32..31 with float32 scales per 16; "q5_1" values 0..31 and "q4_1"
    nibbles, each with float32 mins near minus the group's middle. Valid
    block contents, but no quantizer's output."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in ((layers, K, 2 * I), (layers, I, D)):
        w = random_quant_linear(g, shape, "q4_0" if fmt in ("q4_0", "q4_1") else "q8_0")
        if fmt == "q6_K":
            rows, cols = shape[1] // 16, shape[2]
            w = {"qs": w["qs"] >> 2,
                 "scales": (0.5 + torch.rand((layers, rows, cols), generator=g,
                                             device=device)) * (0.02 / 18.5)}
        elif fmt == "q5_1":
            w = {"qs": (w["qs"] >> 3) + 16, "scales": (w["scales"].float() * 8).half()}
        if fmt in ("q5_1", "q4_1"):
            d = w["scales"].float()
            mid = 16.0 if fmt == "q5_1" else 8.0
            w["mins"] = -d * (mid + torch.rand(d.shape, generator=g, device=device) - 0.5)
        out.append(w)
    return out


# rows the one-launch SwiGLU is checked at (fast mode; the exact mode at 1, 7
# and 64) and timed at (q8_0 and q4_0, bf16 x), against the two-launch path
FUSED_ROWS = (1, 2, BEAM, 7, 8, 9, 12, 16, 32, 33, 64)
FUSED_TIMED_ROWS = (1, 2, BEAM, 8, 9, 12, 16, 32, 64)


def check_fused_mlp(device, dims=(3584, 18944)) -> dict:
    """The five one-launch SwiGLU entries against the plain version at the
    decoder's width; returns the kernels line's entry (q8_0, M = 1) with the
    other timed rows beside it."""
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import fused_mlp as fm
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    from qwen2_audio_tpu_torch.ops.linear import _fused_form

    bf, f32 = torch.bfloat16, torch.float32
    D, I = dims
    flavours = {   # format: (entry, leaf order)
        "q8_0": (fm.fused_mlp_stacked, ("qs", "scales")),
        "q6_K": (fm.fused_mlp_stacked, ("qs", "scales")),
        "q5_1": (fm.fused_mlp_m_stacked, ("qs", "scales", "mins")),
        "q4_0": (fm.fused_mlp4_sym_stacked, ("qs4", "scales")),
        "q4_1": (fm.fused_mlp4_stacked, ("qs4", "scales", "mins")),
    }
    line, by_m = {}, {}
    for fi, (fmt, (entry, order)) in enumerate(flavours.items()):
        gu, dn = _rand_mlp(device, D, I, D, fmt, seed=120 + fi)
        packed = "qs4" in gu
        args = [w[k] for w in (gu, dn) for k in order]
        li = 1
        g_l = tuple(gu[k][li][:, :I] for k in order)
        u_l = tuple(gu[k][li][:, I:] for k in order)
        d_l = tuple(dn[k][li] for k in order)
        group = D // gu["scales"].shape[1]
        worst = 0.0
        # the other rows only in fast mode: the exact mode keeps its kernel
        n_cases = 0
        for ci, (M, dtype, fast) in enumerate(
                (M, dtype, fast) for M in FUSED_ROWS for dtype in (bf, f32)
                for fast in (True, False) if fast or M in (1, 7, 64)):
            n_cases += 1
            gen = torch.Generator(device=device).manual_seed(140 + 10 * fi + ci)
            x = torch.randn(M, D, generator=gen, device=device).to(dtype)
            got = entry(x, *args, li, fast=fast)
            want = fm.fused_mlp_plain(x, g_l, u_l, d_l, packed=packed, fast=fast)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            top = want.float().abs().max().item()
            atol, rtol = (QMM_ATOL_F32 * top, 0.0) if dtype == f32 else \
                (QMM_TOL_BF16[0] * top, QMM_TOL_BF16[1])
            tol = atol + rtol * want.float().abs()
            if fast:
                tol = tol + FUSED_FLIPS * fm.gated_rounding_bound(x, g_l, u_l, d_l,
                                                                   packed=packed)
            used = (diff / tol).max().item()
            worst = max(worst, used)
            tname = str(dtype).removeprefix("torch.")
            what = (f"{entry.__name__} {fmt} K={D} I={I} M={M} x {tname} "
                    f"{'fast' if fast else 'exact'} group {group}")
            log(f"{what}: max_abs_err={diff.max().item():.3e} (max|plain| {top:.3f}), "
                f"{used:.3f} of the tolerance")
            require(got.shape == (M, D) and got.dtype == dtype, f"{what}: shape or type")
            require(bool(torch.isfinite(got).all()), f"{what}: kernel output not finite")
            require(used <= 1.0, f"{what}: kernel disagrees with its plain version "
                    f"({used:.3f} of the tolerance)")
            require(torch.equal(got, entry(x, *args, li, fast=fast)),
                    f"{what}: two runs differ")
            if M == 7 and fmt in ("q8_0", "q4_0", "q4_1"):
                # gate and up as two arrays: the same values, the same bits
                split = fm.fused_mlp_split_stacked(
                    x, tuple(gu[k][..., :I].contiguous() for k in order),
                    tuple(gu[k][..., I:].contiguous() for k in order),
                    tuple(dn[k] for k in order), li, packed=packed, fast=fast)
                require(torch.equal(split, got), f"{what}: the split schema differs")
            if not (M in FUSED_TIMED_ROWS and dtype == bf and fast
                    and fmt in ("q8_0", "q4_0")):
                continue
            # the decode step's M = 1, a pool step's 2 to 8, the beam step's 5,
            # a verify forward's 8 and 9, and 16 and 64 (the speculative pool's
            # verify): the kernel, its bound (every leaf once, x in, y out),
            # the plain version, three matmuls on the dequantized bf16 weights
            # around SiLU * up (never called by the port), the two-launch path
            # the kernel replaces, and which of the two the default takes
            nbytes = sum(t.numel() * t.element_size() for t in g_l + u_l + d_l) \
                + (x.numel() + got.numel()) * x.element_size()
            b_ms, b_by = bound(2.0 * M * 3 * D * I, nbytes, PEAK_BF16)
            wg, wu, wd = (fm._dequant(w, packed).to(bf) for w in (g_l, u_l, d_l))

            def unfused():
                y = qm.quant_linear_stacked(x, gu, li, fast=True)
                return qm.quant_linear_stacked(F.silu(y[..., :I]) * y[..., I:], dn, li,
                                               fast=True)

            run = lambda: entry(x, *args, li, fast=True)   # noqa: E731
            t = {"ms": graph_ms(run), "events_ms": time_ms(run, iters=50),
                 "plain_ms": time_ms(lambda: fm.fused_mlp_plain(
                     x, g_l, u_l, d_l, packed=packed, fast=True), iters=3, warmup=1),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": time_ms(lambda: (F.silu(x @ wg) * (x @ wu)) @ wd, iters=20),
                 "two_launch_ms": graph_ms(unfused)}
            t["bound_share"] = b_ms / t["ms"]
            t["default"] = "one-launch" if _fused_form(x, (gu, dn)) is not None \
                else "two-launch"
            del wg, wu, wd
            log(f"{what}: " + json.dumps(t) + f" ({nbytes / 1e6:.1f} MB)")
            if M != 1:
                by_m[f"{fmt} M{M}"] = {k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                                            "library_ms", "two_launch_ms",
                                                            "default")}
            elif fmt == "q8_0":
                line = {"name": "fused_mlp", "route": "cuda",
                        "source": "qwen2_audio_tpu_torch/csrc/fused_mlp.cu",
                        "replaces": "qwen2_audio_tpu/ops/fused_mlp.py:105",
                        "shape": what, "max_abs_err": diff.max().item(), **t}
        if fmt == "q8_0":
            try:
                entry(torch.zeros(65, D, device=device, dtype=bf), *args, li)
            except ValueError:
                pass
            else:
                raise SmokeFailure("fused MLP: 65 rows were not refused")
        log(f"fused MLP {fmt}: {n_cases} cases, worst {worst:.3f} of the tolerance")
        del gu, dn, args, g_l, u_l, d_l
        torch.cuda.empty_cache()
    require(bool(line), "fused MLP: the kernels-line entry is missing")
    return {**line, **by_m}


# --------------------------------------------------------------------------- #
# phase 3: full width, depth 2, card vs CPU in float32
# --------------------------------------------------------------------------- #

def check_parity(device, hp) -> float:
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.audio.mel import log_mel_spectrogram, mel_input_window
    from qwen2_audio_tpu_torch.models.encoder import (encoder_forward, fuse_encoder_qkv,
                                                      random_encoder_params)
    from qwen2_audio_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused

    params = fuse_encoder_qkv(random_encoder_params(np.random.default_rng(1), hp))
    filters = mel_filterbank(hp.n_mels)
    x = noisy_tone(30.0, seed=2)
    opts = dict(gelu_approximate=True, use_flash=True, compute_dtype=torch.float32)

    win_cpu = mel_input_window(log_mel_spectrogram(x, filters, device="cpu"),
                               0, hp.n_audio_ctx)
    want = encoder_forward(params, win_cpu[None], hp, **opts)[0]

    dev_params = _tree_to(params, device)
    win_dev = mel_input_window(log_mel_spectrogram_fused(x, filters, device=device),
                               0, hp.n_audio_ctx)
    got = encoder_forward(dev_params, win_dev[None], hp, **opts)[0].cpu()
    mel_err = (win_dev.cpu() - win_cpu).abs().max().item()
    err = (got - want).abs().max().item()
    log(f"parity depth {hp.n_audio_layer} width {hp.n_audio_state}: mel window "
        f"err={mel_err:.3e}, embedding max_abs_err={err:.3e} (tol {PARITY_ATOL}), "
        f"shape {tuple(got.shape)}")
    require(got.shape == want.shape, "parity: shapes differ")
    require(err <= PARITY_ATOL, f"parity: card and CPU disagree by {err}")
    return err


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def check_decoder_parity(device, cfg, T0: int = DEC_PARITY_PREFILL,
                         steps: int = DEC_PARITY_STEPS) -> float:
    """The decoder at full width in float32, weights made on the card from
    a torch.Generator and copied to the CPU: a T0-position prefill and
    ``steps`` greedy steps on both; the same tokens, logits within
    PARITY_ATOL."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder, random_decoder_params
    from qwen2_audio_tpu_torch.runtime.generate import generate_on_device

    dec = Decoder(random_decoder_params(torch.Generator(device=device).manual_seed(1),
                                        cfg, dtype=torch.float32), cfg)
    cpu_params = _tree_to(dec.params, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, T0, cfg.hidden_size)).astype(np.float32))
    out = {}
    for where, params, dev in (("card", dec.params, device), ("cpu", cpu_params, "cpu")):
        t0 = time.perf_counter()
        res = generate_on_device(params, cfg, x.to(dev), max_new_tokens=steps,
                                 eos_token_id=cfg.vocab_size - 1,
                                 cache_max_ctx=T0 + steps, cache_dtype=torch.float32)
        out[where] = [r.cpu() if isinstance(r, torch.Tensor) else r for r in res]
        log(f"decoder parity: {where} prefill {T0} + {res[2]} steps in "
            f"{time.perf_counter() - t0:.1f} s")
    (ct, _, cn, cf, c0), (ht, _, hn, hf, h0) = out["card"], out["cpu"]
    err = max((cf - hf).abs().max().item(), (c0 - h0).abs().max().item())
    log(f"decoder parity depth {cfg.num_hidden_layers} width {cfg.hidden_size} f32: "
        f"tokens card {ct[0, :cn].tolist()} cpu {ht[0, :hn].tolist()}; first and "
        f"final logits max_abs_err={err:.3e} (tol {PARITY_ATOL})")
    require(cn == hn == steps and torch.equal(ct, ht), "decoder parity: tokens differ")
    require(err <= PARITY_ATOL, f"decoder parity: card and CPU logits differ by {err}")
    check_decode_options_parity(device, cfg, dec.params, cpu_params, x, steps,
                                ct[0, :cn].tolist())
    del dec, cpu_params
    torch.cuda.empty_cache()
    return err


def check_decode_options_parity(device, cfg, params, cpu_params, x, steps: int,
                                greedy: list) -> None:
    """Phase 3's beam, speculative and attention-tap parity on the decoder of
    ``check_decoder_parity`` (float32, full width, depth 2), card against
    CPU: a beam-5 search (captured on the card, eager on the CPU) of
    ``steps`` tokens, the same tokens and log-probabilities within
    PARITY_ATOL; speculative decoding at K = 7 and K = 8 (verify forwards of
    8 and 9 rows), the same tokens on both, each the greedy tokens; the DTW
    tap of a 160-position block, within TAP_ATOL."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.runtime.generate import (beam_search_on_device,
                                                        generate_speculative)
    T0, eos = x.shape[1], cfg.vocab_size - 1
    sides = (("card", params, device), ("cpu", cpu_params, "cpu"))
    beams = {}
    for where, p, dev in sides:
        t0 = time.perf_counter()
        tok, lp, n, _ = beam_search_on_device(p, cfg, x.to(dev), beam_size=BEAM,
                                              max_new_tokens=steps, eos_token_id=eos,
                                              cache_max_ctx=T0 + steps,
                                              cache_dtype=torch.float32)
        beams[where] = (tok.tolist(), lp)
        log(f"decode options parity: {where} beam {BEAM} of {n} tokens in "
            f"{time.perf_counter() - t0:.1f} s")
    (bt, bl), (ht, hl) = beams["card"], beams["cpu"]
    berr = (bl - hl).abs().max().item() if bt == ht else float("inf")
    log(f"decode options parity: beam tokens card {bt} cpu {ht}; log-probabilities "
        f"max_abs_err={berr:.3e} (tol {PARITY_ATOL})")
    require(bt == ht and berr <= PARITY_ATOL, "decode options parity: beam differs")
    for k in (7, 8):
        spec = {}
        for where, p, dev in sides:
            tok, _, n, _, _, iters = generate_speculative(
                p, cfg, x.to(dev), max_new_tokens=steps, eos_token_id=eos,
                cache_max_ctx=T0 + steps + k, cache_dtype=torch.float32, spec_k=k)
            spec[where] = (tok[0, :n].tolist(), iters)
        log(f"decode options parity: speculative K = {k} (verify M = {k + 1}) card "
            f"{spec['card']}, cpu {spec['cpu']} (tokens, iterations), greedy {greedy}")
        require(spec["card"][0] == spec["cpu"][0] == greedy,
                f"decode options parity: speculative K = {k} tokens differ")
    taps = {}
    cut = (T0 - 60, 60, 10, 80)
    for where, p, dev in sides:
        cache = create_cache(cfg, 1, T0, dtype=torch.float32, device=dev)
        taps[where] = decoder_forward(p, cfg, x.to(dev), cache, 0, block_only=True,
                                      logits_last_only=True, use_flash=False,
                                      attn_slice=cut)[2].cpu()
    terr = (taps["card"] - taps["cpu"]).abs().max().item()
    log(f"decode options parity: attention tap {cut} shape {tuple(taps['card'].shape)} "
        f"max_abs_err={terr:.3e} (tol {TAP_ATOL}, max|cpu| "
        f"{taps['cpu'].abs().max().item():.3f})")
    require(terr <= TAP_ATOL, f"decode options parity: the taps differ by {terr}")



def _quant_launches(fn):
    """fn()'s result and the launches of every quantized-weight entry it
    made, the counters set to 0 just before and read just after."""
    entries = _quant_entries()
    for e in entries:
        e.launches = 0
    out = fn()
    return out, {e.__name__: e.launches for e in entries}


def check_quant_encoder_parity(device, hp) -> dict:
    """The encoder with q8_0 layer weights from the ggml quantizer, float32,
    in the exact mode and in mode "int8": the card's kernels against the
    CPU's plain versions; in mode "int8" the card launches the flat integer
    entry for each of the four linears of a layer and no other."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.models.encoder import (encoder_forward, fuse_encoder_qkv,
                                                      random_encoder_params)
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import quantize_encoder_params

    params = fuse_encoder_qkv(quantize_encoder_params(
        random_encoder_params(np.random.default_rng(5), hp), GGMLType.Q8_0))
    card = _tree_to(params, device)
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32))
    opts = dict(gelu_approximate=True, use_flash=True, compute_dtype=torch.float32)
    errs, card_out = {}, {}
    try:
        for mode in ("dequant", "int8"):
            set_group_matmul_mode(mode)
            want = encoder_forward(params, mel, hp, **opts)[0]
            got, launches = _quant_launches(
                lambda: encoder_forward(card, mel.to(device), hp, **opts)[0].cpu())
            card_out[mode] = got
            err, top = (got - want).abs().max().item(), want.abs().max().item()
            tol = PARITY_ATOL if mode == "dequant" else INT8_PARITY_REL * top
            gap = "" if mode == "dequant" else (
                f"; the exact mode on the card "
                f"{(card_out['dequant'] - want).abs().max().item() / top:.4f} of max|cpu| off")
            log(f"quantized encoder parity (q8_0, mode {mode}) depth {hp.n_audio_layer} width "
                f"{hp.n_audio_state}: embedding max_abs_err={err:.3e} (tol {tol:.3e}, max|cpu| "
                f"{top:.3f}), cos={_cosine(got, want):.8f}{gap}; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
            require(err <= tol, f"quantized encoder parity ({mode}): card and CPU differ by "
                    f"{err}")
            flat = "quant_matmul_int8" if mode == "int8" else "quant_matmul"
            _check_quant_launches(f"quantized encoder parity ({mode})", launches,
                                  {flat: 4 * hp.n_audio_layer}, "one forward")
            errs[mode] = err
    finally:
        set_group_matmul_mode(None)
    return errs


def check_quant_decoder_parity(device, cfg, T0: int = QDEC_PARITY_PREFILL,
                               steps: int = QDEC_PARITY_STEPS) -> dict:
    """The decoder at full width, float32, with q8_0 weights (layers from the
    ggml quantizer, the lm_head random q8_0 blocks made on the card: the
    quantizer took about 36 s of host time over the 156032 x 3584 head) and
    with packed symmetric q4_0 layer weights from the quantizer (the lm_head
    dense). Exact mode: a T0-position prefill
    and ``steps`` greedy steps on the CPU (plain versions, the per-projection
    MLP) and on the card (kernels), there twice: with the one-launch SwiGLU
    off, and in the decode-tuned storage (q8_0: the SwiGLU on; q4_0:
    panelized). Without mins the exact mode's results differ between those
    storages by the order of float32 sums only, so one CPU run holds both:
    the same tokens, logits within PARITY_ATOL. Then mode "int8": the CPU's
    greedy tokens over INT8_PARITY_STEPS teacher-forced on the card, which
    launches the integer entries for every quantized linear and nothing
    else; logits within INT8_PARITY_REL of the largest (the exact mode's
    distance from the same CPU logits is logged beside it). Last, a decoder of random
    q4_0 blocks as int32 words ("qs4b") in the default mode, the same way:
    the word entry for every linear and the lm_head."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (fuse_decoder_params,
                                                            panelize_decoder_params,
                                                            random_decoder_params,
                                                            random_quant_decoder_params)
    from qwen2_audio_tpu_torch.ops.fused_mlp import ENTRIES as FUSED_ENTRIES
    from qwen2_audio_tpu_torch.ops.fused_mlp import ONE_LAUNCH_MAX_M
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp, set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import payload_form, quantize_decoder_params
    from qwen2_audio_tpu_torch.runtime.generate import generate_on_device

    dense = _tree_to(random_decoder_params(
        torch.Generator(device=device).manual_seed(2), cfg, dtype=torch.float32), "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, T0, cfg.hidden_size)).astype(np.float32))
    L, n = cfg.num_hidden_layers, INT8_PARITY_STEPS

    def run(params, dev):
        res = generate_on_device(params, cfg, x.to(dev), max_new_tokens=steps,
                                 eos_token_id=cfg.vocab_size - 1,
                                 cache_max_ctx=T0 + steps, cache_dtype=torch.float32)
        return [r.cpu() if isinstance(r, torch.Tensor) else r for r in res]

    def forced(what, cpu_params, card, want_launches, mode):
        """The CPU's greedy tokens teacher-forced on the card in ``mode``."""
        set_group_matmul_mode(mode)
        t0 = time.perf_counter()
        toks, want = _decode_steps(cpu_params, cfg, x, n, "cpu")
        t1 = time.perf_counter()
        (_, got), launches = _quant_launches(
            lambda: _decode_steps(card, cfg, x, len(toks), device, toks))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        top = max(w.abs().max().item() for w in want)
        _, n_ties = first_real_disagreement(want, got)
        t2 = time.perf_counter()
        gap = ""
        if mode == "int8":
            set_group_matmul_mode("dequant")
            _, exact = _decode_steps(card, cfg, x, len(toks), device, toks)
            gap = (f"; the exact mode on the card "
                   f"{max((a - b).abs().max().item() for a, b in zip(exact, want)) / top:.4f}"
                   f" of it off")
        log(f"quantized decoder parity {what} depth {L} width {cfg.hidden_size} f32: cpu "
            f"{t1 - t0:.1f} s, card {t2 - t1:.1f} s; cpu tokens {toks}, {n_ties} near-tie "
            f"steps where the card picks another; logits max_abs_err={err:.3e} = "
            f"{err / top:.4f} of the largest (tol {INT8_PARITY_REL}){gap}; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        require(err <= INT8_PARITY_REL * top, f"quantized decoder parity {what}: card and "
                f"CPU logits differ by {err}")
        _check_quant_launches(f"quantized decoder parity {what}", launches, want_launches,
                              f"{n} forwards")
        return err

    errs = {}
    set_group_matmul_mode("dequant")
    try:
        for fmt, ttype, head in (("q8_0", GGMLType.Q8_0, True), ("q4_0", GGMLType.Q4_0, False)):
            t0 = time.perf_counter()
            cpu_params = fuse_decoder_params(quantize_decoder_params(
                dense, ttype, quantize_lm_head=False))
            if head:    # random q8_0 blocks made on the card: no host quantizing
                cpu_params["lm_head"] = _tree_to(_rand_blocks(
                    device, cfg.hidden_size, cfg.vocab_size, "q8_0", 8), "cpu")
            log(f"quantized decoder parity {fmt}: {L} layers quantized on the host in "
                f"{time.perf_counter() - t0:.1f} s{', lm_head random q8_0 blocks' if head else ''}"
                f", form {payload_form(cpu_params['layers']['qkv'])}")
            set_fused_mlp(False)
            t0 = time.perf_counter()
            ht, _, hn, hf, h0 = run(cpu_params, "cpu")
            log(f"quantized decoder parity {fmt}: cpu prefill {T0} + {hn} steps in "
                f"{time.perf_counter() - t0:.1f} s")
            card = _tree_to(cpu_params, device)
            tuned = "one-launch SwiGLU" if fmt == "q8_0" else "panelized"
            for which in ("per-projection MLP", tuned):
                set_fused_mlp(which == "one-launch SwiGLU")
                params = panelize_decoder_params(card) if which == "panelized" else card
                before = sum(e.launches for e in FUSED_ENTRIES)
                t0 = time.perf_counter()
                ct, _, cn, cf, c0 = run(params, device)
                n_fused = sum(e.launches for e in FUSED_ENTRIES) - before
                err = max((cf - hf).abs().max().item(), (c0 - h0).abs().max().item())
                log(f"quantized decoder parity {fmt} ({which}, layers "
                    f"{payload_form(params['layers']['qkv'])}, gate_up "
                    f"{payload_form(params['layers']['gate_up'])}) depth "
                    f"{L} width {cfg.hidden_size} f32 exact mode: card "
                    f"prefill {T0} + {cn} steps in {time.perf_counter() - t0:.1f} s, "
                    f"{n_fused} fused launches; tokens card {ct[0, :cn].tolist()} cpu "
                    f"{ht[0, :hn].tolist()}; first and final logits max_abs_err={err:.3e} "
                    f"(tol {PARITY_ATOL})")
                require(cn == hn == steps and torch.equal(ct, ht),
                        f"quantized decoder parity {fmt} ({which}): tokens differ")
                require(err <= PARITY_ATOL, f"quantized decoder parity {fmt} ({which}): "
                        f"card and CPU logits differ by {err}")
                # one per layer and decode forward, and at a prefill of at most
                # ONE_LAUNCH_MAX_M rows
                want_fused = L * (steps - 1 + (T0 <= ONE_LAUNCH_MAX_M)) \
                    if which == "one-launch SwiGLU" else 0
                require(n_fused == want_fused, f"quantized decoder parity {fmt} ({which}): "
                        f"{n_fused} fused launches, want {want_fused}")
                errs[f"{fmt} {which}"] = err
            set_fused_mlp(None)
            errs[f"{fmt} int8 mode"] = forced(
                f"{fmt} (mode int8)", cpu_params, card,
                {"quant_matmul_int8_stacked": 4 * L * n, "quant_matmul_int8": n * head}, "int8")
            del cpu_params, card, params
            torch.cuda.empty_cache()
        set_group_matmul_mode(None)
        card = fuse_decoder_params(random_quant_decoder_params(
            torch.Generator(device=device).manual_seed(3), cfg, "q4_0", dtype=torch.float32,
            b32=True))
        errs["q4_0 b32"] = forced(f"q4_0 b32 ({payload_form(card['layers']['qkv'])}, "
                                  "default mode)", _tree_to(card, "cpu"), card,
                                  {"quant_matmul_q4b_stacked": (4 * L + 1) * n}, None)
        del card
        torch.cuda.empty_cache()
    finally:
        set_group_matmul_mode(None)
        set_fused_mlp(None)
    return errs


def _decode_steps(params, cfg, x, steps: int, dev, toks=None) -> tuple[list, list]:
    """A prefill of x (1, T0, D) and ``steps`` - 1 decode forwards through
    decoder_forward in float32 on ``dev``, each next token greedy or, given
    ``toks``, forced; returns (the tokens, each step's (V,) logits on the
    CPU)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (create_cache, decoder_forward,
                                                            embed_tokens)
    T0 = x.shape[1]
    cache = create_cache(cfg, 1, T0 + steps, dtype=torch.float32, device=dev)
    lg, cache = decoder_forward(params, cfg, x.to(dev), cache, 0, block_only=True,
                                logits_last_only=True)
    rows, chosen = [lg[0, -1].cpu()], []
    for j in range(steps):
        chosen.append(int(rows[-1].argmax()) if toks is None else toks[j])
        if j + 1 < steps:
            e = embed_tokens(params, torch.tensor([[chosen[-1]]], device=dev))
            lg, cache = decoder_forward(params, cfg, e, cache, T0 + j)
            rows.append(lg[0, -1].cpu())
    return chosen, rows


# --------------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------------- #

def write_random_checkpoint(workdir: str, hp, what: str) -> str:
    """A random-weight (seed 0) F16 checkpoint of ``hp`` written by the
    port's ggml writer into ``workdir``; its path."""
    import numpy as np
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
    from qwen2_audio_tpu_torch.models.encoder import random_encoder_params

    t0 = time.perf_counter()
    path = os.path.join(workdir, f"qwen2-audio-random-f16-{hp.n_audio_layer}.bin")
    write_encoder_checkpoint(path, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(hp.n_mels), [b"a", b"b", b"ab"])
    log(f"{what}: wrote {os.path.getsize(path) / 1e9:.3f} GB checkpoint "
        f"({hp.n_audio_layer} layers) in {time.perf_counter() - t0:.1f} s")
    return path


def run_main_path(hp, calls: int, workdir: str) -> dict:
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio.mel import mel_input_window
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward
    from qwen2_audio_tpu_torch.ops.flash_attention import attention_single
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames
    from qwen2_audio_tpu_torch.runtime.context import ContextParams

    path = write_random_checkpoint(workdir, hp, "main")

    t0 = time.perf_counter()
    ctx = capi.whisper_init_from_file_with_params(
        path, ContextParams(compute_dtype=torch.bfloat16))
    log(f"main: loaded on {ctx.device} in {time.perf_counter() - t0:.1f} s")
    x = noisy_tone(30.0, seed=3)
    params = capi.whisper_full_default_params()

    torch.cuda.reset_peak_memory_stats()
    mel_frames.launches = 0
    attention_single.launches = 0
    per_call = []
    for _ in range(calls):
        t0 = time.perf_counter()
        rc = capi.whisper_full(ctx, params, x)
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
        require(rc == 0, f"whisper_full returned {rc}")
    launches = {"mel_log_frames": mel_frames.launches,
                "attention_single": attention_single.launches}
    log(f"main: per-call ms {json.dumps([round(v, 3) for v in per_call])}; "
        f"launches {json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tm = ctx.state.timings
    log(f"main: mel {tm.t_mel_us / 1e3 / calls:.3f} ms/call, encode "
        f"{tm.t_encode_us / 1e3 / tm.n_encode:.3f} ms/call (host clock, synchronised)")
    require(launches["mel_log_frames"] == calls,
            f"mel kernel launched {launches['mel_log_frames']} times in {calls} calls")
    require(launches["attention_single"] == calls * hp.n_audio_layer,
            f"attention kernel launched {launches['attention_single']} times "
            f"in {calls} calls of {hp.n_audio_layer} layers")

    emb = ctx.state.embd_enc
    log(f"main: output shape {tuple(emb.shape)} dtype {emb.dtype}")
    require(tuple(emb.shape) == (hp.n_audio_ctx // 2, hp.n_audio_state), "main: bad shape")
    require(bool(torch.isfinite(emb).all()), "main: output not finite")
    capi.whisper_print_emb_enc(ctx)

    # the same weights and window through the plain einsum attention
    enc = ctx.encoder
    win = mel_input_window(ctx.state.mel, 0, hp.n_audio_ctx)[None]
    plain = encoder_forward(enc.params, win, hp, gelu_approximate=enc.gelu_approximate,
                            use_flash=False, compute_dtype=enc.compute_dtype)[0]
    a, b = emb.float().flatten(), plain.float().flatten()
    cos = (a @ b / (a.norm() * b.norm())).item()
    log(f"main: kernel path vs plain-attention path on the card: cos={cos:.6f} "
        f"(min {MAIN_COS_MIN}), max_abs_diff={(a - b).abs().max().item():.3e}")
    require(cos >= MAIN_COS_MIN, "main: kernel path disagrees with the plain path")
    encode = captured_against_eager_encode(enc, win, emb, calls)
    profile_call(lambda: capi.whisper_full(ctx, params, x), "whisper_full (encode)")
    steady = per_call[1:] or per_call
    return ctx, {"launches": launches, "per_call_ms": per_call, "path": path,
                 "steady_ms": statistics.median(steady), "encode": encode}


def _host_ms(fn, calls: int = 6) -> list[float]:
    """Host ms of ``calls`` calls, each ended by a device synchronisation."""
    import torch
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def captured_against_eager_encode(enc, win, emb, calls: int) -> dict:
    """Phase 4a's encoder graph: ``calls`` whisper_full calls replayed one
    graph; the eager encoder_forward on the same window gives the replay's
    bits and fingerprint; host ms per 30 s clip of the encoder alone,
    replayed and eager (medians of 5 after one)."""
    import torch
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward, fingerprint

    graphs = enc.graphs.values()
    require(len(graphs) == 1 and graphs[0].replays == calls,
            f"main: {len(graphs)} encoder graphs, replays "
            f"{[g.replays for g in graphs]}, want one replayed {calls} times")

    def eager():
        return encoder_forward(enc.params, win, enc.hp, gelu_approximate=enc.gelu_approximate,
                               use_flash=True, compute_dtype=enc.compute_dtype)[0]

    ref = eager()
    same = torch.equal(ref, emb)
    fp_graph, fp_eager = fingerprint(emb), fingerprint(ref)
    graph_ms = statistics.median(_host_ms(lambda: enc(win))[1:])
    eager_ms = statistics.median(_host_ms(eager)[1:])
    log(f"main: captured encode (graph captured in {graphs[0].capture_ms:.1f} ms) against "
        f"the eager encoder_forward: output bit-equal {same}; fingerprint replayed "
        f"{fp_graph!r}, eager {fp_eager!r}; encoder ms per 30 s clip (host clock, "
        f"synchronised) replayed {graph_ms:.3f}, eager {eager_ms:.3f}")
    require(same and fp_graph == fp_eager, "main: the captured encode differs from the eager one")
    return {"capture_ms": graphs[0].capture_ms, "graph_ms": graph_ms, "eager_ms": eager_ms}


ATTN_VARIANTS = (   # phase 4f: (name, set_attention_variants arguments, entry)
    ("lite", {"lite": True}, "attention_lite"),
    ("nopad", {"nopad": True}, "flash_attention_nopad"),
    ("exp2", {"exp2": True}, "attention_single"),
    ("pexp16", {"pexp16": True}, "attention_single"),
    ("blockwise", {"single": False}, "attention_blockwise"),
)


def run_attention_variants(ctx, calls: int) -> dict:
    """Phase 4f, behind the bf16 encoder of phase 4a: whisper_full on one
    clip under each encoder attention variant of ops/fa_variants.py (the
    JAX package's QA_FA_* gates), every launch counter set to 0 just before
    and read just after: the variant's entry launched once per layer and
    call and no other attention entry; the median ms per call; the device
    time of one profiled call; the embedding's cosine to the default path's
    on the same clip. Returns the results by variant name."""
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.ops import fa_variants as fv

    entries = _attention_entries()
    n_layer = ctx.hparams.n_audio_layer
    clip = noisy_tone(30.0, seed=3)
    params = capi.whisper_full_default_params()
    out, graphs = {}, {}
    try:
        for name, switch, entry in (("default", {}, "attention_single"),) + ATTN_VARIANTS:
            fv.set_attention_variants(**switch)
            for e in entries.values():
                e.launches = 0
            per_call = []
            for _ in range(calls):
                t0 = time.perf_counter()
                rc = capi.whisper_full(ctx, params, clip)
                torch.cuda.synchronize()
                per_call.append((time.perf_counter() - t0) * 1e3)
                require(rc == 0, f"variant {name}: whisper_full returned {rc}")
            launches = {k: e.launches for k, e in entries.items()}
            want = {k: (calls * n_layer if k == entry else 0) for k in entries}
            emb = ctx.state.embd_enc.clone()
            require(bool(torch.isfinite(emb).all()), f"variant {name}: output not finite")
            if name == "default":
                ref = emb
            cos = _cosine(emb, ref)
            ms = statistics.median(per_call[1:] or per_call)
            log(f"variant {name}: {json.dumps(switch)}; per-call ms "
                f"{json.dumps([round(v, 3) for v in per_call])}, median {ms:.3f}; "
                f"launches {json.dumps(launches)}; embedding against the default "
                f"path's: cos={cos:.6f} (min {MAIN_COS_MIN}), max_abs_diff="
                f"{(emb.float() - ref.float()).abs().max().item():.3e}")
            require(launches == want, f"variant {name}: launches {launches}, want {want}")
            require(cos >= MAIN_COS_MIN, f"variant {name}: the embedding disagrees with "
                    "the default path's")
            # each setting replays an encoder graph of its own
            graphs[name] = ctx.encoder.graphs.values()[-1]
            require(name == "default" or graphs[name].replays == calls,
                    f"variant {name}: its graph replayed {graphs[name].replays} times, "
                    f"want {calls}")
            prof = profile_call(lambda: capi.whisper_full(ctx, params, clip),
                                f"whisper_full (encode, attention {name})")
            out[name] = {"launches": launches, "ms": ms, "cos": cos,
                         "busy_ms": (prof or {}).get("busy_ms")}
    finally:
        fv.set_attention_variants()
    require(len({id(g) for g in graphs.values()}) == len(graphs),
            "phase 4f: two attention settings replayed one encoder graph")
    log("variants: one encoder graph per setting, captured in ms " + json.dumps(
        {k: round(g.capture_ms, 1) for k, g in graphs.items()}))
    return out


def _quant_entries() -> tuple:
    """Every entry of the quantized-weight kernels: dequantizing (strided
    and panel), one-launch SwiGLU, exact-integer group matmul."""
    from qwen2_audio_tpu_torch.ops import fused_mlp, quant_matmul, quant_matmul_int8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b
    return (quant_matmul.ENTRIES + fused_mlp.ENTRIES + quant_matmul_int8.ENTRIES
            + quant_matmul_q4b.ENTRIES)


def _launch_counters():
    """The package's list of counting wrappers (the one ops/graphs.py adds
    a captured call's launches to at each replay)."""
    from qwen2_audio_tpu_torch.ops import launch_counters
    return launch_counters()


def _cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def teacher_forced_logits(bundle, st, params=None, flash: bool = True,
                          fused: bool | None = None, mode: str | None = None,
                          embd=None) -> list:
    """The request's prefill and tokens through the decoder on the card, one
    (V,) logits row per step: over ``params`` (default: the bundle's), the
    kernel or the plain attention, the one-launch SwiGLU as it is set or as
    ``fused`` says, in the group-matmul mode that is set or ``mode``, the
    prefill from ``embd`` (default: the request's audio embedding)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.linear import (fused_mlp_enabled, group_matmul_mode,
                                                  set_fused_mlp, set_group_matmul_mode)
    from qwen2_audio_tpu_torch.runtime.decoding import _prefill_embeds

    params = bundle.params if params is None else params
    prefill = _prefill_embeds(bundle, bundle.project_audio(
        st.embd_enc if embd is None else embd), [])
    T0, toks = prefill.shape[1], st.result_tokens
    was, was_mode = fused_mlp_enabled(), group_matmul_mode()
    if fused is not None:
        set_fused_mlp(fused)
    if mode is not None:
        set_group_matmul_mode(mode)
    try:
        cache = create_cache(bundle.cfg, 1, T0 + len(toks), dtype=torch.bfloat16,
                             device=prefill.device)
        lg, cache = decoder_forward(params, bundle.cfg, prefill, cache, 0,
                                    block_only=True, logits_last_only=True,
                                    use_flash=flash)
        steps = [lg[0, -1]]
        for j, tok in enumerate(toks[:-1]):
            x = bundle.decoder.embed(torch.tensor([[tok]], device=prefill.device))
            lg, cache = decoder_forward(params, bundle.cfg, x, cache, T0 + j,
                                        use_flash=flash)
            steps.append(lg[0, -1])
    finally:
        set_fused_mlp(was)
        set_group_matmul_mode(was_mode)
    return steps


def teacher_forced_cosines(bundle, st, other=None) -> list[float]:
    """The request's prefill and tokens through the kernel path and through
    another path on the card; cosine of the logits per step. The other path
    is the plain attention over the same weights or, with ``other`` (a
    parameter tree), the kernel attention over those weights."""
    mine = teacher_forced_logits(bundle, st)
    theirs = (teacher_forced_logits(bundle, st, flash=False) if other is None
              else teacher_forced_logits(bundle, st, params=other))
    again = [int(s.argmax()) for s in mine]
    log(f"teacher-forced kernel path reproduces the request's tokens: "
        f"{again == st.result_tokens}")
    return [_cosine(a, b) for a, b in zip(mine, theirs)]


def captured_against_eager(bundle, st, params, what: str) -> dict:
    """The request of ``st`` (its audio embedding, the suppression masks and
    the budget of ``params``) decoded again from the same prefill, replayed
    from the captured step and as the eager step loop: the same tokens,
    bit-equal log-probabilities and final logits. Returns each one's decode
    ms per token (host clock, synchronised)."""
    import numpy as np
    from qwen2_audio_tpu_torch.runtime.decoding import (_prefill_embeds, build_blank_mask,
                                                        build_suppress_mask)
    from qwen2_audio_tpu_torch.runtime.generate import greedy_decode_device
    from qwen2_audio_tpu_torch.utils.timings import Timings

    prefill = _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])
    kw = dict(max_new_tokens=params.max_new_tokens,
              repetition_penalty=params.repetition_penalty,
              suppress_mask=build_suppress_mask(bundle, params),
              suppress_first=build_blank_mask(bundle, params))
    res, ms = {}, {}
    for name, capture in (("replayed", True), ("eager", False)):
        tm = Timings()
        res[name] = greedy_decode_device(bundle, prefill, capture=capture, timings=tm, **kw)
        ms[name] = tm.t_decode_us / 1e3 / max(tm.n_decode, 1)
    g, e = res["replayed"], res["eager"]
    same = (g.tokens == e.tokens and g.logprobs == e.logprobs
            and np.array_equal(g.final_logits, e.final_logits))
    T0 = prefill.shape[1]
    device_ms = step_device_ms(bundle, T0, min(bundle.max_ctx, T0 + params.max_new_tokens))
    log(f"{what}: replayed against the eager step loop from the same prefill: "
        f"{len(g.tokens[0])} tokens, tokens, log-probabilities and final logits "
        f"bit-equal {same} ({g.n_decode_forwards} and {e.n_decode_forwards} forwards); decode "
        f"ms per token replayed {ms['replayed']:.3f}, eager {ms['eager']:.3f}; one decoder "
        f"forward at position {T0} {device_ms:.3f} ms of device time")
    require(same, f"{what}: the captured decode differs from the eager step loop")
    return {"replayed_ms_per_token": ms["replayed"], "eager_ms_per_token": ms["eager"],
            "device_ms_per_step": device_ms}


def step_device_ms(bundle, pos: int, capacity: int, replays: int = 10) -> float:
    """Device ms of one decoder forward of the bundle's decoder at ``pos``
    over a fresh cache of ``capacity`` rows in the bundle's cache type: a
    CUDA graph of the forward replayed ``replays`` times back to back
    between two events, after one replay."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.graphs import Graph

    dev = bundle.decoder.device
    x = bundle.decoder.embed(torch.tensor([[7]], device=dev))
    at = torch.full((1,), pos, dtype=torch.int32, device=dev)
    cache = create_cache(bundle.cfg, 1, capacity, dtype=bundle.cache_dtype, device=dev)
    graph = Graph(lambda: decoder_forward(bundle.params, bundle.cfg, x, cache, at), dev)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay(replays)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def check_every_sweep(bundle, st, params, values=(1, 4, 8, 16), rounds: int = 4) -> dict:
    """Decode ms per token of the request of ``st`` replayed with the done
    flags read every k steps: the values of k taken in turn, forward and
    then backward, so that a drift of the card's speed over the sweep falls
    on every k alike; the median of ``rounds`` runs for each k."""
    from qwen2_audio_tpu_torch.runtime.decoding import (_prefill_embeds, build_blank_mask,
                                                        build_suppress_mask)
    from qwen2_audio_tpu_torch.runtime.generate import greedy_decode_device
    from qwen2_audio_tpu_torch.utils.timings import Timings

    prefill = _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])
    masks = dict(suppress_mask=build_suppress_mask(bundle, params),
                 suppress_first=build_blank_mask(bundle, params))
    per, forwards = {k: [] for k in values}, {}
    for r in range(rounds):
        for k in values if r % 2 == 0 else values[::-1]:
            tm = Timings()
            res = greedy_decode_device(bundle, prefill, max_new_tokens=params.max_new_tokens,
                                       check_every=k, timings=tm, **masks)
            per[k].append(tm.t_decode_us / 1e3 / max(tm.n_decode, 1))
            forwards[k] = res.n_decode_forwards
    return {k: {"ms_per_token": statistics.median(per[k]), "runs": per[k],
                "forwards": forwards[k]} for k in values}


def first_real_disagreement(ref: list, other: list) -> tuple[int | None, int]:
    """Two paths' teacher-forced logits over one request's tokens: the first
    step where they pick different tokens (None: nowhere), after checking
    that every such step is a near-tie: the reference's margin between the
    two picks is within twice the largest logit difference of that step.
    Also returns the count of such steps."""
    first, n = None, 0
    for j, (a, b) in enumerate(zip(ref, other)):
        ta, tb = int(a.argmax()), int(b.argmax())
        if ta == tb:
            continue
        margin = (a[ta] - a[tb]).item()
        spread = (a - b).abs().max().item()
        require(margin <= 2 * spread, f"step {j}: the paths pick tokens {ta} and {tb} "
                f"though the margin {margin:.3e} exceeds twice their logit "
                f"difference {spread:.3e}")
        n += 1
        first = j if first is None else first
    return first, n


def run_audio_to_text(ctx, cfg, requests: int, new_tokens: int) -> dict:
    """Attach a random bf16 Qwen2 decoder made on the card (seed 0) and answer
    ``requests`` requests on different 30 s clips through capi.whisper_full,
    plus one over the int8 KV cache, with the launch counters set to 0
    just before and read just after."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle

    t0 = time.perf_counter()
    bundle = random_bundle(torch.Generator(device=ctx.device).manual_seed(0), cfg,
                           ctx.hparams.n_audio_state, dtype=torch.bfloat16,
                           max_ctx=2048, cache_dtype=torch.bfloat16)
    ctx.decoder = bundle
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in bundle.decoder.buffers())
    log(f"text: {cfg.num_hidden_layers}-layer decoder, {n_bytes / 1e9:.2f} GB of bf16 "
        f"weights made on the card in {time.perf_counter() - t0:.1f} s")
    params = capi.whisper_full_default_params()
    params.max_new_tokens = new_tokens
    params.temperature_inc = 0.0        # random weights: no fallback decodes
    params.print_progress = False
    clips = [noisy_tone(30.0, seed=20 + i, freq=300.0 + 110.0 * i)
             for i in range(requests + 1)]
    caches = [torch.bfloat16] * requests + ["q8"]

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs, states = [], []
    for clip, cache_dtype in zip(clips, caches):
        bundle.cache_dtype = cache_dtype
        st = ctx.init_state()
        t1 = time.perf_counter()
        rc = capi.whisper_full_with_state(ctx, st, params, clip)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        require(rc == 0, f"text: whisper_full returned {rc}")
        tm = st.timings
        n_tok = len(st.result_tokens)
        runs.append({"cache": str(cache_dtype).removeprefix("torch."), "wall_ms": wall,
                     "encode_ms": tm.t_encode_us / 1e3, "prefill_ms": tm.t_prompt_us / 1e3,
                     "prefill_positions": tm.n_prompt, "tokens": n_tok,
                     "forwards": st.n_decode_forwards,
                     "decode_ms_per_token": tm.t_decode_us / 1e3 / max(n_tok, 1)})
        states.append(st)
        require(n_tok > 0 and len(st.segments) == 1, "text: no segment or no tokens")
        require(capi.whisper_full_n_tokens_from_state(st, 0) == n_tok, "text: token count")
        require(bool(np.isfinite(st.logits).all()), "text: logits not finite")
        log(f"text: request {len(runs)} {json.dumps(runs[-1])}; text "
            f"{capi.whisper_full_get_segment_text_from_state(st, 0)[:80]!r}")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    L, n_req = cfg.num_hidden_layers, len(runs)
    fw_bf16 = sum(r["forwards"] for r in runs if r["cache"] != "q8")
    fw_q8 = sum(r["forwards"] for r in runs if r["cache"] == "q8")
    log(f"text: launches {json.dumps(launches)}; decoder forwards {fw_bf16} (bf16 "
        f"cache) + {fw_q8} (int8 cache); peak device memory {peak:.2f} GiB")
    require(launches["attention_causal"] == L * n_req,
            f"prefill kernel launched {launches['attention_causal']} times, "
            f"want {L} x {n_req} requests")
    require(launches["flash_decode"] == L * fw_bf16,
            f"decode kernel launched {launches['flash_decode']} times, want {L} x {fw_bf16}")
    require(launches["flash_decode_quant"] == L * fw_q8,
            f"int8 decode kernel launched {launches['flash_decode_quant']} times, "
            f"want {L} x {fw_q8}")
    n_q8 = sum(r["cache"] == "q8" for r in runs)   # one prefill a request
    require(launches["kv_append_quant"] == L * (fw_q8 + n_q8),
            f"int8 cache writes launched {launches['kv_append_quant']} times, want {L} x "
            f"({fw_q8} decode forwards + {n_q8} prefill)")
    require(launches["mel_log_frames"] == n_req
            and launches["attention_single"] == n_req * ctx.hparams.n_audio_layer,
            "text: encoder kernels not launched once per request and layer")

    cos = teacher_forced_cosines(bundle, states[requests - 1])
    log(f"text: kernel path vs plain-attention path, teacher-forced over "
        f"{len(cos)} steps: min cos {min(cos):.6f} (min {MAIN_COS_MIN}), per step "
        f"{json.dumps([round(c, 6) for c in cos])}")
    require(min(cos) >= MAIN_COS_MIN, "text: kernel path disagrees with the plain path")
    from qwen2_audio_tpu_torch.runtime.generate import CARD_CHECK_EVERY, captured_steps
    log("text: decode steps captured (capture ms, replays, launches a replay): " + json.dumps(
        [[round(g.capture_ms, 1), g.replays, sum(g.launches.values())]
         for g in captured_steps()]) + f"; check_every {CARD_CHECK_EVERY}")
    against = {}
    for st, cache_dtype in zip(states, caches):
        bundle.cache_dtype = cache_dtype
        against[str(cache_dtype).removeprefix("torch.")] = captured_against_eager(
            bundle, st, params, f"text ({cache_dtype} cache)")
    bundle.cache_dtype = torch.bfloat16
    sweep = check_every_sweep(bundle, states[0], params)
    log(f"text: decode ms per token by check_every (bf16 cache, medians): "
        + json.dumps({k: round(v["ms_per_token"], 4) for k, v in sweep.items()})
        + f"; runs {json.dumps({k: [round(x, 4) for x in v['runs']] for k, v in sweep.items()})}"
        + f"; forwards {json.dumps({k: v['forwards'] for k, v in sweep.items()})}")
    prof = profile_call(lambda: capi.whisper_full(ctx, params, clips[0]),
                        "whisper_full (audio -> text)")
    bf = [r for r in runs if r["cache"] != "q8"]
    q8 = [r["decode_ms_per_token"] for r in runs if r["cache"] == "q8"]
    steps = step_launches(bundle)
    log(f"text: decode ms per token, int8 cache {json.dumps(q8)} beside bf16 "
        f"{json.dumps([r['decode_ms_per_token'] for r in bf])} (ratio "
        f"{statistics.median(q8) / statistics.median(r['decode_ms_per_token'] for r in bf):.3f}); "
        f"one decode step by cache: {json.dumps(steps)}")
    return {"launches": launches, "runs": runs, "peak_gib": peak,
            "prefill_ms": statistics.median(r["prefill_ms"] for r in bf),
            "decode_ms_per_token": statistics.median(r["decode_ms_per_token"] for r in bf),
            "against": against, "sweep": sweep, "steps": steps, "profile": prof}


def step_launches(bundle, pos: int = 783, capacity: int = 2048) -> dict:
    """One decode step of the bundle's decoder at ``pos`` over a fresh bf16
    and int8 cache, eager and replayed from a CUDA graph of the same step at
    a device position: the device kernels each launches (counted by the
    profiler), the host ms to enqueue it, and its host ms ending in a device
    synchronisation (each the median of 5 after one; a replay's synchronised
    ms is about the step's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.graphs import Graph
    out = {}
    dev = bundle.decoder.device
    x = bundle.decoder.embed(torch.tensor([[7]], device=dev))
    at = torch.full((1,), pos, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, "q8"):
        cache = create_cache(bundle.cfg, 1, capacity, dtype=dtype, device=x.device)

        def step():
            decoder_forward(bundle.params, bundle.cfg, x, cache, at)

        graph = Graph(step, dev)
        row = {}
        for name, fn in (("eager", step), ("replay", graph.replay)):
            enqueue, total = [], []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                enqueue.append((t1 - t0) * 1e3)
                total.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = sum(ev.count for ev in prof.key_averages()
                          if ev.device_type == torch.autograd.DeviceType.CUDA)
            row[name] = {"kernels": kernels, "enqueue_ms": statistics.median(enqueue[1:]),
                         "host_ms": statistics.median(total[1:])}
        row["capture_ms"] = graph.capture_ms
        out["bf16" if dtype == torch.bfloat16 else "int8"] = row
        del cache, graph
    return out


def graph_device_ms(graph, replays: int = 10) -> float:
    """Device ms of one replay of a captured graph: ``replays`` replays back
    to back between two events, after one."""
    import torch
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay(replays)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def block_forced_logits(bundle, st, width: int) -> list:
    """The request's prefill and tokens through the decoder on the card in
    forwards of ``width`` positions (a speculative verify forward's width),
    teacher-forced: one (V,) logits row per step, aligned with
    ``teacher_forced_logits``."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.runtime.decoding import _prefill_embeds

    prefill = _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])
    T0, toks = prefill.shape[1], st.result_tokens[:-1]
    cache = create_cache(bundle.cfg, 1, T0 + len(toks) + width, dtype=torch.bfloat16,
                         device=prefill.device)
    lg, cache = decoder_forward(bundle.params, bundle.cfg, prefill, cache, 0,
                                block_only=True, logits_last_only=True)
    rows = [lg[0, -1]]
    for i in range(0, len(toks), width):
        chunk = toks[i:i + width]
        x = bundle.decoder.embed(torch.tensor([chunk], device=prefill.device))
        lg, cache = decoder_forward(bundle.params, bundle.cfg, x, cache, T0 + i)
        rows.extend(lg[0, :len(chunk)])
    return rows


def run_decode_options(ctx, what: str, new_tokens: int, clip, int8_cache: bool = False,
                       quantized: bool = False, mode: str = "bf16", greedy=None) -> dict:
    """Phase 4g on the decoder attached to ``ctx``: through capi.whisper_full
    on one clip, every launch counter set to 0 just before each request and
    read just after, a greedy request, a beam-5 request (and with
    ``int8_cache`` one over the int8 KV cache), a request with
    speculative_k = SPEC_K (and with ``int8_cache`` one over the int8
    cache), and one with token_timestamps and max_len = TS_MAX_LEN.

    Each beam request is decoded again from its prefill, captured and as
    the eager host loop: the request's tokens, bit-equal log-probabilities.
    The speculative request's tokens are the greedy request's, or differ
    first at a near tie (SPEC_TIE); it is decoded again captured and eager,
    bit-equal, for its iterations. The timestamps request's segments hold
    the greedy tokens in order, each token's time non-decreasing within the
    window. Logged: ms per token of each request, one captured step's
    device ms (beam and speculative, by replays between events), the beam
    reorder's device ms, iterations and tokens per forward.

    With ``greedy``, the state of a greedy request already made on this
    decoder with ``_text_params(new_tokens)`` (phase 4e in mode "int8"),
    only the beam and speculative requests run. ``mode``: the group-matmul
    mode the quantized launch counts are derived in."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.ops.graphs import Graph
    from qwen2_audio_tpu_torch.runtime import generate as gen
    from qwen2_audio_tpu_torch.runtime.decoding import (_prefill_embeds, beam_search,
                                                        build_blank_mask,
                                                        build_suppress_mask,
                                                        compute_token_timestamps)
    from qwen2_audio_tpu_torch.utils.timings import Timings

    bundle = ctx.decoder
    L = bundle.cfg.num_hidden_layers
    out = {}

    def request(name: str, check_quant: bool = True, **opts) -> tuple:
        params = _text_params(new_tokens)
        for k, v in opts.items():
            setattr(params, k, v)
        st, run, launches = _request(ctx, clip, params)
        require(len(st.result_tokens) > 0 and len(st.segments) >= 1,
                f"{what} {name}: no tokens")
        run["launches"] = {k: n for k, n in launches.items() if n}
        out[name] = run
        log(f"4g {what} {name}: request {json.dumps(run)}")
        require(launches["attention_causal"] == L,
                f"{what} {name}: {launches['attention_causal']} prefill kernel launches, "
                f"want {L}")
        if quantized and check_quant:
            _check_quant_launches(f"{what} {name}", launches, expected_quant_launches(
                ctx, bundle, True, 1, st.n_decode_forwards, run["prefill_positions"],
                mode=mode), f"1 prefill and {st.n_decode_forwards} decode forwards")
        return st, params, launches

    def prefill_of(st):
        return _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])

    trimmed = greedy is not None
    if trimmed:
        gparams = _text_params(new_tokens)
    else:
        greedy, gparams, _ = request("greedy")
    masks = dict(suppress_mask=build_suppress_mask(bundle, gparams),
                 suppress_first=build_blank_mask(bundle, gparams))
    caches = [("bf16", bundle.cache_dtype)] + ([("int8", "q8")] if int8_cache else [])
    for cname, cache_dtype in caches:
        bundle.cache_dtype = cache_dtype
        name = "beam" if cname == "bf16" else f"beam {cname} cache"
        st, params, launches = request(name, strategy="beam", beam_size=BEAM)
        n_fw = st.n_decode_forwards
        kernel = "flash_decode_quant" if cache_dtype == "q8" else "flash_decode"
        require(launches[kernel] == L * n_fw,
                f"{what} {name}: {kernel} launched {launches[kernel]} times, want {L} x {n_fw}")
        if cache_dtype == "q8":
            require(launches["kv_append_quant"] == L * (n_fw + 1),
                    f"{what} {name}: int8 cache writes {launches['kv_append_quant']}")
        prefill = prefill_of(st)
        kw = dict(beam_size=BEAM, max_new_tokens=new_tokens, length_penalty=params.length_penalty,
                  repetition_penalty=params.repetition_penalty, **masks)
        tm = {"captured": Timings(), "eager": Timings()}
        cap = gen.beam_search_device(bundle, prefill, timings=tm["captured"], capture=True, **kw)
        graph = gen.captured_steps()[-1]
        eager = beam_search(bundle, prefill, timings=tm["eager"], capture=False, **kw)
        same = cap.tokens == eager.tokens and cap.logprobs == eager.logprobs
        require(same and cap.tokens[0] == st.result_tokens,
                f"{what} {name}: the captured beam differs from the eager host loop or "
                "from the request")
        step_ms = graph_device_ms(graph)
        src = torch.tensor([1, 0, 2, 3, 4][:BEAM], device=prefill.device)
        cache = graph.state.cache
        reorder = Graph(lambda: cache.reorder(src), prefill.device)
        reorder_ms = graph_device_ms(reorder)
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.parts())
        ms = {k: t.t_decode_us / 1e3 / max(t.n_decode, 1) for k, t in tm.items()}
        out[name].update({"replayed_ms_per_token": ms["captured"],
                          "eager_ms_per_token": ms["eager"], "step_device_ms": step_ms,
                          "reorder_device_ms": reorder_ms,
                          "reorder_bound_ms": 2 * cache_bytes / PEAK_BYTES * 1e3})
        log(f"4g {what} {name}: captured against the eager host loop from the same prefill: "
            f"{len(cap.tokens[0])} tokens, tokens and log-probabilities bit-equal {same}; "
            f"decode ms per token replayed {ms['captured']:.3f}, eager {ms['eager']:.3f}; "
            f"one beam step {step_ms:.3f} ms of device time (graph replays), its cache "
            f"reorder {reorder_ms:.4f} ms (a {cache_bytes / 1e9:.3f} GB cache gathered into "
            f"the scratch and copied back; bound {out[name]['reorder_bound_ms']:.4f} ms, the "
            f"cache read once and written once at 3.35 TB/s)")
        del reorder

    for cname, cache_dtype in caches:
        bundle.cache_dtype = cache_dtype
        name = "speculative" if cname == "bf16" else f"speculative {cname} cache"
        st, params, launches = request(name, speculative_k=SPEC_K)
        if cache_dtype == "q8":
            require(launches["kv_append_quant"] == L * (st.n_decode_forwards + 1),
                    f"{what} {name}: int8 cache writes {launches['kv_append_quant']}")
        require(launches["flash_decode"] == launches["flash_decode_quant"] == 0,
                f"{what} {name}: a verify forward of {SPEC_K + 1} rows launched the "
                "one-position decode kernel")
        prefill = prefill_of(st)
        kw = dict(max_new_tokens=new_tokens, spec_k=SPEC_K, **masks)
        tm = {"captured": Timings(), "eager": Timings()}
        cap = gen.greedy_decode_device(bundle, prefill, timings=tm["captured"], capture=True,
                                       **kw)
        graph = gen.captured_steps()[-1]
        eager = gen.greedy_decode_device(bundle, prefill, timings=tm["eager"], capture=False,
                                         **kw)
        same = (cap.tokens == eager.tokens and cap.logprobs == eager.logprobs
                and cap.spec_iters == eager.spec_iters)
        require(same and cap.tokens[0] == st.result_tokens,
                f"{what} {name}: the captured speculative decode differs from the eager "
                "loop or from the request")
        step_ms = graph_device_ms(graph)
        ms = {k: t.t_decode_us / 1e3 / max(t.n_decode, 1) for k, t in tm.items()}
        n_tok = len(cap.tokens[0])
        out[name].update({"replayed_ms_per_token": ms["captured"],
                          "eager_ms_per_token": ms["eager"], "step_device_ms": step_ms,
                          "iters": cap.spec_iters, "forwards": cap.n_decode_forwards,
                          "tokens_per_forward": n_tok / max(cap.spec_iters, 1)})
        log(f"4g {what} {name}: captured against the eager loop: bit-equal {same}; "
            f"{n_tok} tokens in {cap.spec_iters} iterations ({cap.n_decode_forwards} "
            f"forwards replayed), {n_tok / max(cap.spec_iters, 1):.3f} tokens per forward; "
            f"decode ms per token replayed {ms['captured']:.3f}, eager {ms['eager']:.3f}; "
            f"one verify step ({SPEC_K + 1} positions) {step_ms:.3f} ms of device time")
        if cname != "bf16":
            continue
        # against the greedy request: equal, or first different at a near tie
        ref, got = greedy.result_tokens, st.result_tokens
        j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b), None)
        if j is None and len(ref) != len(got):
            j = min(len(ref), len(got))
        one = teacher_forced_logits(bundle, greedy)
        wide = block_forced_logits(bundle, greedy, SPEC_K + 1)
        spread = max((a.float() - b.float()).abs().max().item() for a, b in zip(one, wide))
        gaps = [(r.float().topk(2).values[0] - r.float().topk(2).values[1]).item()
                for r in one]
        out[name].update({"first_difference": j, "spread": spread, "min_gap": min(gaps)})
        if j is None:
            log(f"4g {what} {name}: the greedy request's {len(ref)} tokens; widest logit "
                f"difference between one- and {SPEC_K + 1}-position forwards {spread:.4f}, "
                f"smallest greedy top-2 gap {min(gaps):.4f}")
        else:
            gap = gaps[min(j, len(gaps) - 1)]
            out[name]["gap"] = gap
            log(f"4g {what} {name}: first differs from the greedy request at token {j} "
                f"({ref[j:j + 1]} against {got[j:j + 1]}); the greedy step's top-2 gap there "
                f"{gap:.4f}, bound {SPEC_TIE} x {spread:.4f}")
            require(gap <= SPEC_TIE * spread, f"{what} {name}: tokens differ at {j} with a "
                    f"top-2 gap of {gap:.4f}, not a near tie")

    bundle.cache_dtype = caches[0][1]
    if trimmed:
        return out
    name = "token timestamps"
    # the tap's teacher-forced forward adds launches of its own: the quantized
    # entries' counts are logged, not derived
    st, params, _ = request(name, check_quant=False, token_timestamps=True, max_len=TS_MAX_LEN)
    require(st.result_tokens == greedy.result_tokens,
            f"{what} {name}: tokens differ from the greedy request's")
    segs = st.segments
    joined = [t for sg in segs for t in sg["tokens"]]
    times = [t for sg in segs for t in sg["token_times"]]
    lo, hi = params.offset_ms // 10, params.offset_ms // 10 + 3000
    require(joined == st.result_tokens and len(times) == len(joined),
            f"{what} {name}: the segments' tokens do not concatenate to the result")
    require(all(lo <= t <= hi for t in times) and all(b >= a for a, b in zip(times, times[1:])),
            f"{what} {name}: token times {times} not non-decreasing within [{lo}, {hi}]")
    prefill = prefill_of(st)
    n_aud = bundle.project_audio(st.embd_enc).shape[0]
    n_content = max(1, min(n_aud, -(-st.mel.n_len_org // 4)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = compute_token_timestamps(bundle, prefill, st.result_tokens, len(bundle.bos_tokens),
                                     n_aud, n_content, n_top=ctx.params.dtw_n_top)
    dtw_ms = (time.perf_counter() - t0) * 1e3
    require(again == times, f"{what} {name}: the times are not reproduced")
    out[name].update({"segments": len(segs), "dtw_ms": dtw_ms})
    log(f"4g {what} {name}: {len(segs)} segments (max_len {TS_MAX_LEN}), token times "
        f"{times}; the tap forward and DTW {dtw_ms:.1f} ms (host clock, synchronised)")
    bundle.cache_dtype = caches[0][1]
    return out


def run_quant_encode(src_path: str, hp, fmt: str, calls: int, workdir: str):
    """Quantize the F16 checkpoint ``src_path`` (of ``hp``) with the port's
    quantize_checkpoint, load it with the block weights kept, and run
    whisper_full ``calls`` times with the launch counters set to 0 just
    before and read just after."""
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.config import GGMLFType
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint
    from qwen2_audio_tpu_torch.quant.qparams import payload_form
    from qwen2_audio_tpu_torch.runtime.context import ContextParams

    t0 = time.perf_counter()
    path = os.path.join(workdir, f"qwen2-audio-random-{fmt}.bin")
    types = quantize_checkpoint(src_path, path, GGMLFType[f"MOSTLY_{fmt.upper()}"])
    n_q = sum(1 for t in types.values() if t not in (0, 1))
    log(f"quant encode {fmt}: quantize_checkpoint wrote {os.path.getsize(path) / 1e9:.3f} GB "
        f"({n_q} quantized tensors, {hp.n_audio_layer} layers) in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    require(n_q == 6 * hp.n_audio_layer, f"quant encode {fmt}: {n_q} quantized tensors")

    t0 = time.perf_counter()
    ctx = capi.whisper_init_from_file_with_params(
        path, ContextParams(compute_dtype=torch.bfloat16, keep_quantized=True))
    qkv = ctx.encoder.params["layers"][0]["qkv"]
    log(f"quant encode {fmt}: loaded on {ctx.device} in {time.perf_counter() - t0:.1f} s, "
        f"layer weights {payload_form(qkv)}")
    require("w" not in qkv, f"quant encode {fmt}: the weights were expanded to dense")
    x = noisy_tone(30.0, seed=3)
    params = capi.whisper_full_default_params()

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    per_call = []
    for _ in range(calls):
        t0 = time.perf_counter()
        rc = capi.whisper_full(ctx, params, x)
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
        require(rc == 0, f"quant encode {fmt}: whisper_full returned {rc}")
    launches = {k: c.launches for k, c in counters.items()}
    flat = "quant_matmul4" if "qs4" in qkv else "quant_matmul"
    tm = ctx.state.timings
    log(f"quant encode {fmt}: per-call ms {json.dumps([round(v, 3) for v in per_call])} "
        f"(mel {tm.t_mel_us / 1e3 / calls:.3f}, encode {tm.t_encode_us / 1e3 / calls:.3f} "
        f"ms/call, host clock, synchronised); launches {json.dumps(launches)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_quant_launches(f"quant encode {fmt}", launches,
                          {flat: 4 * hp.n_audio_layer * calls},
                          f"{calls} calls of {hp.n_audio_layer} layers")
    require(launches["mel_log_frames"] == calls
            and launches["attention_single"] == calls * hp.n_audio_layer,
            f"quant encode {fmt}: mel or attention launches")
    emb = ctx.state.embd_enc
    require(tuple(emb.shape) == (hp.n_audio_ctx // 2, hp.n_audio_state)
            and bool(torch.isfinite(emb).all()), f"quant encode {fmt}: bad output")

    # the same file expanded to dense weights at load: cuBLAS products
    dense = capi.whisper_init_from_file_with_params(
        path, ContextParams(compute_dtype=torch.bfloat16, keep_quantized=False))
    require(capi.whisper_full(dense, params, x) == 0, "quant encode: dense run failed")
    cos = _cosine(emb, dense.state.embd_enc)
    log(f"quant encode {fmt}: block weights through the kernel vs the same file loaded "
        f"dense: cos={cos:.6f} (min {MAIN_COS_MIN}), max_abs_diff="
        f"{(emb.float() - dense.state.embd_enc.float()).abs().max().item():.3e}")
    require(cos >= MAIN_COS_MIN, f"quant encode {fmt}: kernel path disagrees with dense")
    capi.whisper_free(dense)
    profile_call(lambda: capi.whisper_full(ctx, params, x), f"whisper_full (encode, {fmt})")
    steady = per_call[1:] or per_call
    dq16 = run_dequant16_encode(ctx, hp, fmt, x, emb, flat)
    return ctx, {"launches": launches, "per_call_ms": per_call,
                 "steady_ms": statistics.median(steady), "dq16": dq16}


def run_dequant16_encode(ctx, hp, fmt: str, x, ref, flat: str, calls: int = 3) -> dict:
    """The quantized encoder of ``ctx`` with the bf16-domain dequant of its
    format switched on (set_dequant16), ``calls`` calls on the clip of
    ``ref``, the launch counters set to 0 just before and read just after:
    4 launches of the flat entry per layer and call, the embedding against
    ``ref`` (the switch off)."""
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.ops.linear import set_dequant16

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    params = capi.whisper_full_default_params()
    set_dequant16(q4=fmt == "q4_0", q8=fmt == "q8_0")
    try:
        per_call = []
        for _ in range(calls):
            t0 = time.perf_counter()
            rc = capi.whisper_full(ctx, params, x)
            torch.cuda.synchronize()
            per_call.append((time.perf_counter() - t0) * 1e3)
            require(rc == 0, f"quant encode {fmt} dq16: whisper_full returned {rc}")
        launches = {k: c.launches for k, c in counters.items()}
        emb = ctx.state.embd_enc.clone()
        prof = profile_call(lambda: capi.whisper_full(ctx, params, x),
                            f"whisper_full (encode, {fmt}, dq16)")
    finally:
        set_dequant16()
    _check_quant_launches(f"quant encode {fmt} dq16", launches,
                          {flat: 4 * hp.n_audio_layer * calls},
                          f"{calls} calls of {hp.n_audio_layer} layers")
    cos = _cosine(emb, ref)
    log(f"quant encode {fmt} dq16: per-call ms {json.dumps([round(v, 3) for v in per_call])}; "
        f"embedding against the switch off: cos={cos:.6f} (min {MAIN_COS_MIN}), "
        f"max_abs_diff={(emb.float() - ref.float()).abs().max().item():.3e}")
    require(bool(torch.isfinite(emb).all()) and cos >= MAIN_COS_MIN,
            f"quant encode {fmt} dq16: the embedding disagrees with the switch off")
    return {"per_call_ms": per_call, "cos": cos, "busy_ms": (prof or {}).get("busy_ms")}


def dense_decoder_params(params: dict, dtype) -> dict:
    """A decoder tree with every block dict dequantized to a dense ``dtype``
    weight, layer by layer: the comparison's other side, never the port's."""
    import torch
    from qwen2_audio_tpu_torch.ops.quant_matmul import dequantize_weight

    def dense(entry: dict, stacked: bool) -> dict:
        if "w" in entry or not ({"qs", "qs4"} & set(entry)):
            return entry
        blocks = {k: v for k, v in entry.items() if k != "b"}
        if stacked:
            n = next(iter(blocks.values())).shape[0]
            w = torch.stack([dequantize_weight({k: v[i] for k, v in blocks.items()}, dtype)
                             for i in range(n)])
        else:
            w = dequantize_weight(blocks, dtype)
        return {"w": w, **({"b": entry["b"]} if "b" in entry else {})}

    out = dict(params)
    out["layers"] = {k: dense(v, True) for k, v in params["layers"].items()}
    if "lm_head" in params:
        out["lm_head"] = dense(params["lm_head"], False)
    return out


def expected_quant_launches(ctx, bundle, fused_on: bool, prefills: int, decodes: int,
                            prefill_rows: int, mode: str = "bf16") -> dict:
    """Launches of every quantized-weight entry that ``prefills`` requests
    with ``decodes`` decode forwards in all must make in group-matmul
    ``mode``, from the weight forms of the encoder and the decoder: one
    stacked launch per projection, layer and forward; one fused launch per
    layer and decode forward in place of gate_up's and down's where both are
    strided, the switch is on, the mode is not "int8" and the forward has at
    most ``ONE_LAUNCH_MAX_M`` rows (a decode forward here has at most 8);
    one flat launch per forward for the lm_head (last position only) and
    four per encoder layer and request. In mode "int8" the
    32-group "qs" and "qs4" take the integer kernels (a flat "qs4" the exact
    dequantizing one, as in JAX); "qs4b" takes its kernel in every mode."""
    from qwen2_audio_tpu_torch.ops.fused_mlp import ONE_LAUNCH_MAX_M

    def entry(e: dict, stacked: bool) -> str:
        if "qs4b" in e:
            return "quant_matmul_q4b_stacked"
        panel = "qs_p" in e or "qs4_p" in e
        if mode == "int8" and not panel and (stacked or "qs" in e):
            k = e["qs4"].shape[-2] * 2 if "qs4" in e else e["qs"].shape[-2]
            if k // e["scales"].shape[-2] == 32:
                return "quant_matmul_int8" + ("_stacked" if stacked else "")
        name = "quant_matmul" + ("_panel" if panel else "")
        name += "4" if "qs4" in e or "qs4_p" in e else ""
        return name + ("_stacked" if stacked else "")

    layers, L = bundle.params["layers"], bundle.cfg.num_hidden_layers
    forwards = prefills + decodes
    want: dict[str, int] = {}

    def add(name: str, n: int) -> None:
        want[name] = want.get(name, 0) + n

    for key in ("qkv", "o"):
        add(entry(layers[key], True), L * forwards)
    gu, dn = layers["gate_up"], layers["down"]
    strided = all(("qs" in e or "qs4" in e) for e in (gu, dn))
    one_launch = fused_on and mode != "int8" and strided and set(gu) == set(dn)
    fused_forwards = (decodes + (prefills if prefill_rows <= ONE_LAUNCH_MAX_M else 0)
                      if one_launch else 0)
    for e in (gu, dn):
        add(entry(e, True), L * (forwards - fused_forwards))
    if one_launch:
        add({(False, False): "fused_mlp_stacked", (False, True): "fused_mlp_m_stacked",
             (True, True): "fused_mlp4_stacked", (True, False): "fused_mlp4_sym_stacked"}[
                 "qs4" in gu, "mins" in gu], L * fused_forwards)
    add(entry(bundle.params["lm_head"], False), forwards)
    add(entry(ctx.encoder.params["layers"][0]["qkv"], False),
        4 * ctx.hparams.n_audio_layer * prefills)
    return {k: v for k, v in want.items() if v}


def _check_quant_launches(what: str, launches: dict, want: dict, detail: str) -> None:
    for e in _quant_entries():
        n = e.__name__
        require(launches[n] == want.get(n, 0), f"{what}: {n} launched {launches[n]} times, "
                f"want {want.get(n, 0)} for {detail}")


def _request(ctx, clip, params) -> tuple:
    """One whisper_full request on a fresh state with every launch counter
    set to 0 just before and read just after: (state, run figures,
    launches)."""
    import torch
    from qwen2_audio_tpu_torch import capi
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    st = ctx.init_state()
    t1 = time.perf_counter()
    rc = capi.whisper_full_with_state(ctx, st, params, clip)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    require(rc == 0, f"whisper_full returned {rc}")
    tm, n_tok = st.timings, len(st.result_tokens)
    run = {"wall_ms": wall, "encode_ms": tm.t_encode_us / 1e3,
           "prefill_ms": tm.t_prompt_us / 1e3, "prefill_positions": tm.n_prompt,
           "tokens": n_tok, "forwards": st.n_decode_forwards,
           "decode_ms_per_token": tm.t_decode_us / 1e3 / max(n_tok, 1),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return st, run, launches


def _text_params(n_new: int):
    from qwen2_audio_tpu_torch import capi
    params = capi.whisper_full_default_params()
    params.max_new_tokens = n_new
    params.temperature_inc = 0.0        # random weights: no fallback decodes
    params.print_progress = False
    return params


def run_quant_text(ctx, cfg, fmt: str, new_tokens: int, pool_clips=None) -> dict:
    """Behind the quantized encoder of ``ctx``, attach a decoder whose
    linears and lm_head are random ``fmt`` blocks made on the card (seed 0)
    and answer one request per storage configuration on one clip through
    capi.whisper_full, each with the launch counters set to 0 just before
    and read just after. With ``pool_clips``, phase 4h's pools over them on
    the strided blocks with the one-launch SwiGLU at its default (under
    "pool"). Returns the configurations' results by name."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder, panelize_decoder_params
    from qwen2_audio_tpu_torch.ops.fused_mlp import ENTRIES as FUSED_ENTRIES
    from qwen2_audio_tpu_torch.ops.linear import set_dequant16, set_fused_mlp
    from qwen2_audio_tpu_torch.quant.qparams import payload_form

    t0 = time.perf_counter()
    bundle = random_bundle(torch.Generator(device=ctx.device).manual_seed(0), cfg,
                           ctx.hparams.n_audio_state, dtype=torch.bfloat16,
                           max_ctx=2048, cache_dtype=torch.bfloat16, quant=fmt)
    ctx.decoder = bundle
    torch.cuda.synchronize()
    strided = bundle.decoder
    n_bytes = sum(t.numel() * t.element_size() for t in strided.buffers())
    q_bytes = sum(t.numel() * t.element_size() for n, t in strided.named_buffers()
                  if n.rsplit(".", 1)[-1] in ("qs", "qs4", "scales"))
    log(f"quant text {fmt}: {cfg.num_hidden_layers}-layer decoder, {n_bytes / 1e9:.2f} GB on "
        f"the card ({q_bytes / 1e9:.2f} GB of blocks and scales read per decode step, "
        f"{q_bytes / PEAK_BYTES * 1e3:.3f} ms at 3.35 TB/s), layers "
        f"{payload_form(bundle.params['layers']['qkv'])}, lm_head "
        f"{payload_form(bundle.params['lm_head'])}, made in {time.perf_counter() - t0:.1f} s")
    clip = noisy_tone(30.0, seed=40, freq=280.0)
    L = cfg.num_hidden_layers
    # (name, panelize arguments or None, the one-launch SwiGLU's switch, new
    # tokens, set_dequant16 arguments); the dq16 request is the first
    # configuration with the bf16-domain dequant on, teacher-forced against it
    few = min(PANEL_TOKENS, new_tokens)
    configs = {
        "q8_0": [("per-projection MLP", None, False, new_tokens, {}),
                 ("per-projection MLP, dq16", None, False, few, {"q8": True}),
                 ("one-launch SwiGLU", None, True, new_tokens, {}),
                 ("panelized", {}, True, few, {})],
        "q4_0": [("one-launch SwiGLU", None, True, new_tokens, {}),
                 ("one-launch SwiGLU, dq16", None, True, few, {"q4": True}),
                 ("panelized", {}, True, new_tokens, {}),
                 ("panelized, gate_up strided", {"skip_gate_up": True}, True, new_tokens, {})],
    }[fmt]
    out, first, first_logits = {}, None, None
    try:
        for name, panel, fused_on, n_new, dq16 in configs:
            what = f"quant text {fmt} ({name})"
            set_fused_mlp(fused_on)
            set_dequant16(**dq16)
            t0 = time.perf_counter()
            bundle.decoder = strided if panel is None else Decoder(
                panelize_decoder_params(strided.params, **panel), cfg)
            torch.cuda.synchronize()
            forms = {k: payload_form(bundle.params["layers"][k])
                     for k in ("qkv", "o", "gate_up", "down")}
            forms["lm_head"] = payload_form(bundle.params["lm_head"])
            if panel is not None:
                log(f"{what}: panelized on the card in {time.perf_counter() - t0:.2f} s")
            params = _text_params(n_new)
            st, run, launches = _request(ctx, clip, params)
            n_tok = run["tokens"]
            require(n_tok > 0 and len(st.segments) == 1, f"{what}: no tokens")
            require(bool(np.isfinite(st.logits).all()), f"{what}: logits not finite")
            log(f"{what}: forms {json.dumps(forms)}; request {json.dumps(run)}; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}; text "
                f"{capi.whisper_full_get_segment_text_from_state(st, 0)[:60]!r}")
            _check_quant_launches(what, launches, expected_quant_launches(
                ctx, bundle, fused_on, 1, st.n_decode_forwards, run["prefill_positions"]),
                f"1 prefill of {run['prefill_positions']} rows and {st.n_decode_forwards} "
                "decode forwards")
            require(launches["attention_causal"] == L
                    and launches["flash_decode"] == L * st.n_decode_forwards,
                    f"{what}: prefill or decode kernel launches")
            n_fused = sum(launches[e.__name__] for e in FUSED_ENTRIES)
            require((n_fused > 0) == (fused_on and (panel is None
                                                    or bool(panel.get("skip_gate_up")))),
                    f"{what}: {n_fused} fused launches")
            run["against"] = captured_against_eager(bundle, st, params, what)

            if first is None:
                # against the same weights dequantized to dense bf16 (cuBLAS)
                first = st
                dense = dense_decoder_params(bundle.params, torch.bfloat16)
                cos = teacher_forced_cosines(bundle, st, other=dense)
                del dense
                log(f"{what}: kernel path vs the same weights dequantized to dense bf16, "
                    f"teacher-forced over {len(cos)} steps: min cos {min(cos):.6f} (min "
                    f"{MAIN_COS_MIN}), per step {json.dumps([round(c, 6) for c in cos])}")
                require(min(cos) >= MAIN_COS_MIN, f"{what}: kernel path disagrees with dense")
                first_logits = teacher_forced_logits(bundle, first)
            elif (fmt, name) in (("q8_0", "panelized"),
                                 ("q4_0", "panelized, gate_up strided")):
                # every kernel gives the first configuration's bits
                require(st.result_tokens == first.result_tokens[:n_tok],
                        f"{what}: tokens differ from the first configuration's")
                same = n_tok != len(first.result_tokens) or np.array_equal(st.logits,
                                                                           first.logits)
                log(f"{what}: the first configuration's tokens; final logits bit-equal: "
                    f"{same}")
                require(same, f"{what}: final logits differ from the first configuration's")
            else:
                # another order of sums and roundings in the MLP (and with
                # dq16 in the encoder): the first configuration's tokens
                # teacher-forced through this one from this request's own
                # embedding
                mine = teacher_forced_logits(bundle, first, embd=st.embd_enc)
                cos = [_cosine(a, b) for a, b in zip(first_logits, mine)]
                split, n_ties = first_real_disagreement(first_logits, mine)
                upto = n_tok if split is None else min(split, n_tok)
                log(f"{what}: against the first configuration, teacher-forced over "
                    f"{len(cos)} steps: min cos {min(cos):.6f} (min {MAIN_COS_MIN}); "
                    f"{n_ties} near-tie steps pick another token; this request's tokens "
                    f"equal the first's up to step {upto}: "
                    f"{st.result_tokens[:upto] == first.result_tokens[:upto]}")
                require(min(cos) >= MAIN_COS_MIN, f"{what}: disagrees with the first "
                        "configuration")
                require(st.result_tokens[:upto] == first.result_tokens[:upto],
                        f"{what}: tokens differ before the first near-tie")
            run["profile"] = profile_call(lambda: capi.whisper_full(ctx, params, clip),
                                          f"whisper_full (audio -> text, {fmt}, {name})")
            out[name] = {"launches": launches, "run": run, "forms": forms}
        set_fused_mlp(None)
        set_dequant16()
        if pool_clips is not None:
            t0 = time.perf_counter()
            bundle.decoder = strided
            out["pool"] = run_pool(ctx, fmt, new_tokens, pool_clips)
            out["pool"]["seconds"] = time.perf_counter() - t0
        # phase 4g: the blocks in panels with gate_up strided and the
        # one-launch SwiGLU on, so that the two formats' requests launch
        # rows 6-13 and 17 between them
        set_fused_mlp(True)
        bundle.decoder = Decoder(panelize_decoder_params(strided.params, skip_gate_up=True), cfg)
        out["options"] = run_decode_options(ctx, f"{fmt} (panelized, gate_up strided)",
                                            new_tokens, clip, quantized=True)
    finally:
        set_fused_mlp(None)
        set_dequant16()
    ctx.decoder = None
    del bundle, strided
    torch.cuda.empty_cache()
    out["block_gb"] = q_bytes / 1e9
    return out


def run_int8_paths(ctx, cfg, new_tokens: int) -> dict:
    """Phase 4e, behind the q8_0 encoder of ``ctx`` (blocks kept): mode
    "int8" and the word-packed q4_0 form at full width, one request each on
    one clip, every launch counter set to 0 just before and read just after:
    the encoder alone in mode "int8" (4 launches of the flat integer entry
    per layer, none of a dequantizing one; the embedding against the bf16
    mode's); audio -> text in mode "int8" with a q8_0 and with a symmetric
    q4_0 decoder of random blocks made on the card (seed 0, the decoders of
    phase 4d), the logits teacher-forced against the bf16 mode over the same
    weights; audio -> text with the same q4_0 bytes as int32 words in the
    default mode, teacher-forced against the q4_0 request in mode "int8"
    (the four linears give the same bits, the lm_head differs: the exact
    dequantizing kernel there against the integer one here). On the q8_0
    decoder in mode "int8", a beam-5 and a speculative_k = SPEC_K request
    (``run_decode_options`` behind the greedy one: the integer kernels at M
    = 5 and 8), each decoded again captured and eager, bit-equal, with one
    captured step's device ms. Every count is derived from the prefills and
    forwards the run reports."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import payload_form

    clip = noisy_tone(30.0, seed=40, freq=280.0)
    n_enc, L = ctx.hparams.n_audio_layer, cfg.num_hidden_layers
    out = {}
    ctx.decoder = None
    try:
        # the encoder alone: the bf16 mode's embedding, then mode "int8"
        set_group_matmul_mode(None)
        require(capi.whisper_full(ctx, capi.whisper_full_default_params(), clip) == 0,
                "int8 encode: the bf16-mode call failed")
        ref = ctx.state.embd_enc.clone()
        set_group_matmul_mode("int8")
        enc_params = capi.whisper_full_default_params()
        st, run, launches = _request(ctx, clip, enc_params)
        _check_quant_launches("int8 encode", launches, {"quant_matmul_int8": 4 * n_enc},
                              f"1 call of {n_enc} layers")
        require(launches["mel_log_frames"] == 1 and launches["attention_single"] == n_enc,
                "int8 encode: mel or attention launches")
        emb = st.embd_enc
        require(tuple(emb.shape) == tuple(ref.shape) and bool(torch.isfinite(emb).all()),
                "int8 encode: bad output")
        cos = _cosine(emb, ref)
        log(f"int8 encode: {json.dumps(run)}; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; embedding against the "
            f"bf16 mode's: cos={cos:.6f} (min {MAIN_COS_MIN})")
        require(cos >= MAIN_COS_MIN, "int8 encode: the embedding disagrees with the bf16 mode")
        run["profile"] = profile_call(lambda: capi.whisper_full(ctx, enc_params, clip),
                                      "whisper_full (encode, q8_0, mode int8)")
        out["encode"] = {"launches": launches, "run": run, "cos": cos}

        params = _text_params(new_tokens)
        q4 = None
        # (name, random block format, b32 words, group-matmul mode)
        for name, fmt, b32, mode in (("q8_0 int8 mode", "q8_0", False, "int8"),
                                     ("q4_0 int8 mode", "q4_0", False, "int8"),
                                     ("q4_0 b32", "q4_0", True, None)):
            what = f"int8 text ({name})"
            set_group_matmul_mode(mode)
            bundle = random_bundle(torch.Generator(device=ctx.device).manual_seed(0), cfg,
                                   ctx.hparams.n_audio_state, dtype=torch.bfloat16,
                                   max_ctx=2048, cache_dtype=torch.bfloat16, quant=fmt,
                                   b32=b32)
            ctx.decoder = bundle
            forms = {k: payload_form(bundle.params["layers"][k]) for k in ("qkv", "gate_up")}
            forms["lm_head"] = payload_form(bundle.params["lm_head"])
            st, run, launches = _request(ctx, clip, params)
            require(run["tokens"] > 0 and bool(np.isfinite(st.logits).all()),
                    f"{what}: no tokens or logits not finite")
            log(f"{what}: forms {json.dumps(forms)}; request {json.dumps(run)}; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
            _check_quant_launches(what, launches, expected_quant_launches(
                ctx, bundle, True, 1, st.n_decode_forwards, run["prefill_positions"],
                mode=mode or "bf16"),
                f"1 prefill and {st.n_decode_forwards} decode forwards")
            require(launches["attention_causal"] == L
                    and launches["flash_decode"] == L * st.n_decode_forwards,
                    f"{what}: prefill or decode kernel launches")
            run["against"] = captured_against_eager(bundle, st, params, what)
            mine = teacher_forced_logits(bundle, st)
            if b32:     # the same bytes as nibble bytes, in mode "int8"
                other = teacher_forced_logits(q4[0], st, mode="int8")
                against = "the q4_0 nibble bytes in mode int8"
            else:
                other = teacher_forced_logits(bundle, st, mode="bf16")
                against = "the bf16 mode"
            cos = [_cosine(a, b) for a, b in zip(mine, other)]
            split, n_ties = first_real_disagreement(mine, other)
            log(f"{what}: against {against}, teacher-forced over {len(cos)} steps: min cos "
                f"{min(cos):.6f} (min {MAIN_COS_MIN}); {n_ties} near-tie steps pick another "
                f"token, the first at {split}")
            require(min(cos) >= MAIN_COS_MIN, f"{what}: disagrees with {against}")
            run["profile"] = profile_call(lambda: capi.whisper_full(ctx, params, clip),
                                          f"whisper_full (audio -> text, {name})")
            out[name] = {"launches": launches, "run": run, "forms": forms, "min_cos": min(cos)}
            if name == "q8_0 int8 mode":   # M = 5 and 8 through rows 14 and 15
                out[name]["options"] = run_decode_options(
                    ctx, f"int8 text ({name})", new_tokens, clip, quantized=True, mode="int8",
                    greedy=st)
            if name == "q4_0 int8 mode":
                q4 = (bundle, st)
            del bundle
            ctx.decoder = None
            torch.cuda.empty_cache()
    finally:
        set_group_matmul_mode(None)
        ctx.decoder = None
    del q4
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 4h: HF loading, the w8a8 form, the serving layer
# --------------------------------------------------------------------------- #



def check_w8a8(device, dims=(3584, 18944, 156032, 1280)) -> dict:
    """The w8a8 product (ops/linear.py::int8_matmul, one torch._int_mm, the
    rows of M < 17 padded) against its plain version, exact in int32, at M =
    1, 8, 64 and 1500 over the decoder's qkv, gate_up, down and lm_head and
    the encoder's fc1 and fc2, the weight K-major as the modules hold it
    and row-major; the whole w8a8 linear (rows quantized, product, rescale)
    bit-equal to the CPU's at each M of the decoder's gate_up. Timed (the
    K-major weight) where the main path runs it (M 1 and 8 by graph
    replay): the product, its plain version and its bound (the int8 inputs
    read once, the int32 output written once; 2MKN int8 operations), and
    the row-major weight's time beside it."""
    import torch
    from qwen2_audio_tpu_torch.ops import linear as tl
    D, I, V, E = dims
    shapes = {"qkv": (D, D + D // 7 * 2), "gate_up": (D, 2 * I), "down": (I, D),
              "lm_head": (D, V), "fc1": (E, 4 * E), "fc2": (4 * E, E)}
    cases = [(w, M) for w in ("qkv", "gate_up", "down", "lm_head") for M in W8A8_M[:3]] \
        + [(w, 1500) for w in ("gate_up", "fc1", "fc2")]
    out = {}
    for i, (w, M) in enumerate(cases):
        K, N = shapes[w]
        g = torch.Generator(device=device).manual_seed(300 + i)
        a = torch.randint(-128, 128, (M, K), generator=g, device=device, dtype=torch.int8)
        # K-major, as the decoder and encoder modules hold "qs8"
        b = tl.w8a8_layout({"qs8": torch.randint(-128, 128, (K, N), generator=g,
                                                 device=device, dtype=torch.int8)})["qs8"]
        got = tl.int8_matmul(a, b)
        want = tl.int8_matmul_plain(a, b)
        torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(tl.int8_matmul(a, b.contiguous()), want),
                f"w8a8 {w} M={M}: torch._int_mm differs from the exact int32 product")
        what = f"w8a8 product {w} M={M} K={K} N={N}"
        if w == "gate_up" and M <= 64:
            x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
            sc = torch.rand(N, generator=g, device=device) * 1e-3
            card = tl.w8a8(x, b, sc)
            require(torch.equal(card.cpu(), tl.w8a8(x.cpu(), b.cpu(), sc.cpu())),
                    f"{what}: the w8a8 linear differs from the CPU's bits")
        if (w, M) not in (("qkv", 1), ("gate_up", 1), ("gate_up", 8), ("gate_up", 64),
                          ("lm_head", 1), ("fc1", 1500)):
            log(f"{what}: exact")
            continue
        nbytes = a.numel() + b.numel() + 4 * M * N
        b_ms, b_by = bound(2.0 * M * K * N, nbytes, PEAK_INT8)
        run = lambda: tl.int8_matmul(a, b)   # noqa: E731
        bn = b.contiguous()
        t = {"ms": graph_ms(run) if M <= 8 else time_ms(run, iters=10),
             "plain_ms": time_ms(lambda: tl.int8_matmul_plain(a, b), iters=3, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "row_major_ms": graph_ms(lambda: tl.int8_matmul(a, bn)) if M <= 8
             else time_ms(lambda: tl.int8_matmul(a, bn), iters=10)}
        t["bound_share"] = b_ms / t["ms"]
        log(f"{what}: exact; " + json.dumps(t))
        out[f"{w} M{M}"] = t
        del a, b, bn
    torch.cuda.empty_cache()
    return out


def _pool_windows(ctx, clips) -> list:
    """Each clip's 30 s windows in transcribe_many's order: (clip, t0_cs,
    prefill (1, T0, D)), the prefill as the pool builds it."""
    from qwen2_audio_tpu_torch.runtime.decoding import _prefill_embeds
    from qwen2_audio_tpu_torch.runtime.serving import _chunk_offsets, encode_windows
    bundle = ctx.decoder
    out = []
    for a, clip in enumerate(clips):
        st = ctx.init_state()
        require(ctx.pcm_to_mel_with_state(st, clip) == 0, "pool: mel")
        offs = _chunk_offsets(st.mel.n_len_org, ctx.hparams.n_audio_ctx)
        enc = encode_windows(ctx, st.mel, offs)
        out += [(a, off, _prefill_embeds(bundle, bundle.project_audio(enc[w]), []))
                for w, off in enumerate(offs)]
    return out


def _forced_rows(bundle, prefills: list, toks: list, width: int) -> list:
    """Teacher forcing of B = len(prefills) streams at once, each at its own
    positions: every prompt prefilled into its slot (prefill_slot), then the
    streams' tokens fed ``width`` at a time; per stream, one (V,) logits row
    per token (the row its token was picked from)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.runtime.generate import prefill_slot
    B, dev, cfg = len(prefills), prefills[0].device, bundle.cfg
    T0 = [p.shape[1] for p in prefills]
    n = max(len(t) for t in toks)
    pool = (create_cache(cfg, B, max(T0) + n + width, dtype=bundle.cache_dtype, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.zeros(B, cfg.vocab_size, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev))
    for b, p in enumerate(prefills):
        prefill_slot(bundle.params, cfg, *pool, b, p)
    rows = [[pool[2][b].clone()] for b in range(B)]
    for i in range(0, n - 1, width):
        block = [(list(t[i:i + width]) + [0] * width)[:width] for t in toks]
        x = bundle.decoder.embed(torch.tensor(block, device=dev))
        pos = torch.tensor([t0 + i for t0 in T0], dtype=torch.int32, device=dev)
        lg, _ = decoder_forward(bundle.params, cfg, x, pool[0], pos)
        for b in range(B):
            rows[b].extend(lg[b, :max(0, min(width, len(toks[b]) - 1 - i))])
    return rows


def _against_reference(bundle, windows, refs: list, got: list, width: int,
                       what: str) -> dict:
    """Each window's pool tokens against its own B = 1 greedy decode: equal,
    or equal up to a first difference where the reference's top-2 logit gap
    is at most SPEC_TIE x the widest logit difference, up to that token,
    between its B = 1 one-position forwards and B = POOL_SLOTS forwards
    ``width`` positions wide over the same tokens (teacher-forced, computed
    only then)."""
    diffs = {}
    for w, (r, g) in enumerate(zip(refs, got)):
        j = next((i for i, (a, b) in enumerate(zip(r, g)) if a != b), None)
        if j is None and len(r) != len(g):
            j = min(len(r), len(g))
        if j is None:
            continue
        # POOL_SLOTS windows holding w, as the live pool's step has them (the
        # decode kernel's split count, and so its rounding, follows the batch)
        start = max(0, min(w - POOL_SLOTS + 1, len(windows) - POOL_SLOTS))
        group = list(range(start, min(len(windows), start + POOL_SLOTS)))
        ref_rows = _forced_rows(bundle, [windows[w][2]], [r[:j + 1]], 1)[0]
        pool_rows = _forced_rows(bundle, [windows[v][2] for v in group],
                                 [refs[v][:j + 1] for v in group], width)[group.index(w)]
        spread = max((a - b).abs().max().item() for a, b in zip(ref_rows, pool_rows))
        top = ref_rows[min(j, len(ref_rows) - 1)].topk(2).values
        gap = (top[0] - top[1]).item()
        diffs[w] = {"at": j, "gap": gap, "spread": spread}
        log(f"{what}: window {w} first differs from its B = 1 decode at token {j} "
            f"({r[j:j + 1]} against {g[j:j + 1]}); the reference's top-2 gap there "
            f"{gap:.4f}, bound {SPEC_TIE} x {spread:.4f}")
        require(gap <= SPEC_TIE * spread, f"{what}: window {w} differs at {j} with a "
                f"top-2 gap of {gap:.4f}, not a near tie")
    return diffs


def _pick_eos(refs: list) -> int:
    """The token whose first emission splits the windows' B = 1 streams into
    the most different stopping steps (a window that never emits it runs to
    the budget), so that slots finish apart and refill mid-run."""
    def stops(t):
        return {r.index(t) if t in r else len(r) for r in refs}
    cands = sorted({t for r in refs for t in r})
    best = max(cands, key=lambda t: (len(stops(t)), -t))
    require(len(stops(best)) >= 2, f"pool: every window's stream stops alike {refs}")
    return best


def run_pool(ctx, what: str, new_tokens: int, clips, spec_ks=(0, SPEC_K)) -> dict:
    """Phase 4h on the decoder attached to ``ctx``: transcribe_many over
    ``clips`` through POOL_SLOTS slots, POOL_CHUNK tokens a chunk, once per
    ``speculative_k`` in ``spec_ks``, every launch counter set to 0 just
    before each run and read just after. The EOS is a token the windows'
    own B = 1 greedy streams emit at different steps (``_pick_eos``), so
    slots finish apart, refill mid-run and stand at different positions.

    Each run: its segments against each window's B = 1 greedy decode (equal
    up to a first near tie), again with the pool's chunks run eagerly
    (bit-equal tokens and probabilities), launches derived from its chunks;
    aggregate tokens/s, ms per chunk, refills, peak GiB; one captured pool
    step's device ms (B = POOL_SLOTS) beside one B = 1 step's, and for the
    speculative pool one verify iteration's (M = POOL_SLOTS x (K + 1))."""
    import functools

    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp
    from qwen2_audio_tpu_torch.runtime import generate as gen
    from qwen2_audio_tpu_torch.runtime import serving

    bundle = ctx.decoder
    L, eos0 = bundle.cfg.num_hidden_layers, bundle.eos_token_id
    cache_name = "int8" if bundle.cache_dtype == "q8" else "bf16"
    windows = _pool_windows(ctx, clips)
    refs0 = [gen.greedy_decode_device(bundle, p, max_new_tokens=new_tokens).tokens[0]
             for _, _, p in windows]
    eos = _pick_eos(refs0)
    refs = [r[:r.index(eos) + 1] if eos in r else r for r in refs0]
    log(f"4h {what}: {len(windows)} windows of {len(clips)} clips; EOS {eos}, emitted at "
        f"steps {[len(r) - 1 if r[-1] == eos else None for r in refs]} of their B = 1 "
        f"decodes")
    out = {"eos": eos, "windows": len(windows)}
    prefills = [p for _, _, p in windows][:POOL_SLOTS]
    bundle.eos_token_id = eos
    try:
        for k in spec_ks:
            name = "plain" if k == 0 else f"speculative K = {k}"
            params = _text_params(new_tokens)
            params.speculative_k = k

            def pool_run(capture: bool):
                patch = {} if capture else {
                    f: getattr(serving, f) for f in ("decode_chunk_slots",
                                                     "decode_chunk_slots_spec")}
                for f, fn in patch.items():
                    setattr(serving, f, functools.partial(fn, capture=False))
                try:
                    st = ctx.init_state()
                    ctx.state = st
                    t0 = time.perf_counter()
                    segs = list(serving.transcribe_many(ctx, clips, params,
                                                        max_streams=POOL_SLOTS,
                                                        chunk_tokens=POOL_CHUNK))
                    torch.cuda.synchronize()
                    return segs, st, (time.perf_counter() - t0) * 1e3
                finally:
                    for f, fn in patch.items():
                        setattr(serving, f, fn)

            counters = _launch_counters()
            for c in counters.values():
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            segs, st, wall = pool_run(True)
            launches = {n_: c.launches for n_, c in counters.items() if c.launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            stats = {k_: v for k_, v in serving.LAST_POOL_STATS.items()}
            by_window = {(a, s.t0_cs): s for a, s in segs}
            require(len(segs) == len(windows) and set(by_window) == {(a, t) for a, t, _ in
                                                                     windows},
                    f"4h {what} {name}: {len(segs)} segments for {len(windows)} windows")
            got = [by_window[(a, t)].tokens for a, t, _ in windows]
            n_tok = sum(len(t) for t in got)
            chunks = stats["plain_chunks"] + stats["spec_chunks"]
            # launches, from the chunks: a plain chunk is POOL_CHUNK forwards of
            # B = POOL_SLOTS one position wide; a verify forward takes the
            # plain attention
            n_win, n_clip = len(windows), len(clips)
            kern = "flash_decode_quant" if cache_name == "int8" else "flash_decode"
            want = {"attention_causal": L * n_win, "mel_log_frames": n_clip,
                    "attention_single": n_win * ctx.hparams.n_audio_layer,
                    kern: L * POOL_CHUNK * stats["plain_chunks"]}
            for n_, v in want.items():
                require(launches.get(n_, 0) == v, f"4h {what} {name}: {n_} launched "
                        f"{launches.get(n_, 0)} times, want {v}")
            require(launches.get(kern, 0) > 0 or k > 0, f"4h {what} {name}: no {kern}")
            _, e_st, e_wall = pool_run(False)
            order = [(sg["t0"], sg["tokens"], sg["probs"]) for sg in st.segments]
            require([(sg["t0"], sg["tokens"], sg["probs"]) for sg in e_st.segments] == order,
                    f"4h {what} {name}: the captured pool differs from the eager one "
                    "(tokens, probabilities or completion order)")
            diffs = _against_reference(bundle, windows, refs, got, 1 if k == 0 else k + 1,
                                       f"4h {what} {name}")
            tm = st.timings
            run = {"tokens": n_tok, "wall_ms": wall, "eager_wall_ms": e_wall,
                   "decode_ms": tm.t_decode_us / 1e3,
                   "tokens_per_s": n_tok / max(tm.t_decode_us / 1e6, 1e-9),
                   "wall_tokens_per_s": n_tok / (wall / 1e3),
                   "chunks": chunks, "ms_per_chunk": statistics.median(stats["chunk_ms"]),
                   "chunk_ms": [round(v, 3) for v in stats["chunk_ms"]],
                   "refills": stats["refills"], "peak_gib": peak,
                   "same_as_b1": len(windows) - len(diffs), "near_ties": len(diffs)}
            if k:
                run.update(iters=stats["spec_iters"],
                           tokens_per_verify=stats["spec_tokens"] / max(stats["spec_iters"], 1))
            # one captured pool step by graph replays, over the first windows
            pool = (gen.create_cache(bundle.cfg, POOL_SLOTS, bundle.max_ctx,
                                     dtype=bundle.cache_dtype, device=ctx.device),
                    torch.zeros(POOL_SLOTS, dtype=torch.int32, device=ctx.device),
                    torch.zeros(POOL_SLOTS, bundle.cfg.vocab_size, device=ctx.device),
                    torch.zeros(POOL_SLOTS, dtype=torch.bool, device=ctx.device))
            for s_, p in enumerate(prefills):
                gen.prefill_slot(bundle.params, bundle.cfg, *pool, s_, p)
            hist = torch.zeros(POOL_SLOTS, new_tokens + POOL_CHUNK + 16, dtype=torch.int32,
                               device=ctx.device)
            hlen = torch.zeros(POOL_SLOTS, dtype=torch.int32, device=ctx.device)

            def step_ms():
                if k == 0:
                    gen.decode_chunk_slots(bundle.params, bundle.cfg, *pool,
                                           chunk=POOL_CHUNK, eos_token_id=-1)
                else:
                    gen.decode_chunk_slots_spec(bundle.params, bundle.cfg, *pool, hist, hlen,
                                                chunk=POOL_CHUNK, eos_token_id=-1, spec_k=k)
                ms = graph_device_ms(gen.captured_steps()[-1])
                gen.drop_pool_graphs(pool[1])
                return ms

            run["step_device_ms" if k == 0 else "verify_device_ms"] = step_ms()
            T0 = prefills[0].shape[1]
            run["b1_step_device_ms"] = step_device_ms(bundle, T0 + new_tokens // 2,
                                                      bundle.max_ctx)
            run["launches"] = launches
            out[name] = run
            log(f"4h {what} {name}: " + json.dumps(run))
    finally:
        bundle.eos_token_id = eos0
    return out


def run_w8a8_request(ctx, cfg, new_tokens: int) -> dict:
    """A decoder of random per-channel w8a8 weights made on the card (every
    linear and the lm_head), one request through whisper_full on one clip
    with the launch counters set to 0 just before and read just after (the
    int8 product once per linear and forward), decoded again replayed and
    eager from the same prefill (bit-equal); ms per token and one step's
    device ms against the weights' byte bound."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    t0 = time.perf_counter()
    bundle = random_bundle(torch.Generator(device=ctx.device).manual_seed(0), cfg,
                           ctx.hparams.n_audio_state, dtype=torch.bfloat16, max_ctx=2048,
                           cache_dtype=torch.bfloat16, quant="w8a8")
    ctx.decoder = bundle
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for n, t in bundle.decoder.named_buffers()
                  if n.rsplit(".", 1)[-1] in ("qs8", "scale_n"))
    log(f"4h w8a8: {cfg.num_hidden_layers}-layer decoder, {w_bytes / 1e9:.3f} GB of int8 "
        f"weights and scales made in {time.perf_counter() - t0:.1f} s")
    params = _text_params(new_tokens)
    st, run, launches = _request(ctx, noisy_tone(30.0, seed=50, freq=320.0), params)
    L = cfg.num_hidden_layers
    forwards = st.n_decode_forwards + 1
    require(run["tokens"] > 0, "4h w8a8: no tokens")
    require(launches["int8_matmul"] == (4 * L + 1) * forwards,
            f"4h w8a8: int8 products {launches['int8_matmul']}, want {4 * L + 1} x "
            f"{forwards} forwards")
    run["against"] = captured_against_eager(bundle, st, params, "4h w8a8")
    run["bound_ms"] = w_bytes / PEAK_BYTES * 1e3
    run["launches"] = {k: v for k, v in launches.items() if v}
    log(f"4h w8a8: request {json.dumps(run)}")
    ctx.decoder = None
    del bundle
    torch.cuda.empty_cache()
    return run


def write_hf_checkpoint(path: str, hp, cfg, device, seed: int = 0) -> float:
    """A random Qwen2-Audio checkpoint in HF naming (audio_tower.*,
    multi_modal_projector.*, language_model.*), bf16, ``hp`` and ``cfg``
    wide and deep, written with torch.save as ``pytorch_model.bin`` beside
    its ``config.json``, the values drawn on ``device``; returns the GB
    written."""
    import torch
    os.makedirs(path, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(seed)
    sd = {}

    def put(name, *shape, std=0.02, one=False):
        t = torch.ones(shape, device=device) if one else \
            torch.randn(shape, generator=g, device=device) * std
        sd[name] = t.to(torch.bfloat16).cpu()

    E, D, I, V = hp.n_audio_state, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq, nkv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    a = "audio_tower."
    put(a + "conv1.weight", E, hp.n_mels, 3)
    put(a + "conv1.bias", E)
    put(a + "conv2.weight", E, E, 3)
    put(a + "conv2.bias", E)
    put(a + "embed_positions.weight", hp.n_audio_ctx, E)
    for i in range(hp.n_audio_layer):
        p = f"{a}layers.{i}."
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            put(p + ln + ".weight", E, one=True)
            put(p + ln + ".bias", E)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(p + f"self_attn.{proj}.weight", E, E)
            if proj != "k_proj":
                put(p + f"self_attn.{proj}.bias", E)
        put(p + "fc1.weight", 4 * E, E)
        put(p + "fc1.bias", 4 * E)
        put(p + "fc2.weight", E, 4 * E)
        put(p + "fc2.bias", E)
    put(a + "layer_norm.weight", E, one=True)
    put(a + "layer_norm.bias", E)
    put("multi_modal_projector.linear.weight", D, E)
    put("multi_modal_projector.linear.bias", D)
    m = "language_model.model."
    put(m + "embed_tokens.weight", V, D)
    for i in range(cfg.num_hidden_layers):
        p = f"{m}layers.{i}."
        put(p + "input_layernorm.weight", D, one=True)
        put(p + "post_attention_layernorm.weight", D, one=True)
        for proj, n in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)):
            put(p + f"self_attn.{proj}.weight", n, D)
            put(p + f"self_attn.{proj}.bias", n)
        put(p + "self_attn.o_proj.weight", D, nq)
        put(p + "mlp.gate_proj.weight", I, D)
        put(p + "mlp.up_proj.weight", I, D)
        put(p + "mlp.down_proj.weight", D, I)
    put(m + "norm.weight", D, one=True)
    put("language_model.lm_head.weight", V, D)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    config = {
        "audio_config": {"d_model": E, "encoder_attention_heads": hp.n_audio_head,
                         "encoder_layers": hp.n_audio_layer, "num_mel_bins": hp.n_mels,
                         "max_source_positions": hp.n_audio_ctx},
        "text_config": {"vocab_size": V, "hidden_size": D, "intermediate_size": I,
                        "num_hidden_layers": cfg.num_hidden_layers,
                        "num_attention_heads": cfg.num_attention_heads,
                        "num_key_value_heads": cfg.num_key_value_heads,
                        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
                        "tie_word_embeddings": False},
        "audio_token_index": cfg.audio_token_id, "tie_word_embeddings": False}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return sum(t.numel() * 2 for t in sd.values()) / 1e9


def run_hf_load(device, workdir: str, hp, cfg) -> dict:
    """io/hf.py::load_qwen2_audio on a random full-width, depth-2 checkpoint
    in HF naming (a torch .bin: the GPU host may lack safetensors), onto the
    card and onto the CPU, in float32, for decoder_quant None, "q8_0" and
    "w8a8": the two loads' trees equal leaf for leaf; the embedding of one
    clip (first load) and an HF_TOKENS-token greedy request on HF_PROMPT
    prompt tokens, card against CPU (the first token equal, the first
    logits within PARITY_ATOL of the largest, q8_0 in the exact mode; w8a8
    within INT8_PARITY_REL); load seconds."""
    import torch
    from qwen2_audio_tpu_torch.audio import mel_filterbank
    from qwen2_audio_tpu_torch.audio.mel import log_mel_spectrogram, mel_input_window
    from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.runtime.decoding import greedy_decode

    path = os.path.join(workdir, "hf_qwen2_audio")
    t0 = time.perf_counter()
    gb = write_hf_checkpoint(path, hp, cfg, device)
    out = {"checkpoint_gb": gb, "write_s": time.perf_counter() - t0}
    log(f"4h hf: wrote a {hp.n_audio_layer} + {cfg.num_hidden_layers}-layer full-width "
        f"checkpoint ({gb:.2f} GB bf16, pytorch_model.bin) in {out['write_s']:.1f} s")
    mel = log_mel_spectrogram(noisy_tone(30.0, seed=51), mel_filterbank(hp.n_mels),
                              device="cpu")
    win = mel_input_window(mel, 0, hp.n_audio_ctx)[None]
    prompt = torch.randint(2, min(1000, cfg.vocab_size), (1, HF_PROMPT),
                           generator=torch.Generator().manual_seed(5))
    for quant in (None, "q8_0", "w8a8"):
        loaded, secs = {}, {}
        for dev in ("card", "cpu"):
            t0 = time.perf_counter()
            # the card by default: no device argument
            kw = {} if dev == "card" else {"device": "cpu"}
            loaded[dev] = load_qwen2_audio(path, dtype=torch.float32,
                                           cache_dtype=torch.float32, decoder_quant=quant, **kw)
            torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        card, cpu = loaded["card"], loaded["cpu"]
        name = quant or "dense"
        require(card["bundle"].device == device and cpu["bundle"].device.type == "cpu",
                f"4h hf {name}: devices")
        tc, tu = _flat(card["bundle"].params), _flat(cpu["bundle"].params)
        require(tc.keys() == tu.keys() and all(
            tc[k].dtype == tu[k].dtype and torch.equal(tc[k].cpu(), tu[k]) for k in tc),
            f"4h hf {name}: the card's tree differs from the CPU's")
        row = {"load_s_card": secs["card"], "load_s_cpu": secs["cpu"],
               "form": sorted(card["bundle"].params["layers"]["qkv"])}
        if quant is None:
            ec = encoder_forward(card["encoder_params"], win.to(device), card["hparams"],
                                 use_flash=True)
            eu = encoder_forward(cpu["encoder_params"], win, cpu["hparams"], use_flash=True)
            err = (ec.cpu() - eu).abs().max().item() / eu.abs().max().item()
            row["embedding_err"] = err
            require(err <= PARITY_ATOL, f"4h hf: embedding card vs CPU {err:.3e}")
        res = {}
        # q8_0 in the exact mode, as phase 3 holds the card to the CPU: the
        # bf16 mode rounds x to bf16 before each product, where a float32
        # difference upstream flips a rounding; w8a8 rounds x to int8 a row,
        # where such a flip moves a row as mode "int8" does (INT8_PARITY_REL)
        tol = INT8_PARITY_REL if quant == "w8a8" else PARITY_ATOL
        set_group_matmul_mode("dequant" if quant == "q8_0" else None)
        try:
            for dev, ld in loaded.items():
                b = ld["bundle"]
                x = b.decoder.embed(prompt.to(b.device))
                res[dev] = greedy_decode(b, x, max_new_tokens=HF_TOKENS)
        finally:
            set_group_matmul_mode(None)
        rc, ru = res["card"], res["cpu"]
        top = float(abs(ru.first_logits).max())
        ferr = float(abs(rc.first_logits - ru.first_logits).max()) / top
        row.update(tokens_equal=rc.tokens == ru.tokens, first_logits_err=ferr, tol=tol)
        if rc.tokens != ru.tokens:
            j = next(i for i, (a, b_) in enumerate(zip(rc.tokens[0], ru.tokens[0])) if a != b_)
            row["first_difference"] = j
        log(f"4h hf {name}: " + json.dumps(row))
        require(ferr <= tol, f"4h hf {name}: first logits card vs CPU {ferr:.3e}")
        require(rc.tokens == ru.tokens or row["first_difference"] > 0,
                f"4h hf {name}: the first token differs between card and CPU")
        out[name] = row
        del loaded, card, cpu, tc, tu
        torch.cuda.empty_cache()
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def run_full_parallel(ctx, seconds: float = 120.0, calls: int = 4) -> dict:
    """capi.whisper_full_parallel on an encoder-only context: a 120 s clip
    in PARALLEL_PROCESSORS chunks through one captured encode at B =
    PARALLEL_PROCESSORS (one launch of each encoder kernel a layer), each
    chunk's embedding against a B = 1 encode of that chunk (cosine at least
    PARALLEL_COS_MIN); the median ms per call and per chunk."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio.mel import mel_input_window
    clip = noisy_tone(seconds, seed=52)
    params = _text_params(1)
    n = PARALLEL_PROCESSORS
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    require(capi.whisper_full_parallel(ctx, params, clip, n_processors=n) == 0,
            "4h full_parallel: non-zero return")
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    L = ctx.hparams.n_audio_layer
    require(launches.get("attention_single") == L and launches.get("mel_log_frames") == n,
            f"4h full_parallel: launches {launches}")
    emb = ctx.state.embd_enc.clone()
    n_ctx = ctx.hparams.n_audio_ctx // 2
    require(tuple(emb.shape) == (n * n_ctx, ctx.hparams.n_audio_state),
            f"4h full_parallel: embedding shape {tuple(emb.shape)}")
    cos = []
    for i, chunk in enumerate(np.array_split(clip, n)):
        st = ctx.init_state()
        ctx.pcm_to_mel_with_state(st, chunk)
        one = ctx.encoder(mel_input_window(st.mel, 0, ctx.hparams.n_audio_ctx)[None])[0]
        cos.append(_cosine(one, emb[i * n_ctx:(i + 1) * n_ctx]))
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        capi.whisper_full_parallel(ctx, params, clip, n_processors=n)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"cos": cos, "ms_per_call": statistics.median(ms[1:]),
           "ms_per_chunk": statistics.median(ms[1:]) / n, "calls_ms": ms,
           "launches": launches}
    log(f"4h full_parallel: {json.dumps(out)}")
    require(min(cos) >= PARALLEL_COS_MIN, f"4h full_parallel: chunk cosine {min(cos):.6f}")
    return out


def _causal_bf16(kernel_name: str) -> bool:
    """Whether a profiled kernel is attn_wgmma_kernel<D, CAUSAL, OPTS> with
    CAUSAL true."""
    _, found, rest = kernel_name.partition("attn_wgmma_kernel<")
    args = rest.split(">", 1)[0].split(",")
    return bool(found) and len(args) > 1 and args[1].strip() == "true"


def profile_call(fn, what: str) -> dict | None:
    """One call under torch.profiler: device time by kernel group and the
    device's busy share of the call's wall time (None where the profiler
    reports no device time). Every caller has run the same path just
    before, so the call finds its kernels built and its memory warm."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        group = ("quant_matmul_int8" if "qmm8_" in name or "quantize_q8_1" in name
                 else "attention_causal" if "attn_f32_causal" in name
                 or _causal_bf16(name)
                 else "attention_single" if "attn_" in name
                 else "flash_decode" if "decode_kernel" in name
                 else "kv_append_quant" if "kv_append_quant" in name
                 else "mel_log_frames" if "mel_log_frames" in name
                 else "quant_matmul" if "qmm_" in name
                 else "fused_mlp" if "swiglu_" in name
                 else "split sums (quant_matmul, fused_mlp)" if "reduce_partials" in name
                 else "matmul" if any(w in name for w in ("gemm", "nvjet", "cutlass", "sm90"))
                 else "memcpy" if "memcpy" in name
                 else "other (norm, gelu, add, copy, reduce)")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    if busy == 0:
        log("profile: the profiler reported no device time (not measured)")
        return None
    log(f"profile: one {what} call, wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), by group "
        + json.dumps({k: round(v, 4) for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1])}))
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "groups": groups}


# --------------------------------------------------------------------------- #
# phase 4j: the command line on the card
# --------------------------------------------------------------------------- #

CLI_OUTPUTS = ("-otxt", "-osrt", "-ovtt", "-oj", "-ocsv", "-olrc")
CLI_EXTS = ("txt", "srt", "vtt", "json", "csv", "lrc")
CLI_BENCH_SIZES = (512, 1024, 2048)   # the mul_mat bench's N x N x N products
CLI_PATH = ("mel_log_frames", "attention_single", "attention_causal", "flash_decode")
CLI_BENCH_KERNELS = ("quant_matmul", "quant_matmul4", "quant_matmul_int8")


def run_cli(workdir: str, model_path: str, hf_dir: str) -> dict:
    """Phase 4j, the port's command line (qwen2_audio_tpu_torch.cli) on the
    card: ``cli.main.run`` in this process on a 30 s wav with the cut ggml
    checkpoint (CUT_LAYERS deep) and the full-width depth-2 HF checkpoint of 4h as
    ``--decoder``, two whisper_full passes (``--bench-iters 2``), greedy
    without the temperature fallback (``-nf``: a fallback samples) and the
    six output files; the launches of the mel, encoder attention, causal
    prefill and decode kernels over the run, each at least 1; the run held to
    capi.whisper_full on a context built the same way with the same
    ``build_full_params(args)`` (the embedding bit-equal, the tokens and
    segments and every output file equal); ``python -m
    qwen2_audio_tpu_torch.cli -np`` once in a subprocess (exit 0, the same
    txt); then capi.whisper_bench_ggml_mul_mat_str at CLI_BENCH_SIZES, each
    kernel product held to its plain version with phase 2's limits before
    it is timed, and the launches of the dequantizing (int8 values and
    packed nibbles) and exact-integer kernels over the bench."""
    import contextlib
    import io
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio import read_audio, write_wav
    from qwen2_audio_tpu_torch.cli import main as cli_main
    from qwen2_audio_tpu_torch.cli.output_formats import write_outputs
    from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
    from qwen2_audio_tpu_torch.runtime.context import ContextParams

    t_phase = time.perf_counter()
    d = os.path.join(workdir, "cli")
    os.makedirs(os.path.join(d, "ref"))
    wav = os.path.join(d, "clip.wav")
    write_wav(wav, noisy_tone(30.0, seed=70, freq=350.0))
    argv = ["-m", model_path, "-f", wav, "--decoder", hf_dir, "--bench-iters", "2", "-nf",
            *CLI_OUTPUTS]
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc, ctx = cli_main.run(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {k: counters[k].launches for k in CLI_PATH}
    printed = out.getvalue().splitlines()
    log(f"4j cli: rc {rc} in {cli_s:.2f} s; stdout {len(printed)} lines: "
        + " | ".join(ln[:120] for ln in printed[:4]) + f"; launches {json.dumps(launches)}")
    require(rc == 0 and ctx is not None, f"4j: the CLI returned {rc}")
    require(ctx.device.type == "cuda", f"4j: the CLI ran on {ctx.device}")
    for k in CLI_PATH:
        require(launches[k] >= 1, f"4j: {k} was not launched by the CLI run: {launches}")
    elapsed = [float(ln.split()[3]) for ln in printed if ln.startswith("Elapsed time is")]
    require(len(elapsed) == 1, "4j: the CLI printed no elapsed time")
    ms_per_call = elapsed[0] * 1e3 / 2
    tokens = list(ctx.state.result_tokens)

    # the same context and request through capi
    args = cli_main.build_parser().parse_args(cli_main.expand_response_files(argv))
    ref = capi.whisper_init_from_file_with_params(
        model_path, ContextParams(use_gpu=True, flash_attn=args.flash_attn))
    ref.decoder = load_qwen2_audio(hf_dir)["bundle"]
    samples, _ = read_audio(wav)
    params = cli_main.build_full_params(args)
    for _ in range(args.bench_iters):
        require(capi.whisper_full(ref, params, samples) == 0, "4j: capi.whisper_full failed")
    require(torch.equal(ctx.state.embd_enc, ref.state.embd_enc),
            "4j: the CLI's embedding differs from capi.whisper_full's")
    require(tokens == ref.state.result_tokens and len(tokens) > 0,
            f"4j: the CLI's tokens differ from capi.whisper_full's: {tokens[:16]} against "
            f"{ref.state.result_tokens[:16]}")
    def key(segs):
        return [(s["t0"], s["t1"], s["text"], list(s["tokens"])) for s in segs]
    require(key(ctx.state.segments) == key(ref.state.segments),
            "4j: the CLI's segments differ from capi.whisper_full's")
    ref_paths = write_outputs(os.path.join(d, "ref", "clip.wav"), ref.state.segments, args)
    require(sorted(p.rsplit(".", 1)[1] for p in ref_paths) == sorted(CLI_EXTS),
            f"4j: the reference wrote {ref_paths}")
    for rp in ref_paths:
        ext = rp.rsplit(".", 1)[1]
        with open(os.path.join(d, "clip." + ext), "rb") as f, open(rp, "rb") as g:
            got, want = f.read(), g.read()
        require(got == want and len(got) > 0,
                f"4j: the CLI's .{ext} file differs from capi.whisper_full's")
    fp = ref.print_emb_enc()
    log(f"4j cli: embedding bit-equal to capi.whisper_full's ({tuple(ref.state.embd_enc.shape)},"
        f" fingerprint {fp.strip()[:60]}...), {len(tokens)} tokens, "
        f"{len(ref.state.segments)} segment(s), six files equal")
    capi.whisper_free(ctx)
    capi.whisper_free(ref)
    del ctx, ref
    torch.cuda.empty_cache()

    # the command line as a user starts it
    d2 = os.path.join(d, "sub")
    os.makedirs(d2)
    wav2 = os.path.join(d2, "clip.wav")
    write_wav(wav2, noisy_tone(30.0, seed=70, freq=350.0))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "qwen2_audio_tpu_torch.cli", "-m", model_path,
                        "-f", wav2, "--decoder", hf_dir, "--bench-iters", "1", "-nf", "-otxt",
                        "-np"], cwd=root, capture_output=True, text=True, timeout=SUBPROCESS_S)
    sub_s = time.perf_counter() - t0
    log(f"4j cli subprocess: rc {r.returncode} in {sub_s:.1f} s; stderr tail "
        f"{r.stderr[-300:]!r}")
    require(r.returncode == 0, f"4j: python -m qwen2_audio_tpu_torch.cli exited {r.returncode}")
    with open(os.path.join(d2, "clip.txt"), "rb") as f:
        sub_txt = f.read()
    with open(os.path.join(d, "clip.txt"), "rb") as f:
        require(sub_txt == f.read(), "4j: the subprocess's txt differs from the in-process run's")

    # the mul_mat bench through capi, each product held to its plain version
    held = []

    def check(case, got, want):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max().item()
        atol, rtol = QMM_TOL_BF16[0] * top, QMM_TOL_BF16[1]
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        n = case["x"].shape[0]
        held.append({"size": n, "type": case["type"], "kernel": case["kernel"],
                     "max_abs_err": diff.max().item(), "used": used})
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"4j bench {case['type']} N={n}: shape or type")
        require(bool(torch.isfinite(got).all()), f"4j bench {case['type']} N={n}: not finite")
        require(used <= 1.0, f"4j bench {case['type']} N={n}: {case['kernel']} disagrees with "
                f"its plain version ({used:.3f} of the tolerance)")

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    text = capi.whisper_bench_ggml_mul_mat_str(sizes=CLI_BENCH_SIZES, check=check)
    bench_s = time.perf_counter() - t0
    bench_launches = {k: counters[k].launches for k in CLI_BENCH_KERNELS}
    for h in held:
        log(f"4j bench check: N={h['size']} {h['type']} ({h['kernel']}): max_abs_err "
            f"{h['max_abs_err']:.3e}, {h['used']:.3f} of the tolerance")
    for ln in text.splitlines():
        log(f"4j bench: {ln.strip()}")
    log(f"4j bench: {bench_s:.1f} s, launches {json.dumps(bench_launches)}")
    for k in CLI_BENCH_KERNELS:
        require(bench_launches[k] >= 1, f"4j: {k} was not launched by the bench: {bench_launches}")
    gflops = {}   # format: {N: GFLOPS}
    for ln in text.splitlines():
        left, right = ln.split(":")
        fmt, val = right.split()[:2]
        gflops.setdefault(fmt, {})[int(left.split("x")[0])] = float(val)
    seconds = time.perf_counter() - t_phase
    log(f"4j: {seconds:.1f} s in all (CLI {cli_s:.1f}, subprocess {sub_s:.1f}, bench "
        f"{bench_s:.1f})")
    return {"launches": launches, "bench_launches": bench_launches, "cli_s": cli_s,
            "ms_per_call": ms_per_call, "tokens": len(tokens), "subprocess_s": sub_s,
            "bench_s": bench_s, "gflops": gflops, "seconds": seconds}


# --------------------------------------------------------------------------- #
# phase 4k: remote offload, the C API shim and the debug utilities on the card
# --------------------------------------------------------------------------- #

SURFACE_PATH = ("mel_log_frames", "attention_single")
SURFACE_CALLS = 2          # full() passes of each client and of the shim's program
SERVER_START_S = 180.0     # seconds the RPC server may take to accept a connection
INSPECT_LAYERS = 4         # depth of the card-against-CPU per-node diff (full width)
# compare_runs' limits for that diff: float32 on both sides, the card's
# attention kernel and cuBLAS against the CPU's plain attention and matmuls
# (the order of the float32 sums differs); phase 3's 2-layer encoder parity
# bound, and a relative part for the residual stream's growth with depth
INSPECT_ATOL = PARITY_ATOL
INSPECT_RTOL = 1e-3
TRACE_KERNELS = ("mel_log_frames_kernel", "attn_f32_kernel")
TRACE_CALLS = 2            # whisper_full calls inside the profiler trace


def _fingerprints(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith(" ")]


def _connect_when_up(port: int, proc) -> tuple:
    """A RemoteWhisperContext on the server at ``port`` once it accepts
    connections, and the seconds that took."""
    from qwen2_audio_tpu_torch.runtime.rpc import RemoteWhisperContext
    t0 = time.perf_counter()
    while True:
        try:
            return RemoteWhisperContext.connect(f"127.0.0.1:{port}", timeout_s=10), \
                time.perf_counter() - t0
        except OSError:
            require(proc.poll() is None,
                    f"4k: the RPC server exited with {proc.returncode} before accepting")
            require(time.perf_counter() - t0 < SERVER_START_S,
                    f"4k: the RPC server did not accept within {SERVER_START_S:.0f} s")
            time.sleep(0.2)


def run_surface(workdir: str, model_path: str, hp) -> dict:
    """Phase 4k, the rest of the port's surface on the card, on the cut
    checkpoint (``model_path``, F16, CUT_LAYERS deep) and one 30 s clip (a wav, so
    every client reads the same 16-bit samples), in float32 compute, as the
    command line and the RPC server default to: a local capi.whisper_full
    on the card as the reference; ``python -m
    qwen2_audio_tpu_torch.runtime.rpc`` as a process of its own, which a
    RemoteWhisperContext connects to (backend "cuda"), loads the checkpoint
    into and runs full() SURFACE_CALLS times (the embedding and the
    fingerprint bit-equal to the reference), then native/qa_rpc (built
    through the port's native.build) and ``python -m
    qwen2_audio_tpu_torch.cli --rpc`` against it (their fingerprint lines
    the reference's), then CMD_SHUTDOWN (the server exits 0); the port's C
    API shim built (native.build_capi) and its command line run on the card
    (SURFACE_CALLS equal fingerprint lines, the reference's);
    utils.inspect_graph.encoder_intermediates on the card against the CPU at
    full width, INSPECT_LAYERS deep, T = 1500 (no node diverges at
    INSPECT_ATOL / INSPECT_RTOL); utils.profiling.trace around TRACE_CALLS
    local whisper_full calls (the trace names the mel and the attention
    kernels). The
    launches of the mel and encoder attention kernels in this process over
    the phase, each at least 1 (the server's, in its own process, are shown
    by its embedding being the kernels' bits)."""
    import contextlib
    import dataclasses
    import io
    import socket

    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi, native
    from qwen2_audio_tpu_torch.audio import read_wav, write_wav
    from qwen2_audio_tpu_torch.models.encoder import fingerprint, random_encoder_params
    from qwen2_audio_tpu_torch.runtime.context import ContextParams
    from qwen2_audio_tpu_torch.utils import profiling
    from qwen2_audio_tpu_torch.utils.inspect_graph import (compare_runs, encoder_intermediates,
                                                           first_divergence)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(workdir, "surface")
    os.makedirs(d)
    wav = os.path.join(d, "clip.wav")
    write_wav(wav, noisy_tone(30.0, seed=80, freq=410.0))
    samples, _ = read_wav(wav)
    params = capi.whisper_full_default_params()
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    steps = {}

    # the reference: a local context on the card
    t0 = time.perf_counter()
    ref = capi.whisper_init_from_file_with_params(model_path, ContextParams(use_gpu=True))
    require(ref.device.type == "cuda", f"4k: the reference ran on {ref.device}")
    require(capi.whisper_full(ref, params, samples) == 0, "4k: capi.whisper_full failed")
    ref_emb = ref.state.embd_enc.cpu().numpy()
    ref_fp = fingerprint(ref.state.embd_enc)
    require(ref_emb.shape == (hp.n_audio_ctx // 2, hp.n_audio_state)
            and bool(np.isfinite(ref_emb).all()), "4k: the reference embedding")
    steps["reference_s"] = time.perf_counter() - t0

    # the RPC server as its own process, and three clients
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server_log = open(os.path.join(d, "server.log"), "w")
    server = subprocess.Popen(
        [sys.executable, "-m", "qwen2_audio_tpu_torch.runtime.rpc", "--host", "127.0.0.1",
         "--port", str(port)], cwd=root, stdout=server_log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        cli, up_s = _connect_when_up(port, server)
        steps["server_up_s"] = up_s
        require(cli.server_backend == "cuda",
                f"4k: the RPC server reports backend {cli.server_backend!r}")
        cli.load_model_file(model_path)
        remote_ms = []
        for _ in range(SURFACE_CALLS):
            t1 = time.perf_counter()
            require(cli.full(params, samples) == 0, "4k: the remote full() failed")
            remote_ms.append((time.perf_counter() - t1) * 1e3)
        emb = cli.get_emb_enc()
        with contextlib.redirect_stdout(io.StringIO()):
            fp = cli.print_emb_enc()
        cli.close()
        require(emb.dtype == np.float32 and np.array_equal(emb, ref_emb),
                "4k: the RPC server's embedding differs from capi.whisper_full's "
                f"(max_abs {float(np.abs(emb - ref_emb).max()):.3e})")
        require(fp == ref_fp, "4k: the RPC server's fingerprint differs")
        steps["rpc_client_s"] = time.perf_counter() - t0
        log(f"4k rpc: server up in {up_s:.1f} s on {cli.server_devices}; full() "
            f"{json.dumps([round(v, 1) for v in remote_ms])} ms (host clock, the "
            f"{os.path.getsize(model_path) / 1e9:.2f} GB "
            "model sent once before); embedding bit-equal to capi.whisper_full's")

        t0 = time.perf_counter()
        native.build()
        qa_rpc = native._BUILD_DIR / "qa_rpc"
        r = subprocess.run([str(qa_rpc), f"127.0.0.1:{port}", model_path, wav],
                           capture_output=True, text=True, timeout=SUBPROCESS_S)
        require(r.returncode == 0, f"4k: native/qa_rpc exited {r.returncode}: {r.stderr[-500:]}")
        require(r.stdout.strip() == ref_fp.strip(),
                f"4k: native/qa_rpc's fingerprint {r.stdout.strip()[:60]!r} differs")
        steps["qa_rpc_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "qwen2_audio_tpu_torch.cli", "-m", model_path,
                            "-f", wav, "--rpc", f"127.0.0.1:{port}", "-np", "--bench-iters",
                            str(SURFACE_CALLS)], cwd=root, capture_output=True, text=True,
                           timeout=SUBPROCESS_S)
        require(r.returncode == 0, f"4k: the CLI with --rpc exited {r.returncode}: "
                f"{r.stderr[-500:]}")
        require(_fingerprints(r.stdout) == [ref_fp] * SURFACE_CALLS,
                f"4k: the CLI's --rpc fingerprint lines differ: {r.stdout[:300]!r}")
        steps["cli_rpc_s"] = time.perf_counter() - t0

        from qwen2_audio_tpu_torch.runtime.rpc import RemoteWhisperContext
        RemoteWhisperContext.connect(f"127.0.0.1:{port}").close(shutdown_server=True)
        server_rc = server.wait(timeout=60)
        require(server_rc == 0, f"4k: the RPC server exited {server_rc} after CMD_SHUTDOWN")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        server_log.close()
    log(f"4k rpc: qa_rpc and the CLI --rpc printed the reference fingerprint; the server "
        f"exited 0 on CMD_SHUTDOWN ({json.dumps({k: round(v, 1) for k, v in steps.items()})})")

    # the port's C API shim on the card
    t0 = time.perf_counter()
    _, program = native.build_capi()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in sys.path if p]))
    r = subprocess.run([str(program), model_path, wav, str(SURFACE_CALLS)], cwd=root, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_S)
    require(r.returncode == 0, f"4k: the shim's program exited {r.returncode}: {r.stderr[-800:]}")
    require("asked for the card; context on cuda:0)" in r.stderr,
            "4k: the shim's context is not on the card (its str(ctx.device) is not cuda:0): "
            f"{r.stderr[-300:]!r}")
    require(_fingerprints(r.stdout) == [ref_fp] * SURFACE_CALLS,
            f"4k: the shim's fingerprint lines differ: {r.stdout[:300]!r}")
    steps["shim_s"] = time.perf_counter() - t0
    log(f"4k shim: {program.name} printed {SURFACE_CALLS} reference fingerprint lines in "
        f"{steps['shim_s']:.1f} s; "
        + " | ".join(ln.strip() for ln in r.stdout.splitlines() if ln.startswith("Elapsed")))

    # per-node diff of the encoder, the card against the CPU
    t0 = time.perf_counter()
    ihp = dataclasses.replace(hp, n_audio_layer=INSPECT_LAYERS)
    cpu_params = random_encoder_params(np.random.default_rng(81), ihp)
    card_params = _tree_to(cpu_params, ref.device)
    mel = np.random.default_rng(82).standard_normal(
        (1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32)
    before = counters["attention_single"].launches
    card = encoder_intermediates(card_params, torch.from_numpy(mel).to(ref.device), ihp,
                                 gelu_approximate=True)
    require(counters["attention_single"].launches - before == INSPECT_LAYERS,
            "4k: the card's intermediates did not launch the attention kernel per layer")
    cpu = encoder_intermediates(cpu_params, torch.from_numpy(mel), ihp, gelu_approximate=True)
    report = compare_runs(cpu, card, rtol=INSPECT_RTOL, atol=INSPECT_ATOL)
    worst = max(report, key=lambda r: r["max_abs"])
    div = first_divergence(report)
    steps["inspect_s"] = time.perf_counter() - t0
    log(f"4k inspect: {len(report)} nodes, {INSPECT_LAYERS} layers at T = "
        f"{hp.n_audio_ctx} ({2 * hp.n_audio_ctx} mel frames); worst {worst['node']} max_abs {worst['max_abs']:.3e} "
        f"(max_rel {worst['max_rel']:.3e}); first divergence {div} at atol {INSPECT_ATOL}, "
        f"rtol {INSPECT_RTOL}; ln_post max_abs {report[-1]['max_abs']:.3e}")
    require(div is None, f"4k: the card's encoder diverges from the CPU's at {div}")
    del card_params

    # the torch.profiler trace of TRACE_CALLS whisper_full calls: every
    # kernel event by name, beside the launches the wrappers counted (a
    # session has lost its first kernel events on this card, the first
    # call's mel kernel among them, so each kernel must show at least once)
    t0 = time.perf_counter()
    trace_dir = os.path.join(d, "trace")
    before = {k: counters[k].launches for k in SURFACE_PATH}
    with profiling.trace(trace_dir):
        for _ in range(TRACE_CALLS):
            with profiling.annotate("qa_whisper_full"):
                require(capi.whisper_full(ref, params, samples) == 0,
                        "4k: traced whisper_full")
    traced = {k: counters[k].launches - before[k] for k in SURFACE_PATH}
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name") or "" for e in events
               if (e.get("cat") or "").lower() == "kernel"]
    found = {k: sum(k in n for n in kernels) for k in TRACE_KERNELS}
    spans = sum(e.get("name") == "qa_whisper_full" and e.get("cat") == "user_annotation"
                for e in events)
    steps["trace_s"] = time.perf_counter() - t0
    log(f"4k trace: {len(events)} events, {len(kernels)} kernel events, {spans} annotated "
        f"spans; kernel events by name {json.dumps(found)}; launches counted "
        f"{json.dumps(traced)}")
    for k, n in found.items():
        require(n >= 1, f"4k: the trace names no {k}")
    require(spans == TRACE_CALLS, "4k: the trace lost an annotated span")
    require(np.array_equal(ref.state.embd_enc.cpu().numpy(), ref_emb),
            "4k: the traced whisper_full changed the embedding")

    launches = {k: counters[k].launches for k in SURFACE_PATH}
    for k in SURFACE_PATH:
        require(launches[k] >= 1, f"4k: {k} was not launched in the phase: {launches}")
    capi.whisper_free(ref)
    del ref
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"4k: {seconds:.1f} s in all; launches in this process {json.dumps(launches)}")
    return {"launches": launches, "steps": steps, "remote_ms": remote_ms,
            "inspect_worst": {k: worst[k] for k in ("node", "max_abs", "max_rel")},
            "seconds": seconds}


# --------------------------------------------------------------------------- #
# phase 4i: tensor parallelism on one card (gloo ranks), and the training step
# --------------------------------------------------------------------------- #

TP_LAYERS = 2          # depth of phase 4i's full-width decoder
TP_PREFILL = 752       # prefill positions, then TP_STEPS teacher-forced decode steps
TP_STEPS = 8
TP_CAPACITY = 1024     # cache capacity of the TP decode and of the pools
# TP against one process on the same weights (the logits of the prefill's
# last position and of every step): the ranks' partial products of o and
# down are summed in another order, and in bf16 each sum rounds once more,
# which moves a logit by a few bf16 ulps of the residual stream; a shard
# cut wrongly or a missing reduce moves every logit by O(max) (cos near 0)
TP_COS_MIN = 0.999
TP_REL = 0.03          # max|TP - single| / max|single|
TP_CASES = {           # tp -> (weights, group matmul mode, KV cache) of each run
    2: (("bf16", None, "bf16"), ("bf16", None, "q8"), ("q8_0", None, "bf16"),
        ("q4_0", None, "bf16"), ("q8_0", "int8", "bf16")),
    4: (("bf16", None, "bf16"), ("q8_0", None, "q8")),
}
# the pools' 8 slots at ragged positions, float32 activations and cache and
# the exact dequantizing mode, so that the streams must equal one process's
# token for token (in the bf16 mode x rounds to bf16 in the kernels, and one
# slot's greedy token flipped at a near tie against the other order of the
# ranks' sums, on the H100)
TP_POOL_PREFILLS = (40, 57, 73, 88, 96, 111, 120, 137)
TP_POOL_CHUNK = 8
TP_POOL_HIST = 64
TP_ENC_LAYERS = 4      # depth of the sharded encoder (tp = 2)
TP_TIMEOUT = 240.0     # seconds a world may take, start-up included
TRAIN_STEPS = 3
TRAIN_TOKENS = 32
TRAIN_LR = 1e-4
TRAIN_PEAK_GIB = 70.0  # the encoder's depth is cut only past this peak


def tp_tree(cfg, fmt: str, device, dtype=None, seed: int = 40) -> dict:
    """Phase 4i's decoder of one seed on ``device``: dense bf16 or random
    q8_0 / q4_0 blocks, unfused (the TP schema)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (random_decoder_params,
                                                            random_quant_decoder_params)
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device).manual_seed(seed)
    if fmt == "bf16":
        return random_decoder_params(gen, cfg, dtype=dtype)
    return random_quant_decoder_params(gen, cfg, fmt, dtype=dtype)


def tp_prefill_input(cfg, params, device, T: int, seed: int):
    import torch
    gen = torch.Generator(device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=device)
    return params["embed"][toks]


def _cache_dtype(kind: str):
    import torch
    return "q8" if kind == "q8" else torch.bfloat16


def tp_single(cfg, case, device) -> dict:
    """One process's prefill and TP_STEPS greedy steps on a case's weights:
    the logits rows (TP_STEPS + 1, V) on the host and the greedy tokens
    (which the ranks are then fed)."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    fmt, mode, kind = case
    params = tp_tree(cfg, fmt, device)
    set_group_matmul_mode(mode)
    try:
        cache = create_cache(cfg, 1, TP_CAPACITY, dtype=_cache_dtype(kind), device=device)
        lg, _ = decoder_forward(params, cfg, tp_prefill_input(cfg, params, device, TP_PREFILL,
                                                              41),
                                cache, 0, block_only=True, logits_last_only=True)
        rows, toks = [lg[0, -1]], []
        for i in range(TP_STEPS):
            toks.append(int(rows[-1].argmax()))
            lg, _ = decoder_forward(params, cfg, params["embed"][toks[-1]].view(1, 1, -1),
                                    cache, TP_PREFILL + i)
            rows.append(lg[0, -1])
    finally:
        set_group_matmul_mode(None)
    return {"logits": torch.stack(rows).float().cpu(), "tokens": toks}


def tp_pool(params, cfg, device, mesh=None) -> list:
    """Eight slots prefilled at ragged positions, then one plain chunk and
    one speculative chunk (K = SPEC_K) of TP_POOL_CHUNK tokens, in the exact
    dequantizing mode: each slot's stream. Through the TP functions with
    ``mesh``."""
    import torch
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    set_group_matmul_mode("dequant")
    try:
        return _tp_pool(params, cfg, device, mesh)
    finally:
        set_group_matmul_mode(None)


def _tp_pool(params, cfg, device, mesh) -> list:
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache
    from qwen2_audio_tpu_torch.parallel import tp as tpm
    from qwen2_audio_tpu_torch.parallel.mesh import mesh_shape
    from qwen2_audio_tpu_torch.runtime import generate as g
    B = len(TP_POOL_PREFILLS)
    lcfg = cfg if mesh is None else tpm.tp_local_cfg(cfg, mesh_shape(mesh)["tp"])
    cache = create_cache(lcfg, B, TP_CAPACITY, dtype=torch.float32, device=device)
    pos = torch.zeros(B, dtype=torch.int32, device=device)
    logits = torch.zeros(B, cfg.vocab_size, device=device)
    active = torch.zeros(B, dtype=torch.bool, device=device)
    for s, T0 in enumerate(TP_POOL_PREFILLS):
        pre = tp_prefill_input(cfg, params, device, T0, 60 + s)
        if mesh is None:
            g.prefill_slot(params, cfg, cache, pos, logits, active, s, pre)
        else:
            tpm.tp_prefill_slot(params, cfg, mesh, cache, pos, logits, active, s, pre)
    kw = dict(chunk=TP_POOL_CHUNK, eos_token_id=-1)
    args = (cache, pos, logits, active)
    toks = (g.decode_chunk_slots(params, cfg, *args, **kw) if mesh is None else
            tpm.tp_decode_chunk_slots(params, cfg, mesh, *args, **kw))[4].cpu()
    streams = [toks[b].tolist() for b in range(B)]
    hist = torch.zeros(B, TP_POOL_HIST, dtype=torch.int32, device=device)
    hlen = torch.zeros(B, dtype=torch.int32, device=device)
    args = (cache, pos, logits, active, hist, hlen)
    out = (g.decode_chunk_slots_spec(params, cfg, *args, spec_k=SPEC_K, **kw) if mesh is None
           else tpm.tp_decode_chunk_slots_spec(params, cfg, mesh, *args, spec_k=SPEC_K, **kw))
    toks, n_new = out[6].cpu(), out[8].cpu()
    for b in range(B):
        streams[b] += toks[b, :int(n_new[b])].tolist()
    return streams


def tp_encoder(hp, device):
    """(phase 4i's encoder params, a 30 s random mel) on ``device``."""
    import torch
    from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
    gen = torch.Generator(device).manual_seed(43)
    mel = torch.randn((1, hp.n_mels, 2 * hp.n_audio_ctx), generator=gen, device=device)
    return random_encoder_params(gen, hp), mel


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def tp_rank(rank: int, world: int, cfg_kw: dict, hp_kw: dict, cases: tuple,
            tokens: list) -> dict:
    """One rank of a phase 4i world (tp = world): each case's prefill and
    teacher-forced steps, the pools, and (tp = 2) the encoder, on this
    rank's shard, its launch counts set to 0 just before each run and read
    just after."""
    import hashlib

    import torch
    from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig, WhisperHParams
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.parallel import tp as tpm
    from qwen2_audio_tpu_torch.parallel.mesh import (encoder_param_spec, local_cache,
                                                     make_mesh, shard_params, tp_group)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_mesh(1, world)
    cfg = Qwen2DecoderConfig(**cfg_kw)
    counters = _launch_counters()

    def zero():
        for w in counters.values():
            w.launches = 0

    def read():
        return {k: w.launches for k, w in counters.items() if w.launches}

    def shard(full):
        sp = tpm.shard_decoder_for_tp(full, mesh)
        tpm.clear_shard_memo()           # the full tree goes with the caller's reference
        return sp

    out = {"cases": []}
    for case, toks in zip(cases, tokens):
        fmt, mode, kind = case
        full = tp_tree(cfg, fmt, device)
        x = tp_prefill_input(cfg, full, device, TP_PREFILL, 41)
        sp = shard(full)
        del full
        if device.type == "cuda":
            torch.cuda.empty_cache()
        cache = local_cache(cfg, 1, TP_CAPACITY, mesh, dtype=_cache_dtype(kind), device=device)
        set_group_matmul_mode(mode)
        try:
            _sync(device)
            zero()
            t0 = time.perf_counter()
            lg, _ = tpm.tp_decoder_forward(sp, cfg, mesh, x, cache, 0, block_only=True,
                                           logits_last_only=True)
            _sync(device)
            t1 = time.perf_counter()
            rows = [lg[0, -1]]
            for i, t in enumerate(toks):
                lg, _ = tpm.tp_decoder_forward(sp, cfg, mesh, sp["embed"][t].view(1, 1, -1),
                                               cache, TP_PREFILL + i)
                rows.append(lg[0, -1])
            _sync(device)
            t2 = time.perf_counter()
            launches = read()
        finally:
            set_group_matmul_mode(None)
        L = torch.stack(rows).float().cpu().numpy()
        out["cases"].append({"logits": L if rank == 0 else None,
                             "sha": hashlib.sha256(L.tobytes()).hexdigest(),
                             "tokens": L.argmax(-1).tolist(), "launches": launches,
                             "prefill_ms": (t1 - t0) * 1e3,
                             "decode_ms_per_step": (t2 - t1) * 1e3 / len(toks)})
        del sp, cache, x

    full = tp_tree(cfg, "q8_0", device, dtype=torch.float32, seed=44)
    sp = shard(full)
    del full
    _sync(device)
    zero()
    t0 = time.perf_counter()
    out["pool"] = {"streams": tp_pool(sp, cfg, device, mesh)}
    _sync(device)
    out["pool"].update(launches=read(), seconds=time.perf_counter() - t0)
    del sp

    if hp_kw is not None:
        hp = WhisperHParams(**hp_kw)
        params, mel = tp_encoder(hp, device)
        local = shard_params(params, encoder_param_spec(params), mesh)
        del params
        _sync(device)
        zero()
        t0 = time.perf_counter()
        enc = encoder_forward(local, mel, hp, use_flash=True, compute_dtype=torch.bfloat16,
                              tp_group=tp_group(mesh))
        _sync(device)
        out["encoder"] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": read(),
                          "out": enc.float().cpu().numpy() if rank == 0 else None,
                          "sha": hashlib.sha256(enc.float().cpu().numpy().tobytes()).hexdigest()}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _tp_held(tp_rows, single_rows) -> tuple[float, float, float]:
    """(max|delta|, cos, max|delta| / max|single|) of two logits arrays."""
    import numpy as np
    a, b = np.asarray(tp_rows, np.float64), np.asarray(single_rows, np.float64)
    d = float(np.abs(a - b).max())
    cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    return d, cos, d / float(np.abs(b).max())


def run_tp(device, cfg, hp) -> dict:
    """Phase 4i, tensor parallelism: for tp = 2 and then 4, gloo ranks
    spawned on the one card (parallel/launch.py), after one process's
    results on the same weights (made on the card from one seed, in every
    rank too, each rank keeping its shard). Each case: a TP_PREFILL-position
    prefill and TP_STEPS teacher-forced decode steps of the full-width
    decoder at depth TP_LAYERS (bf16 and q8_0, the int8 cache; q4_0 and
    mode "int8" at tp = 2), logits held to TP_COS_MIN and TP_REL, every
    rank's logits bit-equal and so its tokens; the q8_0 pools (8 slots,
    plain and speculative, float32) the single process's streams; at tp = 2
    the encoder of ``hp`` at depth TP_ENC_LAYERS. The ranks share one
    card: no time here is a multi-card figure."""
    import dataclasses

    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward
    from qwen2_audio_tpu_torch.parallel.launch import spawn_world
    t_phase = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ehp = dataclasses.replace(hp, n_audio_layer=TP_ENC_LAYERS)
    single = {case: tp_single(cfg, case, device) for cases in TP_CASES.values()
              for case in cases}
    params = tp_tree(cfg, "q8_0", device, dtype=torch.float32, seed=44)
    pool_want = tp_pool(params, cfg, device)
    del params
    params, mel = tp_encoder(ehp, device)
    enc_want = encoder_forward(params, mel, ehp, use_flash=True,
                               compute_dtype=torch.bfloat16).float().cpu().numpy()
    del params, mel
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_single = time.perf_counter() - t_phase
    out = {"single_s": t_single, "worlds": {}}
    for tp, cases in TP_CASES.items():
        t0 = time.perf_counter()
        ranks = spawn_world(tp_rank, tp, backend="gloo", timeout=TP_TIMEOUT,
                            args=(dataclasses.asdict(cfg),
                                  dataclasses.asdict(ehp) if tp == 2 else None, cases,
                                  [single[c]["tokens"] for c in cases]))
        world = {"seconds": time.perf_counter() - t0, "cases": {}, "launches": {}}
        for i, case in enumerate(cases):
            name = "/".join(c or "bf16 mode" for c in case)
            got = [r["cases"][i] for r in ranks]
            require(len({g["sha"] for g in got}) == 1,
                    f"phase 4i tp={tp} {name}: the ranks' logits differ")
            want = single[case]
            d, cos, rel = _tp_held(got[0]["logits"], want["logits"].numpy())
            same = sum(a == b for a, b in zip(got[0]["tokens"][:-1], want["tokens"]))
            log(f"tp {tp} {name}: max|d| {d:.4g}, cos {cos:.7f}, rel {rel:.4g} (limits cos >= "
                f"{TP_COS_MIN}, rel <= {TP_REL}); greedy tokens {same} of {TP_STEPS} the single "
                f"process's; prefill {got[0]['prefill_ms']:.1f} ms, decode "
                f"{got[0]['decode_ms_per_step']:.2f} ms per step (rank 0, {tp} ranks sharing "
                "one card)")
            require(cos >= TP_COS_MIN and rel <= TP_REL,
                    f"phase 4i tp={tp} {name}: logits against one process: cos {cos}, rel {rel}")
            world["cases"][name] = {"max_abs": d, "cos": cos, "rel": rel, "tokens_same": same,
                                    "prefill_ms": got[0]["prefill_ms"],
                                    "decode_ms_per_step": got[0]["decode_ms_per_step"],
                                    "launches": got[0]["launches"]}
            for k, n in got[0]["launches"].items():
                world["launches"][k] = world["launches"].get(k, 0) + n
        pools = [r["pool"]["streams"] for r in ranks]
        require(all(p == pools[0] for p in pools), f"phase 4i tp={tp}: the ranks' pools differ")
        require(pools[0] == pool_want,
                f"phase 4i tp={tp}: the pool's streams differ from one process's: " + "; ".join(
                    f"slot {b}: {a} vs {w}" for b, (a, w) in enumerate(zip(pools[0], pool_want))
                    if a != w))
        world["pool"] = {"seconds": ranks[0]["pool"]["seconds"],
                         "launches": ranks[0]["pool"]["launches"]}
        for k, n in ranks[0]["pool"]["launches"].items():
            world["launches"][k] = world["launches"].get(k, 0) + n
        log(f"tp {tp} pools: {len(TP_POOL_PREFILLS)} slots, {TP_POOL_CHUNK} plain + up to "
            f"{TP_POOL_CHUNK} speculative tokens each, the single process's streams; "
            f"{ranks[0]['pool']['seconds']:.1f} s")
        if tp == 2:
            e = [r["encoder"] for r in ranks]
            require(len({x["sha"] for x in e}) == 1, "phase 4i: the ranks' encodes differ")
            d, cos, rel = _tp_held(e[0]["out"], enc_want)
            log(f"tp 2 encoder ({TP_ENC_LAYERS} layers, {hp.n_audio_head // 2} heads a rank): "
                f"max|d| {d:.4g}, cos {cos:.7f}, rel {rel:.4g}; {e[0]['ms']:.1f} ms")
            require(cos >= TP_COS_MIN and rel <= TP_REL,
                    f"phase 4i encoder: against one process: cos {cos}, rel {rel}")
            world["encoder"] = {"max_abs": d, "cos": cos, "rel": rel, "ms": e[0]["ms"],
                                "launches": e[0]["launches"]}
            for k, n in e[0]["launches"].items():
                world["launches"][k] = world["launches"].get(k, 0) + n
        world["peak_gib"] = [r.get("peak_gib") for r in ranks]
        out["worlds"][tp] = world
        log(f"tp {tp}: world of {tp} ranks {world['seconds']:.1f} s, peak GiB per rank "
            + json.dumps([round(p, 2) for p in world["peak_gib"] if p is not None]))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_train(device, hp, cfg, batch: int = 1) -> dict:
    """Phase 4i, training: TRAIN_STEPS steps of make_train_step in one
    process at full width (the encoder of ``hp``, the decoder ``cfg``), float32
    parameters and AdamW, on one repeated batch of ``batch`` 30 s mels and
    TRAIN_TOKENS tokens. The loss must be finite and fall; ms per step and
    the peak memory are logged."""
    import math

    import torch
    from qwen2_audio_tpu_torch.config import Qwen2AudioConfig
    from qwen2_audio_tpu_torch.training.step import adamw, init_train_state, make_train_step
    acfg = Qwen2AudioConfig(audio=hp, text=cfg)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device).manual_seed(50)
    t0 = time.perf_counter()
    state = init_train_state(gen, acfg, adamw(TRAIN_LR), device=device)
    n_params = sum(t.numel() for t in (state.opt_state.param_groups[0]["params"]))
    mel = torch.randn((batch, hp.n_mels, 2 * hp.n_audio_ctx), generator=gen, device=device)
    toks = torch.randint(0, cfg.vocab_size, (batch, TRAIN_TOKENS), generator=gen,
                         device=device)
    mask = torch.ones((batch, TRAIN_TOKENS), device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    step = make_train_step(acfg)
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, mel, toks, mask)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device.type == "cuda" else None
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"train: {n_params / 1e9:.3f} B parameters ({hp.n_audio_layer}-layer encoder, "
        f"{cfg.num_hidden_layers}-layer decoder, float32, AdamW), batch {batch}, losses "
        + json.dumps(losses) + ", ms per step " + json.dumps([round(m, 1) for m in ms])
        + (f", peak {peak:.2f} GiB" if peak is not None else "") + f", init {init_s:.1f} s")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"phase 4i training: the loss did not fall: {losses}")
    return {"losses": losses, "ms_per_step": ms, "peak_gib": peak, "params_b": n_params / 1e9,
            "init_s": init_s}


TP_PATH = {   # phase 4i: the kernels its TP runs must launch, by counter name
    "attention_single": "tp 2 encoder", "attention_causal": "every prefill",
    "flash_decode": "bf16 and float32 caches", "flash_decode_quant": "the int8 cache",
    "kv_append_quant": "the int8 cache", "quant_matmul": "q8_0 lm_head",
    "quant_matmul_stacked": "q8_0 layers", "quant_matmul4_stacked": "q4_0 layers",
    "quant_matmul4": "q4_0 lm_head", "quant_matmul_int8": "mode int8 lm_head",
    "quant_matmul_int8_stacked": "mode int8 layers",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="encoder depth of the main-path checkpoint, phases 4a-4h "
                         "(full: 32; 4c, 4j and 4k take at most CUT_LAYERS)")
    ap.add_argument("--calls", type=int, default=8,
                    help="encode-path whisper_full calls; the first is warm-up, "
                         "the median of the rest is reported")
    ap.add_argument("--dec-layers", type=int, default=28,
                    help="decoder depth of the audio -> text paths (full: 28; the q8_0 "
                         "and q4_0 ones of 4d and 4e take at most QUANT_DEC_LAYERS)")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="new tokens per audio -> text request")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phases 1 and 2 (build, kernels against their plain "
                         "versions) and print no result lines")
    ap.add_argument("--cli-only", action="store_true",
                    help="run phase 1 (the build) and phase 4j (the command line and the "
                         "mul_mat bench, on checkpoints it writes) alone and print no "
                         "result lines")
    ap.add_argument("--surface-only", action="store_true",
                    help="run phase 1 (the build) and phase 4k (remote offload, the C API "
                         "shim, the debug utilities, on the checkpoint it writes) alone and "
                         "print no result lines")
    ap.add_argument("--tp-only", action="store_true",
                    help="run phase 1 (the build) and phase 4i (tensor parallelism, "
                         "training) alone and print no result lines")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    import dataclasses

    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.config import WHISPER_PRESETS, Qwen2DecoderConfig

    import faulthandler
    # every thread's stack on stderr if a run nears its time limit
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        gpu = gpu_line()
        log(f"gpu: {gpu}")
        build_s = build()
        log(f"build: {build_s:.1f} s (nvcc, sm_90a, one process per source)")
        # each phase's seconds since the stamp before it, printed at the end
        phases, last = {"phase 1 (build)": round(build_s, 1)}, [time.perf_counter()]

        def stamp(what: str) -> None:
            now = time.perf_counter()
            phases[what] = round(now - last[0], 1)
            last[0] = now
            log(f"{what} done at {now - t_start:.1f} s ({phases[what]:.1f} s)")

        full = WHISPER_PRESETS["qwen2-audio"]
        two = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
        tp_cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=TP_LAYERS)
        cut_hp = dataclasses.replace(full, n_audio_layer=min(CUT_LAYERS, args.layers))
        if args.cli_only or args.surface_only:
            with tempfile.TemporaryDirectory() as workdir:
                path = write_random_checkpoint(workdir, cut_hp, "cut")
                if args.surface_only:
                    stamp("checkpoint")
                    surface = run_surface(workdir, path, cut_hp)
                else:
                    hf = os.path.join(workdir, "hf_qwen2_audio")
                    write_hf_checkpoint(hf, dataclasses.replace(full, n_audio_layer=2), two,
                                        device)
                    stamp("checkpoints")
                    cli = run_cli(workdir, path, hf)
            if args.surface_only:
                log("summary 4k surface: " + json.dumps(surface))
                log(f"surface only: phase 4k passed in {time.perf_counter() - t_start:.1f} s")
                return 0
            log("summary 4j cli: " + json.dumps(cli))
            log(f"cli only: phase 4j passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        if args.tp_only:
            tp = run_tp(device, tp_cfg, full)
            train = run_train(device, full, two)
            log("summary 4i: " + json.dumps({"tp": tp, "train": train}, default=str))
            log(f"tp only: phase 4i passed in {time.perf_counter() - t_start:.1f} s")
            return 0

        mel = check_mel(device)
        attn_bf16, attn_f32 = check_attention(device)
        causal_bf16, causal_f32 = check_causal(device)
        lite, nopad = check_attention_variants(device)
        check_option_effects(device)
        kv_append = check_quantize_kv(device)
        stamp("phase 2 attention")
        decode, decode_q8 = check_decode(device)
        qmm = check_quant_matmul(device)
        check_stream_tickets(device)
        check_dequant16(device)
        stamp("phase 2 dequantizing matmul")
        fused = check_fused_mlp(device)
        int8 = check_int8_matmul(device)
        w8a8 = check_w8a8(device)
        if args.kernels_only:
            log(f"kernels only: phases 1 and 2 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        stamp("phase 2")
        check_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_quant_encoder_parity(device, dataclasses.replace(full, n_audio_layer=2))
        stamp("phase 3 encoders")
        check_decoder_parity(device, two)
        stamp("phase 3 dense decoder")
        check_quant_decoder_parity(device, two)
        stamp("phase 3")
        dec_cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=args.dec_layers)
        qdec_cfg = dataclasses.replace(Qwen2DecoderConfig(),
                                       num_hidden_layers=min(QUANT_DEC_LAYERS, args.dec_layers))
        with tempfile.TemporaryDirectory() as workdir:
            ctx, res = run_main_path(dataclasses.replace(full, n_audio_layer=args.layers),
                                     args.calls, workdir)
            stamp("phase 4a")
            variants = run_attention_variants(ctx, VARIANT_CALLS)
            stamp("phase 4f")
            text = run_audio_to_text(ctx, dec_cfg, TEXT_REQUESTS, args.new_tokens)
            stamp("phase 4b")
            opts = run_decode_options(ctx, "bf16", args.new_tokens,
                                      noisy_tone(30.0, seed=20, freq=300.0), int8_cache=True)
            stamp("phase 4g (bf16)")
            t4h = time.perf_counter()
            clips = [noisy_tone(sec, seed=60 + i, freq=250.0 + 40.0 * i)
                     for i, sec in enumerate(POOL_CLIPS)]
            pools = {"bf16": run_pool(ctx, "bf16", args.new_tokens, clips)}
            ctx.decoder.cache_dtype = "q8"
            pools["bf16, int8 cache"] = run_pool(ctx, "bf16 (int8 cache)", args.new_tokens,
                                                 clips, spec_ks=(0,))
            ctx.decoder = None
            torch.cuda.empty_cache()
            stamp("phase 4h (bf16 pools)")
            w8a8_run = run_w8a8_request(ctx, dec_cfg, args.new_tokens)
            parallel = run_full_parallel(ctx)
            hf = run_hf_load(device, workdir, dataclasses.replace(full, n_audio_layer=2), two)
            t4h = time.perf_counter() - t4h
            stamp("phase 4h (w8a8, full_parallel, HF load)")
            capi.whisper_free(ctx)
            torch.cuda.empty_cache()
            cut_path = res["path"] if cut_hp.n_audio_layer == args.layers \
                else write_random_checkpoint(workdir, cut_hp, "cut")
            cli = run_cli(workdir, cut_path, os.path.join(workdir, "hf_qwen2_audio"))
            stamp("phase 4j")
            surface = run_surface(workdir, cut_path, cut_hp)
            stamp("phase 4k")
            ctx8, enc8 = run_quant_encode(cut_path, cut_hp, "q8_0", QUANT_CALLS, workdir)
            stamp("phase 4c (q8_0)")
            t8 = time.perf_counter()
            text8 = run_quant_text(ctx8, qdec_cfg, "q8_0", args.new_tokens, pool_clips=clips)
            t4h += text8["pool"]["seconds"]
            stamp(f"phase 4d (q8_0; its 4h pool {text8['pool']['seconds']:.1f} s of "
                  f"{time.perf_counter() - t8:.1f})")
            int8_runs = run_int8_paths(ctx8, qdec_cfg, args.new_tokens)
            stamp("phase 4e")
            capi.whisper_free(ctx8)
            ctx4, enc4 = run_quant_encode(cut_path, cut_hp, "q4_0", QUANT_CALLS, workdir)
            stamp("phase 4c (q4_0)")
            text4 = run_quant_text(ctx4, qdec_cfg, "q4_0", args.new_tokens)
            stamp("phase 4d (q4_0)")
            capi.whisper_free(ctx4)
        t4i = time.perf_counter()
        tp = run_tp(device, tp_cfg, full)
        train = run_train(device, full, two)
        t4i = time.perf_counter() - t4i
        stamp("phase 4i")
    except Exception as e:  # every phase failure ends the run with no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for k in (mel, attn_bf16):
        k["launches"] = res["launches"][k["name"]]
    lite["launches"] = variants["lite"]["launches"]["attention_lite"]
    nopad["launches"] = variants["nopad"]["launches"]["flash_attention_nopad"]
    for k in (causal_bf16, decode, decode_q8, kv_append):
        k["launches"] = text["launches"][k["name"]]
    # each kernel's launches on the configuration of the main path that runs it
    on_path = {
        "quant_matmul": text8["per-projection MLP"],
        "quant_matmul_stacked": text8["per-projection MLP"],
        "quant_matmul4_stacked": text4["one-launch SwiGLU"],
        "quant_matmul4": text4["one-launch SwiGLU"],
        "quant_matmul_panel": text8["panelized"],
        "quant_matmul_panel_stacked": text8["panelized"],
        "quant_matmul_panel4": text4["panelized"],
        "quant_matmul_panel4_stacked": text4["panelized"],
    }
    for name, cfg_run in on_path.items():
        qmm[name]["launches"] = cfg_run["launches"][name]
    fused["launches"] = sum(n for k, n in text8["one-launch SwiGLU"]["launches"].items()
                            if k.startswith("fused_mlp"))
    for name, run_name in (("quant_matmul_int8", "q8_0 int8 mode"),
                           ("quant_matmul_int8_stacked", "q8_0 int8 mode"),
                           ("quant_matmul_q4b_stacked", "q4_0 b32")):
        int8[name]["launches"] = int8_runs[run_name]["launches"][name]
    kernels = [mel, attn_bf16, causal_bf16, decode, decode_q8, kv_append,
               qmm["quant_matmul"], qmm["quant_matmul_stacked"],
               qmm["quant_matmul4_stacked"], qmm["quant_matmul4"],
               qmm["quant_matmul_panel"], qmm["quant_matmul_panel_stacked"],
               qmm["quant_matmul_panel4"], qmm["quant_matmul_panel4_stacked"], fused,
               int8["quant_matmul_int8"], int8["quant_matmul_int8_stacked"],
               int8["quant_matmul_q4b_stacked"], lite, nopad]
    for k in kernels:
        require(k["launches"] > 0, f"kernel {k['name']} was not launched on the main path")
    # phase 4j: the launches of rows 1-4 over the CLI run, of 6, 13, 14 over the bench
    for k in (mel, attn_bf16, causal_bf16, decode):
        k["launches_4j"] = cli["launches"][k["name"]]
    for k in (qmm["quant_matmul"], qmm["quant_matmul4"], int8["quant_matmul_int8"]):
        k["launches_4j"] = cli["bench_launches"][k["name"]]
    # phase 4k: the launches of rows 1-2 in this process over the phase (the
    # reference, the per-node diff and the traced call)
    for k in (mel, attn_bf16):
        k["launches_4k"] = surface["launches"][k["name"]]
    # phase 4g: the launches of rows 4/5, 6-13 and 17 on the beam and
    # speculative requests (row 4's are 0 on a speculative request: its
    # verify forwards of K + 1 positions take the plain attention, as in JAX)
    int8_reqs = ("beam int8 cache", "speculative int8 cache")
    for k, reqs in ((decode, ("beam", "speculative")), (decode_q8, int8_reqs),
                    (kv_append, int8_reqs)):
        k["launches_4g"] = {r: opts[r]["launches"].get(k["name"], 0) for r in reqs}
    rows_by_fmt = {"q8_0": ("quant_matmul", "quant_matmul_stacked", "quant_matmul_panel",
                            "quant_matmul_panel_stacked"),
                   "q4_0": ("quant_matmul4", "quant_matmul4_stacked", "quant_matmul_panel4",
                            "quant_matmul_panel4_stacked")}
    for fmt, txt in (("q8_0", text8), ("q4_0", text4)):
        for name in rows_by_fmt[fmt]:
            qmm[name]["launches_4g"] = {r: txt["options"][r]["launches"].get(name, 0)
                                        for r in ("beam", "speculative")}
        fused.setdefault("launches_4g", {}).update(
            {f"{fmt} {r}": sum(n for e, n in txt["options"][r]["launches"].items()
                               if e.startswith("fused_mlp")) for r in ("beam", "speculative")})
    require(decode["launches_4g"]["beam"] > 0 and decode_q8["launches_4g"]["beam int8 cache"] > 0,
            "phase 4g: a decode kernel was not launched on a beam request")
    # phase 4h: the launches of each kernel on the pools that run it
    pool_runs = {f"{cfg_name} {mode}": r["launches"]
                 for cfg_name, runs in (("bf16", pools["bf16"]),
                                        ("bf16 int8 cache", pools["bf16, int8 cache"]),
                                        ("q8_0", text8["pool"]))
                 for mode, r in runs.items() if isinstance(r, dict) and "launches" in r}
    for k in (mel, attn_bf16, causal_bf16, decode, decode_q8, kv_append,
              qmm["quant_matmul"], qmm["quant_matmul_stacked"]):
        k["launches_4h"] = {r: lc.get(k["name"], 0) for r, lc in pool_runs.items()}
    for k, runs in ((mel, pool_runs), (attn_bf16, pool_runs), (causal_bf16, pool_runs),
                    (decode, ("bf16 plain",)), (decode_q8, ("bf16 int8 cache plain",)),
                    (kv_append, ("bf16 int8 cache plain",)),
                    (qmm["quant_matmul"], ("q8_0 plain", f"q8_0 speculative K = {SPEC_K}")),
                    (qmm["quant_matmul_stacked"], ("q8_0 plain",
                                                   f"q8_0 speculative K = {SPEC_K}"))):
        require(all(k["launches_4h"][r] > 0 for r in runs),
                f"phase 4h: {k['name']} was not launched on {runs}: {k['launches_4h']}")
    # the one-launch SwiGLU takes the plain pool's steps (8 rows) and not the
    # speculative pool's verify (POOL_SLOTS x (K + 1) rows, past
    # ONE_LAUNCH_MAX_M: the two-launch path)
    fused_4h = {r: sum(n for e, n in pool_runs[r].items() if e.startswith("fused_mlp"))
                for r in ("q8_0 plain", f"q8_0 speculative K = {SPEC_K}")}
    fused["launches_4h"] = fused_4h
    require(fused_4h["q8_0 plain"] > 0 and fused_4h[f"q8_0 speculative K = {SPEC_K}"] == 0,
            f"phase 4h: the one-launch SwiGLU's launches on the q8_0 pools: {fused_4h}, want "
            "some on the plain pool and none on the speculative one")
    # phase 4i: each kernel's launches over its TP runs (the counts of rank 0,
    # every rank launching the same), by world
    for k in kernels:
        k["launches_4i"] = {
            f"tp {t}": (sum(n for e, n in w["launches"].items() if e.startswith("fused_mlp"))
                        if k is fused else w["launches"].get(k["name"], 0))
            for t, w in tp["worlds"].items()}
    for k in kernels:
        if k["name"] in TP_PATH or k is fused:
            require(sum(k["launches_4i"].values()) > 0,
                    f"phase 4i: {k['name']} was not launched on its TP runs "
                    f"({TP_PATH.get(k['name'], 'the q8_0 and q4_0 decode steps')})")
    for k in [qmm[n] for n in qmm] + [fused]:
        require(all(n > 0 for n in k["launches_4g"].values()),
                f"phase 4g: {k['name']} was not launched on every beam and speculative "
                f"request: {k['launches_4g']}")
    log(f"summary: whisper_full steady {res['steady_ms']:.3f} ms per 30 s clip, "
        f"{args.layers} layers, bf16; attention f32 at the encoder shape "
        f"{attn_f32['ms']:.4f} ms (plain {attn_f32['plain_ms']:.4f}, sdpa "
        f"{attn_f32['library_ms']:.4f}, bound {attn_f32['bound_ms']:.4f}); causal f32 "
        f"at the prefill shape {causal_f32['ms']:.4f} ms (plain "
        f"{causal_f32['plain_ms']:.4f}, sdpa {causal_f32['library_ms']:.4f}, bound "
        f"{causal_f32['bound_ms']:.4f}); audio -> text ({args.dec_layers}-layer "
        f"decoder, bf16): prefill {text['prefill_ms']:.3f} ms, decode "
        f"{text['decode_ms_per_token']:.3f} ms per token (medians), peak "
        f"{text['peak_gib']:.2f} GiB")
    enc = res["encode"]
    log(f"summary captured encode: the encoder alone {enc['graph_ms']:.3f} ms per 30 s clip "
        f"replayed, {enc['eager_ms']:.3f} eager (host clock, synchronised); graph captured "
        f"in {enc['capture_ms']:.1f} ms")
    for cache, row in text["steps"].items():
        log(f"summary decode step ({cache} cache, {args.dec_layers} layers): eager "
            f"{row['eager']['kernels']} kernels, enqueue {row['eager']['enqueue_ms']:.3f} ms, "
            f"synchronised {row['eager']['host_ms']:.3f} ms; replay {row['replay']['kernels']} "
            f"kernels, enqueue {row['replay']['enqueue_ms']:.3f} ms, synchronised "
            f"{row['replay']['host_ms']:.3f} ms; captured in {row['capture_ms']:.1f} ms")
    for cache, row in text["against"].items():
        log(f"summary audio -> text ({cache} cache): decode ms per token replayed "
            f"{row['replayed_ms_per_token']:.3f}, eager {row['eager_ms_per_token']:.3f}; "
            f"one forward's device ms {row['device_ms_per_step']:.3f}")
    prof = text["profile"] or {}
    log(f"summary audio -> text (bf16 cache): device busy "
        f"{100 * prof.get('busy_share', float('nan')):.1f} % of a profiled request")
    for name, v in variants.items():
        log(f"summary attention variant {name}: {v['ms']:.3f} ms per encode (median), "
            f"device busy {v['busy_ms']} ms of a profiled call, embedding cos {v['cos']:.6f}")
    for fmt, enc, txt in (("q8_0", enc8, text8), ("q4_0", enc4, text4)):
        log(f"summary {fmt}: quantized whisper_full steady {enc['steady_ms']:.3f} ms per "
            f"30 s clip (dq16: per-call {json.dumps([round(v, 3) for v in enc['dq16']['per_call_ms']])}, "
            f"device busy {enc['dq16']['busy_ms']} ms); {txt['block_gb']:.2f} GB of blocks "
            "per decode step")
        for name, c in txt.items():
            if isinstance(c, dict) and "run" in c:
                r = c["run"]
                prof = r["profile"] or {}
                log(f"summary {fmt} ({name}): prefill {r['prefill_ms']:.3f} ms, decode "
                    f"{r['decode_ms_per_token']:.3f} ms per token over {r['tokens']} tokens "
                    f"(again from the same prefill: replayed "
                    f"{r['against']['replayed_ms_per_token']:.3f}, eager "
                    f"{r['against']['eager_ms_per_token']:.3f}; one forward's device ms "
                    f"{r['against']['device_ms_per_step']:.3f}), "
                    f"wall {r['wall_ms']:.1f} ms, device busy "
                    f"{100 * prof.get('busy_share', float('nan')):.1f} % of a profiled call, "
                    f"peak {r['peak_gib']:.2f} GiB")
    for name, c in int8_runs.items():
        r, prof = c["run"], c["run"]["profile"] or {}
        log(f"summary int8 paths ({name}): " + (
            f"prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_token']:.3f} ms per "
            f"token over {r['tokens']} tokens (again from the same prefill: replayed "
            f"{r['against']['replayed_ms_per_token']:.3f}, eager "
            f"{r['against']['eager_ms_per_token']:.3f}; one forward's device ms "
            f"{r['against']['device_ms_per_step']:.3f}), " if name != "encode" else
            f"encode {r['encode_ms']:.3f} ms, ") + f"wall {r['wall_ms']:.1f} ms, device busy "
            f"{100 * prof.get('busy_share', float('nan')):.1f} % of a profiled call, peak "
            f"{r['peak_gib']:.2f} GiB")
    for cfg_name, runs in (("4g bf16", opts), ("4g q8_0", text8["options"]),
                           ("4g q4_0", text4["options"]),
                           ("4e q8_0 int8 mode", int8_runs["q8_0 int8 mode"]["options"])):
        for req, r in runs.items():
            log(f"summary {cfg_name} ({req}): " + json.dumps(
                {k: r[k] for k in ("prefill_ms", "decode_ms_per_token", "tokens", "forwards",
                                   "replayed_ms_per_token", "eager_ms_per_token",
                                   "step_device_ms", "reorder_device_ms", "reorder_bound_ms",
                                   "iters", "tokens_per_forward", "first_difference", "gap",
                                   "spread", "min_gap", "segments", "dtw_ms", "wall_ms")
                 if k in r}))
    for cfg_name, runs in (("bf16", pools["bf16"]), ("bf16 int8 cache", pools["bf16, int8 cache"]),
                           ("q8_0", text8["pool"])):
        for mode, r in runs.items():
            if isinstance(r, dict) and "tokens" in r:
                log(f"summary 4h pool {cfg_name} ({mode}): " + json.dumps(
                    {k: r[k] for k in ("tokens", "tokens_per_s", "wall_tokens_per_s",
                                       "ms_per_chunk", "chunks", "refills", "step_device_ms",
                                       "verify_device_ms",
                                       "b1_step_device_ms", "iters", "tokens_per_verify",
                                       "near_ties", "peak_gib") if k in r}))
    log("summary 4h w8a8 request: " + json.dumps(
        {"decode_ms_per_token": w8a8_run["decode_ms_per_token"],
         "step_device_ms": w8a8_run["against"]["device_ms_per_step"],
         "bound_ms": w8a8_run["bound_ms"], "tokens": w8a8_run["tokens"]})
        + "; the product: " + json.dumps(w8a8))
    log(f"summary 4h full_parallel: {parallel['ms_per_call']:.3f} ms per call of "
        f"{PARALLEL_PROCESSORS} chunks ({parallel['ms_per_chunk']:.3f} per chunk), chunk "
        f"cosines {json.dumps([round(c, 7) for c in parallel['cos']])}")
    log("summary 4h hf load: " + json.dumps(hf))
    log(f"summary 4h: {t4h:.1f} s in all")
    log("summary 4j cli: " + json.dumps(cli))
    log("summary 4k surface: " + json.dumps(surface))
    log("summary 4i tp (ranks sharing one card): " + json.dumps(
        {t: {"seconds": w["seconds"], "peak_gib": w["peak_gib"],
             "cases": {n: {k: c[k] for k in ("max_abs", "cos", "rel", "tokens_same",
                                              "prefill_ms", "decode_ms_per_step")}
                       for n, c in w["cases"].items()},
             "pool_s": w["pool"]["seconds"], "encoder": {k: v for k, v in
                                                          w.get("encoder", {}).items()
                                                          if k != "launches"}}
         for t, w in tp["worlds"].items()}))
    log("summary 4i train: " + json.dumps(train))
    log(f"summary 4i: {t4i:.1f} s in all (one-process references {tp['single_s']:.1f} s)")
    log("phase seconds: " + json.dumps(phases))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
