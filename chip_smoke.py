#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qwen2_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers 32] [--calls 8] [--dec-layers 28]
                          [--new-tokens 32] [--q4-layers 32] [--kernels-only]

(``--layers 4 --calls 2 --dec-layers 2 --new-tokens 8 --q4-layers 4`` is a
quick rehearsal.) Phases, each of which must pass (any failure exits non-zero
before the result lines are printed):
1. build every CUDA kernel from qwen2_audio_tpu_torch/csrc with nvcc
   (sm_90a), in parallel, and print the card's name and power limit; the
   SASS of every tensor-core kernel is checked (cuobjdump): the bf16
   attention tile on wgmma, and each fast-mode instantiation of the two
   M <= 8 weight-streaming kernels (qmm_stream_kernel, swiglu_stream_kernel)
   on HMMA or HGMMA; the mel kernel on float32 FMA with no HMMA or HGMMA;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with stated tolerances (the mel kernel on MEL_CASES,
   each also against the float64 oracle; the decode kernels over a
   cache filled with NaN past each stream's position, at the split-KV
   kernel's range edges too, its launch plan held to what the card keeps
   resident), and time kernel,
   plain version and (where one exists) the one-call library equivalent;
   the four dequantizing-matmul entries at M = 1, 7, 752 and 1500 over the
   decoder's, the lm_head's and the encoder's K x N, in both modes, bf16
   and float32 x, q8_0, symmetric q4_0, q4_1 (mins) and q6_K (group 16),
   and at every one of those cases the panel entry of the same weight in
   contiguous column panels, bit-equal to the strided entry; the edges of the
   large-M wgmma tile: M = 9, 65, 129, 753, a weight of N = 1296 (a multiple
   of 16, not of the tile's 128 columns) and K = 1312 (a multiple of 32, not
   of the 64-deep stage) in q8_0 (float16 and float32 scales), q4_0 and q6_K,
   float32 x in fast mode, in panels of widths 16, 48 and 432, the K-split
   M <= 8 launch on two streams at once and in a CUDA graph, bit-equal to
   one stream (ticket counters per stream and per capture), and the M <= 8
   streaming kernel at M = 1 on that N in panels of 16 and 48; the five
   one-launch SwiGLU entries at the decoder's width (K = D = 3584,
   I = 18944) at M = 1, 7, 64 in both modes and M = 2, 8, 9 in fast mode,
   bf16 and float32 x, over q8_0, q6_K, q5_1 (mins), symmetric q4_0 and q4_1
   blocks, the split schema
   bit-equal to the fused one, two runs bit-equal, M = 65 refused; every
   M <= 8 case of the two timed by CUDA-graph replay (the back-to-back
   events' figure beside it), with its share of the bound; the
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
   entry bit-equal, the output moved against dq16 off;
3. parity at full width and depth 2, card against CPU in float32: the
   encoder (embedding, dense and from a q8_0 checkpoint), and the Qwen2
   decoder (a 160-position prefill and 8 greedy steps: the same tokens,
   logits within tolerance), dense and with q8_0 (layers and lm_head) and
   q4_0 (layers) weights from the ggml quantizers (a 16-position prefill
   and 4 steps, exact mode), each with the one-launch SwiGLU off, and once
   more with it on (q8_0) and with the decoder panelized (q4_0); in mode
   "int8" the q8_0 encoder and both decoders, and in the default mode a
   decoder of random q4_0 blocks as int32 words (the CPU's greedy tokens
   over a prefill and one step teacher-forced on the card), each card run
   launching the integer entry for every quantized linear and no other;
4. the main path at full width, each path with the launch counters set
   to 0 just before it and read just after:
   a. encode: write a random-weight (seed 0) F16 qwen2-audio checkpoint
      with the port's ggml writer, load it through
      capi.whisper_init_from_file_with_params in bf16, run whisper_full on
      a 30 s clip ``--calls`` times; check the launch counts, the output
      shape, finiteness, and agreement with the plain attention path;
   b. audio -> text: attach a random bf16 Qwen2 decoder (seed 0, made on
      the card, ``--dec-layers`` deep) and answer 1 request on a 30 s clip
      through capi.whisper_full with ``--new-tokens`` new tokens, plus one
      request over the int8 KV cache; check the launch counts of the prefill and decode kernels
      and of the int8 cache writes (one a layer and forward, the prefill's
      included) against the prefills and decoder forwards the runs report,
      log the int8-cache request's decode ms per token beside the bf16
      one's and the device kernels of one decode step over each cache, the
      segments, tokens and logits, and, teacher-forced over the same
      tokens, the plain-attention path (cosine per step);
   c. quantized encode: the checkpoint of (a) through
      io.export.quantize_checkpoint to q8_0 and to q4_0 (the q4_0 one
      ``--q4-layers`` deep), each loaded with keep_quantized=True and run
      through whisper_full: 4 launches of the flat entry per layer and
      clip, the embedding held against the same file loaded dense;
   d. quantized audio -> text: behind each quantized encoder a decoder
      with q8_0 or packed symmetric q4_0 stacked weights and a quantized
      lm_head, random block contents made on the card, in the storage the
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
      against the q4_0 request in mode "int8");
   f. behind the bf16 context of (a), before (b): whisper_full on one clip
      under each encoder attention variant (set_attention_variants: lite,
      nopad, exp2, pexp16, single off), the variant's entry launched once
      per layer and call and no other attention entry, the median ms per
      call, one profiled call, the embedding against the default path's.
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
MAIN_COS_MIN = 0.99
DEC_PARITY_PREFILL, DEC_PARITY_STEPS = 160, 8
TEXT_REQUESTS = 1     # audio -> text requests over the bf16 cache (+1 over int8)
QMM_ATOL_F32 = 1e-4   # of max|plain|
QMM_TOL_BF16 = (2.0 ** -8, 2.0 ** -7)   # (atol of max|plain|, rtol)
QUANT_CALLS = 6       # whisper_full calls of each quantized encode path
VARIANT_CALLS = 4     # whisper_full calls under each encoder attention variant (4f)
QDEC_PARITY_PREFILL, QDEC_PARITY_STEPS = 16, 4
INT8_PARITY_STEPS = 2  # mode "int8" parity: the prefill and one cached step
FUSED_FLIPS = 2       # bf16 roundings of gated that may fall the other way, per output
PANEL_TOKENS = 8      # new tokens of the q8_0 panelized request
INT8_REL = 0.02       # of max|ref|: q8_1 rounding of x (the JAX suite's bound)
INT8_PARITY_REL = 0.015  # of max|cpu|: phase 3 in mode "int8" and for int32 words


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
            if "registers" in line or "spill" in line or "setmaxnreg" in line:
                log(f"ptxas[{name}]: {line.strip()}")
    for name in ("quant_matmul", "quant_matmul_int8"):
        for fn, n in sass_counts(str(_build._target(name)), ("HGMMA", "IGMMA")).items():
            log(f"sass[{name}]: {fn}: {n}")
    check_attention_sass(sass_counts(str(_build._target("attention_single")),
                                     ("HGMMA", "HMMA")))
    check_stream_sass({name: sass_counts(str(_build._target(name)), STREAM_SASS_OPS)
                       for name in STREAM_KERNELS})
    check_mel_sass(sass_counts(str(_build._target("mel")), ("FFMA", "HMMA", "HGMMA")))
    return secs


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


# the M <= 8 weight-streaming kernels (fast mode): library, kernel, instantiations
STREAM_KERNELS = {"quant_matmul": ("qmm_stream_kernel", 8),
                  "fused_mlp": ("swiglu_stream_kernel", 8)}
STREAM_SASS_OPS = ("HMMA", "HGMMA", "F2FP", "F2F", "FFMA", "FMUL", "FADD", "PRMT")


def check_stream_sass(counts: dict) -> None:
    """Every fast-mode instantiation of the two M <= 8 weight-streaming
    kernels (qmm_stream_kernel: x type x packed x dq16; swiglu_stream_kernel:
    x type x packed x mins) runs its products on the tensor cores: it issues
    HMMA or HGMMA. Logs each instantiation's counts of the instructions a
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


def check_stream_tickets(device) -> None:
    for fmt in ("q8_0", "q4_0"):
        bad, total = stream_ticket_mismatches(device, fmt)
        log(f"tickets {fmt}: {total} K-split launches on two streams and in a graph, "
            f"{bad} not bit-equal to the single-stream output")
        require(bad == 0, f"tickets {fmt}: {bad} of {total} outputs differ")


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
        *_decode_edge_cases(),
    ]


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


def check_decode_residency(device) -> None:
    """The launch plan's split count keeps every cluster resident at once:
    for each batch of the 7B decoder's 4 KV heads up to 8 streams at a
    capacity of 2048, the plan's B * Hkv clusters of ``splits`` CTAs against
    what the card holds (cudaOccupancyMaxActiveClusters of the bf16 kernel at
    the plan's shared memory); what it holds of clusters of 16 and 8 at one
    CTA an SM (the most stages) is logged."""
    import ctypes

    import torch
    from qwen2_audio_tpu_torch.ops import _build
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    lib = _build.library("flash_decode")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count

    def resident(splits: int, stages: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.qa_flash_decode_resident_clusters(splits, stages,
                                                               ctypes.byref(out)),
                         "qa_flash_decode_resident_clusters")
        return out.value

    seen = {}
    for B in (1, 2, 3, 4, 8):
        plan = fd.decode_plan(B, 2048, 4, 7, torch.bfloat16, n_sm)
        held = resident(plan["splits"], plan["stages"])
        seen[B] = (plan["splits"], held)
        require(B * 4 <= held, f"decode plan: B={B} puts {B * 4} clusters of "
                f"{plan['splits']} CTAs on a card that holds {held} at once")
    most = fd.decode_plan(1, 8192, 4, 7, torch.bfloat16, n_sm)["stages"]
    log(f"decode plan residency (B: splits, clusters the card holds): {json.dumps(seen)}; "
        f"at one CTA an SM {n_sm} SMs hold {resident(16, most)} clusters of 16 and "
        f"{resident(8, most)} of 8")


def check_decode(device, cases=None) -> tuple[dict, dict]:
    """Rows 4 and 5 against their plain versions over every case (NaN past
    each stream's position; the range-edge cases with the p-rounding term
    for streams of few rows, ``decode_p_abs_v``), each case's launch plan
    (splits, CTAs holding keys) logged; at B 1 and bf16 q, the first case of each kernel and
    capacity timed by CUDA-graph replays beside bf16 SDPA over the prefix,
    the back-to-back event time and the host's enqueue time logged beside
    them. The first case of each kernel (capacity 2048, pos 783: the audio
    -> text request's) is its main entry."""
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    main, timed, edges = {}, set(), _decode_edge_cases()
    check_decode_residency(device)
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
                              torch.cuda.get_device_properties(device).multi_processor_count)
        what = (f"decode q {tname} cache {str(kvdt).removeprefix('torch.')} B={B} S={S} "
                f"pos={pos} (splits {plan['splits']}, stages {plan['stages']}, "
                f"{plan['ctas_with_keys'](pos)} of {plan['splits'] * Hkv * B} CTAs hold keys)")
        p_abs_v = (decode_p_abs_v(plain, q, cache, posv, scale)
                   if (qdt, kvdt, B, S, pos) in edges else None)
        err, _ = _held(got, want, tname, what, p_abs_v)
        name = "flash_decode_quant" if quant else "flash_decode"
        if B != 1 or qdt != torch.bfloat16 or (name, S) in timed:
            continue
        timed.add((name, S))
        n = sum(p + 1 for p in pos)   # cache rows the function must read
        nbytes = (2 * n * Hkv * d * cache[0].element_size() + 2 * q.numel() * q.element_size()
                  + (2 * n * Hkv * 4 if quant else 0))
        b_ms, b_by = bound(4 * Hq * d * n, nbytes, PEAK_BF16)
        run = lambda: kern(q, *cache, posv, sm_scale=scale)   # noqa: E731
        lib = None
        if not quant:
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
        log(f"{name} at S={S} pos={pos[0]} (graph replay; SDPA as library_ms): " + json.dumps(
            {**{k_: t[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")},
             "events_ms": time_ms(run, iters=50), "host_us": host_us(run)}))
        main.setdefault(name, t)
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
        # M <= 8 by graph replay (back-to-back calls are bound by the host's
        # call rate near 0.1 ms), the events' figure beside it
        run = lambda: entry(x, q, sc, *li, **kw)   # noqa: E731
        t = {"ms": graph_ms(run) if M <= 8 else time_ms(run, iters=10),
             "plain_ms": time_ms(lambda: plain(x, ql, scl, **kw), iters=3 if big else 10,
                                 warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(lambda: x @ dense, iters=10)}
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
        if line in panel_lines:
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
            t_on = time_ms(lambda: entry(x, q, sc, *li, dq16=True, **kw),
                           iters=10 if M > 8 else 50)
            t_off = time_ms(lambda: entry(x, q, sc, *li, **kw), iters=10 if M > 8 else 50)
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
    xq and sx bit-equal, bf16 and float32 x, M = 1, 7, 752, 1500."""
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
                n += 1
    log(f"quantize_activations: {n} cases bit-equal to the plain version (ties, zero groups)")
    return n


def check_int8_matmul(device, dims=(3584, 18944, 156032, 1280)) -> dict:
    """Rows 14, 15 and 16, the exact-integer group matmul, against their
    plain versions at M = 1, 7, 752, 1500 over the decoder's, the lm_head's
    and the encoder's K x N; the equalities the design promises (row 14 =
    row 15 on the same values, row 16 = row 15 over nibble bytes with off 8
    on the same bytes, two runs) bit for bit; times beside bound, plain and
    library. Returns the kernels line's three entries."""
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
        if line is None and M not in (1, 752, 1500):
            continue
        # time beside the bound (weight + scales + x + out once; 2 M K N int8
        # operations), the plain version and one torch.matmul on the
        # dequantized weight in x's type
        nbytes = (ql.numel() * ql.element_size() + scl.numel() * scl.element_size()
                  + (x.numel() + M * N) * x.element_size())
        b_ms, b_by = bound(2.0 * M * K * N, nbytes, PEAK_INT8)
        vals = q4b.unpack_b32(ql) if form == "qs4b" else ql
        dense = qm.block_weight(vals, scl, packed=form != "qs", off=8 if form == "qs4b" else off
                                ).to(dtype)
        t = {"ms": time_ms(lambda: entry(x, q, sc, *li, **kw), iters=10 if M > 8 else 50),
             "plain_ms": time_ms(lambda: plain(x, ql, scl), iters=2, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(lambda: x @ dense, iters=10)}
        del dense
        log(f"{what}: " + json.dumps(t))
        if line is not None:
            src, row = rows[line]
            main[line] = {"name": line, "route": "cuda",
                          "source": "qwen2_audio_tpu_torch/csrc/quant_matmul_int8.cu",
                          "replaces": f"qwen2_audio_tpu/ops/{src}:{row}",
                          "shape": what, "max_abs_err": diff.max().item(), **t}
    log(f"int8 group matmul: {len(cases)} cases, worst {worst:.3f} of the tolerance")
    require(set(main) == set(rows), "int8 group matmul: a kernels-line entry is missing")
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


def check_fused_mlp(device, dims=(3584, 18944)) -> dict:
    """The five one-launch SwiGLU entries against the plain version at the
    decoder's width; returns the kernels line's entry (q8_0, M = 1)."""
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import fused_mlp as fm
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm

    bf, f32 = torch.bfloat16, torch.float32
    D, I = dims
    flavours = {   # format: (entry, leaf order)
        "q8_0": (fm.fused_mlp_stacked, ("qs", "scales")),
        "q6_K": (fm.fused_mlp_stacked, ("qs", "scales")),
        "q5_1": (fm.fused_mlp_m_stacked, ("qs", "scales", "mins")),
        "q4_0": (fm.fused_mlp4_sym_stacked, ("qs4", "scales")),
        "q4_1": (fm.fused_mlp4_stacked, ("qs4", "scales", "mins")),
    }
    line = {}
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
        # M = 2, 8 and 9 only in fast mode: the exact mode keeps its kernel
        for ci, (M, dtype, fast) in enumerate(
                (M, dtype, fast) for M in (1, 2, 7, 8, 9, 64) for dtype in (bf, f32)
                for fast in (True, False) if fast or M in (1, 7, 64)):
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
            if not (M == 1 and dtype == bf and fast and fmt in ("q8_0", "q4_0")):
                continue
            # M = 1 times: the kernel, its bound (every leaf once, x in, y
            # out), the plain version, three matmuls on the dequantized bf16
            # weights around SiLU * up (never called by the port), and the
            # two-launch path the kernel replaces
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
            del wg, wu, wd
            log(f"{what}: " + json.dumps(t) + f" ({nbytes / 1e6:.1f} MB)")
            if fmt == "q8_0":
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
        log(f"fused MLP {fmt}: 18 cases, worst {worst:.3f} of the tolerance")
        del gu, dn, args, g_l, u_l, d_l
        torch.cuda.empty_cache()
    require(bool(line), "fused MLP: the kernels-line entry is missing")
    return line


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
    del dec, cpu_params
    torch.cuda.empty_cache()
    return err



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
                # one per layer and decode forward, and at a prefill of <= 64 rows
                want_fused = L * (steps - 1 + (T0 <= 64)) \
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

def run_main_path(hp, calls: int, workdir: str) -> dict:
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.audio.mel import mel_input_window
    from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward, random_encoder_params
    from qwen2_audio_tpu_torch.ops.flash_attention import attention_single
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames
    from qwen2_audio_tpu_torch.runtime.context import ContextParams

    t0 = time.perf_counter()
    path = os.path.join(workdir, "qwen2-audio-random-f16.bin")
    write_encoder_checkpoint(path, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(hp.n_mels), [b"a", b"b", b"ab"])
    log(f"main: wrote {os.path.getsize(path) / 1e9:.3f} GB checkpoint "
        f"({hp.n_audio_layer} layers) in {time.perf_counter() - t0:.1f} s")

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
    profile_call(lambda: capi.whisper_full(ctx, params, x), "whisper_full (encode)")
    steady = per_call[1:] or per_call
    return ctx, {"launches": launches, "per_call_ms": per_call, "path": path,
                 "steady_ms": statistics.median(steady)}


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
    out = {}
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
            prof = profile_call(lambda: capi.whisper_full(ctx, params, clip),
                                f"whisper_full (encode, attention {name})")
            out[name] = {"launches": launches, "ms": ms, "cos": cos,
                         "busy_ms": (prof or {}).get("busy_ms")}
    finally:
        fv.set_attention_variants()
    return out


def _quant_entries() -> tuple:
    """Every entry of the quantized-weight kernels: dequantizing (strided
    and panel), one-launch SwiGLU, exact-integer group matmul."""
    from qwen2_audio_tpu_torch.ops import fused_mlp, quant_matmul, quant_matmul_int8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b
    return (quant_matmul.ENTRIES + fused_mlp.ENTRIES + quant_matmul_int8.ENTRIES
            + quant_matmul_q4b.ENTRIES)


def _launch_counters():
    from qwen2_audio_tpu_torch.ops.flash_attention import attention_causal, attention_single
    from qwen2_audio_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_quant,
                                                        kv_append_quant)
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames
    return {"mel_log_frames": mel_frames, "attention_single": attention_single,
            "attention_causal": attention_causal, "flash_decode": flash_decode,
            "flash_decode_quant": flash_decode_quant, "kv_append_quant": kv_append_quant,
            **{e.__name__: e for e in _quant_entries()}}


def _cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def teacher_forced_logits(bundle, st, params=None, flash: bool = True,
                          fused: bool | None = None, mode: str | None = None) -> list:
    """The request's prefill and tokens through the decoder on the card, one
    (V,) logits row per step: over ``params`` (default: the bundle's), the
    kernel or the plain attention, the one-launch SwiGLU as it is set or as
    ``fused`` says, in the group-matmul mode that is set or ``mode``."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.linear import (fused_mlp_enabled, group_matmul_mode,
                                                  set_fused_mlp, set_group_matmul_mode)
    from qwen2_audio_tpu_torch.runtime.decoding import _prefill_embeds

    params = bundle.params if params is None else params
    prefill = _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])
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
    bundle.cache_dtype = torch.bfloat16
    profile_call(lambda: capi.whisper_full(ctx, params, clips[0]), "whisper_full (audio -> text)")
    bf = [r for r in runs if r["cache"] != "q8"]
    q8 = [r["decode_ms_per_token"] for r in runs if r["cache"] == "q8"]
    log(f"text: decode ms per token, int8 cache {json.dumps(q8)} beside bf16 "
        f"{json.dumps([r['decode_ms_per_token'] for r in bf])} (ratio "
        f"{statistics.median(q8) / statistics.median(r['decode_ms_per_token'] for r in bf):.3f}); "
        f"one decode step by cache: {json.dumps(step_launches(bundle))}")
    return {"launches": launches, "runs": runs, "peak_gib": peak,
            "prefill_ms": statistics.median(r["prefill_ms"] for r in bf),
            "decode_ms_per_token": statistics.median(r["decode_ms_per_token"] for r in bf)}


def step_launches(bundle, pos: int = 783, capacity: int = 2048) -> dict:
    """One decode step of the bundle's decoder at ``pos`` over a fresh bf16
    and int8 cache: the device kernels it launches (counted by the profiler)
    and its host ms (the median of 5 steps, each ending in a device
    synchronisation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    out = {}
    x = bundle.decoder.embed(torch.tensor([[7]], device=bundle.decoder.device))
    for dtype in (torch.bfloat16, "q8"):
        cache = create_cache(bundle.cfg, 1, capacity, dtype=dtype, device=x.device)

        def step():
            decoder_forward(bundle.params, bundle.cfg, x, cache, pos)

        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kernels = sum(ev.count for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
        out["bf16" if dtype == torch.bfloat16 else "int8"] = {
            "kernels": kernels, "host_ms": statistics.median(times[1:])}
        del cache
    return out


def run_quant_encode(src_path: str, hp, fmt: str, calls: int, workdir: str):
    """Quantize the F16 checkpoint with the port's quantize_checkpoint, load
    it with the block weights kept, and run whisper_full ``calls`` times
    with the launch counters set to 0 just before and read just after."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.config import GGMLFType
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint, write_encoder_checkpoint
    from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
    from qwen2_audio_tpu_torch.quant.qparams import payload_form
    from qwen2_audio_tpu_torch.runtime.context import ContextParams

    if src_path is None:   # a shallower source of its own
        src_path = os.path.join(workdir, f"qwen2-audio-random-f16-{hp.n_audio_layer}.bin")
        write_encoder_checkpoint(src_path, random_encoder_params(np.random.default_rng(0), hp),
                                 hp, mel_filterbank(hp.n_mels), [b"a", b"b", b"ab"])
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
    most 64 rows; one flat launch per forward for the lm_head (last position
    only) and four per encoder layer and request. In mode "int8" the
    32-group "qs" and "qs4" take the integer kernels (a flat "qs4" the exact
    dequantizing one, as in JAX); "qs4b" takes its kernel in every mode."""
    from qwen2_audio_tpu_torch.ops.fused_mlp import MAX_M

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
    fused_forwards = (decodes + (prefills if prefill_rows <= MAX_M else 0)) if one_launch else 0
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


def run_quant_text(ctx, cfg, fmt: str, new_tokens: int) -> dict:
    """Behind the quantized encoder of ``ctx``, attach a decoder whose
    linears and lm_head are random ``fmt`` blocks made on the card (seed 0)
    and answer one request per storage configuration on one clip through
    capi.whisper_full, each with the launch counters set to 0 just before
    and read just after. Returns the configurations' results by name."""
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
                # another order of sums and roundings in the MLP: the first
                # configuration's tokens teacher-forced through this one
                mine = teacher_forced_logits(bundle, first)
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
    dequantizing kernel there against the integer one here). Every count is
    derived from the prefills and forwards the run reports."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="encoder depth of the main-path checkpoint (full: 32)")
    ap.add_argument("--calls", type=int, default=8,
                    help="encode-path whisper_full calls; the first is warm-up, "
                         "the median of the rest is reported")
    ap.add_argument("--dec-layers", type=int, default=28,
                    help="decoder depth of the audio -> text path (full: 28)")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="new tokens per audio -> text request")
    ap.add_argument("--q4-layers", type=int, default=32,
                    help="encoder depth of the q4_0 checkpoint (full: 32; the q8_0 "
                         "one has --layers)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phases 1 and 2 (build, kernels against their plain "
                         "versions) and print no result lines")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    import dataclasses

    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.config import WHISPER_PRESETS, Qwen2DecoderConfig

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        gpu = gpu_line()
        log(f"gpu: {gpu}")
        log(f"build: {build():.1f} s (nvcc, sm_90a, one process per source)")
        def stamp(what: str) -> None:
            log(f"{what} done at {time.perf_counter() - t_start:.1f} s")

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
        if args.kernels_only:
            log(f"kernels only: phases 1 and 2 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        full = WHISPER_PRESETS["qwen2-audio"]
        two = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
        stamp("phase 2")
        check_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_quant_encoder_parity(device, dataclasses.replace(full, n_audio_layer=2))
        stamp("phase 3 encoders")
        check_decoder_parity(device, two)
        stamp("phase 3 dense decoder")
        check_quant_decoder_parity(device, two)
        stamp("phase 3")
        dec_cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=args.dec_layers)
        with tempfile.TemporaryDirectory() as workdir:
            ctx, res = run_main_path(dataclasses.replace(full, n_audio_layer=args.layers),
                                     args.calls, workdir)
            stamp("phase 4a")
            variants = run_attention_variants(ctx, VARIANT_CALLS)
            stamp("phase 4f")
            text = run_audio_to_text(ctx, dec_cfg, TEXT_REQUESTS, args.new_tokens)
            stamp("phase 4b")
            capi.whisper_free(ctx)
            torch.cuda.empty_cache()
            ctx8, enc8 = run_quant_encode(
                res["path"], dataclasses.replace(full, n_audio_layer=args.layers), "q8_0",
                QUANT_CALLS, workdir)
            stamp("phase 4c (q8_0)")
            text8 = run_quant_text(ctx8, dec_cfg, "q8_0", args.new_tokens)
            stamp("phase 4d (q8_0)")
            int8_runs = run_int8_paths(ctx8, dec_cfg, args.new_tokens)
            stamp("phase 4e")
            capi.whisper_free(ctx8)
            ctx4, enc4 = run_quant_encode(
                res["path"] if args.q4_layers == args.layers else None,
                dataclasses.replace(full, n_audio_layer=args.q4_layers), "q4_0",
                QUANT_CALLS, workdir)
            stamp("phase 4c (q4_0)")
            text4 = run_quant_text(ctx4, dec_cfg, "q4_0", args.new_tokens)
            stamp("phase 4d (q4_0)")
            capi.whisper_free(ctx4)
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
    for name, v in variants.items():
        log(f"summary attention variant {name}: {v['ms']:.3f} ms per encode (median), "
            f"device busy {v['busy_ms']} ms of a profiled call, embedding cos {v['cos']:.6f}")
    for fmt, enc, txt in (("q8_0", enc8, text8), ("q4_0", enc4, text4)):
        log(f"summary {fmt}: quantized whisper_full steady {enc['steady_ms']:.3f} ms per "
            f"30 s clip (dq16: per-call {json.dumps([round(v, 3) for v in enc['dq16']['per_call_ms']])}, "
            f"device busy {enc['dq16']['busy_ms']} ms); {txt['block_gb']:.2f} GB of blocks "
            "per decode step")
        for name, c in txt.items():
            if isinstance(c, dict):
                r = c["run"]
                prof = r["profile"] or {}
                log(f"summary {fmt} ({name}): prefill {r['prefill_ms']:.3f} ms, decode "
                    f"{r['decode_ms_per_token']:.3f} ms per token over {r['tokens']} tokens, "
                    f"wall {r['wall_ms']:.1f} ms, device busy "
                    f"{100 * prof.get('busy_share', float('nan')):.1f} % of a profiled call, "
                    f"peak {r['peak_gib']:.2f} GiB")
    for name, c in int8_runs.items():
        r, prof = c["run"], c["run"]["profile"] or {}
        log(f"summary int8 paths ({name}): " + (
            f"prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_token']:.3f} ms per "
            f"token over {r['tokens']} tokens, " if name != "encode" else
            f"encode {r['encode_ms']:.3f} ms, ") + f"wall {r['wall_ms']:.1f} ms, device busy "
            f"{100 * prof.get('busy_share', float('nan')):.1f} % of a profiled call, peak "
            f"{r['peak_gib']:.2f} GiB")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
