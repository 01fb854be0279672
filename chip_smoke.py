#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qwen2_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers 32] [--calls 12] [--dec-layers 28]
                          [--new-tokens 32] [--q4-layers 32] [--kernels-only]

(``--layers 4 --calls 2 --dec-layers 2 --new-tokens 8 --q4-layers 4`` is a
quick rehearsal.) Phases, each of which must pass (any failure exits non-zero
before the result lines are printed):
1. build every CUDA kernel from qwen2_audio_tpu_torch/csrc with nvcc
   (sm_90a), in parallel, and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with stated tolerances (the decode kernels over a
   cache filled with NaN past each stream's position), and time kernel,
   plain version and (where one exists) the one-call library equivalent;
   the four dequantizing-matmul entries at M = 1, 7, 752 and 1500 over the
   decoder's, the lm_head's and the encoder's K x N, in both modes, bf16
   and float32 x, q8_0, symmetric q4_0, q4_1 (mins) and q6_K (group 16),
   and at every one of those cases the panel entry of the same weight in
   contiguous column panels, bit-equal to the strided entry; the five
   one-launch SwiGLU entries at the decoder's width (K = D = 3584,
   I = 18944) at M = 1, 7, 64, both modes, bf16 and float32 x, over q8_0,
   q6_K, q5_1 (mins), symmetric q4_0 and q4_1 blocks, the split schema
   bit-equal to the fused one, two runs bit-equal, M = 65 refused; the
   exact-integer group matmul: the q8_1 quantizing kernel bit-equal to its
   plain version (M = 1, 7, 752, 1500, bf16 and float32 x, ties and all-zero
   groups), then its three entries (flat int8 values, stacked int8 values
   or nibble bytes, stacked int32 words) at M = 1, 7, 752, 1500 over the
   decoder's, the lm_head's and the encoder's K x N, q8_0, symmetric q4_0 as
   bytes and as words, q4_1 and q5_1 with mins, the flat entry bit-equal to
   the stacked one and the words to the bytes with off 8, two runs
   bit-equal;
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
      against the prefills and decoder forwards the runs report, the
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
      against the q4_0 request in mode "int8").
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
as in a causal prefill's first rows;
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
PARITY_ATOL = 2e-3
MAIN_COS_MIN = 0.99
DEC_PARITY_PREFILL, DEC_PARITY_STEPS = 160, 8
TEXT_REQUESTS = 1     # audio -> text requests over the bf16 cache (+1 over int8)
QMM_ATOL_F32 = 1e-4   # of max|plain|
QMM_TOL_BF16 = (2.0 ** -8, 2.0 ** -7)   # (atol of max|plain|, rtol)
QUANT_CALLS = 6       # whisper_full calls of each quantized encode path
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
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]: {line.strip()}")
    return secs


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #

def check_mel(device, n_mels: int = 128, seconds: float = 30.0) -> dict:
    import math

    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.audio.mel import normalize, pad_signal
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames, mel_frames_plain, mel_tables

    padded, n_len, _, n_content = pad_signal(noisy_tone(seconds, seed=1))
    filters = mel_filterbank(n_mels)
    tables = mel_tables(filters, device)
    x = torch.from_numpy(padded).to(device)
    got = mel_frames(x, tables, n_content)
    want = mel_frames_plain(x, tables, n_content)
    err = (normalize(got, n_len) - normalize(want, n_len)).abs().max().item()
    log(f"mel: frames={n_content} n_mel={n_mels} max_abs_err={err:.3e} "
        f"(normalised, tol {MEL_ATOL}), raw log10 err="
        f"{(got - want).abs().max().item():.3e}")
    require(err <= MEL_ATOL, f"mel kernel disagrees with its plain version: {err}")
    # Least work of the function, not of the kernel's design: a 400-point
    # real FFT (2.5 N log2 N), the window, the power, the filterbank's
    # nonzeros (each bin falls in at most two triangles) and the log, per
    # frame; bytes are the signal and the filterbank in, the frames out.
    nnz = int(np.count_nonzero(filters))
    flops = n_content * (2.5 * 400 * math.log2(400) + 400 + 3 * 201 + 2 * nnz + n_mels)
    nbytes = 4 * (x.numel() + filters.size + n_content * n_mels)
    b_ms, b_by = bound(flops, nbytes, PEAK_F32)
    design = n_content * 400 * 402 * 2 + n_content * 201 * n_mels * 2
    log(f"mel: bound counts {flops / 1e6:.1f} MFLOP (rFFT + {nnz} filterbank "
        f"nonzeros) and {nbytes / 1e6:.2f} MB; the kernel's dense-DFT design does "
        f"{design / 1e9:.3f} GFLOP ({design / PEAK_F32 * 1e3:.4f} ms at the f32 peak)")
    return {"name": "mel_log_frames", "route": "cuda",
            "source": "qwen2_audio_tpu_torch/csrc/mel.cu",
            "replaces": "qwen2_audio_tpu/ops/mel_kernel.py:48",
            "max_abs_err": err,
            "ms": time_ms(lambda: mel_frames(x, tables, n_content)),
            "plain_ms": time_ms(lambda: mel_frames_plain(x, tables, n_content)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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
                "ms": time_ms(lambda: attention_single(q, k, v)),
                "plain_ms": time_ms(lambda: attention_single_plain(q, k, v), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, scale=1.0)),
            }
            log(f"attention {tname} at the encoder shape: " + json.dumps(
                {k_: main[tname][k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")}))
    return main["bfloat16"], main["float32"]


def _held(got, want, tname: str, what: str, p_abs_v=None) -> tuple[float, float]:
    """Max abs error and the share of the elementwise tolerance it uses;
    fails unless the kernel's output is finite and within tolerance.
    ``p_abs_v``: the plain attention of |V|, for the causal kernel's bf16
    p-rounding term."""
    import torch
    diff = (got.float() - want.float()).abs()
    atol, rtol = ATTN_TOL[tname]
    tol = atol + rtol * want.float().abs()
    extra = ""
    if tname == "bfloat16" and p_abs_v is not None:
        tol = tol + P_ROUND * p_abs_v.float()
        extra = f" + {P_ROUND:.3g} * P|V|"
    used = (diff / tol).max().item()
    log(f"{what}: max_abs_err={diff.max().item():.3e}, {used:.3f} of the "
        f"tolerance (atol {atol} + rtol {rtol:.3g} * |plain|{extra})")
    require(bool(torch.isfinite(got).all()), f"{what}: kernel output not finite")
    require(used <= 1.0, f"{what}: kernel disagrees with its plain version "
            f"({used:.3f} of the tolerance)")
    return diff.max().item(), used


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
    ]


def check_causal(device, cases=None) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops.flash_attention import (attention_causal,
                                                           attention_causal_plain)
    main = {}
    for i, (dtype, B, Hq, Hkv, T, d, kv_valid) in enumerate(cases or _causal_cases()):
        q, k, v = _causal_case(device, dtype, B, Hq, Hkv, T, d, seed=30 + i)
        scale = d ** -0.5
        got = attention_causal(q, k, v, scale, kv_valid)
        want = attention_causal_plain(q, k, v, scale, kv_valid)
        tname = str(dtype).removeprefix("torch.")
        err, _ = _held(got, want, tname, f"causal {tname} B={B} Hq={Hq} Hkv={Hkv} "
                       f"T={T} d={d} kv_valid={kv_valid}",
                       attention_causal_plain(q, k, v.abs(), scale, kv_valid))
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
            "ms": time_ms(lambda: attention_causal(q, k, v, scale, kv_valid)),
            "plain_ms": time_ms(lambda: attention_causal_plain(q, k, v, scale, kv_valid),
                                iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, scale=scale, enable_gqa=True)),
        }
        log(f"causal {tname} at the prefill shape: " + json.dumps(
            {k_: main[tname][k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")}))
    return main["bfloat16"], main["float32"]


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
    spread = [17, 63, 64, 783]   # first chunk, both sides of a chunk edge, S - 1
    return [  # (q dtype, cache dtype, B, S, positions); first of each kernel: main
        (bf, bf, 1, 784, [783]), (bf, i8, 1, 784, [783]),
        (f32, f32, 1, 784, [783]), (f32, bf, 1, 784, [783]), (f32, i8, 1, 784, [783]),
        (bf, bf, 4, 784, spread), (f32, f32, 4, 784, spread), (bf, i8, 4, 784, spread),
        (bf, bf, 1, 8192, [8191]), (bf, i8, 1, 8192, [8191]),
    ]


def check_decode(device, cases=None) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    main = {}
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
        err, _ = _held(got, want, tname, f"decode q {tname} cache "
                       f"{str(kvdt).removeprefix('torch.')} B={B} S={S} pos={pos}")
        name = "flash_decode_quant" if quant else "flash_decode"
        if name in main:
            continue
        Hq, Hkv = q.shape[1], cache[0].shape[2]
        n = sum(p + 1 for p in pos)   # cache rows the function must read
        nbytes = (2 * n * Hkv * d * cache[0].element_size() + 2 * q.numel() * q.element_size()
                  + (2 * n * Hkv * 4 if quant else 0))
        b_ms, b_by = bound(4 * Hq * d * n, nbytes, PEAK_BF16 if qdt == torch.bfloat16 else PEAK_F32)
        lib = None
        if not quant:
            q4 = q[:, :, None]
            kp, vp = (c[:, :pos[0] + 1].transpose(1, 2) for c in cache)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q4, kp, vp, scale=scale, enable_gqa=True))
        main[name] = {
            "name": name, "route": "cuda",
            "source": "qwen2_audio_tpu_torch/csrc/flash_decode.cu",
            "replaces": "qwen2_audio_tpu/ops/flash_decode.py:43",
            "max_abs_err": err,
            "ms": time_ms(lambda: kern(q, *cache, posv, sm_scale=scale), iters=50),
            "plain_ms": time_ms(lambda: plain(q, *cache, posv, sm_scale=scale)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        }
        log(f"{name} at the main path's last step: " + json.dumps(
            {k_: main[name][k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms")}))
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
            panels[wname] = qm.panelize_weight(qw)
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
        # the entry's time beside its bound, its plain version and one
        # torch.matmul on the dequantized weight in x's type
        nbytes = (ql.numel() + scl.numel() * scl.element_size()
                  + (x.numel() + M * N) * x.element_size())
        b_ms, b_by = bound(2.0 * M * K * N, nbytes, PEAK_BF16 if fast else PEAK_F32)
        dense = qm.block_weight(ql, scl, packed=packed, off=off).to(dtype)
        big = K * N > 1e8
        t = {"ms": time_ms(lambda: entry(x, q, sc, *li, **kw), iters=10 if M > 8 else 50),
             "plain_ms": time_ms(lambda: plain(x, ql, scl, **kw), iters=3 if big else 10,
                                 warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(lambda: x @ dense, iters=10)}
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
            pt = {**t, "ms": time_ms(lambda: pentry(x, pq, psc, *li, **kw), iters=50),
                  "plain_ms": time_ms(lambda: pplain(x, pl_, psl, **kw), iters=3, warmup=1)}
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
        for ci, (M, dtype, fast) in enumerate(
                (M, dtype, fast) for M in (1, 7, 64) for dtype in (bf, f32)
                for fast in (True, False)):
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

            t = {"ms": time_ms(lambda: entry(x, *args, li, fast=True), iters=50),
                 "plain_ms": time_ms(lambda: fm.fused_mlp_plain(
                     x, g_l, u_l, d_l, packed=packed, fast=True), iters=3, warmup=1),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": time_ms(lambda: (F.silu(x @ wg) * (x @ wu)) @ wd, iters=20),
                 "two_launch_ms": time_ms(unfused, iters=50)}
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
        log(f"fused MLP {fmt}: 12 cases, worst {worst:.3f} of the tolerance")
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
    """The decoder at full width, float32, with q8_0 weights (layers and
    lm_head) and with packed symmetric q4_0 layer weights (the lm_head
    dense), all from the ggml quantizers. Exact mode: a T0-position prefill
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
                dense, ttype, quantize_lm_head=head))
            log(f"quantized decoder parity {fmt}: {L} layers{' + lm_head' if head else ''} "
                f"quantized on the host in {time.perf_counter() - t0:.1f} s, form "
                f"{payload_form(cpu_params['layers']['qkv'])}")
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


def _quant_entries() -> tuple:
    """Every entry of the quantized-weight kernels: dequantizing (strided
    and panel), one-launch SwiGLU, exact-integer group matmul."""
    from qwen2_audio_tpu_torch.ops import fused_mlp, quant_matmul, quant_matmul_int8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b
    return (quant_matmul.ENTRIES + fused_mlp.ENTRIES + quant_matmul_int8.ENTRIES
            + quant_matmul_q4b.ENTRIES)


def _launch_counters():
    from qwen2_audio_tpu_torch.ops.flash_attention import attention_causal, attention_single
    from qwen2_audio_tpu_torch.ops.flash_decode import flash_decode, flash_decode_quant
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames
    return {"mel_log_frames": mel_frames, "attention_single": attention_single,
            "attention_causal": attention_causal, "flash_decode": flash_decode,
            "flash_decode_quant": flash_decode_quant,
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
    return {"launches": launches, "runs": runs, "peak_gib": peak,
            "prefill_ms": statistics.median(r["prefill_ms"] for r in bf),
            "decode_ms_per_token": statistics.median(r["decode_ms_per_token"] for r in bf)}


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
    return ctx, {"launches": launches, "per_call_ms": per_call,
                 "steady_ms": statistics.median(steady)}


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
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp
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
    # (name, panelize arguments or None, the one-launch SwiGLU's switch, new tokens)
    configs = {
        "q8_0": [("per-projection MLP", None, False, new_tokens),
                 ("one-launch SwiGLU", None, True, new_tokens),
                 ("panelized", {}, True, min(PANEL_TOKENS, new_tokens))],
        "q4_0": [("one-launch SwiGLU", None, True, new_tokens),
                 ("panelized", {}, True, new_tokens),
                 ("panelized, gate_up strided", {"skip_gate_up": True}, True, new_tokens)],
    }[fmt]
    out, first, first_logits = {}, None, None
    try:
        for name, panel, fused_on, n_new in configs:
            what = f"quant text {fmt} ({name})"
            set_fused_mlp(fused_on)
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
            require((n_fused > 0) == (name in ("one-launch SwiGLU",
                                               "panelized, gate_up strided")),
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
                upto = n_tok if split is None else split
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


def profile_call(fn, what: str) -> dict | None:
    """One call under torch.profiler: device time by kernel group and the
    device's busy share of the call's wall time (None where the profiler
    reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
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
                 or ("attn_bf16_kernel" in name and "true" in name)
                 else "attention_single" if "attn_" in name
                 else "flash_decode" if "decode_kernel" in name
                 else "mel_log_frames" if "mel_log_frames" in name
                 else "quant_matmul" if "qmm_" in name
                 else "fused_mlp" if "swiglu_kernel" in name
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
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="encoder depth of the main-path checkpoint (full: 32)")
    ap.add_argument("--calls", type=int, default=12,
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
        mel = check_mel(device)
        attn_bf16, attn_f32 = check_attention(device)
        causal_bf16, causal_f32 = check_causal(device)
        decode, decode_q8 = check_decode(device)
        qmm = check_quant_matmul(device)
        fused = check_fused_mlp(device)
        int8 = check_int8_matmul(device)
        if args.kernels_only:
            log(f"kernels only: phases 1 and 2 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        full = WHISPER_PRESETS["qwen2-audio"]
        two = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
        log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
        check_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_quant_encoder_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_decoder_parity(device, two)
        check_quant_decoder_parity(device, two)
        log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
        dec_cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=args.dec_layers)
        with tempfile.TemporaryDirectory() as workdir:
            ctx, res = run_main_path(dataclasses.replace(full, n_audio_layer=args.layers),
                                     args.calls, workdir)
            text = run_audio_to_text(ctx, dec_cfg, TEXT_REQUESTS, args.new_tokens)
            capi.whisper_free(ctx)
            torch.cuda.empty_cache()
            ctx8, enc8 = run_quant_encode(
                res["path"], dataclasses.replace(full, n_audio_layer=args.layers), "q8_0",
                QUANT_CALLS, workdir)
            text8 = run_quant_text(ctx8, dec_cfg, "q8_0", args.new_tokens)
            log(f"phase 4d (q8_0) done at {time.perf_counter() - t_start:.1f} s")
            int8_runs = run_int8_paths(ctx8, dec_cfg, args.new_tokens)
            log(f"phase 4e done at {time.perf_counter() - t_start:.1f} s")
            capi.whisper_free(ctx8)
            ctx4, enc4 = run_quant_encode(
                res["path"] if args.q4_layers == args.layers else None,
                dataclasses.replace(full, n_audio_layer=args.q4_layers), "q4_0",
                QUANT_CALLS, workdir)
            text4 = run_quant_text(ctx4, dec_cfg, "q4_0", args.new_tokens)
            capi.whisper_free(ctx4)
    except Exception as e:  # every phase failure ends the run with no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for k in (mel, attn_bf16):
        k["launches"] = res["launches"][k["name"]]
    for k in (causal_bf16, decode, decode_q8):
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
    kernels = [mel, attn_bf16, causal_bf16, decode, decode_q8,
               qmm["quant_matmul"], qmm["quant_matmul_stacked"],
               qmm["quant_matmul4_stacked"], qmm["quant_matmul4"],
               qmm["quant_matmul_panel"], qmm["quant_matmul_panel_stacked"],
               qmm["quant_matmul_panel4"], qmm["quant_matmul_panel4_stacked"], fused,
               int8["quant_matmul_int8"], int8["quant_matmul_int8_stacked"],
               int8["quant_matmul_q4b_stacked"]]
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
    for fmt, enc, txt in (("q8_0", enc8, text8), ("q4_0", enc4, text4)):
        log(f"summary {fmt}: quantized whisper_full steady {enc['steady_ms']:.3f} ms per "
            f"30 s clip; {txt['block_gb']:.2f} GB of blocks per decode step")
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
