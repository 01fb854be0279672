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
   bit-equal to the fused one, two runs bit-equal, M = 65 refused;
3. parity at full width and depth 2, card against CPU in float32: the
   encoder (embedding, dense and from a q8_0 checkpoint), and the Qwen2
   decoder (a 160-position prefill and 8 greedy steps: the same tokens,
   logits within tolerance), dense and with q8_0 and q4_0 weights from the
   ggml quantizers (a 16-position prefill and 4 steps, exact mode), each
   with the one-launch SwiGLU off, and once more with it on (q8_0) and
   with the decoder panelized (q4_0);
4. the main path at full width, two paths, each with the launch counters
   set to 0 just before it and read just after:
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
      is derived from the prefills and decoder forwards the run reports.
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
2-layer float32 card vs CPU 2e-3 (embedding and decoder logits); the
bf16 kernel paths against the plain-attention paths on the card cosine
0.99, the quantized paths against their dense counterparts the same.
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
FUSED_FLIPS = 2       # bf16 roundings of gated that may fall the other way, per output
PANEL_TOKENS = 8      # new tokens of the q8_0 panelized request


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



def check_quant_encoder_parity(device, hp) -> float:
    """The encoder with q8_0 layer weights from the ggml quantizer, exact
    mode, float32: the card's kernels against the CPU's plain versions."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.models.encoder import (encoder_forward, fuse_encoder_qkv,
                                                      random_encoder_params)
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import quantize_encoder_params

    params = fuse_encoder_qkv(quantize_encoder_params(
        random_encoder_params(np.random.default_rng(5), hp), GGMLType.Q8_0))
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32))
    opts = dict(gelu_approximate=True, use_flash=True, compute_dtype=torch.float32)
    set_group_matmul_mode("dequant")
    try:
        want = encoder_forward(params, mel, hp, **opts)[0]
        got = encoder_forward(_tree_to(params, device), mel.to(device), hp, **opts)[0].cpu()
    finally:
        set_group_matmul_mode(None)
    err = (got - want).abs().max().item()
    log(f"quantized encoder parity (q8_0, exact mode) depth {hp.n_audio_layer} width "
        f"{hp.n_audio_state}: embedding max_abs_err={err:.3e} (tol {PARITY_ATOL})")
    require(err <= PARITY_ATOL, f"quantized encoder parity: card and CPU differ by {err}")
    return err


def check_quant_decoder_parity(device, cfg, T0: int = QDEC_PARITY_PREFILL,
                               steps: int = QDEC_PARITY_STEPS) -> dict:
    """The decoder at full width with q8_0 and with packed symmetric q4_0
    weights from the ggml quantizers (the q4_0 lm_head stays dense to hold
    the run's length), exact mode, float32: a T0-position prefill and
    ``steps`` greedy steps on the CPU (plain versions, the per-projection
    MLP) and on the card (kernels), there twice: with the one-launch SwiGLU
    off, and in the decode-tuned storage (q8_0: the SwiGLU on; q4_0:
    panelized). Without mins the exact mode's results differ between those
    storages by the order of float32 sums only, so one CPU run holds both:
    the same tokens, logits within PARITY_ATOL."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (fuse_decoder_params,
                                                            panelize_decoder_params,
                                                            random_decoder_params)
    from qwen2_audio_tpu_torch.ops.fused_mlp import ENTRIES as FUSED_ENTRIES
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp, set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import payload_form, quantize_decoder_params
    from qwen2_audio_tpu_torch.runtime.generate import generate_on_device

    dense = _tree_to(random_decoder_params(
        torch.Generator(device=device).manual_seed(2), cfg, dtype=torch.float32), "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, T0, cfg.hidden_size)).astype(np.float32))

    def run(params, dev):
        res = generate_on_device(params, cfg, x.to(dev), max_new_tokens=steps,
                                 eos_token_id=cfg.vocab_size - 1,
                                 cache_max_ctx=T0 + steps, cache_dtype=torch.float32)
        return [r.cpu() if isinstance(r, torch.Tensor) else r for r in res]

    errs = {}
    set_group_matmul_mode("dequant")
    try:
        for fmt, ttype, head in (("q8_0", GGMLType.Q8_0, True), ("q4_0", GGMLType.Q4_0, False)):
            t0 = time.perf_counter()
            cpu_params = fuse_decoder_params(quantize_decoder_params(
                dense, ttype, quantize_lm_head=head))
            log(f"quantized decoder parity {fmt}: {cfg.num_hidden_layers} layers"
                f"{' + lm_head' if head else ''} quantized on the host in "
                f"{time.perf_counter() - t0:.1f} s, form "
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
                    f"{cfg.num_hidden_layers} width {cfg.hidden_size} f32 exact mode: card "
                    f"prefill {T0} + {cn} steps in {time.perf_counter() - t0:.1f} s, "
                    f"{n_fused} fused launches; tokens card {ct[0, :cn].tolist()} cpu "
                    f"{ht[0, :hn].tolist()}; first and final logits max_abs_err={err:.3e} "
                    f"(tol {PARITY_ATOL})")
                require(cn == hn == steps and torch.equal(ct, ht),
                        f"quantized decoder parity {fmt} ({which}): tokens differ")
                require(err <= PARITY_ATOL, f"quantized decoder parity {fmt} ({which}): "
                        f"card and CPU logits differ by {err}")
                # one per layer and decode forward, and at a prefill of <= 64 rows
                want_fused = cfg.num_hidden_layers * (steps - 1 + (T0 <= 64)) \
                    if which == "one-launch SwiGLU" else 0
                require(n_fused == want_fused, f"quantized decoder parity {fmt} ({which}): "
                        f"{n_fused} fused launches, want {want_fused}")
                errs[f"{fmt} {which}"] = err
            del cpu_params, card, params
            torch.cuda.empty_cache()
    finally:
        set_group_matmul_mode(None)
        set_fused_mlp(None)
    return errs


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


def _launch_counters():
    from qwen2_audio_tpu_torch.ops.flash_attention import attention_causal, attention_single
    from qwen2_audio_tpu_torch.ops.flash_decode import flash_decode, flash_decode_quant
    from qwen2_audio_tpu_torch.ops.fused_mlp import ENTRIES as FUSED_ENTRIES
    from qwen2_audio_tpu_torch.ops.mel_kernel import mel_frames
    from qwen2_audio_tpu_torch.ops.quant_matmul import ENTRIES
    return {"mel_log_frames": mel_frames, "attention_single": attention_single,
            "attention_causal": attention_causal, "flash_decode": flash_decode,
            "flash_decode_quant": flash_decode_quant,
            **{e.__name__: e for e in ENTRIES + FUSED_ENTRIES}}


def _cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def teacher_forced_logits(bundle, st, params=None, flash: bool = True,
                          fused: bool | None = None) -> list:
    """The request's prefill and tokens through the decoder on the card, one
    (V,) logits row per step: over ``params`` (default: the bundle's), the
    kernel or the plain attention, the one-launch SwiGLU as it is set or as
    ``fused`` says."""
    import torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.ops.linear import fused_mlp_enabled, set_fused_mlp
    from qwen2_audio_tpu_torch.runtime.decoding import _prefill_embeds

    params = bundle.params if params is None else params
    prefill = _prefill_embeds(bundle, bundle.project_audio(st.embd_enc), [])
    T0, toks = prefill.shape[1], st.result_tokens
    was = fused_mlp_enabled()
    if fused is not None:
        set_fused_mlp(fused)
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
    require(launches[flat] == 4 * hp.n_audio_layer * calls,
            f"quant encode {fmt}: {flat} launched {launches[flat]} times, want 4 x "
            f"{hp.n_audio_layer} layers x {calls} calls")
    require(sum(launches[e] for e in ("quant_matmul", "quant_matmul4",
                                      "quant_matmul_stacked", "quant_matmul4_stacked"))
            == launches[flat], f"quant encode {fmt}: another entry was launched")
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
                            prefill_rows: int) -> dict:
    """Launches of every dequantizing-matmul and fused-MLP entry that
    ``prefills`` requests with ``decodes`` decode forwards in all must make,
    from the weight forms of the encoder and the decoder: one stacked launch
    per projection, layer and forward; one fused launch per layer and decode
    forward in place of gate_up's and down's where both are strided, the
    switch is on and the forward has at most 64 rows; one flat launch per
    forward for the lm_head (last position only) and four per encoder layer
    and request."""
    from qwen2_audio_tpu_torch.ops.fused_mlp import MAX_M

    def entry(e: dict, stacked: bool) -> str:
        name = "quant_matmul" + ("_panel" if "qs_p" in e or "qs4_p" in e else "")
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
    one_launch = fused_on and strided and set(gu) == set(dn)
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


def run_quant_text(ctx, cfg, fmt: str, new_tokens: int) -> dict:
    """Behind the quantized encoder of ``ctx``, attach a decoder whose
    linears and lm_head are random ``fmt`` blocks made on the card (seed 0)
    and answer one request per storage configuration on one clip through
    capi.whisper_full, each with the launch counters set to 0 just before
    and read just after, then one more timed request each in the reverse
    order. Returns the configurations' results by name."""
    import numpy as np
    import torch
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder, panelize_decoder_params
    from qwen2_audio_tpu_torch.ops.fused_mlp import ENTRIES as FUSED_ENTRIES
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp
    from qwen2_audio_tpu_torch.ops.quant_matmul import ENTRIES as QMM_ENTRIES
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
    counters = _launch_counters()
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
    out, first, first_logits, again = {}, None, None, []
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
            params = capi.whisper_full_default_params()
            params.max_new_tokens = n_new
            params.temperature_inc = 0.0
            params.print_progress = False

            for c in counters.values():
                c.launches = 0
            torch.cuda.reset_peak_memory_stats()
            st = ctx.init_state()
            t1 = time.perf_counter()
            rc = capi.whisper_full_with_state(ctx, st, params, clip)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            launches = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            require(rc == 0, f"{what}: whisper_full returned {rc}")
            tm, n_tok = st.timings, len(st.result_tokens)
            run = {"wall_ms": wall, "encode_ms": tm.t_encode_us / 1e3,
                   "prefill_ms": tm.t_prompt_us / 1e3, "prefill_positions": tm.n_prompt,
                   "tokens": n_tok, "forwards": st.n_decode_forwards,
                   "decode_ms_per_token": tm.t_decode_us / 1e3 / max(n_tok, 1),
                   "peak_gib": peak}
            require(n_tok > 0 and len(st.segments) == 1, f"{what}: no tokens")
            require(bool(np.isfinite(st.logits).all()), f"{what}: logits not finite")
            log(f"{what}: forms {json.dumps(forms)}; request {json.dumps(run)}; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}; text "
                f"{capi.whisper_full_get_segment_text_from_state(st, 0)[:60]!r}")

            want = expected_quant_launches(ctx, bundle, fused_on, 1, st.n_decode_forwards,
                                           tm.n_prompt)
            for e in QMM_ENTRIES + FUSED_ENTRIES:
                require(launches[e.__name__] == want.get(e.__name__, 0),
                        f"{what}: {e.__name__} launched {launches[e.__name__]} times, want "
                        f"{want.get(e.__name__, 0)} for 1 prefill of {tm.n_prompt} rows and "
                        f"{st.n_decode_forwards} decode forwards")
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
            profile_call(lambda: capi.whisper_full(ctx, params, clip),
                         f"whisper_full (audio -> text, {fmt}, {name})")
            out[name] = {"launches": launches, "run": run, "forms": forms}
            again.append((name, bundle.decoder, fused_on, params, st.result_tokens))
        # the host sets the step time and drifts within a run: one more
        # request per configuration, in the reverse order, to read the
        # configurations against each other
        for name, decoder, fused_on, params, tokens in reversed(again):
            set_fused_mlp(fused_on)
            bundle.decoder = decoder
            st = ctx.init_state()
            t1 = time.perf_counter()
            rc = capi.whisper_full_with_state(ctx, st, params, clip)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            require(rc == 0 and len(st.result_tokens) == len(tokens),
                    f"quant text {fmt} ({name}): the second request returned {rc} with "
                    f"{len(st.result_tokens)} tokens")
            tm = st.timings
            out[name]["run2"] = {
                "wall_ms": wall, "prefill_ms": tm.t_prompt_us / 1e3,
                "decode_ms_per_token": tm.t_decode_us / 1e3 / len(tokens),
                "same_tokens": st.result_tokens == tokens}
            log(f"quant text {fmt} ({name}): second request, reverse order "
                f"{json.dumps(out[name]['run2'])}")
    finally:
        set_fused_mlp(None)
    ctx.decoder = None
    del bundle, strided, again, decoder
    torch.cuda.empty_cache()
    out["block_gb"] = q_bytes / 1e9
    return out


def profile_call(fn, what: str) -> None:
    """One call under torch.profiler: device time by kernel group and the
    device's busy share of the call's wall time."""
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
        group = ("attention_causal" if "attn_f32_causal" in name
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
        return
    log(f"profile: one {what} call, wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), by group "
        + json.dumps({k: round(v, 4) for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1])}))


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
        if args.kernels_only:
            log(f"kernels only: phases 1 and 2 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        full = WHISPER_PRESETS["qwen2-audio"]
        two = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
        check_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_quant_encoder_parity(device, dataclasses.replace(full, n_audio_layer=2))
        check_decoder_parity(device, two)
        check_quant_decoder_parity(device, two)
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
    kernels = [mel, attn_bf16, causal_bf16, decode, decode_q8,
               qmm["quant_matmul"], qmm["quant_matmul_stacked"],
               qmm["quant_matmul4_stacked"], qmm["quant_matmul4"],
               qmm["quant_matmul_panel"], qmm["quant_matmul_panel_stacked"],
               qmm["quant_matmul_panel4"], qmm["quant_matmul_panel4_stacked"], fused]
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
                log(f"summary {fmt} ({name}): prefill {r['prefill_ms']:.3f} ms, decode "
                    f"{r['decode_ms_per_token']:.3f} ms per token over {r['tokens']} tokens "
                    f"(second request {c['run2']['decode_ms_per_token']:.3f}), "
                    f"wall {r['wall_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
