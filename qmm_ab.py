"""Time the quantized matmul kernels of csrc/quant_matmul.cu (dequantizing)
and csrc/quant_matmul_int8.cu (exact-integer, mode "int8") and the bf16
attention kernels of csrc/attention_single.cu at the shapes of the encode
path, the decoder prefill and a decode step, for one checkout of the port,
and print a digest of every output. Run it on two checkouts on the same
card, in alternating order, to compare their times and their bits.

    python3 qmm_ab.py [--root DIR] [--label NAME] [--out FILE] [--decode-only]
                      [--attention-only] [--decode-weights] [--mel-only] [--int8-only]
                      [--int8-requests]
                      [--tiles-only]
                      [--tile-variants [all|bf16|int8]] [--ckpt FILE]

``--root`` is the checkout whose ``qwen2_audio_tpu_torch`` is imported and
built (default: the one holding this script). Weights are random q8_0 and
symmetric q4_0 blocks (``random_quant_linear``), x is bf16 and the kernels
run in fast mode, dq16 off, as the encoder and the bf16-mode decoder call
them; where the checkout takes ``dq16``, each shape is also timed with it.
The integer entries run on the same weights and x: q8_0 as int8 values,
q4_0 as nibble bytes ("int8") and as int32 words ("words"). Each case's
inputs come from its own seed, so that two checkouts see the same ones; its
line holds the SHA-256 (first 16 hex digits) of the output's bytes and the
largest |kernel - plain version|.
Each time is the median over 7 replays of a CUDA graph of 20 calls, by CUDA
events, divided by 20: device time, not the host's call rate. Per path the sum over its launches is printed: encode 32
layers x (qkv 1280 -> 3840, out 1280 -> 1280, fc1 1280 -> 5120, fc2 5120 ->
1280) at M = 1500; prefill 28 layers x (qkv 3584 -> 4608, o 3584 -> 3584,
gate_up 3584 -> 37888, down 18944 -> 3584) at M = 752; decode the same
at M = 1. The attention paths (``attention_paths``): "attention encode", 32
layers x the one-shot kernel at (B 1, 20 heads, T 1500, d 64) over views
into one fused QKV output ("attention encode lite" and "... nopad": the
lite and unpadded entries on the same views), and "attention prefill", 28
layers x the causal kernel at (B 1, 28 query heads on 4 KV heads, T 752, d
128); each beside one bf16 SDPA call (``sdpa_ms``); each also holds
``host_us``, the host's microseconds to enqueue one wrapper call, and
``c_us``, the same for the bare C entry (which encodes the tensor maps where
the checkout has them). ``--attention-only`` runs just these and the edges
(about a minute a checkout, the build included). "attention edges" holds,
for each of chip_smoke's bf16 tile edge cases (``_edge_cases``, its inputs
and seeds, NaN past kv_valid), the share of ``ATTN_TOL`` alone that the
one-shot kernel's largest distance from the plain version uses. The decode-step cache
attention (``decode_paths``): "attention decode" and "attention decode
int8", 28 layers x the bf16- or int8-cache kernel at (B 1, 28 query heads
on 4 KV heads, d 128, capacity 2048, pos 783) over 28 caches in turn, and
each cache type at S = 784, 2048 and 8192 alone and at the beam step's (B
5, capacity 784) and the 8-slot pool's (B 8, capacity 2048, positions
752-812) shapes, with bf16 SDPA beside the bf16 cache and, where the
checkout has ``decode_plan``, its splits and CTAs; "decode step, 2
layers": the device kernels (by the profiler) and host ms of one step of a
full-width 2-layer bf16 decoder over each cache. The log-mel kernel (``mel_paths``): ``mel_frames`` at a 30 s
clip (3002 frames, 128 mels) and at 1 s (102 frames, 80 mels) beside its
plain version, by graph replay, with ``host_us``; then "whisper_full", the
host ms per 30 s clip (median of the calls after the first), the mel's
``t_mel_us`` per call and the device busy ms of one profiled call (the mel
kernel's part beside it) of a random-weight F16 qwen2-audio checkpoint
(32 layers, written once to ``--ckpt`` and reused), loaded in bf16.
``--mel-only`` runs just these (about a minute a checkout, the build and
the checkpoint included). ``--decode-weights`` times only the M <= 8
weight-streaming kernels with cold weights (``decode_weights``): each
decoder projection as a 28-layer stack taken in turn, the lm_head, the
one-launch SwiGLU beside the two-launch path over the same weights, and
mode "int8" (and q4_0 words) on the same bytes. ``--int8-only`` times just
the exact-integer entries at the encode, prefill and decode shapes, each M >
8 case beside one ``torch.matmul`` on its dequantized bf16 weight
(``library_ms``; about a minute a checkout, the build included).
``--int8-requests`` times just mode "int8" end to end (``int8_requests``):
the 32-layer q8_0 encode and a request with an 8-layer q8_0 decoder behind
it, eight calls each in a row (every call's host ms, the warm median, one
profiled call's device ms). ``--tiles-only`` times just the
dequantizing entries (the M > 8 tile and, at M = 1, the streaming kernel
whose bits must not move) at the encode, prefill and decode shapes, each
M > 8 case beside one ``torch.matmul`` on its dequantized bf16 weight
(``library_ms``), and the lm_head (3584 -> 156032) at M = 64, a speculative
pool's verify, strided and in panels of 128 (bits compared): path "<fmt>
lm_head M=64", and then ``whisper_full`` per 30 s clip of the random
32-layer checkpoint (``--ckpt``) quantized to q8_0 and q4_0 and loaded with
its block weights kept, host ms and one profiled call's device busy ms
(about two minutes a checkout, the host's quantizing once a call
included: the quantized files are kept beside ``--ckpt``).
``--tile-variants [all|bf16|int8|decode|attention]`` splits the checkout's
M > 8 tiles, decode attention or bf16 attention tile by scratch variants of
their sources, each built with nvcc and swapped in for the checkout's
library, timed in turns (their outputs are wrong where a part is left out;
only "as_is" is held to the plain version): "decode" (``DECODE_VARIANTS``:
the products or the merge's tail left out) at B = 1, 5 and 8;
"attention" (``ATTENTION_VARIANTS``: the overlap, stages, ping-pong,
stagger, an FMA share of the exponentials) at the encode and prefill
shapes; "bf16", the dequantizing tile (``TILE_VARIANTS``: the products, the weight's conversion or x's loads left
out) at gate_up q8_0 M = 752, fc1 q8_0 M = 1500 and the lm_head q8_0 M =
64; "int8", the exact-integer tile (``INT8_VARIANTS``: the products, the
rescale, the weight's conversion left out, or all three; or x's loads) at
gate_up q8_0 and as q4_0 int32 words at M = 752 and fc1 q8_0 at M = 1500,
with the unit's rows forced at gate_up; "all" (the default) both. Prints
one JSON line and, with ``--out``, appends it there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile

from chip_smoke import ATTN_TOL, _edge_case, _edge_cases, gpu_line, host_us
from chip_smoke import graph_ms as time_ms

ENCODER = (32, 1500, ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)))
DECODER = (28, ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)))
ATT_ENCODE = (1, 20, 20, 1500, 64)     # (B, H, Hkv, T, d)
ATT_PREFILL = (1, 28, 4, 752, 128)


def c_entry(q, k, v, causal: bool):
    """The bare C entry of csrc/attention_single.cu on these bf16 inputs, its
    arguments made once: what a call costs the host below the wrapper (the
    tensor maps' encoding, where the checkout encodes them, and the launch)."""
    import torch

    from qwen2_audio_tpu_torch.ops import _build
    B, H, T, d = q.shape
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lib = _build.library("attention_single")
    fn = lib.qa_attention_causal if causal else lib.qa_attention_single
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], B, H, k.shape[1], T,
            k.shape[2], d, 1, d ** -0.5 if causal else 1.0, 0,
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--decode-only", action="store_true",
                    help="time only the decode-step cache attention")
    ap.add_argument("--attention-only", action="store_true",
                    help="time only the bf16 attention kernels and their edge shares")
    ap.add_argument("--decode-weights", action="store_true",
                    help="time only the M <= 8 weight-streaming kernels, cold")
    ap.add_argument("--mel-only", action="store_true",
                    help="time only the log-mel kernel and whisper_full per 30 s clip")
    ap.add_argument("--int8-only", action="store_true",
                    help="time only the exact-integer group matmul's paths")
    ap.add_argument("--int8-requests", action="store_true",
                    help="time only mode int8's q8_0 encode and request, warm")
    ap.add_argument("--tiles-only", action="store_true",
                    help="time only the dequantizing entries and the lm_head at M = 64")
    ap.add_argument("--tile-variants", nargs="?", const="all",
                    choices=("all", "bf16", "int8", "decode", "attention"),
                    help="time scratch variants of the M > 8 tiles (the dequantizing one, "
                         "bf16; the exact-integer one, int8), the decode attention (decode) "
                         "or the bf16 attention tile (attention); all of them by default")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "qmm_ab_encoder.bin"),
                    help="the whisper_full checkpoint, written if missing")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("qmm_ab: no CUDA device", file=sys.stderr)
        return 1
    import qwen2_audio_tpu_torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    from qwen2_audio_tpu_torch.ops import _build
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    here = os.path.dirname(os.path.abspath(qwen2_audio_tpu_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(args.root):
        raise RuntimeError(f"qmm_ab: imported {here}, not from {args.root}")
    _build.build_all()   # every kernel source at once, one nvcc each

    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as q4b
    device = torch.device("cuda", 0)
    shapes, paths = {}, {}

    def record(key: str, path: str, layers: int, out, want, t: dict) -> None:
        t["sha256"] = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                                     .tobytes()).hexdigest()[:16]
        t["max_abs_vs_plain"] = (out.float() - want.float()).abs().max().item()
        shapes[key] = t
        for k, suffix in (("ms", ""), ("dq16_ms", " dq16"), ("library_ms", " library"),
                          ("panel_ms", " panels")):
            if k in t and layers:
                paths[path + suffix] = paths.get(path + suffix, 0.0) + layers * t[k]

    if args.tile_variants:
        return emit(args, {"tile_variants": tile_variants(device, args.tile_variants)})
    if args.int8_requests:
        int8_requests(device, shapes, args.ckpt)
        return emit(args, {"shapes": shapes})
    if args.mel_only:
        mel_paths(device, record, shapes, args.ckpt)
        return emit(args, {"paths_ms": paths, "shapes": shapes})
    if args.decode_only:
        decode_paths(device, record, shapes, paths)
        return emit(args, {"paths_ms": paths, "shapes": shapes})
    if args.attention_only:
        attention_paths(device, record, 0)
        return emit(args, {"paths_ms": paths, "shapes": shapes,
                           "attention edges": edge_shares(device)})
    if args.decode_weights:
        decode_weights(device, record, shapes, paths)
        return emit(args, {"paths_ms": paths, "shapes": shapes})
    seed = 0
    for fmt in ("q8_0", "q4_0"):
        packed = fmt == "q4_0"
        kw = {"fast": True, **({"off": 8} if packed else {})}
        flat = qm.quant_matmul4 if packed else qm.quant_matmul
        stacked = qm.quant_matmul4_stacked if packed else qm.quant_matmul_stacked
        plain = qm.quant_matmul4_plain if packed else qm.quant_matmul_plain
        cases = [("encode", ENCODER[1], K, N, False, ENCODER[0]) for K, N in ENCODER[2]]
        cases += [(path, M, K, N, True, DECODER[0]) for path, M in (("prefill", 752),
                                                                   ("decode", 1))
                  for K, N in DECODER[1]]
        for path, M, K, N, is_stacked, layers in cases:
            seed += 1
            g = torch.Generator(device=device).manual_seed(seed)
            w = random_quant_linear(g, ((2,) if is_stacked else ()) + (K, N), fmt)
            q, sc = w["qs4" if packed else "qs"], w["scales"]
            x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
            li = (1,) if is_stacked else ()
            ql, scl = (q[1], sc[1]) if is_stacked else (q, sc)
            entry = stacked if is_stacked else flat
            key = f"{fmt} {path} M={M} K={K} N={N}"
            if not args.int8_only:
                t = {"ms": time_ms(lambda: entry(x, q, sc, *li, **kw))}
                try:
                    entry(x, q, sc, *li, dq16=True, **kw)
                except TypeError:
                    pass
                else:
                    t["dq16_ms"] = time_ms(lambda: entry(x, q, sc, *li, dq16=True, **kw))
                if args.tiles_only and M > 8:
                    dense = qm.block_weight(ql, scl, packed=packed,
                                            off=8 if packed else 0).to(torch.bfloat16)
                    t["library_ms"] = time_ms(lambda: x @ dense)
                    del dense
                record(key, f"{fmt} {path}", layers, entry(x, q, sc, *li, **kw),
                       plain(x, ql, scl, **kw), t)
            if args.tiles_only:
                del w, q, sc, x
                continue
            # the exact-integer group matmul (mode "int8"): q8_0 int8 values,
            # q4_0 as nibble bytes and as int32 words, a flat weight as a
            # one-layer stack where the flat entry takes int8 values only
            q3, sc3 = (q, sc) if is_stacked else (q[None], sc[None])
            lj = li[0] if is_stacked else 0
            if packed:
                forms = {"int8": (lambda: q8.quant_matmul_int8_stacked(x, q3, sc3, lj, off=8),
                                  lambda: q8.quant_matmul_int8_packed_plain(x, ql, scl, off=8))}
                words = q4b.pack_b32(q3)
                forms["words"] = (lambda: q4b.quant_matmul_q4b_stacked(x, words, sc3, lj),
                                  lambda: q4b.quant_matmul_q4b_plain(x, words[lj], scl))
            elif is_stacked:
                forms = {"int8": (lambda: q8.quant_matmul_int8_stacked(x, q, sc, 1),
                                  lambda: q8.quant_matmul_int8_plain(x, ql, scl))}
            else:
                forms = {"int8": (lambda: q8.quant_matmul_int8(x, q, sc),
                                  lambda: q8.quant_matmul_int8_plain(x, ql, scl))}
            lib_ms = None
            if args.int8_only and M > 8:   # one torch.matmul on the dequantized bf16 weight
                dense = qm.block_weight(ql, scl, packed=packed,
                                        off=8 if packed else 0).to(torch.bfloat16)
                lib_ms = time_ms(lambda: x @ dense)
                del dense
            for form, (run, ref) in forms.items():
                record(f"{key} {form}", f"{fmt} {path} {form}", layers, run(), ref(),
                       {"ms": time_ms(run), **({"library_ms": lib_ms} if lib_ms else {})})
            del w, q, sc, x, forms
        torch.cuda.empty_cache()
    if args.int8_only:
        return emit(args, {"paths_ms": paths, "shapes": shapes})
    if args.tiles_only:
        lm_head_rows(device, record)
        quant_encode_paths(shapes, args.ckpt)
        return emit(args, {"paths_ms": paths, "shapes": shapes})

    attention_paths(device, record, seed)
    decode_paths(device, record, shapes, paths)
    mel_paths(device, record, shapes, args.ckpt)
    return emit(args, {"paths_ms": paths, "shapes": shapes,
                       "attention edges": edge_shares(device)})


# Text edits of csrc/quant_matmul.cu that leave one part of the M > 8 tile
# (qmm_tile_kernel, which dequantizes in the consumers' registers) out.
_BF_WGMMA = ("          wgmma_bf16_rs_k<BM>(acc, a[k], xd + 2 * k, kt > t.kt0 || k > 0);",
              "          pin4(a[k]);")
_BF_CONVERT = ("          qt_convert<PACKED>(r, k, qt_scales(sr, k, cl, group, s_f16, dq16), "
                "zero, a[k]);", "          a[k][0] = r[k]; a[k][1] = r[k + 1]; a[k][2] = r[k] ^ 7u; "
                "a[k][3] = r[k + 1] ^ 7u;")
_BF_X = ("          mbar_expect_tx(&full[s], bytes);\n          tma_load_2d(xs + s * S::kX, "
          "&xmap, &full[s], kt * kQtK, t.m0);",
          "          mbar_expect_tx(&full[s], bytes - (kt > t.kt0 ? S::kX : 0));\n"
          "          if (kt == t.kt0) tma_load_2d(xs + s * S::kX, &xmap, &full[s], kt * kQtK, "
          "t.m0);")
TILE_VARIANTS = {
    "qmm_tile_kernel": {
        "no_wgmma": [_BF_WGMMA], "no_conversion": [_BF_CONVERT],
        "loads_only": [_BF_WGMMA, _BF_CONVERT], "x_once": [_BF_X]},
}


# Text edits of csrc/quant_matmul_int8.cu that leave one part of the M > 8
# tile (qmm8_tile_kernel, the weight as register A) out: the products, the
# rescale (its multiplies and fmas but one a piece; the sx loads stay), the
# weight's conversion, or all three; no TMA loads (the producer only arrives
# on each slot: shared memory holds no data), alone, with products only or
# with the rescale only.
_I8_WGMMA = ("    wgmma_f16_rs_k<N>(p, ag[0], b + 2 * (2 * j), 0);\n"
             "    wgmma_f16_rs_k<N>(p, ag[1], b + 2 * (2 * j + 1), 1);",
             "    (void)b;")
_I8_RESCALE = ("      c[o] = fmaf(p[k], __fmul_rn(x, sw.x), c[o]);\n"
               "      c[o + 2] = fmaf(p[k + 2], __fmul_rn(x, sw.y), c[o + 2]);",
               "      if (jj == 0 && b == 0) c[o] = fmaf(p[k], x, c[o]);")
_I8_CONVERT = ("    a_frag<FORM>(r, 2 * j, lo, hi, ag[0]);\n    a_frag<FORM>(r, 2 * j + 1, lo, hi, ag[1]);",
               "    for (int i = 0; i < 4; ++i) { ag[0][i] = r[(2 * j + i) & 7] ^ lo; "
               "ag[1][i] = r[(2 * j + i + 4) & 7] ^ hi; }")
_I8_NO_TMA = ("          mbar_expect_tx(&full[s], bytes);\n"
              "          tma_load_2d(xs + s * S::kX, &xmap, &full[s], kt * kTileK, m0);\n"
              "          tma_load_2d(sxs + s * S::kSx, &sxmap, &full[s], m0, kt * kGS);\n"
              "          tma_load_2d(ws + s * S::kW, &wmap, &full[s], n0, kt * RROWS);\n"
              "          tma_load_2d(ss + s * kTileScaleBytes, &smap, &full[s], n0, kt * kGS);",
              "          (void)bytes; (void)m0; (void)n0;\n          mbar_arrive(&full[s]);")
INT8_VARIANTS = {
    "qmm8_tile_kernel": {
        "no_products": [_I8_WGMMA], "no_rescale": [_I8_RESCALE], "no_conversion": [_I8_CONVERT],
        "loads_only": [_I8_WGMMA, _I8_RESCALE, _I8_CONVERT],
        "no_loads": [_I8_NO_TMA], "products_only": [_I8_NO_TMA, _I8_RESCALE],
        "rescale_only": [_I8_NO_TMA, _I8_WGMMA]},
}


# Text edits of csrc/flash_decode.cu (the split-KV decode kernel): its
# tensor-core products left out (the loads they read stay live), or every
# CTA returning after it writes its partial (no ticket, no merge); the
# float32 FMA path's dot products and P V left out (the path a bf16 query
# took before the tensor-core path, and still the float32 query's). Each
# checkout takes the variants whose edits its source holds.
_DEC_QK = ("        mma_16816(sc, qf[kp].x, qf[kp].y, bw[0], bw[1]);\n"
           "        mma_16816(sc, qf[kp].z, qf[kp].w, bw[2], bw[3]);",
           "        sc[0] += __uint_as_float(bw[0] ^ bw[1] ^ qf[kp].x);\n"
           "        sc[1] += __uint_as_float(bw[2] ^ bw[3] ^ qf[kp].z);")
_DEC_PV = ("        mma_1688(acc[mt], alo[mt], ahi[mt], pb);",
           "        acc[mt][0] += __uint_as_float(alo[mt] ^ ahi[mt] ^ pb);")
_DEC_TAIL = ("  __syncthreads();\n  if (tid == 0) *last = ticket_acq_rel(&tickets[pair]) == splits - 1;\n"
             "  __syncthreads();\n  if (!*last) return;", "  return;")
DECODE_VARIANTS = {
    "split_decode_kernel": {
        "no_products": [_DEC_QK, _DEC_PV], "no_tail": [_DEC_TAIL],
        "no_fma_products": [("for (int jv = 0; jv < 16 / VEC; ++jv) {",
                             "for (int jv = 0; jv < 0; ++jv) {"),
                            ("for (int jk = 0; jk < 8; ++jk) {", "for (int jk = 0; jk < 0; ++jk) {")]},
}


# Text edits of csrc/attention_single.cu (the bf16 tile at d = 64): the next
# chunk's Q K^T no longer beside this chunk's P V; three K/V stages; the two
# warpgroups' products in turn on named barriers (FA3's ping-pong) in place
# of the start-up stagger; no stagger; an eighth of the exponentials by an
# FMA polynomial in place of ex2.
_ATT_PP = [
    ("    if (wg == 1) named_sync(1, 256);\n    mbar_wait(full_q, 0);",
     "    if (wg == 1) named_arrive(2, 256);\n    mbar_wait(full_q, 0);"),
    ("      mbar_wait(&full_k[0], 0);\n      wgmma_fence();\n      issue_qk<D>(sc, qw, ks);\n"
     "      wgmma_commit();\n",
     "      mbar_wait(&full_k[0], 0);\n      named_sync(2 + wg, 256);\n      wgmma_fence();\n"
     "      issue_qk<D>(sc, qw, ks);\n      wgmma_commit();\n      named_arrive(3 - wg, 256);\n"),
    ("      if (wg == 0) named_arrive(1, 256);\n", ""),
    ("        mbar_wait(&full_k[s], (j / kStages) & 1);\n        wgmma_fence();",
     "        mbar_wait(&full_k[s], (j / kStages) & 1);\n        named_sync(2 + wg, 256);\n"
     "        wgmma_fence();"),
    ("        issue_pv<D>(acc, pa, vs + sp * kTile);\n        wgmma_commit();\n",
     "        issue_pv<D>(acc, pa, vs + sp * kTile);\n        wgmma_commit();\n"
     "        named_arrive(3 - wg, 256);\n"),
    ("      mbar_wait(&full_v[sl], ((n_chunks - 1) / kStages) & 1);\n      wgmma_fence();\n"
     "      issue_pv<D>(acc, pa, vs + sl * kTile);\n      wgmma_commit();\n",
     "      mbar_wait(&full_v[sl], ((n_chunks - 1) / kStages) & 1);\n      named_sync(2 + wg, 256);\n"
     "      wgmma_fence();\n      issue_pv<D>(acc, pa, vs + sl * kTile);\n      wgmma_commit();\n"
     "      named_arrive(3 - wg, 256);\n")]
_ATT_POLY = [
    ("constexpr float kLog2e = 1.4426950408889634f;",
     "constexpr float kLog2e = 1.4426950408889634f;\n\n"
     "__device__ __forceinline__ float ex2_fma(float x) {\n"
     "  const float xc = fmaxf(x, -125.f);\n  const float t = xc + 12582912.f;\n"
     "  const float f = xc - (t - 12582912.f);\n  float p = 1.535336188319500e-4f;\n"
     "  p = fmaf(p, f, 1.339887440266574e-3f);\n  p = fmaf(p, f, 9.618437357674640e-3f);\n"
     "  p = fmaf(p, f, 5.550332471162809e-2f);\n  p = fmaf(p, f, 2.402264791363012e-1f);\n"
     "  p = fmaf(p, f, 6.931472028550421e-1f);\n  p = fmaf(p, f, 1.f);\n"
     "  const float y = __int_as_float(__float_as_int(p) + ((__float_as_int(t) - 0x4B400000) << 23));\n"
     "  return x < -125.f ? 0.f : y;\n}"),
    ("        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], L, -ml0));\n"
     "        sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], L, -ml1));",
     "        if ((n & 7) == 0 && e == 0) {\n"
     "          sc[4 * n + e] = ex2_fma(fmaf(sc[4 * n + e], L, -ml0));\n"
     "          sc[4 * n + 2 + e] = ex2_fma(fmaf(sc[4 * n + 2 + e], L, -ml1));\n"
     "        } else {\n"
     "          sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], L, -ml0));\n"
     "          sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], L, -ml1));\n        }")]
ATTENTION_VARIANTS = {
    "attn_wgmma_kernel": {
        "no_overlap": [("constexpr bool OVL = D == 64 && !OPTS;", "constexpr bool OVL = false;")],
        "stages3": [("constexpr int kStages = 2;      // bf16: K/V chunks in the ring",
                     "constexpr int kStages = 3;")],
        "pingpong": _ATT_PP,
        "no_stagger": [("    if (wg == 1) named_sync(1, 256);\n    mbar_wait(full_q, 0);",
                        "    mbar_wait(full_q, 0);"), ("      if (wg == 0) named_arrive(1, 256);\n", "")],
        "poly_eighth": _ATT_POLY},
}


def _variant_libs(source: str, library: str, variants: dict) -> tuple:
    """The checkout's ``source`` and its text edits in ``variants`` (by the
    kernel the source holds), built side by side (one nvcc each, in
    parallel, with the flags of ops/_build.py) and loaded with ``library``'s
    signatures: (kernel, {variant: library}, the kernel's register, spill
    and C75xx ptxas lines of the unedited build)."""
    import ctypes
    import subprocess

    from chip_smoke import ptxas_by_function
    from qwen2_audio_tpu_torch.ops import _build
    src = (_build.CSRC / source).read_text()
    kernel = next(k for k in variants if k in src)
    texts = {"as_is": src}
    for name, edits in variants[kernel].items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"qmm_ab: variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    work = tempfile.mkdtemp(prefix="qmm_ab_variants_")
    jobs = {}
    for name, text in texts.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             os.path.join(work, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, notes = {}, {}
    for name, job in jobs.items():
        out, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"qmm_ab: variant {name} failed to build:\n{out[-2000:]}")
        if name == "as_is":   # the tile's registers, spills and wgmma serialization notes
            notes = {fn: [ln for ln in lines if "registers" in ln or "spill" in ln or "C75" in ln]
                     for fn, lines in ptxas_by_function(out).items() if kernel in fn}
        lib = ctypes.CDLL(os.path.join(work, f"{name}.so"))
        for fn, argtypes in _build.SIGNATURES[library].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return kernel, libs, notes


def _time_variants(library: str, libs: dict, cases: dict, rounds: int) -> dict:
    """{variant: {case: [ms per round]}} with each variant's library swapped
    in for ``library`` in turns, by graph replay; "as_is" also holds each
    case's largest distance from its plain version (``cases``: {case: (run,
    plain)})."""
    from qwen2_audio_tpu_torch.ops import _build
    res = {name: {} for name in libs}
    for rnd in range(rounds):
        for name in (list(libs) if rnd % 2 == 0 else list(reversed(list(libs)))):
            _build._libs[library] = libs[name]
            for case, (run, plain) in cases.items():
                if rnd == 0 and name == "as_is":
                    res[name][case + " max_abs_vs_plain"] = (
                        run().float() - plain().float()).abs().max().item()
                res[name].setdefault(case, []).append(time_ms(run))
    return res


def tile_variants(device, which: str = "all", rounds: int = 2) -> dict:
    """The split of the checkout's M > 8 tiles by scratch variants of their
    sources: ``which`` "bf16" (the dequantizing tile, TILE_VARIANTS), "int8"
    (the exact-integer tile, INT8_VARIANTS), "decode" (the decode attention,
    DECODE_VARIANTS), "attention" (the bf16 attention tile,
    ATTENTION_VARIANTS) or "all"."""
    out = {}
    if which in ("bf16", "all"):
        out["bf16"] = bf16_tile_variants(device, rounds)
    if which in ("int8", "all"):
        out["int8"] = int8_tile_variants(device, rounds)
    if which in ("decode", "all"):
        out["decode"] = decode_variants(device, rounds)
    if which in ("attention", "all"):
        out["attention"] = attention_variants(device, rounds)
    return out


def bf16_tile_variants(device, rounds: int = 2) -> dict:
    """{variant: {case: [ms per round]}} of the checkout's dequantizing M > 8
    tile and its TILE_VARIANTS, swapped in for its quant_matmul library in
    turns, by graph replay; "as_is" also holds its largest distance from the
    plain version per case, "library" one torch.matmul on the dequantized
    bf16 weight, and "ptxas" the tile's register, spill and C75xx lines of
    the unedited build."""
    import torch

    from chip_smoke import _rand_blocks
    from qwen2_audio_tpu_torch.ops import _build
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    kernel, libs, notes = _variant_libs("quant_matmul.cu", "quant_matmul", TILE_VARIANTS)
    cases, dense = {}, {}
    for i, (case, K, N, M, stacked) in enumerate((
            ("gate_up q8_0 M=752", 3584, 37888, 752, True),
            ("fc1 q8_0 M=1500", 1280, 5120, 1500, False),
            ("lm_head q8_0 M=64", 3584, 156032, 64, False))):
        g = torch.Generator(device=device).manual_seed(4000 + i)
        w = _rand_blocks(device, K, N, "q8_0", 4100 + i, layers=2 if stacked else 0)
        x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
        ql, sl = (w["qs"][1], w["scales"][1]) if stacked else (w["qs"], w["scales"])
        run = ((lambda w=w, x=x: qm.quant_matmul_stacked(x, w["qs"], w["scales"], 1, fast=True))
               if stacked else (lambda w=w, x=x: qm.quant_matmul(x, w["qs"], w["scales"],
                                                                  fast=True)))
        cases[case] = (run, lambda x=x, ql=ql, sl=sl: qm.quant_matmul_plain(x, ql, sl,
                                                                            fast=True))
        dense[case] = (x, ql, sl)
    res = _time_variants("quant_matmul", libs, cases, rounds)
    _build._libs["quant_matmul"] = libs["as_is"]   # the unit's rows forced at gate_up
    plan = qm.tile_plan
    run = cases["gate_up q8_0 M=752"][0]
    for bm in (128, 192, 256):
        def forced(M, K, N, sms, bm=bm):
            p = plan(M, K, N, sms)
            mt = -(-M // bm)
            units = mt * p["tiles"][1] * p["ks"]
            return {**p, "bm": bm, "tiles": (mt, p["tiles"][1]), "units": units,
                    "ctas": min(units, sms)}
        qm.tile_plan = forced
        try:
            res["as_is"][f"gate_up q8_0 M=752 bm={bm}"] = [time_ms(run) for _ in range(2)]
        finally:
            qm.tile_plan = plan
    _build._libs.pop("quant_matmul")
    res["library"] = {}
    for case, (x, ql, sl) in dense.items():
        w = qm.block_weight(ql, sl).to(torch.bfloat16)
        res["library"][case] = time_ms(lambda: x @ w)
        del w
    return {"kernel": kernel, "ptxas": notes, **res}


def int8_tile_variants(device, rounds: int = 2) -> dict:
    """{variant: {case: [ms per round]}} of the checkout's exact-integer M >
    8 tile and its INT8_VARIANTS (products, rescale, the weight's conversion
    left out, or all three: loads and barriers only; no loads), swapped
    in for its quant_matmul_int8 library in turns, by graph replay, at
    gate_up q8_0 and gate_up q4_0 as int32 words at M = 752 and fc1 q8_0 at
    M = 1500 (bf16 x); "as_is" also holds its largest distance from the
    plain version per case, "library" one torch.matmul on the dequantized
    bf16 weight, and "ptxas" the tile's register, spill and C75xx lines of
    the unedited build."""
    import torch

    from chip_smoke import _rand_blocks
    from qwen2_audio_tpu_torch.ops import _build
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as q4b
    kernel, libs, notes = _variant_libs("quant_matmul_int8.cu", "quant_matmul_int8",
                                        INT8_VARIANTS)
    cases, dense = {}, {}
    for i, (case, K, N, M, fmt) in enumerate((
            ("gate_up q8_0 M=752", 3584, 37888, 752, "q8_0"),
            ("gate_up q4_0 words M=752", 3584, 37888, 752, "q4_0"),
            ("fc1 q8_0 M=1500", 1280, 5120, 1500, "q8_0"))):
        g = torch.Generator(device=device).manual_seed(4200 + i)
        stacked = case.startswith("gate_up")
        w = _rand_blocks(device, K, N, fmt, 4300 + i, layers=2 if stacked else 0)
        x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
        if fmt == "q4_0":
            words = q4b.pack_b32(w["qs4"])
            run = lambda x=x, q=words, s=w["scales"]: q4b.quant_matmul_q4b_stacked(x, q, s, 1)
            plain = lambda x=x, q=words[1], s=w["scales"][1]: q4b.quant_matmul_q4b_plain(x, q, s)
            dense[case] = (x, qm.block_weight(w["qs4"][1], w["scales"][1], packed=True, off=8))
        elif stacked:
            run = lambda x=x, q=w["qs"], s=w["scales"]: q8.quant_matmul_int8_stacked(x, q, s, 1)
            plain = lambda x=x, q=w["qs"][1], s=w["scales"][1]: q8.quant_matmul_int8_plain(x, q, s)
            dense[case] = (x, qm.block_weight(w["qs"][1], w["scales"][1]))
        else:
            run = lambda x=x, q=w["qs"], s=w["scales"]: q8.quant_matmul_int8(x, q, s)
            plain = lambda x=x, q=w["qs"], s=w["scales"]: q8.quant_matmul_int8_plain(x, q, s)
            dense[case] = (x, qm.block_weight(w["qs"], w["scales"]))
        cases[case] = (run, plain)
    res = _time_variants("quant_matmul_int8", libs, cases, rounds)
    _build._libs["quant_matmul_int8"] = libs["as_is"]   # the unit's rows forced at gate_up
    plan = q8.tile_plan
    run = cases["gate_up q8_0 M=752"][0]
    for bm in (64, 128):
        def forced(M, N, sms, bm=bm):
            mt, nt = -(-M // bm), plan(M, N, sms)["tiles"][1]
            return {"bm": bm, "tiles": (mt, nt), "units": mt * nt, "ctas": min(mt * nt, sms)}
        q8.tile_plan = forced
        try:
            res["as_is"][f"gate_up q8_0 M=752 bm={bm}"] = [time_ms(run) for _ in range(2)]
        finally:
            q8.tile_plan = plan
    _build._libs.pop("quant_matmul_int8")
    res["library"] = {}
    for case, (x, w) in dense.items():
        wb = w.to(torch.bfloat16)
        res["library"][case] = time_ms(lambda: x @ wb)
        del wb
    return {"kernel": kernel, "ptxas": notes, **res}


def decode_variants(device, rounds: int = 2) -> dict:
    """{variant: {case: [ms per round]}} of the checkout's decode attention
    and its DECODE_VARIANTS, swapped in for its flash_decode library in
    turns, by graph replay, over a bf16 cache (NaN past each position) at B
    = 1 (capacity 2048, pos 783), the beam step's B = 5 (784, every stream at
    783) and the pool's B = 8 (2048, positions 752-812); "as_is" also holds
    its largest distance from the plain version per case, "ptxas" the
    kernel's register and spill lines of the unedited build."""
    import torch

    from chip_smoke import BEAM, _decode_case, _pool_decode_cases
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    from qwen2_audio_tpu_torch.ops import _build
    src = (_build.CSRC / "flash_decode.cu").read_text()
    held = {k: {n: e for n, e in v.items() if all(old in src for old, _ in e)}
            for k, v in DECODE_VARIANTS.items()}
    kernel, libs, notes = _variant_libs("flash_decode.cu", "flash_decode", held)
    pool = _pool_decode_cases()[0][4]
    cases = {}
    for i, (B, S, pos) in enumerate(((1, 2048, [783]), (BEAM, 784, [783] * BEAM),
                                     (len(pool), 2048, pool))):
        q, cache, posv = _decode_case(device, torch.bfloat16, torch.bfloat16, B, S, pos, 4400 + i)
        cases[f"B={B} S={S}"] = (
            lambda q=q, c=cache, p=posv: fd.flash_decode(q, *c, p, sm_scale=128 ** -0.5),
            lambda q=q, c=cache, p=posv: fd.flash_decode_plain(q, *c, p, sm_scale=128 ** -0.5))
    return {**_time_variants("flash_decode", libs, cases, rounds), "ptxas": notes}


def attention_variants(device, rounds: int = 2) -> dict:
    """{variant: {case: [ms per round]}} of the checkout's bf16 attention tile
    and its ATTENTION_VARIANTS, swapped in for its attention_single library
    in turns, by graph replay: the one-shot kernel at the encoder shape (B 1,
    20 heads, T 1500, d 64, views into one fused QKV output) and the causal
    prefill (B 1, 28 query heads on 4 KV heads, T 752, d 128); "as_is" also
    holds its largest distance from the plain version per case, "sdpa" one
    bf16 SDPA call at the encoder shape, "ptxas" the tile's register, spill
    and C75xx lines of the unedited build."""
    import torch
    import torch.nn.functional as F

    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    kernel, libs, notes = _variant_libs("attention_single.cu", "attention_single",
                                        ATTENTION_VARIANTS)
    g = torch.Generator(device=device).manual_seed(4500)
    qkv = torch.randn(1, 1500, 3 * 1280, generator=g, device=device).to(torch.bfloat16)
    q, k, v = (x.unflatten(-1, (20, 64)).transpose(1, 2) for x in qkv.chunk(3, -1))
    qp = torch.randn(1, 752, 28, 128, generator=g, device=device).to(torch.bfloat16)
    kp, vp = (torch.randn(1, 752, 4, 128, generator=g, device=device).to(torch.bfloat16)
              for _ in range(2))
    qp, kp, vp = (x.transpose(1, 2) for x in (qp, kp, vp))
    cases = {"encode": (lambda: fa.attention_single(q, k, v),
                        lambda: fa.attention_single_plain(q, k, v)),
             "prefill": (lambda: fa.attention_causal(qp, kp, vp, 128 ** -0.5),
                         lambda: fa.attention_causal_plain(qp, kp, vp, 128 ** -0.5))}
    return {**_time_variants("attention_single", libs, cases, rounds),
            "sdpa": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)),
            "ptxas": notes}


def lm_head_rows(device, record, M: int = 64, K: int = 3584, vocab: int = 156032) -> None:
    """The lm_head at a speculative pool's verify (M = 64 rows) over random
    q8_0 and symmetric q4_0 blocks, bf16 x, fast mode: the strided entry,
    the same weight in panels of 128 (its bits compared) and one
    torch.matmul on the dequantized bf16 weight; paths "<fmt> lm_head
    M=64"."""
    import torch

    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    for fi, fmt in enumerate(("q8_0", "q4_0")):
        packed = fmt == "q4_0"
        kw = {"fast": True, **({"off": 8} if packed else {})}
        g = torch.Generator(device=device).manual_seed(3000 + fi)
        head = random_quant_linear(g, (K, vocab), fmt)
        key_q = "qs4" if packed else "qs"
        q, sc = head[key_q], head["scales"]
        pw = qm.panelize_weight(head, 128)
        pq, psc = pw[key_q + "_p"], pw["scales_p"]
        flat = qm.quant_matmul4 if packed else qm.quant_matmul
        pflat = qm.quant_matmul_panel4 if packed else qm.quant_matmul_panel
        plain = qm.quant_matmul4_plain if packed else qm.quant_matmul_plain
        x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
        got = flat(x, q, sc, **kw)
        dense = qm.block_weight(q, sc, packed=packed, off=8 if packed else 0).to(torch.bfloat16)
        record(f"{fmt} lm_head M={M} K={K} N={vocab}", f"{fmt} lm_head M={M}", 1, got,
               plain(x, q, sc, **kw),
               {"ms": time_ms(lambda: flat(x, q, sc, **kw)),
                "panel_ms": time_ms(lambda: pflat(x, pq, psc, **kw)),
                "panel_equal": bool(torch.equal(pflat(x, pq, psc, **kw), got)),
                "library_ms": time_ms(lambda: x @ dense)})
        del head, pw, q, sc, pq, psc, dense
        torch.cuda.empty_cache()


def mel_paths(device, record, shapes: dict, ckpt: str, layers: int = 32,
              calls: int = 8) -> None:
    """The log-mel kernel (TPU row 1) at the encode path's 30 s clip (3002
    frames, 128 mels) and at 1 s (102 frames, 80 mels), kernel and plain
    version by graph replay; then whisper_full per 30 s clip through the
    checkout's capi, host clock (each call ends in a synchronisation), and
    its t_mel_us per call, and the device busy ms of one profiled call, the
    mel kernel's share beside it."""
    import torch

    from chip_smoke import noisy_tone
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.audio.mel import pad_signal
    from qwen2_audio_tpu_torch.ops import mel_kernel as mk
    from qwen2_audio_tpu_torch.runtime.context import ContextParams
    for seconds, n_mels in ((30.0, 128), (1.0, 80)):
        padded, _, _, n = pad_signal(noisy_tone(seconds, seed=1))
        tables = mk.mel_tables(mel_filterbank(n_mels), device)
        x = torch.from_numpy(padded).to(device)
        run = lambda: mk.mel_frames(x, tables, n)                  # noqa: E731
        plain = lambda: mk.mel_frames_plain(x, tables, n)          # noqa: E731
        record(f"mel {seconds:g} s n_mel={n_mels} frames={n}", "", 0, run(), plain(),
               {"ms": time_ms(run), "plain_ms": time_ms(plain), "host_us": host_us(run)})
    ctx = capi.whisper_init_from_file_with_params(
        encoder_ckpt(ckpt, layers), ContextParams(compute_dtype=torch.bfloat16))
    t = whisper_full_ms(ctx, calls, "whisper_full (encode)")
    prof = t.pop("profile")
    t["t_mel_us"] = ctx.state.timings.t_mel_us / calls
    t["device_mel_ms"] = prof and prof["groups"].get("mel_log_frames")
    shapes[f"whisper_full {layers} layers, 30 s clip"] = t
    capi.whisper_free(ctx)
    torch.cuda.empty_cache()


def encoder_ckpt(ckpt: str, layers: int = 32) -> str:
    """The random-weight (seed 0) F16 qwen2-audio checkpoint of ``layers``
    layers at ``ckpt``, written if missing."""
    import numpy as np

    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.config import WHISPER_PRESETS
    from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
    from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
    hp = dataclasses.replace(WHISPER_PRESETS["qwen2-audio"], n_audio_layer=layers)
    if not os.path.exists(ckpt):
        write_encoder_checkpoint(ckpt, random_encoder_params(np.random.default_rng(0), hp), hp,
                                 mel_filterbank(hp.n_mels), [b"a", b"b", b"ab"])
    return ckpt


def whisper_full_ms(ctx, calls: int, what: str) -> dict:
    """whisper_full on a 30 s clip ``calls`` times, host clock (each call ends
    in a synchronisation): the median after the first, every call, and one
    profiled call's device busy ms."""
    import statistics
    import time

    import torch

    from chip_smoke import noisy_tone, profile_call
    from qwen2_audio_tpu_torch import capi
    clip, params = noisy_tone(30.0, seed=3), capi.whisper_full_default_params()
    per_call = []
    for _ in range(calls):
        t0 = time.perf_counter()
        if capi.whisper_full(ctx, params, clip) != 0:
            raise RuntimeError("qmm_ab: whisper_full failed")
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
    prof = profile_call(lambda: capi.whisper_full(ctx, params, clip), what)
    return {"ms": statistics.median(per_call[1:]), "per_call_ms": per_call,
            "device_busy_ms": prof and prof["busy_ms"], "profile": prof}


def quant_ckpt(ckpt: str, fmt: str, layers: int = 32) -> str:
    """``encoder_ckpt`` quantized to ``fmt`` by the checkout's
    quantize_checkpoint, written beside it if missing."""
    from qwen2_audio_tpu_torch.config import GGMLFType
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint
    src = encoder_ckpt(ckpt, layers)
    path = src.removesuffix(".bin") + f"_{fmt}.bin"
    if not os.path.exists(path):
        quantize_checkpoint(src, path, GGMLFType[f"MOSTLY_{fmt.upper()}"])
    return path


def int8_requests(device, shapes: dict, ckpt: str, layers: int = 32, calls: int = 8,
                  new_tokens: int = 4) -> None:
    """Mode "int8" end to end, each figure over ``calls`` calls in a row so
    that the first call's costs stand apart from a warm call's: whisper_full
    on a 30 s clip with the random checkpoint quantized to q8_0 (the encoder
    alone; host ms of every call, one profiled call's device busy ms and
    its integer kernels' ms), then with a random full-width q8_0 decoder of
    chip_smoke's QUANT_DEC_LAYERS layers behind it (made on the card from
    seed 0, as chip_smoke's phase 4e makes it; ``new_tokens`` tokens): each
    request's host wall, encode and prefill ms (the state's timings) and
    one profiled request's integer kernels' device ms."""
    import statistics

    import torch

    from chip_smoke import QUANT_DEC_LAYERS, _request, _text_params, noisy_tone, profile_call
    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.runtime.context import ContextParams
    ctx = capi.whisper_init_from_file_with_params(
        quant_ckpt(ckpt, "q8_0", layers),
        ContextParams(compute_dtype=torch.bfloat16, keep_quantized=True))
    clip = noisy_tone(30.0, seed=40, freq=280.0)
    set_group_matmul_mode("int8")
    try:
        for what, params in (("encode", capi.whisper_full_default_params()),
                             ("request", _text_params(new_tokens))):
            if what == "request":
                cfg = dataclasses.replace(Qwen2DecoderConfig(),
                                          num_hidden_layers=QUANT_DEC_LAYERS)
                ctx.decoder = random_bundle(
                    torch.Generator(device=device).manual_seed(0), cfg,
                    ctx.hparams.n_audio_state, dtype=torch.bfloat16, max_ctx=2048,
                    cache_dtype=torch.bfloat16, quant="q8_0")
            runs = [_request(ctx, clip, params)[1] for _ in range(calls)]
            prof = profile_call(lambda: capi.whisper_full(ctx, params, clip),
                                f"whisper_full ({what}, q8_0, mode int8)")
            t = {f"{k}_per_call": [r[k] for r in runs]
                 for k in ("wall_ms", "encode_ms", "prefill_ms")
                 if what == "request" or k != "prefill_ms"}
            t.update({k.removesuffix("_per_call") + "_warm": statistics.median(v[1:])
                      for k, v in list(t.items())})
            t["device_busy_ms"] = prof and prof["busy_ms"]
            t["device_int8_ms"] = prof and prof["groups"].get("quant_matmul_int8")
            shapes[f"int8 mode q8_0 {what}: {layers}-layer encoder"
                   + (f", {QUANT_DEC_LAYERS}-layer decoder" if what == "request" else "")] = t
    finally:
        set_group_matmul_mode(None)
        ctx.decoder = None
        capi.whisper_free(ctx)
        torch.cuda.empty_cache()


def quant_encode_paths(shapes: dict, ckpt: str, layers: int = 32, calls: int = 6) -> None:
    """whisper_full per 30 s clip of the random F16 checkpoint quantized to
    q8_0 and q4_0 by the checkout's quantize_checkpoint (once, kept beside
    ``ckpt``), loaded with the block weights kept (bf16 activations, the
    dequantizing entries in fast mode)."""
    import torch

    from qwen2_audio_tpu_torch import capi
    from qwen2_audio_tpu_torch.runtime.context import ContextParams
    for fmt in ("q8_0", "q4_0"):
        ctx = capi.whisper_init_from_file_with_params(
            quant_ckpt(ckpt, fmt, layers),
            ContextParams(compute_dtype=torch.bfloat16, keep_quantized=True))
        t = whisper_full_ms(ctx, calls, f"whisper_full (encode, {fmt})")
        prof = t.pop("profile")
        t["device_matmul_ms"] = prof and prof["groups"].get("quant_matmul")
        shapes[f"whisper_full {fmt} {layers} layers, 30 s clip"] = t
        capi.whisper_free(ctx)
        torch.cuda.empty_cache()


def attention_paths(device, record, seed: int) -> None:
    """The bf16 attention kernels (TPU rows 2, 3, 18, 19) at the encode and
    prefill shapes: "attention encode", 32 layers x the one-shot kernel at
    (B 1, 20 heads, T 1500, d 64) over views into one fused QKV output, with
    the lite entry (row 18, Q pre-scaled in its type, the row sums of p as
    cast to bf16) and the unpadded entry (row 19) on the same views and one
    bf16 SDPA call beside them; "attention prefill", 28 layers x the causal
    kernel at (B 1, 28 query heads on 4 KV heads, T 752, d 128) beside
    causal GQA SDPA. Each case also holds ``host_us`` and ``c_us``."""
    import torch
    import torch.nn.functional as F

    from qwen2_audio_tpu_torch.ops import fa_variants as fv
    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    for path, layers, (B, H, Hkv, T, d) in (("attention encode", ENCODER[0], ATT_ENCODE),
                                            ("attention prefill", DECODER[0], ATT_PREFILL)):
        seed += 1
        g = torch.Generator(device=device).manual_seed(seed)
        if path == "attention encode":   # head views of the fused QKV output
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=device).to(torch.bfloat16)
            q, k, v = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in qkv.chunk(3, -1))
            run = lambda: fa.attention_single(q, k, v)            # noqa: E731
            ref = lambda: fa.attention_single_plain(q, k, v)      # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)   # noqa: E731
        else:
            q = torch.randn(B, T, H, d, generator=g, device=device).to(torch.bfloat16)
            k, v = (torch.randn(B, T, Hkv, d, generator=g, device=device).to(torch.bfloat16)
                    for _ in range(2))
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
            run = lambda: fa.attention_causal(q, k, v, d ** -0.5)  # noqa: E731
            ref = lambda: fa.attention_causal_plain(q, k, v, d ** -0.5)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True)
        record(f"{path} B={B} H={H} Hkv={Hkv} T={T} d={d}", path, layers, run(), ref(),
               {"ms": time_ms(run), "host_us": host_us(run), "sdpa_ms": time_ms(sdpa),
                "c_us": host_us(c_entry(q, k, v, path == "attention prefill"))})
        if path == "attention encode":
            for entry, r, p in (
                    ("lite", lambda: fv.attention_lite(q, k, v, sm_scale=1.0),
                     lambda: fv.attention_lite_plain(q, k, v, sm_scale=1.0)),
                    ("nopad", lambda: fv.flash_attention_nopad(q, k, v, sm_scale=1.0),
                     lambda: fa.attention_single_plain(q, k, v))):
                record(f"{path} {entry} B={B} H={H} Hkv={Hkv} T={T} d={d}",
                       f"{path} {entry}", layers, r(), p(), {"ms": time_ms(r)})


def decode_paths(device, record, shapes: dict, paths: dict) -> None:
    """The decode-step cache attention (TPU rows 4 and 5) at one step of a
    32-token request: q bf16 (B 1, 28 query heads on 4 KV heads, d 128) over
    a bf16 or int8 cache of capacity S at pos, NaN past pos; and at the beam
    step's shape (B = chip_smoke.BEAM, capacity 784, every stream at 783)
    and the 8-slot pool's (B = chip_smoke.POOL_SLOTS, capacity 2048,
    positions 752-812). Each shape is timed on one cache (warm in L2, as
    chip_smoke times it) beside bf16 SDPA (over the prefix where every
    stream is at one position, else over the whole cache with a mask and
    NaN rows zeroed); the paths "attention decode" and "attention decode
    int8" are 28 layers' caches of capacity 2048 at pos 783 read in turn
    (45 MB of prefixes, about the L2), summed over the layers."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import BEAM, _decode_case, _pool_decode_cases
    from qwen2_audio_tpu_torch.ops import flash_decode as fd
    layers, d = DECODER[0], 128
    pool = _pool_decode_cases()[0][4]
    for seed, (kvdt, B, S, pos) in enumerate([
            (kv, 1, S, [p]) for kv in (torch.bfloat16, torch.int8)
            for S, p in ((784, 783), (2048, 783), (8192, 8191))] + [
            (kv, B, S, pos) for kv in (torch.bfloat16, torch.int8)
            for B, S, pos in ((BEAM, 784, [783] * BEAM), (len(pool), 2048, pool))], start=900):
        quant = kvdt == torch.int8
        kern = fd.flash_decode_quant if quant else fd.flash_decode
        plain = fd.flash_decode_quant_plain if quant else fd.flash_decode_plain
        q, cache, posv = _decode_case(device, torch.bfloat16, kvdt, B, S, pos, seed)
        run = lambda: kern(q, *cache, posv, sm_scale=d ** -0.5)   # noqa: E731
        t = {"ms": time_ms(run), "host_us": host_us(run)}
        if not quant and len(set(pos)) == 1:
            kp, vp = (c[:, :pos[0] + 1].transpose(1, 2) for c in cache)
            t["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kp, vp, scale=d ** -0.5, enable_gqa=True))
        elif not quant:
            kp, vp = (torch.nan_to_num(c).transpose(1, 2) for c in cache)
            mask = (torch.arange(S, device=device)[None, :] <= posv[:, None].long())
            t["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kp, vp, attn_mask=mask[:, None, None, :], scale=d ** -0.5,
                enable_gqa=True))
        if hasattr(fd, "decode_plan"):   # the split-KV kernel's launch
            plan = fd.decode_plan(B, S, 4, 7, kvdt)
            t["plan"] = {"splits": plan["splits"], "grid": plan["grid"],
                         "ctas_with_keys": plan["ctas_with_keys"](posv.tolist())}
        key = (f"attention decode {str(kvdt).removeprefix('torch.')} S={S} pos={pos[0]}"
               if B == 1 else f"attention decode {str(kvdt).removeprefix('torch.')} B={B} "
               f"S={S} pos={min(pos)}-{max(pos)}")
        record(key, "", 0, run(), plain(q, *cache, posv, sm_scale=d ** -0.5), t)   # no path
        del q, cache
    for seed, kvdt in ((1000, torch.bfloat16), (1100, torch.int8)):
        quant = kvdt == torch.int8
        kern = fd.flash_decode_quant if quant else fd.flash_decode
        per = [_decode_case(device, torch.bfloat16, kvdt, 1, 2048, [783], seed + li)
               for li in range(layers)]

        def run():
            for q, cache, posv in per:
                kern(q, *cache, posv, sm_scale=d ** -0.5)

        path = "attention decode" + (" int8" if quant else "")
        paths[path] = time_ms(run)
        shapes[f"{path} {layers} layers S=2048 pos=783"] = {"ms": paths[path] / layers}
        del per
        torch.cuda.empty_cache()
    # the device kernels of one decode step by cache, at full width and depth 2
    from chip_smoke import step_launches
    from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
    bundle = random_bundle(torch.Generator(device=device).manual_seed(0), cfg, 1280,
                           dtype=torch.bfloat16, max_ctx=2048, cache_dtype=torch.bfloat16)
    shapes["decode step, 2 layers"] = step_launches(bundle)
    del bundle
    torch.cuda.empty_cache()


def decode_weights(device, record, shapes: dict, paths: dict, layers: int = DECODER[0],
                   dims=DECODER[1], vocab: int = 156032, ms=(1, 7),
                   mlp_ms=(1, 7, 8, 64)) -> None:
    """The M <= 8 weight-streaming kernels (TPU rows 6-13 at M <= 8 and row
    17) with cold weights, bf16 x, fast mode. Each projection of ``dims``
    (qkv, o, gate_up, down) is a stack of ``layers`` layers of random q8_0 or
    symmetric q4_0 blocks (7.5 / 4.0 GB at full width, far past the 50 MB
    L2), timed as the graph replay of one call per layer over the layers in
    turn, per call; the lm_head (``vocab`` columns, 559 / 280 MB) strided and
    in panels of 128; the one-launch SwiGLU over the gate_up and down stacks
    beside the two-launch path over the same weights (gate_up, SiLU * up,
    down); mode "int8" on the same bytes (q8_0 int8 values, q4_0 nibble
    bytes, and q4_0 as int32 words). Paths at M = 1, summed over the layers:
    "<fmt> decode" (the four projections), "<fmt> decode fused" (qkv, o and
    the SwiGLU), "<fmt> decode two-launch" (qkv, o and the two-launch MLP),
    "<fmt> decode int8" and "q4_0 decode words". Every case's digest and
    largest distance are taken on layer 0 against its plain version. Last,
    the device kernels of one decode step (the profiler's count) of a
    full-width 2-layer decoder of random q8_0 or q4_0 blocks, with the
    one-launch SwiGLU and without."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import graph_ms
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    from qwen2_audio_tpu_torch.ops import fused_mlp as fm
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as q4b

    def per_call(fn) -> float:   # one call per layer, layers in turn
        return graph_ms(lambda: [fn(li) for li in range(layers)], iters=2) / layers

    plan_of = getattr(qm, "stream_plan", None)
    for fi, fmt in enumerate(("q8_0", "q4_0")):
        packed = fmt == "q4_0"
        kw = {"fast": True, **({"off": 8} if packed else {})}
        stacked = qm.quant_matmul4_stacked if packed else qm.quant_matmul_stacked
        plain = qm.quant_matmul4_plain if packed else qm.quant_matmul_plain
        g = torch.Generator(device=device).manual_seed(2000 + fi)
        w = {name: random_quant_linear(g, (layers, K, N), fmt) for name, K, N in
             (("qkv", *dims[0]), ("o", *dims[1]), ("gate_up", *dims[2]), ("down", *dims[3]))}
        key_q = "qs4" if packed else "qs"
        t1 = {}   # name: ms at M = 1
        for name, (K, N) in zip(w, dims):
            q, sc = w[name][key_q], w[name]["scales"]
            words = q4b.pack_b32(q) if packed else None
            for M in ms:
                x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
                t = {"ms": per_call(lambda li: stacked(x, q, sc, li, **kw))}
                if plan_of is not None:
                    t["plan"] = {k: v for k, v in plan_of(M, K, N, qm.sm_count(device)).items()
                                 if k in ("grid", "ksplit")}
                record(f"{fmt} {name} M={M} K={K} N={N} cold", "", 0,
                       stacked(x, q, sc, 0, **kw), plain(x, q[0], sc[0], **kw), t)
                forms = {"int8": (lambda li: q8.quant_matmul_int8_stacked(
                    x, q, sc, li, **({"off": 8} if packed else {})),
                    (lambda: q8.quant_matmul_int8_packed_plain(x, q[0], sc[0], off=8))
                    if packed else (lambda: q8.quant_matmul_int8_plain(x, q[0], sc[0])))}
                if packed:
                    forms["words"] = (lambda li: q4b.quant_matmul_q4b_stacked(x, words, sc, li),
                                      lambda: q4b.quant_matmul_q4b_plain(x, words[0], sc[0]))
                for form, (run, ref) in forms.items():
                    tf = {"ms": per_call(run)}
                    record(f"{fmt} {name} M={M} K={K} N={N} cold {form}", "", 0, run(0), ref(),
                           tf)
                    if M == 1:
                        path = f"{fmt} decode {form}"
                        paths[path] = paths.get(path, 0.0) + layers * tf["ms"]
                if M == 1:
                    t1[name] = t["ms"]
            del words
        paths[f"{fmt} decode"] = layers * sum(t1.values())
        # the one-launch SwiGLU and the two-launch path over the gate_up and down stacks
        gu, dn = w["gate_up"], w["down"]
        (D, I2), (I, _) = dims[2], dims[3]
        fused = fm.fused_mlp4_sym_stacked if packed else fm.fused_mlp_stacked
        g_l = (gu[key_q][0][:, :I], gu["scales"][0][:, :I])
        u_l = (gu[key_q][0][:, I:], gu["scales"][0][:, I:])
        d_l = (dn[key_q][0], dn["scales"][0])
        for M in mlp_ms:
            x = torch.randn(M, D, generator=g, device=device).to(torch.bfloat16)
            args = (gu[key_q], gu["scales"], dn[key_q], dn["scales"])

            def two_launch(li):
                y = stacked(x, gu[key_q], gu["scales"], li, **kw)
                return stacked(F.silu(y[..., :I]) * y[..., I:], dn[key_q], dn["scales"], li,
                               **kw)

            t = {"ms": per_call(lambda li: fused(x, *args, li, fast=True)),
                 "two_launch_ms": per_call(two_launch)}
            plan = getattr(fm, "swiglu_plan", None)
            if plan is not None:
                t["plan"] = {k: v for k, v in plan(M, D, I, dn[key_q].shape[-1],
                                                   qm.sm_count(device), packed).items()
                             if k in ("grid", "warps", "splits", "smem")}
            record(f"{fmt} swiglu M={M} K={D} I={I} cold", "", 0, fused(x, *args, 0, fast=True),
                   fm.fused_mlp_plain(x, g_l, u_l, d_l, packed=packed, fast=True), t)
            if M == 1:
                paths[f"{fmt} decode fused"] = layers * (t1["qkv"] + t1["o"] + t["ms"])
                paths[f"{fmt} decode two-launch"] = layers * (t1["qkv"] + t1["o"]
                                                              + t["two_launch_ms"])
        del w, gu, dn, g_l, u_l, d_l
        torch.cuda.empty_cache()
        # the lm_head, strided and in panels of 128
        K = dims[0][0]
        head = random_quant_linear(g, (K, vocab), fmt)
        flat = qm.quant_matmul4 if packed else qm.quant_matmul
        pflat = qm.quant_matmul_panel4 if packed else qm.quant_matmul_panel
        pw = qm.panelize_weight(head, 128)
        q, sc = head[key_q], head["scales"]
        pq, psc = pw[key_q + "_p"], pw["scales_p"]
        for M in ms:
            x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
            want = plain(x, q, sc, **kw)
            got = flat(x, q, sc, **kw)
            record(f"{fmt} lm_head M={M} K={K} N={vocab}", "", 0, got, want,
                   {"ms": graph_ms(lambda: flat(x, q, sc, **kw)),
                    "panel_ms": graph_ms(lambda: pflat(x, pq, psc, **kw)),
                    "panel_equal": bool(torch.equal(pflat(x, pq, psc, **kw), got))})
        del head, pw, q, sc, pq, psc
        torch.cuda.empty_cache()
    # the device kernels of one decode step of a full-width 2-layer decoder of
    # random blocks, with the one-launch SwiGLU and without
    from chip_smoke import step_launches
    from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.ops import linear
    cfg = dataclasses.replace(Qwen2DecoderConfig(), num_hidden_layers=2)
    for fmt in ("q8_0", "q4_0"):
        bundle = random_bundle(torch.Generator(device=device).manual_seed(7), cfg, 1280,
                               dtype=torch.bfloat16, max_ctx=2048,
                               cache_dtype=torch.bfloat16, device=device, quant=fmt)
        for fused in (True, False):
            linear.set_fused_mlp(fused)
            shapes[f"decode step, 2 layers, {fmt}, "
                   + ("one-launch SwiGLU" if fused else "per-projection MLP")] = \
                step_launches(bundle)["bf16"]
        linear.set_fused_mlp(None)
        del bundle
        torch.cuda.empty_cache()


def edge_shares(device) -> dict:
    """{case: the largest |kernel - plain| over ATTN_TOL's elementwise
    tolerance} of the one-shot entry at chip_smoke's tile edge cases."""
    from qwen2_audio_tpu_torch.ops import flash_attention as fa
    atol, rtol = ATTN_TOL["bfloat16"]
    out = {}
    for i, (B, H, Hkv, Tq, Tk, d, kv_valid, fused) in enumerate(_edge_cases()):
        q, k, v, (kc, vc) = _edge_case(device, B, H, Hkv, Tq, Tk, d, kv_valid, fused, 400 + i)
        want = fa.attention_single_plain(q, kc, vc, kv_valid).float()
        diff = (fa.attention_single(q, k, v, kv_valid).float() - want).abs()
        out[f"B={B} H={H} Hkv={Hkv} Tq={Tq} Tk={Tk} d={d} kv_valid={kv_valid}"
            + (" fused" if fused else "")] = (diff / (atol + rtol * want.abs())).max().item()
    return out


def emit(args, payload: dict) -> int:
    """Print one JSON line (label, root, the card's name and power limit, the
    payload) and, with --out, append it there."""
    line = json.dumps({"label": args.label, "root": args.root, "gpu": gpu_line(), **payload})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
