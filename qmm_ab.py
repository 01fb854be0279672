"""Time the dequantizing matmul kernels of csrc/quant_matmul.cu at the
shapes of the encode path, the decoder prefill and a decode step, for one
checkout of the port. Run it on two checkouts on the same card, in
alternating order, to compare them.

    python3 qmm_ab.py [--root DIR] [--label NAME] [--out FILE]

``--root`` is the checkout whose ``qwen2_audio_tpu_torch`` is imported and
built (default: the one holding this script). Weights are random q8_0 and
symmetric q4_0 blocks (``random_quant_linear``), x is bf16 and the kernels
run in fast mode, dq16 off, as the encoder and the bf16-mode decoder call
them; where the checkout takes ``dq16``, each shape is also timed with it.
Each time is the median over 7 rounds of CUDA events around 20 launches,
divided by 20. Per path the sum over its launches is printed: encode 32
layers x (qkv 1280 -> 3840, out 1280 -> 1280, fc1 1280 -> 5120, fc2 5120 ->
1280) at M = 1500; prefill 28 layers x (qkv 3584 -> 4608, o 3584 -> 3584,
gate_up 3584 -> 37888, down 18944 -> 3584) at M = 752; decode the same
at M = 1. Prints one JSON line and, with ``--out``, appends it there.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ENCODER = (32, 1500, ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)))
DECODER = (28, ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)))


def time_ms(fn, rounds: int = 7, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("qmm_ab: no CUDA device", file=sys.stderr)
        return 1
    import qwen2_audio_tpu_torch
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    from qwen2_audio_tpu_torch.ops import quant_matmul as qm
    here = os.path.dirname(os.path.abspath(qwen2_audio_tpu_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(args.root):
        raise RuntimeError(f"qmm_ab: imported {here}, not from {args.root}")

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(0)
    shapes, paths = {}, {}
    for fmt in ("q8_0", "q4_0"):
        packed = fmt == "q4_0"
        kw = {"fast": True, **({"off": 8} if packed else {})}
        flat = qm.quant_matmul4 if packed else qm.quant_matmul
        stacked = qm.quant_matmul4_stacked if packed else qm.quant_matmul_stacked
        cases = [("encode", ENCODER[1], K, N, False, ENCODER[0]) for K, N in ENCODER[2]]
        cases += [(path, M, K, N, True, DECODER[0]) for path, M in (("prefill", 752),
                                                                   ("decode", 1))
                  for K, N in DECODER[1]]
        for path, M, K, N, is_stacked, layers in cases:
            w = random_quant_linear(g, ((2,) if is_stacked else ()) + (K, N), fmt)
            q, sc = w["qs4" if packed else "qs"], w["scales"]
            x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
            li = (1,) if is_stacked else ()
            entry = stacked if is_stacked else flat
            t = {"ms": time_ms(lambda: entry(x, q, sc, *li, **kw))}
            try:
                entry(x, q, sc, *li, dq16=True, **kw)
            except TypeError:
                pass
            else:
                t["dq16_ms"] = time_ms(lambda: entry(x, q, sc, *li, dq16=True, **kw))
            shapes[f"{fmt} {path} M={M} K={K} N={N}"] = t
            for key, ms in t.items():
                name = f"{fmt} {path}" + (" dq16" if key == "dq16_ms" else "")
                paths[name] = paths.get(name, 0.0) + layers * ms
            del w, q, sc, x
        torch.cuda.empty_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip()
    line = json.dumps({"label": args.label, "root": args.root, "gpu": gpu,
                       "paths_ms": paths, "shapes": shapes})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
