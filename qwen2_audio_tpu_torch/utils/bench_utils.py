"""Matmul throughput micro-bench (≙ whisper_bench_ggml_mul_mat,
src/qwen2-whisper.cpp:3843-3959: N x N x N products over q4_0/q4_1/q5_0/
q5_1/q8_0/f16/f32). The formats are the port's set: f32 and bf16 (one
``torch.matmul``), the five legacy ggml block formats through the
dequantizing kernels (``ops.quant_matmul.quant_linear``: q8_0, q5_0 and q5_1
as int8 values, q4_0 and q4_1 as packed nibbles, the min term of the _1
formats beside the kernel) in the process's group-matmul mode, and the
exact-integer group matmul (``ops.quant_matmul_int8.quant_linear_int8``) as
"q8_0i".

Each case runs once to warm up, ``check`` sees the kernel's own product
beside its plain version, then a dependent chain of ``chain`` products (each one's output the next
one's input) is timed by CUDA events on the card, best of two. On the CPU
the wrappers run their plain versions and the host clock times the chain.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.ops import linear
from qwen2_audio_tpu_torch.ops.quant_matmul import (quant_linear, quant_matmul,
                                                    quant_matmul4, quant_matmul4_plain,
                                                    quant_matmul_plain)
from qwen2_audio_tpu_torch.ops.quant_matmul_int8 import (quant_linear_int8, quant_matmul_int8,
                                                         quant_matmul_int8_plain)
from qwen2_audio_tpu_torch.quant.qparams import quantize_array_for_device

BLOCK_FORMATS = (("q4_0", GGMLType.Q4_0), ("q4_1", GGMLType.Q4_1), ("q5_0", GGMLType.Q5_0),
                 ("q5_1", GGMLType.Q5_1), ("q8_0", GGMLType.Q8_0))
FORMATS = ("f32", "bf16", "q8_0i") + tuple(name for name, _ in BLOCK_FORMATS)


def bench_device(use_gpu: bool = True) -> torch.device:
    """The card, raising without one; the CPU with ``use_gpu=False``."""
    if not use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the mul_mat bench runs on the card and none is available; "
                           "pass use_gpu=False to run it on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def bench_arrays(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(w, x): the dense N x N weight and input of one size, float32."""
    rng = np.random.default_rng(seed + n)
    w = rng.standard_normal((n, n)).astype(np.float32) * 0.1
    x = rng.standard_normal((n, n)).astype(np.float32) * 0.1
    return w, x


def _kernel_pair(qw: dict, fast: bool, int8: bool):
    """(the kernel entry's own product, its plain version): x -> the
    block product without the _1 formats' min term, which both paths add
    after the kernel alike."""
    if int8:
        return (lambda a: quant_matmul_int8(a, qw["qs"], qw["scales"]),
                lambda a: quant_matmul_int8_plain(a, qw["qs"], qw["scales"]))
    if "qs4" in qw:
        off = 0 if "mins" in qw else 8
        return (lambda a: quant_matmul4(a, qw["qs4"], qw["scales"], fast=fast, off=off),
                lambda a: quant_matmul4_plain(a, qw["qs4"], qw["scales"], fast=fast, off=off))
    return (lambda a: quant_matmul(a, qw["qs"], qw["scales"], fast=fast),
            lambda a: quant_matmul_plain(a, qw["qs"], qw["scales"], fast=fast))


def mul_mat_cases(n: int, device: torch.device, seed: int = 0) -> list[dict]:
    """The N x N x N cases of one size: {"type", "fn", "x", "kernel",
    "entry", "plain"}: "fn" the timed product, "kernel" the name of the
    wrapper counting its launches, "entry" and "plain" the kernel's own
    product and its plain version (the last three None for the dense
    cases)."""
    w, x = bench_arrays(n, seed)
    x32 = torch.from_numpy(x).to(device)
    x16 = x32.to(torch.bfloat16)
    fast = linear.group_matmul_mode() == "bf16"
    cases = []
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ww = torch.from_numpy(w).to(device, dt)
        cases.append({"type": name, "fn": lambda a, ww=ww: a @ ww,
                      "x": x32 if dt == torch.float32 else x16,
                      "kernel": None, "entry": None, "plain": None})
    q8 = quantize_array_for_device(w, GGMLType.Q8_0, device=device)
    entry, plain = _kernel_pair(q8, fast, True)
    cases.append({"type": "q8_0i", "fn": lambda a, qw=q8: quant_linear_int8(a, qw), "x": x16,
                  "kernel": "quant_matmul_int8", "entry": entry, "plain": plain})
    for name, ttype in BLOCK_FORMATS:
        qw = quantize_array_for_device(w, ttype, device=device)
        entry, plain = _kernel_pair(qw, fast, False)
        cases.append({"type": name, "fn": lambda a, qw=qw: quant_linear(a, qw, fast=fast),
                      "x": x16, "kernel": "quant_matmul4" if "qs4" in qw else "quant_matmul",
                      "entry": entry, "plain": plain})
    return cases


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_chain(fn: Callable, x0: torch.Tensor, chain: int = 8, rounds: int = 2) -> float:
    """Seconds per fn application over a dependent chain of ``chain``
    calls, the best of ``rounds``: CUDA events on the card, the host clock
    (after a synchronisation) elsewhere."""
    best = float("inf")
    for _ in range(rounds):
        if x0.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            c = x0
            for _i in range(chain):
                c = fn(c)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            c = x0
            for _i in range(chain):
                c = fn(c)
            sec = time.perf_counter() - t0
        best = min(best, sec / chain)
    return best


def mul_mat_bench(sizes=(512, 1024, 2048, 4096), device: torch.device | None = None,
                  chain: int = 8, check: Callable | None = None) -> list[dict]:
    """Rows {"size", "type", "gflops"} for every size and format.
    ``device`` defaults to the card (``bench_device``). ``check(case,
    product, plain_product)``, where given, sees each kernel case's own
    product (its "entry") beside its plain version before the case is
    timed."""
    device = bench_device() if device is None else device
    rows = []
    for n in sizes:
        flops = 2.0 * n * n * n
        for case in mul_mat_cases(n, device):
            case["fn"](case["x"])      # warm-up
            if check is not None and case["entry"] is not None:
                check(case, case["entry"](case["x"]), case["plain"](case["x"]))
            _sync(device)
            sec = time_chain(case["fn"], case["x"], chain=chain)
            rows.append({"size": n, "type": case["type"], "gflops": flops / sec / 1e9})
        del case
    return rows


def mul_mat_bench_str(sizes=(512, 1024, 2048), device: torch.device | None = None,
                      check: Callable | None = None) -> str:
    lines = [f"  {r['size']:4d} x {r['size']:4d}: {r['type']:>5s} {r['gflops']:10.1f} GFLOPS"
             for r in mul_mat_bench(sizes, device=device, check=check)]
    return "\n".join(lines) + "\n"
