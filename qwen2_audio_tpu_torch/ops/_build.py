"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, which ``ctypes`` loads (no PyTorch headers, so
a build takes seconds). Libraries are named by a hash of their source (and
of the ``csrc/*.cuh`` headers the sources share) and land in
``qwen2_audio_tpu_torch/_build/`` (listed in .gitignore, override with
``QA_TORCH_BUILD_DIR``); a library already there is reused. Nothing is
built at import: the first call that needs a kernel builds it, and
``build_all`` builds every source at once, one ``nvcc`` process per source.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when that is not zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C signature of every entry point, by source
SIGNATURES = {
    "mel": {
        # padded, n_padded, fft_tab, ranges, weights, n_weights, out,
        # n_frames, n_mel, stream
        "qa_mel_log_frames": [P, L, P, P, P, I, P, I, I, P],
    },
    "attention_single": {
        # q, k, v, o, strides (b, h, t) of q, k, v, o, B, H, Hkv, Tq,
        # kv_valid, d, is_bf16, sm_scale, flags, stream
        "qa_attention_single": [P, P, P, P] + [L] * 12 + [I] * 7 + [F, I, P],
        # the same arguments (B, H, Hkv, T, kv_valid, d, is_bf16, sm_scale,
        # flags)
        "qa_attention_causal": [P, P, P, P] + [L] * 12 + [I] * 7 + [F, I, P],
    },
    "flash_decode": {
        # q, k, v, k_scale, v_scale, pos, o, workspace, tickets, B, S, Hkv,
        # G, d, q_type, kv_type, sm_scale, splits, stages, stream
        "qa_flash_decode": [P] * 9 + [I] * 7 + [F, I, I, P],
        # k, v, k_q, k_scale, v_q, v_scale, pos, strides (b, t, h) of k and
        # v, B, T, Hkv, d, S, x_type, stream
        "qa_kv_append_quant": [P] * 7 + [L] * 6 + [I] * 6 + [P],
    },
    "quant_matmul": {
        # x, q, scales, out, scratch, tickets, M, K, N, bn, group, x_bf16,
        # s_f16, packed, off, fast, dq16, ksplit, bm, ctas, stream
        "qa_quant_matmul": [P] * 6 + [I] * 14 + [P],
        # stream, out: the id of the graph capture under way on it, or 0
        "qa_stream_capture_id": [P, P],
    },
    "fused_mlp": {
        # x, gate (q, scales, mins), up (q, scales, mins), down (q, scales,
        # mins), out, scratch, partial, tickets, M, K, I, D, ld_gu, bi, plan
        # (7 int32: P, S, units_a, ring_a, ring_b, sg_a, sg_b), group, x_bf16,
        # gu_s_f16, dn_s_f16, packed, off, fast, stream
        "qa_fused_mlp": [P] * 14 + [I] * 4 + [L, I, P] + [I] * 7 + [P],
    },
    "fused_mlp_rows": {
        # qa_fused_mlp's arguments, fast mode at 9 <= M <= 64
        "qa_fused_mlp_rows": [P] * 14 + [I] * 4 + [L, I, P] + [I] * 7 + [P],
    },
    "quant_matmul_int8": {
        # x, xq, sx, M, K, x_bf16, layout (0 int8; 1, 2 the M > 8 tile's), stream
        "qa_quantize_q8_1": [P] * 3 + [I] * 4 + [P],
        # x, q, scales, out, scratch, xq, sx_t, M, K, N, x_bf16, s_f16, form,
        # off, ksplit, bm, ctas, stream
        "qa_quant_matmul_int8": [P] * 7 + [I] * 10 + [P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # nvcc's output (-Xptxas -v) by source


def build_dir() -> Path:
    return Path(os.environ.get("QA_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parents[1] / "_build"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked in PATH and {cuda_home}/bin)")
    return path


def _target(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, target = job
    out, _ = proc.communicate()
    build_log[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all() -> None:
    """Compile every kernel source that is not built yet, all in parallel."""
    with _lock:
        names = [n for n in SIGNATURES if n not in _libs]
        jobs = {n: _start(n) for n in names}
        for n in names:
            _finish(n, jobs[n])
        for n in names:
            _libs[n] = _load(n)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = _load(name)
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
