"""ctypes bindings for the native host library (native/qa_native.cpp), the
same sources the JAX package binds, built into the git-ignored native/build
(nothing under native/ is edited).

Every entry point has a host fallback in Python, so the package works
without the build; the native paths speed up host-side work (wav decode,
the host mel, bulk quantization of large checkpoints, the memcpy bench).
None of them touches the card.

Build:  python -m qwen2_audio_tpu_torch.native   (or: cmake -S native -B native/build)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_BUILD_DIR = _REPO / "native" / "build"
_LIB_PATHS = [
    _BUILD_DIR / "libqa_native.so",
    _REPO / "native" / "libqa_native.so",
]

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the library with cmake+make; returns the .so path."""
    src = _REPO / "native"
    _BUILD_DIR.mkdir(exist_ok=True)
    kw = {} if verbose else {"capture_output": True}
    subprocess.run(["cmake", "-S", str(src), "-B", str(_BUILD_DIR),
                    "-DCMAKE_BUILD_TYPE=Release"], check=True, **kw)
    subprocess.run(["cmake", "--build", str(_BUILD_DIR), "-j"],
                   check=True, **kw)
    return _LIB_PATHS[0]


def load(auto_build: bool = False):
    """Load (and cache) the shared library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        if p.exists():
            _lib = _bind(ctypes.CDLL(str(p)))
            return _lib
    if auto_build:
        try:
            path = build()
            _lib = _bind(ctypes.CDLL(str(path)))
            return _lib
        except Exception:
            return None
    return None


def available() -> bool:
    return load() is not None


def _bind(lib):
    c = ctypes
    lib.qa_version.restype = c.c_int
    lib.qa_free.argtypes = [c.c_void_p]
    lib.qa_wav_read.argtypes = [c.c_char_p, c.POINTER(c.POINTER(c.c_float)),
                                c.POINTER(c.c_int64), c.POINTER(c.c_int)]
    lib.qa_wav_read.restype = c.c_int
    if hasattr(lib, "qa_mp3_read"):        # added in lib version 1 rebuilds
        lib.qa_mp3_read.argtypes = lib.qa_wav_read.argtypes
        lib.qa_mp3_read.restype = c.c_int
    lib.qa_log_mel.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_float), c.c_int,
        c.c_int, c.POINTER(c.POINTER(c.c_float)), c.POINTER(c.c_int64),
        c.POINTER(c.c_int64)]
    lib.qa_log_mel.restype = c.c_int
    lib.qa_quantize.argtypes = [c.c_int, c.POINTER(c.c_float), c.c_int64,
                                c.POINTER(c.c_uint8), c.c_int]
    lib.qa_quantize.restype = c.c_int64
    lib.qa_dequantize.argtypes = [c.c_int, c.POINTER(c.c_uint8), c.c_int64,
                                  c.POINTER(c.c_float), c.c_int]
    lib.qa_dequantize.restype = c.c_int64
    lib.qa_bench_memcpy_gbps.argtypes = [c.c_int64, c.c_int]
    lib.qa_bench_memcpy_gbps.restype = c.c_double
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_read(path: str) -> tuple[np.ndarray, int]:
    lib = load()
    if lib is None:
        from qwen2_audio_tpu_torch.audio.wav import read_wav
        return read_wav(path, expect_rate=None)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rate = ctypes.c_int()
    rc = lib.qa_wav_read(path.encode(), ctypes.byref(out), ctypes.byref(n),
                         ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"qa_wav_read({path}) failed rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.qa_free(out)
    return arr, rate.value


def mp3_read(path: str) -> tuple[np.ndarray, int]:
    """Native-rate mono f32 decode; falls back to the ctypes-from-Python
    binding (audio/mp3.py) when the lib is absent or built pre-mp3."""
    lib = load()
    if lib is None or not hasattr(lib, "qa_mp3_read"):
        from qwen2_audio_tpu_torch.audio.mp3 import read_mp3
        return read_mp3(path, expect_rate=None)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rate = ctypes.c_int()
    rc = lib.qa_mp3_read(path.encode(), ctypes.byref(out), ctypes.byref(n),
                         ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"qa_mp3_read({path}) failed rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.qa_free(out)
    return arr, rate.value


def log_mel(samples: np.ndarray, filters: np.ndarray,
            n_threads: int = 4):
    """Native threaded mel; returns (data (n_mel, n_len), n_len_org).
    Falls back to the plain mel on the CPU when the library is absent."""
    lib = load()
    if lib is None:
        from qwen2_audio_tpu_torch.audio.mel import log_mel_spectrogram
        m = log_mel_spectrogram(samples, filters, device="cpu")
        return m.data.numpy(), m.n_len_org
    samples = np.ascontiguousarray(samples, np.float32)
    filters = np.ascontiguousarray(filters, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_len = ctypes.c_int64()
    n_len_org = ctypes.c_int64()
    rc = lib.qa_log_mel(_fptr(samples), samples.size, _fptr(filters),
                        filters.shape[0], n_threads, ctypes.byref(out),
                        ctypes.byref(n_len), ctypes.byref(n_len_org))
    if rc != 0:
        raise RuntimeError(f"qa_log_mel failed rc={rc}")
    try:
        data = np.ctypeslib.as_array(
            out, shape=(filters.shape[0], n_len.value)).copy()
    finally:
        lib.qa_free(out)
    return data, int(n_len_org.value)


def quantize(x: np.ndarray, ttype: int, n_threads: int = 4) -> np.ndarray:
    lib = load()
    from qwen2_audio_tpu_torch.quant import codecs
    if lib is None:
        return codecs.quantize(x, ttype)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    out = np.empty(codecs.type_size_bytes(ttype, x.size), np.uint8)
    n = lib.qa_quantize(int(ttype), _fptr(x), x.size,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        n_threads)
    if n < 0:
        raise ValueError("qa_quantize failed")
    return out


def dequantize(raw: np.ndarray, ttype: int, n: int,
               n_threads: int = 4) -> np.ndarray:
    lib = load()
    from qwen2_audio_tpu_torch.quant import codecs
    if lib is None:
        return codecs.dequantize(raw, ttype, n)
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(n, np.float32)
    rc = lib.qa_dequantize(int(ttype),
                           raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           n, _fptr(out), n_threads)
    if rc < 0:
        raise ValueError("qa_dequantize failed")
    return out


def bench_memcpy_gbps(bytes_: int = 1 << 30, n_threads: int = 1) -> float:
    """≙ whisper_bench_memcpy (src/qwen2-whisper.cpp:3690-3836)."""
    lib = load()
    if lib is None:
        import time
        src = np.ones(bytes_, np.uint8)
        t0 = time.perf_counter()
        dst = src.copy()
        dt = time.perf_counter() - t0
        del dst
        return bytes_ / dt / 1e9
    return float(lib.qa_bench_memcpy_gbps(bytes_, n_threads))


if __name__ == "__main__":
    print("built:", build(verbose=True))
    print("version:", load().qa_version())
