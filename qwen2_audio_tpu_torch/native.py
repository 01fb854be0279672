"""ctypes bindings for the native host library (native/qa_native.cpp), the
same sources the JAX package binds, built into the git-ignored native/build
(nothing under native/ is edited).

Every entry point has a host fallback in Python, so the package works
without the build; the native paths speed up host-side work (wav decode,
the host mel, bulk quantization of large checkpoints, the memcpy bench).
None of them touches the card. The same build makes native/qa_rpc, the C++
client of the RPC server (runtime/rpc.py).

``build_capi`` builds the port's C API shim (native_src/qa_capi.cpp, which
embeds Python and delegates to qwen2_audio_tpu_torch.capi) and its command line
(native_src/main.c) with g++ and ``python3-config --embed``, into the
kernels' git-ignored build directory (ops/_build.py).

Build:  python -m qwen2_audio_tpu_torch.native   (or: cmake -S native -B native/build)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_BUILD_DIR = _REPO / "native" / "build"
_LIB_PATHS = [
    _BUILD_DIR / "libqa_native.so",
    _REPO / "native" / "libqa_native.so",
]

_lib = None


def build(verbose: bool = False, build_dir: str | Path | None = None) -> Path:
    """Compile the library (and native/qa_rpc beside it) with cmake+make
    into ``build_dir`` (default native/build); returns the .so path."""
    src = _REPO / "native"
    out = Path(build_dir) if build_dir is not None else _BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    kw = {} if verbose else {"capture_output": True}
    # a venv may carry cmake beside its python without it being on PATH
    cmake = shutil.which("cmake") or str(Path(sys.executable).with_name("cmake"))
    subprocess.run([cmake, "-S", str(src), "-B", str(out),
                    "-DCMAKE_BUILD_TYPE=Release"], check=True, **kw)
    subprocess.run([cmake, "--build", str(out), "-j"],
                   check=True, **kw)
    return out / "libqa_native.so"


CAPI_SRC = Path(__file__).resolve().parent / "native_src"


def _python_config() -> str:
    """The python-config of the running interpreter's version."""
    name = f"python{sys.version_info.major}.{sys.version_info.minor}-config"
    for d in (Path(sys.executable).parent,
              Path(getattr(sys, "_base_executable", sys.executable)).parent):
        if (d / name).exists():
            return str(d / name)
    path = shutil.which(name) or shutil.which("python3-config")
    if path is None:
        raise RuntimeError(f"{name} not found: the C API shim needs an embeddable Python")
    return path


def build_capi(verbose: bool = False, build_dir: str | Path | None = None
               ) -> tuple[Path, Path]:
    """Build the port's C API shim ``libqa_capi_torch.so`` and its command line
    ``qa_main_torch`` (``qa_main_torch [-ng] model.bin audio.wav [iters]``)
    with g++ and ``python3-config --embed --cflags --ldflags``, into a
    directory named by a hash of the sources under ``build_dir`` (default:
    the kernels' build directory); a build already there is reused.
    Returns (library, program). The program's embedded interpreter finds the
    package and its dependencies through PYTHONPATH."""
    if build_dir is None:
        from qwen2_audio_tpu_torch.ops._build import build_dir as kernels_dir
        build_dir = kernels_dir()
    pyconf = _python_config()
    cflags = subprocess.run([pyconf, "--embed", "--cflags"], check=True,
                            capture_output=True, text=True).stdout
    ldflags = subprocess.run([pyconf, "--embed", "--ldflags"], check=True,
                             capture_output=True, text=True).stdout
    want = f"-lpython{sys.version_info.major}.{sys.version_info.minor}"
    if want not in ldflags.split():
        raise RuntimeError(f"{pyconf} --embed --ldflags gives {ldflags.strip()!r}, "
                           f"not {want}")
    sources = [CAPI_SRC / "qa_capi.cpp", CAPI_SRC / "main.c"]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + (cflags + ldflags).encode()).hexdigest()[:16]
    out = Path(build_dir) / f"capi-{digest}"
    lib, program = out / "libqa_capi_torch.so", out / "qa_main_torch"
    if lib.exists() and program.exists():
        return lib, program
    tmp = Path(build_dir) / f"capi-{digest}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ld = shlex.split(ldflags)
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ld if f.startswith("-L")]
    kw = {} if verbose else {"capture_output": True, "text": True}
    steps = [
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *shlex.split(cflags),
         str(sources[0]), "-o", str(tmp / lib.name), *ld, *rpaths, "-lpthread"],
        ["gcc", "-O2", str(sources[1]), "-o", str(tmp / program.name),
         f"-L{tmp}", "-lqa_capi_torch", "-Wl,-rpath,$ORIGIN"],
    ]
    for cmd in steps:
        r = subprocess.run(cmd, **kw)
        if r.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"{cmd[0]} failed building the C API shim:\n"
                               f"{getattr(r, 'stdout', '')}{getattr(r, 'stderr', '')}")
    try:
        os.rename(tmp, out)
    except OSError:        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib, program


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
    print("C API shim:", *build_capi(verbose=True))
