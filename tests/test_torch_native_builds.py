"""The native builds the port's tests need, made where the tests' outcome
does not depend on their order.

``native_build`` builds native/ (the host library and native/qa_rpc) through
the port's ``native.build`` into a directory of the test session's own,
shared by its xdist workers under a file lock and named by a hash of the
sources: never native/build, which the JAX package's tests/test_native.py
builds in another worker at the same time. ``capi_build`` does the same for
the port's C API shim (``native.build_capi``). Both skip only where cmake,
g++ or an embeddable Python is missing. The tests below hold the helpers and
the port's two build functions."""

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from qwen2_audio_tpu_torch import native as tnative

ROOT = Path(__file__).resolve().parents[1]
CAPI_SYMBOLS = ("whisper_init_from_file", "whisper_init_from_file_with_params", "whisper_free",
                "whisper_full", "whisper_print_emb_enc", "whisper_pcm_to_mel", "whisper_encode",
                "whisper_n_vocab", "whisper_lang_str", "whisper_full_get_segment_text",
                "whisper_print_timings")


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _locked(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _session_dir(tmp_path_factory) -> Path:
    """A directory every xdist worker of this session shares: the parent of
    the worker's base temporary directory."""
    return tmp_path_factory.getbasetemp().parent


def native_build(tmp_path_factory) -> Path:
    """native/ built once for the session; the directory holds
    libqa_native.so and qa_rpc."""
    if shutil.which("cmake") is None or shutil.which("g++") is None:
        pytest.skip("cmake or g++ is missing")
    srcs = [p for p in (ROOT / "native").iterdir() if p.is_file()]
    out = _session_dir(tmp_path_factory) / f"qa_native-{_digest(srcs)}"
    with _locked(out.with_suffix(".lock")):
        if not (out / "built").exists():
            tnative.build(build_dir=out)
            (out / "built").write_text("ok")
    return out


def capi_build(tmp_path_factory) -> tuple[Path, Path]:
    """The port's C API shim and its command line, built once for the session."""
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("g++ or gcc is missing")
    try:
        tnative._python_config()
    except RuntimeError as e:
        pytest.skip(str(e))
    out = _session_dir(tmp_path_factory) / "qa_capi_torch"
    out.mkdir(exist_ok=True)
    with _locked(out / "lock"):
        return tnative.build_capi(build_dir=out)


def embedded_env() -> dict:
    """The environment of a process that embeds Python: the repo and every
    entry of this interpreter's path on PYTHONPATH (the embedded interpreter
    starts from the base installation, without the venv's site-packages)."""
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", str(ROOT)),
            "PYTHONPATH": os.pathsep.join([str(ROOT)] + [p for p in sys.path if p])}


def test_native_build_is_its_own_and_reused(tmp_path_factory):
    out = native_build(tmp_path_factory)
    assert out.resolve() != (ROOT / "native" / "build").resolve()
    lib, rpc = out / "libqa_native.so", out / "qa_rpc"
    assert lib.exists() and rpc.exists() and os.access(rpc, os.X_OK)
    stamp = (lib.stat().st_mtime_ns, rpc.stat().st_mtime_ns)
    assert native_build(tmp_path_factory) == out
    assert (lib.stat().st_mtime_ns, rpc.stat().st_mtime_ns) == stamp


def test_native_build_loads_in_both_packages(tmp_path_factory):
    """The library the session built binds in the port and in the JAX
    package (the same _bind signatures)."""
    import ctypes

    from qwen2_audio_tpu import native as jnative
    lib = str(native_build(tmp_path_factory) / "libqa_native.so")
    assert tnative._bind(ctypes.CDLL(lib)).qa_version() == \
        jnative._bind(ctypes.CDLL(lib)).qa_version() == 1


def test_capi_build_exports_the_c_api(tmp_path_factory):
    lib, program = capi_build(tmp_path_factory)
    assert lib.exists() and os.access(program, os.X_OK)
    syms = subprocess.run(["nm", "-D", "--defined-only", str(lib)], capture_output=True,
                          text=True, check=True).stdout.split()
    missing = [s for s in CAPI_SYMBOLS if s not in syms]
    assert not missing, missing
    assert capi_build(tmp_path_factory) == (lib, program)     # reused


def test_capi_build_races_to_one_result(tmp_path):
    """Two processes building the shim into one directory at once both get
    the same finished build (each builds in a directory of its own and
    renames it into place)."""
    code = ("import sys; from qwen2_audio_tpu_torch import native; "
            "print(*native.build_capi(build_dir=sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert outs[0][0] == outs[1][0]
    lib, program = (Path(x) for x in outs[0][0].split())
    assert lib.exists() and program.exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_capi_source_delegates_to_the_port():
    """The shim embeds the port's capi and nothing of the JAX package."""
    import re
    src = (ROOT / "qwen2_audio_tpu_torch" / "native_src" / "qa_capi.cpp").read_text()
    assert 'PyImport_ImportModule("qwen2_audio_tpu_torch.capi")' in src
    assert not re.search(r"qwen2_audio_tpu\.|\bjax\b", src)
    main = (ROOT / "qwen2_audio_tpu_torch" / "native_src" / "main.c").read_text()
    assert '"-ng"' in main and "whisper_init_from_file_with_params" in main
