"""MP3 input via the system libmpg123, bound with ctypes.

Reference parity: the reference reads mp3 only when built with
WHISPER_FFMPEG (examples/common.cpp:27-29 declares ffmpeg_decode_audio,
:677-683 routes non-wav inputs through it, transcoding to 16 kHz mono).
The port's equivalent is a thin binding over the system codec library,
libmpg123 for decode, followed by the same mono downmix and 16 kHz
resample (audio/filters.py::resample). Gated: when the library is
absent, ``have_mp3()`` is False and ``read_mp3`` raises with an actionable message (the reference
prints "error: failed to ffmpeg decode" in the same situation).

No vendored decoder, no subprocess: the codec runs in-process and the
PCM lands directly in a numpy buffer.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from qwen2_audio_tpu_torch.audio.filters import resample
from qwen2_audio_tpu_torch.config import WHISPER_SAMPLE_RATE

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0

_lib = None
_lib_err: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        _lib_err = str(e)
        return None
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.restype = ctypes.c_int
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_close.restype = ctypes.c_int
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    lib.mpg123_init()            # no-op on modern libmpg123, needed on old
    _lib = lib
    return _lib


def have_mp3() -> bool:
    """True when the system mp3 decoder library is loadable."""
    return _load() is not None


def _err(lib, code: int) -> str:
    try:
        return lib.mpg123_plain_strerror(code).decode()
    except Exception:
        return f"mpg123 error {code}"


def read_mp3(path: str, expect_rate: int | None = WHISPER_SAMPLE_RATE,
             to_mono: bool = True) -> tuple[np.ndarray, int]:
    """Decode an mp3 file to float32 samples in [-1, 1].

    Mirrors read_wav's contract; like the reference's ffmpeg path the
    output is resampled to ``expect_rate`` (16 kHz) when the stream rate
    differs, rather than refused. Returns (samples, rate_out).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"mp3 input requires the system libmpg123, which failed to "
            f"load ({_lib_err}); convert to 16 kHz wav instead")
    ierr = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(ierr))
    if not h:
        raise RuntimeError(f"mpg123_new: {_err(lib, ierr.value)}")
    try:
        rc = lib.mpg123_open(h, path.encode())
        if rc != _MPG123_OK:
            raise ValueError(f"{path}: mpg123_open: {_err(lib, rc)}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        rc = lib.mpg123_getformat(h, ctypes.byref(rate),
                                  ctypes.byref(channels), ctypes.byref(enc))
        if rc != _MPG123_OK:
            raise ValueError(f"{path}: mpg123_getformat: {_err(lib, rc)}")
        # pin the output format: native rate/channels, s16 — deterministic
        # across libmpg123 builds (float output support varies)
        lib.mpg123_format_none(h)
        rc = lib.mpg123_format(h, rate.value, channels.value,
                               _MPG123_ENC_SIGNED_16)
        if rc != _MPG123_OK:
            raise ValueError(f"{path}: mpg123_format: {_err(lib, rc)}")

        chunks: list[bytes] = []
        buf = ctypes.create_string_buffer(1 << 17)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(ctypes.string_at(buf, done.value))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise ValueError(f"{path}: mpg123_read: {_err(lib, rc)}")
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)

    pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
    nch = max(channels.value, 1)
    if nch > 1:
        pcm = pcm[: len(pcm) - len(pcm) % nch].reshape(-1, nch)
    samples = pcm.astype(np.float32) / 32768.0
    if to_mono and samples.ndim == 2:
        samples = samples.mean(axis=1)
    sr = int(rate.value)
    if expect_rate is not None and sr != expect_rate:
        if samples.ndim == 2:           # per-channel (resample is 1-D)
            samples = np.stack(
                [resample(samples[:, c], sr, expect_rate)
                 for c in range(samples.shape[1])], axis=1)
        else:
            samples = resample(samples, sr, expect_rate)
        sr = expect_rate
    return samples, sr
