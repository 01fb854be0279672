"""Raw-PCM capture sources for streaming transcription.

The stand-in for the reference's SDL microphone loop
(examples/common-sdl.cpp:1-229 ``audio_async``: an
SDL capture callback feeds a ring buffer; the stream example pulls
fixed-length windows out of it). This environment has no audio device,
so the honest capture-loop shape is a *blocking reader over a pipe,
FIFO, or stdin* carrying raw PCM, e.g.

    arecord -f S16_LE -r 16000 -c 1 | python -m qwen2_audio_tpu_torch.cli.stream model.bin -

``pcm_chunks`` yields float32 chunks of ``chunk_ms`` milliseconds until
EOF, exactly how ``audio_async::get()`` hands the reference's stream
example fixed-size windows of microphone audio — the downstream VAD /
segmentation / incremental-UTF-8 logic is identical for both sources.
"""

from __future__ import annotations

import os
import stat
import sys
from typing import BinaryIO, Iterator

import numpy as np

_SAMPLE_BYTES = {"s16le": 2, "f32le": 4}


def decode_pcm(raw: bytes, fmt: str = "s16le") -> np.ndarray:
    """Decode little-endian raw PCM bytes to float32 in [-1, 1]."""
    if fmt == "s16le":
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if fmt == "f32le":
        return np.frombuffer(raw, dtype="<f4").astype(np.float32)
    raise ValueError(f"unknown PCM format {fmt!r} "
                     f"(expected one of {sorted(_SAMPLE_BYTES)})")


def is_pipe_source(path: str) -> bool:
    """True for sources to read as a live PCM stream: '-' (stdin) or a
    FIFO/character-device path (named pipes, /dev/stdin)."""
    if path == "-":
        return True
    try:
        mode = os.stat(path).st_mode
    except OSError:
        return False
    return stat.S_ISFIFO(mode) or stat.S_ISCHR(mode)


def _read_exactly(f: BinaryIO, n: int) -> bytes:
    """Blocking read of up to n bytes; short only at EOF. Pipes return
    whatever is buffered per read(), so loop until the chunk fills — the
    ring-buffer-accumulate role of audio_async's capture callback."""
    parts: list[bytes] = []
    got = 0
    while got < n:
        b = f.read(n - got)
        if not b:
            break
        parts.append(b)
        got += len(b)
    return b"".join(parts)


def pcm_chunks(source: str | BinaryIO, rate: int = 16000,
               chunk_ms: int = 500, fmt: str = "s16le"
               ) -> Iterator[np.ndarray]:
    """Yield float32 PCM chunks of ``chunk_ms`` from a pipe-like source.

    ``source``: '-' for stdin, a path (FIFO or regular file opened in
    binary mode), or an already-open binary stream. The final chunk may
    be shorter; a trailing partial sample frame at EOF is dropped (it
    cannot be decoded).
    """
    if fmt not in _SAMPLE_BYTES:
        raise ValueError(f"unknown PCM format {fmt!r}")
    sb = _SAMPLE_BYTES[fmt]
    chunk_bytes = max(1, rate * chunk_ms // 1000) * sb

    own = False
    if source == "-":
        f: BinaryIO = sys.stdin.buffer
    elif isinstance(source, str):
        f = open(source, "rb")
        own = True
    else:
        f = source
    try:
        while True:
            raw = _read_exactly(f, chunk_bytes)
            if len(raw) >= sb:
                yield decode_pcm(raw[:len(raw) - len(raw) % sb], fmt)
            if len(raw) < chunk_bytes:   # EOF
                return
    finally:
        if own:
            f.close()
