"""Reader/writer for the single-file ggml-model.bin checkpoint format.

Layout (reference: loader src/qwen2-whisper.cpp:1339-1872, writer
models/convert-pt-to-ggml.py:266-339):

    i32   magic = 0x67676d6c ("ggml")
    i32   n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
          n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels, ftype
    i32   filters.n_mel, filters.n_fft
    f32   filters[n_mel * n_fft]
    i32   n_tokens; then n_tokens x { i32 len; u8 bytes[len] }
    repeated tensor records until EOF:
        i32 n_dims, i32 name_len, i32 ttype (ggml_type)
        i32 ne[n_dims]            # ne[0] = fastest-varying (last numpy axis)
        u8  name[name_len]
        raw data, row-major, ggml-block-packed for quantized types

Quantized files store ftype + GGML_QNT_VERSION*1000 (qntvr split at
src/qwen2-whisper.cpp:1413-1415).

Tensors are exposed in natural numpy shape (reverse of the stored ne order).
Quantized payloads stay packed uint8 blocks; ``GGMLTensor.to_f32``
dequantizes them with quant/codecs.py.
"""

from __future__ import annotations

import dataclasses
import io as _io
import struct
from typing import BinaryIO, Iterable

import numpy as np

from qwen2_audio_tpu_torch.config import (
    GGML_FILE_MAGIC,
    GGML_QNT_VERSION_FACTOR,
    GGMLType,
    WhisperHParams,
)
from qwen2_audio_tpu_torch.quant import codecs
from qwen2_audio_tpu_torch.quant.codecs import type_size_bytes  # noqa: F401

@dataclasses.dataclass
class GGMLTensor:
    name: str
    shape: tuple[int, ...]       # numpy order (outermost first)
    ttype: GGMLType
    raw: np.ndarray              # uint8 payload for quantized, else typed array

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def to_f32(self) -> np.ndarray:
        """Float32 array in natural numpy shape, dequantizing block formats."""
        if self.ttype in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
            return self.raw.astype(np.float32).reshape(self.shape)
        return codecs.dequantize(self.raw, self.ttype,
                                 self.n_elements).reshape(self.shape)


@dataclasses.dataclass
class GGMLModelFile:
    hparams: WhisperHParams
    qntvr: int
    filters: np.ndarray          # (n_mel, n_fft) float32
    vocab: list[bytes]           # raw token bytes, index = token id
    tensors: dict[str, GGMLTensor]


def _read_i32(f: BinaryIO) -> int:
    b = f.read(4)
    if len(b) < 4:
        raise EOFError
    return struct.unpack("<i", b)[0]


def read_ggml_file(path_or_buf) -> GGMLModelFile:
    """Parse a checkpoint from a path, a bytes object or a binary file."""
    if isinstance(path_or_buf, str):
        with open(path_or_buf, "rb") as f:
            return _read(f)
    if isinstance(path_or_buf, (bytes, bytearray)):
        return _read(_io.BytesIO(path_or_buf))
    return _read(path_or_buf)


def _read(f: BinaryIO) -> GGMLModelFile:
    magic = struct.unpack("<I", f.read(4))[0]
    if magic != GGML_FILE_MAGIC:
        raise ValueError(f"invalid model data (bad magic 0x{magic:08x})")

    ints = [_read_i32(f) for _ in range(11)]
    raw_ftype = ints[10]
    qntvr = raw_ftype // GGML_QNT_VERSION_FACTOR
    hp = WhisperHParams(
        n_vocab=ints[0], n_audio_ctx=ints[1], n_audio_state=ints[2],
        n_audio_head=ints[3], n_audio_layer=ints[4], n_text_ctx=ints[5],
        n_text_state=ints[6], n_text_head=ints[7], n_text_layer=ints[8],
        n_mels=ints[9], ftype=raw_ftype % GGML_QNT_VERSION_FACTOR,
    )

    n_mel, n_fft = _read_i32(f), _read_i32(f)
    filters = np.frombuffer(f.read(4 * n_mel * n_fft), dtype="<f4").reshape(n_mel, n_fft)

    n_tokens = _read_i32(f)
    vocab = []
    for _ in range(n_tokens):
        ln = _read_i32(f)
        vocab.append(f.read(ln) if ln > 0 else b"")

    tensors: dict[str, GGMLTensor] = {}
    while True:
        try:
            n_dims = _read_i32(f)
        except EOFError:
            break
        name_len = _read_i32(f)
        ttype = GGMLType(_read_i32(f))
        ne = [_read_i32(f) for _ in range(n_dims)]
        name = f.read(name_len).decode("utf-8")
        shape = tuple(reversed(ne))
        n_elements = int(np.prod(ne)) if ne else 1
        nbytes = type_size_bytes(ttype, n_elements)
        payload = f.read(nbytes)
        if len(payload) != nbytes:
            raise ValueError(f"truncated tensor data for '{name}'")
        if ttype == GGMLType.F32:
            raw = np.frombuffer(payload, dtype="<f4").reshape(shape)
        elif ttype == GGMLType.F16:
            raw = np.frombuffer(payload, dtype="<f2").reshape(shape)
        elif ttype == GGMLType.BF16:
            raw = np.frombuffer(payload, dtype="<u2").view(np.uint16)
            raw = (raw.astype(np.uint32) << 16).view(np.float32).reshape(shape)
        else:
            raw = np.frombuffer(payload, dtype=np.uint8)
        tensors[name] = GGMLTensor(name=name, shape=shape, ttype=ttype, raw=raw)

    return GGMLModelFile(hparams=hp, qntvr=qntvr, filters=filters.copy(),
                         vocab=vocab, tensors=tensors)


def write_ggml_file(
    path_or_buf,
    hparams: WhisperHParams,
    filters: np.ndarray,
    vocab: Iterable[bytes],
    tensors: Iterable[GGMLTensor],
    raw_ftype: int | None = None,
) -> None:
    """Write a checkpoint in the exact byte layout whisper_model_load parses."""
    if isinstance(path_or_buf, str):
        with open(path_or_buf, "wb") as f:
            _write(f, hparams, filters, vocab, tensors, raw_ftype)
    else:
        _write(path_or_buf, hparams, filters, vocab, tensors, raw_ftype)


def _write(f: BinaryIO, hparams: WhisperHParams, filters: np.ndarray,
           vocab: Iterable[bytes], tensors: Iterable[GGMLTensor],
           raw_ftype: int | None) -> None:
    f.write(struct.pack("<I", GGML_FILE_MAGIC))
    ftype = hparams.ftype if raw_ftype is None else raw_ftype
    for v in (hparams.n_vocab, hparams.n_audio_ctx, hparams.n_audio_state,
              hparams.n_audio_head, hparams.n_audio_layer, hparams.n_text_ctx,
              hparams.n_text_state, hparams.n_text_head, hparams.n_text_layer,
              hparams.n_mels, ftype):
        f.write(struct.pack("<i", v))

    filters = np.ascontiguousarray(filters, dtype="<f4")
    f.write(struct.pack("<ii", filters.shape[0], filters.shape[1]))
    f.write(filters.tobytes())

    vocab = list(vocab)
    f.write(struct.pack("<i", len(vocab)))
    for tok in vocab:
        if isinstance(tok, str):
            tok = tok.encode("utf-8")
        f.write(struct.pack("<i", len(tok)))
        f.write(tok)

    for t in tensors:
        name_b = t.name.encode("utf-8")
        ne = list(reversed(t.shape))
        f.write(struct.pack("<iii", len(ne), len(name_b), int(t.ttype)))
        for d in ne:
            f.write(struct.pack("<i", d))
        f.write(name_b)
        if t.ttype == GGMLType.F32:
            f.write(np.ascontiguousarray(t.raw, dtype="<f4").tobytes())
        elif t.ttype == GGMLType.F16:
            f.write(np.ascontiguousarray(t.raw, dtype="<f2").tobytes())
        elif t.ttype == GGMLType.BF16:
            v = np.ascontiguousarray(t.raw, dtype=np.float32)
            f.write((v.view(np.uint32) >> 16).astype("<u2").tobytes())
        else:
            f.write(np.ascontiguousarray(t.raw, dtype=np.uint8).tobytes())
