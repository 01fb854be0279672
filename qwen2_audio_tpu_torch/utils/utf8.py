"""Incremental UTF-8 decoding across token boundaries.

Parity with the grammar remnant the reference kept (decode_utf8 +
whisper_partial_utf8, src/qwen2-whisper.cpp:777-786, 3602-3658): byte-level
BPE tokens can split multi-byte codepoints, so streaming text emission must
carry partial state between tokens.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PartialUtf8:
    """≙ whisper_partial_utf8: accumulated value + bytes remaining
    (-1 marks an invalid sequence)."""

    value: int = 0
    n_remain: int = -1


_LOOKUP = (1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4)


def decode_utf8(src: bytes, partial: PartialUtf8
                ) -> tuple[list[int], PartialUtf8]:
    """Decode bytes -> codepoints, resuming from `partial`
    (≙ decode_utf8 :3602-3658). Returns (code_points, new_partial)."""
    out: list[int] = []
    value = partial.value
    n_remain = partial.n_remain

    i = 0
    # continue a pending multi-byte sequence
    while i < len(src) and n_remain > 0:
        b = src[i]
        if (b & 0xC0) != 0x80:
            return out, PartialUtf8(0, -1)
        value = (value << 6) + (b & 0x3F)
        i += 1
        n_remain -= 1
        if n_remain == 0:
            out.append(value)
            value = 0
            n_remain = -1

    while i < len(src):
        first = src[i]
        highbits = first >> 4
        n_remain = _LOOKUP[highbits] - 1
        if n_remain < 0:
            return out, PartialUtf8(0, -1)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        i += 1
        while i < len(src) and n_remain > 0:
            b = src[i]
            if (b & 0xC0) != 0x80:
                return out, PartialUtf8(0, -1)
            value = (value << 6) + (b & 0x3F)
            i += 1
            n_remain -= 1
        if n_remain == 0:
            out.append(value)
            value = 0
            n_remain = -1

    return out, PartialUtf8(value if n_remain > 0 else 0,
                            n_remain if n_remain > 0 else -1)


class StreamingTextDecoder:
    """Accumulates token bytes and yields only complete codepoints — the
    building block for streaming segment callbacks."""

    def __init__(self) -> None:
        self._partial = PartialUtf8()
        self._buf = bytearray()

    def push(self, token_bytes: bytes) -> str:
        self._buf.extend(token_bytes)
        # find the longest prefix that decodes cleanly
        try:
            text = self._buf.decode("utf-8")
            self._buf.clear()
            return text
        except UnicodeDecodeError as e:
            if e.reason.startswith("unexpected end"):  # incomplete tail
                text = self._buf[: e.start].decode("utf-8")
                del self._buf[: e.start]
                return text
            # invalid byte: emit replacement and skip
            text = self._buf[: e.start].decode("utf-8", errors="replace")
            del self._buf[: e.start + 1]
            return text + "�"

    def flush(self) -> str:
        text = self._buf.decode("utf-8", errors="replace")
        self._buf.clear()
        return text
