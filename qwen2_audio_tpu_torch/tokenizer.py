"""Whisper vocabulary.

Mirrors the reference vocab semantics:
- special-token base ids and the multilingual shift
  (src/qwen2-whisper.cpp:418-447, :1487-1504)
- synthesized names for ids past the stored vocab (:1506-1537)

The ggml file stores raw token *bytes* (the converter already applied the
GPT-2 byte-decoder, models/convert-pt-to-ggml.py:242-255), so all matching
operates on bytes. Text tokenization (the GPT-2 word split, which needs the
``regex`` package) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

from qwen2_audio_tpu_torch.lang import lang_str

# openai/whisper tokenizer.py non_speech_tokens symbol set
_NON_SPEECH = set(
    '"#()*+/:;<=>@[\\]^_`{|}~「」『』<<>><<<>>><><<>>--***++=='.split() +
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') +
    ["<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", '("', '((', '))',
     '(((', ')))', '[[', ']]', '{{', '}}', '♪♪', '♪♪♪', '♩', '♪', '♫', '♬',
     '♭', '♮', '♯'])


@dataclasses.dataclass
class WhisperVocab:
    """Mirror of whisper_vocab (src/qwen2-whisper.cpp:418-447)."""

    n_vocab: int
    token_to_id: dict[bytes, int]
    id_to_token: dict[int, bytes]

    token_eot: int = 50256
    token_sot: int = 50257
    token_translate: int = 50357
    token_transcribe: int = 50358
    token_solm: int = 50359
    token_prev: int = 50360
    token_nosp: int = 50361
    token_not: int = 50362
    token_beg: int = 50363

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)

    @classmethod
    def from_token_list(cls, tokens: list[bytes], n_vocab: int) -> "WhisperVocab":
        """Build from the ggml file's stored vocab, applying the multilingual
        id shift and synthesizing names for the missing special ids
        (reference :1453-1540)."""
        t2i = {}
        i2t = {}
        for i, tok in enumerate(tokens):
            t2i[tok] = i
            i2t[i] = tok

        v = cls(n_vocab=n_vocab, token_to_id=t2i, id_to_token=i2t)
        if v.is_multilingual:
            v.token_eot += 1
            v.token_sot += 1
            dt = v.num_languages - 98
            v.token_translate += dt
            v.token_transcribe += dt
            v.token_solm += dt
            v.token_prev += dt
            v.token_nosp += dt
            v.token_not += dt
            v.token_beg += dt

        for i in range(len(tokens), n_vocab):
            if i > v.token_beg:
                word = f"[_TT_{i - v.token_beg}]"
            elif i == v.token_eot:
                word = "[_EOT_]"
            elif i == v.token_sot:
                word = "[_SOT_]"
            elif i == v.token_translate:
                word = "[_TRANSLATE_]"
            elif i == v.token_transcribe:
                word = "[_TRANSCRIBE_]"
            elif i == v.token_solm:
                word = "[_SOLM_]"
            elif i == v.token_prev:
                word = "[_PREV_]"
            elif i == v.token_nosp:
                word = "[_NOSP_]"
            elif i == v.token_not:
                word = "[_NOT_]"
            elif i == v.token_beg:
                word = "[_BEG_]"
            elif v.token_sot < i <= v.token_sot + v.num_languages:
                word = f"[_LANG_{lang_str(i - v.token_sot - 1)}]"
            else:
                word = f"[_extra_token_{i}]"
            b = word.encode("utf-8")
            v.token_to_id[b] = i
            v.id_to_token[i] = b
        return v

    def token_lang(self, lang_id_: int) -> int:
        """Language token id (whisper_token_lang :3508)."""
        return self.token_sot + 1 + lang_id_

    def token_to_str(self, token_id: int) -> str:
        return self.id_to_token.get(token_id, b"").decode("utf-8", errors="replace")

    def tokenize(self, text: str) -> list[int]:
        raise NotImplementedError(
            "text tokenization is not ported yet (ROADMAP.md, section 1, item 5)")


def gpt2_bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte <-> unicode table (openai/gpt-2 encoder.py) mapping
    every byte to a printable character in byte-level BPE vocab files."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_DECODER = {c: b for b, c in gpt2_bytes_to_unicode().items()}


def token_surface_to_bytes(surface: str) -> bytes:
    """Byte-level BPE token surface ('Ġthe') -> raw bytes (b' the'); special
    tokens whose characters are outside the table ('<|endoftext|>') pass
    through as UTF-8."""
    try:
        return bytes(_BYTE_DECODER[c] for c in surface)
    except KeyError:
        return surface.encode("utf-8")
