r"""Whisper vocabulary + tokenizer.

Mirrors the reference vocab semantics:
- special-token base ids and the multilingual shift
  (src/qwen2-whisper.cpp:418-447, :1487-1504)
- synthesized names for ids past the stored vocab (:1506-1537)
- tokenize(): GPT-2 word split + greedy longest-match against the vocab
  (:2677-2725); the reference does not run true BPE merges.

The ggml file stores raw token *bytes* (the converter already applied the
GPT-2 byte-decoder, models/convert-pt-to-ggml.py:242-255), so all matching
operates on bytes.

The word split is the GPT-2 pattern (reference :2683; openai/gpt-2
encoder.py)::

    's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+

written as a scanner (``split_words``) over ``unicodedata`` categories, as
the ``regex`` package that pattern needs is not everywhere: ``\p{L}`` is a
category ``L*``, ``\p{N}`` one ``N*``, marks (``M*``) fall in the third
class, and ``\s`` is the Unicode White_Space set (``_WHITESPACE``), which
leaves out U+001C..U+001F where ``str.isspace`` takes them in. Where the
``regex`` package's Unicode database is newer than ``unicodedata``'s, code
points that one calls unassigned (``Cn``) and the other a letter or number
split differently; assigned code points split alike.
"""

from __future__ import annotations

import dataclasses
import unicodedata

from qwen2_audio_tpu_torch.lang import LANGUAGES, lang_str

# the Unicode White_Space property: what \s matches in the GPT-2 pattern
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
    + "\u2028\u2029\u202f\u205f\u3000")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _cls(c: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' anything else."""
    if c in _WHITESPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def split_words(text: str) -> list[str]:
    """The GPT-2 pattern's ``findall`` (see the module docstring): at each
    position the first alternative that matches, in the pattern's order."""
    cls = [_cls(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        c = text[i]
        if c == "'":
            tail = next((t for t in _CONTRACTIONS if text.startswith(t, i + 1)), None)
            if tail is not None:
                out.append(text[i:i + 1 + len(tail)])
                i += 1 + len(tail)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': an optional ASCII
        # space, then a run of one class
        start = i
        k = cls[i]
        if c == " " and i + 1 < n and cls[i + 1] != "s":
            k = cls[i + 1]
            i += 1
        if k != "s":
            j = i + 1
            while j < n and cls[j] == k:
                j += 1
            out.append(text[start:j])
            i = j
            continue
        # '\s+(?!\S)' then '\s+': a whitespace run, less its last character
        # when a non-space follows and the run is longer than one
        j = i + 1
        while j < n and cls[j] == "s":
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out

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
        """Greedy longest-match tokenization (reference tokenize :2677-2725)."""
        out: list[int] = []
        for word in split_words(text):
            wb = word.encode("utf-8")
            i, n = 0, len(wb)
            while i < n:
                for j in range(n, i, -1):
                    tid = self.token_to_id.get(wb[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        break
                else:
                    i += 1   # an unknown byte: the reference logs it and moves on
        return out

    def is_non_speech(self, token_id: int) -> bool:
        """The token is on openai/whisper's non-speech suppression list
        (the suppress_non_speech_tokens handling of whisper_full_params)."""
        text = self.token_to_str(token_id).strip()
        return bool(text) and text in _NON_SPEECH


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


def language_token_ids(vocab: WhisperVocab) -> dict[str, int]:
    """Language code -> its token id, for the languages the vocab holds."""
    return {code: vocab.token_lang(i) for i, (code, _) in enumerate(LANGUAGES)
            if i < vocab.num_languages}
