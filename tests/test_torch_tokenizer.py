"""The port's tokenizer (tokenizer.py: the GPT-2 word split as a scanner over
``unicodedata``, greedy longest match, the non-speech list, the language
token ids) against the JAX package's, whose split is the ``regex`` pattern.

The split is held to ``_SPLIT_PAT.findall`` exactly, on text drawn from
assigned code points (category other than ``Cn``: where the ``regex``
package's Unicode database is newer than ``unicodedata``'s, code points
unassigned in the older one are letters or numbers in the newer, and there
the two split differently by design), U+001C..U+001F (``str.isspace`` but
not ``\\s``), contractions in both cases, combining marks and non-ASCII
digits. Token ids and every other result: equal."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from qwen2_audio_tpu import tokenizer as jtok
from qwen2_audio_tpu_torch import tokenizer as ttok
from qwen2_audio_tpu_torch.runtime.context import WhisperContext

PIECES = ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'T", "'RE", "'Ve", "'LL", "'D",
          "'", "''", " '", " ", "  ", "   ", "\t", "\n", "\r\n", "\x0b", "\x0c", "\x85",
          "\xa0", " ", "　", " ", "\x1c", "\x1d", "\x1e", "\x1f",
          "́", "̈", "é", " ́", "ि", "٣", "١٢", "²", "Ⅷ",
          "৪", "x", "A", "the", " the", "hello", "123", " 42", "?!", " ...", "日本",
          "\U0001f600", "ß", "Ω"]

ASSIGNED = st.characters(exclude_categories=("Cn", "Cs"))
TEXT = st.lists(st.one_of(st.sampled_from(PIECES), ASSIGNED, st.text(ASSIGNED, max_size=4)),
                max_size=24).map("".join)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(TEXT)
def test_split_matches_regex(text):
    assert ttok.split_words(text) == jtok._SPLIT_PAT.findall(text)


@pytest.mark.parametrize("text", [
    "", " ", "  ", "a ", "a  ", "  hello  world  ", "I'm don't 'S 'LL x'd", "''s", " 'x",
    "\x1c\x1d a \x1f", "\x1c \x1d  x", "été ٣٤ 12²", "x\xa0 y", "  　x",
    "tab\t\tend\t", "line\n\nnext\n", "́́ ́x", "it's 'tis ''m", "a 'll"])
def test_split_edges(text):
    assert ttok.split_words(text) == jtok._SPLIT_PAT.findall(text)


def test_whitespace_set_is_regex_s():
    """The scanner's whitespace is what ``regex``'s \\s matches over the BMP
    and the rest: not str.isspace (U+001C..U+001F differ)."""
    want = {c for c in map(chr, range(0x110000))
            if jtok._regex_mod.match(r"\s", c)}
    assert set(ttok._WHITESPACE) == want
    assert all(chr(c).isspace() and chr(c) not in want for c in range(0x1C, 0x20))


def _vocabs(n_vocab):
    surfaces = list(ttok.gpt2_bytes_to_unicode().values()) + [
        "Ġthe", "Ġworld", "hello", "he", "llo", "Ġw", "'s", "Ġ'", "ĠĠ", "ĠĠĠ", "12",
        "Ġ42", "Ã©", "Ġd", "ĠdÃ©", "æĹ¥", "âĢ¦", "Ċ", "ĊĊ"]
    toks = list(dict.fromkeys(ttok.token_surface_to_bytes(s) for s in surfaces))
    assert toks == list(dict.fromkeys(jtok.token_surface_to_bytes(s) for s in surfaces))
    return (ttok.WhisperVocab.from_token_list(toks, n_vocab),
            jtok.WhisperVocab.from_token_list(toks, n_vocab))


_VOCABS = _vocabs(51865)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(TEXT)
def test_tokenize_ids_match_jax(text):
    tv, jv = _VOCABS
    assert tv.tokenize(text) == jv.tokenize(text)


@pytest.mark.parametrize("text", ["hello world", "the world's 42 dé… 日本\n\n", "zzz",
                                  "  hello  ", "\x1c\x1fhéllo", ""])
def test_tokenize_fixed_texts(text):
    tv, jv = _VOCABS
    got = tv.tokenize(text)
    assert got == jv.tokenize(text)
    if text == "hello world":
        assert [tv.token_to_str(i) for i in got] == ["hello", " world"]


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
def test_is_non_speech_every_id(n_vocab):
    tv, jv = _vocabs(n_vocab)
    got = [i for i in range(n_vocab) if tv.is_non_speech(i)]
    assert got == [i for i in range(n_vocab) if jv.is_non_speech(i)]
    assert got   # the single-byte symbols are on the list
    assert ttok._NON_SPEECH == jtok._NON_SPEECH


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
def test_language_token_ids(n_vocab):
    tv, jv = _vocabs(n_vocab)
    assert ttok.language_token_ids(tv) == jtok.language_token_ids(jv)


def test_context_tokenize_and_count():
    """WhisperContext.tokenize / token_count are the vocab's."""
    tv, jv = _VOCABS
    ctx = object.__new__(WhisperContext)
    ctx.vocab = tv
    text = "hello the world's"
    assert ctx.tokenize(text) == jv.tokenize(text)
    assert ctx.token_count(text) == len(jv.tokenize(text))
