"""The port's text helpers (utils/text.py::similarity, utils/utf8.py) against
the JAX package's, on the same inputs: equal results."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from qwen2_audio_tpu.utils import text as jtext
from qwen2_audio_tpu.utils import utf8 as jutf8
from qwen2_audio_tpu_torch.utils import text as ttext
from qwen2_audio_tpu_torch.utils import utf8 as tutf8

WORDS = st.text(st.sampled_from("abcé日 ✓x"), max_size=12)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(WORDS, WORDS)
def test_similarity_matches_jax(a, b):
    assert ttext.similarity(a, b) == jtext.similarity(a, b)


def test_similarity_values():
    assert ttext.similarity("hello", "hello") == 1.0
    assert ttext.similarity("", "") == 1.0
    assert ttext.similarity("abc", "abd") == pytest.approx(2 / 3)
    assert ttext.similarity("abc", "") == 0.0


def _split(data: bytes, cuts: list[int]) -> list[bytes]:
    cuts = sorted({c % (len(data) + 1) for c in cuts})
    edges = [0, *cuts, len(data)]
    return [data[a:b] for a, b in zip(edges, edges[1:])]


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.binary(max_size=24) | st.text(max_size=8).map(str.encode),
       st.lists(st.integers(0, 64), max_size=5))
def test_decode_utf8_matches_jax(data, cuts):
    """Byte streams cut anywhere (invalid bytes included): the same code
    points and partial state after every piece."""
    tp, jp = tutf8.PartialUtf8(), jutf8.PartialUtf8()
    for piece in _split(data, cuts):
        tcp, tp = tutf8.decode_utf8(piece, tp)
        jcp, jp = jutf8.decode_utf8(piece, jp)
        assert tcp == jcp
        assert (tp.value, tp.n_remain) == (jp.value, jp.n_remain)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.binary(max_size=24) | st.text(max_size=8).map(str.encode),
       st.lists(st.integers(0, 64), max_size=5))
def test_streaming_text_decoder_matches_jax(data, cuts):
    td, jd = tutf8.StreamingTextDecoder(), jutf8.StreamingTextDecoder()
    for piece in _split(data, cuts):
        assert td.push(piece) == jd.push(piece)
    assert td.flush() == jd.flush()


def test_streaming_text_decoder_split_codepoint():
    d = tutf8.StreamingTextDecoder()
    data = "日本語".encode()
    out = d.push(data[:4])       # one whole character and one byte of the next
    assert out == "日"
    out += d.push(data[4:])
    assert out == "日本語" and d.flush() == ""
