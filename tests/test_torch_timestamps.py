"""The port's DTW token timestamps against the JAX package's (CPU, float32):
models/dtw.py, the decoder's attention tap, compute_token_timestamps,
split_segment_by_length and whisper_full with token_timestamps, max_len,
split_on_word and single_segment (after tests/test_timestamps_flags.py)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu import runtime as jrt
from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.io.export import write_encoder_checkpoint
from qwen2_audio_tpu.models import dtw as jdtw
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.models.qwen2_audio import random_bundle as j_random_bundle
from qwen2_audio_tpu.runtime import decoding as jdec
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.convert import bundle_from_jax
from qwen2_audio_tpu_torch.models import dtw as tdtw
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.runtime import decoding as tdec
from qwen2_audio_tpu_torch.runtime.context import ContextParams

CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           tie_word_embeddings=False)
LOGIT_ATOL = 1e-4   # float32 logits and taps, as tests/test_torch_decoding.py
LP_ATOL = 1e-5


def test_alignment_head_presets_match_jax():
    assert tdtw.ALIGNMENT_HEADS_PRESETS == jdtw.ALIGNMENT_HEADS_PRESETS


@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter_matches_jax(width):
    x = np.random.default_rng(width).standard_normal((3, 5, 40)).astype(np.float32)
    want = np.asarray(jdtw.median_filter(jnp.asarray(x), width))
    np.testing.assert_array_equal(tdtw.median_filter(torch.from_numpy(x), width).numpy(), want)
    with pytest.raises(ValueError, match="odd"):
        tdtw.median_filter(torch.from_numpy(x), 4)


def test_dtw_cost_matches_jax():
    a = np.random.default_rng(1).random((6, 50)).astype(np.float32)
    np.testing.assert_allclose(tdtw.dtw_cost(torch.from_numpy(a)).numpy(),
                               np.asarray(jdtw.dtw_cost(jnp.asarray(a))), atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (5, 30), (12, 12), (20, 9)])
def test_dtw_and_backtrace_matches_jax(shape):
    cost = np.random.default_rng(sum(shape)).standard_normal(shape)
    np.testing.assert_array_equal(tdtw.dtw_and_backtrace(cost), jdtw.dtw_and_backtrace(cost))


@pytest.mark.parametrize("n_content,fps", [(60, 25.0), (41, 50.0)])
def test_token_timestamps_from_attention_matches_jax(n_content, fps):
    attn = (np.random.default_rng(n_content).standard_normal((8, 9, 60)) * 3).astype(np.float32)
    want = jdtw.token_timestamps_from_attention(attn, n_content, frames_per_second=fps)
    got = tdtw.token_timestamps_from_attention(torch.from_numpy(attn), n_content,
                                               frames_per_second=fps)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0)


@pytest.fixture(scope="module")
def bundles():
    jb = j_random_bundle(np.random.default_rng(11), JCfg(**CFG), enc_state=64, max_ctx=512)
    return jb, bundle_from_jax(jb)


@pytest.mark.parametrize("attn_slice", [(7, 5, 2, 6), (0, 12, 0, 12), (11, 1, 3, 1)])
def test_attention_tap_matches_jax(bundles, attn_slice):
    jb, tb = bundles
    x = np.random.default_rng(2).standard_normal((2, 12, 64)).astype(np.float32)
    jc = jd.create_cache(jb.cfg, 2, 12, dtype=jnp.float32)
    wl, _, wt = jd.decoder_forward(jb.params, jb.cfg, jnp.asarray(x), jc, 0, block_only=True,
                                   logits_last_only=True, attn_slice=attn_slice)
    tc = td.create_cache(tb.cfg, 2, 12, dtype=torch.float32)
    gl, _, gt = td.decoder_forward(tb.params, tb.cfg, torch.from_numpy(x), tc, 0,
                                   block_only=True, logits_last_only=True, use_flash=False,
                                   attn_slice=attn_slice)
    assert gt.shape == (4, 2, 4, attn_slice[1], attn_slice[3]) == wt.shape
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=LOGIT_ATOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LOGIT_ATOL)


@pytest.mark.parametrize("block_only,use_flash", [(True, True), (False, False)])
def test_attention_tap_refused_off_the_plain_block(bundles, block_only, use_flash):
    _, tb = bundles
    tc = td.create_cache(tb.cfg, 1, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="attention tap"):
        td.decoder_forward(tb.params, tb.cfg, torch.zeros(1, 4, 64), tc, 0,
                           block_only=block_only, use_flash=use_flash,
                           attn_slice=(1, 2, 0, 2))


@pytest.mark.parametrize("n_top,n_content", [(-1, 20), (1, 13), (9, 20)])
def test_compute_token_timestamps_matches_jax(bundles, n_top, n_content):
    jb, tb = bundles
    x = np.random.default_rng(4).standard_normal((1, 24, 64)).astype(np.float32)
    ids = [5, 17, 3, 60, 22, 9, 41]
    kw = dict(aud0=2, n_aud=20, n_content=n_content, n_top=n_top, t_offset_cs=150)
    want = jdec.compute_token_timestamps(jb, jnp.asarray(x), ids, **kw)
    got = tdec.compute_token_timestamps(tb, torch.from_numpy(x), ids, **kw)
    assert got == want
    assert tdec.compute_token_timestamps(tb, torch.from_numpy(x), [], **kw) == []


@pytest.mark.parametrize("max_len,split_on_word", [(1, False), (6, False), (6, True),
                                                   (100, True)])
def test_split_segment_by_length_matches_jax(bundles, max_len, split_on_word):
    jb, tb = bundles
    words = {i: s for i, s in enumerate([" the", "re", " cat", "s", "!", " a", "\nb", "cd"] * 12)}
    ids = [0, 1, 2, 3, 4, 5, 6, 7, 2, 1]
    lps = list(np.linspace(-3.0, 0.2, len(ids)))
    times = [10 * i for i in range(len(ids))]
    for b in (jb, tb):
        b.token_strings = words.__getitem__
    try:
        want = jdec.split_segment_by_length(jb, ids, lps, times, max_len, split_on_word, 3000)
        got = tdec.split_segment_by_length(tb, ids, lps, times, max_len, split_on_word, 3000)
    finally:
        for b in (jb, tb):
            b.token_strings = None
    assert got == want
    assert [t for s in got for t in s["tokens"]] == ids


HP = dict(n_vocab=64, n_audio_ctx=128, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_mels=16)


@pytest.fixture(scope="module")
def contexts(bundles):
    jb, tb = bundles
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(2), JHP(**HP)),
                             JHP(**HP), mel_filterbank(16), [b"x"] * 60)
    jctx = jrt.WhisperContext.init_from_buffer_with_params(buf.getvalue())
    jctx.decoder = jb
    tctx = tcapi.whisper_init_from_buffer_with_params(buf.getvalue(),
                                                      ContextParams(use_gpu=False))
    tctx.decoder = tb
    return jctx, tctx


@pytest.mark.parametrize("opts", [
    dict(),
    dict(max_len=1),
    dict(max_len=8, split_on_word=True),
    dict(max_len=1, single_segment=True),
    dict(strategy="beam", max_len=3),
], ids=["one_segment", "max_len_1", "split_on_word", "single_segment", "beam"])
def test_whisper_full_token_timestamps_match_jax(contexts, opts):
    jctx, tctx = contexts
    x = (0.1 * np.random.default_rng(8).standard_normal(16000 * 3)).astype(np.float32)
    states = []
    for ctx, params in ((jctx, jrt.full_default_params()),
                        (tctx, tcapi.whisper_full_default_params())):
        params.max_new_tokens = 10
        params.temperature_inc = 0.0
        params.token_timestamps = True
        for k, v in opts.items():
            setattr(params, k, v)
        st = ctx.init_state()
        assert ctx.full_with_state(st, params, x) == 0
        states.append(st)
    js, ts = states
    assert ts.result_tokens == js.result_tokens and len(ts.result_tokens) > 0
    assert len(ts.segments) == len(js.segments)
    for w, g in zip(js.segments, ts.segments):
        assert {k: g[k] for k in g if k != "probs"} == {k: w[k] for k in w if k != "probs"}
        np.testing.assert_allclose(g["probs"], w["probs"], atol=LP_ATOL)
        times = g["token_times"]
        assert len(times) == len(g["tokens"])
        assert all(b >= a for a, b in zip(times, times[1:]))
    first, last = ts.segments[0], ts.segments[-1]
    assert all(first["t0"] <= t <= last["t1"] for s in ts.segments for t in s["token_times"])
    assert [t for s in ts.segments for t in s["tokens"]] == ts.result_tokens
    if opts.get("max_len") == 1 and not opts.get("single_segment"):
        assert len(ts.segments) == len(ts.result_tokens)
    if opts.get("single_segment") or not opts.get("max_len"):
        assert len(ts.segments) == 1
