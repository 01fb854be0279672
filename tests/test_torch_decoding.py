"""The port's sampling, generation loops and audio -> text runtime against
the JAX package (CPU, float32): same weights, same inputs, same tokens."""

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
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.models.qwen2_audio import random_bundle as j_random_bundle
from qwen2_audio_tpu.models.qwen2_decoder import embed_tokens as j_embed
from qwen2_audio_tpu.runtime import decoding as jdec
from qwen2_audio_tpu.runtime import generate as jgen
from qwen2_audio_tpu.runtime import sampling as jsamp
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import bundle_from_jax
from qwen2_audio_tpu_torch.models import qwen2_audio as taudio
from qwen2_audio_tpu_torch.runtime import decoding as tdec
from qwen2_audio_tpu_torch.runtime import generate as tgen
from qwen2_audio_tpu_torch.runtime import sampling as tsamp
from qwen2_audio_tpu_torch.runtime.context import ContextParams

CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
LOGIT_ATOL = 1e-4   # float32 logits; the two frameworks sum in other orders
LP_ATOL = 1e-5      # float32 log-probabilities of the chosen tokens


@pytest.fixture(scope="module")
def bundles():
    jb = j_random_bundle(np.random.default_rng(11), JCfg(**CFG), enc_state=64,
                         max_ctx=1024)
    return jb, bundle_from_jax(jb)


def _prefill(jb, tb, T0=7, seed=3):
    x = np.random.default_rng(seed).standard_normal((1, T0, 64)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_bundle_from_jax_and_random_bundle_draws(bundles):
    jb, tb = bundles
    assert tb.cfg == TCfg(**CFG) and tb.eos_token_id == jb.eos_token_id
    assert tb.cache_dtype == torch.float32 and tb.max_ctx == 1024
    tr = taudio.random_bundle(np.random.default_rng(11), TCfg(**CFG), 64, max_ctx=1024)
    np.testing.assert_array_equal(tr.proj_w.numpy(), tb.proj_w.numpy())
    np.testing.assert_array_equal(tr.params["layers"]["qkv"]["w"].numpy(),
                                  tb.params["layers"]["qkv"]["w"].numpy())
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    np.testing.assert_allclose(tb.project_audio(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.project_audio(x)), atol=1e-6)


def test_sampling_helpers_match_jax(rng):
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    seen = rng.random((3, 50)) < 0.3
    for pen in (1.0, 1.7):
        want = jsamp.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), pen)
        got = tsamp.apply_repetition_penalty(torch.from_numpy(logits),
                                             torch.from_numpy(seen), pen)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    for top_k, top_p in ((5, 1.0), (0, 0.8), (7, 0.5)):
        want = jsamp.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p)
        got = tsamp.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wt, wl = jsamp.sample_token(jnp.asarray(logits), jnp.asarray(seen),
                                jnp.zeros(2, jnp.uint32), 0.0, 1.3)
    gt, gl = tsamp.sample_token(torch.from_numpy(logits), torch.from_numpy(seen),
                                None, 0.0, 1.3)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LP_ATOL)
    assert float(tsamp.length_penalty_score(6.0, 3, -1.0)) == \
        float(jsamp.length_penalty_score(jnp.asarray(6.0), 3, -1.0))
    assert float(tsamp.length_penalty_score(6.0, 3, 1.0)) == \
        pytest.approx(float(jsamp.length_penalty_score(jnp.asarray(6.0), 3, 1.0)))


def test_temperature_sampling_draws_from_generator(rng):
    logits = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    draws = [tsamp.sample_token(logits, None, torch.Generator().manual_seed(s),
                                1.0, top_k=5)[0] for s in (1, 1, 2)]
    torch.testing.assert_close(draws[0], draws[1])
    top5 = torch.topk(logits, 5).indices
    for d in draws:
        assert all(int(d[b]) in top5[b].tolist() for b in range(2))


def _compare(want, got):
    assert got.tokens == want.tokens
    for a, b in zip(got.logprobs, want.logprobs):
        np.testing.assert_allclose(a, b, atol=LP_ATOL)
    np.testing.assert_allclose(got.first_logits, np.asarray(want.first_logits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.final_logits, np.asarray(want.final_logits),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("max_new,max_ctx", [(12, 1024), (30, 14)],
                         ids=["budget", "capacity_stop"])
def test_greedy_decode_device_matches_jax(bundles, max_new, max_ctx):
    jb, tb = bundles
    jx, tx = _prefill(jb, tb)
    sup = np.zeros(CFG["vocab_size"], np.float32)
    sup[[5, 9, jb.eos_token_id]] = -np.inf     # no EOS: the budget or capacity stops
    first = np.zeros(CFG["vocab_size"], np.float32)
    first[[3, 4]] = -np.inf
    jb.max_ctx = tb.max_ctx = max_ctx
    try:
        want = jgen.greedy_decode_device(jb, jx, max_new_tokens=max_new,
                                         suppress_mask=sup, suppress_first=first)
        got = tgen.greedy_decode_device(tb, tx, max_new_tokens=max_new,
                                        suppress_mask=sup, suppress_first=first)
    finally:
        jb.max_ctx = tb.max_ctx = 1024
    _compare(want, got)
    assert len(got.tokens[0]) == min(max_new, max_ctx - 7)
    assert got.n_decode_forwards == len(got.tokens[0]) - 1


def test_generate_on_device_eos_padding_matches_jax(bundles):
    """B = 2 streams; EOS made likely so streams stop at different steps."""
    jb, tb = bundles
    x = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(np.float32)
    bias = np.zeros(CFG["vocab_size"], np.float32)
    bias[jb.eos_token_id] = 2.5
    kw = dict(max_new_tokens=10, eos_token_id=jb.eos_token_id, cache_max_ctx=16)
    want = jgen.generate_on_device(jb.params, jb.cfg, jnp.asarray(x),
                                   jnp.asarray(bias), None, cache_dtype=jnp.float32, **kw)
    got = tgen.generate_on_device(tb.params, tb.cfg, torch.from_numpy(x),
                                  torch.from_numpy(bias), None,
                                  cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=LP_ATOL)
    assert got[2] == int(want[2])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=LOGIT_ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=LOGIT_ATOL)


def test_host_greedy_decode_matches_jax(bundles):
    jb, tb = bundles
    prompt = np.array([[3, 17, 40, 2, 8]])
    jx = j_embed(jb.params, jnp.asarray(prompt))
    tx = tb.decoder.embed(torch.from_numpy(prompt))
    stops = []
    want = jdec.greedy_decode(jb, jx, max_new_tokens=9, repetition_penalty=1.3)
    got = tdec.greedy_decode(tb, tx, max_new_tokens=9, repetition_penalty=1.3,
                             abort_callback=lambda: stops.append(1) and False)
    _compare(want, got)
    # the callback runs after every step that did not end in EOS; the
    # budget stop comes after it, with no forward to follow
    assert len(stops) == len(got.tokens[0]) == got.n_decode_forwards + 1


def test_token_statistics_match_jax():
    ids = [1, 2, 3, 1, 2, 3, 4] * 6
    assert tdec._token_entropy(ids) == jdec._token_entropy(ids)
    assert tdec._token_entropy([]) == jdec._token_entropy([])
    for text in ("la la la la " * 20, "ask not what your country can do", ""):
        assert tdec._compression_ratio(text) == jdec._compression_ratio(text)


def test_suppress_masks_match_jax(bundles):
    jb, tb = bundles
    words = {i: s for i, s in enumerate([" ", "", "#", "hello", " ♪", "x"] * 16)}
    fp = jrt.full_default_params()
    fp.suppress_regex = "^h"
    fp.suppress_non_speech_tokens = True
    for b in (jb, tb):
        b.token_strings = words.__getitem__
        b._suppress_cache.clear()
    try:
        np.testing.assert_array_equal(tdec.build_suppress_mask(tb, fp),
                                      jdec.build_suppress_mask(jb, fp))
        np.testing.assert_array_equal(tdec.build_blank_mask(tb, fp),
                                      jdec.build_blank_mask(jb, fp))
    finally:
        for b in (jb, tb):
            b.token_strings = None
            b._suppress_cache.clear()


HP = dict(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_mels=16)


@pytest.fixture(scope="module")
def contexts(bundles):
    """A JAX and a port context on one encoder checkpoint, each with the
    same random decoder attached."""
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


def test_whisper_full_audio_to_text_matches_jax(contexts):
    jctx, tctx = contexts
    x = (0.1 * np.random.default_rng(8).standard_normal(32000)).astype(np.float32)
    for ctx, params in ((jctx, jrt.full_default_params()),
                        (tctx, tcapi.whisper_full_default_params())):
        params.max_new_tokens = 8
        params.temperature_inc = 0.0
        assert ctx.full(params, x) == 0
    assert tctx.state.result_tokens == jctx.state.result_tokens
    assert len(tctx.state.result_tokens) > 0
    assert tcapi.whisper_full_n_segments(tctx) == jctx.full_n_segments() == 1
    assert tcapi.whisper_full_get_segment_text(tctx, 0) == jctx.full_get_segment_text(0)
    assert (tcapi.whisper_full_get_segment_t0(tctx, 0),
            tcapi.whisper_full_get_segment_t1(tctx, 0)) == (0, 3000)
    n = tcapi.whisper_full_n_tokens(tctx, 0)
    assert n == jctx.full_n_tokens(0)
    assert [tcapi.whisper_full_get_token_id(tctx, 0, j) for j in range(n)] == \
        tctx.state.result_tokens
    assert tcapi.whisper_full_get_token_text(tctx, 0, 0) == jctx.full_get_token_text(0, 0)
    np.testing.assert_allclose([tcapi.whisper_full_get_token_p(tctx, 0, j) for j in range(n)],
                               [jctx.full_get_token_p(0, j) for j in range(n)], atol=1e-5)
    assert tctx.state.no_speech_prob == pytest.approx(jctx.state.no_speech_prob, abs=1e-6)
    np.testing.assert_allclose(tcapi.whisper_get_logits(tctx), jctx.get_logits(),
                               atol=LOGIT_ATOL)
    assert tctx.state.n_decode_forwards == n - 1
    assert tctx.state.timings.n_prompt > 0 and tctx.state.timings.n_decode == n


@pytest.mark.parametrize("field,value,code", [
    ("detect_language", True, -6),
    ("translate", True, -7),
])
def test_refused_options_return_their_codes(contexts, field, value, code):
    _, tctx = contexts
    p = tcapi.whisper_full_default_params()
    setattr(p, field, value)
    x = (0.1 * np.random.default_rng(9).standard_normal(20000)).astype(np.float32)
    assert tcapi.whisper_full(tctx, p, x) == code


@pytest.mark.parametrize("opts", [
    dict(strategy="beam"),
    dict(strategy="beam", beam_size=3, length_penalty=0.5, abort_after=5),
    dict(token_timestamps=True, max_len=2),
    dict(speculative_k=4),
    dict(speculative_k=7, token_timestamps=True),
], ids=["beam", "beam_host_loop", "token_timestamps", "speculative", "speculative_timed"])
def test_decode_options_match_jax(contexts, opts):
    """The options the port once refused (beam -8, token_timestamps -9,
    speculative_k -10) through both packages' whisper_full: return code 0,
    the same tokens, segments and probabilities."""
    jctx, tctx = contexts
    x = (0.1 * np.random.default_rng(9).standard_normal(20000)).astype(np.float32)
    states = []
    for ctx, p in ((jctx, jrt.full_default_params()),
                   (tctx, tcapi.whisper_full_default_params())):
        p.max_new_tokens = 8
        p.temperature_inc = 0.0
        for k, v in opts.items():
            if k == "abort_after":
                calls = []
                p.abort_callback = lambda calls=calls, n=v: calls.append(1) or len(calls) >= n
            else:
                setattr(p, k, v)
        st = ctx.init_state()
        assert ctx.full_with_state(st, p, x) == 0
        states.append(st)
    js, ts = states
    assert ts.result_tokens == js.result_tokens and len(ts.result_tokens) > 0
    if "abort_after" in opts:
        # one check after the encode, then one after every token
        assert len(ts.result_tokens) == opts["abort_after"] - 1
    assert len(ts.segments) == len(js.segments) >= 1
    for w, g in zip(js.segments, ts.segments):
        assert {k: g[k] for k in g if k != "probs"} == {k: w[k] for k in w if k != "probs"}
        np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5)
    assert ts.no_speech_prob == pytest.approx(js.no_speech_prob, abs=1e-6)


def test_temperature_fallback_and_abort_path(contexts):
    """A schedule of temperatures runs the fallback (random weights give a
    low average logprob); the abort callback takes the host loop."""
    _, tctx = contexts
    p = tcapi.whisper_full_default_params()
    p.max_new_tokens = 4
    p.temperature_inc = 0.5          # schedule 0.0, 0.5, 1.0
    st = tctx.init_state()
    assert tctx.full_with_state(st, p, (0.1 * np.random.default_rng(10).standard_normal(
        20000)).astype(np.float32)) == 0
    assert st.timings.n_fail_p == 2
    p.temperature_inc = 0.0
    calls = []
    p.abort_callback = lambda: calls.append(1) and False
    st2 = tctx.init_state()
    assert tctx.full_with_state(st2, p, (0.1 * np.random.default_rng(10).standard_normal(
        20000)).astype(np.float32)) == 0
    # one check after the encode, then one after each step short of EOS
    assert st2.n_decode_forwards >= 1 and len(calls) >= st2.n_decode_forwards + 1
