"""The port's serving layer (runtime/serving.py: ``encode_windows``,
``transcribe_long_form``, ``transcribe_continuous``, ``transcribe_many``;
``WhisperContext.full_parallel`` and ``capi.whisper_full_parallel``)
against the JAX package's, after the serving tests of tests/test_aux.py,
tests/test_spec_slots.py and tests/test_runtime_api.py (CPU, float32).
Both packages load the same ggml encoder checkpoint and the same random
decoder bundle.

Tolerances: segment tokens and window times equal JAX's, token for token;
segment probabilities at 1e-5 (float32 log-probabilities); the windows'
encoder output at 1e-4 (float32, tests/test_torch_encoder.py)."""

import io

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
from qwen2_audio_tpu.runtime import serving as jsv
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.convert import bundle_from_jax
from qwen2_audio_tpu_torch.runtime import decoding as tdec
from qwen2_audio_tpu_torch.runtime import serving as tsv
from qwen2_audio_tpu_torch.runtime.context import ContextParams, FullParams, WhisperContext

CPU = ContextParams(use_gpu=False)
HP = dict(n_vocab=64, n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_mels=16)     # 128-frame (1.28 s) windows keep the tests short
DEC = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           tie_word_embeddings=False)
LP_ATOL = 1e-5
ENC_ATOL = 1e-4


@pytest.fixture(scope="module")
def ckpt():
    hp = JHP(**HP)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp), hp,
                             mel_filterbank(hp.n_mels), [b"x"] * 60)
    return buf.getvalue()


def _ctxs(ckpt, max_ctx=512, seed=3, tweak=None):
    """(JAX context, port context) with the same encoder and decoder."""
    jb = j_random_bundle(np.random.default_rng(seed), JCfg(**DEC), enc_state=64,
                         max_ctx=max_ctx)
    if tweak is not None:
        tweak(jb)
    jctx = jrt.WhisperContext.init_from_buffer_with_params(ckpt)
    jctx.decoder = jb
    tctx = WhisperContext.init_from_buffer_with_params(ckpt, CPU)
    tctx.decoder = bundle_from_jax(jb)
    return jctx, tctx


def _audio(seconds, seed=8):
    return (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            ).astype(np.float32)


def _p(mod, **kw):
    return mod.FullParams(temperature_inc=0.0, **kw)


def _same_segments(jsegs, tsegs, jstate=None, tstate=None):
    assert [(s.t0_cs, s.t1_cs, s.tokens) for s in tsegs] == \
        [(s.t0_cs, s.t1_cs, s.tokens) for s in jsegs]
    assert all(s.tokens for s in tsegs)
    if jstate is not None:
        assert len(tstate.segments) == len(jstate.segments)
        for a, b in zip(tstate.segments, jstate.segments):
            assert (a["t0"], a["t1"], a["tokens"]) == (b["t0"], b["t1"], b["tokens"])
            np.testing.assert_allclose(a["probs"], b["probs"], atol=LP_ATOL, rtol=0)


def test_encode_windows_matches_jax(ckpt):
    """Buckets of 1 and of 3 (the last padded) give JAX's windows, as a
    device tensor."""
    jctx, tctx = _ctxs(ckpt)
    x = _audio(4)
    assert jctx.pcm_to_mel(x) == 0 and tctx.pcm_to_mel(x) == 0
    offs = tsv._chunk_offsets(tctx.state.mel.n_len_org, 64)
    assert offs == jsv._chunk_offsets(jctx.state.mel.n_len_org, 64) == [0, 128, 256, 384]
    want = jsv.encode_windows(jctx, jctx.state.mel, offs)
    for bs in (1, 3):
        got = tsv.encode_windows(tctx, tctx.state.mel, offs, batch_size=bs)
        assert isinstance(got, torch.Tensor) and got.device == tctx.device
        np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL, rtol=0)
    assert tctx.state.timings.n_encode == 8
    assert tsv._chunk_offsets(0, 64) == []


@pytest.mark.parametrize("strategy,batch", [("greedy", 2), ("greedy", 1), ("beam", 2)])
def test_transcribe_long_form_matches_jax(ckpt, strategy, batch):
    """tests/test_aux.py's long-form contract (one ordered segment per
    window, every window decoded) with JAX's tokens and probabilities."""
    jctx, tctx = _ctxs(ckpt, max_ctx=1024)
    x = _audio(5)
    kw = dict(max_new_tokens=4, strategy=strategy, beam_size=3)
    jsegs = list(jsv.transcribe_long_form(jctx, x, _p(jrt, **kw), batch_size=batch))
    tsegs = list(tsv.transcribe_long_form(tctx, x, _p(tsv, **kw), batch_size=batch))
    n = -(-tctx.state.mel.n_len_org // 128)
    assert len(tsegs) == n == tctx.full_n_segments()
    assert tsegs[0].t0_cs == 0
    assert all(b.t0_cs == a.t0_cs + 128 for a, b in zip(tsegs, tsegs[1:]))
    _same_segments(jsegs, tsegs, jctx.state, tctx.state)
    assert tctx.state.timings.n_decode >= sum(len(s.tokens) for s in tsegs) or \
        strategy == "beam"


def test_long_form_no_context_carries_transcript(ckpt, monkeypatch):
    """no_context=False: each window's tokens (EOS dropped) prefix the next
    window's prompt; n_max_text_ctx 0 ... 1 (keep = 0) carries nothing."""
    _, tctx = _ctxs(ckpt, max_ctx=1024)
    seen = []
    real = tsv._prefill_embeds

    def spy(bundle, audio, prompt):
        seen.append(list(prompt))
        return real(bundle, audio, prompt)

    monkeypatch.setattr(tsv, "_prefill_embeds", spy)
    x = _audio(3)
    segs = list(tsv.transcribe_long_form(tctx, x, _p(tsv, max_new_tokens=4, no_context=False),
                                         batch_size=4))
    assert len(segs) >= 2 and seen[0] == []
    assert seen[1] == [t for t in segs[0].tokens if t != tctx.decoder.eos_token_id]
    seen.clear()
    list(tsv.transcribe_long_form(tctx, x, _p(tsv, max_new_tokens=4, no_context=False,
                                              n_max_text_ctx=1)))
    assert all(p == [] for p in seen)


def test_transcribe_continuous_matches_long_form_and_jax(ckpt):
    """Continuous batching gives, per window, the lockstep batched decode's
    tokens (tests/test_aux.py) and JAX's pool's segments in JAX's
    completion order."""
    jctx, tctx = _ctxs(ckpt)
    x = _audio(5)
    p = dict(max_new_tokens=6, speculative_k=0)
    ref = list(tsv.transcribe_long_form(tctx, x, _p(tsv, **p), batch_size=2))
    got = list(tsv.transcribe_continuous(tctx, x, _p(tsv, **p), max_streams=2, chunk_tokens=3))
    want = list(jsv.transcribe_continuous(jctx, x, _p(jrt, **p), max_streams=2,
                                          chunk_tokens=3))
    by_t0 = {s.t0_cs: s for s in ref}
    assert len(got) == len(ref)
    for s in got:
        assert (s.tokens, s.t1_cs) == (by_t0[s.t0_cs].tokens, by_t0[s.t0_cs].t1_cs)
    _same_segments(want, got, jctx.state, tctx.state)


def test_transcribe_continuous_slot_reuse(ckpt):
    """More windows than slots: slots refill and every window decodes."""
    jctx, tctx = _ctxs(ckpt)
    x = _audio(10)
    p = dict(max_new_tokens=5, speculative_k=0)
    got = list(tsv.transcribe_continuous(tctx, x, _p(tsv, **p), max_streams=2, chunk_tokens=4))
    n = -(-tctx.state.mel.n_len_org // 128)
    assert len(got) == n > 2 and len(tctx.state.segments) == n
    want = list(jsv.transcribe_continuous(jctx, x, _p(jrt, **p), max_streams=2,
                                          chunk_tokens=4))
    _same_segments(want, got)


@pytest.mark.parametrize("sk", [7, -1])
def test_transcribe_continuous_spec_and_auto_match_plain(ckpt, sk):
    """speculative_k 7 (fixed) and -1 ("auto": 7 and adaptive on the CPU,
    both chunk modes sampled) emit the plain pool's segments; the fixed
    mode runs no plain chunk."""
    _, tctx = _ctxs(ckpt)
    x = _audio(5)

    def run(k):
        segs = tsv.transcribe_continuous(tctx, x, _p(tsv, max_new_tokens=6, speculative_k=k),
                                         max_streams=2, chunk_tokens=3)
        return sorted((s.t0_cs, s.tokens) for s in segs)

    assert run(sk) == run(0)
    run(sk)
    if sk < 0:
        assert tsv.LAST_POOL_STATS["spec_chunks"] >= 1
        assert tsv.LAST_POOL_STATS["plain_chunks"] >= 1
    else:
        assert tsv.LAST_POOL_STATS["plain_chunks"] == 0
        assert tsv.LAST_POOL_STATS["spec_chunks"] >= 1


def test_transcribe_many_matches_per_audio_runs_and_jax(ckpt):
    """Across requests: each audio's segments from the shared pool equal
    its own transcribe_continuous run, and JAX's transcribe_many."""
    jctx, tctx = _ctxs(ckpt)
    g = np.random.default_rng(8)
    audios = [(0.1 * g.standard_normal(16000 * n)).astype(np.float32) for n in (3, 2, 4)]
    p = dict(max_new_tokens=6, speculative_k=0)
    want = {}
    for a, smp in enumerate(audios):
        _, c = _ctxs(ckpt)
        segs = tsv.transcribe_continuous(c, smp, _p(tsv, **p), max_streams=2, chunk_tokens=4)
        want[a] = sorted((s.t0_cs, tuple(s.tokens)) for s in segs)
    got_list = list(tsv.transcribe_many(tctx, audios, _p(tsv, **p), max_streams=2,
                                        chunk_tokens=4))
    got = {a: sorted((s.t0_cs, tuple(s.tokens)) for b, s in got_list if b == a)
           for a in range(len(audios))}
    assert got == want
    jlist = list(jsv.transcribe_many(jctx, audios, _p(jrt, **p), max_streams=2,
                                     chunk_tokens=4))
    assert [(a, s.t0_cs, s.tokens) for a, s in got_list] == \
        [(a, s.t0_cs, s.tokens) for a, s in jlist]


def test_serving_honors_suppression(ckpt):
    """suppress_regex masks tokens in the pool and in the long-form decode."""
    surfaces = lambda b: setattr(b, "token_strings", lambda i: f"tok{i}")  # noqa: E731

    def run(fn, regex, **kw):
        _, tctx = _ctxs(ckpt, tweak=surfaces)
        p = _p(tsv, max_new_tokens=8, suppress_regex=regex, speculative_k=0)
        return [t for s in fn(tctx, _audio(3), p, **kw) for t in s.tokens]

    base = run(tsv.transcribe_continuous, "", max_streams=2, chunk_tokens=4)
    banned = base[0]
    for fn, kw in ((tsv.transcribe_continuous, dict(max_streams=2, chunk_tokens=4)),
                   (tsv.transcribe_long_form, dict(batch_size=2))):
        out = run(fn, f"^tok{banned}$", **kw)
        assert out and banned not in out, (fn.__name__, banned, out)


def test_serving_suppress_blank_and_capacity_parity(ckpt):
    """suppress_blank masks a blank first token in the pool; a stream frozen
    at the cache's capacity emits the same tokens with speculation on or
    off, and JAX's."""
    def run(mod, max_ctx, sk, blank=False, blank_tok=None):
        tweak = None
        if blank_tok is not None:
            tweak = lambda b: setattr(b, "token_strings",  # noqa: E731
                                      lambda i: " " if i == blank_tok else f"tok{i}")
        jctx, tctx = _ctxs(ckpt, max_ctx=max_ctx, tweak=tweak)
        ctx = tctx if mod is tsv else jctx
        p = (_p(tsv) if mod is tsv else _p(jrt))
        p.max_new_tokens, p.suppress_blank, p.speculative_k = 8, blank, sk
        segs = mod.transcribe_continuous(ctx, _audio(3), p, max_streams=1, chunk_tokens=4)
        return [tuple(s.tokens) for s in sorted(segs, key=lambda s: s.t0_cs)]

    first = run(tsv, 512, 0)[0][0]
    masked = run(tsv, 512, 0, blank=True, blank_tok=first)
    assert masked[0][0] != first
    plain = run(tsv, 40, 0)
    assert plain == run(tsv, 40, 7) == run(jsv, 40, 0)
    assert any(len(t) < 8 for t in plain)      # the capacity cut the streams


def test_append_hist_scatter():
    hist = torch.zeros(2, 6, dtype=torch.int32)
    hlen = torch.tensor([1, 5], dtype=torch.int32)
    toks = torch.tensor([[7, 8, 9], [3, 4, 5]], dtype=torch.int32)
    h2, l2 = tsv._append_hist(hist, hlen, toks, torch.tensor([2, 3]))
    assert h2 is hist and l2 is hlen        # in place: a captured step holds them
    assert hist.tolist() == [[0, 7, 8, 0, 0, 0], [0, 0, 0, 0, 0, 3]]
    assert hlen.tolist() == [3, 6]
    jh, jl_ = jsv._append_hist(np.zeros((2, 6), np.int32), np.asarray([1, 5], np.int32),
                               toks.numpy(), np.asarray([2, 3], np.int32))
    assert np.array_equal(np.asarray(jh), hist.numpy())
    assert np.array_equal(np.asarray(jl_), hlen.numpy())


def test_serving_segments_reset_per_call(ckpt):
    _, tctx = _ctxs(ckpt, max_ctx=1024)
    x = _audio(3)
    p = _p(tsv, max_new_tokens=3)
    n1 = len(list(tsv.transcribe_long_form(tctx, x, p, batch_size=2)))
    list(tsv.transcribe_long_form(tctx, x, p, batch_size=2))
    assert tctx.full_n_segments() == n1
    list(tsv.transcribe_continuous(tctx, x, p, max_streams=2, chunk_tokens=3))
    assert tctx.full_n_segments() == n1


def test_serving_initial_prompt_and_callbacks(ckpt):
    """initial_prompt reaches the serving prefill (tokenized, capped at
    n_max_text_ctx / 2); without a tokenizer it is ignored with a warning;
    the segment and progress callbacks run once a window."""
    _, tctx = _ctxs(ckpt, max_ctx=1024)
    b = tctx.decoder
    b.tokenize = lambda s: [5, 6, 7]
    assert tsv._base_prompt_tokens(b, FullParams(initial_prompt="glossary",
                                                 prompt_tokens=[9])) == [5, 6, 7, 9]
    b.tokenize = lambda s: list(range(10))
    assert tsv._base_prompt_tokens(b, FullParams(initial_prompt="x", n_max_text_ctx=4)) \
        == [0, 1]
    b.tokenize = lambda s: [5, 6, 7]
    calls = []
    p = _p(tsv, max_new_tokens=3, initial_prompt="glossary",
           new_segment_callback=lambda c, s, n: calls.append("seg"),
           progress_callback=lambda c, s, d: calls.append(d))
    segs = list(tsv.transcribe_long_form(tctx, _audio(2), p, batch_size=2))
    assert segs and all(s.tokens for s in segs)
    assert calls.count("seg") == len(segs) and calls[-1] == 100
    b.tokenize = None
    tdec._WARNED_FLAGS.discard("serving_initial_prompt")
    assert tsv._base_prompt_tokens(b, FullParams(initial_prompt="x")) == []
    assert "serving_initial_prompt" in tdec._WARNED_FLAGS


def test_pool_warns_refuses_mesh_and_needs_a_decoder(ckpt):
    """The greedy-only pool warns once on beam / temperature / repetition
    penalty; a mesh is taken, and refuses a decoder with fused projections
    (tensor parallelism needs the unfused schema; the tensor-parallel pool
    itself is tests/test_torch_tp_decode.py's); no decoder raises."""
    _, tctx = _ctxs(ckpt)
    x = _audio(2)
    for flag, kw in (("pool_beam", dict(strategy="beam")),
                     ("pool_temperature", dict(temperature=0.5)),
                     ("pool_rep_penalty", dict(repetition_penalty=1.3))):
        tdec._WARNED_FLAGS.discard(flag)
        list(tsv.transcribe_continuous(tctx, x, _p(tsv, max_new_tokens=3, **kw),
                                       max_streams=2, chunk_tokens=3))
        assert flag in tdec._WARNED_FLAGS
    with pytest.raises(ValueError, match="unfused"):
        list(tsv.transcribe_continuous(tctx, x, _p(tsv), mesh=object()))
    with pytest.raises(ValueError, match="unfused"):
        list(tsv.transcribe_many(tctx, [x], _p(tsv), mesh=object()))
    bare = WhisperContext.init_from_buffer_with_params(ckpt, CPU)
    for fn, arg in ((tsv.transcribe_long_form, x), (tsv.transcribe_continuous, x),
                    (tsv.transcribe_many, [x])):
        with pytest.raises(RuntimeError, match="decoder"):
            list(fn(bare, arg))


FP_HP = dict(n_vocab=64, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_mels=16)


@pytest.fixture(scope="module")
def full_ckpt():
    hp = JHP(**FP_HP)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(3), hp), hp,
                             mel_filterbank(hp.n_mels), [b"tok%d" % i for i in range(60)])
    return buf.getvalue()


def test_full_parallel_encoder_only_matches_jax(full_ckpt):
    """Without a decoder: n chunks, one encode at B = n, the chunks'
    embeddings one after the other, JAX's values."""
    x = _audio(4, seed=1)
    jctx = jrt.WhisperContext.init_from_buffer_with_params(full_ckpt)
    tctx = tcapi.whisper_init_from_buffer_with_params(full_ckpt, CPU)
    assert jctx.full_parallel(jrt.full_default_params(), x, n_processors=2) == 0
    assert tcapi.whisper_full_parallel(tctx, tcapi.whisper_full_default_params(), x,
                                       n_processors=2) == 0
    got = tctx.state.embd_enc
    assert isinstance(got, torch.Tensor) and got.shape == (2 * 750, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jctx.state.embd_enc), atol=ENC_ATOL,
                               rtol=0)
    assert tctx.state.timings.n_encode == 2


def test_full_parallel_transcribes_chunks(full_ckpt):
    """With a decoder: one decoded segment per 30 s window (65 s, 3
    windows), JAX's tokens, and each equal to a sequential full() at that
    window's offset; n_processors 1 is full()."""
    jb = j_random_bundle(np.random.default_rng(5), JCfg(**DEC), enc_state=64, max_ctx=1024)
    jctx = jrt.WhisperContext.init_from_buffer_with_params(full_ckpt)
    jctx.decoder = jb
    tctx = tcapi.whisper_init_from_buffer_with_params(full_ckpt, CPU)
    tctx.decoder = bundle_from_jax(jb)
    x = _audio(65, seed=2)

    def params(mod, **kw):
        p = mod.full_default_params()
        p.max_new_tokens, p.temperature_inc = 6, 0.0
        for k, v in kw.items():
            setattr(p, k, v)
        return p

    assert jctx.full_parallel(params(jrt), x, n_processors=2) == 0
    assert tcapi.whisper_full_parallel(tctx, params(tcapi), x, n_processors=2) == 0
    segs = tctx.state.segments
    assert len(segs) == 3 and all(s["tokens"] for s in segs)
    assert [s["tokens"] for s in segs] == [s["tokens"] for s in jctx.state.segments]
    assert tctx.state.result_tokens == [t for s in segs for t in s["tokens"]]
    for i, seg in enumerate(segs):
        c2 = WhisperContext.init_from_buffer_with_params(full_ckpt, CPU)
        c2.decoder = tctx.decoder
        assert c2.full(params(tcapi, offset_ms=i * 30_000), x) == 0
        assert c2.state.result_tokens == seg["tokens"]
    c3 = WhisperContext.init_from_buffer_with_params(full_ckpt, CPU)
    c3.decoder = tctx.decoder
    assert c3.full_parallel(params(tcapi), x, n_processors=1) == 0
    assert c3.state.result_tokens == segs[0]["tokens"]
