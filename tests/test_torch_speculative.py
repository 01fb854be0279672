"""The port's n-gram speculative decoding (runtime/generate.py::
generate_speculative) against the JAX package's, after
tests/test_speculative.py: the same weights and inputs give the same
tokens, acceptance counts (iterations) and log-probabilities, and the same
tokens as plain greedy decoding (CPU, float32)."""

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
from qwen2_audio_tpu.models.qwen2_decoder import fuse_decoder_params as j_fuse
from qwen2_audio_tpu.models.qwen2_decoder import random_decoder_params as j_random_params
from qwen2_audio_tpu.runtime import generate as jgen
from qwen2_audio_tpu.runtime.decoding import DecoderBundle as JBundle
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import bundle_from_jax, decoder_params_from_jax
from qwen2_audio_tpu_torch.runtime import generate as tgen
from qwen2_audio_tpu_torch.runtime.context import ContextParams

LOGIT_ATOL = 1e-4   # float32 logits, as tests/test_torch_decoding.py
LP_ATOL = 1e-5      # float32 log-probabilities of the chosen tokens


def _cfg(vocab=64):
    return dict(vocab_size=vocab, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=32, tie_word_embeddings=False)


def _params(seed, vocab=64, fused=False):
    jp = j_random_params(np.random.default_rng(seed), JCfg(**_cfg(vocab)))
    if fused:
        jp = j_fuse(jp)
    return jp, decoder_params_from_jax(jp)


def _prefill(seed, T0):
    x = (np.random.default_rng(seed).standard_normal((1, T0, 128)) * 0.1).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _spec_both(vocab, pseed, xseed, T0, *, max_new, eos=-1, spec_k=6, ngram=2,
               suppress=None, cache_dtype="f32", fused=False):
    jp, tp = _params(pseed, vocab, fused)
    jx, tx = _prefill(xseed, T0)
    kw = dict(max_new_tokens=max_new, eos_token_id=eos,
              cache_max_ctx=T0 + max_new + spec_k + 8, spec_k=spec_k, ngram=ngram)
    jsup = None if suppress is None else jnp.asarray(suppress)
    tsup = None if suppress is None else torch.from_numpy(suppress)
    want = jgen.generate_speculative(
        jp, JCfg(**_cfg(vocab)), jx, jsup,
        cache_dtype=jnp.float32 if cache_dtype == "f32" else "q8", **kw)
    got = tgen.generate_speculative(
        tp, TCfg(**_cfg(vocab)), tx, tsup,
        cache_dtype=torch.float32 if cache_dtype == "f32" else "q8", **kw)
    return want, got


def _greedy(vocab, pseed, xseed, T0, *, max_new, eos=-1, suppress=None, cache_dtype="f32"):
    _, tp = _params(pseed, vocab)
    _, tx = _prefill(xseed, T0)
    return tgen.generate_on_device(
        tp, TCfg(**_cfg(vocab)), tx, None if suppress is None else torch.from_numpy(suppress),
        max_new_tokens=max_new, eos_token_id=eos, cache_max_ctx=T0 + max_new + 8,
        cache_dtype=torch.float32 if cache_dtype == "f32" else "q8")


def _same(want, got):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[2] == int(want[2])
    assert got[5] == int(want[5]), "iterations (acceptance) differ"
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=LP_ATOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=LOGIT_ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=LOGIT_ATOL)


def test_spec_matches_jax_and_greedy():
    want, got = _spec_both(64, 0, 1, 6, max_new=24)
    _same(want, got)
    g = _greedy(64, 0, 1, 6, max_new=24)
    np.testing.assert_array_equal(got[0].numpy(), g[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), g[1].numpy(), atol=2e-4)
    assert got[2] == g[2] == 24 and 1 <= got[5] <= 24


@pytest.mark.parametrize("spec_k,ngram", [(8, 2), (7, 3), (3, 1)])
def test_spec_accepts_on_cyclic_output(spec_k, ngram):
    """A tiny vocabulary drives the greedy sequence into a cycle: drafts are
    accepted, fewer iterations than tokens, the same acceptance as JAX."""
    want, got = _spec_both(8, 2, 3, 4, max_new=48, spec_k=spec_k, ngram=ngram)
    _same(want, got)
    g = _greedy(8, 2, 3, 4, max_new=48)
    np.testing.assert_array_equal(got[0].numpy(), g[0].numpy())
    assert got[2] == 48
    assert got[5] < got[2], "cyclic output must yield accepted drafts"


def test_spec_eos_stops_identically():
    g = _greedy(8, 2, 3, 4, max_new=16)
    eos = int(g[0][0, 10])
    want, got = _spec_both(8, 2, 3, 4, max_new=32, eos=eos)
    _same(want, got)
    g = _greedy(8, 2, 3, 4, max_new=32, eos=eos)
    assert got[2] == g[2]
    np.testing.assert_array_equal(got[0].numpy(), g[0].numpy())
    row = got[0][0, :got[2]].numpy()
    assert (row == eos).sum() == 1 and row[-1] == eos


def test_spec_suppress_mask():
    sup = np.zeros(64, np.float32)
    sup[:8] = -np.inf
    want, got = _spec_both(64, 5, 6, 5, max_new=20, suppress=sup)
    _same(want, got)
    g = _greedy(64, 5, 6, 5, max_new=20, suppress=sup)
    np.testing.assert_array_equal(got[0].numpy(), g[0].numpy())
    assert not np.isin(got[0][0, :got[2]].numpy(), np.arange(8)).any()


def test_spec_rejects_batch_capacity_and_sampling():
    _, tp = _params(7)
    cfg = TCfg(**_cfg())
    with pytest.raises(ValueError, match="B=1"):
        tgen.generate_speculative(tp, cfg, torch.zeros(2, 4, 128), max_new_tokens=8,
                                  eos_token_id=-1, cache_max_ctx=64, cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="headroom"):
        tgen.generate_speculative(tp, cfg, torch.zeros(1, 4, 128), max_new_tokens=8,
                                  eos_token_id=-1, cache_max_ctx=4 + 8 + 5, spec_k=6,
                                  cache_dtype=torch.float32)
    bundle = _bundle(tp, cfg)
    with pytest.raises(ValueError, match="greedy"):
        tgen.greedy_decode_device(bundle, torch.zeros(1, 4, 128), max_new_tokens=8,
                                  spec_k=4, temperature=0.5)


def _bundle(tp, cfg):
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder
    from qwen2_audio_tpu_torch.runtime.decoding import DecoderBundle
    return DecoderBundle(cfg=cfg, decoder=Decoder(tp, cfg), proj_w=torch.eye(128),
                         proj_b=torch.zeros(128), eos_token_id=-1, bos_tokens=[],
                         post_audio_tokens=[], max_ctx=128, cache_dtype=torch.float32)


@pytest.mark.parametrize("cache_ctx", [None, 20], ids=["call_sized", "caller_capacity"])
def test_spec_through_bundle_wrapper(cache_ctx):
    """greedy_decode_device with spec_k against JAX's and against spec_k 0;
    a caller's cache_ctx clips the budget as the plain loop's capacity does."""
    jp, tp = _params(2, 8)
    jx, tx = _prefill(3, 4)
    jb = JBundle(cfg=JCfg(**_cfg(8)), params=jp, proj_w=jnp.eye(128),
                 proj_b=jnp.zeros(128), eos_token_id=-1, bos_tokens=[],
                 post_audio_tokens=[], max_ctx=128, cache_dtype=jnp.float32)
    tb = _bundle(tp, TCfg(**_cfg(8)))
    want = jgen.greedy_decode_device(jb, jx, max_new_tokens=24, spec_k=6, cache_ctx=cache_ctx)
    got = tgen.greedy_decode_device(tb, tx, max_new_tokens=24, spec_k=6, cache_ctx=cache_ctx)
    plain = tgen.greedy_decode_device(tb, tx, max_new_tokens=24, cache_ctx=cache_ctx)
    assert got.tokens == want.tokens == plain.tokens
    assert len(got.tokens[0]) == (24 if cache_ctx is None else cache_ctx - 4)
    np.testing.assert_allclose(got.logprobs[0], want.logprobs[0], atol=LP_ATOL)
    np.testing.assert_allclose(got.logprobs[0], plain.logprobs[0], atol=2e-4)
    np.testing.assert_allclose(got.final_logits, np.asarray(want.final_logits), atol=LOGIT_ATOL)
    assert got.spec_iters == got.n_decode_forwards < len(got.tokens[0])


def test_spec_with_fused_params():
    outs = []
    for fused in (False, True):
        want, got = _spec_both(8, 2, 3, 4, max_new=32, fused=fused)
        _same(want, got)
        outs.append(got)
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    assert outs[0][2] == outs[1][2]


def test_spec_with_quant_kv_cache():
    """(K + 1)-position forwards through the int8 cache's writes and reads:
    JAX's tokens and acceptance, and plain greedy's tokens on that cache."""
    want, got = _spec_both(8, 2, 3, 4, max_new=32, cache_dtype="q8")
    _same(want, got)
    g = _greedy(8, 2, 3, 4, max_new=32, cache_dtype="q8")
    np.testing.assert_array_equal(got[0].numpy(), g[0].numpy())
    assert got[2] == g[2]


def test_spec_step_after_stop_changes_nothing():
    """A replay after the stop (the card reads the flag every few
    iterations) leaves every state tensor the caller reads as it was."""
    _, tp = _params(2, 8)
    _, tx = _prefill(3, 4)
    cfg = TCfg(**_cfg(8))
    s = tgen.new_spec_state(cfg, 10, 6, 4 + 10 + 6, torch.float32, torch.device("cpu"),
                            suppress_first=False)
    st = tgen.SpecSettings(-1, 10, 6, 2)
    first = tgen._prefill(tp, cfg, tx, s.cache, None)
    s.last_logits.copy_(first)
    s.prev_logits.copy_(first)
    s.tokens.fill_(-1)
    s.base.fill_(4)
    while int(s.count) < 10:
        tgen.spec_step(tp, cfg, s, st)
    before = [t.clone() for t in (s.tokens, s.logprobs, s.count, s.iters, s.last_logits,
                                  s.prev_logits, s.done)]
    for _ in range(3):
        tgen.spec_step(tp, cfg, s, st)
    for a, b in zip(before, (s.tokens, s.logprobs, s.count, s.iters, s.last_logits,
                             s.prev_logits, s.done)):
        assert torch.equal(a, b)


def test_spec_through_whisper_full():
    """FullParams.speculative_k reaches the device decode: both packages'
    whisper_full, and the port's plain greedy request, give the same
    tokens; "auto" (-1) is plain greedy in the port."""
    hp = JHP(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_mels=16)
    rng = np.random.default_rng(11)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(rng, hp), hp,
                             mel_filterbank(hp.n_mels), [b"x"] * 60)
    samples = (0.1 * rng.standard_normal(32000)).astype(np.float32)
    jb = j_random_bundle(np.random.default_rng(12), JCfg(**_cfg(16)), enc_state=64,
                         max_ctx=1024)
    jctx = jrt.WhisperContext.init_from_buffer_with_params(buf.getvalue())
    jctx.decoder = jb
    tctx = tcapi.whisper_init_from_buffer_with_params(buf.getvalue(),
                                                      ContextParams(use_gpu=False))
    tctx.decoder = bundle_from_jax(jb)
    outs = {}
    for name, ctx, params, k in (("jax", jctx, jrt.full_default_params(), 6),
                                 ("port", tctx, tcapi.whisper_full_default_params(), 6),
                                 ("port greedy", tctx, tcapi.whisper_full_default_params(), 0),
                                 ("port auto", tctx, tcapi.whisper_full_default_params(), -1)):
        params.max_new_tokens = 24
        params.temperature_inc = 0.0
        params.speculative_k = k
        st = ctx.init_state()
        assert ctx.full_with_state(st, params, samples) == 0
        outs[name] = (list(st.result_tokens), st.segments[0]["probs"],
                      st.n_decode_forwards if name != "jax" else None)
    assert outs["port"][0] == outs["jax"][0] == outs["port greedy"][0] == outs["port auto"][0]
    assert len(outs["port"][0]) > 0
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], atol=LP_ATOL)
    assert outs["port auto"][2] == outs["port greedy"][2] == len(outs["port"][0]) - 1
