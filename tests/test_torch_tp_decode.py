"""The port's tensor-parallel decode (qwen2_audio_tpu_torch/parallel/tp.py)
against the JAX package's single-device decoder_forward, after
tests/test_tp_decode.py: tp = 2 and 4 gloo ranks on the CPU, each running
the port's decoder on its Megatron shard, for dense, q8_0, q4_0 and w8a8
("fast") weights, the int8 cache, per-stream positions, the TP slot pool
(plain and speculative) and transcribe_continuous(mesh=...).

Each tp is one world (tests/test_torch_dist_workers.py::tp_world, spawned
through parallel.launch.spawn_world with a deadline, importing no JAX),
its ggml blocks multiplied in the exact dequantizing mode, which is the
JAX package's on the CPU.
Tolerances are JAX's own: logits atol = rtol = 2e-4, the gathered cache
1e-4; w8a8 TP quantizes the row-parallel o / down activations per shard, a
finer grouping than one device's, so its contract is e_tp <= 2 * e_single +
1e-4 against the dense forward (test_tp_decode.py:61-73). Streams and
segments equal, token for token."""

import io

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dist_workers as W
from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import GGMLType as JGGMLType
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.io.export import write_encoder_checkpoint
from qwen2_audio_tpu.models import qwen2_decoder as jdec
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.quant.qparams import quantize_decoder_params as j_quantize
from qwen2_audio_tpu.runtime import generate as jgen
from qwen2_audio_tpu_torch.config import GGMLType, Qwen2DecoderConfig
from qwen2_audio_tpu_torch.models.qwen2_decoder import (fuse_decoder_params,
                                                        panelize_decoder_params)
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.parallel.launch import spawn_world
from qwen2_audio_tpu_torch.parallel.tp import shard_decoder_for_tp, tp_local_cfg


@pytest.fixture(scope="module")
def ckpt() -> bytes:
    hp = JHP(**W.SERVE_HP)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp), hp,
                             mel_filterbank(hp.n_mels), [b"x"] * 60)
    return buf.getvalue()


@pytest.fixture(scope="module")
def worlds(ckpt) -> dict:
    return {tp: spawn_world(W.tp_world, tp, timeout=W.WORLD_TIMEOUT, args=(ckpt,))
            for tp in (2, 4)}


def _jparams(seed, cfg, quant=None):
    p = jdec.random_decoder_params(np.random.default_rng(seed), JCfg(**cfg))
    if quant == "fast":
        return j_quantize(p, JGGMLType.Q8_0, mode="fast")
    if quant is not None:
        return j_quantize(p, JGGMLType[quant.upper()])
    return p


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, tuple):       # (logits, this rank's cache): the logits
            a, b = a[0], b[0]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", W.QUANTS)
def test_tp_matches_single_device(worlds, quant, tp):
    cfg = W.tp_cfg(tp)
    jc = JCfg(**cfg)
    params = _jparams(31, cfg, quant)
    dense = _jparams(31, cfg)
    x = jdec.embed_tokens(dense, jnp.asarray(W.tokens(32, (2, 5))))
    want, wcache = jdec.decoder_forward(params, jc, x,
                                        jdec.create_cache(jc, 2, 16, dtype=jnp.float32), 0,
                                        block_only=True)
    ranks = worlds[tp]
    _same_on_every_rank(ranks, f"forward {quant}")
    got = ranks[0][f"forward {quant}"][0]
    gk = np.concatenate([r[f"forward {quant}"][1] for r in ranks], axis=3)  # kv heads
    wk = np.asarray(wcache.k)
    if quant == "fast":
        ref, _ = jdec.decoder_forward(dense, jc, x,
                                      jdec.create_cache(jc, 2, 16, dtype=jnp.float32), 0,
                                      block_only=True)
        e_single = float(np.abs(np.asarray(want) - np.asarray(ref)).max())
        e_tp = float(np.abs(got - np.asarray(ref)).max())
        assert e_tp <= 2.0 * e_single + 1e-4, (e_tp, e_single)
        # deeper layers see the residual stream of the per-shard scales
        np.testing.assert_allclose(gk[0], wk[0], atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(gk, wk, atol=1e-4, rtol=1e-4)


def test_tp_decode_step_vec_pos(worlds):
    """Per-stream positions (continuous batching) under TP = 2."""
    params = _jparams(41, W.CFG, "q8_0")
    dense = _jparams(41, W.CFG)
    jc = JCfg(**W.CFG)
    xp = jdec.embed_tokens(dense, jnp.asarray(W.tokens(42, (2, 6))))
    x1 = jdec.embed_tokens(dense, jnp.asarray(W.tokens(43, (2, 1))))
    cache = jdec.create_cache(jc, 2, 16, dtype=jnp.float32)
    _, cache = jdec.decoder_forward(params, jc, xp, cache, 0, block_only=True)
    want, _ = jdec.decoder_forward(params, jc, x1, cache, jnp.asarray([6, 3], jnp.int32))
    _same_on_every_rank(worlds[2], "vec pos")
    np.testing.assert_allclose(worlds[2][0]["vec pos"], np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_quant_cache(worlds, tp):
    """The int8 KV cache sharded on the kv-head axis under TP."""
    cfg = W.tp_cfg(tp)
    jc = JCfg(**cfg)
    x = jdec.embed_tokens(_jparams(51, cfg), jnp.asarray(W.tokens(52, (2, 5))))
    want, _ = jdec.decoder_forward(_jparams(51, cfg, "q8_0"), jc, x,
                                   jdec.create_cache(jc, 2, 16, dtype="q8"), 0,
                                   block_only=True)
    _same_on_every_rank(worlds[tp], "q8 cache")
    np.testing.assert_allclose(worlds[tp][0]["q8 cache"], np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_tp_rejects_fused_panels_words_and_bad_tp():
    """The unfused schema is required, panels and the word-packed q4_0 form
    are refused, and tp must divide the heads and the intermediate size."""
    params = W.decoder_params(61, W.CFG)
    with pytest.raises(ValueError, match="unfused"):
        shard_decoder_for_tp(fuse_decoder_params(params), None)
    q8 = W.decoder_params(61, W.CFG, "q8_0")
    with pytest.raises(ValueError, match="panelized"):
        shard_decoder_for_tp(panelize_decoder_params(q8), None)
    from qwen2_audio_tpu_torch.quant.qparams import Q4Form, quantize_decoder_params
    b32 = quantize_decoder_params(params, GGMLType.Q4_0, form=Q4Form(b32=True))
    with pytest.raises(ValueError, match="qs4b"):
        shard_decoder_for_tp(b32, None)
    with pytest.raises(ValueError, match="divide"):
        tp_local_cfg(Qwen2DecoderConfig(**W.CFG), 3)


def _jax_pool(tp: int, spec: bool) -> list[list[int]]:
    """tests/test_tp_decode.py's single-device pool."""
    cfg = W.pool_cfg(tp)
    jc = JCfg(**cfg)
    params = _jparams(71, cfg, "q8_0")
    B, S, HB = W.POOL["B"], W.POOL["S"], W.POOL["HB"]
    cache = jdec.create_cache(jc, B, S, dtype=jnp.float32)
    pos = jnp.zeros((B,), jnp.int32)
    logits = jnp.zeros((B, jc.vocab_size), jnp.float32)
    active = jnp.zeros((B,), bool)
    for s, pre in enumerate(W.pool_prefills()):
        cache, pos, logits, active = jgen.prefill_slot(params, jc, cache, pos, logits, active,
                                                       jnp.int32(s), jnp.asarray(pre))
    hist = jnp.zeros((B, HB), jnp.int32)
    hlen = jnp.zeros((B,), jnp.int32)
    streams = [[] for _ in range(B)]
    for _ in range(W.POOL["chunks"]):
        if spec:
            (cache, pos, logits, active, hist, hlen, toks, _l, n_new,
             _it) = jgen.decode_chunk_slots_spec(params, jc, cache, pos, logits, active, hist,
                                                 hlen, chunk=W.POOL["chunk"], eos_token_id=-1,
                                                 spec_k=W.POOL["spec_k"])
            n_new = np.asarray(n_new)
        else:
            before = np.asarray(pos)
            cache, pos, logits, active, toks, _l = jgen.decode_chunk_slots(
                params, jc, cache, pos, logits, active, chunk=W.POOL["chunk"],
                eos_token_id=-1)
            n_new = np.asarray(pos) - before
        t = np.asarray(toks)
        for b in range(B):
            streams[b].extend(int(v) for v in t[b, :n_new[b]])
    return streams


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_tp_slot_pool_matches_single(worlds, tp, spec):
    """The TP slot pool (prefill_slot, then the chunk decode, plain or
    batched-speculative) emits the single-device pool's streams: JAX's,
    and the port's own."""
    key = f"pool spec={spec}"
    _same_on_every_rank(worlds[tp], key)
    got = worlds[tp][0][key]
    assert got == _jax_pool(tp, spec)
    tl.set_group_matmul_mode("dequant")      # the ranks' mode, JAX's on the CPU
    try:
        assert got == W.pool_streams(tp, spec)
    finally:
        tl.set_group_matmul_mode(None)


def test_transcribe_continuous_tp_mesh(worlds, ckpt):
    """transcribe_continuous(mesh=tp2) yields the single-device segments
    (the JAX package's), on every rank."""
    from qwen2_audio_tpu import runtime as jrt
    from qwen2_audio_tpu.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu.runtime.serving import transcribe_continuous
    ctx = jrt.WhisperContext.init_from_buffer_with_params(ckpt)
    ctx.decoder = random_bundle(np.random.default_rng(3), JCfg(**W.CFG), enc_state=64,
                                max_ctx=512)
    p = jrt.FullParams(max_new_tokens=6, temperature_inc=0.0, speculative_k=5)
    want = sorted((s.t0_cs, tuple(s.tokens)) for s in transcribe_continuous(
        ctx, W.serve_audio(), p, max_streams=2, chunk_tokens=3))
    assert all(r["serve"] == want for r in worlds[2])
    assert want and all(toks for _, toks in want)


def test_tp_worlds_import_no_jax(worlds):
    assert all(r["jax_free"] for ranks in worlds.values() for r in ranks)
