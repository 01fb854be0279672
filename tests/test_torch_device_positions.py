"""Per-stream device positions and the device-state decode loop against the
JAX package (CPU, float32): ``decoder_forward`` with a (B,) position tensor
against the JAX one with vector ``pos0``, and the port's ``GenState`` loop,
read every step and every 4 steps, against JAX ``generate_on_device``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.models.qwen2_audio import random_bundle as j_random_bundle
from qwen2_audio_tpu.runtime import generate as jgen
from qwen2_audio_tpu_torch.convert import bundle_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops import graphs as tgraphs
from qwen2_audio_tpu_torch.ops import linear as tlin
from qwen2_audio_tpu_torch.runtime import generate as tgen
from qwen2_audio_tpu_torch.runtime import sampling as tsamp

CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
LOGIT_ATOL = 1e-4   # float32 logits; the two frameworks sum in other orders
LP_ATOL = 1e-5      # float32 log-probabilities of the chosen tokens
KV_ATOL = 1e-5      # float32 K/V rows written by the forward
S = 16              # cache capacity of the forward cases


@pytest.fixture(scope="module")
def bundles():
    jb = j_random_bundle(np.random.default_rng(11), JCfg(**CFG), enc_state=64,
                         max_ctx=1024)
    return jb, bundle_from_jax(jb)


def _caches(quant: bool, seed: int = 1):
    """The same random cache contents as a JAX and a port cache (B = 2)."""
    r = np.random.default_rng(seed)
    shape = (CFG["num_hidden_layers"], 2, S, CFG["num_key_value_heads"], CFG["head_dim"])
    if quant:
        parts = [r.integers(-127, 128, shape).astype(np.int8),
                 (r.random(shape[:-1]) * 0.02).astype(np.float32),
                 r.integers(-127, 128, shape).astype(np.int8),
                 (r.random(shape[:-1]) * 0.02).astype(np.float32)]
        return (jd.QuantKVCache(*map(jnp.asarray, parts), pos=jnp.int32(0)),
                td.QuantKVCache(*(torch.from_numpy(p.copy()) for p in parts)))
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    return (jd.KVCache(jnp.asarray(k), jnp.asarray(v), pos=jnp.int32(0)),
            td.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _parts(cache) -> list[np.ndarray]:
    names = ("k_q", "k_s", "v_q", "v_s") if hasattr(cache, "k_q") else ("k", "v")
    return [np.asarray(getattr(cache, n)) for n in names]


@pytest.mark.parametrize("quant", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("T,pos", [(1, (5, 11)), (3, (4, S - 2))],
                         ids=["T1", "T3_past_capacity"])
def test_decoder_forward_vector_positions_match_jax(bundles, quant, T, pos):
    """B = 2 streams at their own positions; with T = 3 stream 1 runs past
    the capacity and its last row is dropped. Logits within LOGIT_ATOL;
    every cache row outside the written ones bit-equal, the written ones
    equal to KV_ATOL (float32) or one int8 step (the quantized cache)."""
    jb, tb = bundles
    x = np.random.default_rng(7).standard_normal((2, T, 64)).astype(np.float32)
    jc, tc = _caches(quant)
    before = _parts(tc)
    want, jc = jd.decoder_forward(jb.params, jb.cfg, jnp.asarray(x), jc,
                                  jnp.asarray(pos, jnp.int32))
    tpos = torch.tensor(pos, dtype=torch.int32)
    got, tc = td.decoder_forward(tb.params, tb.cfg, torch.from_numpy(x), tc, tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    assert torch.equal(tpos, torch.tensor(pos, dtype=torch.int32))   # not moved
    assert tc.pos == 0   # the high-water mark is the caller's for vector positions
    written = np.zeros((2, S), bool)
    for b, p in enumerate(pos):
        written[b, p:min(p + T, S)] = True
    for w, g, b0 in zip(_parts(jc), _parts(tc), before):
        np.testing.assert_array_equal(g[:, ~written], b0[:, ~written])
        np.testing.assert_array_equal(w[:, ~written], b0[:, ~written])
        if g.dtype == np.int8:
            assert np.abs(g[:, written].astype(int) - w[:, written]).max() <= 1
        else:
            np.testing.assert_allclose(g[:, written], w[:, written], atol=KV_ATOL, rtol=1e-6)


def test_write_rows_drops_rows_past_capacity():
    buf = torch.arange(2 * 4, dtype=torch.float32).view(2, 4, 1)
    val = torch.full((2, 3, 1), -1.0)
    td._write_rows(buf, val, td._cache_rows(torch.tensor([0, 2], dtype=torch.int32), 3, 4))
    assert buf[:, :, 0].tolist() == [[-1, -1, -1, 3], [4, 5, -1, -1]]
    td._write_rows(buf, val[:, :1], td._cache_rows(torch.tensor([4, 3], dtype=torch.int32),
                                                   1, 4))
    assert buf[:, :, 0].tolist() == [[-1, -1, -1, 3], [4, 5, -1, -1]]


def test_int_and_tensor_positions_give_the_same_bits(bundles):
    """A shared int position and the same position per stream as a tensor:
    the same logits and cache, bit for bit."""
    _, tb = bundles
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1, 64))
                         .astype(np.float32))
    outs = []
    for pos in (9, torch.tensor([9, 9], dtype=torch.int32)):
        _, tc = _caches(False)
        logits, tc = td.decoder_forward(tb.params, tb.cfg, x, tc, pos)
        outs.append((logits, tc.k, tc.v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# the greedy picks of the prefill below, free of EOS: stream 0 takes 48, 33,
# 79, 22, ..., stream 1 62, 40, 33, 70, ...; with 33 as the stop token the
# streams stop at steps 1 and 2
STOP = 33


def _case(jb, name):
    """(prefill (B, T0, D), suppress_mask, suppress_first, generate kwargs)."""
    V = CFG["vocab_size"]
    no_eos = np.zeros(V, np.float32)
    no_eos[jb.eos_token_id] = -np.inf
    x = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(np.float32)
    kw = dict(max_new_tokens=10, eos_token_id=STOP, cache_max_ctx=32)
    if name == "eos_at_different_steps":
        return x, None, None, kw
    if name == "capacity_stop":
        return x, no_eos, None, dict(kw, eos_token_id=jb.eos_token_id, cache_max_ctx=6 + 5)
    if name == "suppress_first":
        first = np.zeros(V, np.float32)
        first[[48, 62]] = -np.inf
        return x, None, first, kw
    if name == "repetition_penalty":
        return x, no_eos, None, dict(kw, eos_token_id=jb.eos_token_id,
                                      repetition_penalty=1.3)
    raise ValueError(name)


CASES = ("eos_at_different_steps", "capacity_stop", "suppress_first", "repetition_penalty")


@pytest.mark.parametrize("check_every", [1, 4])
@pytest.mark.parametrize("name", CASES)
def test_device_state_loop_matches_jax(bundles, name, check_every):
    jb, tb = bundles
    x, sup, first, kw = _case(jb, name)
    want = jgen.generate_on_device(
        jb.params, jb.cfg, jnp.asarray(x), None if sup is None else jnp.asarray(sup),
        None if first is None else jnp.asarray(first), cache_dtype=jnp.float32, **kw)
    got = tgen.generate_on_device(
        tb.params, tb.cfg, torch.from_numpy(x), None if sup is None else torch.from_numpy(sup),
        None if first is None else torch.from_numpy(first), cache_dtype=torch.float32,
        check_every=check_every, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=LP_ATOL)
    assert got[2] == int(want[2])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=LOGIT_ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=LOGIT_ATOL)
    toks = got[0].numpy()
    stops = [list(r).index(kw["eos_token_id"]) if kw["eos_token_id"] in r else None
             for r in toks]
    if name == "eos_at_different_steps":
        assert None not in stops and stops[0] != stops[1]
    elif name == "capacity_stop":
        assert got[2] == 5 and stops == [5, 5]   # EOS only as padding past count
    elif name == "suppress_first":
        assert not set(toks[:, 0]) & {48, 62}


@pytest.mark.parametrize("check_every", [1, 3, 4, 16])
def test_forwards_counted_and_budget_kept(bundles, check_every):
    """Read every step, the loop runs count - 1 forwards; read every n steps
    it replays at most n - 1 more after the last stream stops, and never
    past the budget or the capacity."""
    jb, tb = bundles
    x, sup, _, kw = _case(jb, "eos_at_different_steps")
    res = tgen._generate(tb.params, tb.cfg, torch.from_numpy(x), None, None,
                         cache_dtype=torch.float32, temperature=0.0, repetition_penalty=1.0,
                         top_k=0, top_p=1.0, seed=0, abort_callback=None, timings=None,
                         check_every=check_every, capture=False, **kw)
    count, forwards = res[2], res[5]
    assert count - 1 <= forwards < count - 1 + check_every
    assert forwards <= kw["max_new_tokens"] - 1
    if check_every == 1:
        assert forwards == count - 1
    x, sup, _, kw = _case(jb, "capacity_stop")
    res = tgen._generate(tb.params, tb.cfg, torch.from_numpy(x), torch.from_numpy(sup), None,
                         cache_dtype=torch.float32, temperature=0.0, repetition_penalty=1.0,
                         top_k=0, top_p=1.0, seed=0, abort_callback=None, timings=None,
                         check_every=check_every, capture=False, **kw)
    assert res[2] == 5 and res[5] == 4


def test_steps_after_every_stream_stopped_change_nothing_read(bundles):
    """Run the state until both streams stop, then step three more times:
    count, tokens, log-probabilities, the previous logits and the positions
    keep their values, bit for bit."""
    jb, tb = bundles
    x, _, _, kw = _case(jb, "eos_at_different_steps")
    smp = tgen.Sampling(kw["eos_token_id"], repetition_penalty=1.3)
    s = tgen.new_state(tb.cfg, 2, 10, 32, torch.float32, torch.device("cpu"), seen=True,
                       suppress=False, suppress_first=False, sampled=False)
    logits, _ = td.decoder_forward(tb.params, tb.cfg, torch.from_numpy(x), s.cache, 0,
                                   block_only=True, logits_last_only=True)
    tgen.load(s, logits[:, -1], 6, kw["eos_token_id"], 0, None, None)
    tgen.emit(s, smp)
    for _ in range(9):
        if bool(s.done.all()):
            break
        tgen.step(tb.params, tb.cfg, s, smp)
    assert bool(s.done.all())
    kept = [t.clone() for t in (s.count, s.tokens, s.logprobs, s.prev_logits, s.pos, s.done)]
    for _ in range(3):
        tgen.step(tb.params, tb.cfg, s, smp)
    for a, b in zip(kept, (s.count, s.tokens, s.logprobs, s.prev_logits, s.pos, s.done)):
        assert torch.equal(a, b)


def test_abort_callback_runs_after_every_step(bundles):
    """With a callback the loop reads the flags after every step, whatever
    check_every says, and calls the callback after each step that did not
    stop every stream: a true result ends the loop there."""
    jb, tb = bundles
    x, sup, _, kw = _case(jb, "capacity_stop")
    calls = []
    res = tgen.generate_on_device(tb.params, tb.cfg, torch.from_numpy(x),
                                  torch.from_numpy(sup), None, cache_dtype=torch.float32,
                                  check_every=8, abort_callback=lambda: len(calls) == 2
                                  or calls.append(1), **kw)
    assert res[2] == 3 and len(calls) == 2


def test_graph_keys_and_cache():
    """tree_key follows addresses, shapes, strides and types; the switches
    key follows each process switch; GraphCache drops the least recently
    used first."""
    w = torch.zeros(4, 6)
    tree = {"a": {"w": w}, "b": [w[:, :3]]}
    assert tgraphs.tree_key(tree) == tgraphs.tree_key({"a": {"w": w}, "b": [w[:, :3]]})
    for other in ({"a": {"w": w.clone()}, "b": [w[:, :3]]},
                  {"a": {"w": w}, "b": [w[:, :3].contiguous()]},
                  {"a": {"w": w.half()}, "b": [w[:, :3]]},
                  {"a": {"w": w.view(6, 4)}, "b": [w[:, :3]]}):
        assert tgraphs.tree_key(other) != tgraphs.tree_key(tree)
    base = tgraphs.switches()
    try:
        tlin.set_fused_mlp(False)
        assert tgraphs.switches() != base
        tlin.set_fused_mlp(None)
        tlin.set_group_matmul_mode("int8")
        assert tgraphs.switches() != base
    finally:
        tlin.set_group_matmul_mode(None)
        tlin.set_fused_mlp(None)
    assert tgraphs.switches() == base
    cache, made = tgraphs.GraphCache(2), []

    def make(k):
        return lambda: made.append(k) or k

    for k in ("a", "b", "a", "c", "b"):
        cache.get(k, make(k))
    assert made == ["a", "b", "c", "b"] and cache.values() == ["c", "b"]
    cache.clear()
    assert len(cache) == 0


def test_encoder_drops_its_graphs_with_its_weights():
    """The encoder's graphs read its weights by address: moving them (.to)
    drops the graphs; on the CPU the forward runs eagerly and keeps none."""
    from qwen2_audio_tpu_torch.config import WhisperHParams
    from qwen2_audio_tpu_torch.models import encoder as tenc
    hp = WhisperHParams(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=1,
                        n_mels=16)
    params = tenc.random_encoder_params(np.random.default_rng(0), hp)
    enc = tenc.Encoder(tenc.fuse_encoder_qkv(params), hp)
    mel = torch.zeros(1, 16, 2 * hp.n_audio_ctx)
    assert enc(mel).shape == (1, hp.n_audio_ctx // 2, 64)
    assert len(enc.graphs) == 0
    enc.graphs.get("key", lambda: "a graph")
    enc.to(torch.float64)
    assert len(enc.graphs) == 0


def test_one_graph_key_for_every_temperature(bundles):
    """The temperature is a device value of the state: a fallback's
    temperatures share one captured step; greedy and sampled steps do not.
    A tensor temperature draws from the generator alone (the same seed, the
    same tokens) and within the top k."""
    _, tb = bundles
    layout = (1, 8, 32, torch.float32)
    flags = dict(seen=False, suppress=False, suppress_first=False, sampled=True)
    smp = tgen.Sampling(7, top_k=5)
    key = tgen._step_key(tb.params, tb.cfg, layout, flags, smp, torch.device("cpu"))
    assert key == tgen._step_key(tb.params, tb.cfg, layout, dict(flags), smp,
                                 torch.device("cpu"))
    assert key != tgen._step_key(tb.params, tb.cfg, layout, dict(flags, sampled=False), smp,
                                 torch.device("cpu"))
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 40))
                              .astype(np.float32))
    draws = [tsamp.sample_token(logits, None, torch.Generator().manual_seed(s),
                                torch.tensor(t), top_k=5)[0]
             for s, t in ((1, 0.7), (1, 0.7), (2, 1.3))]
    assert torch.equal(draws[0], draws[1])
    top5 = torch.topk(logits, 5).indices
    for d in draws:
        assert all(int(d[b]) in top5[b].tolist() for b in range(2))


def test_capture_refused_off_the_card(bundles):
    _, tb = bundles
    x = torch.zeros(1, 3, 64)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tgen.generate_on_device(tb.params, tb.cfg, x, max_new_tokens=2, eos_token_id=0,
                                cache_max_ctx=8, capture=True)


def test_config_is_a_graph_key():
    assert hash(td.Qwen2DecoderConfig(**CFG)) == hash(dataclasses.replace(
        td.Qwen2DecoderConfig(**CFG)))
