"""The port's continuous-batching slot pool (runtime/generate.py:
``prefill_slot``, ``decode_chunk_slots``, ``decode_chunk_slots_spec``)
against the JAX package's, after tests/test_spec_slots.py: the same
weights and prefills give the same per-slot streams, positions and flags,
and the speculative pool emits exactly the plain pool's tokens (CPU,
float32 and the int8 cache).

Tolerances: tokens, positions, active flags, acceptance (iterations) and
draft histories equal, token for token; log-probabilities at 1e-5 and the
installed logits at 1e-4 (float32, as tests/test_torch_speculative.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.runtime import generate as jg
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import decoder_params_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops.graphs import GraphCache
from qwen2_audio_tpu_torch.runtime import generate as tg

LP_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _kw(vocab=64):
    return dict(vocab_size=vocab, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=32, tie_word_embeddings=False)


class _Model:
    """One set of random weights in both packages."""

    def __init__(self, seed, vocab=64):
        self.jcfg, self.tcfg = JCfg(**_kw(vocab)), TCfg(**_kw(vocab))
        self.jp = jd.random_decoder_params(np.random.default_rng(seed), self.jcfg)
        self.tp = decoder_params_from_jax(jax.tree.map(np.asarray, self.jp))
        self.V = vocab


def _prefills(seeds_t0):
    return [(np.random.default_rng(s).standard_normal((1, t0, 128)) * 0.1).astype(np.float32)
            for s, t0 in seeds_t0]


def _tdt(cache_dtype):
    return torch.float32 if cache_dtype == "f32" else "q8"


def _jdt(cache_dtype):
    return jnp.float32 if cache_dtype == "f32" else "q8"


def _tpool(m, prefills, S, cache_dtype="f32"):
    B = len(prefills)
    pool = (td.create_cache(m.tcfg, B, S, dtype=_tdt(cache_dtype)),
            torch.zeros(B, dtype=torch.int32), torch.zeros(B, m.V),
            torch.zeros(B, dtype=torch.bool))
    for s, pre in enumerate(prefills):
        tg.prefill_slot(m.tp, m.tcfg, *pool, s, torch.from_numpy(pre))
    return pool


def _jpool(m, prefills, S, cache_dtype="f32"):
    B = len(prefills)
    pool = (jd.create_cache(m.jcfg, B, S, dtype=_jdt(cache_dtype)),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B, m.V), jnp.float32),
            jnp.zeros((B,), bool))
    for s, pre in enumerate(prefills):
        pool = jg.prefill_slot(m.jp, m.jcfg, *pool, jnp.int32(s), jnp.asarray(pre))
    return pool


def _collect_plain(streams, toks, chunk, eos):
    """tests/test_spec_slots.py's plain-pool reading: up to and with EOS."""
    for b in range(len(streams)):
        for j in range(chunk):
            if streams[b] and streams[b][-1] == eos:
                break
            streams[b].append(int(toks[b, j]))
            if streams[b][-1] == eos:
                break


def run_plain(m, prefills, *, S, chunk, rounds, eos=-1, suppress=None, cache_dtype="f32",
              jax_too=False):
    """The port's plain pool (and, with ``jax_too``, JAX's beside it, every
    chunk's outputs compared); returns the port's streams, pos, active."""
    tpool = _tpool(m, prefills, S, cache_dtype)
    jpool = _jpool(m, prefills, S, cache_dtype) if jax_too else None
    sup_t = None if suppress is None else torch.from_numpy(suppress)
    streams = [[] for _ in prefills]
    for _ in range(rounds):
        out = tg.decode_chunk_slots(m.tp, m.tcfg, *tpool, sup_t, chunk=chunk, eos_token_id=eos)
        tpool, toks, lps = out[:4], out[4], out[5]
        if jax_too:
            jout = jg.decode_chunk_slots(m.jp, m.jcfg, *jpool,
                                         None if suppress is None else jnp.asarray(suppress),
                                         chunk=chunk, eos_token_id=eos)
            jpool = jout[:4]
            assert np.array_equal(toks.numpy(), np.asarray(jout[4]))
            np.testing.assert_allclose(lps.numpy(), np.asarray(jout[5]), atol=LP_ATOL, rtol=0)
            assert np.array_equal(tpool[1].numpy(), np.asarray(jpool[1]))
            assert np.array_equal(tpool[3].numpy(), np.asarray(jpool[3]))
            np.testing.assert_allclose(tpool[2].numpy(), np.asarray(jpool[2]),
                                       atol=LOGIT_ATOL, rtol=0)
        _collect_plain(streams, toks.numpy(), chunk, eos)
    return streams, tpool[1].numpy(), tpool[3].numpy()


def run_spec(m, prefills, *, S, chunk, rounds, eos=-1, suppress=None, spec_k=6, ngram=2,
             hbuf=128, cache_dtype="f32", jax_too=False, check_every=None):
    tpool = _tpool(m, prefills, S, cache_dtype)
    B = len(prefills)
    hist, hlen = torch.zeros(B, hbuf, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    if jax_too:
        jpool = _jpool(m, prefills, S, cache_dtype) + (jnp.zeros((B, hbuf), jnp.int32),
                                                       jnp.zeros((B,), jnp.int32))
    sup_t = None if suppress is None else torch.from_numpy(suppress)
    streams = [[] for _ in prefills]
    iters = []
    for _ in range(rounds):
        out = tg.decode_chunk_slots_spec(m.tp, m.tcfg, *tpool, hist, hlen, sup_t, chunk=chunk,
                                         eos_token_id=eos, spec_k=spec_k, ngram=ngram,
                                         check_every=check_every)
        tpool, (hist, hlen), toks, lps, n_new, it = out[:4], out[4:6], out[6], out[7], \
            out[8], out[9]
        assert toks.shape == (B, chunk + spec_k + 1)
        iters.append(int(it))
        if jax_too:
            jout = jg.decode_chunk_slots_spec(
                m.jp, m.jcfg, *jpool, None if suppress is None else jnp.asarray(suppress),
                chunk=chunk, eos_token_id=eos, spec_k=spec_k, ngram=ngram)
            jpool = jout[:6]
            assert np.array_equal(toks.numpy(), np.asarray(jout[6]))
            np.testing.assert_allclose(lps.numpy(), np.asarray(jout[7]), atol=LP_ATOL, rtol=0)
            assert np.array_equal(n_new.numpy(), np.asarray(jout[8]))
            assert int(it) == int(jout[9]), "iterations (acceptance) differ"
            for t, j in zip((tpool[1], tpool[3], hist, hlen), (jpool[1], jpool[3], jpool[4],
                                                                jpool[5])):
                assert np.array_equal(t.numpy(), np.asarray(j))
        for b in range(B):
            streams[b].extend(int(x) for x in toks[b, :int(n_new[b])])
    return streams, tpool[1].numpy(), tpool[3].numpy(), iters


@pytest.mark.parametrize("cache_dtype", ["f32", "q8"])
def test_prefill_slot_matches_jax(cache_dtype):
    """Each slot's K/V block, logits, position and flag equal JAX's; other
    slots' rows untouched; an odd capacity takes the int8 cache too."""
    m = _Model(1)
    pre = _prefills([(10, 5), (11, 3)])
    S = 13
    tpool, jpool = _tpool(m, pre, S, cache_dtype), _jpool(m, pre, S, cache_dtype)
    for t, j in zip(tpool[0].parts(), jax.tree.leaves(jpool[0])[:4]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    assert np.array_equal(tpool[1].numpy(), [5, 3]) and tpool[3].all()
    np.testing.assert_allclose(tpool[2].numpy(), np.asarray(jpool[2]), atol=LOGIT_ATOL, rtol=0)
    # slot 1's rows past its prompt stay as they were
    assert not tpool[0].parts()[0][:, 1, 3:].any()
    with pytest.raises(ValueError, match="slot"):
        tg.prefill_slot(m.tp, m.tcfg, *tpool, 2, torch.from_numpy(pre[0]))


@pytest.mark.parametrize("cache_dtype,suppress", [("f32", False), ("q8", False),
                                                  ("f32", True)])
def test_plain_and_spec_pools_match_jax(cache_dtype, suppress):
    """Both pools, chunk by chunk, against JAX's: tokens, log-probabilities,
    positions, flags, logits; the speculative one's acceptance and history."""
    m = _Model(11)
    pre = _prefills([(20, 4), (21, 7), (22, 5)])
    sup = None
    if suppress:
        sup = np.zeros(64, np.float32)
        sup[:8] = -np.inf
    want, wpos, wact = run_plain(m, pre, S=64, chunk=6, rounds=3, suppress=sup,
                                 cache_dtype=cache_dtype, jax_too=True)
    got, gpos, gact, _ = run_spec(m, pre, S=64, chunk=6, rounds=3, suppress=sup,
                                  cache_dtype=cache_dtype, jax_too=True)
    assert got == want
    np.testing.assert_array_equal(gpos, wpos)
    if suppress:
        assert not any(t < 8 for s in got for t in s)


def test_spec_slots_accept_on_cyclic_output():
    """A tiny vocabulary forces cycles: the slots accept drafts (fewer
    iterations than tokens) and stay exact per slot, as in JAX."""
    m = _Model(2, vocab=8)
    pre = _prefills([(30, 4), (31, 6)])
    want, _, _ = run_plain(m, pre, S=256, chunk=16, rounds=3)
    got, _, _, iters = run_spec(m, pre, S=256, chunk=16, rounds=3, spec_k=8, jax_too=True)
    assert got == want
    assert len(set(want[0])) < len(want[0])
    assert sum(iters) < 3 * 16


def test_spec_slots_eos_freezes_identically():
    m = _Model(2, vocab=8)
    pre = _prefills([(33, 4)])
    base, _, _ = run_plain(m, pre, S=128, chunk=24, rounds=1)
    eos = base[0][10]                  # the token plain greedy emits at step 10
    want, _, wact = run_plain(m, pre, S=128, chunk=24, rounds=1, eos=eos, jax_too=True)
    got, _, gact, _ = run_spec(m, pre, S=128, chunk=24, rounds=1, eos=eos, spec_k=5,
                               jax_too=True)
    assert got == want
    assert got[0][-1] == eos and got[0].count(eos) == 1
    assert not gact[0] and not wact[0]


def test_spec_slots_refill_midstream():
    """A finished slot refilled with a fresh stream (history reset) decodes
    it exactly as a fresh plain pool would."""
    m = _Model(2, vocab=8)
    pre_a, pre_b = _prefills([(50, 4), (51, 4)])
    want_b, _, _ = run_plain(m, [pre_b], S=128, chunk=8, rounds=2)
    pool = _tpool(m, [pre_a], 128)
    hist, hlen = torch.zeros(1, 128, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    tg.decode_chunk_slots_spec(m.tp, m.tcfg, *pool, hist, hlen, None, chunk=8,
                               eos_token_id=-1, spec_k=6)
    tg.prefill_slot(m.tp, m.tcfg, *pool, 0, torch.from_numpy(pre_b))
    hist[0] = 0
    hlen[0] = 0
    got = []
    for _ in range(2):
        out = tg.decode_chunk_slots_spec(m.tp, m.tcfg, *pool, hist, hlen, None, chunk=8,
                                         eos_token_id=-1, spec_k=6)
        got.extend(int(x) for x in out[6][0, :int(out[8][0])])
    assert got == want_b[0]


def test_spec_slots_quant_cache_cyclic_matches_plain():
    """The int8 cache's (B, K + 1) per-slot writes, values and scales, with
    acceptance: the plain int8-cache pool's streams and positions."""
    m = _Model(2, vocab=8)
    pre = _prefills([(60, 4), (61, 6)])
    want, wpos, _ = run_plain(m, pre, S=256, chunk=12, rounds=2, cache_dtype="q8")
    got, gpos, _, _ = run_spec(m, pre, S=256, chunk=12, rounds=2, spec_k=6, cache_dtype="q8",
                               jax_too=True)
    assert got == want
    np.testing.assert_array_equal(gpos, wpos)


def test_spec_slots_property_fuzz():
    """Random seeds, slot counts, chunks, spec widths, n-gram orders, vocab
    sizes, EOS choices and cache types: the speculative pool equals the
    plain pool stream for stream (tests/test_spec_slots.py's trials)."""
    base = np.random.default_rng(1234)
    for trial in range(6):
        vocab = int(base.choice([8, 16, 64]))
        B = int(base.integers(1, 4))
        chunk = int(base.integers(3, 12))
        spec_k = int(base.integers(2, 9))
        ngram = int(base.choice([2, 3]))
        rounds = int(base.integers(1, 4))
        eos = int(base.integers(0, vocab)) if base.random() < 0.5 else -1
        cdt = "q8" if base.random() < 0.3 else "f32"
        m = _Model(int(base.integers(1 << 30)), vocab=vocab)
        pre = [(np.random.default_rng(int(base.integers(1 << 30))).standard_normal(
            (1, int(base.integers(2, 8)), 128)) * 0.1).astype(np.float32) for _ in range(B)]
        S = 8 + max(p.shape[1] for p in pre) + rounds * chunk + spec_k + 1
        S = -(-S // 8) * 8
        tag = (trial, vocab, B, chunk, spec_k, ngram, rounds, eos, cdt)
        want, _, wact = run_plain(m, pre, S=S, chunk=chunk, rounds=rounds, eos=eos,
                                  cache_dtype=cdt)
        got, _, gact, _ = run_spec(m, pre, S=S, chunk=chunk, rounds=rounds, eos=eos,
                                   spec_k=spec_k, ngram=ngram, cache_dtype=cdt)
        assert got == want, (tag, got, want)
        np.testing.assert_array_equal(gact, wact, err_msg=str(tag))


@pytest.mark.parametrize("cache_dtype", ["f32", "q8"])
def test_spec_slots_capacity_boundary_matches_plain(cache_dtype):
    """Streams that exhaust the cache mid-chunk: the speculative pool emits
    exactly the plain pool's tokens (the accepted suffix clamped, the
    frozen slots' rows dropped past the capacity), as JAX's does."""
    m = _Model(2, vocab=8)
    pre = _prefills([(70, 4), (71, 6)])
    S = 24
    want, wpos, wact = run_plain(m, pre, S=S, chunk=12, rounds=2, cache_dtype=cache_dtype,
                                 jax_too=True)
    got, gpos, gact, _ = run_spec(m, pre, S=S, chunk=12, rounds=2, spec_k=6,
                                  cache_dtype=cache_dtype, jax_too=True)
    want = [[t for t in row if t != -1] for row in want]
    assert got == want, (got, want)
    np.testing.assert_array_equal(gpos, wpos)
    np.testing.assert_array_equal(gact, wact)
    assert not gact.any()


@pytest.mark.parametrize("check_every", [1, 3, 16])
def test_spec_iterations_after_the_stop_change_nothing(check_every):
    """The card replays iterations in groups and reads the condition once a
    group: iterations after it fails leave every output as it was."""
    m = _Model(2, vocab=8)
    pre = _prefills([(80, 4), (81, 5)])
    want = run_spec(m, pre, S=128, chunk=10, rounds=2, spec_k=4, check_every=1)
    got = run_spec(m, pre, S=128, chunk=10, rounds=2, spec_k=4, check_every=check_every)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])


class _NoHostRead(TorchDispatchMode):
    """Raises where an op reads a value back to the host or copies a Python
    value in (a CUDA graph can capture neither)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                    torch.ops.aten.lift_fresh.default):
            raise RuntimeError(f"a host read or copy: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_pool_steps_read_nothing_back(kind):
    """The steps the card captures read nothing back and copy nothing in
    (tests/test_torch_beam.py's dispatch check; over the float cache, as the
    int8 cache's CPU write route reads positions where the card's kernel
    reads them on the device)."""
    m = _Model(3)
    pool = _tpool(m, _prefills([(90, 4), (91, 6)]), 40)
    if kind == "plain":
        s = tg._pool_state(*pool, True, 5)
        st = tg.SlotSettings(7, 5)
        run = lambda: tg.slot_step(m.tp, m.tcfg, s, st)  # noqa: E731
    else:
        hist, hlen = torch.zeros(2, 32, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
        s = tg._pool_state(*pool, True, 5 + 4 + 1, hist, hlen)
        st = tg.SlotSettings(7, 5, 4, 2)
        run = lambda: tg.spec_slot_step(m.tp, m.tcfg, s, st)  # noqa: E731
    with _NoHostRead():
        run()
        run()
    assert int(s.i) == 2


def test_graph_cache_drop():
    """A pool's captured steps are dropped with it (they hold its cache)."""
    class G:
        def __init__(self, pos):
            self.state = type("S", (), {"pos": pos})()

    gc = GraphCache(4)
    a, b = torch.zeros(2), torch.zeros(2)
    gc.get("a", lambda: G(a))
    gc.get("b", lambda: G(b))
    gc.drop(lambda g: g.state.pos is a)
    assert len(gc) == 1 and gc.values()[0].state.pos is b


def test_chunk_arguments_checked():
    m = _Model(3)
    pool = _tpool(m, _prefills([(92, 4)]), 16)
    with pytest.raises(ValueError):
        tg.decode_chunk_slots(m.tp, m.tcfg, *pool, chunk=0, eos_token_id=1)
    with pytest.raises(ValueError):
        tg.decode_chunk_slots_spec(m.tp, m.tcfg, *pool, torch.zeros(1, 8, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32), chunk=4, eos_token_id=1,
                                   spec_k=0)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tg.decode_chunk_slots(m.tp, m.tcfg, *pool, chunk=2, eos_token_id=1, capture=True)
