"""The port's beam search against the JAX package's (CPU, float32): the
cache's hypothesis reorder and tiling, the device beam loop
(runtime/generate.py::beam_search_on_device) and the host loop
(runtime/decoding.py::beam_search), after tests/test_generate_device.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.runtime import decoding as jdec
from qwen2_audio_tpu.runtime import generate as jgen
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import decoder_params_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.runtime import decoding as tdec
from qwen2_audio_tpu_torch.runtime import generate as tgen

CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           tie_word_embeddings=False)
LP_ATOL = 1e-5      # float32 log-probabilities of the chosen tokens


def _jax_cache(q8: bool, B: int, S: int, seed: int):
    """A JAX cache of B streams filled from a seed (values, and for the int8
    cache, scales)."""
    rng = np.random.default_rng(seed)
    c = jd.create_cache(JCfg(**CFG), B, S, dtype="q8" if q8 else jnp.float32)
    if q8:
        return jd.QuantKVCache(
            k_q=jnp.asarray(rng.integers(-127, 128, c.k_q.shape), jnp.int8),
            k_s=jnp.asarray(rng.random(c.k_s.shape), jnp.float32),
            v_q=jnp.asarray(rng.integers(-127, 128, c.v_q.shape), jnp.int8),
            v_s=jnp.asarray(rng.random(c.v_s.shape), jnp.float32), pos=jnp.int32(5))
    return jd.KVCache(k=jnp.asarray(rng.standard_normal(c.k.shape), jnp.float32),
                      v=jnp.asarray(rng.standard_normal(c.v.shape), jnp.float32),
                      pos=jnp.int32(5))


def _to_torch(jc):
    leaves = {k: torch.from_numpy(np.array(v)) for k, v in jc._asdict().items() if k != "pos"}
    cls = td.QuantKVCache if "k_q" in leaves else td.KVCache
    return cls(**leaves, pos=int(jc.pos))


def _same_cache(jc, tc):
    for name, tv in zip(("k_q", "k_s", "v_q", "v_s") if "k_q" in jc._fields else ("k", "v"),
                        tc.parts()):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(jc, name)))
    assert tc.pos == int(jc.pos)


@pytest.mark.parametrize("q8", [False, True], ids=["f32_cache", "int8_cache"])
def test_tile_cache_matches_jax(q8):
    jc = _jax_cache(q8, 1, 12, 0)
    want = jd.tile_cache(jc, 4)
    _same_cache(want, td.tile_cache(_to_torch(jc), 4))
    # into a preallocated cache: copies only, the buffers keep their addresses
    out = _to_torch(_jax_cache(q8, 4, 12, 1))
    ptrs = [p.data_ptr() for p in out.parts()]
    assert td.tile_cache(_to_torch(jc), 4, out=out) is out
    _same_cache(want, out)
    assert [p.data_ptr() for p in out.parts()] == ptrs
    with pytest.raises(ValueError, match="does not tile"):
        td.tile_cache(_to_torch(jc), 3, out=out)


@pytest.mark.parametrize("q8", [False, True], ids=["f32_cache", "int8_cache"])
@pytest.mark.parametrize("src", [[2, 0, 0, 3], [0, 1, 2, 3], [3, 3, 3, 3]],
                         ids=["mixed", "identity", "one_beam"])
def test_reorder_matches_jax(q8, src):
    jc = _jax_cache(q8, 4, 10, 2)
    tc = _to_torch(jc)
    ptrs = [p.data_ptr() for p in tc.parts()]
    want = jc.reorder(jnp.asarray(src))
    assert tc.reorder(torch.tensor(src)) is tc
    _same_cache(want, tc)
    assert [p.data_ptr() for p in tc.parts()] == ptrs     # in place
    # a second reorder reuses the scratch of the first
    scratch = tc._scratch.data_ptr()
    tc.reorder(torch.tensor([1, 0, 3, 2]))
    _same_cache(want.reorder(jnp.asarray([1, 0, 3, 2])), tc)
    assert tc._scratch.data_ptr() == scratch


def test_topk_lower_first_matches_jax_on_ties():
    """Equal values come lower index first, as jax.lax.top_k gives them, at
    the edge of the k kept too; -inf and negative zero order as floats."""
    x = np.array([0.5, 2.0, -1.0, 2.0, 0.5, -np.inf, 2.0, 0.5, -3.0, 0.5], np.float32)
    for k in (1, 2, 3, 4, 5, 6, 10):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tgen.topk_lower_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    rng = np.random.default_rng(0)
    y = rng.integers(-3, 3, 5000).astype(np.float32) * 0.25
    wv, wi = jax.lax.top_k(jnp.asarray(y), 7)
    gv, gi = tgen.topk_lower_first(torch.from_numpy(y), 7)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.fixture(scope="module")
def bundles():
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder
    from qwen2_audio_tpu_torch.runtime.decoding import DecoderBundle
    jp = jd.random_decoder_params(np.random.default_rng(3), JCfg(**CFG))
    jb = jdec.DecoderBundle(cfg=JCfg(**CFG), params=jp, proj_w=jnp.eye(64),
                            proj_b=jnp.zeros(64), eos_token_id=95, bos_tokens=[],
                            post_audio_tokens=[], max_ctx=64, cache_dtype=jnp.float32)
    tb = DecoderBundle(cfg=TCfg(**CFG), decoder=Decoder(decoder_params_from_jax(jp), TCfg(**CFG)),
                       proj_w=torch.eye(64), proj_b=torch.zeros(64), eos_token_id=95,
                       bos_tokens=[], post_audio_tokens=[], max_ctx=64,
                       cache_dtype=torch.float32)
    return jb, tb


def _prompt(jb, tb, seed, T0=5):
    prompt = np.random.default_rng(seed).integers(2, 90, (1, T0))
    return (jd.embed_tokens(jb.params, jnp.asarray(prompt)),
            tb.decoder.embed(torch.from_numpy(prompt)))


def _eos_seen(tb, tx, max_new):
    """A token the beams emit partway: as the EOS it makes hypotheses
    finish, so that the snapshots and the final selection matter."""
    r = tgen.beam_search_device(tb, tx, beam_size=4, max_new_tokens=max_new)
    return r.tokens[0][3]


@pytest.mark.parametrize("eos", ["rare", "emitted"])
@pytest.mark.parametrize("length_penalty,rep_penalty",
                         [(-1.0, 1.0), (0.5, 1.0), (-1.0, 1.3), (0.5, 1.3)])
def test_device_and_host_beam_match_jax(bundles, length_penalty, rep_penalty, eos):
    jb, tb = bundles
    jx, tx = _prompt(jb, tb, 4)
    if eos == "emitted":
        jb.eos_token_id = tb.eos_token_id = _eos_seen(tb, tx, 10)
    sup = np.zeros(CFG["vocab_size"], np.float32)
    sup[[7, 11]] = -np.inf
    first = np.zeros(CFG["vocab_size"], np.float32)
    first[[3, 4]] = -np.inf
    kw = dict(beam_size=4, max_new_tokens=10, length_penalty=length_penalty,
              repetition_penalty=rep_penalty, suppress_mask=sup, suppress_first=first)
    try:
        want_dev = jgen.beam_search_device(jb, jx, **kw)
        want_host = jdec.beam_search(jb, jx, **kw)
        got_dev = tgen.beam_search_device(tb, tx, **kw)
        got_host = tdec.beam_search(tb, tx, **kw)
    finally:
        jb.eos_token_id = tb.eos_token_id = 95
    assert want_dev.tokens == want_host.tokens          # the JAX package's own parity
    for got in (got_dev, got_host):
        assert got.tokens == want_dev.tokens
        np.testing.assert_allclose(got.logprobs[0], np.asarray(want_dev.logprobs[0]),
                                   atol=LP_ATOL)
        np.testing.assert_allclose(got.logprobs[0], want_host.logprobs[0], atol=LP_ATOL)
        np.testing.assert_allclose(got.first_logits, np.asarray(want_dev.first_logits),
                                   atol=1e-4)
    # the host loop is the device loop read every step: the same bits
    assert got_host.logprobs == got_dev.logprobs
    assert got_dev.n_decode_forwards == got_host.n_decode_forwards


def test_beam_on_device_capacity_and_raw_entry(bundles):
    """beam_search_on_device itself, with the capacity stopping the search
    before the budget, against the JAX function."""
    jb, tb = bundles
    jx, tx = _prompt(jb, tb, 6, T0=7)
    kw = dict(beam_size=3, max_new_tokens=12, eos_token_id=95, cache_max_ctx=13)
    wt, wl, wn, wf = jgen.beam_search_on_device(jb.params, jb.cfg, jx, None, None,
                                                cache_dtype=jnp.float32, **kw)
    gt, gl, gn, gf = tgen.beam_search_on_device(tb.params, tb.cfg, tx, None, None,
                                                cache_dtype=torch.float32, **kw)
    assert gn == int(wn) == 6
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt)[:gn])
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl)[:gn], atol=LP_ATOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-4)


def test_beam_int8_cache_matches_jax(bundles):
    jb, tb = bundles
    jx, tx = _prompt(jb, tb, 8)
    kw = dict(beam_size=5, max_new_tokens=8, eos_token_id=95, cache_max_ctx=13)
    wt, wl, wn, _ = jgen.beam_search_on_device(jb.params, jb.cfg, jx, cache_dtype="q8", **kw)
    gt, gl, gn, _ = tgen.beam_search_on_device(tb.params, tb.cfg, tx, cache_dtype="q8", **kw)
    assert gn == int(wn)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt)[:gn])
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl)[:gn], atol=LP_ATOL)


def test_host_beam_abort_matches_jax(bundles):
    """The abort callback ends the host loop at the same token as JAX's."""
    jb, tb = bundles
    jx, tx = _prompt(jb, tb, 9)
    outs = []
    for mod, b, x in ((jdec, jb, jx), (tdec, tb, tx)):
        calls = []
        res = mod.beam_search(b, x, beam_size=3, max_new_tokens=10,
                              abort_callback=lambda: calls.append(1) or len(calls) >= 4)
        outs.append((res.tokens, len(calls)))
    assert outs[0] == outs[1]
    assert len(outs[1][0][0]) == 4


def test_beam_refuses_a_batch(bundles):
    _, tb = bundles
    with pytest.raises(ValueError, match="one stream"):
        tgen.beam_search_on_device(tb.params, tb.cfg, torch.zeros(2, 3, 64), beam_size=2,
                                   max_new_tokens=4, eos_token_id=95, cache_max_ctx=8,
                                   cache_dtype=torch.float32)


class _NoHostRead(TorchDispatchMode):
    """Raises where an op would read a tensor's value back to the host, or
    copy a Python value in from a host tensor (a CUDA graph can capture
    neither)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                    torch.ops.aten.lift_fresh.default):
            raise RuntimeError(f"a host read or copy: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["beam", "speculative", "greedy"])
def test_steps_read_nothing_back(bundles, kind):
    """The steps the card captures as CUDA graphs read no value back to the
    host (no .item(), no 0-dim tensor index, no data-dependent shape) and
    copy in no host tensor (no Python value assigned by index)."""
    _, tb = bundles
    cfg, p, cpu = tb.cfg, tb.params, torch.device("cpu")
    if kind == "beam":
        s = tgen.new_beam_state(cfg, 3, 10, 30, torch.float32, cpu, seen=True, suppress=True)
        s.count.fill_(1)
        s.base.fill_(5)
        run = lambda: tgen.beam_step(p, cfg, s, tgen.BeamSettings(3, 10, 0.5, 1.3))  # noqa: E731
    elif kind == "speculative":
        s = tgen.new_spec_state(cfg, 10, 4, 30, torch.float32, cpu, suppress_first=True)
        s.base.fill_(5)
        run = lambda: tgen.spec_step(p, cfg, s, tgen.SpecSettings(3, 10, 4, 2))  # noqa: E731
    else:
        s = tgen.new_state(cfg, 2, 10, 30, torch.float32, cpu, seen=True, suppress=True,
                           suppress_first=True, sampled=False)
        run = lambda: tgen.step(p, cfg, s, tgen.Sampling(3, 1.3))  # noqa: E731
    with _NoHostRead():
        run()
        run()
    x = torch.arange(4.0)
    with pytest.raises(RuntimeError, match="host read"), _NoHostRead():
        x[torch.tensor(1)]
    with pytest.raises(RuntimeError, match="host read or copy"), _NoHostRead():
        x[torch.arange(2)] = 1.0
