"""The port's Qwen2 decoder against the JAX package's on the same weights
(CPU, float32 unless stated)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import decoder_params_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td

SMALL = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16)
# d = 128 and g = 7, the 7B head layout, at a small width
WIDE = dict(vocab_size=64, hidden_size=256, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=14, num_key_value_heads=2,
            head_dim=128)
ATOL = 1e-4        # float32 logits; the two frameworks sum in other orders
BF16_ATOL = 5e-2   # bf16 logits of O(1): a few bf16 ulps of the largest


def _np(x):
    return np.asarray(x, np.float32)


def _pair(cfg_kw, seed=0, dtype=jnp.float32):
    jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
    jp = jd.random_decoder_params(np.random.default_rng(seed), jcfg, dtype=dtype)
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_config_copy_matches_jax():
    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(JCfg())
    assert TCfg().num_kv_groups == JCfg().num_kv_groups == 7


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_jax(dtype, rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jd.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-6)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = td.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), 1e-6)
    assert got.dtype == tdt
    # float32: summation order; bf16: one bf16 ulp at |x| ~ 3
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=1e-5 if dtype == jnp.float32 else 2e-2)


def test_rope_matches_jax(rng):
    pos = np.arange(40, 70)
    jc, js = jd.rope_angles(jnp.asarray(pos), 128, 1e6)
    tc, ts = td.rope_angles(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-6)   # f32 cos/sin
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-6)
    x = rng.standard_normal((2, 30, 3, 128)).astype(np.float32)
    want = jd.apply_rope(jnp.asarray(x), jc, js)
    got = td.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_quantize_kv_matches_jax(rng):
    x = rng.standard_normal((2, 7, 3, 128)).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero vector: scale 0
    jq, js = jd._quantize_kv(jnp.asarray(x))
    tq, ts = td._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))   # exact
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_random_decoder_params_same_draws():
    jcfg, tcfg = JCfg(**SMALL), TCfg(**SMALL)
    jp = jd.random_decoder_params(np.random.default_rng(3), jcfg)
    tp = td.random_decoder_params(np.random.default_rng(3), tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_random_decoder_params_torch_generator_shapes():
    tcfg = TCfg(**SMALL)
    g = torch.Generator().manual_seed(0)
    tp = td.random_decoder_params(g, tcfg, dtype=torch.bfloat16)
    ref = td.random_decoder_params(np.random.default_rng(0), tcfg)
    for key in ("q", "gate", "down"):
        assert tp["layers"][key]["w"].shape == ref["layers"][key]["w"].shape
        assert tp["layers"][key]["w"].dtype == torch.bfloat16
    assert 0.015 < tp["embed"].float().std().item() < 0.025   # scale 0.02


def test_convert_and_hf_loader_match_jax(rng):
    cfg = JCfg(**SMALL)
    D, I, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size
    nq, nkv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.standard_normal((V, D)),
          "model.norm.weight": rng.standard_normal(D),
          "lm_head.weight": rng.standard_normal((V, D))}
    for i in range(L):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (nq, D)), ("self_attn.k_proj", (nkv, D)),
                            ("self_attn.v_proj", (nkv, D))):
            sd[p + name + ".weight"] = rng.standard_normal(shape)
            sd[p + name + ".bias"] = rng.standard_normal(shape[0])
        for name, shape in (("self_attn.o_proj", (D, nq)), ("mlp.gate_proj", (I, D)),
                            ("mlp.up_proj", (I, D)), ("mlp.down_proj", (D, I))):
            sd[p + name + ".weight"] = rng.standard_normal(shape)
        sd[p + "input_layernorm.weight"] = rng.standard_normal(D)
        sd[p + "post_attention_layernorm.weight"] = rng.standard_normal(D)
    want = decoder_params_from_jax(jax.tree.map(
        np.asarray, jd.decoder_params_from_hf_state_dict(sd, cfg)))
    got = td.decoder_params_from_hf_state_dict(sd, TCfg(**SMALL))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def _run_both(cfg_kw, dtype, cache_dtype, T0=9, steps=3, seed=0):
    """Prefill (block_only) then ``steps`` single-position forwards fed the
    JAX argmax tokens, through both packages; returns the logits pairs."""
    jcfg, tcfg, jp, tp = _pair(cfg_kw, seed, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, T0, jcfg.hidden_size)).astype(np.float32)
    S = T0 + steps + 2
    jcache = jd.create_cache(jcfg, 2, S, dtype=cache_dtype)
    tcache = td.create_cache(tcfg, 2, S, dtype={jnp.float32: torch.float32,
                                                jnp.bfloat16: torch.bfloat16}.get(
                                                    cache_dtype, cache_dtype))
    jl, jcache = jd.decoder_forward(jp, jcfg, jnp.asarray(x, dtype), jcache, 0,
                                    block_only=True)
    tl, tcache = td.decoder_forward(tp, tcfg, torch.from_numpy(x).to(tdt), tcache, 0,
                                    block_only=True)
    out = [(_np(jl), tl.numpy())]
    assert tcache.pos == T0
    for step in range(steps):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1))
        jx = jd.embed_tokens(jp, jnp.asarray(tok)[:, None])
        tx = td.embed_tokens(tp, torch.from_numpy(tok)[:, None])
        jl, jcache = jd.decoder_forward(jp, jcfg, jx, jcache, T0 + step)
        tl, tcache = td.decoder_forward(tp, tcfg, tx, tcache, T0 + step)
        out.append((_np(jl), tl.numpy()))
    return out


@pytest.mark.parametrize("cfg_kw", [SMALL, WIDE], ids=["small", "d128_g7"])
def test_decoder_forward_f32_matches_jax(cfg_kw):
    for want, got in _run_both(cfg_kw, jnp.float32, jnp.float32):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_decoder_forward_bf16_matches_jax():
    for want, got in _run_both(WIDE, jnp.bfloat16, jnp.bfloat16):
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_decoder_forward_int8_cache_matches_jax():
    # the quantized cache path: same int8 values, scales folded the same way
    for want, got in _run_both(WIDE, jnp.float32, "q8"):
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_attention_and_unfused_layers_agree():
    """use_flash=False (plain einsum attention) and the unfused q/k/v,
    gate/up schema compute what the default path computes."""
    tcfg = TCfg(**WIDE)
    tp = td.random_decoder_params(np.random.default_rng(5), tcfg)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 11, tcfg.hidden_size)).astype(np.float32))
    outs = []
    for params, flash in ((td.fuse_decoder_params(tp), True), (tp, False)):
        cache = td.create_cache(tcfg, 1, 13, dtype=torch.float32)
        a, cache = td.decoder_forward(params, tcfg, x, cache, 0, block_only=True,
                                      logits_last_only=True, use_flash=flash)
        b, _ = td.decoder_forward(params, tcfg, x[:, :1], cache, 11, use_flash=flash)
        outs.append((a, b))
    assert outs[0][0].shape == (1, 1, tcfg.vocab_size)
    for u, v in zip(*outs):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=0)


def test_decoder_module_and_capacity_guard():
    tcfg = TCfg(**SMALL)
    dec = td.Decoder(td.random_decoder_params(np.random.default_rng(7), tcfg), tcfg)
    assert "qkv" in dec.params["layers"] and "q" not in dec.params["layers"]
    cache = td.create_cache(tcfg, 1, 4, dtype=torch.float32)
    x = dec.embed(torch.tensor([[1, 2, 3, 4]]))
    logits, cache = dec(x, cache, 0, block_only=True)
    assert logits.shape == (1, 4, tcfg.vocab_size) and cache.pos == 4
    with pytest.raises(ValueError, match="capacity"):
        dec(x[:, :1], cache, 4)
