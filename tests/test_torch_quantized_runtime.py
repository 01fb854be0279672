"""Quantized checkpoints and quantized decoders through the port's runtime
against the JAX package's (CPU; Pallas in interpret mode on the JAX side).
Both packages are set to the exact ("dequant") group-matmul mode unless a
test says otherwise: the JAX package's default depends on its device, the
port's is "bf16". Both run their one-launch SwiGLU MLP at decode M (the
default of each off the TPU)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import GGMLFType as JFType
from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHParams
from qwen2_audio_tpu.io.export import write_encoder_checkpoint
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu.runtime import ContextParams as JContextParams
from qwen2_audio_tpu.runtime import WhisperContext as JContext
from qwen2_audio_tpu.runtime import full_default_params as j_full_default_params
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.config import GGMLFType, GGMLType
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.convert import decoder_params_from_jax, quant_params_from_jax
from qwen2_audio_tpu_torch.io.export import quantize_checkpoint
from qwen2_audio_tpu_torch.models import encoder as te
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.quant import qparams as tq
from qwen2_audio_tpu_torch.runtime.context import ContextParams, WhisperContext
from qwen2_audio_tpu_torch.runtime.generate import generate_on_device

HP = dict(n_vocab=64, n_audio_ctx=256, n_audio_state=64, n_audio_head=4,
          n_audio_layer=2, n_mels=16)
DEC = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, tie_word_embeddings=False)
EMB_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(autouse=True)
def _exact_mode(monkeypatch):
    for var in ("QA_FUSED_MLP", "QA_PANEL_BN", "QA_PANEL_DEEP_K", "QA_PANEL_SKIP_GU"):
        monkeypatch.delenv(var, raising=False)
    jl.set_group_matmul_mode("dequant")
    tl.set_group_matmul_mode("dequant")
    yield
    jl.set_group_matmul_mode(None)
    tl.set_group_matmul_mode(None)
    tl.set_fused_mlp(None)


def _source(seed=0) -> bytes:
    hp = JHParams(**HP)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(seed), hp),
                             hp, mel_filterbank(hp.n_mels), [b"x"] * 60)
    return buf.getvalue()


@pytest.fixture(scope="module", params=["MOSTLY_Q8_0", "MOSTLY_Q4_0", "MOSTLY_Q5_1"])
def quantized_buf(request):
    dst = io.BytesIO()
    quantize_checkpoint(io.BytesIO(_source()), dst, GGMLFType[request.param])
    return request.param, dst.getvalue()


def test_keep_quantized_matches_dense_and_jax(quantized_buf):
    ftype, buf = quantized_buf
    samples = (0.1 * np.random.default_rng(1).standard_normal(32000)).astype(np.float32)

    dense = WhisperContext.init_from_buffer_with_params(
        buf, ContextParams(use_gpu=False, keep_quantized=False))
    assert "w" in dense.encoder.params["layers"][0]["qkv"]
    assert dense.full(tcapi.whisper_full_default_params(), samples) == 0

    kept = WhisperContext.init_from_buffer_with_params(buf, ContextParams(use_gpu=False))
    assert kept.params.keep_quantized          # the default
    qkv = kept.encoder.params["layers"][0]["qkv"]
    assert "w" not in qkv and {"qs", "qs4"} & set(qkv) and "b" in qkv
    if ftype == "MOSTLY_Q4_0":                 # packed, symmetric, f16 scales
        assert tq.payload_form(qkv) == "packed4+sym+u8+f16sc"
    assert "w" in kept.encoder.params["conv1"]  # conv, norm, positions stay dense
    assert kept.full(tcapi.whisper_full_default_params(), samples) == 0

    jctx = JContext.init_from_buffer_with_params(buf, JContextParams(keep_quantized=True))
    assert jctx.full(j_full_default_params(), samples) == 0

    got = kept.state.embd_enc.numpy()
    assert got.shape == (HP["n_audio_ctx"] // 2, HP["n_audio_state"])
    np.testing.assert_allclose(got, dense.state.embd_enc.numpy(), **EMB_TOL)
    np.testing.assert_allclose(got, np.asarray(jctx.state.embd_enc), **EMB_TOL)


def test_capi_quantized_context_bf16_mode(quantized_buf):
    """The default mode ("bf16") through capi: close to the exact mode."""
    _, buf = quantized_buf
    samples = (0.1 * np.random.default_rng(2).standard_normal(32000)).astype(np.float32)
    out = []
    for mode in ("dequant", None):
        tl.set_group_matmul_mode(mode)
        ctx = tcapi.whisper_init_from_buffer_with_params(buf, ContextParams(use_gpu=False))
        assert tcapi.whisper_full(ctx, tcapi.whisper_full_default_params(), samples) == 0
        out.append(ctx.state.embd_enc.numpy())
    assert tl.group_matmul_mode() == "bf16"
    np.testing.assert_allclose(out[1], out[0], atol=0.1)
    assert np.abs(out[1] - out[0]).max() > 0


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_K", "Q6_K"])
def test_fuse_encoder_qkv_over_block_dicts(fmt, rng):
    hp = WhisperHParams(**{**HP, "n_audio_state": 256, "n_audio_ctx": 64})
    params = te.random_encoder_params(rng, hp)
    q = tq.quantize_encoder_params(params, GGMLType[fmt])
    fused = te.fuse_encoder_qkv(q)
    lyr, f = q["layers"][0], fused["layers"][0]["qkv"]
    assert set(f) == set(lyr["q"]) and "q" not in fused["layers"][0]
    d = 256
    dense = tqm.dequantize_weight(f)
    for i, name in enumerate("qkv"):
        assert torch.equal(dense[:, i * d:(i + 1) * d], tqm.dequantize_weight(lyr[name]))
    assert torch.equal(f["b"][d:2 * d], torch.zeros(d))     # K has no bias
    mel = torch.from_numpy(rng.standard_normal((1, 16, 128)).astype(np.float32))
    a = te.encoder_forward(q, mel, hp)
    b = te.encoder_forward(fused, mel, hp)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    mixed = dict(q)
    mixed["layers"] = [dict(lyr, k={"w": params["layers"][0]["k"]["w"]})]
    with pytest.raises(ValueError, match="weight form"):
        te.fuse_encoder_qkv(mixed)


def test_quantize_encoder_params_matches_jax(rng):
    hp = JHParams(**HP)
    jp = random_encoder_params(np.random.default_rng(4), hp)
    jqp = jq.quantize_encoder_params(jp, JType.Q8_0)
    tp = tq.quantize_encoder_params(
        quant_params_from_jax(jax.tree.map(np.asarray, jp)), GGMLType.Q8_0)
    want = quant_params_from_jax(jax.tree.map(np.asarray, jqp))
    for a, b in zip(tp["layers"], want["layers"]):
        for key in ("q", "k", "v", "o", "fc1", "fc2"):
            assert set(a[key]) == set(b[key])
            for leaf in a[key]:
                assert torch.equal(a[key][leaf].float(), b[key][leaf].float()), (key, leaf)


def _decoders(fmt, form=None, seed=0, **over):
    """A JAX and a port decoder with the same ggml-quantized weights."""
    jcfg, tcfg = JCfg(**{**DEC, **over}), TCfg(**{**DEC, **over})
    jp = jd.random_decoder_params(np.random.default_rng(seed), jcfg)
    jqp = jq.quantize_decoder_params(jp, JType[fmt], form=form)
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp))
    tqp = tq.quantize_decoder_params(tp, GGMLType[fmt])
    return jcfg, tcfg, jp, jqp, tqp


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1", "Q5_0"])
def test_quantize_decoder_params_leaves_equal_jax(fmt):
    _, _, _, jqp, tqp = _decoders(fmt)
    want = quant_params_from_jax(jax.tree.map(np.asarray, jqp))
    assert set(tqp["layers"]) == set(want["layers"])
    for key in ("q", "k", "v", "o", "gate", "up", "down"):
        assert set(tqp["layers"][key]) == set(want["layers"][key]), key
        for leaf, val in tqp["layers"][key].items():
            assert val.shape == want["layers"][key][leaf].shape, (key, leaf)
            assert torch.equal(val.float(), want["layers"][key][leaf].float()), (key, leaf)
    for leaf, val in tqp["lm_head"].items():
        assert torch.equal(val.float(), want["lm_head"][leaf].float()), leaf
    assert tqp["layers"]["q"]["scales"].dtype == torch.float16
    assert "w" in tq.quantize_decoder_params(
        {"layers": {k: {"w": torch.zeros(1, 32, 32)} for k in
                    ("q", "k", "v", "o", "gate", "up", "down")},
         "lm_head": {"w": torch.zeros(32, 32)}}, GGMLType.Q8_0,
        quantize_lm_head=False)["lm_head"]


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1"])
def test_quantized_decoder_logits_and_tokens_match_jax(fmt, rng):
    jcfg, tcfg, jp, jqp, tqp = _decoders(fmt)
    toks = rng.integers(0, 128, (1, 6))
    jx = jd.embed_tokens(jp, jnp.asarray(toks))
    tx = td.embed_tokens(tqp, torch.from_numpy(toks))
    jqp, tqp = jd.fuse_decoder_params(jqp), td.fuse_decoder_params(tqp)
    assert {"qs", "qs4"} & set(tqp["layers"]["qkv"]) and "gate_up" in tqp["layers"]

    want, jcache = jd.decoder_forward(jqp, jcfg, jx, jd.KVCache.create(
        jcfg, 1, 16, dtype=jnp.float32), 0)
    got, tcache = td.decoder_forward(tqp, tcfg, tx, td.create_cache(
        tcfg, 1, 16, torch.float32), 0, block_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)

    # four greedy steps over the cache: the same tokens
    jtoks, ttoks = [], []
    jl_, tl_ = want[:, -1], got[:, -1]
    for step in range(4):
        jt, tt = int(jnp.argmax(jl_[0])), int(tl_[0].argmax())
        jtoks.append(jt)
        ttoks.append(tt)
        jl_, jcache = jd.decoder_forward(jqp, jcfg, jd.embed_tokens(
            jp, jnp.asarray([[jt]])), jcache, 6 + step)
        tl_, tcache = td.decoder_forward(tqp, tcfg, td.embed_tokens(
            tqp, torch.tensor([[tt]])), tcache, 6 + step)
        jl_, tl_ = jl_[:, -1], tl_[:, -1]
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=2e-3, rtol=1e-3)
    assert jtoks == ttoks

    # and the port's generation entry picks them too
    res = generate_on_device(tqp, tcfg, tx, max_new_tokens=4, eos_token_id=127,
                             cache_max_ctx=16, cache_dtype=torch.float32)
    assert res[0][0, :4].tolist() == ttoks


def test_quantized_decoder_bf16_mode_close_to_jax(rng):
    jl.set_group_matmul_mode("bf16")
    tl.set_group_matmul_mode("bf16")
    jcfg, tcfg, jp, jqp, tqp = _decoders("Q8_0", seed=1)
    toks = rng.integers(0, 128, (1, 5))
    want, _ = jd.decoder_forward(jd.fuse_decoder_params(jqp), jcfg, jd.embed_tokens(
        jp, jnp.asarray(toks)), jd.KVCache.create(jcfg, 1, 8, dtype=jnp.float32), 0)
    got, _ = td.decoder_forward(td.fuse_decoder_params(tqp), tcfg, td.embed_tokens(
        tqp, torch.from_numpy(toks)), td.create_cache(tcfg, 1, 8, torch.float32), 0,
        block_only=True)
    # x and w rounded to bf16 at the same places in both; float32 logits O(0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


def test_fuse_decoder_params_mixed_forms_keeps_separate(rng):
    _, tcfg, _, _, q8 = _decoders("Q8_0", seed=2)
    _, _, _, _, q4 = _decoders("Q4_0", seed=2)
    mixed = dict(q8)
    mixed["layers"] = dict(q8["layers"], v=q4["layers"]["v"])   # v at another type
    out = td.fuse_decoder_params(mixed)
    assert out is mixed and "qkv" not in out["layers"] and "gate" in out["layers"]
    # the separate projections still run, each through its own form
    x = td.embed_tokens(mixed, torch.from_numpy(rng.integers(0, 128, (1, 4))))
    lg, _ = td.Decoder(mixed, tcfg)(x, td.create_cache(tcfg, 1, 8, torch.float32), 0,
                                    block_only=True)
    assert lg.shape == (1, 4, 128) and bool(torch.isfinite(lg).all())
    # uniform forms fuse: 7 projections become 4, biases kept
    fused = td.fuse_decoder_params(q4)
    assert set(fused["layers"]) == {"ln1", "ln2", "qkv", "o", "gate_up", "down"}
    assert set(fused["layers"]["qkv"]) == {"qs4", "scales", "b"}
    assert fused["layers"]["qkv"]["qs4"].shape == (2, 32, 64 + 2 * 32)
    assert td.fuse_decoder_params(fused) is fused


def test_random_quant_decoder_params_forms():
    cfg = TCfg(**DEC)
    g = torch.Generator().manual_seed(0)
    for fmt, key in (("q8_0", "qs"), ("q4_0", "qs4")):
        p = td.random_quant_decoder_params(g, cfg, fmt, dtype=torch.float32)
        assert p["layers"]["down"][key].shape == (2, 128 if key == "qs" else 64, 64)
        assert p["layers"]["down"]["scales"].dtype == torch.float16
        assert "mins" not in p["lm_head"] and key in p["lm_head"]
        w = tqm.dequantize_weight({k: v[0] for k, v in p["layers"]["gate"].items()})
        assert 0.01 < float(w.std()) < 0.04
        dec = td.Decoder(p, cfg)
        lg, _ = dec(dec.embed(torch.tensor([[1, 2, 3]])),
                    td.create_cache(cfg, 1, 8, torch.float32), 0, block_only=True)
        assert bool(torch.isfinite(lg).all())
    with pytest.raises(ValueError):
        td.random_quant_decoder_params(g, cfg, "q5_0")


def test_bundle_from_jax_takes_quantized_trees(rng):
    from qwen2_audio_tpu.runtime.decoding import DecoderBundle as JBundle
    from qwen2_audio_tpu_torch.convert import bundle_from_jax
    jcfg, tcfg, jp, jqp, tqp = _decoders("Q4_0", seed=3)
    jb = JBundle(cfg=jcfg, params=jqp, proj_w=jnp.eye(64), proj_b=jnp.zeros(64),
                 eos_token_id=127, bos_tokens=[], post_audio_tokens=[], max_ctx=32,
                 cache_dtype=jnp.float32)
    tb = bundle_from_jax(jb)
    qkv = tb.params["layers"]["qkv"]
    assert qkv["qs4"].dtype == torch.uint8 and "mins" not in qkv
    want = td.fuse_decoder_params(tqp)["layers"]["qkv"]
    assert torch.equal(qkv["qs4"], want["qs4"])
    assert torch.equal(qkv["scales"].float(), want["scales"].float())


# the decode-tuned storage: fused gate_up with the one-launch SwiGLU, and the
# contiguous-panel forms, alone or beside it
TUNED = {   # name: (format, panelize, skip_gate_up, intermediate size)
    "q8_0-fused": ("Q8_0", False, False, 128),
    "q4_1-fused": ("Q4_1", False, False, 128),
    "q4_0-panel": ("Q4_0", True, False, 128),
    # down's K past 8192 stays strided, as in the 7B tower, so that with
    # gate_up left strided too the one-launch kernel runs beside the panels
    "q4_0-panel-skip-gate-up": ("Q4_0", True, True, 8192 + 256),
    "q8_0-panel-deep-down": ("Q8_0", True, False, 8192 + 256),
}
T0, STEPS = 70, 4      # a prefill past the one-launch kernel's 64 rows


@pytest.mark.parametrize("name", list(TUNED))
def test_decode_tuned_decoder_matches_jax(name, rng, monkeypatch):
    """A 2-layer quantized decoder in the JAX package's decode-tuned storage,
    carried across by ``bundle_from_jax``: a 70-position prefill (two-launch
    MLP) and four greedy steps (one-launch SwiGLU where gate_up is strided)
    through ``decoder_forward``; logits against the JAX decoder, and the
    port's switch on against off."""
    from qwen2_audio_tpu.runtime.decoding import DecoderBundle as JBundle
    from qwen2_audio_tpu_torch.convert import bundle_from_jax
    fmt, panel, skip_gu, inter = TUNED[name]
    if skip_gu:
        monkeypatch.setenv("QA_PANEL_SKIP_GU", "1")
    jcfg, tcfg, jp, jqp, _ = _decoders(fmt, seed=5, intermediate_size=inter)
    jqp = jd.fuse_decoder_params(jqp)
    if panel:
        jqp = jd.panelize_decoder_params(jqp)
    tb = bundle_from_jax(JBundle(cfg=jcfg, params=jqp, proj_w=jnp.eye(64),
                                 proj_b=jnp.zeros(64), eos_token_id=127, bos_tokens=[],
                                 post_audio_tokens=[], max_ctx=T0 + STEPS,
                                 cache_dtype=jnp.float32))
    tqp = tb.params
    layers = tqp["layers"]
    assert ("qs_p" in layers["qkv"] or "qs4_p" in layers["qkv"]) == panel
    assert ("qs" in layers["gate_up"] or "qs4" in layers["gate_up"]) == (not panel or skip_gu)
    assert bool({"qs_p", "qs4_p"} & set(layers["down"])) == (panel and inter <= 8192)
    assert tq.payload_form(layers["qkv"]) == {
        "q8_0-fused": "strided+sym+f16sc", "q4_1-fused": "packed4+mins+u8+f16sc",
        "q8_0-panel-deep-down": "strided-panel+sym+f16sc",
    }.get(name, "packed4-panel+sym+u8+f16sc")

    fused_calls = []
    real = td.fused_mlp_at
    monkeypatch.setattr(td, "fused_mlp_at", lambda x, gu, dn, li: (
        lambda y: (fused_calls.append((x.shape[1], y is not None)), y)[1])(real(x, gu, dn, li)))

    toks = rng.integers(0, 128, (1, T0))
    jx = jd.embed_tokens(jp, jnp.asarray(toks))
    tx = td.embed_tokens(tqp, torch.from_numpy(toks))

    def run_port():
        lg, cache = td.decoder_forward(tqp, tcfg, tx, td.create_cache(
            tcfg, 1, T0 + STEPS, torch.float32), 0, block_only=True, logits_last_only=True)
        out, picked = [lg[:, -1]], []
        for step in range(STEPS):
            picked.append(int(out[-1][0].argmax()))
            lg, cache = td.decoder_forward(tqp, tcfg, td.embed_tokens(
                tqp, torch.tensor([[picked[-1]]])), cache, T0 + step)
            out.append(lg[:, -1])
        return torch.stack(out).numpy(), picked

    got, ttoks = run_port()
    one_launch = not panel or skip_gu
    assert fused_calls == [(T0, False)] * 2 + [(1, one_launch)] * (2 * STEPS)

    want, jcache = jd.decoder_forward(jqp, jcfg, jx, jd.KVCache.create(
        jcfg, 1, T0 + STEPS, dtype=jnp.float32), 0, logits_last_only=True)
    jout, jtoks = [want[:, -1]], []
    for step in range(STEPS):
        jtoks.append(int(jnp.argmax(jout[-1][0])))
        lg, jcache = jd.decoder_forward(jqp, jcfg, jd.embed_tokens(
            jp, jnp.asarray([[jtoks[-1]]])), jcache, T0 + step)
        jout.append(lg[:, -1])
    np.testing.assert_allclose(got, np.asarray(jnp.stack(jout)), atol=2e-3, rtol=1e-3)
    assert ttoks == jtoks

    # the switch off: the per-projection path at every M, the same tokens
    tl.set_fused_mlp(False)
    fused_calls.clear()
    off, off_toks = run_port()
    assert all(not taken for _, taken in fused_calls)
    np.testing.assert_allclose(off, got, atol=2e-3, rtol=1e-3)
    assert off_toks == ttoks
    if not one_launch:
        assert np.array_equal(off, got)      # nothing to switch off


def test_unfused_layers_take_the_split_entry(rng, monkeypatch):
    """Separate gate and up (no ``fuse_decoder_params``): the decoder's MLP
    goes through ``fused_mlp_split_at`` at decode M, as the JAX one does."""
    monkeypatch.setenv("QA_FUSED_MLP", "1")
    jcfg, tcfg, jp, jqp, tqp = _decoders("Q8_0", seed=6)
    taken = []
    real = td.fused_mlp_split_at
    monkeypatch.setattr(td, "fused_mlp_split_at", lambda x, g, u, dn, li: (
        lambda y: (taken.append(y is not None), y)[1])(real(x, g, u, dn, li)))
    toks = rng.integers(0, 128, (1, 3))
    want, _ = jd.decoder_forward(jqp, jcfg, jd.embed_tokens(jp, jnp.asarray(toks)),
                                 jd.KVCache.create(jcfg, 1, 8, dtype=jnp.float32), 0)
    got, _ = td.decoder_forward(tqp, tcfg, td.embed_tokens(tqp, torch.from_numpy(toks)),
                                td.create_cache(tcfg, 1, 8, torch.float32), 0,
                                block_only=True)
    assert taken == [True, True] and "gate" in tqp["layers"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)


def test_panelized_decoder_through_generate_and_decoder_module(rng):
    """``panelize_decoder_params`` composed after ``fuse_decoder_params`` in
    the port: the Decoder module holds the panel tree as it is, and greedy
    generation picks the strided tree's tokens."""
    _, tcfg, _, _, tqp = _decoders("Q4_0", seed=7)
    fused = td.fuse_decoder_params(tqp)
    tx = td.embed_tokens(tqp, torch.from_numpy(rng.integers(0, 128, (1, 5))))
    kw = dict(max_new_tokens=4, eos_token_id=127, cache_max_ctx=16, cache_dtype=torch.float32)
    want = generate_on_device(fused, tcfg, tx, **kw)
    for skip in (False, True):
        dec = td.Decoder(td.panelize_decoder_params(fused, skip_gate_up=skip), tcfg)
        assert "qs4_p" in dec.params["layers"]["qkv"] and "qs4_p" in dec.params["lm_head"]
        assert ("qs4" in dec.params["layers"]["gate_up"]) == skip
        got = generate_on_device(dec.params, tcfg, tx, **kw)
        assert torch.equal(got[0], want[0])
        np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), atol=1e-4)
