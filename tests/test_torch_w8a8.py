"""The port's per-channel w8a8 form (quant/qparams.py ``mode="fast"``,
ops/linear.py ``w8a8``) against the JAX package's ``fast_w8_from_array``,
``quantize_*_params(mode="fast")`` and ``ops/linear.py::_w8a8`` (CPU).

Tolerances: the quantized leaves are equal bit for bit; the int32
accumulator of the int8 x int8 product is exact (held to an int64 product);
a linear's output equals JAX's bit for bit (the same float32 roundings of
the same exact accumulator); whole forwards (decoder logits, encoder
output), whose float32 sums run in other orders, at the float32 tolerances
of tests/test_torch_decoder.py and tests/test_torch_encoder.py. Against the
dense weights (w8a8 is lossy) the JAX tests' bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.models import encoder as jenc
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.config import WhisperHParams as THP
from qwen2_audio_tpu_torch.convert import encoder_params_from_jax, quant_params_from_jax
from qwen2_audio_tpu_torch.models import encoder as tenc
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.quant import qparams as tq

CFG = dict(vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           tie_word_embeddings=False)
HP = dict(n_vocab=66, n_audio_ctx=300, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_mels=16)
LOGIT_ATOL = 1e-4     # float32 logits (tests/test_torch_decoder.py)
ENC_ATOL = 1e-4       # float32 encoder output (tests/test_torch_encoder.py)


def _np(a):
    return np.asarray(a)


def _leaves_equal(jtree, ttree):
    want = quant_params_from_jax(jax.tree.map(np.asarray, jtree))
    jl_, tl_ = jax.tree_util.tree_leaves_with_path(want), \
        jax.tree_util.tree_leaves_with_path(ttree)
    assert [p for p, _ in jl_] == [p for p, _ in tl_]
    for (path, a), (_, b) in zip(jl_, tl_):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("shape,zero_col", [((256, 128), False), ((64, 48), True)])
def test_fast_w8_from_array_equal_jax(shape, zero_col, rng):
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    if zero_col:
        w[:, 5] = 0.0        # a zero column: scale 0, values 0
    want = jq.fast_w8_from_array(w, to_device=False)
    got = tq.fast_w8_from_array(w)
    assert got["qs8"].dtype == torch.int8 and got["scale_n"].shape == (shape[1],)
    assert np.array_equal(got["qs8"].numpy(), want["qs8"])
    assert np.array_equal(got["scale_n"].numpy(), want["scale_n"])
    assert torch.equal(tq.fast_w8_from_array(torch.from_numpy(w))["qs8"], got["qs8"])


def test_fast_w8_from_ggml_blocks_equal_jax(rng):
    """ggml q8_0 blocks -> the w8a8 form (the JAX serving path for ggml
    files), and its accuracy against the dense weight."""
    K, N = 128, 64
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    jw = jq.quantize_array_for_device(w, JType.Q8_0)
    want = jq.fast_w8_from_ggml_blocks(jw)
    got = tq.fast_w8_from_ggml_blocks(tq.quantize_array_for_device(w, GGMLType.Q8_0))
    assert np.array_equal(got["qs8"].numpy(), np.asarray(want["qs8"]))
    assert np.array_equal(got["scale_n"].numpy(), np.asarray(want["scale_n"]))
    x = rng.standard_normal((4, K)).astype(np.float32)
    y = tl.linear(torch.from_numpy(x), got).numpy()
    assert np.abs(y - x @ w).max() / np.abs(x @ w).max() < 0.04


@pytest.mark.parametrize("M", [1, 8, 17, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w8a8_linear_bits_equal_jax(M, dtype, rng):
    """``linear`` over {"qs8", "scale_n", "b"}: the rows quantized as JAX
    does them (zero rows included), the same bits out."""
    K, N = 256, 128
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    p = tq.fast_w8_from_array(w)
    p["b"] = torch.from_numpy((0.1 * rng.standard_normal(N)).astype(np.float32))
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0                                   # s_x = 0: inv 0, output the bias
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = np.asarray(jl.linear(jnp.asarray(x, jdt), jp).astype(jnp.float32))
    got = tl.linear(torch.from_numpy(x).to(tdt), p)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), want)
    # the first two int8 quantizations only: within 3 % of the dense product
    if dtype == "f32" and M > 1:
        dense = x[1:] @ w
        assert np.abs(got.numpy()[1:] - p["b"].numpy() - dense).max() \
            < 0.03 * np.abs(dense).max()


@pytest.mark.parametrize("M,K,N", [(1, 3584, 64), (3, 18944, 16), (5, 96, 40)])
def test_int8_matmul_plain_is_exact(M, K, N):
    """The plain int8 x int8 -> int32 product is exact, at the decoder's
    deepest K too, with every value at the int8 extremes."""
    rng = np.random.default_rng(K)
    a = rng.choice([-128, -127, 127], (M, K)).astype(np.int8)
    b = rng.choice([-128, 127], (K, N)).astype(np.int8)
    a[0] = -128
    b[:, 0] = -128          # the largest sum: K * 2^14
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = tl.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_quantize_rows_matches_jax_rounding():
    """Half-to-even rounding and the IEEE quotient, on values built to sit
    on .5 after scaling."""
    x = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -127.0],
                    [0.0] * 8], np.float32)
    xq, s = tl.quantize_rows(torch.from_numpy(x))
    xf = jnp.asarray(x)
    js = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    jinv = jnp.where(js > 0, 1.0 / js, 0.0)
    want = np.asarray(jnp.round(xf * jinv).astype(jnp.int8))
    assert np.array_equal(xq.numpy(), want)
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert xq[0].tolist() == [127, 0, 2, 2, 0, -2, 64, -127]


def _decoder_pair(seed):
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jp = jd.random_decoder_params(np.random.default_rng(seed), jcfg)
    return jcfg, tcfg, jp


def test_quantize_decoder_params_fast_equal_jax():
    jcfg, tcfg, jp = _decoder_pair(2)
    want = jq.quantize_decoder_params(jax.tree.map(np.asarray, jp), JType.Q8_0,
                                      mode="fast", to_device=False)
    got = tq.quantize_decoder_params(quant_params_from_jax(jax.tree.map(np.asarray, jp)),
                                     GGMLType.Q8_0, mode="fast")
    assert "qs8" in got["layers"]["q"] and "w" not in got["layers"]["q"]
    assert got["layers"]["q"]["qs8"].shape == (2, 128, 128)
    assert got["layers"]["q"]["scale_n"].shape == (2, 128)
    assert set(got["lm_head"]) == {"qs8", "scale_n"}
    _leaves_equal(want, got)


def _run(params, cfg, module):
    """A 7-position prefill, then one step, as tests/test_fused_decoder.py."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, 128)) * 0.1).astype(np.float32)
    step = (rng.standard_normal((2, 1, 128)) * 0.1).astype(np.float32)
    if module is jd:
        cache = jd.create_cache(cfg, 2, 48, dtype=jnp.float32)
        lg, cache = jd.decoder_forward(params, cfg, jnp.asarray(x), cache, 0,
                                       block_only=True, logits_last_only=True)
        lg2, _ = jd.decoder_forward(params, cfg, jnp.asarray(step), cache, 7)
        return _np(lg), _np(lg2)
    cache = td.create_cache(cfg, 2, 48, dtype=torch.float32)
    lg, cache = td.decoder_forward(params, cfg, torch.from_numpy(x), cache, 0,
                                   block_only=True, logits_last_only=True)
    lg2, _ = td.decoder_forward(params, cfg, torch.from_numpy(step), cache, 7)
    return lg.numpy(), lg2.numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_w8a8_decoder_matches_jax(fused):
    """The decoder over w8a8 weights, separate and fused (the ``("fast",
    Q8_0)`` case of tests/test_fused_decoder.py): the port's logits equal
    JAX's at the float32 tolerance, fusing changes nothing, and both stay
    near the dense decoder (the JAX test's bound)."""
    jcfg, tcfg, jp = _decoder_pair(2)
    jq_ = jq.quantize_decoder_params(jp, JType.Q8_0, mode="fast")
    tq_ = tq.quantize_decoder_params(quant_params_from_jax(jax.tree.map(np.asarray, jp)),
                                     GGMLType.Q8_0, mode="fast")
    if fused:
        jq_, tq_ = jd.fuse_decoder_params(jq_), td.fuse_decoder_params(tq_)
        assert set(tq_["layers"]["qkv"]) == {"qs8", "scale_n", "b"}
    want = _run(jq_, jcfg, jd)
    got = _run(tq_, tcfg, td)
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(g_, w_, atol=LOGIT_ATOL, rtol=0)
    unfused = _run(tq.quantize_decoder_params(
        quant_params_from_jax(jax.tree.map(np.asarray, jp)), GGMLType.Q8_0, mode="fast"),
        tcfg, td)
    for a, b in zip(got, unfused):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    dense = _run(quant_params_from_jax(jax.tree.map(np.asarray, jp)), tcfg, td)
    err = max(np.abs(a - b).max() for a, b in zip(got, dense))
    scale = max(np.abs(b).max() for b in dense)
    assert err < 0.12 * scale + 0.12, err


def test_w8a8_encoder_matches_jax(rng):
    """quantize_encoder_params(mode="fast") and the encoder over it: the
    leaves equal JAX's, the output JAX's at the float32 tolerance, fused QKV
    a pure re-parameterisation, and close to the dense encoder (the JAX
    test's bounds)."""
    jp = jenc.random_encoder_params(np.random.default_rng(4), JHP(**HP))
    tp = encoder_params_from_jax(jax.tree.map(np.asarray, jp))
    jqp = jq.quantize_encoder_params(jp, JType.Q8_0, mode="fast")
    tqp = tq.quantize_encoder_params(tp, GGMLType.Q8_0, mode="fast")
    assert set(tqp["layers"][0]["q"]) == {"qs8", "scale_n", "b"}
    _leaves_equal(jqp, tqp)
    mel = rng.standard_normal((1, 16, 600)).astype(np.float32)
    want = _np(jenc.encoder_forward(jqp, jnp.asarray(mel), JHP(**HP)))
    got = tenc.encoder_forward(tqp, torch.from_numpy(mel), THP(**HP)).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)
    fused = tenc.encoder_forward(tenc.fuse_encoder_qkv(tqp), torch.from_numpy(mel),
                                 THP(**HP)).numpy()
    np.testing.assert_allclose(fused, got, atol=2e-5, rtol=1e-5)
    dense = tenc.encoder_forward(tp, torch.from_numpy(mel), THP(**HP)).numpy()
    assert np.corrcoef(dense.ravel(), got.ravel())[0, 1] > 0.999
    assert np.abs(got - dense).max() < 0.15 * np.abs(dense).max()


def test_w8a8_greedy_first_token_matches_dense():
    """A short greedy decode over w8a8 weights takes the dense decoder's
    first token and JAX's tokens."""
    from qwen2_audio_tpu.runtime.generate import generate_on_device as j_gen
    from qwen2_audio_tpu_torch.runtime.generate import generate_on_device as t_gen
    jcfg, tcfg, jp = _decoder_pair(3)
    x = (np.random.default_rng(9).standard_normal((1, 6, 128)) * 0.1).astype(np.float32)
    tp = quant_params_from_jax(jax.tree.map(np.asarray, jp))
    fast = tq.quantize_decoder_params(tp, GGMLType.Q8_0, mode="fast")
    jfast = jq.quantize_decoder_params(jp, JType.Q8_0, mode="fast")
    kw = dict(max_new_tokens=6, eos_token_id=95, cache_max_ctx=16)
    got = t_gen(fast, tcfg, torch.from_numpy(x), cache_dtype=torch.float32, **kw)
    want = j_gen(jfast, jcfg, jnp.asarray(x), cache_dtype=jnp.float32, **kw)
    dense = t_gen(tp, tcfg, torch.from_numpy(x), cache_dtype=torch.float32, **kw)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[0][0, 0]) == int(dense[0][0, 0])


def test_modules_hold_w8a8_weights_k_major():
    """The decoder and encoder modules store "qs8" K-major (the layout the
    card's int8 product reads at speed): the same values and the same
    outputs as the row-major leaves; other leaves untouched; .to() keeps
    the layout."""
    jcfg, tcfg, jp = _decoder_pair(4)
    fast = tq.quantize_decoder_params(quant_params_from_jax(jax.tree.map(np.asarray, jp)),
                                      GGMLType.Q8_0, mode="fast")
    dec = td.Decoder(fast, tcfg)
    q = dec.params["layers"]["qkv"]["qs8"]
    assert q.stride(-2) == 1 and q.shape == (2, 128, 256)
    assert torch.equal(q, td.fuse_decoder_params(fast)["layers"]["qkv"]["qs8"])
    assert dec.params["lm_head"]["qs8"].stride(0) == 1
    assert dec.to("cpu").params["lm_head"]["qs8"].stride(0) == 1
    np.testing.assert_array_equal(_run(dec.params, tcfg, td)[1],
                                  _run(td.fuse_decoder_params(fast), tcfg, td)[1])
    again = tl.w8a8_layout(dec.params)
    assert again["layers"]["qkv"]["qs8"].data_ptr() == q.data_ptr()
    tp = encoder_params_from_jax(jax.tree.map(
        np.asarray, jenc.random_encoder_params(np.random.default_rng(4), JHP(**HP))))
    enc = tenc.Encoder(tq.quantize_encoder_params(tp, GGMLType.Q8_0, mode="fast"), THP(**HP))
    assert enc.params["layers"][1]["fc1"]["qs8"].stride(0) == 1
    assert enc.params["layers"][1]["ln1"]["w"].is_contiguous()
