"""The port's card-side weight forms (quant/qparams.py) against the JAX
package's: the same ggml blocks give the same leaves, bit for bit, once
the JAX storage variants are converted (convert.quant_params_from_jax)."""

import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.io.ggml_format import GGMLTensor as JTensor
from qwen2_audio_tpu.ops import quant_matmul as jqm
from qwen2_audio_tpu.quant import codecs as jcodecs
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.io.ggml_format import GGMLTensor
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.quant import qparams as tq

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
FOUR_BIT = ("Q4_0", "Q4_1", "Q4_K")
N, K = 24, 512     # torch [out, in]


def _raw(fmt, seed=0):
    x = np.random.default_rng(seed).standard_normal((N, K)).astype(np.float32)
    return jcodecs.quantize(x, JType[fmt])


def _cases():
    for fmt in FORMATS:
        if fmt in FOUR_BIT:
            for packed in (True, False):
                for sym in ((True, False) if fmt == "Q4_0" and packed else (True,)):
                    yield fmt, packed, sym
        else:
            yield fmt, True, True


@pytest.mark.parametrize("scale", ["f16", "u16"])
@pytest.mark.parametrize("fmt,packed,sym", list(_cases()))
def test_device_weight_leaves_equal_jax(fmt, packed, sym, scale, monkeypatch):
    raw = _raw(fmt)
    # the JAX package stores what its TPU compiler takes: int8-typed nibble
    # bytes, uint16 scale bit patterns; pin them so both variants are met
    monkeypatch.setenv("QA_SCALE16", "1" if scale == "f16" else "0")
    monkeypatch.setenv("QA_SCALE_U16", "1" if scale == "u16" else "0")
    jform = jq.Q4Form(packed=packed, sym=sym, i8=scale == "u16", scale=scale)
    want = jq.device_weight_from_ggml_tensor(
        JTensor("w", (N, K), JType[fmt], raw), to_device=False, form=jform)
    want = quant_params_from_jax(want)
    got = tq.device_weight_from_ggml_tensor(
        GGMLTensor("w", (N, K), GGMLType[fmt], raw),
        form=tq.Q4Form(packed=packed, sym=sym))
    assert set(got) == set(want)
    f16_payload = fmt in ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0")
    assert got["scales"].dtype == (torch.float16 if f16_payload else torch.float32)
    qkey = "qs4" if "qs4" in got else "qs"
    assert got[qkey].dtype == (torch.uint8 if qkey == "qs4" else torch.int8)
    for leaf in got:
        assert got[leaf].dtype == want[leaf].dtype, leaf
        assert got[leaf].shape == want[leaf].shape, leaf
        assert torch.equal(got[leaf], want[leaf]), leaf
    if "mins" in got:
        assert got["mins"].dtype == torch.float32
    assert ("qs4" in got) == (packed and fmt in FOUR_BIT)
    assert ("mins" in got) == (fmt in ("Q4_1", "Q5_1", "Q2_K", "Q4_K", "Q5_K")
                               or (fmt == "Q4_0" and packed and not sym))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_weight_bit_equal(fmt):
    raw = _raw(fmt, seed=1)
    got = tq.device_weight_from_ggml_tensor(GGMLTensor("w", (N, K), GGMLType[fmt], raw))
    jw = jq.device_weight_from_ggml_tensor(JTensor("w", (N, K), JType[fmt], raw))
    want = np.asarray(jqm.dequantize_weight(jw))
    dense = tqm.dequantize_weight(got).numpy()
    assert np.array_equal(dense, want)
    # and both are the codec's own dequantization, transposed to [in, out]
    assert np.array_equal(dense, jcodecs.dequantize(raw, JType[fmt]).reshape(N, K).T)
    assert tqm.dequantize_weight(got, torch.bfloat16).dtype == torch.bfloat16


def test_jax_int4_and_f32_scale_leaves_convert():
    """JAX may hold unpacked q4_0 values as int4 and packed scales as f32."""
    raw = _raw("Q4_0", seed=2)
    jw = jq.device_weight_from_ggml_tensor(
        JTensor("w", (N, K), JType.Q4_0, raw),
        form=jq.Q4Form(packed=False, sym=True, scale="f32"))
    conv = quant_params_from_jax({k: np.asarray(v) for k, v in jw.items()})
    got = tq.device_weight_from_ggml_tensor(
        GGMLTensor("w", (N, K), GGMLType.Q4_0, raw), form=tq.Q4Form(packed=False))
    assert conv["qs"].dtype == torch.int8 and torch.equal(conv["qs"], got["qs"])
    assert torch.equal(conv["scales"].float(), got["scales"].float())


def test_quant_params_from_jax_maps_trees_and_refuses_panels():
    tree = {"layers": [{"q": {"qs": np.zeros((32, 16), np.int8),
                              "scales": np.ones((1, 16), np.float16).view(np.uint16),
                              "b": np.zeros(16, np.float32)},
                        "ln1": {"w": np.ones(32, np.float32)}}],
            "pos": np.zeros((4, 32), np.float32)}
    out = quant_params_from_jax(tree)
    assert out["layers"][0]["q"]["scales"].dtype == torch.float16
    assert float(out["layers"][0]["q"]["scales"][0, 0]) == 1.0
    assert out["layers"][0]["ln1"]["w"].dtype == torch.float32
    # panel leaves, refused until their kernels were ported, convert like
    # their strided namesakes
    panels = quant_params_from_jax(
        {"q": {"qs_p": np.zeros((1, 32, 16), np.int8),
               "scales_p": np.ones((1, 1, 16), np.float16).view(np.uint16)},
         "k": {"qs4_p": np.full((2, 16, 16), -1, np.int8),
               "scales_p": np.ones((2, 1, 16), np.float32),
               "mins": np.zeros((1, 32), np.float32)}})
    assert panels["q"]["qs_p"].dtype == torch.int8
    assert panels["q"]["scales_p"].dtype == torch.float16
    assert float(panels["q"]["scales_p"][0, 0, 0]) == 1.0
    assert panels["k"]["qs4_p"].dtype == torch.uint8 and int(panels["k"]["qs4_p"][0, 0, 0]) == 255
    assert panels["k"]["scales_p"].dtype == torch.float32
    # the per-channel w8a8 form, refused until it was ported: int8 values,
    # float32 scales
    w8 = quant_params_from_jax({"q": {"qs8": np.full((32, 16), -3, np.int8),
                                      "scale_n": np.ones(16, np.float32)}})["q"]
    assert w8["qs8"].dtype == torch.int8 and int(w8["qs8"][0, 0]) == -3
    assert w8["scale_n"].dtype == torch.float32
    # the word-packed nibbles, refused until their kernel was ported: int32,
    # the same bits
    words = quant_params_from_jax({"q": {"qs4b": np.full((4, 16), -2, np.int32),
                                         "scales": np.ones((1, 16), np.float32)}})["q"]
    assert words["qs4b"].dtype == torch.int32 and int(words["qs4b"][0, 0]) == -2


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1", "Q6_K"])
def test_quantize_array_for_device_equal_jax(fmt, rng):
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    got = tq.quantize_array_for_device(w, GGMLType[fmt])
    want = quant_params_from_jax(
        jq.quantize_array_for_device(w, JType[fmt], to_device=False))
    assert set(got) == set(want)
    for leaf in got:
        assert torch.equal(got[leaf].float(), want[leaf].float()), leaf
    assert torch.equal(tq.quantize_array_for_device(torch.from_numpy(w), GGMLType[fmt])[
        "scales"], got["scales"])


def test_payload_form_and_q4form():
    raw = _raw("Q4_0")
    t = GGMLTensor("w", (N, K), GGMLType.Q4_0, raw)
    assert tq.payload_form(tq.device_weight_from_ggml_tensor(t)) == "packed4+sym+u8+f16sc"
    assert tq.payload_form(tq.device_weight_from_ggml_tensor(
        t, form=tq.Q4Form(sym=False))) == "packed4+mins+u8+f16sc"
    assert tq.payload_form(tq.device_weight_from_ggml_tensor(
        t, form=tq.Q4Form(packed=False))) == "strided+sym+f16sc"
    t6 = GGMLTensor("w", (N, K), GGMLType.Q6_K, _raw("Q6_K"))
    assert tq.payload_form(tq.device_weight_from_ggml_tensor(t6)) == "strided+sym+f32sc"
    assert tq.payload_form({"qs8": 0, "scale_n": 0}) == "w8a8"
    panel = tqm.panelize_weight(tq.device_weight_from_ggml_tensor(t), 8)
    assert tq.payload_form(panel) == "packed4-panel+sym+u8+f16sc"
    assert tq.payload_form(tqm.panelize_weight(
        tq.device_weight_from_ggml_tensor(t6), 8)) == "strided-panel+sym+f32sc"
    with pytest.raises(ValueError):
        tq.payload_form({"w": 0})
    # Q4Form(b32=True), refused until its kernel was ported: q4_0's bytes as
    # int32 words, the JAX package's payload; only packed symmetric q4_0
    b32 = tq.device_weight_from_ggml_tensor(t, form=tq.Q4Form(b32=True))
    assert tq.payload_form(b32) == "packed4-b32+sym+f16sc"
    assert b32["qs4b"].dtype == torch.int32 and b32["qs4b"].shape == (K // 8, N)
    jw = jq.device_weight_from_ggml_tensor(JTensor("w", (N, K), JType.Q4_0, raw),
                                           to_device=False,
                                           form=jq.Q4Form(b32=True, scale="f16"))
    assert np.array_equal(b32["qs4b"].numpy(), jw["qs4b"])
    assert np.array_equal(b32["scales"].numpy(), jw["scales"])
    for bad in (dict(packed=False), dict(sym=False)):
        with pytest.raises(ValueError):
            tq.Q4Form(b32=True, **bad)
    q41 = GGMLTensor("w", (N, K), GGMLType.Q4_1, _raw("Q4_1"))
    assert "qs4" in tq.device_weight_from_ggml_tensor(q41, form=tq.Q4Form(b32=True))
    with pytest.raises(ValueError):
        tq.device_weight_from_ggml_tensor(GGMLTensor("w", (N, K), GGMLType.F16,
                                                     np.zeros((N, K), np.float16)))


def test_quantize_params_modes():
    # mode="fast", refused until the per-channel w8a8 form was ported, now
    # gives it (tests/test_torch_w8a8.py holds its values to the JAX ones)
    w = torch.randn(2, 32, 16)
    p = {"layers": {k: {"w": w} for k in ("q", "k", "v", "o", "gate", "up", "down")}}
    fast = tq.quantize_decoder_params(p, GGMLType.Q8_0, mode="fast")["layers"]["q"]
    assert set(fast) == {"qs8", "scale_n"} and fast["qs8"].shape == (2, 32, 16)
    assert fast["scale_n"].shape == (2, 16)
    assert tq.quantize_encoder_params({"layers": []}, GGMLType.Q8_0, mode="fast") == {
        "layers": []}
    with pytest.raises(ValueError):
        tq.quantize_decoder_params(p, GGMLType.Q8_0, mode="other")
    with pytest.raises(ValueError):
        tq.quantize_encoder_params({"layers": []}, GGMLType.Q8_0, mode="other")


def test_q8_0_from_array_bits_equal_the_codec():
    """The torch q8_0 quantizer (every q8_0 weight the port quantizes) gives
    the bits of the ggml codec's byte stream unpacked: zero groups, values
    that scale to .5 (rounded away from zero), int8 extremes; a K not a
    multiple of 32 raises."""
    from qwen2_audio_tpu_torch.quant import codecs as tcodecs
    rng = np.random.default_rng(7)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    w[:32, 3] = 0.0
    w[32:64, 4] = np.tile([127.0, 0.5, 1.5, -2.5], 8)
    w[64:96, 5] = np.tile([1.0, -1.0], 16) * 3.0
    raw = tcodecs.quantize(np.ascontiguousarray(w.T), GGMLType.Q8_0)
    want = tq.device_weight_from_ggml_tensor(GGMLTensor("_", (N, K), GGMLType.Q8_0, raw))
    got = tq.q8_0_from_array(torch.from_numpy(w))
    assert set(got) == set(want)
    for leaf in got:
        assert got[leaf].dtype == want[leaf].dtype and torch.equal(got[leaf], want[leaf]), leaf
    with pytest.raises(ValueError):
        tq.q8_0_from_array(torch.zeros(48, 8))
