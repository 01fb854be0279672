"""The port's own copy of the ggml block codecs, its ``to_f32`` and its
``quantize_checkpoint`` against the JAX package's: byte for byte."""

import io

import numpy as np
import pytest

from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import GGMLFType as JFType
from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.config import WhisperHParams as JHParams
from qwen2_audio_tpu.io import export as jexport
from qwen2_audio_tpu.io.ggml_format import GGMLTensor as JTensor
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.quant import codecs as jcodecs
from qwen2_audio_tpu_torch.config import GGMLFType, GGMLType
from qwen2_audio_tpu_torch.io import export as texport
from qwen2_audio_tpu_torch.io.ggml_format import GGMLTensor, read_ggml_file
from qwen2_audio_tpu_torch.quant import codecs as tcodecs

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
FTYPES = ["MOSTLY_Q8_0", "MOSTLY_Q4_0", "MOSTLY_Q4_1", "MOSTLY_Q5_0", "MOSTLY_Q5_1",
          "MOSTLY_Q2_K", "MOSTLY_Q3_K", "MOSTLY_Q4_K", "MOSTLY_Q5_K", "MOSTLY_Q6_K"]
# rows of 256 so that the k-quants take them; rows of 64 make them fall back
HP256 = dict(n_vocab=64, n_audio_ctx=64, n_audio_state=256, n_audio_head=4,
             n_audio_layer=1, n_mels=16)
HP64 = dict(n_vocab=64, n_audio_ctx=64, n_audio_state=64, n_audio_head=4,
            n_audio_layer=1, n_mels=16)


def _weights(seed=0, shape=(24, 512)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, :32] = 0.0          # an all-zero block
    x[1, 5] = -7.5           # a block whose largest value is negative
    return x


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_bytes_equal(fmt):
    x = _weights()
    got = tcodecs.quantize(x, GGMLType[fmt])
    want = jcodecs.quantize(x, JType[fmt])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.size == tcodecs.type_size_bytes(GGMLType[fmt], x.size) \
        == jcodecs.type_size_bytes(JType[fmt], x.size)


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_equal(fmt):
    raw = jcodecs.quantize(_weights(seed=1), JType[fmt])
    got = tcodecs.dequantize(raw, GGMLType[fmt])
    assert np.array_equal(got, jcodecs.dequantize(raw, JType[fmt]))
    assert np.array_equal(tcodecs.dequantize(raw, GGMLType[fmt], n=512)[:512], got[:512])


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_f32_dequantizes(fmt):
    x = _weights(seed=2)
    raw = jcodecs.quantize(x, JType[fmt])
    got = GGMLTensor("w", x.shape, GGMLType[fmt], raw).to_f32()
    want = JTensor("w", x.shape, JType[fmt], raw).to_f32()
    assert got.shape == x.shape and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_type_size_bytes_dense_and_refusals():
    assert tcodecs.type_size_bytes(GGMLType.F32, 10) == 40
    assert tcodecs.type_size_bytes(GGMLType.F16, 10) == 20
    with pytest.raises(ValueError):
        tcodecs.type_size_bytes(GGMLType.Q8_0, 33)
    with pytest.raises(ValueError):
        tcodecs.type_size_bytes(GGMLType.Q6_K, 128)


def _source(hp_kw, seed=0) -> bytes:
    hp = JHParams(**hp_kw)
    buf = io.BytesIO()
    jexport.write_encoder_checkpoint(
        buf, random_encoder_params(np.random.default_rng(seed), hp), hp,
        mel_filterbank(hp.n_mels), [b"x"] * 60)
    return buf.getvalue()


@pytest.mark.parametrize("ftype", FTYPES)
def test_quantize_checkpoint_bytes_equal(ftype):
    src = _source(HP256)
    got, want = io.BytesIO(), io.BytesIO()
    res_t = texport.quantize_checkpoint(io.BytesIO(src), got, GGMLFType[ftype])
    res_j = jexport.quantize_checkpoint(io.BytesIO(src), want, JFType[ftype])
    assert got.getvalue() == want.getvalue()
    assert res_t == res_j
    # 2-D matmul weights quantized; norms, biases, convs, positions kept
    qt = int(GGMLType[ftype.removeprefix("MOSTLY_")])
    assert res_t["layers.0.fc1.weight"] == qt
    assert res_t["conv1.weight"] == int(GGMLType.F16)
    assert res_t["embed_positions.weight"] == int(GGMLType.F32)
    assert res_t["layers.0.fc1.bias"] == int(GGMLType.F32)


@pytest.mark.parametrize("ftype", ["MOSTLY_Q4_K", "MOSTLY_Q6_K"])
def test_quantize_checkpoint_kquant_falls_back_to_q8_0(ftype):
    src = _source(HP64, seed=1)
    got, want = io.BytesIO(), io.BytesIO()
    res = texport.quantize_checkpoint(io.BytesIO(src), got, GGMLFType[ftype])
    jexport.quantize_checkpoint(io.BytesIO(src), want, JFType[ftype])
    assert got.getvalue() == want.getvalue()
    # q/k/v/o rows are 64 wide: no 256 super-block fits; fc2 rows are 256
    assert res["layers.0.self_attn.q_proj.weight"] == int(GGMLType.Q8_0)
    assert res["layers.0.fc2.weight"] == int(GGMLType[ftype.removeprefix("MOSTLY_")])


def test_quantize_checkpoint_patterns_and_header():
    src = _source(HP64, seed=2)
    dst = io.BytesIO()
    res = texport.quantize_checkpoint(io.BytesIO(src), dst, GGMLFType.MOSTLY_Q5_0,
                                      to_quant=[r"fc\d\.weight$"],
                                      to_skip=[r"fc2"])
    assert res["layers.0.fc1.weight"] == int(GGMLType.Q5_0)
    assert res["layers.0.fc2.weight"] == int(GGMLType.F16)
    assert res["layers.0.self_attn.q_proj.weight"] == int(GGMLType.F16)
    m = read_ggml_file(dst.getvalue())
    assert m.hparams.ftype == int(GGMLFType.MOSTLY_Q5_0) and m.qntvr == 2
    t = m.tensors["layers.0.fc1.weight"]
    assert t.raw.dtype == np.uint8 and t.to_f32().shape == (256, 64)
