"""PyTorch port's checkpoint I/O, runtime context and capi against the JAX
package (CPU)."""

import io

import jax
import numpy as np
import pytest
import torch

from qwen2_audio_tpu import capi as jcapi
from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import GGMLType as JGT
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.io import export as jexport
from qwen2_audio_tpu.io import ggml_format as jfmt
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.tokenizer import WhisperVocab as JVocab
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.config import GGMLType as TGT
from qwen2_audio_tpu_torch.config import WhisperHParams as THP
from qwen2_audio_tpu_torch.convert import encoder_params_from_jax
from qwen2_audio_tpu_torch.io import export as texport
from qwen2_audio_tpu_torch.io import ggml_format as tfmt
from qwen2_audio_tpu_torch.runtime.context import ContextParams, WhisperContext
from qwen2_audio_tpu_torch.tokenizer import WhisperVocab as TVocab
from qwen2_audio_tpu_torch.utils import logging as tlog

HP = dict(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_mels=16)
VOCAB = [b"a", b"b", b"ab"]
CPU = ContextParams(use_gpu=False)


def _tensors(mod, gt, rng):
    f = rng.standard_normal((3, 8)).astype(np.float32)
    bf = (f.view(np.uint32) & 0xFFFF0000).view(np.float32)   # bf16-exact
    q8 = rng.integers(0, 255, size=2 * 34, dtype=np.uint8)   # two Q8_0 blocks
    return [mod.GGMLTensor("a.weight", (3, 8), gt.F32, f),
            mod.GGMLTensor("b.weight", (3, 8), gt.F16, f.astype(np.float16)),
            mod.GGMLTensor("c.weight", (3, 8), gt.BF16, bf),
            mod.GGMLTensor("d.weight", (2, 32), gt.Q8_0, q8)]


def test_writer_byte_identical_and_readers_cross_read():
    filters = mel_filterbank(16)
    jb, tb = io.BytesIO(), io.BytesIO()
    jfmt.write_ggml_file(jb, JHP(**HP), filters, VOCAB,
                         _tensors(jfmt, JGT, np.random.default_rng(1)))
    tfmt.write_ggml_file(tb, THP(**HP), filters, VOCAB,
                         _tensors(tfmt, TGT, np.random.default_rng(1)))
    assert jb.getvalue() == tb.getvalue()

    from_t = jfmt.read_ggml_file(tb.getvalue())
    from_j = tfmt.read_ggml_file(jb.getvalue())
    assert from_j.hparams.__dict__ == from_t.hparams.__dict__
    assert from_j.vocab == from_t.vocab == VOCAB
    np.testing.assert_array_equal(from_j.filters, from_t.filters)
    for name, t in from_t.tensors.items():
        u = from_j.tensors[name]
        assert (u.shape, int(u.ttype)) == (t.shape, int(t.ttype))
        np.testing.assert_array_equal(u.raw, t.raw)
        if t.ttype != JGT.Q8_0:
            np.testing.assert_array_equal(u.to_f32(), t.to_f32())


def test_quantized_to_f32_raises():
    """Quantized tensors used to raise in ``to_f32``; with the block codecs
    ported they dequantize, to the JAX package's values. What still raises
    is a block count that does not fit the format."""
    buf = io.BytesIO()
    tfmt.write_ggml_file(buf, THP(**HP), mel_filterbank(16), VOCAB,
                         _tensors(tfmt, TGT, np.random.default_rng(2)))
    m = tfmt.read_ggml_file(buf.getvalue())      # every type parses
    assert m.tensors["d.weight"].ttype == TGT.Q8_0
    got = m.tensors["d.weight"].to_f32()
    want = jfmt.read_ggml_file(buf.getvalue()).tensors["d.weight"].to_f32()
    assert got.shape == (2, 32) and np.array_equal(got, want, equal_nan=True)
    assert tfmt.type_size_bytes(TGT.Q4_K, 512) == 2 * 144
    with pytest.raises(ValueError):
        tfmt.type_size_bytes(TGT.Q4_K, 128)


def _checkpoint(seed=0) -> bytes:
    buf = io.BytesIO()
    jexport.write_encoder_checkpoint(buf, random_encoder_params(
        np.random.default_rng(seed), JHP(**HP)), JHP(**HP), mel_filterbank(16), VOCAB)
    return buf.getvalue()


def test_encoder_checkpoint_writer_byte_identical():
    jp = random_encoder_params(np.random.default_rng(0), JHP(**HP))
    tb = io.BytesIO()
    texport.write_encoder_checkpoint(
        tb, encoder_params_from_jax(jax.tree.map(np.asarray, jp)), THP(**HP),
        mel_filterbank(16), VOCAB)
    assert tb.getvalue() == _checkpoint(0)


def test_vocab_special_tokens_match():
    for n_vocab in (64, 51864, 51865, 51866):
        a, b = JVocab.from_token_list(VOCAB, n_vocab), TVocab.from_token_list(VOCAB, n_vocab)
        assert a.id_to_token == b.id_to_token
        assert (a.token_eot, a.token_sot, a.token_beg, a.token_lang(3)) == \
            (b.token_eot, b.token_sot, b.token_beg, b.token_lang(3))


@pytest.fixture(scope="module")
def contexts():
    data = _checkpoint(0)
    return (jcapi.whisper_init_from_buffer_with_params(data),
            tcapi.whisper_init_from_buffer_with_params(data, CPU))


def _tone(seconds):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def test_whisper_full_matches_jax(contexts, capsys):
    jctx, tctx = contexts
    x = _tone(2.0)
    assert jcapi.whisper_full(jctx, jcapi.whisper_full_default_params(), x) == 0
    assert tcapi.whisper_full(tctx, tcapi.whisper_full_default_params(), x) == 0
    got = tctx.state.embd_enc
    assert got.shape == (750, 64) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jctx.state.embd_enc), atol=1e-4)
    assert tcapi.whisper_n_len(tctx) == jcapi.whisper_n_len(jctx)
    jcapi.whisper_print_emb_enc(jctx)
    jfp = capsys.readouterr().out.strip()
    tcapi.whisper_print_emb_enc(tctx)
    tfp = capsys.readouterr().out.strip()
    assert tfp == jfp
    tcapi.whisper_print_timings(tctx)
    assert tctx.state.timings.n_encode >= 1


def test_pcm_to_mel_and_encode_match_jax(contexts):
    jctx, tctx = contexts
    x = _tone(3.0) + np.float32(0.01)
    assert jcapi.whisper_pcm_to_mel(jctx, x) == 0
    assert tcapi.whisper_pcm_to_mel(tctx, x) == 0
    np.testing.assert_allclose(tctx.state.mel.data.numpy(), jctx.state.mel.data,
                               atol=3e-4)
    assert jcapi.whisper_encode(jctx, 0) == 0
    assert tcapi.whisper_encode(tctx, 0) == 0
    np.testing.assert_allclose(tctx.state.embd_enc.numpy(),
                               np.asarray(jctx.state.embd_enc), atol=1e-4)


def test_error_codes(contexts):
    _, ctx = contexts
    seen = []
    tlog.log_set(lambda level, text, ud: seen.append((level, text)))
    try:
        st = ctx.init_state()
        assert ctx.full_with_state(st, tcapi.whisper_full_default_params(),
                                   _tone(0.5)) == 0
        assert st.embd_enc is None
        assert any("too short" in t for _, t in seen)
        assert ctx.set_mel_with_state(st, np.zeros((15, 200), np.float32)) == -1
        assert ctx.set_mel_with_state(st, np.zeros((16, 3000), np.float32)) == 0
        assert ctx.encode_with_state(st, 0, audio_ctx=1501) == -2
        p = tcapi.whisper_full_default_params()
        p.audio_ctx = 1501
        assert ctx.full_with_state(st, p, _tone(2.0)) == -1
        assert ctx.encode_with_state(ctx.init_state(), 0) == -1   # no mel
    finally:
        tlog.log_set(None)


def test_short_audio_ctx_matches_jax(contexts):
    jctx, tctx = contexts
    x = _tone(2.0)
    for ctx, capi in ((jctx, jcapi), (tctx, tcapi)):
        p = capi.whisper_full_default_params()
        p.audio_ctx = 500
        assert capi.whisper_full(ctx, p, x) == 0
    assert tctx.state.embd_enc.shape == (250, 64)
    np.testing.assert_allclose(tctx.state.embd_enc.numpy(),
                               np.asarray(jctx.state.embd_enc), atol=1e-4)


def test_use_gpu_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcapi.whisper_init_from_buffer_with_params(_checkpoint(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcapi.whisper_init_from_buffer_with_params(_checkpoint(0), ContextParams())


def test_init_forms_and_lifecycle(tmp_path):
    data = _checkpoint(1)
    path = str(tmp_path / "m.bin")
    with open(path, "wb") as f:
        f.write(data)

    class Loader:
        def __init__(self):
            self.pos, self.closed = 0, False

        def read(self, n):
            out = data[self.pos:self.pos + n]
            self.pos += len(out)
            return out

        def eof(self):
            return self.pos >= len(data)

        def close(self):
            self.closed = True

    ld = Loader()
    c = tcapi.whisper_init_with_params(ld, CPU)
    assert ld.closed and tcapi.whisper_n_vocab(c) == 64
    assert tcapi.whisper_init_from_file_with_params_no_state(path, CPU).state is None
    assert tcapi.whisper_init_from_buffer_with_params_no_state(data, CPU).state is None
    c2 = tcapi.whisper_init_from_file_with_params(path, CPU)
    assert c2.model_type_readable() == "unknown" and tcapi.whisper_model_n_mels(c2) == 16
    assert c2.encoder.compute_dtype == torch.float32 and c2.params.gelu_approximate
    assert "qkv" in c2.encoder.params["layers"][0]
    assert c2.decoder is None
    with pytest.raises(TypeError):
        c2.decoder = object()
    with pytest.raises(NotImplementedError):
        c2.vocab.tokenize("ab")
    tcapi.whisper_free(c2)
    assert c2.state is None and c2.encoder is None
