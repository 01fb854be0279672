"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present. Run on the
GPU host with ``python -m pytest tests/test_torch_cuda.py -q``."""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from qwen2_audio_tpu_torch import capi
from qwen2_audio_tpu_torch.audio import mel_filterbank
from qwen2_audio_tpu_torch.audio.mel import pad_signal
from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
from qwen2_audio_tpu_torch.ops import flash_attention as tfa
from qwen2_audio_tpu_torch.ops import flash_decode as tfd
from qwen2_audio_tpu_torch.ops import mel_kernel as tmk
from qwen2_audio_tpu_torch.runtime.context import ContextParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seconds,n_mels", [(1.0, 80), (30.0, 128)])
def test_mel_kernel_matches_plain(device, seconds, n_mels):
    padded, _, _, n = pad_signal(chip_smoke.noisy_tone(seconds, seed=4))
    tables = tmk.mel_tables(mel_filterbank(n_mels), device)
    x = torch.from_numpy(padded).to(device)
    before = tmk.mel_frames.launches
    got = tmk.mel_frames(x, tables, n)
    assert tmk.mel_frames.launches == before + 1
    want = tmk.mel_frames_plain(x, tables, n)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("dtype,B,H,Hkv,T,d,kv_valid,fused", [
    (torch.bfloat16, 1, 20, 20, 1500, 64, 1500, True),
    (torch.float32, 1, 20, 20, 1500, 64, 1500, True),
    (torch.bfloat16, 2, 4, 2, 300, 128, 237, False),
    (torch.float32, 2, 4, 2, 300, 64, 237, False),
])
def test_attention_kernel_matches_plain(device, dtype, B, H, Hkv, T, d, kv_valid, fused):
    q, k, v = chip_smoke._attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed=5)
    before = tfa.attention_single.launches
    got = tfa.attention_single(q, k, v, kv_valid)
    assert tfa.attention_single.launches == before + 1
    want = tfa.attention_single_plain(q, k, v, kv_valid)
    atol, rtol = chip_smoke.ATTN_TOL[str(dtype).removeprefix("torch.")]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_context_on_card_matches_cpu(device):
    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_mels=80)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(80), [b"a"])
    x = chip_smoke.noisy_tone(2.0, seed=6)
    out = []
    for cp in (ContextParams(), ContextParams(use_gpu=False)):
        ctx = capi.whisper_init_from_buffer_with_params(buf.getvalue(), cp)
        assert capi.whisper_full(ctx, capi.whisper_full_default_params(), x) == 0
        out.append(ctx.state.embd_enc.cpu())
    torch.testing.assert_close(out[0], out[1], atol=2e-3, rtol=0)


def _tol(want, dtype, p_abs_v=None):
    """chip_smoke's elementwise tolerance; the causal kernel's bf16 check
    adds the p-rounding term."""
    atol, rtol = chip_smoke.ATTN_TOL[str(dtype).removeprefix("torch.")]
    tol = atol + rtol * want.float().abs()
    if dtype == torch.bfloat16 and p_abs_v is not None:
        tol = tol + chip_smoke.P_ROUND * p_abs_v.float()
    return tol


@pytest.mark.parametrize("dtype,B,Hq,Hkv,T,d,kv_valid", [
    (torch.bfloat16, 1, 28, 4, 752, 128, 752),
    (torch.float32, 1, 28, 4, 752, 128, 752),
    (torch.bfloat16, 2, 28, 4, 333, 128, 333),
    (torch.float32, 2, 14, 2, 100, 128, 77),
])
def test_causal_kernel_matches_plain(device, dtype, B, Hq, Hkv, T, d, kv_valid):
    q, k, v = chip_smoke._causal_case(device, dtype, B, Hq, Hkv, T, d, seed=7)
    before = tfa.attention_causal.launches
    got = tfa.attention_causal(q, k, v, d ** -0.5, kv_valid)
    assert tfa.attention_causal.launches == before + 1
    want = tfa.attention_causal_plain(q, k, v, d ** -0.5, kv_valid)
    tol = _tol(want, dtype, tfa.attention_causal_plain(q, k, v.abs(), d ** -0.5, kv_valid))
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("qdt,kvdt,B,S,pos", [
    (torch.bfloat16, torch.bfloat16, 1, 784, [783]),
    (torch.float32, torch.float32, 4, 784, [17, 63, 64, 783]),
    (torch.float32, torch.bfloat16, 1, 300, [150]),
    (torch.bfloat16, torch.int8, 4, 784, [17, 63, 64, 783]),
    (torch.float32, torch.int8, 1, 8192, [8191]),
])
def test_decode_kernel_matches_plain_over_poisoned_cache(device, qdt, kvdt, B, S, pos):
    """Rows past each stream's position hold NaN (int8: junk and NaN scales)."""
    q, cache, posv = chip_smoke._decode_case(device, qdt, kvdt, B, S, pos, seed=8)
    quant = kvdt == torch.int8
    kern = tfd.flash_decode_quant if quant else tfd.flash_decode
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    before = kern.launches
    got = kern(q, *cache, posv, sm_scale=128 ** -0.5)
    assert kern.launches == before + 1
    want = plain(q, *cache, posv, sm_scale=128 ** -0.5)
    tol = _tol(want, qdt)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_decoder_context_on_card_matches_cpu(device):
    """A small audio -> text context in float32: the same tokens on the card
    (kernels) as on the CPU (plain versions)."""
    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_mels=80)
    cfg = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=14,
                             num_key_value_heads=2, head_dim=128)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(80), [b"a"])
    x = chip_smoke.noisy_tone(2.0, seed=6)
    out = []
    for cp in (ContextParams(), ContextParams(use_gpu=False)):
        ctx = capi.whisper_init_from_buffer_with_params(buf.getvalue(), cp)
        ctx.decoder = random_bundle(np.random.default_rng(1), cfg, hp.n_audio_state,
                                    max_ctx=1024)
        p = capi.whisper_full_default_params()
        p.max_new_tokens = 6
        p.temperature_inc = 0.0
        assert capi.whisper_full(ctx, p, x) == 0
        out.append((ctx.state.result_tokens, capi.whisper_get_logits(ctx)))
    assert out[0][0] == out[1][0] and len(out[0][0]) > 0
    np.testing.assert_allclose(out[0][1], out[1][1], atol=2e-3)
