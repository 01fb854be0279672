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
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
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


def _qmm_tol(want, dtype):
    """chip_smoke's tolerance of the dequantizing matmul (sum order only;
    bf16 outputs may round either way at the end)."""
    top = want.float().abs().max().item()
    if dtype == torch.float32:
        return chip_smoke.QMM_ATOL_F32 * top
    return chip_smoke.QMM_TOL_BF16[0] * top + chip_smoke.QMM_TOL_BF16[1] * want.float().abs()


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("M,dtype,fast", [
    (1, torch.bfloat16, True), (1, torch.float32, False), (7, torch.float32, True),
    (752, torch.bfloat16, True), (300, torch.float32, False), (130, torch.float32, True),
])
def test_quant_matmul_entries_match_plain(device, fmt, M, dtype, fast):
    """Flat and stacked entries over random blocks (every byte value, -128
    included) at the decoder's qkv shape."""
    K, N = 3584, 4608
    qw = chip_smoke._rand_blocks(device, K, N, fmt, seed=11, layers=3)
    packed = fmt == "q4_0"
    q, sc = qw["qs4" if packed else "qs"], qw["scales"]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(12),
                    device=device).to(dtype)
    kw = {"fast": fast, **({"off": 8} if packed else {})}
    flat, stacked, plain = ((tqm.quant_matmul4, tqm.quant_matmul4_stacked,
                             tqm.quant_matmul4_plain) if packed else
                            (tqm.quant_matmul, tqm.quant_matmul_stacked,
                             tqm.quant_matmul_plain))
    before = flat.launches, stacked.launches
    got_s = stacked(x, q, sc, 2, **kw)
    got_f = flat(x, q[2], sc[2], **kw)
    assert (flat.launches, stacked.launches) == (before[0] + 1, before[1] + 1)
    want = plain(x, q[2], sc[2], **kw)
    assert got_s.dtype == dtype and bool(torch.isfinite(got_s).all())
    assert torch.equal(got_s, got_f)         # one device function, and no run-to-run spread
    assert torch.equal(got_s, stacked(x, q, sc, 2, **kw))
    assert bool(((got_s.float() - want.float()).abs() <= _qmm_tol(want, dtype)).all())


@pytest.mark.parametrize("ttype,M,dtype,fast", [
    ("Q4_1", 5, torch.float32, False), ("Q4_1", 200, torch.bfloat16, True),
    ("Q6_K", 1, torch.float32, False), ("Q6_K", 200, torch.bfloat16, True),
    ("Q5_1", 3, torch.float32, False), ("Q2_K", 64, torch.float32, False),
    ("Q4_K", 1, torch.bfloat16, True), ("Q3_K", 9, torch.float32, True),
])
def test_quant_linear_formats_match_plain(device, ttype, M, dtype, fast):
    """Real quantizer output with mins, group 16 and float32 scales through
    quant_linear: the card's kernel + min term against the CPU's plain path."""
    from qwen2_audio_tpu_torch.config import GGMLType
    qw_dev = chip_smoke._quantized(device, 1280, 512, GGMLType[ttype], seed=13)
    qw_cpu = {k: v.cpu() for k, v in qw_dev.items()}
    x = torch.randn(M, 1280, generator=torch.Generator().manual_seed(14)).to(dtype)
    got = tqm.quant_linear(x.to(device), qw_dev, fast=fast).cpu()
    want = tqm.quant_linear(x, qw_cpu, fast=fast)
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, dtype)).all())


def test_quant_matmul_refuses_what_the_kernel_does_not_take(device):
    qw = chip_smoke._rand_blocks(device, 256, 128, "q8_0", seed=15)
    x = torch.zeros(2, 256, device=device)
    with pytest.raises(ValueError):      # float16 activations
        tqm.quant_matmul(x.half(), qw["qs"], qw["scales"])
    with pytest.raises(ValueError):      # N not a multiple of 16
        tqm.quant_matmul(x, qw["qs"][:, :120].contiguous(), qw["scales"][:, :120].contiguous())
    with pytest.raises(ValueError):      # a view that is not contiguous
        tqm.quant_matmul(x, qw["qs"][:, ::2], qw["scales"][:, ::2])


def test_quantized_context_on_card_matches_cpu(device):
    """A q8_0 checkpoint with a q4_0 decoder attached, exact mode, float32:
    the same tokens on the card (kernels) as on the CPU (plain versions)."""
    from qwen2_audio_tpu_torch.config import GGMLFType, GGMLType
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder, random_decoder_params
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import quantize_decoder_params
    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_mels=80)
    cfg = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=14,
                             num_key_value_heads=2, head_dim=128, tie_word_embeddings=False)
    src, dst = io.BytesIO(), io.BytesIO()
    write_encoder_checkpoint(src, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(80), [b"a"])
    quantize_checkpoint(io.BytesIO(src.getvalue()), dst, GGMLFType.MOSTLY_Q8_0)
    x = chip_smoke.noisy_tone(2.0, seed=6)
    out = []
    set_group_matmul_mode("dequant")
    try:
        for cp in (ContextParams(), ContextParams(use_gpu=False)):
            ctx = capi.whisper_init_from_buffer_with_params(dst.getvalue(), cp)
            assert "qs" in ctx.encoder.params["layers"][0]["qkv"]
            bundle = random_bundle(np.random.default_rng(1), cfg, hp.n_audio_state,
                                   max_ctx=1024)
            bundle.decoder = Decoder(quantize_decoder_params(
                random_decoder_params(np.random.default_rng(2), cfg), GGMLType.Q4_0), cfg)
            ctx.decoder = bundle
            p = capi.whisper_full_default_params()
            p.max_new_tokens = 6
            p.temperature_inc = 0.0
            before = tqm.quant_matmul4_stacked.launches
            assert capi.whisper_full(ctx, p, x) == 0
            if cp.use_gpu:
                assert tqm.quant_matmul4_stacked.launches > before
            out.append((ctx.state.result_tokens, capi.whisper_get_logits(ctx)))
    finally:
        set_group_matmul_mode(None)
    assert out[0][0] == out[1][0] and len(out[0][0]) > 0
    np.testing.assert_allclose(out[0][1], out[1][1], atol=2e-3)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("M,dtype,fast", [
    (1, torch.bfloat16, True), (5, torch.float32, False), (752, torch.bfloat16, True),
    (130, torch.float32, False),
])
def test_panel_entries_give_the_strided_bits(device, fmt, M, dtype, fast):
    """Flat and stacked panel entries at the decoder's qkv shape (6 panels
    of 768) and at a width no multiple of 128 divides (one panel)."""
    for K, N in ((3584, 4608), (256, 208)):
        qw = chip_smoke._rand_blocks(device, K, N, fmt, seed=21, layers=2)
        pw = tqm.panelize_weight(qw)
        packed = fmt == "q4_0"
        qk, pk = ("qs4", "qs4_p") if packed else ("qs", "qs_p")
        assert pw[pk].shape[1:] == ((6, K // (2 if packed else 1), 768) if N == 4608
                                    else (1, K // (2 if packed else 1), 208))
        x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(22),
                        device=device).to(dtype)
        kw = {"fast": fast, **({"off": 8} if packed else {})}
        stacked, flat, pstacked, pflat = (
            (tqm.quant_matmul4_stacked, tqm.quant_matmul4, tqm.quant_matmul_panel4_stacked,
             tqm.quant_matmul_panel4) if packed else
            (tqm.quant_matmul_stacked, tqm.quant_matmul, tqm.quant_matmul_panel_stacked,
             tqm.quant_matmul_panel))
        before = pstacked.launches, pflat.launches
        got = pstacked(x, pw[pk], pw["scales_p"], 1, **kw)
        assert torch.equal(got, pflat(x, pw[pk][1], pw["scales_p"][1], **kw))
        assert (pstacked.launches, pflat.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, stacked(x, qw[qk], qw["scales"], 1, **kw))
        assert torch.equal(got, flat(x, qw[qk][1], qw["scales"][1], **kw))


def test_panel_entry_refuses_a_width_the_kernel_does_not_take(device):
    qw = chip_smoke._rand_blocks(device, 256, 192, "q8_0", seed=23)
    x = torch.zeros(2, 256, device=device)
    pw = tqm.panelize_weight(qw, 24)             # 24 is no multiple of 16
    with pytest.raises(ValueError):
        tqm.quant_matmul_panel(x, pw["qs_p"], pw["scales_p"])


@pytest.mark.parametrize("fmt", ["q8_0", "q6_K", "q5_1", "q4_0", "q4_1"])
@pytest.mark.parametrize("M,dtype,fast", [
    (1, torch.bfloat16, True), (1, torch.float32, False), (5, torch.float32, True),
    (33, torch.bfloat16, False), (64, torch.float32, False),
])
def test_fused_mlp_matches_plain(device, fmt, M, dtype, fast):
    """The one-launch SwiGLU over every dequant flavour at a width whose last
    tile of I is ragged (I = 1056 = 16 * 64 + 32), both schemas."""
    from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
    K, I = 512, 1056
    gu, dn = chip_smoke._rand_mlp(device, K, I, K, fmt, seed=31)
    packed = "qs4" in gu
    order = (("qs4" if packed else "qs"), "scales") + (("mins",) if "mins" in gu else ())
    entry = {(False, 2): tfm.fused_mlp_stacked, (False, 3): tfm.fused_mlp_m_stacked,
             (True, 3): tfm.fused_mlp4_stacked, (True, 2): tfm.fused_mlp4_sym_stacked
             }[packed, len(order)]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(32),
                    device=device).to(dtype)
    leaves = [tuple(w[k][1] for k in order) for w in
              ({k: gu[k][..., :I] for k in order}, {k: gu[k][..., I:] for k in order}, dn)]
    before = entry.launches
    got = entry(x, *(w[k] for w in (gu, dn) for k in order), 1, fast=fast)
    assert entry.launches == before + 1
    want = tfm.fused_mlp_plain(x, *leaves, packed=packed, fast=fast)
    tol = _qmm_tol(want, dtype)
    if fast:
        tol = tol + chip_smoke.FUSED_FLIPS * tfm.gated_rounding_bound(x, *leaves, packed=packed)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, entry(x, *(w[k] for w in (gu, dn) for k in order), 1, fast=fast))
    split = tfm.fused_mlp_split_stacked(
        x, tuple(gu[k][..., :I].contiguous() for k in order),
        tuple(gu[k][..., I:].contiguous() for k in order), tuple(dn[k] for k in order), 1,
        packed=packed, fast=fast)
    assert torch.equal(split, got)


def test_fused_mlp_refuses_what_the_kernel_does_not_take(device):
    from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
    gu, dn = chip_smoke._rand_mlp(device, 256, 128, 256, "q8_0", seed=33)
    args = (gu["qs"], gu["scales"], dn["qs"], dn["scales"])
    x = torch.zeros(2, 256, device=device)
    with pytest.raises(ValueError):      # float16 activations
        tfm.fused_mlp_stacked(x.half(), *args, 0)
    with pytest.raises(ValueError):      # 65 rows
        tfm.fused_mlp_stacked(torch.zeros(65, 256, device=device), *args, 0)
    with pytest.raises(ValueError):      # down's rows not contiguous
        tfm.fused_mlp_stacked(x, gu["qs"], gu["scales"],
                              dn["qs"].transpose(1, 2).contiguous().transpose(1, 2),
                              dn["scales"], 0)
    with pytest.raises(ValueError):      # float64 scales
        tfm.fused_mlp_stacked(x, gu["qs"], gu["scales"].double(), dn["qs"],
                              dn["scales"].double(), 0)


@pytest.mark.parametrize("skip_gate_up", [False, True])
def test_decode_tuned_context_on_card_matches_cpu(device, skip_gate_up):
    """A q4_1 decoder (packed nibbles with mins), fused and panelized, behind
    a dense encoder, exact mode, float32: the same tokens on the card
    (panel kernels, the one-launch SwiGLU) as on the CPU (plain versions)."""
    from qwen2_audio_tpu_torch.config import GGMLType
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (
        Decoder, fuse_decoder_params, panelize_decoder_params, random_decoder_params)
    from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    from qwen2_audio_tpu_torch.quant.qparams import quantize_decoder_params
    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_mels=80)
    cfg = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=14,
                             num_key_value_heads=2, head_dim=128, tie_word_embeddings=False)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(80), [b"a"])
    x = chip_smoke.noisy_tone(2.0, seed=6)
    tree = fuse_decoder_params(quantize_decoder_params(
        random_decoder_params(np.random.default_rng(2), cfg), GGMLType.Q4_1))
    if skip_gate_up:     # the MLP strided (one launch at decode M), the rest in panels
        tree = dict(tree, layers={k: (tqm.panelize_weight(e) if k in ("qkv", "o") else e)
                                  for k, e in tree["layers"].items()},
                    lm_head=tqm.panelize_weight(tree["lm_head"]))
    else:
        tree = panelize_decoder_params(tree)
    out = []
    set_group_matmul_mode("dequant")
    try:
        for cp in (ContextParams(), ContextParams(use_gpu=False)):
            ctx = capi.whisper_init_from_buffer_with_params(buf.getvalue(), cp)
            bundle = random_bundle(np.random.default_rng(1), cfg, hp.n_audio_state,
                                   max_ctx=1024)
            bundle.decoder = Decoder(tree, cfg)
            ctx.decoder = bundle
            p = capi.whisper_full_default_params()
            p.max_new_tokens = 6
            p.temperature_inc = 0.0
            before = (tqm.quant_matmul_panel4_stacked.launches, tqm.quant_matmul_panel4.launches,
                      tfm.fused_mlp4_stacked.launches)
            assert capi.whisper_full(ctx, p, x) == 0
            if cp.use_gpu:
                assert tqm.quant_matmul_panel4_stacked.launches > before[0]
                assert tqm.quant_matmul_panel4.launches > before[1]
                assert (tfm.fused_mlp4_stacked.launches > before[2]) == skip_gate_up
            out.append((ctx.state.result_tokens, capi.whisper_get_logits(ctx)))
    finally:
        set_group_matmul_mode(None)
    assert out[0][0] == out[1][0] and len(out[0][0]) > 0
    np.testing.assert_allclose(out[0][1], out[1][1], atol=2e-3)


def test_quantize_activations_kernel_is_bit_equal_to_plain(device):
    """chip_smoke's phase-2 check of the q8_1 quantizing kernel at the
    decoder's widths: xq and sx bit-equal, ties and all-zero groups."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    before = t8.quantize_activations.launches
    n = chip_smoke.check_quantize_activations(device, Ks=(3584, 448))
    assert t8.quantize_activations.launches == before + n


def test_int8_group_matmul_matches_plain(device):
    """chip_smoke's phase-2 check of rows 14, 15 and 16 at narrow widths
    (M = 1, 7, 752, 1500; q8_0, symmetric q4_0 as bytes and as words, q4_1
    and q5_1 with mins): within tolerance of the plain versions, the flat and
    stacked entries and the byte and word forms bit-equal, two runs equal."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    before = [e.launches for e in t8.ENTRIES + tb.ENTRIES]
    out = chip_smoke.check_int8_matmul(device, dims=(448, 768, 1024, 256))
    assert set(out) == {"quant_matmul_int8", "quant_matmul_int8_stacked",
                        "quant_matmul_q4b_stacked"}
    assert all(e.launches > b for e, b in zip(t8.ENTRIES + tb.ENTRIES, before))


def test_int8_group_matmul_refuses_what_the_kernel_does_not_take(device):
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    qw = chip_smoke._rand_blocks(device, 256, 128, "q8_0", seed=41)
    x = torch.zeros(2, 256, device=device)
    with pytest.raises(ValueError):      # float16 activations
        t8.quant_matmul_int8(x.half(), qw["qs"], qw["scales"])
    with pytest.raises(ValueError):      # N not a multiple of 16
        t8.quant_matmul_int8(x, qw["qs"][:, :120].contiguous(),
                             qw["scales"][:, :120].contiguous())
    with pytest.raises(ValueError):      # a view that is not contiguous
        t8.quant_matmul_int8(x, qw["qs"][:, ::2], qw["scales"][:, ::2])
    with pytest.raises(ValueError):      # float16 activations at the quantizer
        t8.quantize_activations(x.half())
