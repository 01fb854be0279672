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


@pytest.mark.parametrize("name", chip_smoke.MEL_CASES)
def test_mel_kernel_edge_cases(device, name):
    """The per-frame FFT kernel on chip_smoke's MEL_CASES (silence, white
    noise, a bin-centred tone, clips under 201 samples, one frame, frame
    counts around multiples of the CTA's 8, 3002 and 6002 frames, 80 and 128
    mels, a dense bank with an empty row): within MEL_ATOL of its plain
    version and of the float64 oracle after normalisation, one launch."""
    before = tmk.mel_frames.launches
    c = chip_smoke.mel_case(device, name)
    assert tmk.mel_frames.launches == before + 1
    assert max(c["err_plain"], c["err_oracle"], c["plain_err_oracle"]) <= chip_smoke.MEL_ATOL
    if name == "silence":
        assert bool(((c["got"] + 1.5).abs() <= 1e-6).all())


def test_mel_kernel_replays_in_a_graph(device):
    """Captured in a CUDA graph, the mel launch replays to the eager bits."""
    padded, _, _, n = pad_signal(chip_smoke.noisy_tone(30.0, seed=4))
    tables = tmk.mel_tables(mel_filterbank(128), device)
    x = torch.from_numpy(padded).to(device)
    want = tmk.mel_frames(x, tables, n)
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            got = tmk.mel_frames(x, tables, n)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def _tol(want, dtype, p_abs_v=None, any_type=False):
    """chip_smoke's elementwise tolerance; the causal kernel's bf16 check
    adds the p-rounding term (``any_type``: pexp16's, in float32 too)."""
    atol, rtol = chip_smoke.ATTN_TOL[str(dtype).removeprefix("torch.")]
    tol = atol + rtol * want.float().abs()
    if (dtype == torch.bfloat16 or any_type) and p_abs_v is not None:
        tol = tol + chip_smoke.P_ROUND * p_abs_v.float()
    return tol


@pytest.mark.parametrize("dtype,B,Hq,Hkv,T,d,kv_valid", [
    (torch.bfloat16, 1, 28, 4, 752, 128, 752),
    (torch.float32, 1, 28, 4, 752, 128, 752),
    (torch.bfloat16, 2, 28, 4, 333, 128, 333),
    (torch.float32, 2, 14, 2, 100, 128, 77),
    (torch.bfloat16, 2, 14, 2, 129, 128, 100),
    (torch.bfloat16, 2, 7, 1, 1, 128, 1),
    (torch.bfloat16, 2, 28, 4, 752, 128, 600),
])
def test_causal_kernel_matches_plain(device, dtype, B, Hq, Hkv, T, d, kv_valid):
    q, k, v = chip_smoke._causal_case(device, dtype, B, Hq, Hkv, T, d, seed=7)
    before = tfa.attention_causal.launches
    got = tfa.attention_causal(q, k, v, d ** -0.5, kv_valid)
    assert tfa.attention_causal.launches == before + 1
    want = tfa.attention_causal_plain(q, k, v, d ** -0.5, kv_valid)
    tol = _tol(want, dtype, tfa.attention_causal_plain(q, k, v.abs(), d ** -0.5, kv_valid))
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("i", range(len(chip_smoke._edge_cases())))
def test_attention_tile_edges_match_plain(device, i):
    """The bf16 tile where queries and keys cross its 64- and 128-row edges,
    Tq != Tk, GQA groups of 7, fused-QKV views, NaN at and past kv_valid
    (chip_smoke's phase-2 edge cases and tolerance: ATTN_TOL, with the
    p-rounding term only where at most FEW_KEYS keys carry every row)."""
    B, H, Hkv, Tq, Tk, d, kv_valid, fused = chip_smoke._edge_cases()[i]
    q, k, v, (kc, vc) = chip_smoke._edge_case(device, B, H, Hkv, Tq, Tk, d, kv_valid, fused,
                                             seed=13)
    got = tfa.attention_single(q, k, v, kv_valid)
    want = tfa.attention_single_plain(q, kc, vc, kv_valid)
    few = kv_valid <= chip_smoke.FEW_KEYS
    tol = _tol(want, torch.bfloat16,
               tfa.attention_single_plain(q, kc, vc.abs(), kv_valid) if few else None)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("i", range(len(chip_smoke._variant_edge_cases())))
def test_attention_variant_edges_match_plain(device, i):
    """Each attention entry and option across the bf16 tile's edges, NaN
    past kv_valid (chip_smoke's phase-2 cases and tolerance: the p-rounding
    term under pexp16 or where at most FEW_KEYS keys carry every row)."""
    entry, opts, dtype, (B, H, Hkv, T, d, kv_valid, fused) = chip_smoke._variant_edge_cases()[i]
    q, k, v = chip_smoke._attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed=14)
    k[:, :, kv_valid:] = float("nan")
    v[:, :, kv_valid:] = float("nan")
    if "sm_scale" in opts:
        q = q * (1.0 / opts["sm_scale"])
    kern, plain = chip_smoke._variant_fns(entry, opts, kv_valid)
    counter = chip_smoke._attention_entries()[entry]
    before = counter.launches
    got = kern(q, k, v)
    assert counter.launches == before + 1
    want = plain(q, k, v)
    few = opts.get("pexp16") or kv_valid <= chip_smoke.FEW_KEYS
    tol = _tol(want, dtype, plain(q, k, v.abs()) if few else None, any_type=True)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


_BF, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("qdt,kvdt,B,S,pos", [
    (_BF, _BF, 1, 784, [783]),
    (_F32, _F32, 4, 784, [17, 63, 64, 783]),
    (_F32, _BF, 1, 300, [150]),
    (_BF, _I8, 4, 784, [17, 63, 64, 783]),
    (_F32, _I8, 1, 8192, [8191]),
    # the split-KV kernel's range edges (chip_smoke's): pos 0, 63, 64, 1023,
    # 1024, 2047 at a capacity of 2048, and B 4 at mixed positions
    *chip_smoke._decode_edge_cases(),
    # pos = S - 1 at the main shape; S 8192: 512-row ranges over a ring
    (_BF, _I8, 1, 784, [783]), (_BF, _BF, 1, 8192, [8191]), (_BF, _I8, 1, 8192, [4000]),
    # q float32 over each cache type
    (_F32, _F32, 1, 2048, [783]), (_F32, _BF, 1, 2048, [783]), (_F32, _I8, 1, 2048, [783]),
])
def test_decode_kernel_matches_plain_over_poisoned_cache(device, qdt, kvdt, B, S, pos):
    """Rows past each stream's position hold NaN (int8: junk and NaN scales).
    The range-edge cases add chip_smoke's p-rounding term for streams of few
    rows (``decode_p_abs_v``); every other case is held to ATTN_TOL alone."""
    q, cache, posv = chip_smoke._decode_case(device, qdt, kvdt, B, S, pos, seed=8)
    quant = kvdt == torch.int8
    kern = tfd.flash_decode_quant if quant else tfd.flash_decode
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    before = kern.launches
    got = kern(q, *cache, posv, sm_scale=128 ** -0.5)
    assert kern.launches == before + 1
    want = plain(q, *cache, posv, sm_scale=128 ** -0.5)
    p_abs_v = None
    if (qdt, kvdt, B, S, pos) in chip_smoke._decode_edge_cases():
        p_abs_v = chip_smoke.decode_p_abs_v(plain, q, cache, posv, 128 ** -0.5)
    tol = _tol(want, qdt, p_abs_v)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("kvdt", [_BF, _I8])
def test_decode_kernel_replays_in_a_graph_with_pos_changed(device, kvdt):
    """One call captured in a CUDA graph, then pos changed in place and the
    graph replayed: the kernel reads pos on the device only, so each replay
    matches the plain version at the new positions."""
    q, cache, posv = chip_smoke._decode_case(device, _BF, kvdt, 2, 2048, [2047, 2047], seed=9)
    quant = kvdt == torch.int8
    kern = tfd.flash_decode_quant if quant else tfd.flash_decode
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    kern(q, *cache, posv, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern(q, *cache, posv, sm_scale=128 ** -0.5)
    for new in ([783, 100], [0, 2047], [1151, 64]):
        posv.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = plain(q, *cache, posv, sm_scale=128 ** -0.5)
        assert bool(((out.float() - want.float()).abs() <= _tol(want, _BF)).all()), new


_POOL = [783, 755, 801, 760, 790, 752, 812, 770]   # the 8-slot pool's step


@pytest.mark.parametrize("kvdt", [_BF, _I8])
@pytest.mark.parametrize("B,S,pos", [(5, 784, [783] * 5), (5, 784, [0, 63, 64, 400, 783]),
                                     (8, 2048, _POOL)])
def test_decode_batch_shapes_captured_equal_eager(device, kvdt, B, S, pos):
    """The beam step's (B = 5, capacity 784) and the pool's (B = 8, ragged)
    shapes over a cache with NaN past each stream's position: the kernel
    (several splits a (stream, KV head), merged by the last CTA to take its
    ticket) within tolerance of the plain version, and three launches
    captured in a CUDA graph and replayed bit-equal to the eager call, with
    the kernel's ticket counters back at 0 after."""
    q, cache, posv = chip_smoke._decode_case(device, _BF, kvdt, B, S, pos, seed=10)
    quant = kvdt == torch.int8
    kern = tfd.flash_decode_quant if quant else tfd.flash_decode
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    assert tfd.decode_plan(B, S, 4, 7, kvdt)["splits"] > 1
    eager = kern(q, *cache, posv, sm_scale=128 ** -0.5)
    want = plain(q, *cache, posv, sm_scale=128 ** -0.5)
    p_abs_v = chip_smoke.decode_p_abs_v(plain, q, cache, posv, 128 ** -0.5)
    assert bool(torch.isfinite(eager).all())
    assert bool(((eager.float() - want.float()).abs() <= _tol(want, _BF, p_abs_v)).all())
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        kern(q, *cache, posv, sm_scale=128 ** -0.5)
        with torch.cuda.graph(graph):
            outs = [kern(q, *cache, posv, sm_scale=128 ** -0.5) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, eager) for o in outs)
    arrays = [t for key, t in tqm._tickets.items() if key[0] == "flash_decode"]
    assert arrays and all(int(t.count_nonzero()) == 0 for t in arrays)


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


@pytest.mark.parametrize("i", range(len(chip_smoke._variant_cases())))
def test_attention_variant_matches_plain(device, i):
    """The lite, unpadded and blockwise entries and the exp2 / pexp16
    options against their plain versions (chip_smoke's phase-2 cases and
    tolerances; NaN past kv_valid in the ragged cases)."""
    entry, opts, dtype, (B, H, Hkv, T, d, kv_valid, fused) = chip_smoke._variant_cases()[i]
    q, k, v = chip_smoke._attn_case(device, dtype, B, H, Hkv, T, d, kv_valid, fused, seed=9)
    if not fused and kv_valid < T:
        k[:, :, kv_valid:] = float("nan")
        v[:, :, kv_valid:] = float("nan")
    if "sm_scale" in opts:
        q = q * (1.0 / opts["sm_scale"])
    kern, plain = chip_smoke._variant_fns(entry, opts, kv_valid)
    counter = chip_smoke._attention_entries()[entry]
    before = counter.launches
    got = kern(q, k, v)
    assert counter.launches == before + 1
    want = plain(q, k, v)
    tol = _tol(want, dtype, plain(q, k, v.abs()) if opts.get("pexp16") else None,
               any_type=True)
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_lite_nan_tail_contributes_nothing(device):
    """Keys at or past kv_valid holding NaN leave the lite output as zeros
    there would."""
    from qwen2_audio_tpu_torch.ops import fa_variants as tfv
    q, k, v = chip_smoke._attn_case(device, torch.bfloat16, 2, 4, 4, 300, 64, 300, False,
                                    seed=10)
    k0, v0 = k.clone(), v.clone()
    k0[:, :, 237:] = 0.0
    v0[:, :, 237:] = 0.0
    k[:, :, 237:] = float("nan")
    v[:, :, 237:] = float("nan")
    got = tfv.attention_lite(q, k, v, sm_scale=1.0, kv_valid=237)
    want = tfv.attention_lite(q, k0, v0, sm_scale=1.0, kv_valid=237)
    assert torch.equal(got, want)


def test_quantize_kv_bits_equal_cpu(device):
    """The int8 cache's scales and values on the card bit-equal to the CPU's
    over amax values where a reciprocal multiply rounds otherwise than
    division."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import _quantize_kv
    x = chip_smoke.kv_with_scales(chip_smoke.reciprocal_misses(512, seed=11), seed=12)
    (q_c, s_c), (q_g, s_g) = _quantize_kv(x), _quantize_kv(x.to(device))
    assert torch.equal(s_g.cpu(), s_c)
    assert torch.equal(q_g.cpu(), q_c)


@pytest.mark.parametrize("xdt", [_F32, _BF])
def test_kv_append_quant_bits_equal_cpu(device, xdt):
    """One launch writes the int8 cache bit-equal to the CPU's plain route,
    over amax values where a reciprocal multiply rounds otherwise than
    division: B 2 at positions 3 and 180 of 200 (the second stream's rows
    past the capacity dropped), v a strided view of a fused K/V buffer."""
    x = chip_smoke.kv_with_scales(chip_smoke.reciprocal_misses(512, seed=11), seed=12)
    kv = torch.cat([x, x.flip(1) * 3.0], dim=-1).to(xdt)      # (2, 64, 4, 256)
    k, v = kv[..., :128].contiguous(), kv[..., 128:]
    pos = torch.tensor([3, 180], dtype=torch.int32)
    caches = []
    for dev in ("cpu", device):
        c = [torch.full((2, 200, 4, 128), -7, dtype=torch.int8, device=dev),
             torch.full((2, 200, 4), float("nan"), device=dev)]
        c = c + [t.clone() for t in c]
        before = tfd.kv_append_quant.launches
        tfd.kv_append_quant(k.to(dev), v.to(dev), *c, pos.to(dev))
        assert tfd.kv_append_quant.launches == before + (dev != "cpu")
        caches.append([t.cpu() for t in c])
    for cpu, card in zip(*caches):
        assert torch.equal(cpu.isnan(), card.isnan())
        assert torch.equal(cpu.nan_to_num(), card.nan_to_num())


def test_int8_cache_at_an_odd_capacity(device):
    """Layer 1 of a 2-layer int8 cache at Hkv 2 and capacity 39 (a
    speculative request's T0 + budget + K): its scales start off the
    16-byte grid. The append writes the CPU's bits, and the decode kernel
    over it matches its plain version (39 rows visible: the range-edge cases'
    p-rounding term)."""
    gen = torch.Generator().manual_seed(21)
    k, v = (torch.randn(1, 8, 2, 128, generator=gen).to(_BF) for _ in range(2))
    q = torch.randn(1, 14, 128, generator=gen).to(_BF)
    pos = torch.tensor([31], dtype=torch.int32)
    caches = []
    for dev in ("cpu", device):
        c = [torch.zeros(2, 1, 39, 2, 128, dtype=torch.int8, device=dev),
             torch.zeros(2, 1, 39, 2, device=dev)]
        c = c + [t.clone() for t in c]
        layer = [t[1] for t in c]
        tfd.kv_append_quant(k.to(dev), v.to(dev), *layer, pos.to(dev))
        caches.append(layer)
    for cpu, card in zip(*caches):
        assert torch.equal(cpu, card.cpu())
    got = tfd.flash_decode_quant(q.to(device), *caches[1], (pos + 7).to(device),
                                 sm_scale=128 ** -0.5)
    want = tfd.flash_decode_quant_plain(q, *caches[0], pos + 7, sm_scale=128 ** -0.5)
    p_abs_v = chip_smoke.decode_p_abs_v(tfd.flash_decode_quant_plain, q, caches[0], pos + 7,
                                        128 ** -0.5)
    assert bool(((got.cpu().float() - want.float()).abs() <= _tol(want, _BF, p_abs_v)).all())


def test_int8_cache_of_a_decoder_bit_equal_to_the_old_route(device, monkeypatch):
    """A 4-layer bf16 decoder over the int8 cache, a 40-position prefill and
    8 steps: the cache written by kv_append_quant (one launch per layer and
    forward) bit-equal to the one the plain quantizer and sliced writes give
    on the card."""
    from qwen2_audio_tpu_torch.models import qwen2_decoder as qd
    cfg = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=4, num_attention_heads=14,
                             num_key_value_heads=2, head_dim=128)
    params = qd.fuse_decoder_params(qd.random_decoder_params(
        np.random.default_rng(3), cfg, dtype=_BF, scale=0.2, device=device))
    g = torch.Generator(device="cpu").manual_seed(4)
    embeds = [torch.randn(1, 40, 256, generator=g).to(device, _BF)]
    embeds += [torch.randn(1, 1, 256, generator=g).to(device, _BF) for _ in range(8)]

    def run():
        cache = qd.create_cache(cfg, 1, 64, dtype="q8", device=device)
        qd.decoder_forward(params, cfg, embeds[0], cache, 0, block_only=True,
                           logits_last_only=True)
        for j, e in enumerate(embeds[1:]):
            qd.decoder_forward(params, cfg, e, cache, 40 + j)
        return cache

    before = tfd.kv_append_quant.launches
    new = run()
    assert tfd.kv_append_quant.launches == before + cfg.num_hidden_layers * len(embeds)
    monkeypatch.setattr(qd, "kv_append_quant", tfd.kv_append_quant_plain)
    old = run()
    for name in ("k_q", "k_s", "v_q", "v_s"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name


@pytest.mark.parametrize("fmt,M", [("q8_0", 1), ("q8_0", 752), ("q4_0", 1), ("q4_0", 752)])
def test_dequant16_strided_equals_panel(device, fmt, M):
    """dq16 through the stacked strided entry and the stacked panel entry on
    the same bytes: the same bits, and the plain version within
    chip_smoke's tolerance."""
    qw = chip_smoke._rand_blocks(device, 512, 1024, fmt, seed=13, layers=2)
    packed = fmt == "q4_0"
    kw = {"fast": True, **({"off": 8} if packed else {})}
    x = torch.randn(M, 512, generator=torch.Generator(device=device).manual_seed(14),
                    device=device)
    key = "qs4" if packed else "qs"
    pw = tqm.panelize_weight(qw, 256)
    strided = tqm.quant_matmul4_stacked if packed else tqm.quant_matmul_stacked
    panel = tqm.quant_matmul_panel4_stacked if packed else tqm.quant_matmul_panel_stacked
    got = strided(x, qw[key], qw["scales"], 1, dq16=True, **kw)
    assert torch.equal(panel(x, pw[key + "_p"], pw["scales_p"], 1, dq16=True, **kw), got)
    plain = tqm.quant_matmul4_plain if packed else tqm.quant_matmul_plain
    want = plain(x, qw[key][1], qw["scales"][1], dq16=True, **kw)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= chip_smoke.QMM_ATOL_F32 * top
    assert (got - strided(x, qw[key], qw["scales"], 1, **kw)).abs().max().item() \
        > chip_smoke.QMM_ATOL_F32 * top


@pytest.mark.parametrize("fmt,M,dtype,bn", [
    ("q8_0", 9, torch.bfloat16, 48), ("q8_0", 65, torch.float32, 432),
    ("q8_0", 129, torch.bfloat16, 16), ("q8_0", 753, torch.bfloat16, 144),
    ("q4_0", 9, torch.float32, 16), ("q4_0", 129, torch.bfloat16, 432),
    ("q4_0", 753, torch.bfloat16, 48),
])
def test_large_m_tile_edges_match_plain(device, fmt, M, dtype, bn):
    """The fast large-M tile where it is most likely wrong: M off the 128-row
    tile, N = 1296 (a multiple of 16, not of 128), K = 1312 (a multiple of
    32, not of the 64-deep stage), and panels whose width is not a multiple
    of the tile's: within tolerance, the panels bit-equal to strided."""
    K, N = 1312, 1296
    qw = chip_smoke._rand_blocks(device, K, N, fmt, seed=51)
    packed = fmt == "q4_0"
    q, sc = qw["qs4" if packed else "qs"], qw["scales"]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(52),
                    device=device).to(dtype)
    kw = {"fast": True, **({"off": 8} if packed else {})}
    entry, pentry, plain = ((tqm.quant_matmul4, tqm.quant_matmul_panel4,
                             tqm.quant_matmul4_plain) if packed else
                            (tqm.quant_matmul, tqm.quant_matmul_panel, tqm.quant_matmul_plain))
    got = entry(x, q, sc, **kw)
    want = plain(x, q, sc, **kw)
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, dtype)).all())
    pw = tqm.panelize_weight(qw, bn)
    assert torch.equal(pentry(x, pw["qs4_p" if packed else "qs_p"], pw["scales_p"], **kw), got)


def _dequant_entry(packed: bool):
    return ((tqm.quant_matmul4, tqm.quant_matmul_panel4, tqm.quant_matmul4_plain) if packed
            else (tqm.quant_matmul, tqm.quant_matmul_panel, tqm.quant_matmul_plain))


def _dequant_into(device, x, q, sc, packed, off, out):
    """The dequantizing matmul's C entry into a given output (the wrapper
    allocates its own), fast mode, with the launch plan's scratch."""
    from qwen2_audio_tpu_torch.ops import _build
    group = x.shape[1] // sc.shape[0]
    plan = tqm.launch_plan("t", x, q, sc, group, True, tqm.sm_count(device))
    scratch = torch.empty(max(plan["scratch"], 1), dtype=torch.uint8, device=device)
    M, K = x.shape
    rc = _build.library("quant_matmul").qa_quant_matmul(
        x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), scratch.data_ptr(), None,
        M, K, plan["N"], plan["bn"], group, int(x.dtype == torch.bfloat16),
        int(sc.dtype == torch.float16), int(packed), off, 1, 0, plan["ksplit"],
        plan.get("bm", 0), plan["grid"][0], torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return plan


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("M", [9, 64, 65, 128, 129, 256, 257, 753, 1500])
def test_dequant_tile_rows_match_plain(device, fmt, M):
    """The fast M > 8 tile at every row count where its unit changes (16,
    64, 128 rows, 128 x 2, 192 or 256 wide, K split or not) on the ragged
    weight (N = 1296, K = 1312): within tolerance of the plain version, in
    panels of 48 and 432 bit-equal to strided, two runs bit-equal."""
    K, N = 1312, 1296
    qw = chip_smoke._rand_blocks(device, K, N, fmt, seed=70)
    packed = fmt == "q4_0"
    q, sc = qw["qs4" if packed else "qs"], qw["scales"]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(71 + M),
                    device=device).to(torch.bfloat16)
    kw = {"fast": True, **({"off": 8} if packed else {})}
    entry, pentry, plain = _dequant_entry(packed)
    got = entry(x, q, sc, **kw)
    want = plain(x, q, sc, **kw)
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(entry(x, q, sc, **kw), got)
    for bn in (48, 432):
        pw = tqm.panelize_weight(qw, bn)
        assert torch.equal(pentry(x, pw["qs4_p" if packed else "qs_p"], pw["scales_p"], **kw),
                           got)


@pytest.mark.parametrize("M,fmt,dtype", [(9, "q8_0", torch.bfloat16),
                                         (65, "q4_0", torch.float32),
                                         (129, "q8_0", torch.float32),
                                         (753, "q4_0", torch.bfloat16),
                                         (1500, "q8_0", torch.bfloat16)])
def test_dequant_tile_writes_every_output_over_nan(device, M, fmt, dtype):
    """The M > 8 tile at ragged M and N (1296 = 10 x 128 + 16), with and
    without a K split: an output filled with NaN first is finite everywhere
    after the launch and equals the wrapper's result bit for bit."""
    K, N = 1312, 1296
    packed = fmt == "q4_0"
    w = chip_smoke._rand_blocks(device, K, N, fmt, seed=72)
    q, sc = w["qs4" if packed else "qs"], w["scales"]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(73),
                    device=device).to(dtype)
    out = torch.full((M, N), float("nan"), dtype=dtype, device=device)
    plan = _dequant_into(device, x, q, sc, packed, 8 if packed else 0, out)
    torch.cuda.synchronize()
    assert plan["kernel"] == "wgmma" and bool(torch.isfinite(out).all())
    entry = _dequant_entry(packed)[0]
    assert torch.equal(out, entry(x, q, sc, fast=True, **({"off": 8} if packed else {})))


def test_dequant_tile_replays_in_a_graph_bit_equal(device):
    """The persistent tile at M = 752 (gate_up's 37888 columns, K cut to 512,
    the stacked entry) captured in a CUDA graph: every replay equals the
    eager call."""
    K, N, M = 512, 37888, 752
    w = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=74, layers=2)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(75),
                    device=device).to(torch.bfloat16)
    eager = tqm.quant_matmul_stacked(x, w["qs"], w["scales"], 1, fast=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tqm.quant_matmul_stacked(x, w["qs"], w["scales"], 1, fast=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tqm.quant_matmul_stacked(x, w["qs"], w["scales"], 1, fast=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("M", [64, 1500])
def test_dequant_tile_on_two_streams_is_bit_equal(device, M):
    """Launches of the persistent tile on two streams at once, queued behind
    a sleep on each (at M = 64 with a K split and its second launch, and at
    the encoder's M = 1500): every output equals the single-stream one."""
    K, N = (3584, 3584) if M == 64 else (1280, 3840)
    w = chip_smoke._rand_blocks(device, K, N, "q4_0", seed=76, layers=2)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(77),
                    device=device).to(torch.bfloat16)
    want = tqm.quant_matmul4_stacked(x, w["qs4"], w["scales"], 1, fast=True, off=8)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(int(1e8))
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(tqm.quant_matmul4_stacked(x, w["qs4"], w["scales"], 1, fast=True,
                                                      off=8))
    torch.cuda.synchronize()
    assert len(outs) == 16 and all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("M,K,N", [(1500, 1280, 1280), (9, 256, 128), (752, 512, 37888)])
def test_dequant_tile_counts_below_and_far_above_the_sms(device, M, K, N):
    """120 units (the encoder's out: fewer CTAs than SMs), one tile split
    over K (M = 9, N = 128) and 1184 units (gate_up: about 9 a CTA): within
    tolerance of the plain version, two runs bit-equal."""
    w = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=78)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(79),
                    device=device).to(torch.bfloat16)
    group = K // w["scales"].shape[0]
    plan = tqm.launch_plan("t", x, w["qs"], w["scales"], group, True, tqm.sm_count(device))
    assert plan["kernel"] == "wgmma"
    assert plan["grid"][0] == min(plan["units"], tqm.sm_count(device))
    got = tqm.quant_matmul(x, w["qs"], w["scales"], fast=True)
    want = tqm.quant_matmul_plain(x, w["qs"], w["scales"], fast=True)
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(got, tqm.quant_matmul(x, w["qs"], w["scales"], fast=True))


@pytest.mark.parametrize("M", [9, 129, 753])
def test_int8_tile_edges_agree_across_forms(device, M):
    """The integer large-M tile at N = 1296 and K = 1312 (a multiple of 32,
    not of the 128-deep stage), f16 and f32 scales: within tolerance of the
    plain version, the nibble bytes and the int32 words of the same q4_0
    bytes bit-equal, the flat and stacked int8 entries bit-equal."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    K, N = 1312, 1296
    w4 = chip_smoke._rand_blocks(device, K, N, "q4_0", seed=53, layers=2)
    w8 = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=54)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(55),
                    device=device).to(torch.bfloat16)
    for sc in (w8["scales"], w8["scales"].float()):
        got = t8.quant_matmul_int8(x, w8["qs"], sc)
        want = t8.quant_matmul_int8_plain(x, w8["qs"], sc)
        assert bool(((got.float() - want.float()).abs()
                     <= _qmm_tol(want, torch.bfloat16)).all())
        assert torch.equal(got, t8.quant_matmul_int8_stacked(x, w8["qs"][None], sc[None], 0))
    by = t8.quant_matmul_int8_stacked(x, w4["qs4"], w4["scales"], 1, off=8)
    want = t8.quant_matmul_int8_packed_plain(x, w4["qs4"][1], w4["scales"][1], off=8)
    assert bool(((by.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(by, tb.quant_matmul_q4b_stacked(x, tb.pack_b32(w4["qs4"]),
                                                       w4["scales"], 1))


@pytest.mark.parametrize("M", [16, 17, 32, 33, 64, 65, 128, 129])
def test_int8_tile_every_unit_height(device, M):
    """Each of the tile's unit heights (16, 32, 64, 128 rows of x) full and
    one row past it, at K = 1312 (a last stage of one group: the second
    reads zeros past K) and N = 1296, bf16 x: int8 values, nibble bytes at
    off 0 and 8 and int32 words within tolerance of the plain version, the
    words bit-equal to the bytes, and the plan's rows as tile_plan says."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    K, N = 1312, 1296
    w8 = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=64, layers=2)
    w4 = chip_smoke._rand_blocks(device, K, N, "q4_0", seed=65, layers=2)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(66 + M),
                    device=device).to(torch.bfloat16)
    plan = t8.launch_plan("t", x, w8["qs"][1], w8["scales"][1], tqm.sm_count(device))
    assert plan["bm"] == (next(r for r in t8.TILE_ROWS if r >= M) if M <= 128 else
                          t8.tile_plan(M, N, tqm.sm_count(device))["bm"])
    got = t8.quant_matmul_int8_stacked(x, w8["qs"], w8["scales"], 1)
    want = t8.quant_matmul_int8_plain(x, w8["qs"][1], w8["scales"][1])
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    for off in (0, 8):
        got = t8.quant_matmul_int8_stacked(x, w4["qs4"], w4["scales"], 1, off=off)
        want = t8.quant_matmul_int8_packed_plain(x, w4["qs4"][1], w4["scales"][1], off=off)
        assert bool(((got.float() - want.float()).abs()
                     <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(got, tb.quant_matmul_q4b_stacked(x, tb.pack_b32(w4["qs4"]),
                                                        w4["scales"], 1))


@pytest.mark.parametrize("M", [9, 752])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_tile_activations_bit_equal_to_plain(device, M, dtype):
    """The quantizing kernel's f16 layouts for the M > 8 tile (K's order,
    the words form's words_k order; sx transposed in 16-row blocks) bit-equal
    to tile_activations_plain."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    x = chip_smoke._ties_and_zeros(device, M, 1312, dtype, seed=67)
    for form in (t8.STRIDED, t8.PACKED, t8.WORDS):
        xq, sx_t = t8._tile_activations(x, form)
        torch.cuda.synchronize()
        pq, ps = t8.tile_activations_plain(x, form)
        assert torch.equal(xq, pq) and torch.equal(sx_t, ps)


def _int8_into(device, x, q, sc, form, off, out):
    """The integer matmul's C entry into a given output (the wrapper
    allocates its own), with the launch plan's buffers."""
    from qwen2_audio_tpu_torch.ops import _build
    from qwen2_audio_tpu_torch.ops import quant_matmul as tqm_
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    plan = t8.launch_plan("t", x, q, sc, tqm_.sm_count(device))
    bufs = {k: torch.empty(shape, dtype=dt, device=device)
            for k, (shape, dt) in plan["buffers"].items()}
    M, K = x.shape
    rc = _build.library("quant_matmul_int8").qa_quant_matmul_int8(
        x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), bufs["xq"].data_ptr(),
        bufs["sx_t"].data_ptr(), M, K, q.shape[1], int(x.dtype == torch.bfloat16),
        int(sc.dtype == torch.float16), form, off, plan["bm"], plan["grid"][0],
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return plan


@pytest.mark.parametrize("M,form", [(9, 0), (65, 1), (129, 2), (753, 0), (753, 1)])
def test_int8_tile_writes_every_output_over_nan(device, M, form):
    """The M > 8 tile at ragged M and N (1296 = 10 x 128 + 16) writes every
    output it owns: an output filled with NaN first is finite everywhere
    after the launch and equals the wrapper's result bit for bit."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    K, N = 1312, 1296
    fmt = "q8_0" if form == 0 else "q4_0"
    w = chip_smoke._rand_blocks(device, K, N, fmt, seed=56 + form)
    q, sc = (w["qs"] if form == 0 else w["qs4"]), w["scales"]
    if form == 2:
        q = tb.pack_b32(q)
    off = 0 if form == 0 else 8
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(57),
                    device=device).to(torch.bfloat16)
    out = torch.full((M, N), float("nan"), dtype=torch.bfloat16, device=device)
    plan = _int8_into(device, x, q, sc, form, off, out)
    torch.cuda.synchronize()
    assert plan["kernel"] == "wgmma" and bool(torch.isfinite(out).all())
    want = (t8.quant_matmul_int8(x, q, sc) if form == 0 else
            tb.quant_matmul_q4b_stacked(x, q[None], sc[None], 0) if form == 2 else
            t8.quant_matmul_int8_stacked(x, q[None], sc[None], 0, off=8))
    assert torch.equal(out, want)


def test_int8_tile_replays_in_a_graph_bit_equal(device):
    """The persistent tile at M = 752 (gate_up's 37888 columns, K cut to
    512) captured in a CUDA graph: every replay equals the eager call."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    K, N, M = 512, 37888, 752
    w = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=58, layers=2)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(59),
                    device=device).to(torch.bfloat16)
    eager = t8.quant_matmul_int8_stacked(x, w["qs"], w["scales"], 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t8.quant_matmul_int8_stacked(x, w["qs"], w["scales"], 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t8.quant_matmul_int8_stacked(x, w["qs"], w["scales"], 1)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_int8_tile_on_two_streams_is_bit_equal(device):
    """Launches of the persistent tile on two streams at once, queued
    behind a sleep on each: every output equals the single-stream one."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    K, N, M = 1280, 3840, 1500
    w = chip_smoke._rand_blocks(device, K, N, "q4_0", seed=60, layers=2)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(61),
                    device=device).to(torch.bfloat16)
    want = t8.quant_matmul_int8_stacked(x, w["qs4"], w["scales"], 1, off=8)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(int(1e8))
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(t8.quant_matmul_int8_stacked(x, w["qs4"], w["scales"], 1, off=8))
    torch.cuda.synchronize()
    assert len(outs) == 16 and all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("M,N,tiles", [(1500, 1280, 120), (752, 37888, 1776)])
def test_int8_tile_counts_below_and_far_above_the_sms(device, M, N, tiles):
    """120 tiles (the encoder's o and fc2: fewer CTAs than SMs) and 1776
    (gate_up: 13.5 tiles a CTA), K cut to 512: within tolerance of the plain
    version, two runs bit-equal."""
    from qwen2_audio_tpu_torch.ops import quant_matmul as tqm_
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    K = 512
    w = chip_smoke._rand_blocks(device, K, N, "q8_0", seed=62)
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(63),
                    device=device).to(torch.bfloat16)
    plan = t8.launch_plan("t", x, w["qs"], w["scales"], tqm_.sm_count(device))
    assert plan["tiles"][0] * plan["tiles"][1] == tiles
    assert plan["grid"][0] == min(tiles, tqm_.sm_count(device))
    got = t8.quant_matmul_int8(x, w["qs"], w["scales"])
    want = t8.quant_matmul_int8_plain(x, w["qs"], w["scales"])
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(got, t8.quant_matmul_int8(x, w["qs"], w["scales"]))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_k_split_launches_on_two_streams_are_bit_equal(device, fmt):
    """The K-split M = 1 streaming matmul (qkv 3584 -> 4608) launched many
    times on two streams at once, and replayed in a CUDA graph: every output
    bit-equal to the single-stream one (launches on two streams, or in a
    graph, count their blocks on ticket arrays of their own)."""
    bad, total = chip_smoke.stream_ticket_mismatches(device, fmt, rounds=128)
    assert total == 2 * 128 + 4 and bad == 0


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 64])
def test_stream_matmul_rows_match_plain(device, fmt, M):
    """The M <= 8 tensor-core streaming kernel (fast mode; M = 9 and 64 take
    the large-M tile) at a ragged N = 1296 and K = 1312, bf16 x: within
    tolerance of the plain version, two runs bit-equal, the stacked entry and
    panels of 16 and 48 bit-equal to the flat one."""
    K, N = 1312, 1296
    qw = chip_smoke._rand_blocks(device, K, N, fmt, seed=61, layers=2)
    packed = fmt == "q4_0"
    key = "qs4" if packed else "qs"
    q, sc = qw[key], qw["scales"]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(62),
                    device=device).to(torch.bfloat16)
    kw = {"fast": True, **({"off": 8} if packed else {})}
    flat, stacked, pentry, plain = (
        (tqm.quant_matmul4, tqm.quant_matmul4_stacked, tqm.quant_matmul_panel4,
         tqm.quant_matmul4_plain) if packed else
        (tqm.quant_matmul, tqm.quant_matmul_stacked, tqm.quant_matmul_panel,
         tqm.quant_matmul_plain))
    got = flat(x, q[1], sc[1], **kw)
    want = plain(x, q[1], sc[1], **kw)
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, torch.bfloat16)).all())
    assert torch.equal(got, flat(x, q[1], sc[1], **kw))
    assert torch.equal(got, stacked(x, q, sc, 1, **kw))
    for bn in (16, 48):
        pw = tqm.panelize_weight({key: q[1], "scales": sc[1]}, bn)
        assert torch.equal(pentry(x, pw[key + "_p"], pw["scales_p"], **kw), got)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_1", "q6_K"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 33, 63, 64])
def test_stream_swiglu_rows_match_plain(device, fmt, M):
    """The one-launch SwiGLU's cooperative kernel (fast mode) at every row
    count up to 8 (per-warp streaming) and at 9, 16, 33, 63 and 64 (all rows
    at once, 2, 4 or 8 n-tiles), at a ragged D = 528: within tolerance of the
    plain version, two runs bit-equal, the split schema bit-equal to the
    fused one."""
    from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
    K, I, D = 512, 1056, 528
    gu, dn = chip_smoke._rand_mlp(device, K, I, D, fmt, seed=63)
    packed = "qs4" in gu
    order = (("qs4" if packed else "qs"), "scales") + (("mins",) if "mins" in gu else ())
    entry = {(False, 2): tfm.fused_mlp_stacked, (True, 3): tfm.fused_mlp4_stacked,
             (True, 2): tfm.fused_mlp4_sym_stacked}[packed, len(order)]
    x = torch.randn(M, K, generator=torch.Generator(device=device).manual_seed(64),
                    device=device).to(torch.bfloat16)
    args = [w[k] for w in (gu, dn) for k in order]
    leaves = [tuple(w[k][1] for k in order) for w in
              ({k: gu[k][..., :I] for k in order}, {k: gu[k][..., I:] for k in order}, dn)]
    got = entry(x, *args, 1, fast=True)
    want = tfm.fused_mlp_plain(x, *leaves, packed=packed, fast=True)
    tol = _qmm_tol(want, torch.bfloat16) \
        + chip_smoke.FUSED_FLIPS * tfm.gated_rounding_bound(x, *leaves, packed=packed)
    assert got.shape == (M, D) and bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, entry(x, *args, 1, fast=True))
    split = tfm.fused_mlp_split_stacked(
        x, tuple(gu[k][..., :I].contiguous() for k in order),
        tuple(gu[k][..., I:].contiguous() for k in order), tuple(dn[k] for k in order), 1,
        packed=packed, fast=True)
    assert torch.equal(split, got)


@pytest.mark.parametrize("M", [1, 8, 64])
def test_swiglu_captured_replay_is_bit_equal_to_eager(device, M):
    """The cooperative launch (its grid barrier and tile tickets on the
    capture's own ticket array) captured in a CUDA graph and replayed: every
    replay bit-equal to the eager call, at the three row regimes."""
    from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
    bad, total = chip_smoke.swiglu_graph_mismatches(device, M, dims=(1536, 8960))
    assert total == 9 and bad == 0
    assert tfm.fused_mlp_stacked.launches > 0


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_swiglu_on_two_streams_is_bit_equal(device, fmt):
    """The cooperative launch many times on two streams at once, queued
    behind a sleep on each: each stream's launches count on a ticket array
    of their own (grid barrier and tile tickets), so every output is
    bit-equal to the single-stream one, at 1 and 64 rows."""
    bad, total = chip_smoke.swiglu_stream_mismatches(device, fmt, rounds=32,
                                                     dims=(1536, 8960))
    assert total == 2 * 2 * 32 and bad == 0


# --------------------------------------------------------------------------- #
# CUDA graphs of the decode step and the encoder (runtime/generate.py,
# models/encoder.py, ops/graphs.py)
# --------------------------------------------------------------------------- #

_GRAPH_CFG = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                num_hidden_layers=2, num_attention_heads=14,
                                num_key_value_heads=2, head_dim=128,
                                tie_word_embeddings=False)


def _graph_decoder(device, quant, seed=0):
    return random_bundle(torch.Generator(device=device).manual_seed(seed), _GRAPH_CFG, 128,
                         dtype=torch.bfloat16, quant=quant)


def _generate_both(bundle, x, cache_dtype, steps=8, **kw):
    """The same request eager (the step read every step) and captured
    (replayed 3 steps a chunk): the outputs of each and the decode kernel's
    launches each counted."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    no_eos = torch.zeros(_GRAPH_CFG.vocab_size, device=x.device)
    no_eos[bundle.eos_token_id] = -torch.inf
    entry = tfd.flash_decode_quant if cache_dtype == "q8" else tfd.flash_decode
    out = []
    for capture, every in ((False, 1), (True, 3)):
        before = entry.launches
        res = tgen.generate_on_device(
            bundle.params, _GRAPH_CFG, x, no_eos, None, max_new_tokens=steps + 1,
            eos_token_id=bundle.eos_token_id, cache_max_ctx=64, cache_dtype=cache_dtype,
            capture=capture, check_every=every, **kw)
        torch.cuda.synchronize()
        out.append((res, entry.launches - before))
    return out


@pytest.mark.parametrize("quant", [None, "q8_0"], ids=["bf16_weights", "q8_0_weights"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "q8"], ids=["bf16_cache", "int8_cache"])
def test_captured_decode_step_bit_equal_to_eager(device, quant, cache_dtype):
    """8 steps of the decode step replayed from a CUDA graph, the positions
    moving on the device between replays, against the same steps run
    eagerly: the same tokens, bit-equal log-probabilities and logits, and
    the decode kernel counted L times a forward either way."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, quant)
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    (eager, n_eager), (graph, n_graph) = _generate_both(bundle, x, cache_dtype)
    assert eager[2] == graph[2] == 9
    for a, b in zip(eager, graph):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert n_eager == n_graph == _GRAPH_CFG.num_hidden_layers * 8
    assert len(tgen.captured_steps()) == 1 and tgen.captured_steps()[0].replays == 8


@pytest.mark.parametrize("quant", [None, "q8_0"], ids=["bf16_weights", "q8_0_weights"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "q8"], ids=["bf16_cache", "int8_cache"])
def test_captured_beam_step_bit_equal_to_eager(device, quant, cache_dtype):
    """Beam search of 5 hypotheses replayed from a captured step (the cache
    gathered in place every step) against the eager step loop: the same
    tokens, bit-equal log-probabilities, the decode kernel launched once a
    layer and step at B = 5."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, quant)
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    entry = tfd.flash_decode_quant if cache_dtype == "q8" else tfd.flash_decode
    out = []
    for capture, every in ((False, 1), (True, 3)):
        before = entry.launches
        res = tgen.beam_search_on_device(
            bundle.params, _GRAPH_CFG, x, beam_size=5, max_new_tokens=9,
            eos_token_id=bundle.eos_token_id, cache_max_ctx=64, cache_dtype=cache_dtype,
            repetition_penalty=1.3, capture=capture, check_every=every)
        torch.cuda.synchronize()
        out.append((res, entry.launches - before))
    (eager, n_eager), (graph, n_graph) = out
    assert eager[2] == graph[2] == 9
    assert torch.equal(eager[0], graph[0]) and torch.equal(eager[1], graph[1])
    assert n_eager == n_graph == _GRAPH_CFG.num_hidden_layers * 8


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "q8"], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("spec_k", [7, 8])
def test_captured_speculative_step_bit_equal_to_eager(device, cache_dtype, spec_k):
    """Speculative decoding replayed from a captured verify step, replays
    after the stop included, against the eager loop: the same tokens,
    log-probabilities and iterations, bit for bit. The cache holds
    T0 + budget + K rows, 39 at K = 7: at Hkv = 2 each layer's int8-cache
    scales start off the 16-byte grid."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, "q8_0")
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    runs = [tgen.generate_speculative(
        bundle.params, _GRAPH_CFG, x, max_new_tokens=12, eos_token_id=bundle.eos_token_id,
        cache_max_ctx=20 + 12 + spec_k, cache_dtype=cache_dtype, spec_k=spec_k,
        capture=capture, check_every=every) for capture, every in ((False, 1), (True, 4))]
    for a, b in zip(*runs):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_captured_step_with_repetition_penalty(device):
    """A repetition penalty keeps a seen-token mask in the captured step,
    written with device values only (a Python True would be copied in from
    the host, which a capture refuses): bit-equal to the eager step."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, None)
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    (eager, _), (graph, _) = _generate_both(bundle, x, torch.bfloat16, repetition_penalty=1.3)
    for a, b in zip(eager, graph):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_captured_step_keyed_on_switches_and_weights(device):
    """A process switch or another weight tree gets a graph of its own (not
    the stale one): each run bit-equal to the eager step under the same
    switch and weights."""
    from qwen2_audio_tpu_torch.ops.linear import set_fused_mlp
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, "q8_0")
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    runs = []
    try:
        for switch, b in ((None, bundle), (False, bundle), (False, _graph_decoder(
                device, "q8_0", seed=1))):
            set_fused_mlp(switch)
            (eager, _), (graph, _) = _generate_both(b, x, torch.bfloat16)
            assert torch.equal(eager[0], graph[0]) and torch.equal(eager[3], graph[3])
            runs.append(graph)
    finally:
        set_fused_mlp(None)
    assert len(tgen.captured_steps()) == 3
    assert not torch.equal(runs[0][3], runs[2][3])


def test_captured_step_draws_from_its_generator(device):
    """At temperature > 0 the captured step draws from the generator
    registered with its graph: the eager step's tokens from the same seed,
    at two temperatures through one graph."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, None)
    x = torch.randn(1, 20, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device).to(torch.bfloat16)
    for temperature in (0.9, 0.5):
        (eager, _), (graph, _) = _generate_both(bundle, x, torch.bfloat16,
                                                temperature=temperature, top_k=40, seed=5)
        assert torch.equal(eager[0], graph[0]) and torch.equal(eager[1], graph[1])
    assert len(tgen.captured_steps()) == 1


def test_captured_encoder_equals_encoder_forward(device):
    """whisper_full's encode replays a captured encoder_forward: bit-equal to
    the eager forward on the same window, the attention kernel counted once
    a layer and call, and two states' embeddings held apart."""
    from qwen2_audio_tpu_torch.audio.mel import mel_input_window
    from qwen2_audio_tpu_torch.models.encoder import encoder_forward
    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_mels=80)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(80), [b"a"])
    ctx = capi.whisper_init_from_buffer_with_params(
        buf.getvalue(), ContextParams(compute_dtype=torch.bfloat16))
    p = capi.whisper_full_default_params()
    states = [ctx.init_state() for _ in range(2)]
    before = tfa.attention_single.launches
    for i, st in enumerate(states):
        assert capi.whisper_full_with_state(ctx, st, p,
                                            chip_smoke.noisy_tone(2.0, seed=6 + i)) == 0
    assert tfa.attention_single.launches == before + 2 * hp.n_audio_layer
    assert len(ctx.encoder.graphs) == 1 and ctx.encoder.graphs.values()[0].replays == 2
    enc = ctx.encoder
    for st in states:
        win = mel_input_window(st.mel, 0, hp.n_audio_ctx).to(device)[None]
        want = encoder_forward(enc.params, win, hp, gelu_approximate=enc.gelu_approximate,
                               use_flash=True, compute_dtype=enc.compute_dtype)[0]
        assert torch.equal(st.embd_enc, want)
    assert states[0].embd_enc.data_ptr() != states[1].embd_enc.data_ptr()
    assert not torch.equal(states[0].embd_enc, states[1].embd_enc)


# --------------------------------------------------------------------------- #
# the slot pool, the w8a8 product (runtime/generate.py, ops/linear.py)
# --------------------------------------------------------------------------- #

def _pool_run(bundle, prefills, cache_dtype, capture, eos, spec_k=0, chunk=5, rounds=4):
    """A pool of 3 slots over prefills of different lengths: after each chunk
    every finished slot is refilled with the next stream (its position
    restarting there), as runtime/serving.py does; every chunk's outputs
    and the pool's positions and logits after it."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    dev = prefills[0].device
    B, V = 3, _GRAPH_CFG.vocab_size
    pool = (create_cache(_GRAPH_CFG, B, 64, dtype=cache_dtype, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev), torch.zeros(B, V, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev))
    hist = torch.zeros(B, 64, dtype=torch.int32, device=dev)
    hlen = torch.zeros(B, dtype=torch.int32, device=dev)
    queue = iter(prefills)
    out = []

    def refill(slots):
        for s in slots:
            x = next(queue, None)
            if x is not None:
                tgen.prefill_slot(bundle.params, _GRAPH_CFG, *pool, s, x)
                hist[s] = 0
                hlen[s] = 0

    refill(range(B))
    for _ in range(rounds):
        if spec_k:
            res = tgen.decode_chunk_slots_spec(bundle.params, _GRAPH_CFG, *pool, hist, hlen,
                                               chunk=chunk, eos_token_id=eos, spec_k=spec_k,
                                               capture=capture)[6:]
        else:
            res = tgen.decode_chunk_slots(bundle.params, _GRAPH_CFG, *pool, chunk=chunk,
                                          eos_token_id=eos, capture=capture)[4:]
        out.append([t.clone() for t in res] + [pool[1].clone(), pool[2].clone()])
        refill([s for s in range(B) if not bool(pool[3][s])])
    tgen.drop_pool_graphs(pool[1])
    return out


def _pool_prefills(device, n=6):
    gen = torch.Generator(device=device).manual_seed(5)
    return [torch.randn(1, t0, 256, generator=gen, device=device).to(torch.bfloat16)
            for t0 in (20, 13, 27, 9, 17, 22)[:n]]


@pytest.mark.parametrize("quant", [None, "q8_0"], ids=["bf16_weights", "q8_0_weights"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "q8"], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("spec_k", [0, 7], ids=["plain", "speculative"])
def test_captured_pool_bit_equal_to_eager(device, quant, cache_dtype, spec_k):
    """The pool's captured step (plain: replayed ``chunk`` times; speculative:
    iterations in groups, the condition read once a group) against the same
    chunks run eagerly, at depth 2 with slots at different positions, an EOS
    that a slot emits mid-chunk and the refills after it: every chunk's
    tokens, log-probabilities (and counts), positions and logits bit-equal;
    the decode kernel launched once a layer and step in the plain pool."""
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, quant)
    pre = _pool_prefills(device)
    free = _pool_run(bundle, pre, cache_dtype, False, -1, rounds=1)
    eos = int(free[0][0][1, 2])         # slot 1 emits it at step 2 of the first chunk
    entry = tfd.flash_decode_quant if cache_dtype == "q8" else tfd.flash_decode
    runs = []
    for capture in (False, True):
        before = entry.launches
        runs.append(_pool_run(bundle, pre, cache_dtype, capture, eos, spec_k=spec_k))
        runs[-1].append(entry.launches - before)
    eager, graph = runs
    assert eager[-1] == graph[-1]
    if not spec_k:
        assert eager[-1] == _GRAPH_CFG.num_hidden_layers * 5 * 4
    for a, b in zip(eager[:-1], graph[:-1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    toks = torch.cat([r[0] for r in eager[:-1]], dim=1)
    assert bool((toks == eos).any()), "no slot stopped: the refill was not exercised"
    assert len(set(eager[1][-2].tolist())) > 1, "positions are not ragged"
    assert not tgen.captured_steps()


@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 1500])
@pytest.mark.parametrize("K,N", [(3584, 4608), (1280, 3840)])
def test_w8a8_product_exact_on_card(device, M, K, N):
    """``int8_matmul`` (torch._int_mm, rows padded past 16 below 17) is the
    plain int32 product exactly, over a row-major and a K-major weight; the
    whole w8a8 linear (row quantization, product, rescale) gives the CPU's
    bits."""
    from qwen2_audio_tpu_torch.ops import linear as tl
    gen = torch.Generator().manual_seed(M + K)
    a = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8)
    before = tl.int8_matmul.launches
    got = tl.int8_matmul(a.to(device), b.to(device))
    assert tl.int8_matmul.launches == before + 1 and got.shape == (M, N)
    assert torch.equal(got.cpu(), tl.int8_matmul_plain(a, b))
    assert torch.equal(tl.int8_matmul_plain(a.to(device), b.to(device)).cpu(), got.cpu())
    # K-major, as the decoder and encoder modules hold the weight
    bk = tl.w8a8_layout({"qs8": b.to(device)})["qs8"]
    assert bk.stride(0) == 1 and torch.equal(tl.int8_matmul(a.to(device), bk), got)
    x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
    sc = torch.rand(N, generator=gen) * 0.01
    card = tl.w8a8(x.to(device), b.to(device), sc.to(device))
    assert torch.equal(card.cpu(), tl.w8a8(x, b, sc))
    with pytest.raises(ValueError, match="multiples of 8"):
        tl.int8_matmul(a[:, :K - 4].to(device), b[:K - 4, :].to(device)[:, :N - 4])


def test_prefill_slot_into_an_int8_cache_at_an_odd_capacity(device):
    """A slot prefilled into the int8 pool at capacity 39 (Hkv 2: each
    layer's scales off the 16-byte grid) holds the bits of the same prefill
    into a cache of its own; the other slot's rows are untouched; a captured
    chunk over the pool equals the eager one."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
    from qwen2_audio_tpu_torch.runtime import generate as tgen
    tgen.clear_graphs()
    bundle = _graph_decoder(device, None)
    x = _pool_prefills(device, 1)[0]
    ref = create_cache(_GRAPH_CFG, 1, 39, dtype="q8", device=device)
    logits, _ = decoder_forward(bundle.params, _GRAPH_CFG, x, ref, 0, block_only=True,
                                logits_last_only=True)
    outs = []
    for capture in (False, True):
        pool = (create_cache(_GRAPH_CFG, 2, 39, dtype="q8", device=device),
                torch.zeros(2, dtype=torch.int32, device=device),
                torch.zeros(2, _GRAPH_CFG.vocab_size, device=device),
                torch.zeros(2, dtype=torch.bool, device=device))
        tgen.prefill_slot(bundle.params, _GRAPH_CFG, *pool, 1, x)
        for buf, want in zip(pool[0].parts(), ref.parts()):
            assert torch.equal(buf[:, 1, :20], want[:, 0, :20])
            assert not buf[:, 0].any() and not buf[:, 1, 20:].any()
        assert torch.equal(pool[2][1], logits[0, -1]) and pool[1].tolist() == [0, 20]
        res = tgen.decode_chunk_slots(bundle.params, _GRAPH_CFG, *pool, chunk=6,
                                      eos_token_id=-1, capture=capture)
        outs.append([t.clone() for t in res[1:]])
        tgen.drop_pool_graphs(pool[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# tensor parallelism on one card (gloo ranks) and the training step
# --------------------------------------------------------------------------- #

TP_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                tie_word_embeddings=False)


def test_tp_forward_on_card_matches_one_process(device):
    """Two gloo ranks on the card (chip_smoke's phase 4i ranks at a small
    width): each case's prefill and teacher-forced steps within phase 4i's
    tolerances of one process, the ranks' logits bit-equal; the q8_0 pools'
    streams one process's."""
    import dataclasses

    from qwen2_audio_tpu_torch.parallel.launch import spawn_world
    cfg = Qwen2DecoderConfig(**TP_SMALL)
    cases = (("bf16", None, "bf16"), ("q8_0", None, "q8"))
    single = [chip_smoke.tp_single(cfg, c, device) for c in cases]
    pool_want = chip_smoke.tp_pool(chip_smoke.tp_tree(cfg, "q8_0", device, torch.float32, 44),
                                   cfg, device)
    ranks = spawn_world(chip_smoke.tp_rank, 2, timeout=chip_smoke.TP_TIMEOUT,
                        args=(dataclasses.asdict(cfg), None, cases,
                              [s["tokens"] for s in single]))
    for i, want in enumerate(single):
        got = [r["cases"][i] for r in ranks]
        assert got[0]["sha"] == got[1]["sha"]
        _, cos, rel = chip_smoke._tp_held(got[0]["logits"], want["logits"].numpy())
        assert cos >= chip_smoke.TP_COS_MIN and rel <= chip_smoke.TP_REL, (cases[i], cos, rel)
        assert got[0]["launches"].get("attention_causal", 0) > 0
    assert ranks[0]["pool"]["streams"] == ranks[1]["pool"]["streams"] == pool_want


def test_train_step_on_card_matches_cpu(device):
    """The single-process train step on the card against the same step on
    the CPU (float32, TF32 off): three losses at rtol 1e-4, the first
    step's gradients at atol 1e-5, rtol 1e-3."""
    from qwen2_audio_tpu_torch.config import Qwen2AudioConfig
    from qwen2_audio_tpu_torch.training import step as tstep
    cfg = Qwen2AudioConfig(
        audio=WhisperHParams(n_vocab=64, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                             n_audio_layer=2, n_mels=16),
        text=Qwen2DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, head_dim=16,
                                tie_word_embeddings=False))
    r = np.random.default_rng(5)
    batch = (torch.from_numpy(r.standard_normal((2, 16, 64)).astype(np.float32)),
             torch.from_numpy(r.integers(0, 128, (2, 8))),
             torch.ones(2, 8))
    runs = {}
    for dev in (torch.device("cpu"), device):
        st = tstep.init_train_state(np.random.default_rng(0), cfg, tstep.adamw(1e-3),
                                    device=dev)
        train = tstep.make_train_step(cfg)
        losses, grads = [], None
        for i in range(3):
            st, loss = train(st, *(t.to(dev) for t in batch))
            losses.append(loss)
            if i == 0:
                grads = [p.grad.cpu().clone() for p in tstep.leaves(st.params)]
        runs[dev.type] = (losses, grads)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


def test_cli_on_card_matches_capi(device, tmp_path, capsys):
    """The port's CLI in this process (cli.main.run, no -ng) on a tiny ggml
    checkpoint and a tiny HF decoder on the card: the mel, encoder
    attention, causal prefill and decode kernels launched; the embedding
    bit-equal to capi.whisper_full's on a context built the same way with
    the same build_full_params, the tokens and the txt file the same."""
    import json

    from qwen2_audio_tpu_torch.audio import write_wav
    from qwen2_audio_tpu_torch.cli import main as cli_main
    from qwen2_audio_tpu_torch.cli.output_formats import write_outputs
    from qwen2_audio_tpu_torch.io.hf import load_qwen2_audio
    from qwen2_audio_tpu_torch.ops import launch_counters

    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_mels=80)
    cfg = Qwen2DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=2,
                             num_key_value_heads=1, head_dim=128, audio_token_id=500)
    model = str(tmp_path / "model.bin")
    write_encoder_checkpoint(model, random_encoder_params(np.random.default_rng(0), hp), hp,
                             mel_filterbank(80), [b"a"])
    hf = str(tmp_path / "hf")
    chip_smoke.write_hf_checkpoint(hf, hp, cfg, device)
    with open(tmp_path / "hf" / "config.json") as f:
        conf = json.load(f)
    conf["text_config"]["eos_token_id"] = 7
    with open(tmp_path / "hf" / "config.json", "w") as f:
        json.dump(conf, f)
    wav = str(tmp_path / "clip.wav")
    write_wav(wav, chip_smoke.noisy_tone(3.0, seed=8))
    argv = ["-m", model, "-f", wav, "--decoder", hf, "--bench-iters", "1", "-nf",
            "--max-new-tokens", "8", "-otxt"]
    counters = launch_counters()
    names = ("mel_log_frames", "attention_single", "attention_causal", "flash_decode")
    before = {k: counters[k].launches for k in names}
    rc, ctx = cli_main.run(argv)
    assert rc == 0 and ctx.device.type == "cuda"
    assert all(counters[k].launches > before[k] for k in names), \
        {k: counters[k].launches - before[k] for k in names}
    args = cli_main.build_parser().parse_args(argv)
    ref = capi.whisper_init_from_file_with_params(model, ContextParams())
    ref.decoder = load_qwen2_audio(hf)["bundle"]
    from qwen2_audio_tpu_torch.audio import read_audio
    assert capi.whisper_full(ref, cli_main.build_full_params(args), read_audio(wav)[0]) == 0
    assert torch.equal(ctx.state.embd_enc, ref.state.embd_enc)
    assert ctx.state.result_tokens == ref.state.result_tokens and ctx.state.result_tokens
    (tmp_path / "ref").mkdir()
    [txt] = write_outputs(str(tmp_path / "ref" / "clip.wav"), ref.state.segments, args)
    assert (tmp_path / "clip.txt").read_bytes() == open(txt, "rb").read()


def test_rpc_round_trip_on_card(device, tmp_path):
    """The port's RPC server in this process and its client, the context on
    the card (the client's default ContextParams): the server reports
    "cuda", its connection thread launches the mel and encoder attention
    kernels, and the embedding it returns is bit-equal to a local
    capi.whisper_full on the card (float32 on both sides)."""
    from qwen2_audio_tpu_torch.ops import launch_counters
    from qwen2_audio_tpu_torch.runtime import RemoteWhisperContext, RpcServer

    hp = WhisperHParams(n_vocab=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_mels=80)
    model = str(tmp_path / "model.bin")
    write_encoder_checkpoint(model, random_encoder_params(np.random.default_rng(0), hp), hp,
                             mel_filterbank(80), [b"a"])
    pcm = chip_smoke.noisy_tone(3.0, seed=9)
    srv = RpcServer("127.0.0.1", 0)
    srv.start_background()
    try:
        counters = launch_counters()
        names = ("mel_log_frames", "attention_single")
        before = {k: counters[k].launches for k in names}
        cli = RemoteWhisperContext.connect(f"127.0.0.1:{srv.port}")
        assert cli.server_backend == "cuda"
        assert cli.server_devices == [torch.cuda.get_device_name(0)]
        cli.load_model_file(model)
        for _ in range(2):
            assert cli.full(capi.whisper_full_default_params(), pcm) == 0
        emb, fp = cli.get_emb_enc(), cli.print_emb_enc()
        cli.close()
        assert all(counters[k].launches > before[k] for k in names), \
            {k: counters[k].launches - before[k] for k in names}
    finally:
        srv.shutdown()
    ref = capi.whisper_init_from_file_with_params(model, ContextParams())
    assert capi.whisper_full(ref, capi.whisper_full_default_params(), pcm) == 0
    assert ref.device.type == "cuda"
    np.testing.assert_array_equal(emb, ref.state.embd_enc.cpu().numpy())
    assert fp == ref.print_emb_enc()


# the M <= 8 integer kernel's edges: N a multiple of 16 and not of the
# 128-column tile (1296 = 10 x 128 + 16), K a multiple of 32 and not of the
# plan's split (1312 = 41 groups, a prime count)
_SMALL_K, _SMALL_N = 1312, 1296


def _small_inputs(device, M, xdt, sdt, seed):
    w8 = chip_smoke._rand_blocks(device, _SMALL_K, _SMALL_N, "q8_0", seed=seed, layers=2)
    w4 = chip_smoke._rand_blocks(device, _SMALL_K, _SMALL_N, "q4_0", seed=seed + 1, layers=2)
    x = torch.randn(M, _SMALL_K, generator=torch.Generator(device=device).manual_seed(seed + 2),
                    device=device).to(xdt)
    return x, w8["qs"], w8["scales"].to(sdt), w4["qs4"], w4["scales"].to(sdt)


@pytest.mark.parametrize("sdt", [torch.float16, torch.float32])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", range(1, 9))
def test_int8_small_every_row_count_form_and_type(device, M, xdt, sdt):
    """The one-launch M <= 8 kernel at every M from 1 to 8, bf16 and
    float32 x, float16 and float32 scales, ragged N and K split unevenly:
    int8 values, nibble bytes with off 8 and 0, and int32 words, each within
    phase 2's tolerance of its plain version; two runs bit-equal, the flat
    entry bit-equal to the stacked one, the words bit-equal to the nibble
    bytes with off 8."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    x, q8, s8, q4, s4 = _small_inputs(device, M, xdt, sdt, 70 + M)
    plan = t8.launch_plan("t", x, q8[1], s8[1], tqm.sm_count(device))
    assert plan["kernel"] == "small" and plan["ksplit"] > 1 and 41 % plan["ksplit"]
    before = t8.quant_matmul_int8_stacked.launches
    cases = [
        (lambda: t8.quant_matmul_int8_stacked(x, q8, s8, 1),
         t8.quant_matmul_int8_plain(x, q8[1], s8[1])),
        (lambda: t8.quant_matmul_int8_stacked(x, q4, s4, 1, off=8),
         t8.quant_matmul_int8_packed_plain(x, q4[1], s4[1], off=8)),
        (lambda: t8.quant_matmul_int8_stacked(x, q4, s4, 1, off=0),
         t8.quant_matmul_int8_packed_plain(x, q4[1], s4[1], off=0)),
    ]
    outs = []
    for run, want in cases:
        got = run()
        assert got.shape == (M, _SMALL_N) and got.dtype == xdt
        assert bool(torch.isfinite(got).all())
        assert bool(((got.float() - want.float()).abs() <= _qmm_tol(want, xdt)).all())
        assert torch.equal(got, run())
        outs.append(got)
    assert t8.quant_matmul_int8_stacked.launches == before + 2 * len(cases)
    assert torch.equal(outs[0], t8.quant_matmul_int8(x, q8[1], s8[1]))
    words = tb.quant_matmul_q4b_stacked(x, tb.pack_b32(q4), s4, 1)
    assert torch.equal(words, outs[1])


@pytest.mark.parametrize("M", [1, 5, 8])
def test_int8_small_replays_in_a_graph_bit_equal(device, M):
    """The three forms of the M <= 8 kernel captured in one CUDA graph (its
    split's tickets on the capture's own array): every replay bit-equal to
    the eager calls, and every ticket back at 0 after the launches."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
    x, q8, s8, q4, s4 = _small_inputs(device, M, torch.bfloat16, torch.float16, 90 + M)
    words = tb.pack_b32(q4)

    def calls():
        return (t8.quant_matmul_int8_stacked(x, q8, s8, 1),
                t8.quant_matmul_int8_stacked(x, q4, s4, 1, off=8),
                tb.quant_matmul_q4b_stacked(x, words, s4, 1))

    eager = calls()
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    tickets = tqm.ticket_array(device, stream.cuda_stream, kind="quant_matmul_int8")
    assert int(tickets.abs().sum()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        calls()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))
    assert torch.equal(outs[1], outs[2])
    assert int(tickets.abs().sum()) == 0


def test_int8_small_on_two_streams_is_bit_equal(device):
    """The K-split M = 8 kernel launched many times on two streams at once,
    queued behind a sleep on each (each stream's launches count on its own
    ticket array): every output equals the single-stream one."""
    from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
    x, q8, s8, _, _ = _small_inputs(device, 8, torch.bfloat16, torch.float16, 99)
    want = t8.quant_matmul_int8_stacked(x, q8, s8, 1)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(int(1e8))
    for _ in range(16):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(t8.quant_matmul_int8_stacked(x, q8, s8, 1))
    torch.cuda.synchronize()
    assert len(outs) == 32 and all(torch.equal(o, want) for o in outs)
