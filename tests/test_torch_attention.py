"""Attention kernel's plain version (what the wrapper runs on the CPU)
against the JAX package's one-shot Pallas kernel in interpret mode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.models.encoder import _sdpa as jax_sdpa
from qwen2_audio_tpu_torch.ops import fa_variants as tfv
from qwen2_audio_tpu_torch.ops import flash_attention as tfa

# the package's ops/__init__ re-exports a function of the module's name
jfa = importlib.import_module("qwen2_audio_tpu.ops.flash_attention")
ATOL = 2e-5   # float32; the two sum in different orders


@pytest.mark.parametrize("B,H,Hkv,T,d,kv_valid", [
    (1, 4, 4, 300, 64, None),
    (2, 4, 4, 256, 64, None),
    (1, 4, 2, 256, 64, None),      # GQA
    (1, 4, 2, 300, 64, 211),       # GQA + ragged keys
    (2, 2, 2, 200, 128, 150),      # ragged keys, d = 128
])
def test_plain_matches_single_kernel(B, H, Hkv, T, d, kv_valid, rng):
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    if kv_valid is not None:
        k[:, :, kv_valid:] = 100.0     # poison the masked tail
        v[:, :, kv_valid:] = 100.0
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=1.0,
        kv_valid=kv_valid, single=True, lite=False))
    got = tfa.attention_single(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_valid)
    assert tfa.attention_single.launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


def test_encoder_entry_matches_jax(monkeypatch, rng):
    # off the TPU the JAX entry would take the quarantined lite kernel
    monkeypatch.setenv("QA_FA_LITE", "0")
    B, T, D, H = 2, 300, 128, 2
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(jfa.flash_attention_encoder(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H))
    got = tfv.flash_attention_encoder(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


def test_sdpa_matches_jax(rng):
    """The encoder's use_flash=False path against the JAX einsum _sdpa."""
    B, T, D, H = 1, 200, 64, 4
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H))
    got = tfa.attention_encoder_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


def test_fused_qkv_views_equal_contiguous(rng):
    """Head views into one fused projection give what contiguous copies give."""
    B, T, H, d = 2, 96, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * d)).astype(np.float32))
    views = [x.unflatten(-1, (H, d)).transpose(1, 2) for x in qkv.chunk(3, -1)]
    a = tfa.attention_single(*views)
    b = tfa.attention_single(*(x.contiguous() for x in views))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_plain_tracks_f32(rng):
    B, H, T, d = 1, 2, 128, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32))
               for _ in range(3))
    q = q * d ** -0.5
    ref = tfa.attention_single(q, k, v)
    got = tfa.attention_single(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def _chunked_bf16(q, k, v, fault=None, chunk=64):
    """The bf16 kernel's arithmetic in plain PyTorch: keys in chunks of 64,
    running max and sum in float32, p rounded to bf16 for P V, one bf16
    rounding of the output. ``fault`` plants a bug for the tolerance check."""
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    starts = list(range(0, k.shape[2], chunk))
    if fault == "drop_last_chunk":
        starts = starts[:-1]
    for k0 in starts:
        s = qf @ kf[:, :, k0:k0 + chunk].transpose(-1, -2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - mn)
        p = torch.exp(s - mn)
        m = mn
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + chunk]
    return (acc / l).bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_last_chunk", "no_rescale"])
def test_bf16_tolerance_separates_faults(fault):
    """chip_smoke's bf16 tolerance at the encoder's T and d admits the
    kernel's sound arithmetic and rejects planted faults by a wide margin."""
    import chip_smoke
    atol, rtol = chip_smoke.ATTN_TOL["bfloat16"]
    q, k, v = chip_smoke._attn_case("cpu", torch.bfloat16, 1, 4, 4, 1500, 64,
                                    1500, True, seed=10)
    want = tfa.attention_single_plain(q, k, v).float()
    used = ((_chunked_bf16(q, k, v, fault).float() - want).abs()
            / (atol + rtol * want.abs())).max().item()
    if fault is None:
        assert used <= 1.0
    else:
        assert used >= 10.0


def test_wrapper_rejects_bad_input():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        tfa.attention_single(q, q, q, kv_valid=0)
    with pytest.raises(ValueError):
        tfa.attention_single(q, q, q, kv_valid=9)
    with pytest.raises(ValueError):
        tfa.attention_single(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64))
    m = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.attention_single(m, m, m)
