"""Causal prefill attention: the port's plain version (what the wrapper runs
on the CPU) against the JAX package's blockwise Pallas kernel in interpret
mode and against the decoder's einsum attention."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.models.qwen2_decoder import _gqa_attention
from qwen2_audio_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("qwen2_audio_tpu.ops.flash_attention")
ATOL = 2e-5   # float32; the kernel and the plain version sum in other orders


def _qkv(rng, B, H, Hkv, T, d):
    q = rng.standard_normal((B, H, T, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,Hkv,T,d,kv_valid", [
    (1, 7, 1, 200, 128, None),    # g = 7 (the 7B grouping), T not a block multiple
    (2, 4, 2, 130, 64, None),     # B = 2, ragged T
    (1, 4, 4, 160, 64, 121),      # keys past kv_valid masked too
])
def test_plain_matches_pallas_causal(B, H, Hkv, T, d, kv_valid, rng):
    q, k, v = _qkv(rng, B, H, Hkv, T, d)
    scale = d ** -0.5
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale,
        causal=True, kv_valid=kv_valid, block_q=128, block_k=128))
    before = tfa.attention_causal.launches
    got = tfa.attention_causal(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale, kv_valid)
    assert tfa.attention_causal.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


def test_plain_matches_decoder_einsum(rng):
    """The decoder's block prefill: (B, T, H, d) heads, GQA g = 7."""
    B, T, Hq, Hkv, d = 2, 45, 14, 2, 128
    q = rng.standard_normal((B, T, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    want = np.asarray(_gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 0, T))
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got = tfa.attention_causal(tq, tk, tv, d ** -0.5)
    assert got.shape == (B, Hq, T, d)
    np.testing.assert_allclose(got.transpose(1, 2).reshape(B, T, -1).numpy(),
                               want, atol=ATOL, rtol=1e-4)


def test_bf16_plain_tracks_f32(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 4, 2, 96, 128))
    ref = tfa.attention_causal(q, k, v, 128 ** -0.5)
    got = tfa.attention_causal(q.bfloat16(), k.bfloat16(), v.bfloat16(), 128 ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def test_first_row_sees_only_key_zero(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 2, 2, 16, 64))
    out = tfa.attention_causal(q, k, v, 0.125)
    torch.testing.assert_close(out[:, :, 0], v[:, :, 0], rtol=0, atol=1e-6)


def test_wrapper_rejects_bad_input():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        tfa.attention_causal(q, q, q, 1.0, kv_valid=0)
    with pytest.raises(ValueError):
        tfa.attention_causal(q, torch.zeros(1, 2, 9, 64), torch.zeros(1, 2, 9, 64), 1.0)
    with pytest.raises(ValueError):
        tfa.attention_causal(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64), 1.0)
    m = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.attention_causal(m, m, m, 1.0)


def _causal_chunked_bf16(q, k, v, scale, fault=None, chunk=64):
    """The bf16 causal kernel's arithmetic in plain PyTorch: keys in chunks
    of 64 up to each 64-row block's diagonal, running max and sum in
    float32, p rounded to bf16 for P V. ``fault`` plants a bug."""
    g = q.shape[1] // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    T = q.shape[2]
    out = torch.empty(q.shape)
    for q0 in range(0, T, chunk):
        rows = torch.arange(q0, min(q0 + chunk, T))[:, None]
        qb = qf[:, :, q0:q0 + chunk]
        m = torch.full(qb.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape)
        starts = list(range(0, q0 + 1, chunk))
        if fault == "skip_diagonal" and len(starts) > 1:
            starts = starts[:-1]
        for k0 in starts:
            s = qb @ kf[:, :, k0:k0 + chunk].transpose(-1, -2) * scale
            cols = torch.arange(k0, min(k0 + chunk, T))[None, :]
            s = s.masked_fill(cols > rows, -torch.inf)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - mn)
            p = torch.exp(s - mn)
            m = mn
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + chunk]
        out[:, :, q0:q0 + chunk] = acc / l
    return out.bfloat16()


@pytest.mark.parametrize("fault", [None, "skip_diagonal", "no_rescale"])
def test_bf16_causal_tolerance_separates_faults(fault):
    """chip_smoke's bf16 tolerance for the causal kernel (with its p-rounding
    term) admits the kernel's sound chunked arithmetic and rejects planted
    faults by a wide margin."""
    import chip_smoke
    atol, rtol = chip_smoke.ATTN_TOL["bfloat16"]
    q, k, v = chip_smoke._causal_case("cpu", torch.bfloat16, 1, 4, 2, 256, 128, seed=3)
    scale = 128 ** -0.5
    want = tfa.attention_causal_plain(q, k, v, scale).float()
    tol = atol + rtol * want.abs() + chip_smoke.P_ROUND * \
        tfa.attention_causal_plain(q, k, v.abs(), scale).float()
    got = _causal_chunked_bf16(q, k, v, scale, fault).float()
    used = ((got - want).abs() / tol).max().item()
    if fault is None:
        assert used <= 1.0
    else:
        assert used >= 10.0
