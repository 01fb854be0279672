"""Decode-step cache attention: the port's plain versions (what the wrappers
run on the CPU) against the JAX package's flash_decode kernels in Pallas
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.models.qwen2_decoder import _quantize_kv
from qwen2_audio_tpu.ops.flash_decode import flash_decode, flash_decode_quant
from qwen2_audio_tpu_torch.ops import flash_decode as tfd

ATOL = 2e-5    # float32, as the JAX suite's flash_decode tolerance


def _mk(rng, B, S, Hq, Hkv, d=128):
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("B,S,Hq,Hkv,pos", [
    (1, 256, 12, 2, 255),        # full cache valid
    (1, 256, 12, 2, 17),         # short prefix inside the first block
    (2, 640, 8, 4, 500),         # non-power-of-two S, partial block
    (1, 128, 4, 4, 64),          # MHA (g = 1)
    (1, 96, 28, 4, 95),          # S smaller than one block, g = 7 (7B shape)
])
def test_plain_matches_pallas(B, S, Hq, Hkv, pos):
    rng = np.random.default_rng(0)
    q, k, v = _mk(rng, B, S, Hq, Hkv)
    want = np.asarray(flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.full((B,), pos, jnp.int32),
                                   sm_scale=128 ** -0.5, block_k=256))
    before = tfd.flash_decode.launches
    got = tfd.flash_decode(*_t(q, k, v), pos, sm_scale=128 ** -0.5)
    assert tfd.flash_decode.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=ATOL)


def test_per_stream_positions_and_poisoned_tail():
    """Every stream at its own depth; rows past each stream's position hold
    NaN (K) and 1e30 / NaN (V) and must not reach the output."""
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv = 4, 384, 8, 2
    q, k, v = _mk(rng, B, S, Hq, Hkv)
    pos = np.array([3, 127, 128, 383], np.int32)
    want = np.asarray(flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), sm_scale=128 ** -0.5,
                                   block_k=128))
    for b, p in enumerate(pos):
        k[b, p + 1:] = np.nan
        v[b, p + 1:] = np.nan if b % 2 else 1e30
    got = tfd.flash_decode(*_t(q, k, v), torch.from_numpy(pos), sm_scale=128 ** -0.5)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=ATOL)


def test_quant_plain_matches_pallas():
    rng = np.random.default_rng(2)
    B, S, Hq, Hkv = 2, 320, 14, 2
    q, k, v = _mk(rng, B, S, Hq, Hkv)
    k_q, k_s = (np.asarray(a) for a in _quantize_kv(jnp.asarray(k)))
    v_q, v_s = (np.asarray(a) for a in _quantize_kv(jnp.asarray(v)))
    pos = np.array([100, 319], np.int32)
    want = np.asarray(flash_decode_quant(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(pos), sm_scale=128 ** -0.5, block_k=128))
    k_s, v_s = k_s.copy(), v_s.copy()
    k_s[0, 101:] = np.nan             # scales past the position are never used
    v_s[0, 101:] = np.nan
    before = tfd.flash_decode_quant.launches
    got = tfd.flash_decode_quant(*_t(q, k_q, k_s, v_q, v_s), torch.from_numpy(pos),
                                 sm_scale=128 ** -0.5)
    assert tfd.flash_decode_quant.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=ATOL)


def test_bf16_plain_matches_pallas():
    rng = np.random.default_rng(4)
    B, S, Hq, Hkv = 1, 256, 12, 2
    q, k, v = _mk(rng, B, S, Hq, Hkv)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_decode(jq, jk, jv, jnp.full((B,), 200, jnp.int32),
                                   sm_scale=128 ** -0.5), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tfd.flash_decode(tq, tk, tv, 200, sm_scale=128 ** -0.5)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of outputs of O(0.1), plus p's rounding against another max
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-3)


def test_wrapper_rejects_bad_input():
    q = torch.zeros(1, 8, 128)
    k = torch.zeros(1, 16, 2, 128)
    with pytest.raises(ValueError):
        tfd.flash_decode(q, k, torch.zeros(1, 16, 3, 128), 3, sm_scale=1.0)
    with pytest.raises(ValueError):
        tfd.flash_decode(torch.zeros(1, 7, 128), k, k, 3, sm_scale=1.0)
    with pytest.raises(ValueError):
        tfd.flash_decode_quant(q, k.to(torch.int8), torch.zeros(1, 16, 3),
                               k.to(torch.int8), torch.zeros(1, 16, 2), 3, sm_scale=1.0)
    m = torch.empty(1, 8, 128, device="meta")
    with pytest.raises(ValueError):
        tfd.flash_decode(m, k.to("meta"), k.to("meta"), 3, sm_scale=1.0)


def _decode_chunked(q, k, v, pos, scale, k_s=None, v_s=None, fault=None, chunk=64):
    """The decode kernel's arithmetic in plain PyTorch: keys of each stream
    in chunks of 64 up to its position, running max and sum in float32, the
    int8 V scales multiplied into p, p cast to q's type for P V. ``fault``
    plants a bug."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(B, Hq, d)
    for b in range(B):
        last = int(pos[b])
        qg = q[b].float().unflatten(0, (Hkv, Hq // Hkv))             # (Hkv, g, d)
        m = torch.full((Hkv, Hq // Hkv, 1), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(qg.shape)
        starts = list(range(0, last + 1, chunk))
        if fault == "drop_chunk":
            starts = starts[1:]
        for k0 in starts:
            end = min(S if fault == "read_past_pos" else last + 1, k0 + chunk)
            kc, vc = (x[b, k0:end].to(q.dtype).float().transpose(0, 1) for x in (k, v))
            s = qg @ kc.transpose(-1, -2) * scale
            if k_s is not None:
                s = s * k_s[b, k0:end].float().T[:, None, :]
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - mn)
            p = torch.exp(s - mn)
            l = l * alpha + p.sum(-1, keepdim=True)
            if v_s is not None and fault != "no_v_scale":
                p = p * v_s[b, k0:end].float().T[:, None, :]
            acc = acc * alpha + p.to(q.dtype).float() @ vc
            m = mn
        out[b] = (acc / torch.where(l == 0, torch.ones_like(l), l)).flatten(0, 1)
    return out.to(q.dtype)


_SPREAD = [17, 63, 64, 783]   # first chunk, both sides of a chunk edge, S - 1
_FAULT_CASES = [  # (B, S, positions, the least reading of a planted fault)
    (1, 784, [783], 10.0), (4, 784, _SPREAD, 10.0),
    # one dropped chunk of 128 carries under 1% of the weight
    (1, 8192, [8191], 5.0),
]


_FAULTS = [(cache, case, fault)
           for cache in ("bfloat16", "int8")
           for case, (_, S, pos, _) in enumerate(_FAULT_CASES)
           for fault in (None, "drop_chunk", "no_rescale", "no_v_scale", "read_past_pos")
           if not (fault == "no_v_scale" and cache != "int8")
           and not (fault == "read_past_pos" and min(pos) == S - 1)]


@pytest.mark.parametrize("cache,case,fault", _FAULTS, ids=[
    f"{c}-B{_FAULT_CASES[i][0]}_S{_FAULT_CASES[i][1]}-{f}" for c, i, f in _FAULTS])
def test_bf16_decode_tolerance_separates_faults(cache, case, fault):
    """chip_smoke's bf16 tolerance for the decode kernels, at its shapes and
    over its NaN-poisoned caches, admits the kernel's sound chunked
    arithmetic and rejects planted faults: a dropped 64-key chunk, a missing
    rescale, a missing V scale (int8), a read past the position."""
    import chip_smoke
    B, S, pos, least = _FAULT_CASES[case]
    quant = cache == "int8"
    q, c, posv = chip_smoke._decode_case("cpu", torch.bfloat16, getattr(torch, cache),
                                         B, S, pos, seed=50)
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    want = plain(q, *c, posv, sm_scale=128 ** -0.5).float()
    atol, rtol = chip_smoke.ATTN_TOL["bfloat16"]
    k, v = (c[0], c[2]) if quant else c
    scales = dict(k_s=c[1], v_s=c[3]) if quant else {}
    got = _decode_chunked(q, k, v, posv, 128 ** -0.5, fault=fault, **scales).float()
    used = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
    if fault is None:
        assert bool(torch.isfinite(got).all()) and used <= 1.0
    else:   # chip_smoke fails a kernel whose output is not finite
        assert not bool(torch.isfinite(got).all()) or used >= least
