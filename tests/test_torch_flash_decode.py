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
    """The decode kernel's arithmetic in plain PyTorch: each stream's rows
    split over CTAs as ``decode_plan`` partitions them for the main path (a
    bf16 query over a bf16 or int8 cache: the tensor-core path's split
    counts, whatever the test's types); within a split, keys in chunks of
    64, running max and sum in float32 against the split's own maximum, the
    int8 V scales multiplied into p, p cast to q's type for P V; then the
    last CTA's merge of the splits' partials: M = max m_j, L = sum l_j
    e^(m_j - M), O = sum acc_j e^(m_j - M) / L, a split with no rows
    weighing 0. Rows past a split's range are never read, so a poisoned
    tail stays out. ``fault`` plants a bug."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    cache = torch.int8 if k_s is not None else torch.bfloat16
    ranges = tfd.decode_plan(B, S, Hkv, Hq // Hkv, cache)["ranges"]
    out = torch.empty(B, Hq, d)
    for b in range(B):
        qg = q[b].float().unflatten(0, (Hkv, Hq // Hkv))             # (Hkv, g, d)
        splits = ranges(int(pos[b]))
        if fault == "edge_off_by_one":      # each split's range one row too long
            splits = [(lo, min(S, hi + 1)) if hi > lo else (lo, hi) for lo, hi in splits]
        parts = []
        for lo, hi in splits:
            m = torch.full((Hkv, Hq // Hkv, 1), -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(qg.shape)
            starts = list(range(lo, hi, chunk))
            if fault == "drop_chunk" and lo == 0:
                starts = starts[1:]
            for k0 in starts:
                end = min(S if fault == "read_past_pos" else hi, k0 + chunk)
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
            if fault == "empty_split_nan" and hi == lo:
                m = torch.full_like(m, torch.nan)
            parts.append((m, l, acc))
        if fault == "split_twice":
            parts.append(parts[0])
        if fault == "split_dropped":      # the last split that holds rows
            parts.pop(max(j for j, (lo, hi) in enumerate(splits) if hi > lo))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, O = torch.zeros_like(M), torch.zeros(qg.shape)
        for m, l, acc in parts:
            w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
            if fault == "no_merge_rescale":
                w = torch.where(m == -torch.inf, 0.0, 1.0)
            L, O = L + l * w, O + acc * w
        out[b] = (O / torch.where(L == 0, torch.ones_like(L), L)).flatten(0, 1)
    return out.to(q.dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,pos", [
    (1, 784, 28, 4, [783]),              # 13 splits of one chunk
    (4, 384, 8, 2, [3, 127, 128, 383]),  # 6 splits: one, two and six hold rows
    (1, 8192, 28, 4, [8191]),            # 16 splits of 8 chunks each
    (5, 784, 28, 4, [783] * 5),          # the beam step: 13 splits of one chunk
    (5, 784, 28, 4, [0, 63, 64, 400, 783]),
    (8, 2048, 28, 4, [783, 755, 801, 760, 790, 752, 812, 770]),   # the pool's: 8 splits
])
def test_split_arithmetic_matches_pallas(B, S, Hq, Hkv, pos):
    """The kernel's split arithmetic and merge in float32 against the JAX
    package's flash_decode and flash_decode_quant (Pallas interpret mode),
    inputs from a numpy seed; the emulation's cache holds NaN (K, V, int8
    scales) and junk int8 values past each stream's position, the JAX
    kernels' the clean values."""
    rng = np.random.default_rng(5)
    q, k, v = _mk(rng, B, S, Hq, Hkv)
    posv = np.array(pos, np.int32)
    past = np.arange(S)[None, :] > posv[:, None]          # (B, S)
    want = np.asarray(flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(posv), sm_scale=128 ** -0.5, block_k=128))
    kp, vp = k.copy(), v.copy()
    kp[past], vp[past] = np.nan, np.nan
    got = _decode_chunked(*_t(q, kp, vp), posv, 128 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=ATOL)
    k_q, k_s = (np.asarray(a) for a in _quantize_kv(jnp.asarray(k)))
    v_q, v_s = (np.asarray(a) for a in _quantize_kv(jnp.asarray(v)))
    want = np.asarray(flash_decode_quant(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(posv), sm_scale=128 ** -0.5, block_k=128))
    k_q, k_s, v_q, v_s = (a.copy() for a in (k_q, k_s, v_q, v_s))
    k_q[past], v_q[past] = 127, -128
    k_s[past], v_s[past] = np.nan, np.nan
    tq, tkq, tks, tvq, tvs = _t(q, k_q, k_s, v_q, v_s)
    got = _decode_chunked(tq, tkq, tvq, posv, 128 ** -0.5, k_s=tks, v_s=tvs)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=ATOL)


_SPREAD = [17, 63, 64, 783]   # one split, one full split, a second split of one row, S - 1
_FAULT_CASES = [  # (B, S, positions, the least reading of a planted fault)
    (1, 784, [783], 10.0), (4, 784, _SPREAD, 10.0),
    # one dropped chunk of 128 carries under 1% of the weight
    (1, 8192, [8191], 5.0),
    # a range-edge case, with chip_smoke's p-rounding term for few rows
    (4, 2048, [0, 64, 1024, 2047], 10.0),
]
_SPLIT_FAULTS = ("no_merge_rescale", "split_twice", "split_dropped", "empty_split_nan",
                 "edge_off_by_one")


def _applies(fault, B, S, pos) -> bool:
    """Whether a planted fault changes anything at this case: a missing
    rescale within a split needs a split of two chunks, an empty split's
    NaN an empty split, a read past pos (or past a range's end, for the
    last split) a row there."""
    splits = tfd.decode_plan(B, S, 4, 7, torch.bfloat16)["splits"]
    ranges = [tfd.split_ranges(p, S, splits) for p in pos]
    if fault == "no_rescale":
        return any(hi - lo > 64 for r in ranges for lo, hi in r)
    if fault == "empty_split_nan":
        return any(hi == lo for r in ranges for lo, hi in r)
    if fault in ("read_past_pos", "edge_off_by_one"):
        return min(pos) < S - 1
    return True


_FAULTS = [(cache, case, fault)
           for cache in ("bfloat16", "int8")
           for case, (B, S, pos, _) in enumerate(_FAULT_CASES)
           for fault in (None, "drop_chunk", "no_rescale", "no_v_scale", "read_past_pos",
                         *_SPLIT_FAULTS)
           if not (fault == "no_v_scale" and cache != "int8")
           and (fault is None or _applies(fault, B, S, pos))]


@pytest.mark.parametrize("cache,case,fault", _FAULTS, ids=[
    f"{c}-B{_FAULT_CASES[i][0]}_S{_FAULT_CASES[i][1]}-{f}" for c, i, f in _FAULTS])
def test_bf16_decode_tolerance_separates_faults(cache, case, fault):
    """chip_smoke's bf16 tolerance for the decode kernels, at its shapes and
    over its NaN-poisoned caches, admits the kernel's sound split
    arithmetic and rejects planted faults: a dropped 64-key chunk, a missing
    rescale within a split, a missing V scale (int8), a read past the
    position; in the merge, a missing e^(m_j - M) rescale, a split counted
    twice, a split dropped, an empty split's -inf turned into NaN; a range
    edge off by one."""
    import chip_smoke
    B, S, pos, least = _FAULT_CASES[case]
    quant = cache == "int8"
    q, c, posv = chip_smoke._decode_case("cpu", torch.bfloat16, getattr(torch, cache),
                                         B, S, pos, seed=50)
    plain = tfd.flash_decode_quant_plain if quant else tfd.flash_decode_plain
    want = plain(q, *c, posv, sm_scale=128 ** -0.5).float()
    atol, rtol = chip_smoke.ATTN_TOL["bfloat16"]
    tol = atol + rtol * want.abs()
    if (torch.bfloat16, getattr(torch, cache), B, S, pos) in chip_smoke._decode_edge_cases():
        tol = tol + chip_smoke.P_ROUND * chip_smoke.decode_p_abs_v(plain, q, c, posv,
                                                                   128 ** -0.5)
    k, v = (c[0], c[2]) if quant else c
    scales = dict(k_s=c[1], v_s=c[3]) if quant else {}
    got = _decode_chunked(q, k, v, posv, 128 ** -0.5, fault=fault, **scales).float()
    used = ((got - want).abs() / tol).max().item()
    if fault is None:
        assert bool(torch.isfinite(got).all()) and used <= 1.0
    else:   # chip_smoke fails a kernel whose output is not finite
        assert not bool(torch.isfinite(got).all()) or used >= least


@pytest.mark.parametrize("T,pos", [(1, [5, 779]), (752, [0, 40])])
def test_kv_append_quant_plain_matches_jax_cache_update(T, pos):
    """Part of every int8-cache forward: the plain route (the wrapper's on
    the CPU) equals the JAX package's _quantize_kv plus its per-stream cache
    update (models/qwen2_decoder.py, the vector-position scatter) bit for
    bit, B 2 at different positions, rows past the capacity dropped."""
    rng = np.random.default_rng(T)
    B, S, H, d = 2, 780, 4, 128
    k = (rng.standard_normal((B, T, H, d)) * rng.uniform(0.01, 10, (B, T, H, 1))).astype(np.float32)
    v = (rng.standard_normal((B, T, H, d)) * 3).astype(np.float32)
    k[0, 0, 0] = 0.0                                  # a zero vector: scale 0, values 0
    posv = np.array(pos, np.int32)
    bidx = jnp.arange(B)[:, None]
    rows = jnp.asarray(posv)[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
    want = []
    for x in (k, v):
        xq, xs = _quantize_kv(jnp.asarray(x))
        cq = jnp.full((B, S, H, d), -3, jnp.int8).at[bidx, rows].set(xq, mode="drop")
        cs = jnp.full((B, S, H), 0.5, jnp.float32).at[bidx, rows].set(xs, mode="drop")
        want += [np.asarray(cq), np.asarray(cs)]
    got = [torch.full((B, S, H, d), -3, dtype=torch.int8), torch.full((B, S, H), 0.5)]
    got += [t.clone() for t in got]
    before = tfd.kv_append_quant.launches
    tfd.kv_append_quant(torch.from_numpy(k), torch.from_numpy(v), *got, torch.from_numpy(posv))
    assert tfd.kv_append_quant.launches == before   # CPU: the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
