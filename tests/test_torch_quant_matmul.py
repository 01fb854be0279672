"""The port's dequantizing matmul entries and its linear dispatch against
their JAX namesakes (Pallas kernels in interpret mode on the CPU), on the
same ggml blocks and activations.

Tolerances: exact mode, float32: rtol 1e-5 / atol 1e-5 (the order of the
float32 sums differs); ``fast`` mode, bf16 out: atol 2e-2 (both round x and
the dequantized weight to bf16 once; the outputs are O(1) bf16 values whose
last rounding may fall either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.ops import quant_matmul as jqm
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
MS = [1, 5, 40]
K, N, L = 512, 128, 3
EXACT = dict(rtol=1e-5, atol=1e-5)
FAST_ATOL = 2e-2


def _np(a):
    return np.asarray(a, np.float32)


def _weight(fmt, seed=0, form=None, k=K, n=N):
    """One quantized (k, n) weight as (JAX dict, port dict)."""
    w = (0.05 * np.random.default_rng(seed).standard_normal((k, n))).astype(np.float32)
    host = jq.quantize_array_for_device(w, JType[fmt], to_device=False,
                                        form=form or jq.Q4Form(scale="f16"))
    return {k_: jnp.asarray(v) for k_, v in host.items()}, quant_params_from_jax(host)


def _stacked(fmt, form=None):
    pairs = [_weight(fmt, seed=10 + i, form=form) for i in range(L)]
    jw = {k_: jnp.stack([p[0][k_] for p in pairs]) for k_ in pairs[0][0]}
    tw = {k_: torch.stack([p[1][k_] for p in pairs]) for k_ in pairs[0][1]}
    return jw, tw


def _x(m, dtype, seed=0, k=K):
    x = np.random.default_rng(100 + seed).standard_normal((m, k)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jx, tx


def _close(got, want, fast):
    assert tuple(got.shape) == tuple(want.shape)
    if fast:
        np.testing.assert_allclose(got.float().numpy(), _np(want), atol=FAST_ATOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), _np(want), **EXACT)


@pytest.fixture(autouse=True)
def _modes():
    yield
    jl.set_group_matmul_mode(None)
    tl.set_group_matmul_mode(None)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fmt", ["Q8_0", "Q5_0", "Q5_1", "Q6_K", "Q3_K"])
def test_quant_matmul_exact(fmt, m):
    jw, tw = _weight(fmt)
    jx, tx = _x(m, "f32")
    got = tqm.quant_matmul(tx, tw["qs"], tw["scales"])
    assert got.dtype == torch.float32
    _close(got, jqm.quant_matmul(jx, jw["qs"], jw["scales"]), fast=False)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fmt", ["Q8_0", "Q2_K"])
def test_quant_matmul_fast_bf16(fmt, m):
    jw, tw = _weight(fmt)
    jx, tx = _x(m, "bf16")
    got = tqm.quant_matmul(tx, tw["qs"], tw["scales"], fast=True)
    assert got.dtype == torch.bfloat16
    _close(got, jqm.quant_matmul(jx, jw["qs"], jw["scales"], fast=True), fast=True)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fast", [False, True])
def test_quant_matmul_stacked(fast, m):
    jw, tw = _stacked("Q8_0")
    jx, tx = _x(m, "bf16" if fast else "f32")
    for li in (0, L - 1):
        got = tqm.quant_matmul_stacked(tx, tw["qs"], tw["scales"], li, fast=fast)
        want = jqm.quant_matmul_stacked(jx, jw["qs"], jw["scales"], jnp.int32(li), fast=fast)
        _close(got, want, fast)
    # the layer is read in place and picks that layer's weight
    assert torch.equal(tqm.quant_matmul_stacked(tx, tw["qs"], tw["scales"], 1, fast=fast),
                       tqm.quant_matmul(tx, tw["qs"][1], tw["scales"][1], fast=fast))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fmt,off", [("Q4_0", 8), ("Q4_1", 0), ("Q4_K", 0)])
def test_quant_matmul4_exact(fmt, off, m):
    jw, tw = _weight(fmt)
    assert ("mins" in tw) == (off == 0)
    jx, tx = _x(m, "f32")
    got = tqm.quant_matmul4(tx, tw["qs4"], tw["scales"], off=off)
    _close(got, jqm.quant_matmul4(jx, jw["qs4"], jw["scales"], off=off), fast=False)


@pytest.mark.parametrize("m", MS)
def test_quant_matmul4_fast_bf16(m):
    jw, tw = _weight("Q4_0")
    jx, tx = _x(m, "bf16")
    got = tqm.quant_matmul4(tx, tw["qs4"], tw["scales"], fast=True, off=8)
    assert got.dtype == torch.bfloat16
    _close(got, jqm.quant_matmul4(jx, jw["qs4"], jw["scales"], fast=True, off=8), fast=True)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("fast", [False, True])
def test_quant_matmul4_stacked(fast, m):
    jw, tw = _stacked("Q4_0")
    jx, tx = _x(m, "bf16" if fast else "f32")
    for li in (0, L - 1):
        got = tqm.quant_matmul4_stacked(tx, tw["qs4"], tw["scales"], li, fast=fast, off=8)
        want = jqm.quant_matmul4_stacked(jx, jw["qs4"], jw["scales"], jnp.int32(li),
                                         fast=fast, off=8)
        _close(got, want, fast)


def test_nibble_order_with_distinct_values():
    """A weight whose 32 values of a group are all distinct multiples of the
    scale: a wrong nibble pairing permutes them and changes x @ w."""
    k, n = 256, 128
    vals = np.tile(np.arange(32) % 16, k // 32)[:, None] + np.zeros((1, n), np.int64)
    vals[16::32] = 15                      # make value 16 of each group differ from 0
    vals = (vals + np.arange(n)[None, :]) % 16          # (k, n) nibbles 0..15
    g = vals.reshape(k // 32, 32, n)
    qs4 = (g[:, :16] | (g[:, 16:] << 4)).reshape(k // 2, n).astype(np.uint8)
    scales = np.full((k // 32, n), 0.25, np.float16)
    x = np.random.default_rng(5).standard_normal((5, k)).astype(np.float32)
    want_dense = x @ ((vals - 8) * 0.25).astype(np.float32)
    got = tqm.quant_matmul4(torch.from_numpy(x), torch.from_numpy(qs4),
                            torch.from_numpy(scales), off=8)
    np.testing.assert_allclose(got.numpy(), want_dense, rtol=1e-5, atol=1e-4)
    want = jqm.quant_matmul4(jnp.asarray(x), jnp.asarray(qs4), jnp.asarray(scales), off=8)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)
    assert np.array_equal(tqm.unpack4(torch.from_numpy(qs4)).numpy(), vals)


def test_int8_minus_128():
    """-128 occurs in ggml files: no abs, no negation in int8."""
    k, n = 256, 128
    qs = np.full((k, n), -128, np.int8)
    qs[::3] = 127
    scales = np.full((k // 32, n), 2.0 ** -7, np.float16)
    x = np.ones((1, k), np.float32)
    got = tqm.quant_matmul(torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(scales))
    want = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(qs), jnp.asarray(scales))
    assert np.array_equal(got.numpy(), _np(want))
    assert float(got[0, 0]) == float(qs[:, 0].astype(np.float64).sum() * 2.0 ** -7)
    assert float(tqm.dequantize_weight({"qs": torch.from_numpy(qs),
                                        "scales": torch.from_numpy(scales)}).min()) == -1.0


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_linear_all_formats(fmt, rng):
    """Every format reaches quant_linear (mins added outside the kernel),
    batched activations."""
    jw, tw = _weight(fmt, seed=3)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    got = tqm.quant_linear(torch.from_numpy(x), tw)
    want = jqm.quant_linear(jnp.asarray(x), jw)
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=2e-5)
    dense = torch.from_numpy(x) @ tqm.dequantize_weight(tw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sym", [True, False])
def test_quant_linear4_sym_and_mins(sym, rng):
    jw, tw = _weight("Q4_0", seed=4, form=jq.Q4Form(sym=sym, scale="f16"))
    assert ("mins" in tw) == (not sym)
    x = rng.standard_normal((5, K)).astype(np.float32)
    got = tqm.quant_linear4(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), _np(jqm.quant_linear4(jnp.asarray(x), jw)),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1", "Q5_1", "Q6_K"])
def test_quant_linear_stacked(fmt, rng):
    jw, tw = _stacked(fmt)
    x = rng.standard_normal((1, 5, K)).astype(np.float32)
    for li in range(L):
        got = tqm.quant_linear_stacked(torch.from_numpy(x), tw, li)
        want = jqm.quant_linear_stacked(jnp.asarray(x), jw, jnp.int32(li))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["dequant", "bf16"])
@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_K", "Q3_K"])
def test_linear_dispatch(fmt, mode, rng):
    jl.set_group_matmul_mode(mode)
    tl.set_group_matmul_mode(mode)
    assert tl.group_matmul_mode() == mode
    jw, tw = _weight(fmt, seed=6)
    b = rng.standard_normal(N).astype(np.float32)
    jw["b"], tw["b"] = jnp.asarray(b), torch.from_numpy(b)
    fast = mode == "bf16"
    jx, tx = _x(5, "bf16" if fast else "f32", seed=6)
    got = tl.linear(tx, tw)
    want = jl.linear(jx, jw)
    if fast:
        np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2 * FAST_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["dequant", "bf16"])
@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q5_1"])
def test_linear_at_dispatch(fmt, mode, rng):
    jl.set_group_matmul_mode(mode)
    tl.set_group_matmul_mode(mode)
    jw, tw = _stacked(fmt)
    b = rng.standard_normal((L, N)).astype(np.float32)
    jw["b"], tw["b"] = jnp.asarray(b), torch.from_numpy(b)
    fast = mode == "bf16"
    jx, tx = _x(5, "bf16" if fast else "f32", seed=7)
    for li in (0, 2):
        got = tl.linear_at(tx, tw, li)
        want = jl.linear_at(jx, jw, jnp.int32(li))
        if fast:
            np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2 * FAST_ATOL)
        else:
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=2e-5)


def test_linear_dense_and_default_mode(rng):
    assert tl.group_matmul_mode() == "bf16"
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    x = rng.standard_normal((2, 16)).astype(np.float32)
    got = tl.linear_at(torch.from_numpy(x), {"w": torch.from_numpy(w),
                                             "b": torch.from_numpy(b)}, 1)
    want = jl.linear_at(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        jnp.int32(1))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    got = tl.linear(torch.from_numpy(x), {"w": torch.from_numpy(w[0])})
    np.testing.assert_allclose(got.numpy(), x @ w[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["qs_p", "qs4_p", "qs4b", "qs8"])
def test_unported_forms_raise(key):
    """The per-channel form raises; the panel forms and the word-packed
    nibbles, refused until their kernels were ported, are now taken by
    ``linear`` and ``linear_at``: the panels give the strided result, the
    words the integer kernel's result on the same bytes (in every mode)."""
    if key == "qs8":
        p = {key: torch.zeros(1, 32, 16, dtype=torch.int8), "scales_p": torch.ones(1, 1, 16)}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.linear(torch.zeros(1, 32), p)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.linear_at(torch.zeros(1, 32), p, 0)
        return
    tl.set_group_matmul_mode("dequant")
    _, tw = _stacked("Q8_0" if key == "qs_p" else "Q4_0")
    _, tx = _x(3, "f32")
    if key == "qs4b":
        from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
        from qwen2_audio_tpu_torch.ops.quant_matmul_q4b import pack_b32
        tb = {"qs4b": pack_b32(tw["qs4"]), "scales": tw["scales"]}
        want = t8.quant_matmul_int8_stacked(tx, tw["qs4"], tw["scales"], 1, off=8)
        assert torch.equal(tl.linear_at(tx, tb, 1), want)
        assert torch.equal(tl.linear(tx, {k_: v[1] for k_, v in tb.items()}), want)
        # and close to the exact product: only x is rounded, to 8 bits a group
        dense = tl.linear_at(tx, tw, 1)
        assert float((want - dense).abs().max()) <= 0.02 * float(dense.abs().max())
        return
    tp = tqm.panelize_weight(tw, 64)
    assert key in tp and tp[key].shape[:2] == (L, N // 64)
    assert torch.equal(tl.linear_at(tx, tp, 1), tl.linear_at(tx, tw, 1))
    flat_p, flat = ({k_: v[1] for k_, v in t.items()} for t in (tp, tw))
    assert torch.equal(tl.linear(tx, flat_p), tl.linear(tx, flat))


def test_int8_mode_raises_and_bad_mode():
    """Mode "int8", refused until its kernels were ported, now takes the
    integer group matmul, as the JAX package does; unknown modes and
    non-linear dicts still raise."""
    jw, tw = _weight("Q8_0")
    jl.set_group_matmul_mode("int8")
    tl.set_group_matmul_mode("int8")
    jx, tx = _x(3, "f32", seed=8)
    want = np.asarray(jl.linear(jx, jw))
    np.testing.assert_allclose(tl.linear(tx, tw).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    st_j, st_t = {k_: v[None] for k_, v in jw.items()}, {k_: v[None] for k_, v in tw.items()}
    want = np.asarray(jl.linear_at(jx, st_j, jnp.int32(0)))
    np.testing.assert_allclose(tl.linear_at(tx, st_t, 0).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError):
        tl.set_group_matmul_mode("w8a8")
    with pytest.raises(ValueError):
        tl.linear(torch.zeros(1, K), {"b": torch.zeros(4)})


def test_wrapper_refuses_bad_shapes_and_devices():
    _, tw = _weight("Q8_0")
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(2, K + 32), tw["qs"], tw["scales"])
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(2, K), tw["qs"].to(torch.int16), tw["scales"])
    with pytest.raises(ValueError):
        tqm.quant_matmul(torch.zeros(2, K), tw["qs"], tw["scales"][:3])
    with pytest.raises(ValueError):
        tqm.quant_matmul_stacked(torch.zeros(2, K), tw["qs"], tw["scales"], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.quant_matmul(torch.zeros(2, K, device="meta"), tw["qs"].to("meta"),
                         tw["scales"].to("meta"))
    assert all(e.launches == 0 for e in tqm.ENTRIES)   # the CPU launches nothing


def test_split_k_plan():
    # decode shapes of the 7B tower on 132 SMs: a few blocks per SM, each
    # warp keeping at least two 32-row blocks of K
    for k, n in [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 156032)]:
        s = tqm.split_k(1, k, n, 132)
        tiles = -(-n // 128)
        assert 1 <= s <= k // 32 // 8
        assert s == 1 or tiles * s >= 2 * 132
    assert tqm.split_k(1, 3584, 156032, 132) == 1
    assert tqm.split_k(752, 3584, 4608, 132) == 1


def test_group_min_term_matches_jax(rng):
    x = rng.standard_normal((5, 256)).astype(np.float32)
    for group in (16, 32):
        mins = rng.standard_normal((256 // group, 24)).astype(np.float32)
        got = tqm.group_min_term(torch.from_numpy(x), torch.from_numpy(mins), group=group)
        want = jqm.group_min_term(jnp.asarray(x), jnp.asarray(mins), group=group)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
