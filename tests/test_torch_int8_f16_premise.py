"""The premise of the exact-integer group matmul's M > 8 tile
(csrc/quant_matmul_int8.cu): every operand of a 32-group's integer dot is
exact in float16, and an f16 product with a float32 sum, zeroed for the
group and taken as two k16 steps, gives the exact integer dot at every
partial sum, whatever the order of K inside the group. So the tile's p is
the integer dot the plain version (and ggml's mmq) takes, and its output is
that of ``group_matmul_plain``'s arithmetic.

Emulated here on the CPU in numpy: float16 values, float32 products (exact:
11 x 11 significant bits) and float32 partial sums, in the kernel's order
of K inside a group (``_kernel_order``, the words form's words_k) and in
plain order, sequentially and pairwise. The magic-exponent conversions the tile
uses (0x6400 | u is the f16 1024 + u, then one f16 add or fma removes the
bias) are emulated in float16 arithmetic. Random blocks of all three weight
forms go through the emulation and through the JAX package's kernels
(Pallas interpret mode), held to test_torch_quant_matmul_int8's tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.ops import quant_matmul_int8 as j8
from qwen2_audio_tpu.ops import quant_matmul_q4b as jb
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb

GROUP = 32
REL = 1e-6          # of max|ref|, float32 x (as test_torch_quant_matmul_int8)


def _kernel_order():
    """K inside a group as the tile's products take it for the words form
    (the other forms keep K's order): slot 16 s + 8 h + 2 t4 + b of k16
    step s holds value 16 s + 4 t4 + 2 h + b, the kernel's words_k."""
    order = np.empty(GROUP, np.int64)
    order[t8.words_k(np.arange(GROUP))] = np.arange(GROUP)
    return order


def _magic(u):
    """float16 1024 + u from the bits 0x6400 | u, u a byte."""
    return (np.uint16(0x6400) | u.astype(np.uint16)).view(np.float16)


def _f16_values(form, raw):
    """The tile's float16 values from raw bytes (uint8): int8 values (v ^
    0x80 under the magic exponent, - 1152), or the low and high nibbles
    (off 0 or 8: 1024 + n - (1024 + off); 1024 + 16 n, * 1/16 - (64 + off))."""
    if form == "int8":
        return (_magic(raw ^ np.uint8(0x80)) + np.float16(-1152.0)).astype(np.float16)
    off = int(form.split()[-1])
    lo = (_magic(raw & np.uint8(0x0F)) + np.float16(-(1024 + off))).astype(np.float16)
    hi = np.float16(_magic(raw & np.uint8(0xF0)) * np.float16(1 / 16)
                    + np.float16(-(64 + off)))
    return lo, hi


@pytest.mark.parametrize("form", ["int8", "nibbles off 0", "nibbles off 8", "xq"])
def test_every_operand_is_exact_in_f16(form):
    """All values a form can hold survive the cast to float16 and back, and
    the tile's magic-exponent conversion of every byte gives them exactly."""
    raw = np.arange(256, dtype=np.uint8)
    if form == "xq":
        v = np.arange(-127, 128)
        assert np.array_equal(v.astype(np.float16).astype(np.int64), v)
        assert np.array_equal(_f16_values("int8", (v & 0xFF).astype(np.uint8)), v)
        return
    if form == "int8":
        v = raw.view(np.int8).astype(np.int64)
        assert np.array_equal(v.astype(np.float16).astype(np.int64), v)
        assert np.array_equal(_f16_values(form, raw).astype(np.int64), v)
        return
    off = int(form.split()[-1])
    lo, hi = _f16_values(form, raw)
    assert np.array_equal(lo.astype(np.int64), (raw & 0x0F).astype(np.int64) - off)
    assert np.array_equal(hi.astype(np.int64), (raw >> 4).astype(np.int64) - off)
    v = np.arange(-8, 16)
    assert np.array_equal(v.astype(np.float16).astype(np.int64), v)


def _partials(xq, v, order, pairwise):
    """Every float32 partial sum of the group's dot in ``order``, as two
    k16 steps (zeroed, then added to): sequential, or each step's 16
    products summed pairwise first."""
    prod = (xq[order].astype(np.float16).astype(np.float32)
            * v[order].astype(np.float16).astype(np.float32))
    out, acc = [], np.float32(0)
    for s in range(2):
        step = prod[16 * s:16 * s + 16]
        if pairwise:
            while len(step) > 1:
                step = (step[0::2] + step[1::2]).astype(np.float32)
                out.extend(step.tolist())
            acc = np.float32(acc + step[0])
        else:
            for p in step:
                acc = np.float32(acc + p)
                out.append(float(acc))
        out.append(float(acc))
    return acc, out


@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("order", ["kernel", "plain", "reversed"])
@pytest.mark.parametrize("case", ["int8 -128", "int8 127", "nibbles 15", "nibbles -8",
                                  "alternating", "random"])
def test_two_k16_steps_are_exact_at_every_partial_sum(case, order, pairwise):
    """The largest dots (|xq| 127 against -128, 127, 15 or -8 everywhere:
    32 x 127 x 128 = 520192 < 2^24), alternating signs and random groups:
    every float32 partial sum is an integer equal to the exact int64 one,
    and the group's dot equals ``group_matmul_plain``'s."""
    rng = np.random.default_rng(len(case))
    xq = np.full(GROUP, 127, np.int64)
    v = {"int8 -128": np.full(GROUP, -128), "int8 127": np.full(GROUP, 127),
         "nibbles 15": np.full(GROUP, 15), "nibbles -8": np.full(GROUP, -8),
         "alternating": np.where(np.arange(GROUP) % 2, -128, 127),
         "random": rng.integers(-128, 128, GROUP)}[case].astype(np.int64)
    if case == "alternating":
        xq = np.where(np.arange(GROUP) % 3, 127, -127)
    if case == "random":
        xq = rng.integers(-127, 128, GROUP)
        xq[0] = 127                      # sx = 1 below: x quantizes to itself
    k = {"kernel": _kernel_order(), "plain": np.arange(GROUP),
         "reversed": np.arange(GROUP)[::-1].copy()}[order]
    p, parts = _partials(xq, v, k, pairwise)
    exact = int(np.dot(xq, v))
    assert p == np.float32(exact) and abs(exact) < 2 ** 24
    assert all(float(q).is_integer() and abs(q) < 2 ** 24 for q in parts)
    if not pairwise:
        steps = np.cumsum((xq[k] * v[k])[:16]).tolist() + np.cumsum(xq[k] * v[k]).tolist()[16:]
        assert parts[:16] == [float(q) for q in steps[:16]]
    # the plain version's dot of the same group: one row, one column, and
    # sx = sw = 1 (the row's largest |x| is 127)
    x = torch.from_numpy(xq.astype(np.float32))[None]
    want = t8.group_matmul_plain(x, torch.from_numpy(v.astype(np.int8))[:, None],
                                 torch.ones(1, 1))
    assert float(want[0, 0]) == exact


def _emulate(xq, sx, values, scales):
    """The tile's arithmetic for a whole matmul: each group's dot from f16
    products in the kernel's order as two k16 steps, then the groups in
    order into float32 as c = fma(p, sx * sw, c) (float64 for the exact
    product and sum, rounded once)."""
    M, K = xq.shape
    N = values.shape[1]
    order = _kernel_order()
    acc = np.zeros((M, N), np.float32)
    for g in range(K // GROUP):
        k = g * GROUP + order
        prod = (xq[:, k].astype(np.float16).astype(np.float32)[:, :, None]
                * values[k].astype(np.float16).astype(np.float32)[None])
        p = (prod[:, :16].sum(1, dtype=np.float32) + prod[:, 16:].sum(1, dtype=np.float32))
        exact = xq[:, g * GROUP:(g + 1) * GROUP].astype(np.int64) @ values[
            g * GROUP:(g + 1) * GROUP].astype(np.int64)
        assert np.array_equal(p.astype(np.int64), exact)      # exact, as the premise says
        s = (sx[:, g:g + 1] * scales[g:g + 1].astype(np.float32)).astype(np.float32)
        acc = (p.astype(np.float64) * s + acc).astype(np.float32)
    return acc


@pytest.mark.parametrize("form", ["int8", "nibbles off 0", "nibbles off 8", "words"])
@pytest.mark.parametrize("m", [9, 40])
def test_emulated_tile_matches_jax(form, m):
    """Random blocks through the emulated tile and through the JAX kernels
    (float32 x): within REL of max|ref|, where x's q8_1 bits agree."""
    K, N = 256, 96
    rng = np.random.default_rng(31 + m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    sc = (0.01 + 0.05 * rng.random((K // GROUP, N))).astype(np.float16)
    xq, sx = (a.numpy() for a in t8.quantize_activations(torch.from_numpy(x)))
    jxq = np.asarray(j8.quantize_activations(jnp.asarray(x))[0])
    assert np.array_equal(jxq, xq)
    if form == "int8":
        qs = rng.integers(-128, 128, (1, K, N)).astype(np.int8)
        values = qs[0].astype(np.int64)
        ref = j8.quant_matmul_int8_stacked(jnp.asarray(x), jnp.asarray(qs), jnp.asarray(sc[None]),
                                           jnp.int32(0))
    else:
        qs4 = rng.integers(0, 256, (1, K // 2, N)).astype(np.uint8)
        off = 8 if form == "words" else int(form.split()[-1])
        values = tqm.unpack4(torch.from_numpy(qs4[0])).numpy().astype(np.int64) - off
        if form == "words":
            words = tb.pack_b32(qs4)
            ref = jb.quant_matmul_q4b_stacked(jnp.asarray(x), jnp.asarray(words),
                                              jnp.asarray(sc[None]), jnp.int32(0))
            # the words are the same nibbles, low nibbles first
            assert np.array_equal(tb.unpack_b32(words)[0], qs4[0])
        else:
            ref = j8.quant_matmul_int8_stacked(jnp.asarray(x), jnp.asarray(qs4),
                                               jnp.asarray(sc[None]), jnp.int32(0), off=off)
    got = _emulate(xq, sx, values, sc)
    want = np.asarray(ref, np.float32)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    plain = t8.group_matmul_plain(torch.from_numpy(x), torch.from_numpy(values),
                                  torch.from_numpy(sc)).numpy()
    assert np.abs(got - plain).max() <= REL * np.abs(plain).max()
