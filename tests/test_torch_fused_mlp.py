"""The port's one-launch SwiGLU MLP (ops/fused_mlp.py, ops/linear.py
``fused_mlp_at`` / ``fused_mlp_split_at``) against its JAX namesakes (the
Pallas kernel in interpret mode on the CPU), on the same ggml blocks and
activations, and against the port's own two-launch path.

Tolerances against JAX: both sides round at the same places, so only the
order of the float32 sums differs: 1e-5 * max|ref| in exact mode with
float32 x, 1e-4 * max|ref| in ``fast`` mode, plus one bf16 ulp
(2^-7 * |ref| + 2^-8 * max|ref|) where the output is bf16. In ``fast`` mode
the order of g's and u's sums can also move a gated value across a bf16
rounding boundary (seen at M = 64: one of 24576 values, 3.6e-4 of max|ref|);
two such flips are allowed for per output, each bounded by
``gated_rounding_bound`` (2^-8 * max|gated| of the row * max|Wd|). Against the
two-launch path: the JAX suite's own bounds for that comparison, 1e-4 of
max|ref| in exact mode and 0.03 in ``fast`` mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.ops import fused_mlp as jfm
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm

K, I, L = 256, 384, 2
# format -> (kind, the entry of that name in both packages, leaf order)
KINDS = {
    "Q8_0": ("strided", "fused_mlp_stacked", ("qs", "scales")),
    "Q6_K": ("strided", "fused_mlp_stacked", ("qs", "scales")),          # group 16
    "Q5_1": ("strided_m", "fused_mlp_m_stacked", ("qs", "scales", "mins")),
    "Q4_0": ("packed", "fused_mlp4_sym_stacked", ("qs4", "scales")),
    "Q4_1": ("packed_m", "fused_mlp4_stacked", ("qs4", "scales", "mins")),
}
MODES = [(False, "f32"), (True, "f32"), (True, "bf16"), (False, "bf16")]


@pytest.fixture(autouse=True)
def _modes():
    yield
    jl.set_group_matmul_mode(None)
    tl.set_group_matmul_mode(None)
    tl.set_fused_mlp(None)


def _quantize(w, fmt):
    return jq.quantize_array_for_device(w, JType[fmt], to_device=False,
                                        form=jq.Q4Form(scale="f16"))


@functools.lru_cache(maxsize=None)
def _mlp(fmt, k=K, i=I, split=False, seed=0):
    """Stacked MLP weights of ``L`` layers as (JAX dicts, port dicts), each a
    list [gate_up, down] or, split, [gate, up, down]."""
    rng = np.random.default_rng(seed)
    shapes = [(k, i), (k, i), (i, k)] if split else [(k, 2 * i), (i, k)]
    jws, tws = [], []
    for shape in shapes:
        per = [_quantize((0.1 * rng.standard_normal(shape)).astype(np.float32), fmt)
               for _ in range(L)]
        host = {leaf: np.stack([d[leaf] for d in per]) for leaf in per[0]}
        jws.append({leaf: jnp.asarray(v) for leaf, v in host.items()})
        tws.append(quant_params_from_jax(host))
    return jws, tws


def _x(m, dtype, k=K, seed=0):
    x = np.random.default_rng(100 + seed).standard_normal((m, k)).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32))


FLIPS = 2     # bf16 roundings of gated that may fall the other way, per output


def _leaves(ws, order, li):
    """(gate, up, down) leaf tuples of layer ``li`` from port dicts [gate_up,
    down] or [gate, up, down]."""
    if len(ws) == 2:
        half = ws[0][order[0]].shape[-1] // 2
        return (tuple(ws[0][k][li][:, :half] for k in order),
                tuple(ws[0][k][li][:, half:] for k in order),
                tuple(ws[1][k][li] for k in order))
    return tuple(tuple(w[k][li] for k in order) for w in ws)


def _held(got, want, fast, dtype, tx=None, leaves=None):
    """``leaves``: the port's (gate, up, down) leaf tuples, for the gated
    rounding term of ``fast`` mode."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    tol = (1e-4 if fast else 1e-5) * top
    if dtype == "bf16":
        tol = tol + 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * top
    if fast:
        tol = tol + FLIPS * tfm.gated_rounding_bound(
            tx, *leaves, packed=leaves[0][0].dtype == torch.uint8).numpy()
    assert (np.abs(got - want) <= tol).all(), (np.abs(got - want).max(), top)


@pytest.mark.parametrize("m", [1, 7, 9, 16, 33, 64])
@pytest.mark.parametrize("fast,dtype", MODES)
@pytest.mark.parametrize("fmt", list(KINDS))
def test_fused_entry_matches_jax(fmt, fast, dtype, m):
    _, name, order = KINDS[fmt]
    (jgu, jdn), (tgu, tdn) = _mlp(fmt)
    jx, tx = _x(m, dtype)
    for li in (0, L - 1):
        want = getattr(jfm, name)(jx, *(jgu[k] for k in order), *(jdn[k] for k in order),
                                  jnp.int32(li), fast=fast)
        got = getattr(tfm, name)(tx, *(tgu[k] for k in order), *(tdn[k] for k in order),
                                 li, fast=fast)
        assert got.dtype == tx.dtype and got.shape == (m, K)
        _held(got, want, fast, dtype, tx, _leaves((tgu, tdn), order, li))


@pytest.mark.parametrize("m", [1, 7, 9])
@pytest.mark.parametrize("fast,dtype", [(False, "f32"), (True, "bf16")])
@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1"])
def test_split_entry_matches_jax(fmt, fast, dtype, m):
    order = KINDS[fmt][2]
    jws, tws = _mlp(fmt, split=True, seed=1)
    jx, tx = _x(m, dtype, seed=1)
    packed = "qs4" in tws[0]
    want = jfm.fused_mlp_split_stacked(
        jx, *(tuple(w[k] for k in order) for w in jws), jnp.int32(1), packed=packed, fast=fast)
    got = tfm.fused_mlp_split_stacked(
        tx, *(tuple(w[k] for k in order) for w in tws), 1, packed=packed, fast=fast)
    _held(got, want, fast, dtype, tx, _leaves(tws, order, 1))


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0"])
def test_split_and_fused_schemas_agree_bit_for_bit(fmt):
    """Gate and up as two arrays or as the halves of one: the same values,
    the same result."""
    order = KINDS[fmt][2]
    _, (tg, tu, tdn) = _mlp(fmt, split=True, seed=2)
    gu = {k: torch.cat([tg[k], tu[k]], dim=-1) for k in order}
    _, tx = _x(5, "f32", seed=2)
    a = tfm.fused_mlp_split_stacked(tx, *(tuple(w[k] for k in order) for w in (tg, tu, tdn)),
                                    0, packed="qs4" in tg)
    b = getattr(tfm, KINDS[fmt][1])(tx, *(gu[k] for k in order), *(tdn[k] for k in order), 0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fmt", list(KINDS))
def test_plain_fused_matches_two_launch_path(fmt, fast):
    """The plain fused version against the port's per-projection path
    (``quant_linear_stacked`` twice around SiLU * up)."""
    _, name, order = KINDS[fmt]
    _, (tgu, tdn) = _mlp(fmt, seed=3)
    _, tx = _x(8, "f32", seed=3)
    for li in range(L):
        got = getattr(tfm, name)(tx, *(tgu[k] for k in order), *(tdn[k] for k in order),
                                 li, fast=fast)
        gu = tqm.quant_linear_stacked(tx, tgu, li, fast=fast)
        gated = torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]
        want = tqm.quant_linear_stacked(gated, tdn, li, fast=fast)
        rel = ((got - want).abs().max() / (want.abs().max() + 1e-6)).item()
        assert rel < (0.03 if fast else 1e-4), (li, rel)


def test_plain_version_rounds_where_the_kernel_does():
    """``fast``: x, each dequantized weight and gated rounded once to bf16,
    float32 sums; checked against the same arithmetic written out."""
    _, (tgu, tdn) = _mlp("Q4_1", seed=4)
    _, tx = _x(3, "f32", seed=4)
    got = tfm.fused_mlp4_stacked(tx, tgu["qs4"], tgu["scales"], tgu["mins"],
                                 tdn["qs4"], tdn["scales"], tdn["mins"], 1, fast=True)

    def bf(t):
        return t.to(torch.bfloat16).float()

    wgu = tqm.dequantize_weight({k: v[1] for k, v in tgu.items()})
    wdn = tqm.dequantize_weight({k: v[1] for k, v in tdn.items()})
    g, u = bf(tx) @ bf(wgu[:, :I]), bf(tx) @ bf(wgu[:, I:])
    want = bf(g * torch.sigmoid(g) * u) @ bf(wdn)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["dequant", "bf16"])
@pytest.mark.parametrize("fmt", list(KINDS))
def test_fused_mlp_at_matches_jax(fmt, mode):
    jl.set_group_matmul_mode(mode)
    tl.set_group_matmul_mode(mode)
    (jgu, jdn), (tgu, tdn) = _mlp(fmt, seed=5)
    fast = mode == "bf16"
    jx, tx = _x(6, "bf16" if fast else "f32", seed=5)
    want = jl.fused_mlp_at(jx.reshape(2, 3, K), jgu, jdn, jnp.int32(1))
    got = tl.fused_mlp_at(tx.reshape(2, 3, K), tgu, tdn, 1)
    assert want is not None and got is not None and got.shape == (2, 3, K)
    _held(got.reshape(6, K), np.asarray(want, np.float32).reshape(6, K), fast,
          "bf16" if fast else "f32", tx, _leaves((tgu, tdn), KINDS[fmt][2], 1))


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q5_1"])
def test_fused_mlp_split_at_matches_jax(fmt, monkeypatch):
    # off the TPU the JAX entry runs wherever the switch allows
    monkeypatch.setenv("QA_FUSED_MLP", "1")
    jl.set_group_matmul_mode("dequant")
    tl.set_group_matmul_mode("dequant")
    jws, tws = _mlp(fmt, split=True, seed=6)
    jx, tx = _x(4, "f32", seed=6)
    want = jl.fused_mlp_split_at(jx, *jws, jnp.int32(0))
    got = tl.fused_mlp_split_at(tx, *tws, 0)
    assert want is not None and got is not None
    _held(got, want, False, "f32")


def _guard_cases():
    """name -> a function (gate_up, down, x) -> (gate_up, down, x) that makes
    the one-launch kernel not apply."""
    def bias(gu, dn, x, lib):
        return dict(gu, b=lib.zeros((L, 2 * I))), dn, x

    def mixed(gu, dn, x, lib):       # int8 values beside packed nibbles
        return gu, {"qs4": dn["qs"][:, ::2].astype(lib.uint8) if lib is jnp
                    else dn["qs"][:, ::2].to(torch.uint8), "scales": dn["scales"]}, x

    def mins_one_side(gu, dn, x, lib):
        return gu, dict(dn, mins=dn["scales"] * 0), x

    def groups_differ(gu, dn, x, lib):     # group 32 against group 16
        sc = lib.concatenate([dn["scales"], dn["scales"]], 1) if lib is jnp \
            else torch.cat([dn["scales"], dn["scales"]], 1)
        return gu, dict(dn, scales=sc), x

    def too_many_rows(gu, dn, x, lib):
        return gu, dn, lib.zeros((65, K))

    def dense_down(gu, dn, x, lib):
        return gu, {"w": lib.zeros((L, I, K))}, x

    return {f.__name__: f for f in (bias, mixed, mins_one_side, groups_differ,
                                    too_many_rows, dense_down)}


@pytest.mark.parametrize("case", list(_guard_cases()))
def test_fused_mlp_at_returns_none_where_jax_does(case):
    change = _guard_cases()[case]
    (jgu, jdn), (tgu, tdn) = _mlp("Q8_0", seed=7)
    jx, tx = _x(4, "f32", seed=7)
    jg, jd, jxx = change(jgu, jdn, jx, jnp)
    tg, td, txx = change(tgu, tdn, tx, torch)
    assert jl.fused_mlp_at(jxx, jg, jd, jnp.int32(0)) is None
    assert tl.fused_mlp_at(txx, tg, td, 0) is None
    # and without the change both take the kernel
    assert jl.fused_mlp_at(jx, jgu, jdn, jnp.int32(0)) is not None
    assert tl.fused_mlp_at(tx, tgu, tdn, 0) is not None


def test_switch_mode_and_row_limit(monkeypatch):
    (jgu, jdn), (tgu, tdn) = _mlp("Q4_0", seed=8)
    jx, tx = _x(2, "f32", seed=8)
    assert tl.fused_mlp_enabled()
    monkeypatch.setenv("QA_FUSED_MLP", "0")
    tl.set_fused_mlp(False)
    assert jl.fused_mlp_at(jx, jgu, jdn, jnp.int32(0)) is None
    assert tl.fused_mlp_at(tx, tgu, tdn, 0) is None and not tl.fused_mlp_enabled()
    monkeypatch.delenv("QA_FUSED_MLP")
    tl.set_fused_mlp(None)
    assert tl.fused_mlp_at(tx, tgu, tdn, 0) is not None
    # mode "int8": no one-launch kernel in either package; the per-projection
    # path takes the integer group matmul in both (1e-6 of max|ref|, the
    # bound of tests/test_torch_quant_matmul_int8.py)
    jl.set_group_matmul_mode("int8")
    tl.set_group_matmul_mode("int8")
    assert jl.fused_mlp_at(jx, jgu, jdn, jnp.int32(0)) is None
    assert tl.fused_mlp_at(tx, tgu, tdn, 0) is None
    for w_j, w_t, x_j, x_t in ((jgu, tgu, jx, tx), (jdn, tdn, *_x(2, "f32", k=I, seed=8))):
        want = np.asarray(jl.linear_at(x_j, w_j, jnp.int32(1)))
        np.testing.assert_allclose(tl.linear_at(x_t, w_t, 1).numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    tl.set_group_matmul_mode(None)
    # the direct entries raise past 64 rows, as the JAX ones do
    with pytest.raises(ValueError, match="decode-shaped"):
        tfm.fused_mlp4_sym_stacked(torch.zeros(65, K), tgu["qs4"], tgu["scales"],
                                   tdn["qs4"], tdn["scales"], 0)
    with pytest.raises(ValueError, match="decode-shaped"):
        jfm.fused_mlp4_sym_stacked(jnp.zeros((65, K)), jgu["qs4"], jgu["scales"],
                                   jdn["qs4"], jdn["scales"], jnp.int32(0))


def test_split_at_guards():
    _, (tg, tu, tdn) = _mlp("Q5_1", split=True, seed=9)
    _, tx = _x(2, "f32", seed=9)
    assert tl.fused_mlp_split_at(tx, tg, tu, tdn, 0) is not None
    no_mins = {k: v for k, v in tu.items() if k != "mins"}
    assert tl.fused_mlp_split_at(tx, tg, no_mins, tdn, 0) is None     # unequal key sets
    assert tl.fused_mlp_split_at(tx, dict(tg, b=torch.zeros(L, I)), tu, tdn, 0) is None
    assert tl.fused_mlp_split_at(torch.zeros(65, K), tg, tu, tdn, 0) is None
    tl.set_fused_mlp(False)
    assert tl.fused_mlp_split_at(tx, tg, tu, tdn, 0) is None


def test_wrapper_refuses_bad_shapes_and_devices():
    _, (tgu, tdn) = _mlp("Q8_0", seed=7)
    x = torch.zeros(2, K)
    args = (tgu["qs"], tgu["scales"], tdn["qs"], tdn["scales"])
    with pytest.raises(ValueError):                      # K does not match
        tfm.fused_mlp_stacked(torch.zeros(2, K + 32), *args, 0)
    with pytest.raises(ValueError):                      # leaves without the (L,) axis
        tfm.fused_mlp_stacked(x, *(a[0] for a in args), 0)
    with pytest.raises(ValueError):                      # nibble entry, int8 values
        tfm.fused_mlp4_sym_stacked(torch.zeros(2, 2 * K), *args, 0)
    with pytest.raises(ValueError):                      # down's group differs
        tfm.fused_mlp_stacked(x, tgu["qs"], tgu["scales"], tdn["qs"],
                              torch.cat([tdn["scales"]] * 2, 1), 0)
    with pytest.raises(ValueError):                      # an odd fused width
        tfm.fused_mlp_stacked(x, tgu["qs"][..., :-1], tgu["scales"][..., :-1],
                              tdn["qs"], tdn["scales"], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_mlp_stacked(x.to("meta"), *(a.to("meta") for a in args), 0)
    assert all(e.launches == 0 for e in tfm.ENTRIES)     # the CPU launches nothing


def test_slice_plan():
    # the 7B tower at one row: one 64-column tile per block, 296 blocks
    assert tfm.slice_width(1, 18944, 3584) == 64
    for m in (1, 2, 7, 8, 33, 64):
        bi = tfm.slice_width(m, 18944, 3584)
        slices = -(-18944 // bi)
        assert bi % 64 == 0 and slices * m * 3584 * 4 <= 64 << 20
        assert slices >= 60          # still more blocks than half the card's SMs
    assert tfm.slice_width(64, 18944, 3584) == 320
    assert tfm.slice_width(3, 96, 64) == 64              # a ragged last tile


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0"])
@pytest.mark.parametrize("shape", ["rows", "batch"])
def test_fused_form_takes_one_launch_up_to_the_cards_crossover(fmt, shape):
    """In bf16 mode the dispatch takes the one-launch kernel at
    ``ONE_LAUNCH_MAX_M`` rows of x (however they are batched) and the
    two-launch path one row above it, where the card measured the two-launch
    path faster; the kernel itself keeps its range (``MAX_M`` = 64)."""
    _, (tgu, tdn) = _mlp(fmt, seed=10)
    n = tfm.ONE_LAUNCH_MAX_M
    tl.set_group_matmul_mode("bf16")
    try:
        for rows, want in ((n, True), (n + 1, False)):
            x = torch.zeros(rows, K) if shape == "rows" else torch.zeros(1, rows, K)
            assert (tl._fused_form(x, (tgu, tdn)) is not None) == want
            assert (tl.fused_mlp_at(x, tgu, tdn, 0) is not None) == want
    finally:
        tl.set_group_matmul_mode(None)
    assert 8 <= n < tfm.MAX_M == 64
