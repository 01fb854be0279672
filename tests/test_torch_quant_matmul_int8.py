"""The port's exact-integer group matmul (ops/quant_matmul_int8.py,
ops/quant_matmul_q4b.py), its linear dispatch in mode "int8" and the
word-packed q4_0 form against the JAX package's (Pallas kernels in interpret
mode on the CPU), on the same ggml blocks and activations.

Tolerances against JAX: both quantize x to the same int8 bits (asserted
against JAX's quantize_activations) and take the same exact integer group
dots, so only the float32 steps differ: 1e-6 * max|ref| with float32 x, plus
one bf16 ulp (2^-7 * |ref|) where the output is bf16, plus, where XLA's
compiled quantization inside the JAX kernel rounds a near-tie the other way
(``_flip_bound``), sx * sw * |v| for each such xq. The results are not
bit-equal in float32: XLA's CPU code fuses and contracts the float32
updates of the interpreted kernel its own way (the same updates jitted
outside Pallas give other bits again); with bf16 output most cases are
bit-equal (``test_matmul_entries_match_jax`` records which). Whole decoders
(2 layers, D = 64): DEC_REL = 1e-5 of max|logit|. At these sizes no xq
rounds the other way, so the port stays far inside it, while the same
decoder in the exact mode stands more than 10 * DEC_REL off JAX's mode
"int8" (asserted): the bound tells the arithmetics apart. Each forward's
entry calls are counted as well."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.ops import quant_matmul as jqm
from qwen2_audio_tpu.ops import quant_matmul_int8 as j8
from qwen2_audio_tpu.ops import quant_matmul_q4b as jb
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig as TCfg
from qwen2_audio_tpu_torch.convert import decoder_params_from_jax, quant_params_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb
from qwen2_audio_tpu_torch.quant import qparams as tq

K, N, L = 512, 384, 2
REL = 1e-6
BF16_ULP = 2.0 ** -7
DEC_REL = 1e-5   # of max|logit|, whole decoders (see the module docstring)


@pytest.fixture(autouse=True)
def _modes():
    yield
    jl.set_group_matmul_mode(None)
    tl.set_group_matmul_mode(None)


def _x(m, dtype, seed=0, k=K):
    x = np.random.default_rng(100 + seed).standard_normal((m, k)).astype(np.float32)
    bf = dtype == "bf16"
    return (jnp.asarray(x, jnp.bfloat16 if bf else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if bf else torch.float32))


def _close(got, want, flips=0.0):
    """Within the module's tolerance, plus ``flips`` (``_flip_bound``);
    returns whether bit-equal."""
    want = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype") else want,
                      np.float32)
    g = got.float().numpy()
    assert g.shape == want.shape
    tol = REL * np.abs(want).max() + flips
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * np.abs(want)
    assert (np.abs(g - want) <= tol).all(), np.abs(g - want).max()
    return bool(np.array_equal(g, want))


def _flip_bound(jx, tx, values, scales):
    """How far the JAX kernel may stand off where XLA's compiled quantization
    rounds a near-tie the other way (seen with bf16 x: x * inv = 63.499996
    became 64 under jit, 63 eagerly, in numpy and here): each xq that differs
    moves the output by sx * sw * |v|."""
    jxq = np.asarray(jax.jit(j8.quantize_activations)(jx)[0]).astype(np.int64)
    xq, sx = (a.numpy() for a in t8.quantize_activations(tx))
    dq = np.abs(jxq - xq).astype(np.float64)
    if not dq.any():
        return 0.0
    v = np.abs(values.numpy().astype(np.float64))
    sw = scales.numpy().astype(np.float64)
    out = 0.0
    for g in range(sw.shape[0]):
        k = slice(g * 32, (g + 1) * 32)
        out = out + (dq[:, k] @ v[k]) * sx[:, g:g + 1] * sw[g:g + 1]
    return out


def _payload(seed, layers=L, k=K, n=N, scale=np.float16):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-128, 128, (layers, k, n)).astype(np.int8)       # -128 included
    qs4 = rng.integers(0, 256, (layers, k // 2, n)).astype(np.uint8)
    sc = (0.01 + 0.05 * rng.random((layers, k // 32, n))).astype(scale)
    return qs, qs4, sc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ties_and_zeros(m, k=K):
    """Rows with an all-zero group and values that sit on .5 rounding ties
    (a group whose max is 127 has sx = 1, so 2.5 -> 2 and -3.5 -> -4)."""
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    x[0, :32] = 0.0
    x[-1, 32:64] = np.array([127.0] + [0.5, 1.5, 2.5, -3.5, -0.5, 126.5] * 5 + [4.5],
                            np.float32)
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 7, 40])
def test_quantize_activations_bit_equal_jax(m, dtype):
    x = _ties_and_zeros(m)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jxq, jsx = j8.quantize_activations(jx)
    xq, sx = t8.quantize_activations(tx)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    assert np.array_equal(xq.numpy(), np.asarray(jxq))
    assert np.array_equal(sx.numpy(), np.asarray(jsx))
    assert float(sx[0, 0]) == 0.0 and not xq[0, :32].any()
    assert sx[-1, 1] == 1.0 and xq[-1, 32:39].tolist() == [127, 0, 2, 2, -4, 0, 126]
    assert t8.quantize_activations.launches == 0          # the CPU launches nothing


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 7, 40])
def test_matmul_entries_match_jax(m, dtype):
    """Rows 14, 15 (int8 values; nibbles off 8 and 0) and 16 against the JAX
    kernels; the port's flat entry equals its stacked one, and the word form
    equals the nibble form with off 8, bit for bit."""
    qs, qs4, sc = _payload(seed=m)
    jx, tx = _x(m, dtype, seed=m)
    equal = {}
    flips = _flip_bound(jx, tx, _t(qs[1]), _t(sc[1]))
    got14 = t8.quant_matmul_int8(tx, _t(qs[1]), _t(sc[1]))
    assert got14.dtype == tx.dtype
    equal["row 14"] = _close(got14, j8.quant_matmul_int8(jx, jnp.asarray(qs[1]),
                                                         jnp.asarray(sc[1])), flips)
    got15 = t8.quant_matmul_int8_stacked(tx, _t(qs), _t(sc), 1)
    assert torch.equal(got15, got14)
    equal["row 15 int8"] = _close(got15, j8.quant_matmul_int8_stacked(
        jx, jnp.asarray(qs), jnp.asarray(sc), jnp.int32(1)), flips)
    for off in (0, 8):
        got = t8.quant_matmul_int8_stacked(tx, _t(qs4), _t(sc), 1, off=off)
        flips = _flip_bound(jx, tx, tqm.unpack4(_t(qs4[1])) - off, _t(sc[1]))
        equal[f"row 15 nibbles off {off}"] = _close(got, j8.quant_matmul_int8_stacked(
            jx, jnp.asarray(qs4), jnp.asarray(sc), jnp.int32(1), off=off), flips)
    words = tb.pack_b32(_t(qs4))
    got16 = tb.quant_matmul_q4b_stacked(tx, words, _t(sc), 1)
    assert torch.equal(got16, got)                          # off 8, the same bytes
    equal["row 16"] = _close(got16, jb.quant_matmul_q4b_stacked(
        jx, jnp.asarray(jb.pack_b32(qs4)), jnp.asarray(sc), jnp.int32(1)), flips)
    assert t8.quant_matmul_int8.launches == t8.quant_matmul_int8_stacked.launches == 0
    print(f"M={m} {dtype}: bit-equal to JAX {equal}")


def test_plain_version_is_the_kernels_arithmetic():
    """The plain version against a float64 reckoning of the same function:
    xq exact, the group dots exact, the float32 sum in order."""
    qs, _, sc = _payload(seed=3, layers=1)
    x = np.random.default_rng(3).standard_normal((5, K)).astype(np.float32)
    got = t8.quant_matmul_int8(torch.from_numpy(x), _t(qs[0]), _t(sc[0])).numpy()
    xq, sx = (a.numpy() for a in t8.quantize_activations(torch.from_numpy(x)))
    acc = np.zeros((5, N), np.float32)
    for g in range(K // 32):
        p = xq[:, g * 32:(g + 1) * 32].astype(np.int64) @ qs[0, g * 32:(g + 1) * 32].astype(
            np.int64)
        scale = sx[:, g:g + 1] * sc[0, g:g + 1].astype(np.float32)
        acc = acc + p.astype(np.float32) * scale
    assert np.array_equal(got, acc)
    dense = x @ (qs[0].astype(np.float32) * np.repeat(sc[0].astype(np.float32), 32, 0))
    assert np.abs(got - dense).max() <= 0.02 * np.abs(dense).max()   # q8_1 rounding only


def test_pack_b32_matches_jax_and_round_trips():
    qs4 = np.random.default_rng(4).integers(0, 256, (3, 64, 48)).astype(np.uint8)
    want = jb.pack_b32(qs4)
    got_np, got_t = tb.pack_b32(qs4), tb.pack_b32(_t(qs4))
    assert got_np.dtype == np.int32 and got_t.dtype == torch.int32
    assert np.array_equal(got_np, want) and np.array_equal(got_t.numpy(), want)
    assert np.array_equal(tb.pack_b32(qs4.view(np.int8)), want)
    assert np.array_equal(tb.pack_b32(_t(qs4).view(torch.int8)).numpy(), want)
    assert np.array_equal(tb.unpack_b32(want), jb.unpack_b32_np(want))
    assert torch.equal(tb.unpack_b32(got_t), _t(qs4))
    sc = np.full((4, 48), 0.25, np.float16)
    assert np.array_equal(
        tb.dequantize_weight_q4b({"qs4b": got_t[0], "scales": _t(sc)}).numpy(),
        np.asarray(jb.dequantize_weight_q4b({"qs4b": jnp.asarray(want[0]),
                                             "scales": jnp.asarray(sc)})))
    with pytest.raises(ValueError):
        tb.pack_b32(_t(qs4[:, :63]))


def _block_dict(fmt, form, stacked, seed=0, k=K, n=N):
    """One ggml-quantized weight as (JAX dict, port dict), stacked over L."""
    rng = np.random.default_rng(seed)
    per = [jq.quantize_array_for_device(
        (0.05 * rng.standard_normal((k, n))).astype(np.float32), JType[fmt],
        to_device=False, form=form) for _ in range(L if stacked else 1)]
    host = {leaf: (np.stack([d[leaf] for d in per]) if stacked else per[0][leaf])
            for leaf in per[0]}
    return {leaf: jnp.asarray(v) for leaf, v in host.items()}, quant_params_from_jax(host)


FORMS = {   # name: (format, JAX Q4Form, panelize, the port's int8-mode entry or None)
    "q8_0": ("Q8_0", None, False, "int8"),
    "q5_1 mins": ("Q5_1", None, False, "int8"),
    "q4_0 sym": ("Q4_0", jq.Q4Form(scale="f16"), False, "int8"),
    "q4_0 mins": ("Q4_0", jq.Q4Form(sym=False, scale="f16"), False, "int8"),
    "q4_k mins": ("Q4_K", None, False, "int8"),
    "q6_K (16-groups)": ("Q6_K", None, False, None),
    "q8_0 panels": ("Q8_0", None, True, None),
    "q4_0 panels": ("Q4_0", jq.Q4Form(scale="f16"), True, None),
    "q4_0 b32": ("Q4_0", jq.Q4Form(b32=True, scale="f16"), False, "q4b"),
}


@pytest.mark.parametrize("name", list(FORMS))
def test_int8_mode_dispatch_matches_jax(name):
    """``linear`` and ``linear_at`` in mode "int8" for every form, against
    JAX in the same mode, and the entry each one reaches."""
    fmt, form, panel, route = FORMS[name]
    jl.set_group_matmul_mode("int8")
    tl.set_group_matmul_mode("int8")
    b = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    for stacked in (True, False):
        jw, tw = _block_dict(fmt, form, stacked, seed=11)
        if panel:   # the JAX entry panelizes one layer at a time
            per = [jqm.panelize_weight({k: v[i] for k, v in jw.items()})
                   for i in range(L)] if stacked else [jqm.panelize_weight(jw)]
            jw = {k: jnp.stack([d[k] for d in per]) if stacked else per[0][k] for k in per[0]}
            tw = tqm.panelize_weight(tw)
        jw["b"] = jnp.asarray(np.stack([b] * L) if stacked else b)
        tw["b"] = torch.from_numpy(np.stack([b] * L) if stacked else b)
        jx, tx = _x(5, "f32", seed=5)
        calls = {}
        for mod in (t8, tb, tqm):
            for e in mod.ENTRIES:
                calls[e.__name__] = 0
        spied = _spy(calls)
        try:
            got = tl.linear_at(tx, tw, 1) if stacked else tl.linear(tx, tw)
        finally:
            spied()
        want = jl.linear_at(jx, jw, jnp.int32(1)) if stacked else jl.linear(jx, jw)
        used = {k for k, v in calls.items() if v}
        integer = bool(used & {"quant_matmul_int8", "quant_matmul_int8_stacked",
                               "quant_matmul_q4b_stacked"})
        # the dequantizing kernels: the bound of tests/test_torch_quant_matmul.py
        top = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=(REL if integer else 1e-5) * top)
        if route == "q4b":
            assert used == {"quant_matmul_q4b_stacked"}
        elif route == "int8" and (stacked or fmt in ("Q8_0", "Q5_1")):
            assert used == {"quant_matmul_int8_stacked" if stacked else "quant_matmul_int8"}
        else:   # the exact dequantizing kernels
            assert used and not integer, used


def _spy(calls):
    """Count entry calls on the CPU (the wrappers count launches on the card
    only) by wrapping the module attributes ``linear`` reaches; returns the
    undo."""
    saved = []
    for mod in (t8, tb, tqm):
        for e in mod.ENTRIES:
            @functools.wraps(e)
            def wrapped(*a, _e=e, **k):
                calls[_e.__name__] += 1
                return _e(*a, **k)
            saved.append((mod, e.__name__, e))
            setattr(mod, e.__name__, wrapped)

    def undo():
        for mod, attr, e in saved:
            setattr(mod, attr, e)
    return undo


def test_fused_mlp_off_in_int8_mode_and_for_b32():
    jw, tw = _block_dict("Q8_0", None, True, seed=12, k=K, n=2 * 128)
    jd_, td_ = _block_dict("Q8_0", None, True, seed=13, k=128, n=K)
    jb_, tb_ = _block_dict("Q4_0", jq.Q4Form(b32=True, scale="f16"), True, seed=14, k=K,
                           n=2 * 128)
    jx, tx = _x(2, "f32", seed=12)
    assert tl.fused_mlp_at(tx, tw, td_, 0) is not None
    assert tl.fused_mlp_at(tx, tb_, td_, 0) is None
    assert jl.fused_mlp_at(jx, jb_, jd_, jnp.int32(0)) is None
    jl.set_group_matmul_mode("int8")
    tl.set_group_matmul_mode("int8")
    assert tl.fused_mlp_at(tx, tw, td_, 0) is None
    assert jl.fused_mlp_at(jx, jw, jd_, jnp.int32(0)) is None


def _decoders(form=None, fmt="Q4_0"):
    cfg = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               tie_word_embeddings=False)
    jcfg, tcfg = JCfg(**cfg), TCfg(**cfg)
    jp = jd.random_decoder_params(np.random.default_rng(7), jcfg, dtype=jnp.float32)
    jqp = jq.quantize_decoder_params(jp, JType[fmt], form=form)
    tp = decoder_params_from_jax(jax.tree.map(np.asarray, jp))
    tform = tq.Q4Form(b32=form.b32) if form is not None else None
    tqp = tq.quantize_decoder_params(tp, GGMLType[fmt], form=tform)
    return jcfg, tcfg, jp, jqp, tqp


DECODER_ENTRIES = {   # per forward of the 2-layer decoder: 4 linears a layer, the lm_head
    "q8_0 int8 mode": {"quant_matmul_int8_stacked": 8, "quant_matmul_int8": 1},
    "q4_0 int8 mode": {"quant_matmul_int8_stacked": 8, "quant_matmul4": 1},   # flat "qs4"
    "q4_0 b32": {"quant_matmul_q4b_stacked": 9},
}


@pytest.mark.parametrize("case", list(DECODER_ENTRIES))
def test_decoder_forward_matches_jax(case):
    """A 2-layer decoder, a 5-position prefill and one cached step, in mode
    "int8" or with b32 weights (in the default mode: "qs4b" takes the integer
    kernel in every mode), against JAX: each forward reaches the entries of
    DECODER_ENTRIES and no other, and the logits agree to DEC_REL of the
    largest."""
    b32 = case.endswith("b32")
    if not b32:
        jl.set_group_matmul_mode("int8")
        tl.set_group_matmul_mode("int8")
    jcfg, tcfg, jp, jqp, tqp = _decoders(jq.Q4Form(b32=True, scale="f16") if b32 else None,
                                         fmt="Q8_0" if case.startswith("q8_0") else "Q4_0")
    if b32:
        assert "qs4b" in tqp["layers"]["q"] and "qs4b" in tqp["lm_head"]
        assert tq.payload_form(tqp["layers"]["q"]) == "packed4-b32+sym+f16sc"
    jqp, tqp = jd.fuse_decoder_params(jqp), td.fuse_decoder_params(tqp)
    x = np.random.default_rng(8).standard_normal((1, 5, 64)).astype(np.float32)

    def forward(*a, **k):
        calls = {e.__name__: 0 for mod in (t8, tb, tqm) for e in mod.ENTRIES}
        undo = _spy(calls)
        try:
            out = td.decoder_forward(tqp, tcfg, *a, **k)
        finally:
            undo()
        assert {n: c for n, c in calls.items() if c} == DECODER_ENTRIES[case]
        return out

    want, jcache = jd.decoder_forward(jqp, jcfg, jnp.asarray(x), jd.KVCache.create(
        jcfg, 1, 8, dtype=jnp.float32), 0)
    got, tcache = forward(torch.from_numpy(x), td.create_cache(tcfg, 1, 8, torch.float32), 0,
                          block_only=True)
    err = np.abs(got.numpy() - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err <= DEC_REL, err
    if not b32:     # the exact mode's arithmetic lies outside the bound
        tl.set_group_matmul_mode("dequant")
        exact = td.decoder_forward(tqp, tcfg, torch.from_numpy(x), td.create_cache(
            tcfg, 1, 8, torch.float32), 0, block_only=True)[0]
        tl.set_group_matmul_mode("int8")
        gap = np.abs(exact.numpy() - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
        assert gap > 10 * DEC_REL, gap
    tok = int(got[0, -1].argmax())
    want, _ = jd.decoder_forward(jqp, jcfg, jd.embed_tokens(jp, jnp.asarray([[tok]])),
                                 jcache, 5)
    got, _ = forward(td.embed_tokens(tqp, torch.tensor([[tok]])), tcache, 5)
    err = np.abs(got.numpy() - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err <= DEC_REL, err


def test_quant_params_from_jax_takes_qs4b():
    qs4 = np.random.default_rng(5).integers(0, 256, (2, 32, 16)).astype(np.uint8)
    tree = {"layers": {"q": {"qs4b": jb.pack_b32(qs4),
                             "scales": np.ones((2, 2, 16), np.float16).view(np.uint16),
                             "b": np.zeros((2, 16), np.float32)}}}
    out = quant_params_from_jax(tree)["layers"]["q"]
    assert out["qs4b"].dtype == torch.int32 and out["scales"].dtype == torch.float16
    assert np.array_equal(out["qs4b"].numpy(), jb.pack_b32(qs4))
    assert torch.equal(tb.unpack_b32(out["qs4b"]), _t(qs4))
    with pytest.raises(NotImplementedError):
        quant_params_from_jax({"q": {"qs8": np.zeros((32, 16), np.int8),
                                     "scale_n": np.ones(16, np.float32)}})


def test_wrappers_refuse_bad_shapes_and_devices():
    qs, qs4, sc = _payload(seed=6, layers=1)
    x = torch.zeros(2, K)
    with pytest.raises(ValueError):                  # K not a multiple of 32
        t8.quantize_activations(torch.zeros(2, K + 16))
    with pytest.raises(ValueError):                  # scales of 16-groups
        t8.quant_matmul_int8(x, _t(qs[0]), _t(np.repeat(sc[0], 2, 0)))
    with pytest.raises(ValueError):                  # nibbles at the int8 entry
        t8.quant_matmul_int8(x, _t(qs4[0]), _t(sc[0]))
    with pytest.raises(ValueError):                  # off with int8 values
        t8.quant_matmul_int8_stacked(x, _t(qs), _t(sc), 0, off=8)
    with pytest.raises(ValueError):                  # off 4
        t8.quant_matmul_int8_stacked(x, _t(qs4), _t(sc), 0, off=4)
    with pytest.raises(ValueError):                  # bytes at the word entry
        tb.quant_matmul_q4b_stacked(x, _t(qs4), _t(sc), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        t8.quant_matmul_int8(x.to("meta"), _t(qs[0]).to("meta"), _t(sc[0]).to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        t8.quantize_activations(x.to("meta"))
    assert all(e.launches == 0 for e in t8.ENTRIES + tb.ENTRIES)


def test_q8_0_context_in_int8_mode_matches_jax():
    """A q8_0 checkpoint through both packages' contexts in mode "int8": the
    encoder's four linears per layer take the integer kernels in both; the
    embeddings agree to 3e-3 of their largest value. Over 256 positions an
    upstream ulp rounds some xq the other way, so the port stands further
    off JAX than one linear does; the port's exact mode stands beyond the
    bound (asserted), so the bound still separates the arithmetics."""
    import io

    from qwen2_audio_tpu.audio import mel_filterbank
    from qwen2_audio_tpu.config import WhisperHParams as JHParams
    from qwen2_audio_tpu.io.export import write_encoder_checkpoint
    from qwen2_audio_tpu.models.encoder import random_encoder_params
    from qwen2_audio_tpu.runtime import ContextParams as JContextParams
    from qwen2_audio_tpu.runtime import WhisperContext as JContext
    from qwen2_audio_tpu.runtime import full_default_params as j_full_default_params
    from qwen2_audio_tpu_torch import capi as tcapi
    from qwen2_audio_tpu_torch.config import GGMLFType
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint
    from qwen2_audio_tpu_torch.runtime.context import ContextParams, WhisperContext

    hp = JHParams(n_vocab=64, n_audio_ctx=256, n_audio_state=64, n_audio_head=4,
                  n_audio_layer=2, n_mels=16)
    src, dst = io.BytesIO(), io.BytesIO()
    write_encoder_checkpoint(src, random_encoder_params(np.random.default_rng(0), hp), hp,
                             mel_filterbank(hp.n_mels), [b"x"] * 60)
    quantize_checkpoint(io.BytesIO(src.getvalue()), dst, GGMLFType.MOSTLY_Q8_0)
    samples = (0.1 * np.random.default_rng(1).standard_normal(32000)).astype(np.float32)
    jl.set_group_matmul_mode("int8")
    tl.set_group_matmul_mode("int8")
    ctx = WhisperContext.init_from_buffer_with_params(dst.getvalue(),
                                                      ContextParams(use_gpu=False))
    calls = {e.__name__: 0 for mod in (t8, tb, tqm) for e in mod.ENTRIES}
    undo = _spy(calls)
    try:
        assert ctx.full(tcapi.whisper_full_default_params(), samples) == 0
    finally:
        undo()
    assert {k for k, v in calls.items() if v} == {"quant_matmul_int8"}
    assert calls["quant_matmul_int8"] == 4 * hp.n_audio_layer
    jctx = JContext.init_from_buffer_with_params(dst.getvalue(),
                                                 JContextParams(keep_quantized=True))
    assert jctx.full(j_full_default_params(), samples) == 0
    got, want = ctx.state.embd_enc.numpy(), np.asarray(jctx.state.embd_enc)
    assert np.abs(got - want).max() <= 3e-3 * np.abs(want).max()
    tl.set_group_matmul_mode("dequant")
    assert ctx.full(tcapi.whisper_full_default_params(), samples) == 0
    assert np.abs(ctx.state.embd_enc.numpy() - want).max() > 3e-3 * np.abs(want).max()


def test_b32_decoder_trees():
    """Random b32 blocks are the q4_0 bytes of the same seed; a b32 tree
    fuses (the "qs4b" width for the fused bias), passes through
    panelization, and its forward in the default mode gives the bits of the
    nibble-byte tree in mode "int8" (with the word lm_head: a flat "qs4"
    takes the exact dequantizing kernel in that mode)."""
    cfg = TCfg(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               tie_word_embeddings=False)
    p4 = td.random_quant_decoder_params(torch.Generator().manual_seed(3), cfg, "q4_0",
                                        dtype=torch.float32)
    pb = td.random_quant_decoder_params(torch.Generator().manual_seed(3), cfg, "q4_0",
                                        dtype=torch.float32, b32=True)
    assert torch.equal(tb.unpack_b32(pb["layers"]["down"]["qs4b"]), p4["layers"]["down"]["qs4"])
    assert torch.equal(pb["embed"], p4["embed"]) and "qs4b" in pb["lm_head"]
    fused = td.fuse_decoder_params(pb)
    qkv = fused["layers"]["qkv"]
    assert set(qkv) == {"qs4b", "scales", "b"} and qkv["qs4b"].shape == (2, 8, 64 + 2 * 32)
    assert qkv["b"].shape == (2, 128)
    panel = td.panelize_decoder_params(fused)
    assert all(panel["layers"][k] is fused["layers"][k] for k in ("qkv", "o", "gate_up", "down"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 64)).astype(np.float32))
    got = [td.decoder_forward(p, cfg, x, td.create_cache(cfg, 1, 4, torch.float32), 0,
                              block_only=True)[0] for p in (fused, panel)]
    assert torch.equal(got[0], got[1])
    tl.set_group_matmul_mode("int8")
    want = td.decoder_forward(td.fuse_decoder_params(dict(p4, lm_head=pb["lm_head"])), cfg,
                              x, td.create_cache(cfg, 1, 4, torch.float32), 0,
                              block_only=True)[0]
    assert torch.equal(got[0], want)
    with pytest.raises(ValueError):
        td.random_quant_linear(torch.Generator(), (64, 32), "q8_0", b32=True)


def test_encoder_from_a_q4_0_checkpoint_as_words():
    """A q4_0 checkpoint's nibbles as int32 words ("qs4b"):
    ``fuse_encoder_qkv`` fuses them, and the forward takes the word entry
    for all four linears of a layer."""
    import io

    from qwen2_audio_tpu_torch.audio.filters import mel_filterbank
    from qwen2_audio_tpu_torch.config import GGMLFType, WhisperHParams
    from qwen2_audio_tpu_torch.io.export import quantize_checkpoint, write_encoder_checkpoint
    from qwen2_audio_tpu_torch.io.ggml_format import read_ggml_file
    from qwen2_audio_tpu_torch.models import encoder as te

    hp = WhisperHParams(n_vocab=64, n_audio_ctx=64, n_audio_state=64, n_audio_head=4,
                        n_audio_layer=1, n_mels=16)
    src, dst = io.BytesIO(), io.BytesIO()
    write_encoder_checkpoint(src, te.random_encoder_params(np.random.default_rng(2), hp), hp,
                             mel_filterbank(hp.n_mels), [b"x"] * 8)
    quantize_checkpoint(io.BytesIO(src.getvalue()), dst, GGMLFType.MOSTLY_Q4_0)
    params = te.encoder_params_from_ggml(read_ggml_file(io.BytesIO(dst.getvalue())),
                                         keep_quantized=True)

    def as_words(e):
        if isinstance(e, dict) and "qs4" in e:
            return {"qs4b": tb.pack_b32(e["qs4"]), **{k: v for k, v in e.items() if k != "qs4"}}
        return e

    words = te.fuse_encoder_qkv(dict(params, layers=[
        {k: as_words(v) for k, v in lyr.items()} for lyr in params["layers"]]))
    nibbles = te.fuse_encoder_qkv(params)
    qkv = words["layers"][0]["qkv"]
    assert set(qkv) == {"qs4b", "scales", "b"} and qkv["qs4b"].shape == (8, 3 * 64)
    assert torch.equal(tb.unpack_b32(qkv["qs4b"]), nibbles["layers"][0]["qkv"]["qs4"])
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32))
    calls = {e.__name__: 0 for mod in (t8, tb, tqm) for e in mod.ENTRIES}
    undo = _spy(calls)
    try:
        got = te.encoder_forward(words, mel, hp)
    finally:
        undo()
    assert {k for k, v in calls.items() if v} == {"quant_matmul_q4b_stacked"}
    assert calls["quant_matmul_q4b_stacked"] == 4 * hp.n_audio_layer
    assert got.shape == (1, hp.n_audio_ctx // 2, 64) and bool(torch.isfinite(got).all())
    tl.set_group_matmul_mode("dequant")
    exact = te.encoder_forward(nibbles, mel, hp)
    assert float((got - exact).abs().max()) <= 0.03 * float(exact.abs().max())  # q8_1 rounding
