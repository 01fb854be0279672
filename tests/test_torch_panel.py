"""The port's contiguous-panel weight forms (ops/quant_matmul.py panel
entries, ``panelize_weight``, ``pick_panel_width``, ``quant_linear_panel``;
``models.qwen2_decoder.panelize_decoder_params``; the panel branches of
``ops.linear``) against their JAX namesakes (Pallas in interpret mode on the
CPU) and, bit for bit, against the port's strided entries on the same values.

Tolerances against JAX as for the strided entries: exact mode, float32:
rtol 1e-5 / atol 1e-5 (the order of the float32 sums); ``fast`` mode, bf16
out: atol 2e-2 (the last rounding may fall either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.ops import quant_matmul as jqm
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.quant import qparams as tq

K, N, BN, L = 256, 512, 128, 3
EXACT = dict(rtol=1e-5, atol=1e-5)
FAST_ATOL = 2e-2
FORMATS = ["Q8_0", "Q6_K", "Q4_0", "Q4_1"]


@pytest.fixture(autouse=True)
def _modes():
    yield
    jl.set_group_matmul_mode(None)
    tl.set_group_matmul_mode(None)


def _host(fmt, seed=0, k=K, n=N):
    w = (0.05 * np.random.default_rng(seed).standard_normal((k, n))).astype(np.float32)
    return jq.quantize_array_for_device(w, JType[fmt], to_device=False,
                                        form=jq.Q4Form(scale="f16"))


def _flat(fmt, seed=0, bn=BN):
    """(JAX strided, JAX panels, port strided, port panels) of one weight."""
    host = _host(fmt, seed)
    jw = {k: jnp.asarray(v) for k, v in host.items()}
    tw = quant_params_from_jax(host)
    return jw, jqm.panelize_weight(jw, bn), tw, tqm.panelize_weight(tw, bn)


def _stacked(fmt, bn=BN):
    hosts = [_host(fmt, seed=10 + i) for i in range(L)]
    host = {k: np.stack([h[k] for h in hosts]) for k in hosts[0]}
    jw = {k: jnp.asarray(v) for k, v in host.items()}
    tw = quant_params_from_jax(host)
    per = [jqm.panelize_weight({k: v[i] for k, v in jw.items()}, bn) for i in range(L)]
    jp = {k: jnp.stack([d[k] for d in per]) for k in per[0]}
    return jw, jp, tw, tqm.panelize_weight(tw, bn)


def _x(m, dtype, seed=0, k=K):
    x = np.random.default_rng(100 + seed).standard_normal((m, k)).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32))


def _close(got, want, fast):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    if fast:
        np.testing.assert_allclose(got.float().numpy(), want, atol=FAST_ATOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **EXACT)


def _keys(tw):
    packed = "qs4" in tw
    return ("qs4" if packed else "qs", "qs4_p" if packed else "qs_p", packed,
            {"off": 8 if "mins" not in tw else 0} if packed else {})


@pytest.mark.parametrize("m", [1, 5, 40])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_panel_entry_matches_jax_and_strided(fmt, fast, m):
    jw, jp, tw, tp = _flat(fmt)
    qkey, pkey, packed, kw = _keys(tw)
    jx, tx = _x(m, "bf16" if fast else "f32")
    jentry, tentry, strided = ((jqm.quant_matmul_panel4, tqm.quant_matmul_panel4,
                                tqm.quant_matmul4) if packed else
                               (jqm.quant_matmul_panel, tqm.quant_matmul_panel,
                                tqm.quant_matmul))
    assert tp[pkey].shape == (N // BN, K // (2 if packed else 1), BN)
    got = tentry(tx, tp[pkey], tp["scales_p"], fast=fast, **kw)
    assert got.dtype == tx.dtype
    _close(got, jentry(jx, jp[pkey], jp["scales_p"], fast=fast, **kw), fast)
    assert torch.equal(got, strided(tx, tw[qkey], tw["scales"], fast=fast, **kw))


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_panel_stacked_entry_matches_jax_and_strided(fmt, fast, m):
    jw, jp, tw, tp = _stacked(fmt)
    qkey, pkey, packed, kw = _keys(tw)
    jx, tx = _x(m, "bf16" if fast else "f32", seed=1)
    jentry, tentry, flat, strided = (
        (jqm.quant_matmul_panel4_stacked, tqm.quant_matmul_panel4_stacked,
         tqm.quant_matmul_panel4, tqm.quant_matmul4_stacked) if packed else
        (jqm.quant_matmul_panel_stacked, tqm.quant_matmul_panel_stacked,
         tqm.quant_matmul_panel, tqm.quant_matmul_stacked))
    assert tp[pkey].dim() == 4 and tp[pkey].is_contiguous()
    for li in (0, L - 1):
        got = tentry(tx, tp[pkey], tp["scales_p"], li, fast=fast, **kw)
        _close(got, jentry(jx, jp[pkey], jp["scales_p"], jnp.int32(li), fast=fast, **kw), fast)
        # the layer is read in place; flat, stacked and strided agree bit for bit
        assert torch.equal(got, flat(tx, tp[pkey][li], tp["scales_p"][li], fast=fast, **kw))
        assert torch.equal(got, strided(tx, tw[qkey], tw["scales"], li, fast=fast, **kw))


@pytest.mark.parametrize("fmt", FORMATS + ["Q5_1"])
def test_panelize_weight_round_trip_and_jax_bytes(fmt):
    jw, jp, tw, tp = _flat(fmt, seed=2)
    qkey, pkey, packed, _ = _keys(tw)
    assert set(tp) == set(jp)
    for leaf in tp:
        want = quant_params_from_jax({pkey: jp[pkey], leaf: jp[leaf]})[leaf]
        assert tp[leaf].dtype == want.dtype and tp[leaf].shape == want.shape, leaf
        assert torch.equal(tp[leaf], want), leaf
    assert torch.equal(tqm.from_panels(tp[pkey]), tw[qkey])
    assert torch.equal(tqm.from_panels(tp["scales_p"]), tw["scales"])
    if "mins" in tw:                       # mins stay (K // group, N)
        assert tp["mins"] is tw["mins"]
    # numpy leaves panelize to the same bytes
    host = tqm.panelize_weight({k: v.numpy() for k, v in tw.items()}, BN)
    assert all(np.array_equal(host[k], tp[k].numpy()) for k in tp)
    assert host[pkey].flags["C_CONTIGUOUS"]
    with pytest.raises(ValueError):
        tqm.to_panels(tw[qkey], 96)


@pytest.mark.parametrize("n", [4608, 37888, 3584, 156032, 18944, 5120, 1280, 512, 200,
                               96, 128, 1024, 2048 + 128])
def test_pick_panel_width_matches_jax(n, monkeypatch):
    monkeypatch.delenv("QA_PANEL_BN", raising=False)
    assert tqm.pick_panel_width(n) == jqm.pick_panel_width(n)
    for pref in (256, 768, 2048):
        assert tqm.pick_panel_width(n, pref) == jqm.pick_panel_width(n, pref)
    bn = tqm.pick_panel_width(n)
    assert n % bn == 0 and (bn % 128 == 0 or bn == n)


def test_panel_widths_of_the_7b_tower():
    assert [tqm.pick_panel_width(n) for n in (4608, 37888, 3584, 156032)] == \
        [768, 1024, 896, 128]
    assert tqm.pick_panel_width(200) == 200      # no multiple of 128 divides it


@pytest.mark.parametrize("fmt", FORMATS + ["Q5_1", "Q2_K"])
def test_quant_linear_panel_matches_jax(fmt, rng):
    """Batched activations, mins added outside the kernel from the
    unpanelled (K // group, N) leaf."""
    jw, jp, tw, tp = _flat(fmt, seed=3)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    got = tqm.quant_linear_panel(torch.from_numpy(x), tp)
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(jqm.quant_linear_panel(
        jnp.asarray(x), jp)), rtol=1e-5, atol=2e-5)
    assert torch.equal(got, tqm.quant_linear(torch.from_numpy(x), tw))


@pytest.mark.parametrize("fmt", FORMATS + ["Q5_1"])
def test_quant_linear_stacked_panel_branches_match_jax(fmt, rng):
    jw, jp, tw, tp = _stacked(fmt)
    x = rng.standard_normal((1, 5, K)).astype(np.float32)
    for li in range(L):
        got = tqm.quant_linear_stacked(torch.from_numpy(x), tp, li)
        want = jqm.quant_linear_stacked(jnp.asarray(x), jp, jnp.int32(li))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
        assert torch.equal(got, tqm.quant_linear_stacked(torch.from_numpy(x), tw, li))


@pytest.mark.parametrize("mode", ["dequant", "bf16"])
@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1"])
def test_linear_dispatch_takes_panels(fmt, mode, rng):
    jl.set_group_matmul_mode(mode)
    tl.set_group_matmul_mode(mode)
    fast = mode == "bf16"
    jx, tx = _x(5, "bf16" if fast else "f32", seed=6)
    tol = dict(atol=2 * FAST_ATOL) if fast else dict(rtol=1e-5, atol=2e-5)
    b = rng.standard_normal(N).astype(np.float32)
    _, jp, _, tp = _flat(fmt, seed=6)
    got = tl.linear(tx, dict(tp, b=torch.from_numpy(b)))
    want = jl.linear(jx, dict(jp, b=jnp.asarray(b)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    _, jps, _, tps = _stacked(fmt)
    bs = rng.standard_normal((L, N)).astype(np.float32)
    for li in (0, 2):
        got = tl.linear_at(tx, dict(tps, b=torch.from_numpy(bs)), li)
        want = jl.linear_at(jx, dict(jps, b=jnp.asarray(bs)), jnp.int32(li))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_fused_mlp_at_leaves_panels_to_linear_at():
    """A panelized gate_up is not the one-launch kernel's form, in either
    package."""
    _, jp, _, tp = _stacked("Q8_0")
    jx, tx = _x(2, "f32")
    assert jl.fused_mlp_at(jx, jp, jp, jnp.int32(0)) is None
    assert tl.fused_mlp_at(tx, tp, tp, 0) is None


def test_wrapper_refuses_bad_panel_shapes():
    _, _, tw, tp = _flat("Q8_0")
    x = torch.zeros(2, K)
    with pytest.raises(ValueError):                # a strided weight at a panel entry
        tqm.quant_matmul_panel(x, tw["qs"], tw["scales"])
    with pytest.raises(ValueError):                # panels at a strided entry
        tqm.quant_matmul(x, tp["qs_p"], tp["scales_p"])
    with pytest.raises(ValueError):                # scales of another panel count
        tqm.quant_matmul_panel(x, tp["qs_p"], tp["scales_p"][:2])
    with pytest.raises(ValueError):                # int8 panels at the nibble entry
        tqm.quant_matmul_panel4(torch.zeros(2, 2 * K), tp["qs_p"], tp["scales_p"])
    with pytest.raises(ValueError):                # flat panels at the stacked entry
        tqm.quant_matmul_panel_stacked(x, tp["qs_p"], tp["scales_p"], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.quant_matmul_panel(x.to("meta"), tp["qs_p"].to("meta"), tp["scales_p"].to("meta"))
    assert all(e.launches == 0 for e in tqm.ENTRIES)


# --------------------------------------------------------------------------- #
# panelize_decoder_params
# --------------------------------------------------------------------------- #

DEC = dict(vocab_size=256, hidden_size=128, intermediate_size=8192 + 256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=32, tie_word_embeddings=False)


def _tree(fmt):
    """A fused quantized decoder tree of the port (random blocks; ``down``
    has K > 8192) and the same tree as numpy leaves for the JAX package."""
    cfg = Qwen2DecoderConfig(**DEC)
    p = td.fuse_decoder_params(td.random_quant_decoder_params(
        torch.Generator().manual_seed(0), cfg, fmt, dtype=torch.float32))

    def host(t):
        return {k: host(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()

    return p, host(p)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, want[k])
        else:
            w = np.asarray(want[k])
            assert tuple(v.shape) == w.shape, k
            assert v.numpy().dtype == w.dtype, k
            assert v.numpy().tobytes() == np.ascontiguousarray(w).tobytes(), k


@pytest.mark.parametrize("deep_k,skip_gu", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_panelize_decoder_params_matches_jax(fmt, deep_k, skip_gu, monkeypatch):
    monkeypatch.delenv("QA_PANEL_BN", raising=False)
    monkeypatch.setenv("QA_PANEL_DEEP_K", "1" if deep_k else "0")
    monkeypatch.setenv("QA_PANEL_SKIP_GU", "1" if skip_gu else "0")
    p, hp = _tree(fmt)
    got = td.panelize_decoder_params(p, deep_k=deep_k, skip_gate_up=skip_gu)
    _assert_trees_equal(got, jd.panelize_decoder_params(hp))
    layers = got["layers"]
    pkey, qkey = ("qs4_p", "qs4") if fmt == "q4_0" else ("qs_p", "qs")
    assert pkey in layers["qkv"] and pkey in layers["o"] and pkey in got["lm_head"]
    assert "b" in layers["qkv"] and "w" in layers["ln1"]
    assert (pkey in layers["down"]) == deep_k            # K = 8448 > 8192
    assert (qkey in layers["gate_up"]) == skip_gu
    assert layers["qkv"][pkey].shape[:2] == (2, 1) and got["lm_head"][pkey].dim() == 3
    # numpy leaves give the same bytes, and the input tree is left as it was
    _assert_trees_equal(got, td.panelize_decoder_params(hp, deep_k=deep_k,
                                                        skip_gate_up=skip_gu))
    assert qkey in p["layers"]["qkv"]


def test_payload_form_names_panels_as_jax_does():
    for fmt in ("Q8_0", "Q6_K", "Q4_0", "Q4_1"):
        jw, jp, tw, tp = _flat(fmt, seed=4)
        # the JAX strings name the storage type of the nibbles too: hand it
        # the port's leaves (uint8 nibbles), as convert carries them across
        as_np = {k: v.numpy() for k, v in tp.items()}
        assert tq.payload_form(tp) == jq.payload_form(as_np)
        assert "-panel" in tq.payload_form(tp)
        assert tq.payload_form(tw) == jq.payload_form({k: v.numpy() for k, v in tw.items()})
    assert tq.payload_form(_flat("Q4_0")[3]) == "packed4-panel+sym+u8+f16sc"
    assert tq.payload_form(_flat("Q4_1")[3]) == "packed4-panel+mins+u8+f16sc"
    assert tq.payload_form(_flat("Q6_K")[3]) == "strided-panel+sym+f32sc"


def test_quant_params_from_jax_carries_a_panelized_tree(monkeypatch):
    """JAX storage variants (int8-typed nibbles, uint16 scale bits) inside a
    panelized decoder tree become the port's types with the same values."""
    monkeypatch.setenv("QA_PANEL_DEEP_K", "0")
    monkeypatch.setenv("QA_PANEL_SKIP_GU", "0")
    p, hp = _tree("q4_0")
    jax_like = dict(hp, layers={
        k: ({leaf: (a.view(np.int8) if leaf == "qs4" else
                    a.view(np.uint16) if leaf == "scales" else a)
             for leaf, a in e.items()} if "qs4" in e else e)
        for k, e in hp["layers"].items()})
    got = quant_params_from_jax(jd.panelize_decoder_params(jax_like))
    want = td.panelize_decoder_params(p)
    for key in ("qkv", "o", "gate_up", "down"):
        assert set(got["layers"][key]) == set(want["layers"][key]), key
        for leaf, v in want["layers"][key].items():
            assert got["layers"][key][leaf].dtype == v.dtype, (key, leaf)
            assert torch.equal(got["layers"][key][leaf], v), (key, leaf)
    assert got["layers"]["qkv"]["qs4_p"].dtype == torch.uint8
    assert got["layers"]["qkv"]["scales_p"].dtype == torch.float16
    assert torch.equal(got["lm_head"]["qs4_p"], want["lm_head"]["qs4_p"])
