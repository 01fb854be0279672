"""The encoder attention's variants (ops/fa_variants.py) and the options of
the one-shot, blockwise and causal paths (ops/flash_attention.py) against
the JAX package: ``flash_attention`` under every combination of single,
lite, exp2, pexp16 and causal, ``flash_attention_nopad``,
``flash_attention_encoder`` under each ``set_attention_variants`` setting
and a 2-layer ``encoder_forward`` under lite and nopad (CPU, the Pallas
kernels in interpret mode).

The JAX side is compiled with ``xla_allow_excess_precision`` off: with it on
(XLA's default) the CPU compiler drops the bf16 roundings that pexp16
prescribes (it keeps exp's result in float32), so JAX on the CPU would not
compute its own kernel's function. Tolerances: float32 atol 2e-5 + rtol
1e-4 (the two sum in other orders); bf16 one ulp of the output (atol 1e-3
+ rtol 2^-7). Under pexp16 in float32, an f32 ulp of s (another order of
the Q K^T sum) moves bf16(s - m) across a rounding boundary now and then:
at most 1 % of the outputs may exceed the float32 tolerance, none by more
than 2^-7 max|V| (a missing rounding moves most of them,
``test_pexp16_check_sees_a_missing_rounding``). Under pexp16 with exp2, XLA
on the CPU expands the bf16 exp2 as exp(bf16(x * 0.69140625)), ln 2 rounded
to bf16, which is not 2^x (0.25 % off in the exponent); the port takes 2^x
in float32, as the kernel's exp2f does. There the plain version's
exponential is swapped for XLA's expansion (``_xla_exp2``) for the
comparison, so that the roundings are still held to JAX's."""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.models import encoder as jenc
from qwen2_audio_tpu.ops import fa_variants as jfv
from qwen2_audio_tpu_torch.config import WhisperHParams as THP
from qwen2_audio_tpu_torch.convert import encoder_params_from_jax
from qwen2_audio_tpu_torch.models import encoder as tenc
from qwen2_audio_tpu_torch.ops import fa_variants as tfv
from qwen2_audio_tpu_torch.ops import flash_attention as tfa

# the package's ops/__init__ re-exports a function of the module's name
jfa = importlib.import_module("qwen2_audio_tpu.ops.flash_attention")
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)
GATES = ("QA_FA_SINGLE", "QA_FA_LITE", "QA_FA_NOPAD", "QA_FA_EXP2", "QA_FA_PEXP16")


def _strict(fn, *args):
    """fn(*args) compiled without XLA's excess precision, as numpy."""
    args = [jnp.asarray(a) for a in args]
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args).astype(jnp.float32))


def _qkv(rng, B, H, Hkv, T, d, dtype=np.float32):
    q = rng.standard_normal((B, H, T, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, d)).astype(np.float32)
    if dtype != np.float32:   # values that bf16 holds exactly, on both sides
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    return q, k, v


def _xla_exp2(monkeypatch) -> None:
    """Make the port's plain versions take XLA's CPU expansion of a bf16
    exp2, exp(bf16(x * bf16(ln 2))), for the pexp16 comparisons."""
    real = tfa._exp

    def exp(x, exp2):
        return torch.exp((x * 0.69140625).bfloat16().float()) if exp2 else real(x, False)
    monkeypatch.setattr(tfa, "_exp", exp)


def test_xla_expands_bf16_exp2_with_a_rounded_ln2():
    """What ``_xla_exp2`` stands for, read from JAX itself; the port's own
    exp2 is 2^x."""
    x = np.linspace(-8, 0, 4001).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16().float()
    want = _strict(jnp.exp2, jnp.asarray(x, jnp.bfloat16))
    got = torch.exp((xb * 0.69140625).bfloat16().float()).bfloat16().float().numpy()
    np.testing.assert_array_equal(got, want)
    assert torch.equal(tfa._exp(xb, True), torch.exp2(xb))
    assert (torch.exp2(xb).bfloat16().float().numpy() != want).mean() > 0.3


def _assert_close(got, want, v_max: float, *, pexp16=False, bf16=False):
    """The module's tolerances (see its docstring)."""
    if bf16:
        np.testing.assert_allclose(got, want, **BF16_TOL)
    elif pexp16:
        err = np.abs(got - want)
        beyond = err > F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
        assert beyond.mean() <= 0.01, beyond.mean()
        assert err.max() <= 2.0 ** -7 * v_max, err.max()
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype):
    return jnp.asarray(x, dtype)


SHAPES = [  # (T, d, H, Hkv, kv_valid): T 256 and 300 (a padded tail), GQA
    (256, 64, 4, 2, None), (300, 64, 4, 4, 211), (256, 128, 4, 1, None),
    (300, 128, 4, 2, None),
]
OPTIONS = list(itertools.product([False, True], repeat=5))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}d{}H{}kv{}v{}".format(*s))
@pytest.mark.parametrize("single,lite,exp2,pexp16,causal", OPTIONS)
def test_flash_attention_matches_jax(shape, single, lite, exp2, pexp16, causal,
                                    monkeypatch):
    """Every combination of the five options at T 256 and 300, d 64 and 128:
    JAX's dispatch picks lite, one-shot, blockwise or causal, and the port's
    plain path takes the same one."""
    T, d, H, Hkv, kv_valid = shape
    rng = np.random.default_rng(T + d + H)
    q, k, v = _qkv(rng, 1, H, Hkv, T, d)
    kw = dict(sm_scale=d ** -0.5, causal=causal, kv_valid=kv_valid, single=single,
              lite=lite, exp2=exp2, pexp16=pexp16)
    want = _strict(lambda q, k, v: jfa.flash_attention(q, k, v, **kw), q, k, v)
    path = tfv.dispatch(T, d, causal=causal, block_k=512, single=single, lite=lite)
    if pexp16 and path == "single":
        _xla_exp2(monkeypatch)
    got = tfv.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert got.shape == want.shape == (1, H, T, d)
    _assert_close(got.numpy(), want, np.abs(v).max(), pexp16=pexp16 and path == "single")


@pytest.mark.parametrize("fault", ["x", "p"])
def test_pexp16_check_sees_a_missing_rounding(fault):
    """The pexp16 check of ``test_flash_attention_matches_jax`` fails a plain
    version that leaves out the bf16 rounding of s - m or of p."""
    rng = np.random.default_rng(256 + 64 + 4)
    q, k, v = _qkv(rng, 1, 4, 2, 256, 64)
    kw = dict(sm_scale=0.125, single=True, pexp16=True)
    want = _strict(lambda q, k, v: jfa.flash_attention(q, k, v, **kw), q, k, v)
    kf, vf = (torch.from_numpy(x).repeat_interleave(2, dim=1) for x in (k, v))
    s = torch.from_numpy(q) @ kf.transpose(-1, -2) * 0.125
    x = s - s.amax(-1, keepdim=True)
    p = torch.exp(x if fault == "x" else x.bfloat16().float())
    p = p if fault == "p" else p.bfloat16().float()
    got = ((p @ vf) / p.sum(-1, keepdim=True)).numpy()
    with pytest.raises(AssertionError):
        _assert_close(got, want, np.abs(v).max(), pexp16=True)


@pytest.mark.parametrize("causal,exp2", list(itertools.product([False, True], repeat=2)))
@pytest.mark.parametrize("T", [256, 300])
def test_blockwise_tiles_match_jax(T, causal, exp2):
    """block_k 128: several key tiles, the blockwise kernel's online softmax
    (the plain version rounds p per tile, as the TPU kernel does), bf16."""
    rng = np.random.default_rng(T)
    q, k, v = _qkv(rng, 1, 4, 2, T, 128, "bf16")
    kw = dict(sm_scale=128 ** -0.5, causal=causal, block_k=128, exp2=exp2)
    assert tfv.dispatch(T, 128, causal=causal, block_k=128, single=True,
                        lite=False) == ("causal" if causal else "blockwise")
    want = _strict(lambda q, k, v: jfa.flash_attention(q, k, v, **kw),
                   *(_jax(x, jnp.bfloat16) for x in (q, k, v)))
    got = tfv.flash_attention(*(_torch(x, torch.bfloat16) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("kind", ["lite", "single", "pexp16", "pexp16 exp2", "lite exp2"])
def test_one_shot_bf16_matches_jax(kind, monkeypatch):
    """The one-shot paths in bf16, where lite's row sum of the rounded p and
    pexp16's roundings act, at the encoder's d = 64 with a ragged tail."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 4, 2, 300, 64, "bf16")
    kw = dict(sm_scale=0.125, kv_valid=237, single=True, lite="lite" in kind,
              exp2="exp2" in kind, pexp16="pexp16" in kind)
    want = _strict(lambda q, k, v: jfa.flash_attention(q, k, v, **kw),
                   *(_jax(x, jnp.bfloat16) for x in (q, k, v)))
    if "pexp16" in kind:
        _xla_exp2(monkeypatch)
    got = tfv.flash_attention(*(_torch(x, torch.bfloat16) for x in (q, k, v)), **kw)
    _assert_close(got.float().numpy(), want, np.abs(v).max(), bf16=True)


@pytest.mark.parametrize("T,H,Hkv", [(256, 2, 2), (300, 4, 2), (375, 5, 5)])
@pytest.mark.parametrize("exp2", [False, True])
def test_nopad_matches_jax(T, H, Hkv, exp2):
    rng = np.random.default_rng(T + H)
    q, k, v = _qkv(rng, 1, H, Hkv, T, 64)
    want = np.asarray(jfv.flash_attention_nopad(
        *(jnp.asarray(x) for x in (q, k, v)), sm_scale=0.125, block_q=128, exp2=exp2))
    got = tfv.flash_attention_nopad(*(torch.from_numpy(x) for x in (q, k, v)),
                                    sm_scale=0.125, exp2=exp2)
    assert tfv.flash_attention_nopad.launches == 0
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


SETTINGS = {   # name: set_attention_variants arguments
    "default": {}, "single off": {"single": False}, "lite": {"lite": True},
    "nopad": {"nopad": True}, "exp2": {"exp2": True}, "pexp16": {"pexp16": True},
    "lite exp2": {"lite": True, "exp2": True}, "nopad exp2": {"nopad": True, "exp2": True},
    "single off exp2": {"single": False, "exp2": True},
    "pexp16 exp2": {"pexp16": True, "exp2": True},
}


def _set_gates(monkeypatch, switch: dict) -> None:
    sw = tfv.AttentionVariants(**switch)
    for env, on in zip(GATES, (sw.single, sw.lite, sw.nopad, sw.exp2, sw.pexp16)):
        monkeypatch.setenv(env, "1" if on else "0")


@pytest.mark.parametrize("name", list(SETTINGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_entry_matches_jax_under_each_switch(name, dtype, monkeypatch):
    """flash_attention_encoder under each set_attention_variants setting
    against the JAX entry with the matching QA_FA_* gates; in bf16 the Q
    pre-scale rounds 0.125 * LOG2E to bf16 first on both sides."""
    switch = SETTINGS[name]
    _set_gates(monkeypatch, switch)
    B, T, D, H = 2, 300, 128, 2
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
               .to(getattr(torch, dtype)).float().numpy() for _ in range(3))
    want = _strict(lambda q, k, v: jfa.flash_attention_encoder(q, k, v, H),
                   *(_jax(x, getattr(jnp, dtype)) for x in (q, k, v)))
    if switch.get("pexp16"):
        _xla_exp2(monkeypatch)
    tfv.set_attention_variants(**switch)
    try:
        got = tfv.flash_attention_encoder(
            *(_torch(x, getattr(torch, dtype)) for x in (q, k, v)), H)
    finally:
        tfv.set_attention_variants()
    _assert_close(got.float().numpy(), want, np.abs(v).max(), bf16=dtype == "bfloat16",
                  pexp16=bool(switch.get("pexp16")))


def test_prescale_rounds_the_scale_to_q_type():
    """0.125 * LOG2E is not a bf16 value: the pre-scale multiplies by its bf16
    rounding, and an unrounded scale gives other bits."""
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 128))
                         .astype(np.float32)).bfloat16()
    s = 0.125 * tfa.LOG2E
    s16 = torch.tensor(s, dtype=torch.bfloat16).item()
    assert s16 != s
    got = tfa.prescale(q, 2, exp2=True)
    assert torch.equal(got, (q.float() * s16).bfloat16())
    assert not torch.equal(got, (q.float() * s).bfloat16())
    want = np.asarray(jnp.asarray(q.float().numpy(), jnp.bfloat16)
                      * jnp.asarray(s, jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


SMALL = dict(n_vocab=66, n_audio_ctx=300, n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_mels=16)


@pytest.mark.parametrize("name,fused", [("lite", False), ("lite", True), ("nopad", False),
                                        ("nopad", True)])
def test_encoder_forward_under_variant_matches_jax(name, fused, monkeypatch):
    """A 2-layer encoder_forward with the attention through lite or nopad,
    against JAX's with its gate set (its jit cache cleared first: the gates
    are read at trace time); the port's variant entry runs once per layer."""
    switch = SETTINGS[name]
    _set_gates(monkeypatch, switch)
    jp = jenc.random_encoder_params(np.random.default_rng(5), JHP(**SMALL))
    jtree = jax.tree.map(np.asarray, jp)
    tp = encoder_params_from_jax(jtree)
    if fused:
        jtree, tp = jenc.fuse_encoder_qkv(jtree), tenc.fuse_encoder_qkv(tp)
    mel = np.random.default_rng(6).standard_normal((1, 16, 600)).astype(np.float32)
    jax.clear_caches()
    want = np.asarray(jenc.encoder_forward(jtree, jnp.asarray(mel), JHP(**SMALL),
                                           use_flash=True))
    calls = []   # the plain one-shot version's lite argument, call by call
    real = tfa.attention_single_plain
    monkeypatch.setattr(tfa, "attention_single_plain",
                        lambda *a, **k: calls.append(k.get("lite", False)) or real(*a, **k))
    tfv.set_attention_variants(**switch)
    try:
        got = tenc.encoder_forward(tp, torch.from_numpy(mel), THP(**SMALL), use_flash=True)
    finally:
        tfv.set_attention_variants()
    assert calls == [name == "lite"] * SMALL["n_audio_layer"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_lite_poisoned_tail_matches_jax():
    """Keys past kv_valid poisoned with 100 (the JAX suite's case): both
    packages leave them out."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 1, 1, 200, 64)
    q = q[:, :, :128]
    k[:, :, 150:] = 100.0
    v[:, :, 150:] = 100.0
    kw = dict(sm_scale=0.125, kv_valid=150, block_q=128, block_k=256, single=True,
              lite=True)
    want = np.asarray(jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    got = tfv.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lite_nan_tail_contributes_nothing(dtype):
    """NaN in K and V at or past kv_valid: the lite output is finite and
    equals the output with zeros there (on the TPU, 0 * NaN would poison P V;
    the port never reads those keys)."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(np.random.default_rng(3),
                                                            2, 4, 2, 300, 64))
    k0, v0 = k.clone(), v.clone()
    k0[:, :, 237:], v0[:, :, 237:] = 0.0, 0.0
    k[:, :, 237:], v[:, :, 237:] = float("nan"), float("nan")
    got = tfv.attention_lite(q, k, v, sm_scale=0.125, kv_valid=237)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, tfv.attention_lite(q, k0, v0, sm_scale=0.125, kv_valid=237))


def _chunked(q, k, v, *, exp2=False, pexp16=False, lite=False, fault=None, chunk=64):
    """The bf16 one-shot kernel's arithmetic in plain PyTorch: keys in chunks
    of 64, running max and sum in float32, p (under pexp16 also s - m)
    rounded to bf16 against the running max, the row sum over the rounded p
    under pexp16 or lite. ``fault`` plants a bug."""
    bf = torch.bfloat16
    e = torch.exp2 if exp2 else torch.exp
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
        alpha = torch.ones_like(m) if fault == "no_rescale" else e(m - mn)
        x = s - mn
        p = e(x.to(bf).float()).to(bf).float() if pexp16 else e(x)
        l = l * alpha + (p.to(bf).float() if pexp16 or lite else p).sum(-1, keepdim=True)
        acc = acc * alpha + p.to(bf).float() @ vf[:, :, k0:k0 + chunk]
        m = mn
    return (acc / l).to(bf)


@pytest.mark.parametrize("variant", ["lite", "pexp16", "exp2", "pexp16 exp2"])
@pytest.mark.parametrize("fault", [None, "drop_last_chunk", "no_rescale"])
def test_bf16_variant_tolerance_separates_faults(variant, fault):
    """chip_smoke's phase-2 tolerance for the variants at the encoder's T and
    d (pexp16 with its P_ROUND * P|V| term, Q pre-scaled by LOG2E under exp2)
    admits the kernel's arithmetic, rounded against running maxima, and
    rejects a dropped chunk or a missing rescale by a wide margin."""
    atol, rtol = chip_smoke.ATTN_TOL["bfloat16"]
    q, k, v = chip_smoke._attn_case("cpu", torch.bfloat16, 1, 4, 4, 1500, 64, 1500, True,
                                    seed=10)
    exp2, pexp16, lite = "exp2" in variant, "pexp16" in variant, variant == "lite"
    if exp2:
        q = q * torch.tensor(tfa.LOG2E, dtype=torch.bfloat16).item()
    if lite:
        want = tfv.attention_lite_plain(q, k, v, sm_scale=1.0).float()
    else:
        want = tfa.attention_single_plain(q, k, v, exp2=exp2, pexp16=pexp16).float()
    tol = atol + rtol * want.abs()
    if pexp16:
        tol = tol + chip_smoke.P_ROUND * tfa.attention_single_plain(
            q, k, v.abs(), exp2=exp2, pexp16=True).float()
    got = _chunked(q, k, v, exp2=exp2, pexp16=pexp16, lite=lite, fault=fault).float()
    used = ((got - want).abs() / tol).max().item()
    if fault is None:
        assert used <= 0.5
    else:
        assert used >= 10.0


@pytest.mark.parametrize("option", ["pexp16", "lite"])
@pytest.mark.parametrize("kernel", ["follows", "ignores"])
def test_option_case_tells_a_flag_apart(option, kernel):
    """chip_smoke's option case: the one-shot kernel's bf16 arithmetic
    (rounded against running maxima) under pexp16 or lite passes
    ``option_followed``; a kernel that ignores the flag fails it, which the
    tolerance of the random cases cannot show."""
    q, k, v = chip_smoke._option_case("cpu", torch.bfloat16, H=2)
    want_off = tfa.attention_single_plain(q, k, v)
    if option == "lite":
        want = tfv.attention_lite_plain(q, k, v, sm_scale=1.0)
    else:
        want = tfa.attention_single_plain(q, k, v, pexp16=True)
    assert torch.equal(want, torch.ones_like(want))
    assert torch.equal(want_off, torch.full_like(want, 0.99609375))
    off = _chunked(q, k, v)
    on = _chunked(q, k, v, **{option: True}) if kernel == "follows" else off
    ok, _ = chip_smoke.option_followed(on, off, want, want_off)
    assert ok == (kernel == "follows")


def test_option_case_float32_pexp16_step():
    """In float32 the option case moves pexp16's output 3.1e-3 (relative)
    off the default, far past the float32 tolerance; lite computes the
    default there."""
    q, k, v = chip_smoke._option_case("cpu", torch.float32, H=2)
    off = tfa.attention_single_plain(q, k, v)
    on = tfa.attention_single_plain(q, k, v, pexp16=True)
    np.testing.assert_allclose(off.numpy(), 1.0 / (1 + 1499 * np.exp(-0.69)), rtol=1e-5)
    np.testing.assert_allclose(on.numpy(), 1.0 / 750.5, rtol=1e-6)
    assert torch.equal(tfv.attention_lite_plain(q, k, v, sm_scale=1.0), off)
    assert chip_smoke.option_followed(on, off, on, off)[0]
    assert not chip_smoke.option_followed(off, off, on, off)[0]


@pytest.mark.parametrize("single,lite,causal,block_k,Tk,d,want", [
    (True, True, False, 1536, 1500, 64, "lite"),      # the encoder, lite on
    (True, True, False, 1536, 1500, 128, "single"),   # d 128: no pad lane
    (True, False, False, 1536, 1500, 64, "single"),
    (False, True, False, 1536, 1500, 64, "blockwise"),
    (True, False, False, 512, 1500, 64, "blockwise"),  # keys past one tile
    (True, True, True, 512, 300, 64, "causal"),
    (True, False, False, 512, 300, 64, "single"),      # block_k shrinks to 512
])
def test_dispatch_follows_jax(single, lite, causal, block_k, Tk, d, want):
    assert tfv.dispatch(Tk, d, causal=causal, block_k=block_k, single=single,
                        lite=lite) == want


def test_switch_defaults_and_reader():
    assert tfv.attention_variants() == tfv.AttentionVariants()
    assert tfv.AttentionVariants() == tfv.AttentionVariants(True, False, False, False, False)
    tfv.set_attention_variants(single=False, exp2=True)
    try:
        assert tfv.attention_variants() == tfv.AttentionVariants(single=False, exp2=True)
    finally:
        tfv.set_attention_variants()
    assert tfv.attention_variants() == tfv.AttentionVariants()


def test_variant_wrappers_reject_bad_input():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        tfv.attention_lite(q, q, q, sm_scale=1.0, kv_valid=9)
    with pytest.raises(ValueError):
        tfv.flash_attention_nopad(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64),
                                  sm_scale=1.0)
    with pytest.raises(ValueError):
        tfa.attention_blockwise(q, q, q, 1.0, kv_valid=0)
    with pytest.raises(ValueError):
        tfa.attention_causal(q, torch.zeros(1, 2, 9, 64), torch.zeros(1, 2, 9, 64), 1.0)
    m = torch.empty(1, 2, 8, 64, device="meta")
    for fn in (lambda: tfv.attention_lite(m, m, m, sm_scale=1.0),
               lambda: tfv.flash_attention_nopad(m, m, m, sm_scale=1.0),
               lambda: tfa.attention_blockwise(m, m, m, 1.0)):
        with pytest.raises(ValueError):
            fn()
    assert (tfv.attention_lite.launches, tfv.flash_attention_nopad.launches,
            tfa.attention_blockwise.launches) == (0, 0, 0)
