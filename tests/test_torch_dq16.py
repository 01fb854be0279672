"""The bf16-domain dequant (``dq16``: each block scale rounded to bf16
before the multiply, fast mode) of the port's eight dequantizing entries and
of ``ops.linear`` (``set_dequant16``) against the JAX package's ``dq16``
kernels and its QA_Q4_DQ16 / QA_Q8_DQ16 gates (Pallas in interpret mode on
the CPU).

The JAX side is compiled with ``xla_allow_excess_precision`` off, so that
XLA keeps the bf16 rounding of q * bf16(s) that the kernel prescribes.
x is float32 (rounded to bf16 inside, as the fast mode does; the output is
float32), so that a weight's bf16 rounding shows: tolerance rtol 1e-5 and
atol 1e-5 of max|JAX| (only the order of the float32 sums differs); a
missing bf16 cast of the scale moves the outputs by about 3e-3 of the
largest (``test_tolerance_catches_a_missing_scale_cast``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu.ops import quant_matmul as jqm
from qwen2_audio_tpu.quant import qparams as jq
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.ops import fused_mlp as tfm
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.ops import quant_matmul as tqm

K, N, BN, L = 256, 256, 128, 2
REL = 1e-5


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    monkeypatch.delenv("QA_Q4_DQ16", raising=False)
    monkeypatch.delenv("QA_Q8_DQ16", raising=False)
    yield
    tl.set_dequant16()
    tl.set_group_matmul_mode(None)
    jl.set_group_matmul_mode(None)


def _strict(fn, *args):
    args = [jnp.asarray(a) for a in args]
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args), np.float32)


def _host(fmt, seed=0, k=K, n=N):
    w = (0.05 * np.random.default_rng(seed).standard_normal((k, n))).astype(np.float32)
    return jq.quantize_array_for_device(w, JType[fmt], to_device=False,
                                        form=jq.Q4Form(scale="f16"))


def _weights(fmt, stacked=False, panel=False):
    """(JAX dict, port dict) of one weight, or of L stacked ones; panels of
    width BN with ``panel``."""
    if stacked:
        hosts = [_host(fmt, seed=10 + i) for i in range(L)]
        host = {k: np.stack([h[k] for h in hosts]) for k in hosts[0]}
    else:
        host = _host(fmt)
    jw = {k: jnp.asarray(v) for k, v in host.items()}
    tw = quant_params_from_jax(host)
    if panel:
        if stacked:
            per = [jqm.panelize_weight({k: v[i] for k, v in jw.items()}, BN)
                   for i in range(L)]
            jw = {k: jnp.stack([d[k] for d in per]) for k in per[0]}
        else:
            jw = jqm.panelize_weight(jw, BN)
        tw = tqm.panelize_weight(tw, BN)
    return jw, tw


def _x(m, seed=0, k=K):
    return np.random.default_rng(100 + seed).standard_normal((m, k)).astype(np.float32)


def _close(got, want):
    got = got.float().numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * top)


ENTRIES = [   # (entry, format, stacked, panel)
    ("quant_matmul", "Q8_0", False, False),
    ("quant_matmul_stacked", "Q8_0", True, False),
    ("quant_matmul_panel", "Q8_0", False, True),
    ("quant_matmul_panel_stacked", "Q8_0", True, True),
    ("quant_matmul4", "Q4_0", False, False),
    ("quant_matmul4", "Q4_1", False, False),
    ("quant_matmul4_stacked", "Q4_0", True, False),
    ("quant_matmul4_stacked", "Q4_1", True, False),
    ("quant_matmul_panel4", "Q4_0", False, True),
    ("quant_matmul_panel4", "Q4_1", False, True),
    ("quant_matmul_panel4_stacked", "Q4_0", True, True),
    ("quant_matmul_panel4_stacked", "Q4_1", True, True),
]


def _entry_args(name, fmt, stacked, panel):
    jw, tw = _weights(fmt, stacked, panel)
    packed = "4" in name
    qkey = ("qs4" if packed else "qs") + ("_p" if panel else "")
    skey = "scales_p" if panel else "scales"
    kw = {"off": 8 if fmt == "Q4_0" else 0} if packed else {}
    return (jw[qkey], jw[skey]), (tw[qkey], tw[skey]), kw


@pytest.mark.parametrize("m", [1, 40])
@pytest.mark.parametrize("name,fmt,stacked,panel", ENTRIES)
def test_entry_with_dq16_matches_jax(name, fmt, stacked, panel, m):
    """Each of the eight entries with dq16 (q8_0, symmetric q4_0, and q4_1,
    whose min term the caller adds) against the JAX entry with dq16."""
    (jq_, js), (tq, ts), kw = _entry_args(name, fmt, stacked, panel)
    x = _x(m)
    li = (1,) if stacked else ()
    jentry, tentry = getattr(jqm, name), getattr(tqm, name)
    want = _strict(lambda x, q, s: jentry(x, q, s, *(jnp.int32(i) for i in li), fast=True,
                                          dq16=True, **kw), x, jq_, js)
    got = tentry(torch.from_numpy(x), tq, ts, *li, fast=True, dq16=True, **kw)
    _close(got, want)
    assert getattr(tqm, name).launches == 0


@pytest.mark.parametrize("name,fmt,stacked,panel", [ENTRIES[0], ENTRIES[6]])
def test_tolerance_catches_a_missing_scale_cast(name, fmt, stacked, panel):
    """The port's entry without dq16 (the scale multiplied in float32) is far
    outside the tolerance against JAX's dq16."""
    (jq_, js), (tq, ts), kw = _entry_args(name, fmt, stacked, panel)
    x = _x(5)
    li = (1,) if stacked else ()
    jentry, tentry = getattr(jqm, name), getattr(tqm, name)
    want = _strict(lambda x, q, s: jentry(x, q, s, *(jnp.int32(i) for i in li), fast=True,
                                          dq16=True, **kw), x, jq_, js)
    got = tentry(torch.from_numpy(x), tq, ts, *li, fast=True, **kw)
    with pytest.raises(AssertionError):
        _close(got, want)
    moved = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert moved > 50 * REL


def test_dq16_only_in_fast_mode():
    """dq16 changes nothing in the exact mode, as in JAX."""
    _, tw = _weights("Q8_0")
    x = torch.from_numpy(_x(3))
    assert torch.equal(tqm.quant_matmul(x, tw["qs"], tw["scales"], dq16=True),
                       tqm.quant_matmul(x, tw["qs"], tw["scales"]))


FORMS = [("Q8_0", False), ("Q8_0", True), ("Q4_0", False), ("Q4_0", True),
         ("Q4_1", False), ("Q4_1", True)]


def _gates(monkeypatch, q4, q8):
    """JAX's gates, and both packages in the bf16 group-matmul mode."""
    monkeypatch.setenv("QA_Q4_DQ16", "1" if q4 else "0")
    monkeypatch.setenv("QA_Q8_DQ16", "1" if q8 else "0")
    jl.set_group_matmul_mode("bf16")
    tl.set_group_matmul_mode("bf16")


@pytest.mark.parametrize("q4,q8", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("fmt,panel", FORMS)
def test_linear_with_set_dequant16_matches_jax(fmt, panel, q4, q8, monkeypatch):
    """``linear`` under set_dequant16 against JAX's ``linear`` under
    QA_Q4_DQ16 / QA_Q8_DQ16: q4 takes the packed forms, q8 the int8 forms;
    q4_1's min term (added outside the kernel on both sides) and a bias."""
    _gates(monkeypatch, q4, q8)
    jw, tw = _weights(fmt, panel=panel)
    b = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    jw["b"], tw["b"] = jnp.asarray(b), torch.from_numpy(b)
    x = _x(5, seed=1)
    want = _strict(lambda x: jl.linear(x, jw), x)
    tl.set_dequant16(q4=q4, q8=q8)
    got = tl.linear(torch.from_numpy(x), tw)
    _close(got, want)
    tl.set_dequant16()
    packed = fmt != "Q8_0"
    off = tl.linear(torch.from_numpy(x), tw)
    assert torch.equal(got, off) == (not (q4 if packed else q8))


@pytest.mark.parametrize("q4,q8", [(True, False), (False, True)])
@pytest.mark.parametrize("fmt,panel", FORMS)
def test_linear_at_with_set_dequant16_matches_jax(fmt, panel, q4, q8, monkeypatch):
    _gates(monkeypatch, q4, q8)
    jw, tw = _weights(fmt, stacked=True, panel=panel)
    x = _x(5, seed=2)
    want = _strict(lambda x: jl.linear_at(x, jw, jnp.int32(1)), x)
    tl.set_dequant16(q4=q4, q8=q8)
    _close(tl.linear_at(torch.from_numpy(x), tw, 1), want)


def test_set_dequant16_reader_and_exact_mode():
    assert tl.dequant16() == (False, False)
    _, tw = _weights("Q4_0")
    x = torch.from_numpy(_x(2))
    tl.set_group_matmul_mode("dequant")
    off = tl.linear(x, tw)
    tl.set_dequant16(q4=True, q8=True)
    assert tl.dequant16() == (True, True)
    assert torch.equal(tl.linear(x, tw), off)     # the exact mode takes no dq16


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_fused_mlp_at_ignores_dequant16(fmt):
    """The one-launch SwiGLU has no dq16 (neither has JAX's fused_mlp)."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_quant_linear
    g = torch.Generator().manual_seed(4)
    gu = random_quant_linear(g, (L, 256, 2 * 512), fmt)
    dn = random_quant_linear(g, (L, 512, 256), fmt)
    x = torch.randn(1, 256, generator=g)
    off = tl.fused_mlp_at(x, gu, dn, 1)
    assert off is not None
    tl.set_dequant16(q4=True, q8=True)
    assert torch.equal(tl.fused_mlp_at(x, gu, dn, 1), off)
    assert sum(e.launches for e in tfm.ENTRIES) == 0
