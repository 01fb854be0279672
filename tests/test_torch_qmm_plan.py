"""The launch plans of the quantized matmul kernels (csrc/quant_matmul.cu and
csrc/quant_matmul_int8.cu), from shapes, types and addresses alone: which
kernel a call takes, its grid and the buffers the wrapper allocates, and what
is refused rather than copied. The kernels themselves run only on the card
(tests/test_torch_cuda.py); these need no device."""

import pytest
import torch

from qwen2_audio_tpu_torch.ops import quant_matmul as qm
from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as q8
from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as q4b

SMS = 132


def _weight(K, N, packed=False, group=32, scale_dtype=torch.float16):
    q = torch.zeros((K // 2 if packed else K, N), dtype=torch.uint8 if packed else torch.int8)
    return q, torch.ones((K // group, N), dtype=scale_dtype)


@pytest.mark.parametrize("M,fast,dtype,kernel,scratch", [
    (1, True, torch.bfloat16, "small", 4 * 5 * 1 * 1296),
    (8, False, torch.float32, "small", 4 * 5 * 8 * 1296),
    (9, True, torch.bfloat16, "wgmma", 0),
    (65, True, torch.float32, "wgmma", 2 * 65 * 1312),
    (753, False, torch.float32, "fma", 0),
    (1500, True, torch.bfloat16, "wgmma", 0),
])
def test_dequantizing_plan_picks_the_kernel_grid_and_scratch(M, fast, dtype, kernel, scratch):
    """M <= 8 streams the weight (split over K, float32 partial sums in
    scratch): in fast mode on the tensor cores, in exact mode in float32;
    above, the 128 x 128 tile, whose grid walks M first; float32 x in fast
    mode gets a bf16 copy, rounded once, for the TMA box."""
    K, N = 1312, 1296
    q, sc = _weight(K, N)
    x = torch.zeros(M, K, dtype=dtype)
    plan = qm.launch_plan("t", x, q, sc, 32, fast, SMS)
    assert plan["kernel"] == kernel and plan["scratch"] == scratch
    assert (plan["M"], plan["K"], plan["N"], plan["bn"]) == (M, K, N, N)
    if kernel == "small":
        # at most K / 256 splits (41 / 8 here): fast mode, 6 column groups of
        # 256 (stream_plan); exact mode, about four blocks of 128 per SM
        cols = 256 if fast else 128
        assert plan["grid"] == (-(-N // cols), 5) and plan["ksplit"] == 5
    else:
        assert plan["grid"] == (-(-M // 128), -(-N // 128), 1) and plan["ksplit"] == 1


@pytest.mark.parametrize("M,K,N,dtype,ksplit", [
    (752, 18944, 3584, torch.bfloat16, 2),   # prefill down: 168 tiles on 132 SMs
    (752, 3584, 3584, torch.float32, 2),     # prefill o
    (752, 3584, 4608, torch.bfloat16, 1),    # prefill qkv: 216 tiles
    (752, 3584, 37888, torch.bfloat16, 1),   # gate_up: 888 tiles
    (1500, 1280, 1280, torch.bfloat16, 1),   # encoder out: one wave
    (752, 3520, 3584, torch.bfloat16, 1),    # 55 stages: no even split
])
def test_fast_tile_splits_k_where_the_last_wave_is_thin(M, K, N, dtype, ksplit):
    q, sc = _weight(K, N)
    plan = qm.launch_plan("t", torch.zeros(M, K, dtype=dtype), q, sc, 32, True, SMS)
    assert plan["ksplit"] == ksplit == qm.split_tiles(M, K, N, SMS)
    assert plan["grid"][2] == ksplit
    want = (4 * ksplit * M * N if ksplit > 1 else 0) + (2 * M * K if dtype == torch.float32 else 0)
    assert plan["scratch"] == want
    exact = qm.launch_plan("t", torch.zeros(M, K), q, sc, 32, False, SMS)
    assert exact["kernel"] == "fma" and exact["ksplit"] == 1 and exact["scratch"] == 0


def test_dequantizing_plan_of_panels_reads_the_panel_width():
    K, N, bn = 1312, 1296, 48
    q, sc = _weight(K, N)
    pw = qm.panelize_weight({"qs": q, "scales": sc}, bn)
    plan = qm.launch_plan("t", torch.zeros(752, K, dtype=torch.bfloat16), pw["qs_p"],
                          pw["scales_p"], 32, True, SMS)
    assert (plan["N"], plan["bn"], plan["grid"]) == (N, bn, (6, 11, 1))


@pytest.mark.parametrize("M,kernel", [(1, "small"), (9, "wgmma"), (1500, "wgmma")])
def test_integer_plan_picks_the_kernel_and_buffers(M, kernel):
    K, N = 1312, 1296
    q, sc = _weight(K, N)
    plan = q8.launch_plan("t", torch.zeros(M, K, dtype=torch.bfloat16), q, sc, SMS)
    assert plan["kernel"] == kernel
    if kernel == "small":
        assert plan["buffers"] == {"scratch": ((5, 1, N), torch.float32)}
    else:
        assert plan["grid"] == (-(-M // 128), -(-N // 128))
        assert plan["buffers"] == {"xq": ((M, K), torch.int8),
                                   "sx_t": ((K // 32, -(-M // 4) * 4), torch.float32)}


def _refusals(plan_of):
    """(what, call) pairs that a launch plan must refuse."""
    K, N = 256, 128
    q, sc = _weight(K, N)
    buf = torch.zeros(2 * K + 8, dtype=torch.bfloat16)
    return [
        ("float16 x", lambda: plan_of(torch.zeros(16, K, dtype=torch.float16), q, sc)),
        ("float64 scales", lambda: plan_of(torch.zeros(16, K), q, sc.double())),
        ("x not contiguous", lambda: plan_of(torch.zeros(K, 16).t(), q, sc)),
        ("x not 16-byte aligned", lambda: plan_of(buf[1:1 + 2 * K].view(2, K), q, sc)),
        ("weight view not contiguous", lambda: plan_of(
            torch.zeros(16, K), torch.zeros(K, 2 * N, dtype=torch.int8)[:, ::2], sc)),
        ("N not a multiple of 16", lambda: plan_of(
            torch.zeros(16, K), q[:, :120].contiguous(), sc[:, :120].contiguous())),
    ]


@pytest.mark.parametrize("i", range(6))
def test_plans_refuse_rather_than_copy(i):
    for plan_of in (lambda x, q, sc: qm.launch_plan("t", x, q, sc, 32, True, SMS),
                    lambda x, q, sc: q8.launch_plan("t", x, q, sc, SMS)):
        what, call = _refusals(plan_of)[i]
        with pytest.raises(ValueError):
            call()


def test_dequantizing_plan_refuses_a_k_off_the_32_grid():
    """K = 48 in 16-groups passes the shape check and stops at the kernel's."""
    q, sc = _weight(48, 128, group=16)
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.launch_plan("t", torch.zeros(16, 48), q, sc, 16, True, SMS)


@pytest.mark.parametrize("fn,form", [("quant_linear", "qs"), ("quant_linear", "qs4"),
                                     ("quant_linear_int8", "qs"), ("q4b", "qs4b")])
def test_linear_layers_hand_the_kernels_contiguous_rows(fn, form):
    """The linear layers make x's rows contiguous themselves (the entries
    refuse a strided x): a transposed view gives the contiguous x's result."""
    g = torch.Generator().manual_seed(3)
    K, N = 256, 64
    qs = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    qw = {"qs": qs, "scales": torch.rand(K // 32, N, generator=g).half()}
    if form != "qs":
        qs4 = torch.randint(0, 256, (K // 2, N), generator=g, dtype=torch.uint8)
        qw = {"qs4": qs4, "scales": qw["scales"]}
        if form == "qs4b":
            qw = {"qs4b": q4b.pack_b32(qs4), "scales": qw["scales"]}
    xt = torch.randn(K, 12, generator=g).t()
    assert not xt.is_contiguous()
    run = {"quant_linear": qm.quant_linear, "quant_linear_int8": q8.quant_linear_int8,
           "q4b": q4b.quant_linear_q4b}[fn]
    assert torch.equal(run(xt, qw), run(xt.contiguous(), qw))
