"""The launch plans of the two M <= 8 weight-streaming kernels in fast mode,
from shapes alone: the dequantizing matmul's (ops.quant_matmul.stream_plan:
column groups of 256 and K splits of whole 32-row groups) and the one-launch
SwiGLU's (ops.fused_mlp.swiglu_plan: slices of I in 32-column units). The
kernels themselves run only on the card (tests/test_torch_cuda.py); these
need no device."""

import pytest
import torch

from qwen2_audio_tpu_torch.ops import fused_mlp as fm
from qwen2_audio_tpu_torch.ops import quant_matmul as qm

# the 7B decoder's decode shapes, the lm_head, the encoder's, and ragged ones
MATMUL_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 156032),
                 (1280, 3840), (5120, 1280), (1312, 1296), (32, 16), (96, 48)]
SMS = (132, 114, 78)


@pytest.mark.parametrize("K,N", MATMUL_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 7, 8])
@pytest.mark.parametrize("sms", SMS)
def test_stream_plan_covers_every_column_and_k_group_once(K, N, M, sms):
    plan = qm.stream_plan(M, K, N, sms)
    groups, ks = plan["grid"]
    assert plan["ksplit"] == ks == len(plan["k_ranges"])
    # column groups of 4 warps x 64 columns: every column in exactly one
    assert (groups - 1) * 256 < N <= groups * 256
    # the K ranges tile [0, K) in order, in whole 32-row groups
    edges = [a for a, _ in plan["k_ranges"]] + [plan["k_ranges"][-1][1]]
    assert edges[0] == 0 and edges[-1] == K
    assert all(a < b and a % 32 == 0 for a, b in zip(edges, edges[1:]))
    covered = [k for a, b in plan["k_ranges"] for k in range(a // 32, b // 32)]
    assert covered == list(range(K // 32))


@pytest.mark.parametrize("K,N", MATMUL_SHAPES)
@pytest.mark.parametrize("M", [1, 7, 8])
@pytest.mark.parametrize("sms", SMS)
def test_stream_plan_loads_blocks_evenly_within_budget(K, N, M, sms):
    plan = qm.stream_plan(M, K, N, sms)
    groups, ks = plan["grid"]
    sizes = [b - a for a, b in plan["k_ranges"]]
    assert max(sizes) - min(sizes) <= 32        # no split a group more than another
    assert M * max(sizes) <= 16384              # a block's x in bf16: 32 KB at most
    # about five blocks per SM and at least 4 splits, each split at least 8
    # groups of K and at most 28 splits, unless x's budget asks for more
    least = -(-(K // 32) // (16384 // (32 * M)))
    assert ks == least or ks <= max(1, min(max(4, round(5 * sms / groups)), K // 256, 28))
    assert ks >= min(4, K // 256) or groups > 4096
    # two blocks fit an SM's 228 KB of shared memory
    assert 2 * (plan["smem"] + 1024) <= 233472
    assert plan["scratch"] == (4 * ks * M * N if ks > 1 else 0)


@pytest.mark.parametrize("K,N,bn", [(3584, 4608, 16), (3584, 4608, 48), (3584, 4608, 128),
                                    (3584, 37888, 1024), (3584, 156032, 128), (1312, 1296, 16),
                                    (1312, 1296, 48)])
@pytest.mark.parametrize("M,packed", [(1, False), (7, True), (8, False)])
def test_stream_plan_is_the_same_for_panels(K, N, bn, M, packed):
    q = torch.zeros((K // 2 if packed else K, N), dtype=torch.uint8 if packed else torch.int8)
    sc = torch.ones((K // 32, N), dtype=torch.float16)
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    strided = qm.launch_plan("t", x, q, sc, 32, True, 132)
    pw = qm.panelize_weight({"qs4" if packed else "qs": q, "scales": sc}, bn)
    panel = qm.launch_plan("t", x, pw["qs4_p" if packed else "qs_p"], pw["scales_p"], 32, True,
                           132)
    assert strided["kernel"] == panel["kernel"] == "small"
    for key in ("grid", "ksplit", "k_ranges", "scratch", "smem"):
        assert strided[key] == panel[key]
    assert (strided["bn"], panel["bn"]) == (N, bn)


@pytest.mark.parametrize("M,K,N", [(9, 3584, 4608), (0, 3584, 4608), (1, 3600, 4608),
                                   (1, 16, 4608), (1, 3584, 4600)])
def test_stream_plan_refuses(M, K, N):
    with pytest.raises(ValueError):
        qm.stream_plan(M, K, N, 132)


MLP_SHAPES = [(3584, 18944, 3584), (1536, 8960, 1536), (512, 1056, 528), (64, 96, 64),
              (256, 32, 16)]


@pytest.mark.parametrize("K,I,D", MLP_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 7, 8, 9, 33, 64])
@pytest.mark.parametrize("sms", SMS)
def test_swiglu_plan_covers_every_unit_of_i_once_and_evenly(K, I, D, M, sms):
    plan = fm.swiglu_plan(M, K, I, D, sms)
    (P,) = plan["grid"]
    assert P == len(plan["slices"]) and 1 <= P <= min(sms, I // 32)
    edges = [a for a, _ in plan["slices"]] + [plan["slices"][-1][1]]
    assert edges[0] == 0 and edges[-1] == I
    assert all(a < b and a % 32 == 0 for a, b in zip(edges, edges[1:]))
    widths = [b - a for a, b in plan["slices"]]
    assert max(widths) - min(widths) <= 32      # SMs within one unit of each other


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("packed,mins", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_swiglu_plan_stays_within_its_budgets(M, packed, mins):
    K, I, D = 3584, 18944, 3584
    plan = fm.swiglu_plan(M, K, I, D, 132, packed, mins)
    (P,) = plan["grid"]
    assert plan["scratch"] == 4 * P * M * D <= 64 << 20
    assert plan["smem"] <= 232448
    # every pair of 64-column blocks of a slice between two barriers where
    # shared memory holds them (at 64 rows the slices widen past that)
    widest = max(b - a for a, b in plan["slices"]) // 32
    assert plan["ucap"] == (-(-widest // 2) if M <= 8 else 3)
    # at decode rows every SM takes a slice; at 64 rows the budget narrows them
    assert P == (132 if M <= 8 else (64 << 20) // (M * D * 4))


@pytest.mark.parametrize("M,K,I,D", [(65, 3584, 18944, 3584), (0, 3584, 18944, 3584),
                                     (1, 3600, 18944, 3584), (1, 3584, 18960, 3584),
                                     (1, 3584, 18944, 3592), (8, 11264, 18944, 3584)])
def test_swiglu_plan_refuses(M, K, I, D):
    with pytest.raises(ValueError):
        fm.swiglu_plan(M, K, I, D, 132)
