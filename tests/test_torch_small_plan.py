"""The launch plans of the weight-streaming kernels in fast mode, from shapes
alone: the dequantizing matmul's at M <= 8 (ops.quant_matmul.stream_plan:
column groups of 256 and K splits of whole 32-row groups) and the one-launch
SwiGLU's at M <= 64 (ops.fused_mlp.swiglu_plan: phase A's 16-column units
of I, phase B's column tiles and splits of Wd, shared memory, the reckoned
traffic). The kernels themselves run only on the card
(tests/test_torch_cuda.py); these need no device."""

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


def _covered_once(ranges, size, step):
    """The ranges, in order, tile [0, size) in whole ``step``s, each once."""
    cells = [c for a, b in ranges for c in range(a // step, b // step)]
    assert all(a % step == 0 and b % step == 0 and a < b for a, b in ranges)
    return sorted(cells) == list(range(size // step))


@pytest.mark.parametrize("K,I,D", MLP_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 7, 8, 9, 33, 64])
@pytest.mark.parametrize("sms", SMS)
def test_swiglu_plan_covers_every_unit_of_i_once_and_evenly(K, I, D, M, sms):
    plan = fm.swiglu_plan(M, K, I, D, sms)
    (P,) = plan["grid"]
    # one cooperative CTA (or two, from 9 to 32 rows) an SM
    assert P == sms * (2 if 8 < M <= 32 else 1) == len(plan["phase_a"])
    # phase A: every 16-column unit of I in exactly one pass of one CTA; the
    # CTAs within one unit of each other, a pass at most 12 units (one pass
    # at M <= 8) and within its ring slot
    passes = [r for cta in plan["phase_a"] for r in cta]
    assert _covered_once(passes, I, 16)
    owned = [sum(b - a for a, b in cta) // 16 for cta in plan["phase_a"]]
    assert max(owned) - min(owned) <= 1
    for cta in plan["phase_a"]:
        units = sum(b - a for a, b in cta) // 16
        assert len(cta) == (min(1, units) if M <= 8 else -(-units // 12))
        assert all((b - a) // 16 <= plan["units_a"] for a, b in cta)
    # phase B: every (row of I, column of D) of Wd in exactly one task, at
    # most one task a CTA; the columns in tiles of 16 per warp, the rows in
    # whole 32-row groups
    tasks = plan["phase_b"]
    assert len(tasks) == plan["tiles"] * plan["splits"] <= P
    cells = [(r, c) for (c0, c1), (r0, r1) in tasks
             for r in range(r0 // 32, r1 // 32) for c in range(c0 // 16, c1 // 16)]
    assert len(cells) == len(set(cells)) == (I // 32) * (D // 16)
    assert all(c1 - c0 <= 16 * plan["warps"] and r0 % 32 == 0 for (c0, c1), (r0, _) in tasks)
    # a CTA's shared memory within the card's 227 KB
    assert plan["smem"] <= 232448


@pytest.mark.parametrize("M", [1, 8, 9, 64])
@pytest.mark.parametrize("packed,mins", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_swiglu_plan_stays_within_its_budgets(M, packed, mins):
    K, I, D = 3584, 18944, 3584
    plan = fm.swiglu_plan(M, K, I, D, 132, packed, mins)
    S = plan["splits"]
    # the scratch: gated in bf16, the splits' float32 sums where I is split
    assert plan["scratch"] == 2 * M * I + (4 * S * M * D if S > 1 else 0)
    assert plan["smem"] <= 232448
    # each weight byte read once: the reckoned traffic (weights, x and y once,
    # every scratch byte and ticket once) within 1.05 x the weight bytes plus
    # x and y
    weights = fm.weight_bytes(K, I, D, packed, mins)
    assert plan["weights"] == weights
    assert plan["traffic"] <= 1.05 * weights + 2 * M * (K + D)
    # the splits fill the card: every CTA a task, as many as the budget keeps
    assert plan["tiles"] * S <= plan["grid"][0] < plan["tiles"] * (S + 1) or \
        2 * M * I + 4 * (S + 1) * M * D + plan["tickets"] > 0.05 * weights


@pytest.mark.parametrize("M,K,I,D", [(65, 3584, 18944, 3584), (0, 3584, 18944, 3584),
                                     (1, 3600, 18944, 3584), (1, 3584, 18960, 3584),
                                     (1, 3584, 18944, 3592), (8, 11264, 18944, 3584),
                                     (9, 3584, 18944, 524288)])
def test_swiglu_plan_refuses(M, K, I, D):
    # K = 11264 at 8 rows: x staged whole beside the warps' rings passes the
    # 227 KB of shared memory; D = 524288: more column tiles than tickets
    with pytest.raises(ValueError):
        fm.swiglu_plan(M, K, I, D, 132)
