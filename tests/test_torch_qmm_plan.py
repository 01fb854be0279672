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
    (9, True, torch.bfloat16, "wgmma", 4 * 5 * 9 * 1296),
    (65, True, torch.float32, "wgmma", 4 * 5 * 65 * 1296 + 2 * 65 * 1312),
    (753, False, torch.float32, "fma", 0),
    (1500, True, torch.bfloat16, "wgmma", 0),
])
def test_dequantizing_plan_picks_the_kernel_grid_and_scratch(M, fast, dtype, kernel, scratch):
    """M <= 8 streams the weight (split over K, float32 partial sums in
    scratch): in fast mode on the tensor cores, in exact mode in float32;
    above, in fast mode the persistent tile (tile_plan: one CTA a unit up to
    the SM count, K split where the 11 column tiles leave most SMs idle),
    in exact mode the 128 x 128 float32 tile, whose grid walks M first;
    float32 x in fast mode gets a bf16 copy, rounded once, for the TMA box."""
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
    elif kernel == "wgmma":
        tp = qm.tile_plan(M, K, N, SMS)
        assert plan["grid"] == (tp["ctas"],) and plan["ksplit"] == tp["ks"]
        assert plan["bm"] == tp["bm"] and plan["smem"] <= qm.SMEM_LIMIT
    else:
        assert plan["grid"] == (-(-M // 128), -(-N // 128)) and plan["ksplit"] == 1


# the fast M > 8 tile's shapes: the prefill's (qkv, o, gate_up, down), the
# encoder's (qkv, out, fc1, fc2), the lm_head and the ragged edge case (N a
# multiple of 16 and not of 128, K of 32 and not of the 64-deep stage)
_TILE_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (1280, 3840),
                (1280, 1280), (1280, 5120), (5120, 1280), (3584, 156032), (1312, 1296)]
_TILE_M = [9, 16, 17, 33, 64, 65, 128, 129, 256, 257, 752, 753, 1500]


@pytest.mark.parametrize("M", _TILE_M)
@pytest.mark.parametrize("K,N", _TILE_SHAPES)
def test_fast_tile_units_cover_the_output_once(M, K, N):
    """The CTAs' units (cta_units) cover every (m tile, n tile, split) of the
    product exactly once; the tiles cover every row and column, the splits
    every stage of K in whole 64-deep stages, at least 4 each where K is
    split; at most one CTA an SM; the CTAs at work at once share weight
    columns (units walk M, then the splits, then N)."""
    plan = qm.tile_plan(M, K, N, SMS)
    mt, nt = plan["tiles"]
    bm, ks = plan["bm"], plan["ks"]
    assert mt * bm >= M > (mt - 1) * bm and nt * 128 >= N > (nt - 1) * 128
    assert plan["units"] == mt * nt * ks and plan["ctas"] == min(plan["units"], SMS)
    seen = [u for b in range(plan["ctas"]) for u in qm.cta_units(plan, b)]
    assert sorted(seen) == sorted((m, n, s) for m in range(mt) for n in range(nt)
                                  for s in range(ks))
    assert len(seen) == len(set(seen))
    ranges = plan["k_ranges"]
    assert len(ranges) == ks and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b and a % 64 == 0 for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(ks - 1))
    if ks > 1:
        assert all(b - a >= 4 * 64 for a, b in ranges[:-1])
    first = {n for b in range(plan["ctas"]) for m, n, s in qm.cta_units(plan, b)[:1]}
    assert len(first) <= -(-plan["ctas"] // (mt * ks))


@pytest.mark.parametrize("M", _TILE_M)
@pytest.mark.parametrize("packed", [False, True])
def test_fast_tile_fits_the_card(M, packed):
    """A unit's rows hold M without wasting half of them up to 128 rows
    (16, 32, 64 or 128), and above are 128, 192 or 256; its ring fits the
    232448 bytes a block may use with at least 5 slots and at most 15 (the
    named barriers)."""
    plan = qm.tile_plan(M, 3584, 3584, SMS)
    bm = plan["bm"]
    if M <= 128:
        assert M <= bm < 2 * M
    else:
        assert bm in (128, 192, 256)
    ring, smem = qm.tile_ring(bm, packed)
    assert 5 <= ring <= 15 and smem <= qm.SMEM_LIMIT
    x = torch.zeros(M, 3584, dtype=torch.bfloat16)
    q, sc = _weight(3584, 3584, packed=packed)
    lp = qm.launch_plan("t", x, q, sc, 32, True, SMS)
    assert (lp["ring"], lp["smem"]) == (ring, smem)


@pytest.mark.parametrize("M,K,N,bm,ks", [
    (752, 3584, 37888, 256, 1),     # gate_up: 7 waves of 256 rows, not 9 of 192
    (752, 3584, 4608, 256, 1),      # prefill qkv: one wave of 108 units
    (752, 3584, 3584, 192, 1),      # prefill o: one wave of 112 units of 192 rows, not 84 of 256
    (752, 18944, 3584, 192, 1),     # prefill down
    (1500, 1280, 5120, 256, 1),     # fc1: two waves of 256 rows
    (1500, 1280, 3840, 192, 1),     # encoder qkv: two waves of 192 rows, as of 256
    (1500, 1280, 1280, 128, 1),     # encoder out: one wave of 120 units
    (1500, 5120, 1280, 256, 2),     # fc2: K in 2 for 120 units of 256 rows, not 120 of 128
    (64, 3584, 156032, 64, 1),      # the verify's lm_head: 1219 units
    (64, 3584, 37888, 64, 1),       # the verify's gate_up
    (64, 3584, 3584, 64, 4),        # the verify's o: 28 tiles, K in 4
    (64, 18944, 3584, 64, 4),       # the verify's down
    (9, 1312, 1296, 16, 5),         # 11 tiles, K in 5 of at least 4 stages
])
def test_fast_tile_width_and_split_of_the_main_shapes(M, K, N, bm, ks):
    plan = qm.tile_plan(M, K, N, SMS)
    assert (plan["bm"], plan["ks"]) == (bm, ks)


@pytest.mark.parametrize("M,K,N", [(8, 256, 128), (64, 48, 128), (64, 256, 120),
                                   (64, 0, 128), (64, 256, 0)])
def test_fast_tile_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    with pytest.raises(ValueError):
        qm.tile_plan(M, K, N, SMS)


def test_dequantizing_plan_of_panels_reads_the_panel_width():
    K, N, bn = 1312, 1296, 48
    q, sc = _weight(K, N)
    pw = qm.panelize_weight({"qs": q, "scales": sc}, bn)
    x = torch.zeros(752, K, dtype=torch.bfloat16)
    plan = qm.launch_plan("t", x, pw["qs_p"], pw["scales_p"], 32, True, SMS)
    assert (plan["N"], plan["bn"]) == (N, bn)
    # the plan depends on M, K and N alone: the strided weight's, bar the width
    strided = qm.launch_plan("t", x, q, sc, 32, True, SMS)
    assert {k: v for k, v in plan.items() if k != "bn"} == \
        {k: v for k, v in strided.items() if k != "bn"}
    assert plan["grid"] == (132,) and plan["ksplit"] == 2


@pytest.mark.parametrize("M,kernel", [(1, "small"), (9, "wgmma"), (1500, "wgmma")])
def test_integer_plan_picks_the_kernel_and_buffers(M, kernel):
    """At M <= 8 the one-launch kernel of small_plan, its split sums in a
    float32 (ks, M, N) buffer; above 8 rows, one persistent CTA an SM up to
    the unit count, over units of tile_plan's rows by 128 weight columns, no
    K split; xq as f16 values and sx transposed in whole 16-row blocks."""
    K, N = 1312, 1296
    q, sc = _weight(K, N)
    plan = q8.launch_plan("t", torch.zeros(M, K, dtype=torch.bfloat16), q, sc, SMS)
    assert plan["kernel"] == kernel
    if kernel == "small":
        small = q8.small_plan(M, K, N, SMS)
        assert {k: plan[k] for k in small} == small and small["ksplit"] > 1
        assert plan["buffers"] == {"partial": ((small["ksplit"], 1, N), torch.float32)}
    else:
        bm = plan["bm"]
        assert plan["tiles"] == (-(-M // bm), -(-N // 128)) and plan["ksplit"] == 1
        assert plan["grid"] == (min(plan["units"], SMS),)
        assert plan["buffers"] == {"xq": ((M, K), torch.float16),
                                   "sx_t": ((K // 32, -(-M // 16) * 16), torch.float32)}


# the integer tile's shapes: the decoder's (prefill), the encoder's and the
# ragged edge case (N a multiple of 16 and not of the unit, K of 32 and not of
# the stage)
_INT8_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584),
                (1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1312, 1296)]


@pytest.mark.parametrize("M", [9, 65, 129, 752, 753, 1500])
@pytest.mark.parametrize("K,N", _INT8_SHAPES)
def test_integer_tiles_cover_the_output_once(M, K, N):
    """The CTAs' unit lists (cta_units) cover every (m tile, n tile) of the
    output exactly once, the units cover every row and column, and the CTAs
    at work at once share weight columns (consecutive units walk M first)."""
    q, sc = _weight(K, N)
    plan = q8.launch_plan("t", torch.zeros(M, K, dtype=torch.bfloat16), q, sc, SMS)
    mt, nt = plan["tiles"]
    bm = plan["bm"]
    assert bm in q8.TILE_ROWS and mt * bm >= M and nt * 128 >= N
    assert (mt - 1) * bm < M and (nt - 1) * 128 < N and plan["units"] == mt * nt
    seen = [t for b in range(plan["grid"][0]) for t in q8.cta_units(plan, b)]
    assert sorted(seen) == sorted((m, n) for m in range(mt) for n in range(nt))
    first_wave = {u // mt for u in range(min(plan["grid"][0], mt * nt))}
    assert len(first_wave) <= -(-plan["grid"][0] // mt)


@pytest.mark.parametrize("M", [9, 752, 1500])
@pytest.mark.parametrize("K,N", _INT8_SHAPES)
def test_integer_plan_fits_the_card(M, K, N):
    """Shared memory within the 232448 bytes a block may use, as many CTAs
    as fill the card (one an SM) unless there are fewer units, and the unit's
    rows: up to 128 the least of 16, 32, 64, 128 that holds M, above 64 only
    where it ends the waves first (a stage costing bm + TILE_FIXED rows)."""
    for form, dtype in ((q8.STRIDED, torch.int8), (q8.PACKED, torch.uint8),
                        (q8.WORDS, torch.int32)):
        q = torch.zeros((K // q8._FORMS[form][1], N), dtype=dtype)
        sc = torch.ones((K // 32, N), dtype=torch.float16)
        plan = q8.launch_plan("t", torch.zeros(M, K, dtype=torch.bfloat16), q, sc, SMS)
        mt, nt = plan["tiles"]
        assert (plan["ring"], plan["smem"]) == q8.tile_ring(plan["bm"], form)
        assert plan["smem"] <= q8.SMEM_LIMIT and 2 <= plan["ring"] <= q8.TILE_SLOTS
        assert plan["grid"] == (min(mt * nt, SMS),)

    def waves(bm):
        return -(-(-(-M // bm) * -(-N // 128)) // SMS) * (bm + q8.TILE_FIXED)

    if M <= 128:
        assert plan["bm"] == next(r for r in q8.TILE_ROWS if r >= M)
    else:
        assert (plan["bm"] == 64) == (waves(64) < waves(128))


@pytest.mark.parametrize("M,N,bn", [(752, 37888, 128), (752, 3584, 64), (1500, 5120, 128),
                                     (1500, 1280, 128), (752, 4608, 128)])
def test_integer_tile_width_of_the_main_shapes(M, N, bn):
    """The unit's rows (``bn``: its width along M, the wgmma's N) at the main
    shapes: gate_up, qkv and the encoder take 128; the prefill's down and o
    take 64 (336 units of 64 rows are 3 waves against 2 of 168 units of
    128, cheaper counting a stage's fixed work)."""
    plan = q8.tile_plan(M, N, SMS)
    assert plan["bm"] == bn and plan["tiles"][1] == -(-N // 128)


@pytest.mark.parametrize("M", [9, 64, 65, 752, 1500])
@pytest.mark.parametrize("K,N", _INT8_SHAPES[:4])
def test_integer_plan_takes_no_k_split_above_8_rows(M, K, N):
    """Each output of the M > 8 tile is one float32 sum in group order
    (ggml's numerics, the parent's bits): no K split, no scratch for one."""
    q, sc = _weight(K, N)
    plan = q8.launch_plan("t", torch.zeros(M, K, dtype=torch.bfloat16), q, sc, SMS)
    assert plan["kernel"] == "wgmma" and plan["ksplit"] == 1
    assert set(plan["buffers"]) == {"xq", "sx_t"}


@pytest.mark.parametrize("bm", [16, 32, 64, 128])
def test_integer_tile_ring_of_each_form(bm):
    """A ring slot holds xq's box, the stage's raw rows (8 KB of int8, 4 KB
    of nibble bytes or words), 1 KB of scales, sx and two barriers; as many
    as fit in the block's shared memory, at most TILE_SLOTS (two named
    barriers each, 14 of the 15 there are)."""
    for form, raw in ((q8.STRIDED, 8192), (q8.PACKED, 4096), (q8.WORDS, 4096)):
        slots, smem = q8.tile_ring(bm, form)
        slot = bm * 128 + raw + 1024 + 8 * bm + 16
        assert slots == min(q8.TILE_SLOTS, (q8.SMEM_LIMIT - 1024) // slot)
        assert smem == slots * slot + 1024 <= q8.SMEM_LIMIT
    assert 2 * q8.TILE_SLOTS <= 15


def test_integer_tile_plan_refuses_what_the_kernel_does_not_take():
    for M, N in ((8, 128), (9, 120), (9, 0)):
        with pytest.raises(ValueError):
            q8.tile_plan(M, N, SMS)


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
