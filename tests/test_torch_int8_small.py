"""The exact-integer group matmul's M <= 8 kernel (csrc/quant_matmul_int8.cu,
``qmm8_small_kernel``) modelled on the CPU: its launch plan, what each lane
loads and hands to ``mma.sync.m16n8k32.s8``, and the order of its float32
sums.

- ``small_plan`` covers every 32-group of K once, in whole groups and in
  order, every tile once a split, and is the same for the flat and
  stacked entries and the three weight forms of one shape.
- Per form (int8 values, nibble bytes with off 8 and 0, int32 words), the
  numpy model below follows ``load_unit`` and ``consume_unit`` lane by lane:
  the bytes each lane loads, the transposes and nibble masks that make its
  A registers, the A fragments as the PTX fragment layout places them (A
  row g of mma j is the warp's column C g + 2 j, row g + 8 column C g + 2 j
  + 1, C the columns a lane owns),
  and B from the shared-memory xq the quantizing quads write. Every (column,
  k) of a group must be used exactly once, and every output's integer dot
  must be the exact dot of xq with the stored values.
- The sums: groups in order within a warp's quarter of a split, the 4
  warps added in order, the splits added in order, each step the kernel's
  float32 arithmetic; the result within phase 2's tolerances of
  ``group_matmul_plain``.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import chip_smoke
from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb

GROUP = 32
C = t8.SMALL_LANE_COLS        # neighbouring columns a lane owns
COLS = 8 * C                  # a warp's columns: 8 lane groups
SMS = 132

# the decoder's (qkv, o, gate_up, down), the lm_head's, the encoder's fc1
# and the ragged edge case (N a multiple of 16 and not of the tile, K of 32
# and a prime count of groups); K = 32 and 96 (fewer groups than warps)
_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 156032),
           (1280, 5120), (1312, 1296), (32, 16), (96, 48)]


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("K,N", _SHAPES)
def test_small_plan_covers_every_group_and_tile_once(M, K, N):
    plan = t8.small_plan(M, K, N, SMS)
    ks, ctas, G = plan["ksplit"], plan["ctas"], K // GROUP
    assert plan["grid"] == (ctas, ks) and len(plan["k_ranges"]) == ks
    # splits: whole groups, in order, covering K once, at most SMALL_GROUPS
    # each and, where K has that many, at least one a warp
    edges = [a for a, _ in plan["k_ranges"]] + [plan["k_ranges"][-1][1]]
    assert edges[0] == 0 and edges[-1] == K and all(e % GROUP == 0 for e in edges)
    sizes = [(b - a) // GROUP for a, b in plan["k_ranges"]]
    assert all(a < b for a, b in zip(edges, edges[1:])) and sum(sizes) == G
    assert max(sizes) <= t8.SMALL_GROUPS and max(sizes) - min(sizes) <= 1
    if G >= t8.SMALL_WARPS:
        assert min(sizes) >= t8.SMALL_WARPS
    # the warps' quarters partition each split, in warp order
    for s in range(ks):
        parts = [t8.small_warp_groups(plan, s, w) for w in range(t8.SMALL_WARPS)]
        assert parts[0][0] == edges[s] // GROUP and parts[-1][1] == edges[s + 1] // GROUP
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    # tiles: every one once a split, none past N; the CTAs' counts differ by one
    T = -(-N // t8.SMALL_COLS)
    walked = [t8.small_tiles(plan, p) for p in range(ctas)]
    assert sorted(t for w in walked for t in w) == list(range(T)) and plan["tiles"] == T
    assert max(map(len, walked)) == plan["tiles_per_cta"] and min(map(len, walked)) >= 1
    assert max(map(len, walked)) - min(map(len, walked)) <= 1
    # buffers, tickets, shared memory
    assert plan["tickets"] == (T if ks > 1 else 0) <= 4096
    assert plan["buffers"] == ({"partial": ((ks, M, N), torch.float32)} if ks > 1 else {})
    assert plan["smem"] == t8.small_smem(M, max(sizes)) <= t8.SMALL_SMEM
    assert ctas * ks <= 4 * SMS


@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("K,N", [(3584, 37888), (18944, 3584), (1312, 1296)])
def test_small_plan_is_the_same_for_every_entry_and_form(M, K, N):
    """Flat int8 values, a layer of a stack, nibble bytes and int32 words of
    one (K, N): the same launch, as phase 2's bit-equalities need."""
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    sc = torch.ones((2, K // GROUP, N), dtype=torch.float16)
    weights = [torch.zeros((K, N), dtype=torch.int8),
               torch.zeros((2, K, N), dtype=torch.int8)[1],
               torch.zeros((2, K // 2, N), dtype=torch.uint8)[1],
               torch.zeros((2, K // 8, N), dtype=torch.int32)[1]]
    plans = [t8.launch_plan("t", x, q, sc[1], SMS) for q in weights]
    assert all(p == plans[0] for p in plans)
    assert plans[0]["kernel"] == "small"
    assert {k: plans[0][k] for k in t8.small_plan(M, K, N, SMS)} == t8.small_plan(M, K, N, SMS)


@pytest.mark.parametrize("M,K,N", [(9, 3584, 4608), (0, 3584, 4608), (752, 1312, 1296),
                                   (1, 3584, 4600), (1, 3600, 4608)])
def test_small_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    with pytest.raises(ValueError):
        t8.small_plan(M, K, N, SMS)


# --------------------------------------------------------------------------- #
# the fragments: one 32-group of one warp's columns, lane by lane
# --------------------------------------------------------------------------- #

def _u32(b: np.ndarray) -> int:
    """4 bytes -> a little-endian word."""
    return int(np.asarray(b, np.uint8).view("<u4")[0])


def _bytes(w: int) -> list[int]:
    return [(w >> (8 * i)) & 0xFF for i in range(4)]


def _transpose_bytes(r):
    """transpose_bytes: c[i] holds byte i of r0 .. r3 in its bytes 0 .. 3."""
    return [sum(_bytes(r[j])[i] << (8 * j) for j in range(4)) for i in range(4)]


def _swar_sub8(p: int) -> int:
    return (((p | 0x80808080) - 0x08080808) & 0xFFFFFFFF) ^ 0x80808080


def _nibble_quads(w: int, off: int) -> tuple[int, int]:
    lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
    return (_swar_sub8(lo), _swar_sub8(hi)) if off else (lo, hi)


def _lane_regs(form: str, stored: np.ndarray, off: int, g: int, t: int):
    """load_unit and consume_unit for lane (g, t) of a warp at one group of
    its COLS columns, ``stored`` the group's rows as the form holds them
    (int8 (32, COLS), nibble bytes (16, COLS), int32 words (4, COLS)):
    lo[c], hi[c], the 4 int8 values of column C g + c at k = 4 t + i and 16
    + 4 t + i."""
    cols = slice(C * g, C * g + C)
    if form == "words":
        wd = [int(v) & 0xFFFFFFFF for v in stored[t, cols]]
        return [list(p) for p in zip(*(_nibble_quads(w, off) for w in wd))]
    R = C // 4                     # words a row of the lane's columns
    rows = [(i & 3) + (i >> 2) * 16 + 4 * t for i in range(8 if form == "int8" else 4)]
    w = []
    for r in rows:   # one load of C bytes a row: w[R i + c4] holds columns 4 c4 .. 4 c4 + 3
        b = stored[r, cols].view(np.uint8)
        w += [_u32(b[4 * c4:4 * c4 + 4]) for c4 in range(R)]
    quads = [_transpose_bytes(w[h:4 * R:R]) for h in range(R)]     # rows 4 t + i
    lo = [v for q in quads for v in q]
    if form == "int8":             # rows 16 + 4 t + i
        hi = [v for h in range(R) for v in _transpose_bytes(w[4 * R + h:8 * R:R])]
        return lo, hi
    return [list(p) for p in zip(*(_nibble_quads(x, off) for x in lo))]


def _group(form: str, off: int, seed: int):
    """One group of a warp's COLS columns in ``form`` and its values (32,
    COLS)."""
    rng = np.random.default_rng(seed)
    if form == "int8":
        v = rng.integers(-128, 128, (GROUP, COLS)).astype(np.int8)
        return v, v.astype(np.int64)
    nib = rng.integers(0, 16, (GROUP, COLS)).astype(np.uint8)
    packed = (nib[:16] | (nib[16:] << 4)).astype(np.uint8)       # byte row j: k = j, j + 16
    stored = packed if form == "packed" else tb.pack_b32(packed)
    return stored, nib.astype(np.int64) - off


def _xs(xq: np.ndarray) -> np.ndarray:
    """The quads' writes of one group's xq (M, 32) int8: slot row m, lane t
    a uint2 of values 4 t .. 4 t + 3 and 16 + 4 t .. 16 + 4 t + 3."""
    M = xq.shape[0]
    out = np.zeros((M, 4, 2), np.uint32)
    for m in range(M):
        for t in range(4):
            out[m, t] = (_u32(xq[m, 4 * t:4 * t + 4].view(np.uint8)),
                         _u32(xq[m, 16 + 4 * t:20 + 4 * t].view(np.uint8)))
    return out


def _s8(word: int) -> list[int]:
    return [b - 256 if b > 127 else b for b in _bytes(word)]


@pytest.mark.parametrize("M", [1, 2, 5, 8])
@pytest.mark.parametrize("form,off", [("int8", 0), ("packed", 8), ("packed", 0),
                                      ("words", 8)])
def test_fragments_take_every_value_once_and_give_the_exact_dot(form, off, M):
    stored, values = _group(form, off, seed=3 + M)
    rng = np.random.default_rng(11 + M)
    xq = rng.integers(-127, 128, (M, GROUP)).astype(np.int8)
    xs = _xs(xq)
    regs = {(g, t): _lane_regs(form, stored, off, g, t) for g in range(8) for t in range(4)}
    used = np.zeros((GROUP, COLS), np.int64)
    want = xq.astype(np.int64) @ values                           # (M, 64)
    got = np.full((8, COLS), np.iinfo(np.int64).min)              # (n, column)
    for j in range(C // 2):
        # A (16 x 32) of mma j from the lanes' a0 = lo[2j], a1 = lo[2j + 1],
        # a2 = hi[2j], a3 = hi[2j + 1] by the PTX layout; B (32 x 8) from xs
        A = np.zeros((16, GROUP), np.int64)
        B = np.zeros((GROUP, 8), np.int64)
        for (g, t), (lo, hi) in regs.items():
            for r, (reg, k0) in enumerate(((lo[2 * j], 4 * t), (lo[2 * j + 1], 4 * t),
                                           (hi[2 * j], 16 + 4 * t), (hi[2 * j + 1], 16 + 4 * t))):
                row = g + 8 * (r % 2)
                A[row, k0:k0 + 4] = _s8(reg)
            rb = g if g < M else 0                                 # past M: row 0 again
            B[4 * t:4 * t + 4, g] = _s8(int(xs[rb, t, 0]))
            B[16 + 4 * t:20 + 4 * t, g] = _s8(int(xs[rb, t, 1]))
        for row in range(16):
            col = C * (row % 8) + 2 * j + row // 8
            assert np.array_equal(A[row], values[:, col]), (j, row)
            used[:, col] += 1
        D = A @ B
        # d0 .. d3 of lane (g, t): (row g, n 2t), (g, 2t + 1), (g + 8, 2t),
        # (g + 8, 2t + 1) -> acc[h][c] of output (row 2 t + h, column C g + c)
        for g in range(8):
            for t in range(4):
                for h in range(2):
                    got[2 * t + h, C * g + 2 * j] = D[g, 2 * t + h]
                    got[2 * t + h, C * g + 2 * j + 1] = D[g + 8, 2 * t + h]
    assert (used == 1).all()
    assert np.array_equal(got[:M], want)


@pytest.mark.parametrize("M", range(1, 9))
def test_lanes_read_their_rows_of_sx(M):
    """r2 = min(2 t, SX - 2), SX = M rounded up to even: wherever row 2 t
    (or 2 t + 1) is below M, the lane's pair of sx reads it, inside the slot."""
    SX = (M + 1) // 2 * 2
    for t in range(4):
        r2 = min(2 * t, SX - 2)
        assert 0 <= r2 and r2 + 1 < SX + (SX == 0) and r2 % 2 == 0
        for h in range(2):
            if 2 * t + h < M:
                assert r2 + h == 2 * t + h


# --------------------------------------------------------------------------- #
# the sums
# --------------------------------------------------------------------------- #

def _fma32(a, b, c):
    """float32 fma(a, b, c) (products of float32 are exact in float64; the
    sum rounded once more, to float32)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _kernel_order(x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                  plan: dict) -> np.ndarray:
    """The kernel's float32 arithmetic in its order: within each split, each
    warp's quarter c = fma(float(p), sx * sw, c) over its groups in order
    from 0; the 4 warps' sums added in warp order; the splits' added in
    split order."""
    xq, sx = t8.quantize_activations_plain(x)
    xq, sx = xq.numpy().astype(np.int64), sx.numpy()
    v, sw = values.numpy().astype(np.int64), scales.float().numpy()
    M, N = xq.shape[0], v.shape[1]
    total = None
    for s in range(plan["ksplit"]):
        split = None
        for w in range(t8.SMALL_WARPS):
            a, b = t8.small_warp_groups(plan, s, w)
            c = np.zeros((M, N), np.float32)
            for gi in range(a, b):
                p = xq[:, gi * GROUP:(gi + 1) * GROUP] @ v[gi * GROUP:(gi + 1) * GROUP]
                c = _fma32(p.astype(np.float32), sx[:, gi:gi + 1] * sw[gi:gi + 1], c)
            split = c if split is None else (split + c).astype(np.float32)
        total = split if total is None else (total + split).astype(np.float32)
    return total


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("K,N", [(3584, 4608), (18944, 3584)])
def test_sum_order_agrees_with_the_plain_version(M, K, N, dtype):
    """The model of the kernel's sums, at the plan of the decoder's qkv and
    down shapes (splits of 14 and 45 groups), over a 128-column slice of the
    weight: within phase 2's tolerance of ``group_matmul_plain``."""
    plan = t8.small_plan(M, K, N, SMS)
    assert plan["ksplit"] > 1
    n = 128
    g = torch.Generator().manual_seed(K + M)
    values = torch.randint(-128, 128, (K, n), generator=g, dtype=torch.int8)
    scales = (torch.rand(K // GROUP, n, generator=g) * 0.02).half()
    x = torch.randn(M, K, generator=g).to(dtype)
    got = torch.from_numpy(_kernel_order(x, values, scales, plan)).to(dtype).float()
    want = t8.group_matmul_plain(x, values, scales).float()
    top = want.abs().max().item()
    if dtype == torch.float32:
        tol = chip_smoke.QMM_ATOL_F32 * top
    else:
        tol = chip_smoke.QMM_TOL_BF16[0] * top + chip_smoke.QMM_TOL_BF16[1] * want.abs()
    assert bool(((got - want).abs() <= tol).all())
