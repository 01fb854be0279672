"""The exact-integer group matmul's M > 8 tile (csrc/quant_matmul_int8.cu,
``qmm8_tile_kernel``) modelled on the CPU: what each consumer thread reads
and computes, from the bytes of a raw weight stage to the outputs it stores.

The tile computes the output's transpose on f16 wgmma with the weight as the
register A operand. Emulated here in numpy, per form (int8 values, nibble
bytes, int32 words) and per nibble offset:
- the stage's raw rows as TMA lays them in shared memory (int8 and nibble
  bytes 128-byte swizzled, words not), and the 32-bit registers that
  ``ldmatrix.x4.trans`` (or, for words, a 64-bit load) hands each lane;
- the A fragments ``a_frag`` makes of them under the magic exponent (each
  value exact in float16, no scale folded in), placed where wgmma takes a
  fragment (A row g of a warp is weight column cl, row g + 8 column cl + 1);
- B, xq as f16 in the order ``tile_activations_plain`` writes it (words_k
  for the words form); each group's two k16 steps summed in float32;
- the rescale, c = fma(p, sx * sw, c) in group order, thread by thread as
  ``rescale_piece`` indexes each piece of a group's products (sx read four
  rows at a time from ``sx_slot``'s order, two where a piece holds one
  block of 8 rows), and the epilogue's stores.
Every group's p must be the exact integer dot of ``group_matmul_plain``'s
operands, and the outputs the ones the same arithmetic gives when written
out directly. The launch plan is in tests/test_torch_qmm_plan.py; the kernel
runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
from qwen2_audio_tpu_torch.ops import quant_matmul_int8 as t8
from qwen2_audio_tpu_torch.ops import quant_matmul_q4b as tb

GROUP, TILE_N, STAGE_K = 32, 128, 64


# --------------------------------------------------------------------------- #
# shared memory and the loads
# --------------------------------------------------------------------------- #

def _swizzled(rows: np.ndarray) -> np.ndarray:
    """(R, 128) bytes -> shared memory as a 128-byte-swizzled TMA box: byte
    n of row r at r * 128 + ((n // 16) ^ (r % 8)) * 16 + n % 16."""
    R = rows.shape[0]
    smem = np.zeros(R * 128, np.uint8)
    r, n = np.meshgrid(np.arange(R), np.arange(128), indexing="ij")
    smem[r * 128 + (((n // 16) ^ (r % 8)) << 4) + n % 16] = rows[r, n]
    return smem


def _ldsm_x4_trans(smem: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16: lane l gives the address of
    row l % 8 of matrix l // 8 (16 bytes, 8 elements of 16 bits); lane t
    receives, of matrix i, the elements (row 2 (t % 4), column t // 4) in
    its low and (row 2 (t % 4) + 1, column t // 4) in its high half."""
    h = smem.view(np.uint16) if smem.dtype == np.uint8 else smem
    out = np.zeros((32, 4), np.uint32)
    for t in range(32):
        for i in range(4):
            lo = h[(addrs[8 * i + 2 * (t % 4)] + 2 * (t // 4)) // 2]
            hi = h[(addrs[8 * i + 2 * (t % 4) + 1] + 2 * (t // 4)) // 2]
            out[t, i] = np.uint32(lo) | (np.uint32(hi) << 16)
    return out


def _raw_words(form: int, raw: np.ndarray, warp: int) -> np.ndarray:
    """The raw registers r[0..7] of every lane of consumer warp ``warp``
    (0..7) for one stage, as the kernel loads them."""
    c16 = 4 * (warp // 4) + warp % 4
    lanes = np.arange(32)
    r = np.zeros((32, 8), np.uint32)
    if form == t8.WORDS:   # raw: (8 word rows, 128 columns) uint32, no swizzle
        g, t4 = lanes // 4, lanes % 4
        cl = 16 * c16 + 2 * g
        for j in range(2):   # group j: word row 4 j + t4, columns cl and cl + 1
            r[:, 2 * j] = raw[4 * j + t4, cl]
            r[:, 2 * j + 1] = raw[4 * j + t4, cl + 1]
        return r
    smem = _swizzled(raw)
    addrs = lanes * 128 + ((c16 ^ (lanes % 8)) << 4)
    r[:, :4] = _ldsm_x4_trans(smem, addrs)
    if form == t8.STRIDED:
        r[:, 4:] = _ldsm_x4_trans(smem, addrs + 32 * 128)
    return r


# --------------------------------------------------------------------------- #
# the fragments
# --------------------------------------------------------------------------- #

def _byte_perm(w: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm(w, 0x64646464, sel): byte i of the result is byte
    sel[4 i + 3 .. 4 i] of (w, 0x64646464)."""
    src = [(w >> (8 * b)) & 0xFF for b in range(4)] + [np.full_like(w, 0x64)] * 4
    out = np.zeros_like(w)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _f16x2(w: np.ndarray) -> np.ndarray:
    """(..., 2) float16 lanes (low, high) of 32-bit words."""
    return np.stack([(w & 0xFFFF).astype(np.uint16).view(np.float16),
                     (w >> 16).astype(np.uint16).view(np.float16)], -1)


def _a_frag(form: int, r: np.ndarray, k: int, off: int) -> np.ndarray:
    """The kernel's a_frag for every lane: (32, 4, 2) float16, registers
    a[0..3] and their (low, high) lanes, for k16 step k (0..3) of a stage."""
    if form == t8.STRIDED:
        w0, w1 = r[:, 2 * k] ^ 0x80808080, r[:, 2 * k + 1] ^ 0x80808080
        v = [_byte_perm(w0, 0x4240), _byte_perm(w0, 0x4341), _byte_perm(w1, 0x4240),
             _byte_perm(w1, 0x4341)]
        return np.stack([_f16x2(x) + np.float16(-1152) for x in v], 1).astype(np.float16)
    m = 0xF0F0F0F0 if k & 1 else 0x0F0F0F0F
    w0, w1 = r[:, 2 * (k >> 1)] & m, r[:, 2 * (k >> 1) + 1] & m
    if form == t8.PACKED:
        v = [_byte_perm(w0, 0x4240), _byte_perm(w0, 0x4341), _byte_perm(w1, 0x4240),
             _byte_perm(w1, 0x4341)]
    else:
        v = [_byte_perm(w0, 0x4140), _byte_perm(w1, 0x4140), _byte_perm(w0, 0x4342),
             _byte_perm(w1, 0x4342)]
    h = np.stack([_f16x2(x) for x in v], 1)
    if k & 1:   # 1024 + 16 n, times 1/16 (exact), then - (64 + off)
        return (h * np.float16(1 / 16) + np.float16(-(64 + off))).astype(np.float16)
    return (h + np.float16(-(1024 + off))).astype(np.float16)


def _a_tile(form: int, raw: np.ndarray, k: int, off: int) -> np.ndarray:
    """A (128 weight columns, 16) float16 of k16 step k for the unit's two
    warpgroups: warp w's lane (g, t4) holds rows 16 (w % 4) + g (a[0], a[2])
    and + 8 (a[1], a[3]) of its warpgroup at columns 2 t4, 2 t4 + 1 (a[0],
    a[1]) and + 8 (a[2], a[3]); A row 16 (w % 4) + g is weight column cl =
    16 c16 + 2 g and row + 8 column cl + 1."""
    A = np.full((TILE_N, 16), np.nan, np.float32)
    for w in range(8):
        a = _a_frag(form, _raw_words(form, raw, w), k, off).astype(np.float32)
        c16 = 4 * (w // 4) + w % 4
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            cl = 16 * c16 + 2 * g
            A[cl, 2 * t4:2 * t4 + 2] = a[lane, 0]
            A[cl + 1, 2 * t4:2 * t4 + 2] = a[lane, 1]
            A[cl, 2 * t4 + 8:2 * t4 + 10] = a[lane, 2]
            A[cl + 1, 2 * t4 + 8:2 * t4 + 10] = a[lane, 3]
    assert not np.isnan(A).any()
    return A


# --------------------------------------------------------------------------- #
# a whole unit
# --------------------------------------------------------------------------- #

def _weights(form: int, K: int, N: int, seed: int):
    """Random raw bytes of a form, the integer values they hold (K, N) and
    f16 scales."""
    rng = np.random.default_rng(seed)
    sc = (0.01 + 0.05 * rng.random((K // GROUP, N))).astype(np.float16)
    if form == t8.STRIDED:
        q = rng.integers(-128, 128, (K, N)).astype(np.int8)
        return q, q.astype(np.int64), sc
    qs4 = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    values = tqm.unpack4(torch.from_numpy(qs4)).numpy().astype(np.int64)
    return (tb.pack_b32(qs4) if form == t8.WORDS else qs4), values, sc


def _stage_raw(form: int, q: np.ndarray, kt: int) -> np.ndarray:
    """Stage kt's raw rows as the producer's TMA box takes them (one unit of
    128 columns; rows past K read as zero)."""
    per = {t8.STRIDED: STAGE_K, t8.PACKED: STAGE_K // 2, t8.WORDS: STAGE_K // 8}[form]
    rows = q[kt * per:(kt + 1) * per]
    if form == t8.WORDS:
        out = np.zeros((per, TILE_N), np.uint32)
        out[:rows.shape[0]] = rows.view(np.uint32)
        return out
    out = np.zeros((per, TILE_N), np.uint8)
    out[:rows.shape[0]] = rows.view(np.uint8)
    return out


def _fma32(p, s, c):
    """float32 fma(p, s, c) through float64: p s is exact there (an integer
    below 2^20 times a float32), the sum rounded once to float32 except in
    cases a float64 rounding first moves (never at these sizes' values)."""
    return np.float32(np.float64(p) * np.float64(s) + np.float64(c)) if np.ndim(p) == 0 else \
        (p.astype(np.float64) * s.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _pieces(bm: int) -> tuple[int, int]:
    """(P, J): a group's products in P = 2 pieces of the unit's rows, J
    blocks of 8 rows each, as the kernel's Pieces<BM>."""
    return 2, bm // 16


def _rescale_pieces(c: np.ndarray, p: np.ndarray, sx_row: np.ndarray, sw: np.ndarray,
                    bm: int) -> np.ndarray:
    """The kernel's rescale_piece over every thread and piece: lane (g, t4)
    of a warp holds c[4 j + b] (column cl) and c[4 j + 2 + b] (cl + 1) of
    unit row 8 j + 2 t4 + b, piece i's products as p[4 (j - i J) + ..], and
    reads sx of the group's slotted row at 4 t4 (load_sx): one float4 at 16
    (j / 2) for a pair of blocks, a float2 at 16 (i / 2) + 2 (i % 2) where a
    piece holds one block."""
    row = np.zeros(max(bm, sx_row.size), np.float32)   # the TMA box, past ldt zero
    row[:sx_row.size] = sx_row
    P, J = _pieces(bm)
    out = c.copy()
    for cl in range(0, TILE_N, 2):
        for t4 in range(4):
            ct = np.zeros(bm // 2, np.float32)   # the thread's fragment of c and p
            pt = np.zeros(bm // 2, np.float32)
            for j in range(bm // 8):
                for b in range(2):
                    ct[4 * j + b], ct[4 * j + 2 + b] = c[cl, 8 * j + 2 * t4 + b], \
                        c[cl + 1, 8 * j + 2 * t4 + b]
                    pt[4 * j + b], pt[4 * j + 2 + b] = p[cl, 8 * j + 2 * t4 + b], \
                        p[cl + 1, 8 * j + 2 * t4 + b]
            sxa = 4 * t4
            for i in range(P):
                pp = pt[4 * J * i:4 * J * (i + 1)]
                if J == 1:
                    at = sxa + 16 * (i >> 1) + 2 * (i & 1)
                    sxv = row[at:at + 2]
                else:
                    sxv = np.concatenate([row[sxa + 16 * ((i * J + jj) >> 1):
                                              sxa + 16 * ((i * J + jj) >> 1) + 4]
                                          for jj in range(0, J, 2)])
                for jj in range(J):
                    for b in range(2):
                        x = sxv[2 * jj + b]
                        k, o = 4 * jj + b, 4 * (i * J + jj) + b
                        s0, s1 = np.float32(x * sw[cl]), np.float32(x * sw[cl + 1])
                        ct[o] = _fma32(pp[k], s0, ct[o])
                        ct[o + 2] = _fma32(pp[k + 2], s1, ct[o + 2])
            for j in range(bm // 8):
                for b in range(2):
                    out[cl, 8 * j + 2 * t4 + b] = ct[4 * j + b]
                    out[cl + 1, 8 * j + 2 * t4 + b] = ct[4 * j + 2 + b]
    return out


def _unit(form: int, off: int, M: int, K: int, bm: int, seed: int):
    """One unit (rows 0 .. bm - 1 of x, the 128 columns) through the modelled
    tile and through the same arithmetic written out directly."""
    q, values, sc = _weights(form, K, TILE_N, seed)
    values = values - off
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    xq_t, sx_t = (a.numpy() for a in t8.tile_activations_plain(x, form))
    xq8, sx = (a.numpy() for a in t8.quantize_activations_plain(x))
    G, stages = K // GROUP, -(-K // STAGE_K)
    B = np.zeros((bm, stages * STAGE_K), np.float32)   # xq's boxes, past M and K zero (TMA)
    B[:M, :K] = xq_t.astype(np.float32)
    c = np.zeros((TILE_N, bm), np.float32)   # out^T, as the fragments hold it
    want = np.zeros((M, TILE_N), np.float32)
    for kt in range(stages):
        raw = _stage_raw(form, q, kt)
        for j in range(2):   # both groups, a group past K reading zeros
            gi = 2 * kt + j
            p = np.zeros((TILE_N, bm), np.float32)
            for s in range(2):
                k = 2 * j + s
                A = _a_tile(form, raw, k, off)
                kk = slice(kt * STAGE_K + 16 * k, kt * STAGE_K + 16 * k + 16)
                p = (p + (A.astype(np.float64) @ B[:, kk].T.astype(np.float64))).astype(np.float32)
            if gi >= G:   # the padded group: p 0, both scales 0, c's bits unchanged
                assert not p.any()
                before = c.copy()
                c = _rescale_pieces(c, p, np.zeros(0, np.float32), np.zeros(TILE_N, np.float32),
                                    bm)
                assert np.array_equal(c.view(np.uint32), before.view(np.uint32))
                continue
            exact = values[gi * GROUP:(gi + 1) * GROUP].T @ xq8[:, gi * GROUP:(gi + 1) * GROUP].T
            assert np.array_equal(p[:, :M].astype(np.int64), exact), (kt, j)
            # the rescale, thread by thread and piece by piece as rescale_piece
            # indexes it
            sw = sc[gi].astype(np.float32)
            c = _rescale_pieces(c, p, sx_t[gi], sw, bm)
            want = _fma32(exact.T.astype(np.float32),
                          (sx[:, gi:gi + 1] * sw[None, :]).astype(np.float32), want)
    # the epilogue: lane (g, t4) stores c[4 j], c[4 j + 2] (columns cl, cl +
    # 1) of row 8 j + 2 t4 and c[4 j + 1], c[4 j + 3] of the next row
    out = np.full((M, TILE_N), np.nan, np.float32)
    for w in range(8):
        c16 = 4 * (w // 4) + w % 4
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            cl = 16 * c16 + 2 * g
            for j in range(bm // 8):
                for b in range(2):
                    ra = 8 * j + 2 * t4 + b
                    if ra < M:
                        out[ra, cl:cl + 2] = c[cl:cl + 2, ra]
    return out, want, x, values, sc


_FORM_CASES = [(t8.STRIDED, 0), (t8.PACKED, 0), (t8.PACKED, 8), (t8.WORDS, 8)]


@pytest.mark.parametrize("form,off", _FORM_CASES, ids=["int8", "nibbles0", "nibbles8", "words"])
def test_fragments_give_each_groups_exact_dot(form, off):
    """Each lane's registers from ldmatrix.trans (words: a 64-bit load) of a
    swizzled raw stage, converted by a_frag and placed as wgmma places A,
    times B in tile_activations' order, give every group's exact integer dot
    (asserted inside ``_unit``, for every group of K = 160: two full stages
    and a ragged one whose second group reads zeros past K and leaves the
    sums' bits as they are), and the stores cover every output of the
    unit's rows once with the directly written arithmetic's values, at bm
    32 (two pieces of two blocks of 8 rows), 16 (of one) and 128 (of
    eight)."""
    out, want, *_ = _unit(form, off, M=20, K=160, bm=32, seed=11 + form + off)
    assert not np.isnan(out).any()
    assert np.array_equal(out, want)
    out, want, *_ = _unit(form, off, M=9, K=96, bm=16, seed=12 + form + off)
    assert not np.isnan(out).any()
    assert np.array_equal(out, want)
    out, want, *_ = _unit(form, off, M=100, K=64, bm=128, seed=13 + form + off)
    assert not np.isnan(out).any()
    assert np.array_equal(out, want)


@pytest.mark.parametrize("form,off", _FORM_CASES, ids=["int8", "nibbles0", "nibbles8", "words"])
def test_modelled_unit_matches_the_plain_version(form, off):
    """The modelled unit (bm 16 at M = 9) within the float32 x tolerance of
    tests/test_torch_quant_matmul_int8.py of ``group_matmul_plain``, which
    adds p * (sx * sw) with two roundings where the tile fuses them."""
    out, _, x, values, sc = _unit(form, off, M=9, K=96, bm=16, seed=23 + form + off)
    plain = t8.group_matmul_plain(x, torch.from_numpy(values), torch.from_numpy(sc)).numpy()
    assert np.abs(out - plain).max() <= 1e-6 * np.abs(plain).max()


@pytest.mark.parametrize("form", [t8.STRIDED, t8.PACKED, t8.WORDS])
@pytest.mark.parametrize("M", [9, 16, 33, 752])
def test_tile_activations_hold_the_int8_values(form, M):
    """The tile's xq is the plain int8 xq value for value, as f16, at
    words_k's columns for the words form and in K's order otherwise; sx_t
    holds row m's scale of group g at (g, sx_slot(m)) and 0 in the slots of
    the rows past M; words_k and sx_slot are permutations inside each group
    and each 16 rows."""
    K = 96
    x = torch.from_numpy(np.random.default_rng(M).standard_normal((M, K)).astype(np.float32))
    xq, sx_t = t8._tile_activations(x, form)
    xq8, sx = t8.quantize_activations_plain(x)
    assert xq.dtype == torch.float16 and xq.shape == (M, K)
    assert sx_t.shape == (K // GROUP, -(-M // 16) * 16)
    cols = t8.words_k(torch.arange(K)) if form == t8.WORDS else torch.arange(K)
    assert torch.equal(xq[:, cols].to(torch.int64), xq8.to(torch.int64))
    slots = t8.sx_slot(torch.arange(M))
    assert torch.equal(sx_t[:, slots], sx.t())
    rest = torch.ones(sx_t.shape[1], dtype=torch.bool)
    rest[slots] = False
    assert not sx_t[:, rest].any()
    for perm, n in ((t8.words_k, GROUP), (t8.sx_slot, 16)):
        p = perm(torch.arange(4 * n))
        assert torch.equal(p.sort().values, torch.arange(4 * n))
        assert torch.equal(p // n, torch.arange(4 * n) // n)


def test_tile_activations_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        t8._tile_activations(torch.zeros(4, 48), t8.STRIDED)
    with pytest.raises(ValueError):
        t8._tile_activations(torch.zeros(4, 64), 3)
    x = torch.ones(4, 64)                       # the CPU takes the plain version
    for got, want in zip(t8._tile_activations(x, t8.WORDS),
                         t8.tile_activations_plain(x, t8.WORDS)):
        assert torch.equal(got, want)
