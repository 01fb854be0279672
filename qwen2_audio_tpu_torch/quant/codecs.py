"""ggml-compatible block quantization codecs (numpy, vectorized).

Bit-exact re-implementations of the reference's scalar quantizers so that
checkpoints quantized here load into ggml (and vice versa) with identical
payload bytes:

- block layouts:  ggml/src/ggml-common.h:144-191 (q4_0/q8_0), :150-182 (q4_1/q5_x)
- quantizers:     ggml/src/ggml-quants.c quantize_row_{q4_0,q4_1,q5_0,q5_1,q8_0}_ref
- dequantizers:   ggml/src/ggml-quants.c dequantize_row_{...}

All formats share a 32-element group ("block") structure. Within a 4/5-bit
block the packing pairs element j with element j+16: low nibble = j,
high nibble = j+16; the 5th bits live in a little-endian uint32 ``qh``.

The dequantizers here are the *test oracles* (and the loader's dense
path); the hot path dequantizes inside the CUDA matmul kernels
(csrc/quant_matmul.cu, ops/quant_matmul.py) from the same block values.
"""

from __future__ import annotations

import numpy as np

from qwen2_audio_tpu_torch.config import GGMLType

QK = 32  # group size shared by all supported formats (QK4_0 == QK8_0 == 32)

# bytes per 32-element block, matching sizeof(block_*) with packed f16 scales
# 256-element super-block formats (QK_K): bytes per super-block
KBLOCK_BYTES = {
    GGMLType.Q2_K: 16 + 64 + 2 + 2,    # 4-bit scale|min bytes, 2-bit quants, d, dmin
    GGMLType.Q3_K: 32 + 64 + 12 + 2,   # hmask, 2-bit quants, 6-bit scales, d
    GGMLType.Q4_K: 2 + 2 + 12 + 128,   # d, dmin, 6-bit scales/mins, nibbles
    GGMLType.Q5_K: 2 + 2 + 12 + 32 + 128,  # d, dmin, scales, qh, nibbles
    GGMLType.Q6_K: 128 + 64 + 16 + 2,  # ql, qh, int8 scales, d
}

BLOCK_BYTES = {
    GGMLType.Q4_0: 2 + 16,          # f16 d + 16 nibble bytes
    GGMLType.Q4_1: 2 + 2 + 16,      # f16 d + f16 m + 16 nibble bytes
    GGMLType.Q5_0: 2 + 4 + 16,      # f16 d + u32 qh + 16 nibble bytes
    GGMLType.Q5_1: 2 + 2 + 4 + 16,  # f16 d + f16 m + u32 qh + 16 nibble bytes
    GGMLType.Q8_0: 2 + 32,          # f16 d + 32 int8
}


def _blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK != 0:
        raise ValueError(f"size {x.size} not a multiple of group size {QK}")
    return x.reshape(-1, QK)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Value with the largest |x| per block, first occurrence on ties —
    matches the C scan `if (amax < fabsf(v))`. An all-zero block keeps the
    C loop's +0.0 initializer even when the inputs are -0.0 (the strict <
    never fires), so force +0.0 there; otherwise d = max/-8 would flip the
    f16 scale's sign bit and break quantize∘dequantize idempotence."""
    a = np.abs(xb)
    idx = np.argmax(a, axis=1)
    rows = np.arange(xb.shape[0])
    maxv = xb[rows, idx]
    return np.where(a[rows, idx] == 0.0, np.float32(0.0), maxv)


def _trunc_u8(v: np.ndarray, cap: int) -> np.ndarray:
    """MIN(cap, (int8_t)(v)) for non-negative v: C truncates toward zero."""
    return np.minimum(cap, v.astype(np.int8)).astype(np.uint8)


# --------------------------------------------------------------------------- #
# quantize: float32 -> packed bytes
# --------------------------------------------------------------------------- #

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    maxv = _signed_absmax(xb)
    d = maxv / -8.0
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, 0.0
                       ).astype(np.float32)
    q = _trunc_u8(xb * inv[:, None] + np.float32(8.5), 15)
    packed = q[:, :16] | (q[:, 16:] << 4)
    out = np.empty((xb.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / np.float32(15.0)
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, 0.0
                       ).astype(np.float32)
    q = _trunc_u8((xb - mn[:, None]) * inv[:, None] + np.float32(0.5), 15)
    packed = q[:, :16] | (q[:, 16:] << 4)
    out = np.empty((xb.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:] = packed
    return out.reshape(-1)


def _pack_qh(q: np.ndarray) -> np.ndarray:
    """Collect bit 4 of all 32 values into a little-endian uint32 per block."""
    bits = ((q >> 4) & 1).astype(np.uint32)  # (nb, 32)
    shifts = np.arange(32, dtype=np.uint32)
    qh = (bits << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return qh


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    maxv = _signed_absmax(xb)
    d = maxv / -16.0
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, 0.0
                       ).astype(np.float32)
    q = _trunc_u8(xb * inv[:, None] + np.float32(16.5), 31)
    packed = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    qh = _pack_qh(q)
    out = np.empty((xb.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 6:] = packed
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / np.float32(31.0)
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, 0.0
                       ).astype(np.float32)
    # note: the reference applies no MIN cap here ((uint8_t)(x0 + 0.5f))
    q = ((xb - mn[:, None]) * inv[:, None] + np.float32(0.5)).astype(np.uint8)
    packed = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    qh = _pack_qh(q)
    out = np.empty((xb.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 8:] = packed
    return out.reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=1)
    d = amax / np.float32(127.0)
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, 0.0
                       ).astype(np.float32)
    # roundf = round half away from zero (not banker's rounding)
    scaled = xb * inv[:, None]
    q = np.sign(scaled) * np.floor(np.abs(scaled) + np.float32(0.5))
    q = q.astype(np.int8)
    out = np.empty((xb.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


# --------------------------------------------------------------------------- #
# dequantize: packed bytes -> float32
# --------------------------------------------------------------------------- #

def _unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """(nb, 16) packed bytes -> (nb, 32) nibble values, j / j+16 layout."""
    lo = (packed & 0x0F).astype(np.int32)
    hi = (packed >> 4).astype(np.int32)
    return np.concatenate([lo, hi], axis=1)


def _unpack_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) bytes -> (nb, 32) fifth-bit values (0 or 16)."""
    qh = qh_bytes.copy().view(np.uint32).reshape(-1)  # little-endian
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((qh[:, None] >> shifts[None, :]) & 1).astype(np.int32)
    return bits << 4


def dequantize_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 18)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    q = _unpack_nibbles(b[:, 2:]) - 8
    return (q * d).astype(np.float32).reshape(-1)[:n]


def dequantize_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 20)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _unpack_nibbles(b[:, 4:])
    return (q * d + m).astype(np.float32).reshape(-1)[:n]


def dequantize_q5_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 22)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    q = _unpack_nibbles(b[:, 6:]) | _unpack_qh(b[:, 2:6])
    return ((q - 16) * d).astype(np.float32).reshape(-1)[:n]


def dequantize_q5_1(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 24)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _unpack_nibbles(b[:, 8:]) | _unpack_qh(b[:, 4:8])
    return (q * d + m).astype(np.float32).reshape(-1)[:n]


def dequantize_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 34)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    q = b[:, 2:].view(np.int8).astype(np.int32)
    return (q * d).astype(np.float32).reshape(-1)[:n]


# --------------------------------------------------------------------------- #
# k-quants: 256-element super-blocks (q4_K, q6_K)
#
# Layouts: ggml/src/ggml-common.h (block_q4_K 144 B: f16 d + f16 dmin +
# 12 B packed 6-bit scales/mins + 128 B nibbles; block_q6_K 210 B: 128 B
# low nibbles + 64 B high bits + 16 int8 scales + f16 d).
# Quantizers: ggml/src/ggml-quants.c quantize_row_q4_K_ref:2483 (
# make_qkx2_quants:1817 scale/min search per 32-group, 6-bit super-scales)
# and quantize_row_q6_K_ref:2908 (make_qx_quants:1645 per 16-group).
#
# Both directions are BIT-EXACT against the reference source semantics:
# the dequantizers match any ggml build (single-rounded elementwise f32),
# and the quantizers reproduce the C search with strict sequential-f32
# accumulation (np.cumsum pins the `acc += term` order), verified
# byte-for-byte against ggml-quants.c compiled -ffp-contract=off
# -fno-tree-vectorize (tools/crosscheck_ggml.py --codec-oracle). Note that
# ggml's own default -O2/-march=native builds reassociate these sums
# (FMA/SIMD) and differ from THEMSELVES across machines on ~0.1% of
# borderline blocks; the strict-FP compile is the canonical target.
# --------------------------------------------------------------------------- #

QK_K = 256


def _nearest_int(v: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round-half-to-even (the 12582912.0f trick)."""
    return np.rint(v).astype(np.int32)


def _seqsum(a: np.ndarray) -> np.ndarray:
    """Sequential float32 row sum — np.cumsum computes every prefix, which
    pins the accumulation order and rounding to the C loop's
    `acc += term` exactly (np.sum uses pairwise summation and diverges)."""
    return np.cumsum(a.astype(np.float32), axis=1, dtype=np.float32)[:, -1]


def _make_qkx2_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                      rmin: float, rdelta: float, nstep: int,
                      use_mad: bool = False
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized make_qkx2_quants: x, weights (G, n).
    Returns (scale (G,), the_min (G,), L (G, n) uint8).

    All arithmetic is strict float32 in the reference's operation order
    (sequential accumulations via _seqsum) so the chosen codes match the
    C search bit-for-bit."""
    f32 = np.float32
    x = x.astype(f32)
    w = weights.astype(f32)
    xmin0 = x.min(axis=1)
    xmax = x.max(axis=1)
    xmin = np.minimum(xmin0, f32(0.0))
    # C clamps min to 0 BEFORE the max == min early-out (ggml-quants.c:1836-
    # 1841), so a constant-positive group takes the full search with min=0;
    # only constant-zero / constant-negative groups hit the flat path.
    flat = xmax == xmin
    rng = np.where(xmax > xmin, (xmax - xmin).astype(f32), f32(1.0))
    sum_w = _seqsum(w)
    sum_x = _seqsum((w * x).astype(f32))

    iscale = (f32(nmax) / rng).astype(f32)
    scale = (f32(1.0) / iscale).astype(f32)
    L = np.clip(_nearest_int((iscale[:, None] * (x - xmin[:, None]).astype(f32)
                              ).astype(f32)), 0, nmax)
    Lf = L.astype(f32)
    diff = (((scale[:, None] * Lf).astype(f32) + xmin[:, None]).astype(f32)
            - x).astype(f32)
    err = np.abs(diff) if use_mad else (diff * diff).astype(f32)
    best_mad = _seqsum((w * err).astype(f32))
    cur_min = xmin.copy()

    for step in range(nstep + 1):
        # the C search is STATEFUL: an accepted update overwrites `min`,
        # and later iterations quantize against the new min AND the new
        # (max - min) denominator
        denom = np.where(flat, f32(1.0), (xmax - cur_min).astype(f32))
        c = f32(f32(f32(rmin) + f32(f32(rdelta) * f32(step))) + f32(nmax))
        isc = (c / denom).astype(f32)
        Laux = np.clip(_nearest_int((isc[:, None]
                                     * (x - cur_min[:, None]).astype(f32)
                                     ).astype(f32)), 0, nmax)
        lf = Laux.astype(f32)
        wl = (w * lf).astype(f32)
        sum_l = _seqsum(wl)
        sum_l2 = _seqsum((wl * lf).astype(f32))
        sum_xl = _seqsum((wl * x).astype(f32))
        D = (np.float32(sum_w * sum_l2) - np.float32(sum_l * sum_l)
             ).astype(f32)
        Dp = np.where(D > 0, D, f32(1.0))
        this_scale = ((np.float32(sum_w * sum_xl)
                       - np.float32(sum_x * sum_l)).astype(f32) / Dp
                      ).astype(f32)
        this_min = ((np.float32(sum_l2 * sum_x)
                     - np.float32(sum_l * sum_xl)).astype(f32) / Dp
                    ).astype(f32)
        pos = this_min > 0
        this_min = np.where(pos, f32(0.0), this_min)
        this_scale = np.where(
            pos, (sum_xl / np.where(sum_l2 > 0, sum_l2, f32(1.0))
                  ).astype(f32), this_scale)
        diff = (((this_scale[:, None] * lf).astype(f32)
                 + this_min[:, None]).astype(f32) - x).astype(f32)
        err = np.abs(diff) if use_mad else (diff * diff).astype(f32)
        mad = _seqsum((w * err).astype(f32))
        upd = (D > 0) & (mad < best_mad)
        L = np.where(upd[:, None], Laux, L)
        best_mad = np.where(upd, mad, best_mad)
        scale = np.where(upd, this_scale, scale)
        cur_min = np.where(upd, this_min, cur_min)

    scale = np.where(flat, f32(0.0), scale)
    the_min = np.where(flat, -xmin, -cur_min)
    L = np.where(flat[:, None], 0, L)
    return (scale.astype(np.float32), the_min.astype(np.float32),
            L.astype(np.uint8))


def _pack_k4_scales(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """(nb, 8) 6-bit scales + mins -> (nb, 12) packed bytes
    (quantize_row_q4_K_ref:2519-2528 layout)."""
    nb = ls.shape[0]
    sc = np.zeros((nb, 12), np.uint8)
    sc[:, 0:4] = ls[:, 0:4] & 63
    sc[:, 4:8] = lm[:, 0:4] & 63
    sc[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    sc[:, 0:4] |= (ls[:, 4:8] >> 4) << 6
    sc[:, 4:8] |= (lm[:, 4:8] >> 4) << 6
    return sc


def _unpack_k4_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 12) packed bytes -> 6-bit (sc (nb,8), m (nb,8))
    (get_scale_min_k4, ggml-quants.c:1898)."""
    q = sc.astype(np.int32)
    d = np.empty((sc.shape[0], 8), np.int32)
    m = np.empty_like(d)
    d[:, 0:4] = q[:, 0:4] & 63
    m[:, 0:4] = q[:, 4:8] & 63
    d[:, 4:8] = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    m[:, 4:8] = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return d, m


def quantize_q4_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if xb.size % QK_K:
        raise ValueError(f"size {xb.size} not a multiple of {QK_K}")
    nb = xb.size // QK_K
    xg = xb.reshape(nb * 8, 32)

    sum_x2 = _seqsum((xg * xg).astype(np.float32))
    av_x = np.sqrt((sum_x2 / np.float32(32.0)).astype(np.float32)
                   ).astype(np.float32)
    weights = (av_x[:, None] + np.abs(xg)).astype(np.float32)
    scales, mins, L = _make_qkx2_quants(xg, weights, 15, -1.0, 0.1, 20)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L.reshape(nb, 8, 32)

    # C starts both maxima at +0.0 and updates on strictly-greater only
    # (quantize_row_q4_K_ref:2494-2510), so an all-non-positive column yields
    # +0.0 — never -0.0 (which would flip the f16 dmin sign byte)
    max_scale = np.where(scales.max(1) > 0, scales.max(1), np.float32(0.0))
    max_min = np.where(mins.max(1) > 0, mins.max(1), np.float32(0.0))
    with np.errstate(divide="ignore"):
        inv_scale = np.where(max_scale > 0, 63.0 / max_scale, 0.0
                             ).astype(np.float32)
        inv_min = np.where(max_min > 0, 63.0 / max_min, 0.0
                           ).astype(np.float32)
    # C casts nearest_int to uint8_t (mod 256) BEFORE MIN(63, ·), so a
    # negative regression scale wraps high then clamps to 63
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales) & 0xFF
                    ).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins) & 0xFF
                    ).astype(np.uint8)
    packed_sc = _pack_k4_scales(ls, lm)
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)

    # re-quantize L against the DECODED (f16, 6-bit) scales, like the ref
    sc_dec, m_dec = _unpack_k4_scales(packed_sc)
    dd = (d.astype(np.float32)[:, None] * sc_dec.astype(np.float32)
          ).astype(np.float32)                           # (nb, 8)
    dm = (dmin.astype(np.float32)[:, None] * m_dec.astype(np.float32)
          ).astype(np.float32)
    safe = np.where(dd != 0, dd, 1.0)
    L2 = np.clip(_nearest_int((xb.reshape(nb, 8, 32) + dm[:, :, None])
                              / safe[:, :, None]), 0, 15)
    L = np.where((dd != 0)[:, :, None], L2, L).astype(np.uint8)

    # pack nibbles: per 64-chunk, low = elems 0..31, high = 32..63
    Lc = L.reshape(nb, 4, 2, 32)
    qs = (Lc[:, :, 0] | (Lc[:, :, 1] << 4)).reshape(nb, 128).astype(np.uint8)

    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = packed_sc
    out[:, 16:] = qs
    return out.reshape(-1)


def dequantize_q4_K(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 144)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)    # (nb, 1)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, m = _unpack_k4_scales(b[:, 4:16])
    qs = b[:, 16:].reshape(nb, 4, 32)
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)
    dd = d * sc.astype(np.float32)                               # (nb, 8)
    dm = dmin * m.astype(np.float32)
    y = dd[:, :, None] * q - dm[:, :, None]
    return y.astype(np.float32).reshape(-1)[:n]


def quantize_q5_K(x: np.ndarray) -> np.ndarray:
    """quantize_row_q5_K_ref (ggml-quants.c:2676): q4_K's structure with
    5-bit quants (nmax 31, rmin -0.5, nstep 15); the 5th bits go to qh."""
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if xb.size % QK_K:
        raise ValueError(f"size {xb.size} not a multiple of {QK_K}")
    nb = xb.size // QK_K
    xg = xb.reshape(nb * 8, 32)

    sum_x2 = _seqsum((xg * xg).astype(np.float32))
    av_x = np.sqrt((sum_x2 / np.float32(32.0)).astype(np.float32)
                   ).astype(np.float32)
    weights = (av_x[:, None] + np.abs(xg)).astype(np.float32)
    scales, mins, L = _make_qkx2_quants(xg, weights, 31, -0.5, 0.1, 15)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L.reshape(nb, 8, 32)

    max_scale = np.where(scales.max(1) > 0, scales.max(1), np.float32(0.0))
    max_min = np.where(mins.max(1) > 0, mins.max(1), np.float32(0.0))
    with np.errstate(divide="ignore"):
        inv_scale = np.where(max_scale > 0, 63.0 / max_scale, 0.0
                             ).astype(np.float32)
        inv_min = np.where(max_min > 0, 63.0 / max_min, 0.0
                           ).astype(np.float32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales) & 0xFF
                    ).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins) & 0xFF
                    ).astype(np.uint8)
    packed_sc = _pack_k4_scales(ls, lm)
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)

    sc_dec, m_dec = _unpack_k4_scales(packed_sc)
    dd = (d.astype(np.float32)[:, None] * sc_dec.astype(np.float32)
          ).astype(np.float32)
    dm = (dmin.astype(np.float32)[:, None] * m_dec.astype(np.float32)
          ).astype(np.float32)
    safe = np.where(dd != 0, dd, 1.0)
    L2 = np.clip(_nearest_int((xb.reshape(nb, 8, 32) + dm[:, :, None])
                              / safe[:, :, None]), 0, 31)
    L = np.where((dd != 0)[:, :, None], L2, L).astype(np.int32)

    # per 64-chunk: ql nibbles hold (l & 15) of the two 32-halves; qh[j]
    # collects the 5th bits, two bits per chunk (quantize_row_q5_K_ref:2742)
    Lc = L.reshape(nb, 4, 2, 32)
    hi = (Lc > 15).astype(np.uint8)              # (nb, 4, 2, 32)
    lo = (Lc - (hi.astype(np.int32) << 4)).astype(np.uint8)
    ql = (lo[:, :, 0] | (lo[:, :, 1] << 4)).reshape(nb, 128)
    shifts = (2 * np.arange(4))[None, :, None, None]
    qh = ((hi.astype(np.uint32) << shifts)
          << np.array([0, 1])[None, None, :, None]).sum(axis=(1, 2)
                                                        ).astype(np.uint8)

    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = packed_sc
    out[:, 16:48] = qh
    out[:, 48:] = ql
    return out.reshape(-1)


def dequantize_q5_K(raw: np.ndarray, n: int) -> np.ndarray:
    """dequantize_row_q5_K (ggml-quants.c:2763)."""
    b = raw.reshape(-1, 176)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, m = _unpack_k4_scales(b[:, 4:16])
    qh = b[:, 16:48]                              # (nb, 32)
    qs = b[:, 48:].reshape(nb, 4, 32)
    lo = (qs & 0xF).astype(np.int32)
    hi4 = (qs >> 4).astype(np.int32)
    shifts = (2 * np.arange(4))[None, :, None]
    bit_lo = ((qh[:, None, :] >> shifts) & 1).astype(np.int32)
    bit_hi = ((qh[:, None, :] >> (shifts + 1)) & 1).astype(np.int32)
    q = np.stack([lo + (bit_lo << 4), hi4 + (bit_hi << 4)],
                 axis=2).reshape(nb, 8, 32).astype(np.float32)
    dd = d * sc.astype(np.float32)
    dm = dmin * m.astype(np.float32)
    y = dd[:, :, None] * q - dm[:, :, None]
    return y.astype(np.float32).reshape(-1)[:n]


def quantize_q2_K(x: np.ndarray) -> np.ndarray:
    """quantize_row_q2_K_ref (ggml-quants.c:1909): per-16 groups, 2-bit
    quants, 4-bit super-quantized scales|mins, use_mad search."""
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if xb.size % QK_K:
        raise ValueError(f"size {xb.size} not a multiple of {QK_K}")
    nb = xb.size // QK_K
    xg = xb.reshape(nb * 16, 16)

    weights = np.abs(xg).astype(np.float32)
    scales, mins, L = _make_qkx2_quants(xg, weights, 3, -0.5, 0.1, 15,
                                        use_mad=True)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    L = L.reshape(nb, 16, 16).astype(np.int32)

    max_scale = np.where(scales.max(1) > 0, scales.max(1), np.float32(0.0))
    max_min = np.where(mins.max(1) > 0, mins.max(1), np.float32(0.0))
    with np.errstate(divide="ignore"):
        inv_scale = np.where(max_scale > 0,
                             np.float32(15.0) / max_scale, np.float32(0.0)
                             ).astype(np.float32)
        inv_min = np.where(max_min > 0,
                           np.float32(15.0) / max_min, np.float32(0.0)
                           ).astype(np.float32)
    # C stores the UNCLAMPED nearest_int into a uint8 (mod 256), then ORs
    # the min nibble over it (quantize_row_q2_K_ref:1937-1957); blocks with
    # max <= 0 write zeros (inv forced to 0 keeps those lanes finite)
    ls = np.where(max_scale[:, None] > 0,
                  _nearest_int(inv_scale[:, None] * scales), 0) & 0xFF
    lm = np.where(max_min[:, None] > 0,
                  _nearest_int(inv_min[:, None] * mins), 0)
    sc_bytes = (ls | ((lm << 4) & 0xFF)).astype(np.uint8)      # (nb, 16)
    d = np.where(max_scale > 0, max_scale / np.float32(15.0),
                 np.float32(0.0)).astype(np.float16)
    dmin = np.where(max_min > 0, max_min / np.float32(15.0),
                    np.float32(0.0)).astype(np.float16)

    dd = (d.astype(np.float32)[:, None]
          * (sc_bytes & 0xF).astype(np.float32)).astype(np.float32)
    dm = (dmin.astype(np.float32)[:, None]
          * (sc_bytes >> 4).astype(np.float32)).astype(np.float32)
    safe = np.where(dd != 0, dd, 1.0)
    L2 = np.clip(_nearest_int((xb.reshape(nb, 16, 16) + dm[:, :, None])
                              / safe[:, :, None]), 0, 3)
    L = np.where((dd != 0)[:, :, None], L2, L).astype(np.uint8)

    # 2-bit packing: 128-chunks, byte j/4+l = L[j+l] | L[+32]<<2 | ... <<6
    Lq = L.reshape(nb, 2, 4, 32)
    qs = (Lq[:, :, 0] | (Lq[:, :, 1] << 2) | (Lq[:, :, 2] << 4)
          | (Lq[:, :, 3] << 6)).reshape(nb, 64).astype(np.uint8)

    out = np.empty((nb, 84), np.uint8)
    out[:, 0:16] = sc_bytes
    out[:, 16:80] = qs
    out[:, 80:82] = d.view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q2_K(raw: np.ndarray, n: int) -> np.ndarray:
    """dequantize_row_q2_K (ggml-quants.c:1979)."""
    b = raw.reshape(-1, 84)
    nb = b.shape[0]
    sc_bytes = b[:, 0:16]
    qs = b[:, 16:80].reshape(nb, 2, 2, 16)     # (chunk, half-of-16, l)
    d = b[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 82:84].copy().view(np.float16).astype(np.float32)
    # group g = 8*chunk + 2*shift_idx + half; elements qs[chunk, half, l]
    # >> (2*shift_idx)
    shifts = (2 * np.arange(4))[None, None, :, None, None]
    q2 = ((qs[:, :, None, :, :] >> shifts) & 3).astype(np.float32)
    # q2: (nb, chunk, j, half, 16) -> group order (nb, 16, 16)
    q2 = q2.reshape(nb, 16, 16)
    dl = d * (sc_bytes & 0xF).astype(np.float32)       # (nb, 16)
    ml = dmin * (sc_bytes >> 4).astype(np.float32)
    y = dl[:, :, None] * q2 - ml[:, :, None]
    return y.astype(np.float32).reshape(-1)[:n]


def _make_q3_quants(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized make_q3_quants (do_rmse=True, ggml-quants.c:1715-1765):
    weighted init then 5 rounds of SEQUENTIAL per-element coordinate
    descent (running sums mutate within a round, so the element loop stays
    a loop; groups are vectorized). Returns (scale (G,), L (G,n) uint8 with
    +nmax offset)."""
    f32 = np.float32
    x = x.astype(f32)
    G, n = x.shape
    a = np.abs(x)
    idx = np.argmax(a, axis=1)
    rows = np.arange(G)
    amax = a[rows, idx]
    maxv = x[rows, idx]
    dead = amax < f32(1e-15)                    # GROUP_MAX_EPS
    safe_max = np.where(dead, f32(1.0), maxv)

    iscale = (f32(-nmax) / safe_max).astype(f32)
    L = np.clip(_nearest_int((iscale[:, None] * x).astype(f32)),
                -nmax, nmax - 1)
    w = (x * x).astype(f32)
    wx = (w * x).astype(f32)
    Lf = L.astype(f32)
    sumlx = _seqsum((wx * Lf).astype(f32))
    suml2 = _seqsum(((w * Lf).astype(f32) * Lf).astype(f32))
    active = ~dead
    for _ in range(5):
        changed_any = np.zeros(G, bool)
        for i in range(n):
            wi, xi = w[:, i], x[:, i]
            Li = L[:, i].astype(f32)
            slx = (sumlx - ((wi * xi).astype(f32) * Li).astype(f32)
                   ).astype(f32)
            sl2 = (suml2 - ((wi * Li).astype(f32) * Li).astype(f32)
                   ).astype(f32)
            pos = slx > 0
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                # inactive lanes may hit 0/0 or f32 overflow; they are
                # discarded by the `accept` mask exactly as C's early
                # `if (slx > 0)` skips them
                ratio = np.where(pos, ((xi * sl2).astype(f32)
                                       / np.where(pos, slx, f32(1.0))
                                       ).astype(f32), f32(0.0))
                new_l = np.clip(_nearest_int(ratio), -nmax, nmax - 1)
                nlf = new_l.astype(f32)
                slx2 = (slx + ((wi * xi).astype(f32) * nlf).astype(f32)
                        ).astype(f32)
                sl22 = (sl2 + ((wi * nlf).astype(f32) * nlf).astype(f32)
                        ).astype(f32)
                accept = (active & pos & (new_l != L[:, i]) & (sl22 > 0)
                          & (((slx2 * slx2).astype(f32) * suml2).astype(f32)
                             > ((sumlx * sumlx).astype(f32) * sl22
                                ).astype(f32)))
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx).astype(f32)
            suml2 = np.where(accept, sl22, suml2).astype(f32)
            changed_any |= accept
        active &= changed_any
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(f32)
    scale = np.where(dead, f32(0.0), scale)
    L = np.where(dead[:, None], 0, L + nmax)
    return scale.astype(np.float32), L.astype(np.uint8)


def quantize_q3_K(x: np.ndarray) -> np.ndarray:
    """quantize_row_q3_K_ref (ggml-quants.c:2251): per-16 groups, 3-bit
    symmetric quants, 6-bit packed scales, high bits in hmask."""
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if xb.size % QK_K:
        raise ValueError(f"size {xb.size} not a multiple of {QK_K}")
    nb = xb.size // QK_K
    xg = xb.reshape(nb, 16, 16)

    scales, L = _make_q3_quants(xg.reshape(-1, 16), 4)
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, 16, 16).astype(np.int32)

    absmax_idx = np.argmax(np.abs(scales), axis=1)
    rows = np.arange(nb)
    max_scale = scales[rows, absmax_idx]
    zero_blk = max_scale == 0.0                 # C: if (max_scale)
    safe_ms = np.where(zero_blk, np.float32(1.0), max_scale)

    iscale = (np.float32(-32.0) / safe_ms).astype(np.float32)
    sc6 = (np.clip(_nearest_int(iscale[:, None] * scales), -32, 31) + 32
           ).astype(np.int32)                   # (nb, 16), 0..63
    sc6 = np.where(zero_blk[:, None], 0, sc6)
    d = np.where(zero_blk, np.float32(0.0),
                 (np.float32(1.0) / iscale).astype(np.float32)
                 ).astype(np.float16)

    sc_bytes = np.zeros((nb, 12), np.uint8)
    sc_bytes[:, 0:8] = (sc6[:, :8] & 0xF) | ((sc6[:, 8:] & 0xF) << 4)
    hi2 = sc6 >> 4                               # (nb, 16), 0..3
    for k in range(4):
        sc_bytes[:, 8 + k] = (hi2[:, k] | (hi2[:, k + 4] << 2)
                              | (hi2[:, k + 8] << 4) | (hi2[:, k + 12] << 6))
    # zero_blk blocks keep all-zero scale bytes (C memsets then skips)

    # re-quantize against the decoded 6-bit scales (ggml-quants.c:2290)
    sc_dec = sc6 - 32
    dd = (d.astype(np.float32)[:, None] * sc_dec.astype(np.float32)
          ).astype(np.float32)
    safe = np.where(dd != 0, dd, 1.0)
    L2 = np.clip(_nearest_int(xg / safe[:, :, None]), -4, 3) + 4
    L = np.where((dd != 0)[:, :, None], L2, L).astype(np.int32)  # 0..7

    Lflat = L.reshape(nb, 256)
    pos = np.arange(256)
    hbit = (Lflat > 3).astype(np.uint32)
    hm = np.zeros((nb, 32), np.uint32)
    # hmask[j % 32] bit (j // 32) (quantize_row_q3_K_ref:2306-2316)
    for bit in range(8):
        seg = hbit[:, 32 * bit:32 * (bit + 1)]
        hm |= seg << bit
    hmask = hm.astype(np.uint8)
    Llow = np.where(Lflat > 3, Lflat - 4, Lflat)
    Lq = Llow.reshape(nb, 2, 4, 32)
    qs = (Lq[:, :, 0] | (Lq[:, :, 1] << 2) | (Lq[:, :, 2] << 4)
          | (Lq[:, :, 3] << 6)).reshape(nb, 64).astype(np.uint8)

    out = np.empty((nb, 110), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = sc_bytes
    out[:, 108:110] = d.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q3_K(raw: np.ndarray, n: int) -> np.ndarray:
    """dequantize_row_q3_K (ggml-quants.c:2327)."""
    b = raw.reshape(-1, 110)
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(nb, 2, 2, 16)     # (chunk, half, l)
    sc_bytes = b[:, 96:108].astype(np.int32)
    d = b[:, 108:110].copy().view(np.float16).astype(np.float32)

    # unpack 6-bit signed scales (get-scale logic quantize_row_q3_K_ref:2291)
    low = np.empty((nb, 16), np.int32)
    low[:, :8] = sc_bytes[:, :8] & 0xF
    low[:, 8:] = sc_bytes[:, :8] >> 4
    ks = np.arange(16)
    hi2 = (sc_bytes[:, 8 + (ks % 4)] >> (2 * (ks // 4))[None, :]) & 3
    sc = (low | (hi2 << 4)) - 32                 # (nb, 16)

    hmask_h = hmask.reshape(nb, 2, 16)           # [half, l]
    out = np.empty((nb, 16, 16), np.float32)
    for g in range(16):
        c, j, h = g // 8, (g % 8) // 2, g % 2
        q2 = ((qs[:, c, h] >> (2 * j)) & 3).astype(np.int32)
        hb = ((hmask_h[:, h] >> (4 * c + j)) & 1).astype(np.int32)
        val = (q2 - np.where(hb == 1, 0, 4)).astype(np.float32)
        out[:, g] = (d * sc[:, g:g + 1]).astype(np.float32) * val
    return out.astype(np.float32).reshape(-1)[:n]


def _make_qx_quants(x: np.ndarray, nmax: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized make_qx_quants (rmse_type=1, w = x^2): x (G, n).
    Returns (scale (G,), L (G, n) uint8 with +nmax offset).
    Strict f32 in the reference's operation order (see _make_qkx2_quants)."""
    f32 = np.float32
    x = x.astype(f32)
    G, n = x.shape
    a = np.abs(x)
    idx = np.argmax(a, axis=1)
    rows = np.arange(G)
    amax = a[rows, idx]
    maxv = x[rows, idx]
    dead = amax < f32(1e-15)                    # GROUP_MAX_EPS
    safe_max = np.where(dead, f32(1.0), maxv)

    w = (x * x).astype(f32)

    def pass_at(iscale):
        l = np.clip(_nearest_int((iscale[:, None] * x).astype(f32)),
                    -nmax, nmax - 1)
        lf = l.astype(f32)
        wx = (w * x).astype(f32)
        wl = (w * lf).astype(f32)
        sumlx = _seqsum((wx * lf).astype(f32))
        suml2 = _seqsum((wl * lf).astype(f32))
        return l, sumlx, suml2

    iscale0 = (f32(-nmax) / safe_max).astype(f32)
    L, sumlx, suml2 = pass_at(iscale0)
    scale = np.where(suml2 > 0,
                     (sumlx / np.where(suml2 > 0, suml2, f32(1.0))
                      ).astype(f32), f32(0.0))
    best = (scale * sumlx).astype(f32)
    for step in range(-9, 10):
        if step == 0:
            continue
        c = -f32(f32(nmax) + f32(f32(0.1) * f32(step)))
        isc = (c / safe_max).astype(f32)
        l, slx, sl2 = pass_at(isc)
        upd = (sl2 > 0) & (np.float32(slx * slx) > np.float32(best * sl2))
        L = np.where(upd[:, None], l, L)
        scale = np.where(upd, (slx / np.where(sl2 > 0, sl2, f32(1.0))
                               ).astype(f32), scale)
        best = np.where(upd, (scale * slx).astype(f32), best)

    L = np.where(dead[:, None], -nmax, L) + nmax
    scale = np.where(dead, f32(0.0), scale)
    return scale.astype(np.float32), L.astype(np.uint8)


def quantize_q6_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if xb.size % QK_K:
        raise ValueError(f"size {xb.size} not a multiple of {QK_K}")
    nb = xb.size // QK_K
    xg = xb.reshape(nb, 16, 16)

    scales, L = _make_qx_quants(xg.reshape(-1, 16), 32)
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, 16, 16).astype(np.int32)

    absmax_idx = np.argmax(np.abs(scales), axis=1)
    rows = np.arange(nb)
    max_scale = scales[rows, absmax_idx]
    dead_blk = np.abs(max_scale) < 1e-15        # GROUP_MAX_EPS
    safe_ms = np.where(dead_blk, 1.0, max_scale)

    iscale = (-128.0 / safe_ms).astype(np.float32)
    d = (1.0 / iscale).astype(np.float16)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)
                     ).astype(np.int8)

    dd = d.astype(np.float32)[:, None] * sc8.astype(np.float32)  # (nb, 16)
    safe = np.where(dd != 0, dd, 1.0)
    L2 = np.clip(_nearest_int(xg / safe[:, :, None]), -32, 31) + 32
    L = np.where((dd != 0)[:, :, None], L2, L).astype(np.uint8)

    # pack: per 128-chunk, ql holds nibbles of (0..31, 64..95) and
    # (32..63, 96..127); qh holds the two high bits of all four runs
    Lh = L.reshape(nb, 2, 4, 32)                # chunks of 128, 4 runs
    q1, q2, q3, q4 = (Lh[:, :, i] for i in range(4))
    ql = np.concatenate([(q1 & 0xF) | ((q3 & 0xF) << 4),
                         (q2 & 0xF) | ((q4 & 0xF) << 4)], axis=2)
    qh = ((q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4)
          | ((q4 >> 4) << 6))
    zero = dead_blk[:, None]

    out = np.empty((nb, 210), np.uint8)
    out[:, 0:128] = np.where(zero, 0, ql.reshape(nb, 128)).astype(np.uint8)
    out[:, 128:192] = np.where(zero, 0, qh.reshape(nb, 64)).astype(np.uint8)
    out[:, 192:208] = np.where(zero, 0,
                               sc8.view(np.uint8).reshape(nb, 16))
    dz = np.where(dead_blk, np.float16(0.0), d).astype(np.float16)
    out[:, 208:210] = dz.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q6_K(raw: np.ndarray, n: int) -> np.ndarray:
    b = raw.reshape(-1, 210)
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)
    qh = b[:, 128:192].reshape(nb, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32)  # (nb, 16)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)  # (nb, 1)

    lo = ql & 0xF
    hi = ql >> 4
    q1 = (lo[:, :, :32] | (((qh >> 0) & 3) << 4)).astype(np.int32) - 32
    q2 = (lo[:, :, 32:] | (((qh >> 2) & 3) << 4)).astype(np.int32) - 32
    q3 = (hi[:, :, :32] | (((qh >> 4) & 3) << 4)).astype(np.int32) - 32
    q4 = (hi[:, :, 32:] | (((qh >> 6) & 3) << 4)).astype(np.int32) - 32
    q = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, 256)  # position order
    dsc = d * np.repeat(sc, 16, axis=1)          # d * sc[pos // 16]
    y = dsc * q.astype(np.float32)
    return y.astype(np.float32).reshape(-1)[:n]


_QUANTIZERS = {
    GGMLType.Q2_K: quantize_q2_K,
    GGMLType.Q3_K: quantize_q3_K,
    GGMLType.Q4_K: quantize_q4_K,
    GGMLType.Q5_K: quantize_q5_K,
    GGMLType.Q6_K: quantize_q6_K,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q8_0: quantize_q8_0,
}

_DEQUANTIZERS = {
    GGMLType.Q2_K: dequantize_q2_K,
    GGMLType.Q3_K: dequantize_q3_K,
    GGMLType.Q4_K: dequantize_q4_K,
    GGMLType.Q5_K: dequantize_q5_K,
    GGMLType.Q6_K: dequantize_q6_K,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q8_0: dequantize_q8_0,
}


def quantize(x: np.ndarray, ttype: GGMLType) -> np.ndarray:
    """float32 array -> packed uint8 bytes in the given ggml block format."""
    return _QUANTIZERS[GGMLType(ttype)](x)


def dequantize(raw: np.ndarray, ttype: GGMLType, n: int | None = None) -> np.ndarray:
    """packed uint8 bytes -> flat float32 array of n elements."""
    ttype = GGMLType(ttype)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if n is None:
        if ttype in KBLOCK_BYTES:
            n = raw.size // KBLOCK_BYTES[ttype] * QK_K
        else:
            n = raw.size // BLOCK_BYTES[ttype] * QK
    return _DEQUANTIZERS[ttype](raw, n)


def type_size_bytes(ttype: GGMLType, n_elements: int) -> int:
    """Total storage bytes for n_elements in the given format."""
    ttype = GGMLType(ttype)
    if ttype == GGMLType.F32:
        return 4 * n_elements
    if ttype in (GGMLType.F16, GGMLType.BF16):
        return 2 * n_elements
    if ttype in BLOCK_BYTES:
        if n_elements % QK:
            raise ValueError(f"{n_elements} not a multiple of {QK}")
        return n_elements // QK * BLOCK_BYTES[ttype]
    if ttype in KBLOCK_BYTES:
        if n_elements % QK_K:
            raise ValueError(f"{n_elements} not a multiple of {QK_K}")
        return n_elements // QK_K * KBLOCK_BYTES[ttype]
    raise ValueError(f"unsupported ggml type {ttype}")
