"""Card-side quantized weight construction.

Bridges the ggml block formats (quant/codecs.py) to the kernel layout of
ops/quant_matmul.py: values are carried over BIT-EXACT from the ggml
blocks, (nibble - 8) * d for q4_0, int8 * d for q8_0 and so on, so a
checkpoint quantized by ggml and loaded here gives identical dequantized
weights. ggml stores torch [out, in] rows with groups along ``in``; the
kernel layout is [in, out] with scales (in // group, out).

One explicit form with one default:

    qs      int8 values (K, N)
    qs4     uint8 nibble bytes (K // 2, N), for q4_0 / q4_1 / q4_K when
            ``Q4Form.packed`` (the default)
    scales  float16 where the block's d is a raw f16 payload (q4_0, q4_1,
            q5_0, q5_1, q8_0: lossless), float32 for the k-quants' products
    mins    float32; q4_0 is symmetric by default (no "mins" leaf, the
            kernel subtracts 8), ``Q4Form(sym=False)`` folds -8 * d into one
    qs4b    int32 words of symmetric q4_0 nibbles (K // 8, N) with
            ``Q4Form(b32=True)``: word r packs byte rows 4r .. 4r + 3 of
            "qs4" (ops.quant_matmul_q4b.pack_b32); the other 4-bit formats
            keep "qs4", their mins having no place in that kernel
    qs_p, qs4_p, scales_p
            the same values in contiguous column panels (P, rows, bn), made
            from the forms above by ops.quant_matmul.panelize_weight
    qs8, scale_n
            the per-channel w8a8 form (``mode="fast"``): int8 values (K, N)
            and one float32 scale per output column (N,), multiplied by
            ops.linear's int8 x int8 -> int32 product

All ten formats reduce to ``w = q * d (+ m)``: q4_K / q5_K at 32-group
granularity (super-block scale times 6-bit sub-scale), q2_K / q3_K / q6_K at
16 (the kernels derive the group size from the scales' shape).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.io.ggml_format import GGMLTensor
from qwen2_audio_tpu_torch.ops.quant_matmul_q4b import pack_b32
from qwen2_audio_tpu_torch.quant import codecs
from qwen2_audio_tpu_torch.quant.codecs import QK

QUANT_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
               GGMLType.Q8_0, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
               GGMLType.Q5_K, GGMLType.Q6_K)
# formats whose scale is the block's raw f16 d: float16 storage is lossless
_F16_SCALES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
               GGMLType.Q8_0)


@dataclasses.dataclass(frozen=True)
class Q4Form:
    """The payload form of the 4-bit formats (q4_0, q4_1, q4_K).

    ``packed``: two nibbles per byte ("qs4") or one int8 value each ("qs");
    ``sym``: q4_0 without a "mins" leaf, (q - 8) * d inside the kernel;
    ``b32``: q4_0's nibbles as int32 words ("qs4b"), which needs ``packed``
    and ``sym`` (the word kernel has no mins).
    """
    packed: bool = True
    sym: bool = True
    b32: bool = False

    def __post_init__(self):
        if self.b32 and not (self.packed and self.sym):
            raise ValueError("Q4Form.b32 requires packed symmetric q4_0 (the word-packed "
                             "kernel has no mins path)")


def payload_form(qw: dict) -> str:
    """Canonical name of a quantized payload's form, from its keys and
    types (what the kernels dispatch on)."""
    def sc(a) -> str:
        return {torch.float32: "f32sc", torch.float16: "f16sc"}[a.dtype]
    if "qs8" in qw:
        return "w8a8"
    if "qs4b" in qw:
        return "packed4-b32+sym+" + sc(qw["scales"])
    for qkey, panel in (("qs4", ""), ("qs4_p", "-panel")):
        if qkey in qw:
            return "+".join(("packed4" + panel, "sym" if "mins" not in qw else "mins",
                             "u8", sc(qw["scales_p" if panel else "scales"])))
    for qkey, panel in (("qs", ""), ("qs_p", "-panel")):
        if qkey in qw:
            return "+".join(("strided" + panel, "sym" if "mins" not in qw else "mins",
                             sc(qw["scales_p" if panel else "scales"])))
    raise ValueError(f"not a quantized payload: keys={sorted(qw)}")


def _scales(s: np.ndarray, f16_exact: bool) -> torch.Tensor:
    """(N, K // group) float32 -> (K // group, N), float16 where lossless."""
    s = np.ascontiguousarray(s.T, dtype=np.float32)
    return torch.from_numpy(s.astype(np.float16) if f16_exact else s)


def pack4_device_weight(vals_unsigned: np.ndarray, scales: np.ndarray,
                        mins: np.ndarray | None, f16_exact: bool = False,
                        form: Q4Form | None = None) -> dict:
    """Unsigned nibbles (N, K) 0..15 with scales and mins (N, K // 32) in
    torch layout -> {"qs4": (K // 2, N) uint8, "scales"[, "mins"]}. Byte
    g * 16 + j pairs values g * 32 + j (low) and g * 32 + j + 16 (high) along
    the input axis, ggml's own in-group pairing (block_q4_0). With
    ``form.b32`` and no mins: {"qs4b": (K // 8, N) int32, "scales"}, the same
    bytes 4 rows to a word."""
    vT = np.ascontiguousarray(vals_unsigned.T).astype(np.uint8)   # (K, N)
    K, N = vT.shape
    g = vT.reshape(K // QK, QK, N)
    packed = (g[:, :16] | (g[:, 16:] << 4)).reshape(K // 2, N)
    if form is not None and form.b32 and mins is None:
        return {"qs4b": torch.from_numpy(pack_b32(packed)), "scales": _scales(scales, f16_exact)}
    out = {"qs4": torch.from_numpy(np.ascontiguousarray(packed)),
           "scales": _scales(scales, f16_exact)}
    if mins is not None:
        out["mins"] = torch.from_numpy(np.ascontiguousarray(mins.T, dtype=np.float32))
    return out


def device_weight_from_arrays(q_values: np.ndarray, scales: np.ndarray,
                              f16_exact: bool = False) -> dict:
    """q_values (N, K) integers and scales (N, K // group) in torch layout
    -> {"qs": (K, N) int8, "scales": (K // group, N)}."""
    return {"qs": torch.from_numpy(np.ascontiguousarray(q_values.T, dtype=np.int8)),
            "scales": _scales(scales, f16_exact)}


def _unpack_q4_0(raw: np.ndarray, n_rows: int, n_cols: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    b = raw.reshape(-1, 18)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)      # (nb,)
    lo = (b[:, 2:] & 0x0F).astype(np.int8) - 8
    hi = (b[:, 2:] >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1)                      # (nb, 32)
    return (vals.reshape(n_rows, n_cols),
            d.reshape(n_rows, n_cols // QK))


def _unpack_q8_0(raw: np.ndarray, n_rows: int, n_cols: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    b = raw.reshape(-1, 34)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    vals = b[:, 2:].view(np.int8)
    return (vals.reshape(n_rows, n_cols),
            d.reshape(n_rows, n_cols // QK))


def _unpack_nibble_body(body: np.ndarray) -> np.ndarray:
    lo = (body & 0x0F).astype(np.int8)
    hi = (body >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=1)           # j / j+16 layout


def _unpack_qh_bits(qh_bytes: np.ndarray) -> np.ndarray:
    qh = qh_bytes.copy().view(np.uint32).reshape(-1)
    shifts = np.arange(32, dtype=np.uint32)
    return (((qh[:, None] >> shifts[None, :]) & 1) << 4).astype(np.int8)


def _unpack_q4_1(raw, n_rows, n_cols):
    b = raw.reshape(-1, 20)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    vals = _unpack_nibble_body(b[:, 4:])              # 0..15
    return (vals.reshape(n_rows, n_cols), d.reshape(n_rows, n_cols // QK),
            m.reshape(n_rows, n_cols // QK))


def _unpack_q5_0(raw, n_rows, n_cols):
    b = raw.reshape(-1, 22)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    vals = (_unpack_nibble_body(b[:, 6:]) | _unpack_qh_bits(b[:, 2:6])) - 16
    return (vals.reshape(n_rows, n_cols).astype(np.int8),
            d.reshape(n_rows, n_cols // QK))


def _unpack_q5_1(raw, n_rows, n_cols):
    b = raw.reshape(-1, 24)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    vals = _unpack_nibble_body(b[:, 8:]) | _unpack_qh_bits(b[:, 4:8])  # 0..31
    return (vals.reshape(n_rows, n_cols), d.reshape(n_rows, n_cols // QK),
            m.reshape(n_rows, n_cols // QK))


def _unpack_q4_K(raw, n_rows, n_cols):
    """q4_K super-blocks -> the generic {vals 0..15, per-32-group scale,
    per-32-group (negative) min} form: within one 256 super-block the j-th
    32-subblock dequantizes as w = (d*sc_j)*q - (dmin*m_j), which is
    exactly the q4_1-style scale+min layout at group granularity 32."""
    from qwen2_audio_tpu_torch.quant.codecs import _unpack_k4_scales
    b = raw.reshape(-1, 144)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, m = _unpack_k4_scales(b[:, 4:16])
    qs = b[:, 16:].reshape(nb, 4, 32)
    lo = (qs & 0xF).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    vals = np.stack([lo, hi], axis=2).reshape(nb, 256)
    scales = d * sc.astype(np.float32)            # (nb, 8)
    mins = -(dmin * m.astype(np.float32))
    return (vals.reshape(n_rows, n_cols),
            scales.reshape(n_rows, n_cols // QK),
            mins.reshape(n_rows, n_cols // QK))


def _unpack_q5_K(raw, n_rows, n_cols):
    """q5_K super-blocks -> {vals 0..31, per-32-group scale, per-32-group
    (negative) min}: same q4_1-style form as q4_K with the 5th bit from
    qh (layout dequantize_row_q5_K, ggml-quants.c:2763)."""
    from qwen2_audio_tpu_torch.quant.codecs import _unpack_k4_scales
    b = raw.reshape(-1, 176)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, m = _unpack_k4_scales(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:].reshape(nb, 4, 32)
    lo = (qs & 0xF).astype(np.int32)
    hi4 = (qs >> 4).astype(np.int32)
    shifts = (2 * np.arange(4))[None, :, None]
    bit_lo = ((qh[:, None, :] >> shifts) & 1).astype(np.int32)
    bit_hi = ((qh[:, None, :] >> (shifts + 1)) & 1).astype(np.int32)
    vals = np.stack([lo + (bit_lo << 4), hi4 + (bit_hi << 4)],
                    axis=2).reshape(nb, 256).astype(np.int8)
    scales = d * sc.astype(np.float32)            # (nb, 8)
    mins = -(dmin * m.astype(np.float32))
    return (vals.reshape(n_rows, n_cols),
            scales.reshape(n_rows, n_cols // QK),
            mins.reshape(n_rows, n_cols // QK))


def _unpack_q2_K(raw, n_rows, n_cols):
    """q2_K super-blocks -> {vals 0..3, per-16-group scale, per-16-group
    (negative) min}: w = (d*sc_g)*q - (dmin*m_g) per 16-element sub-block
    (layout dequantize_row_q2_K, ggml-quants.c:1979)."""
    b = raw.reshape(-1, 84)
    nb = b.shape[0]
    sc_bytes = b[:, 0:16]
    qs = b[:, 16:80].reshape(nb, 2, 2, 16)
    d = b[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 82:84].copy().view(np.float16).astype(np.float32)
    shifts = (2 * np.arange(4))[None, None, :, None, None]
    q2 = ((qs[:, :, None, :, :] >> shifts) & 3).astype(np.int8)
    vals = q2.reshape(nb, 256)
    scales = d * (sc_bytes & 0xF).astype(np.float32)     # (nb, 16)
    mins = -(dmin * (sc_bytes >> 4).astype(np.float32))
    return (vals.reshape(n_rows, n_cols),
            scales.reshape(n_rows, n_cols // 16),
            mins.reshape(n_rows, n_cols // 16))


def _unpack_q3_K(raw, n_rows, n_cols):
    """q3_K super-blocks -> {vals -4..3, per-16-group SIGNED scale}:
    w = (d*sc_g)*q, sc 6-bit signed (layout dequantize_row_q3_K,
    ggml-quants.c:2327)."""
    b = raw.reshape(-1, 110)
    nb = b.shape[0]
    hmask = b[:, 0:32].reshape(nb, 2, 16)
    qs = b[:, 32:96].reshape(nb, 2, 2, 16)
    sc_bytes = b[:, 96:108].astype(np.int32)
    d = b[:, 108:110].copy().view(np.float16).astype(np.float32)

    low = np.empty((nb, 16), np.int32)
    low[:, :8] = sc_bytes[:, :8] & 0xF
    low[:, 8:] = sc_bytes[:, :8] >> 4
    ks = np.arange(16)
    hi2 = (sc_bytes[:, 8 + (ks % 4)] >> (2 * (ks // 4))[None, :]) & 3
    sc = (low | (hi2 << 4)) - 32                          # (nb, 16) signed

    vals = np.empty((nb, 16, 16), np.int8)
    for g in range(16):
        c, j, h = g // 8, (g % 8) // 2, g % 2
        q2 = ((qs[:, c, h] >> (2 * j)) & 3).astype(np.int32)
        hb = ((hmask[:, h] >> (4 * c + j)) & 1).astype(np.int32)
        vals[:, g] = (q2 - np.where(hb == 1, 0, 4)).astype(np.int8)
    scales = d * sc.astype(np.float32)
    return (vals.reshape(n_rows, n_cols),
            scales.reshape(n_rows, n_cols // 16))


def _unpack_q6_K(raw, n_rows, n_cols):
    """q6_K super-blocks -> {vals -32..31, per-16-group SIGNED scale}:
    w = (d*sc_g)*q, sc int8 (layout dequantize_row_q6_K,
    ggml-quants.c:3026)."""
    b = raw.reshape(-1, 210)
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)
    qh = b[:, 128:192].reshape(nb, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32)  # (nb, 16)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)

    lo = ql & 0xF
    hi = ql >> 4
    q1 = (lo[:, :, :32] | (((qh >> 0) & 3) << 4)).astype(np.int32) - 32
    q2 = (lo[:, :, 32:] | (((qh >> 2) & 3) << 4)).astype(np.int32) - 32
    q3 = (hi[:, :, :32] | (((qh >> 4) & 3) << 4)).astype(np.int32) - 32
    q4 = (hi[:, :, 32:] | (((qh >> 6) & 3) << 4)).astype(np.int32) - 32
    vals = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, 256)
    scales = d * sc
    return (vals.reshape(n_rows, n_cols).astype(np.int8),
            scales.reshape(n_rows, n_cols // 16))


def device_weight_from_ggml_tensor(t: GGMLTensor, form: Q4Form | None = None,
                                   device: torch.device | str = "cpu") -> dict:
    """A quantized GGMLTensor (torch [out, in] shape) as a kernel dict on
    ``device``, bit-exact. ``form`` chooses the payload of the 4-bit
    formats (default: packed, q4_0 symmetric)."""
    form = form or Q4Form()
    n_rows, n_cols = t.shape
    raw = np.asarray(t.raw)
    tt = GGMLType(t.ttype)
    f16 = tt in _F16_SCALES
    if tt == GGMLType.Q4_0:
        vals, d = _unpack_q4_0(raw, n_rows, n_cols)
        if form.packed:
            # symmetric: no mins leaf; else w = n * d + (-8 * d), the offset
            # folded into the min term as for q4_1 / q4_K
            out = pack4_device_weight(vals + 8, d, None if form.sym else -8.0 * d,
                                      f16_exact=True, form=form)
        else:
            out = device_weight_from_arrays(vals, d, f16_exact=True)
    elif tt in (GGMLType.Q8_0, GGMLType.Q5_0):
        unpack = _unpack_q8_0 if tt == GGMLType.Q8_0 else _unpack_q5_0
        out = device_weight_from_arrays(*unpack(raw, n_rows, n_cols), f16_exact=True)
    elif tt in (GGMLType.Q4_1, GGMLType.Q5_1, GGMLType.Q4_K, GGMLType.Q5_K,
                GGMLType.Q2_K):
        unpack = {GGMLType.Q4_1: _unpack_q4_1, GGMLType.Q5_1: _unpack_q5_1,
                  GGMLType.Q4_K: _unpack_q4_K, GGMLType.Q5_K: _unpack_q5_K,
                  GGMLType.Q2_K: _unpack_q2_K}[tt]
        vals, d, m = unpack(raw, n_rows, n_cols)     # m already in +m form
        if tt in (GGMLType.Q4_1, GGMLType.Q4_K) and form.packed:
            out = pack4_device_weight(vals, d, m, f16_exact=f16, form=form)
        else:
            out = device_weight_from_arrays(vals, d, f16_exact=f16)
            out["mins"] = torch.from_numpy(np.ascontiguousarray(m.T, dtype=np.float32))
    elif tt in (GGMLType.Q3_K, GGMLType.Q6_K):
        unpack = _unpack_q3_K if tt == GGMLType.Q3_K else _unpack_q6_K
        out = device_weight_from_arrays(*unpack(raw, n_rows, n_cols))
    else:
        raise ValueError(f"unsupported quantized type {t.ttype}")
    return {k: v.to(device) for k, v in out.items()}


def q8_0_from_array(w: torch.Tensor) -> dict:
    """ggml's quantize_row_q8_0 over the 32-groups along K of a float32
    (K, N) weight, in torch on the weight's device (threads on the CPU):
    d = max|w| / 127 a group, q = round(w / d) half away from zero, d stored
    float16. The same bits as ``codecs.quantize`` then unpacking (the same
    float32 operations, IEEE quotients), without the byte stream: a 7B
    lm_head in seconds instead of minutes."""
    K, N = w.shape
    if K % QK:
        raise ValueError(f"q8_0: K {K} is not a multiple of {QK}")
    wb = w.float().reshape(K // QK, QK, N)
    amax = wb.abs().amax(dim=1)
    d = amax / torch.full_like(amax, 127.0)
    nz = d != 0
    one = torch.ones_like(d)
    inv = torch.where(nz, one / torch.where(nz, d, one), torch.zeros_like(d))
    scaled = wb * inv[:, None, :]
    q = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    return {"qs": q.to(torch.int8).reshape(K, N), "scales": d.to(torch.float16)}


def quantize_array_for_device(w, ttype: GGMLType, form: Q4Form | None = None,
                              device: torch.device | str = "cpu") -> dict:
    """Dense [in, out] float weight -> kernel dict (groups along in), through
    the ggml quantizers so values round-trip exactly through files (q8_0 by
    ``q8_0_from_array``, the same bits)."""
    if GGMLType(ttype) == GGMLType.Q8_0:
        w = torch.as_tensor(w).detach().to("cpu", torch.float32)
        return {k: v.to(device) for k, v in q8_0_from_array(w).items()}
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    w = np.asarray(w, dtype=np.float32)
    K, N = w.shape
    raw = codecs.quantize(np.ascontiguousarray(w.T), ttype)   # rows = out
    return device_weight_from_ggml_tensor(GGMLTensor("_", (N, K), ttype, raw),
                                          form=form, device=device)


def fast_w8_from_array(w, device: torch.device | str | None = None) -> dict:
    """Dense [in, out] float weight -> the per-channel w8a8 form {"qs8":
    int8 (K, N), "scale_n": float32 (N,)}: s = max|w| / 127 over each
    column, q = rint(w / s). Not bit-compatible with the ggml blocks (one
    scale per output channel, not per 32-group). The arithmetic is the JAX
    package's float32 numpy, in torch (threads); the leaves land on
    ``device`` (default: the weight's own, the CPU for numpy)."""
    if isinstance(w, torch.Tensor):
        device = w.device if device is None else device
    w = torch.as_tensor(w).detach().to("cpu", torch.float32)
    amax = w.abs().amax(dim=0)                                           # (N,)
    s = amax / torch.full_like(amax, 127.0)
    pos = s > 0
    one = torch.ones_like(s)
    inv = torch.where(pos, one / torch.where(pos, s, one), torch.zeros_like(s))
    q = torch.round(w * inv[None, :]).to(torch.int8)     # half to even, as np.rint
    device = "cpu" if device is None else device
    return {"qs8": q.to(device), "scale_n": s.to(device)}


def fast_w8_from_ggml_blocks(qw: dict) -> dict:
    """A ggml block dict re-quantized to the per-channel w8a8 form
    (dequantize, then ``fast_w8_from_array``), on the block dict's device."""
    from qwen2_audio_tpu_torch.ops.quant_matmul import dequantize_weight
    return fast_w8_from_array(dequantize_weight(qw).cpu(), device=qw["scales"].device)


_DECODER_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")
_ENCODER_QUANT_KEYS = ("q", "k", "v", "o", "fc1", "fc2")
_MODES = ("ggml", "fast")


def _quantizer(ttype: GGMLType, mode: str, form: Q4Form | None):
    """w, device -> the dict of one weight: ggml blocks (``mode="ggml"``)
    or the per-channel w8a8 form (``mode="fast"``)."""
    if mode not in _MODES:
        raise ValueError(f"unknown quantization mode {mode!r}: want one of {_MODES}")
    if mode == "fast":
        return fast_w8_from_array
    return lambda w, device: quantize_array_for_device(w, ttype, form=form, device=device)


def quantize_decoder_params(params: dict, ttype: GGMLType,
                            quantize_lm_head: bool = True, mode: str = "ggml",
                            form: Q4Form | None = None) -> dict:
    """Replace the stacked decoder linears (L, K, N) by quantized dicts
    whose leaves are stacked the same way, on the device of the dense
    weights; biases, norms and the embedding stay dense.

    mode="ggml": {"qs": (L, K, N), "scales": (L, K // group, N)}, bit-exact
    with the ggml format. mode="fast": {"qs8": (L, K, N) int8, "scale_n":
    (L, N) float32}, the per-channel w8a8 form (``ttype`` unused)."""
    quant = _quantizer(ttype, mode, form)
    out = dict(params)
    layers = dict(params["layers"])
    for key in _DECODER_QUANT_KEYS:
        entry = dict(layers[key])
        w = entry.pop("w")                              # (L, K, N)
        per_layer = [quant(w[i], "cpu") for i in range(w.shape[0])]
        for leaf in per_layer[0]:
            entry[leaf] = torch.stack([d[leaf] for d in per_layer]).to(w.device)
        layers[key] = entry
    out["layers"] = layers
    if quantize_lm_head and "lm_head" in params:
        w = params["lm_head"]["w"]
        out["lm_head"] = quant(w, w.device)
    return out


def quantize_encoder_params(params: dict, ttype: GGMLType, mode: str = "ggml",
                            form: Q4Form | None = None) -> dict:
    """Quantize the encoder's per-layer attention and MLP linears (conv
    stem, norms and positions stay dense, the quantize tool's skip set):
    ggml blocks, or the per-channel w8a8 form with ``mode="fast"``."""
    quant = _quantizer(ttype, mode, form)
    out = dict(params)
    new_layers = []
    for lyr in params["layers"]:
        nl = dict(lyr)
        for key in _ENCODER_QUANT_KEYS:
            entry = dict(lyr[key])
            w = entry.pop("w")
            entry.update(quant(w, w.device))
            nl[key] = entry
        new_layers.append(nl)
    out["layers"] = new_layers
    return out
