"""Decode-step attention over the KV cache: the CUDA kernel
csrc/flash_decode.cu and its plain versions.

Replaces the TPU kernel qwen2_audio_tpu/ops/flash_decode.py::_decode_kernel
at both of its call sites: ``flash_decode`` (bf16 or float32 cache) and
``flash_decode_quant`` (int8 cache, float32 per-vector scales). One query
per stream: stream b attends to cache rows 0..pos[b]; rows past pos[b] are
never read (the TPU kernel's clamped index map) and may hold anything, NaN
included (the TPU kernel zeroed V past pos so that 0 * NaN could not reach
the output). K and V are converted to q's type, the scores are scaled by
``sm_scale`` (and, int8, by the K scales) in float32, p is multiplied by the
V scales and cast to q's type before P V, and the output is in q's type.

The cache is the decoder's own (B, S, Hkv, d) layer buffer, used in place;
the query heads of KV head h are h * g .. h * g + g - 1. The kernel is bound
by the bytes of the valid cache prefix (design notes in the CUDA source).

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its launches.
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops import _build

_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIM = 128
_MAX_GROUP = 8


def _decode_plain(q, k, v, pos, sm_scale, k_s=None, v_s=None):
    """The arithmetic of the TPU kernel in one pass: q (B, Hq, d), k/v
    (B, S, Hkv, d), pos (B,), scales (B, S, Hkv) or None."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    visible = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (B, S)
    qg = q.float().unflatten(1, (Hkv, Hq // Hkv))                       # (B, Hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(q.dtype).float()) * sm_scale
    if k_s is not None:
        s = s * k_s.float().transpose(1, 2)[:, :, None, :]
    s = s.masked_fill(~visible[:, None, None, :], -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v_s is not None:
        p = p * v_s.float().transpose(1, 2)[:, :, None, :].masked_fill(
            ~visible[:, None, None, :], 0.0)
    # rows past pos may hold NaN: zero them so that 0 * NaN stays out
    vz = v.to(q.dtype).masked_fill(~visible[:, :, None, None], 0)
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(q.dtype).float(), vz.float())
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).flatten(1, 2).to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, *, sm_scale: float) -> torch.Tensor:
    """q (B, Hq, d), k/v (B, S, Hkv, d), pos (B,) -> (B, Hq, d) in q's type."""
    return _decode_plain(q, k, v, pos, sm_scale)


def flash_decode_quant_plain(q: torch.Tensor, k_q: torch.Tensor,
                             k_s: torch.Tensor, v_q: torch.Tensor,
                             v_s: torch.Tensor, pos, *,
                             sm_scale: float) -> torch.Tensor:
    """int8 cache: k_q/v_q (B, S, Hkv, d) int8, k_s/v_s (B, S, Hkv) float32."""
    return _decode_plain(q, k_q, v_q, pos, sm_scale, k_s, v_s)


def _check(name: str, q, k, v, scales=()) -> None:
    B, Hq, d = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != d or v.shape != k.shape \
            or Hq % k.shape[2]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for s in scales:
        if s.shape != k.shape[:3]:
            raise ValueError(f"{name}: scale shape {tuple(s.shape)}, want "
                             f"{tuple(k.shape[:3])}")


def _launch(name: str, q, k, v, pos, sm_scale, k_s=None, v_s=None) -> torch.Tensor:
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if q.dtype not in _Q_TYPES or k.dtype not in _KV_TYPES or v.dtype != k.dtype \
            or (k.dtype == torch.int8) != (k_s is not None):
        raise ValueError(f"{name}: the kernel takes q in {list(_Q_TYPES)} and a "
                         f"cache in {list(_KV_TYPES)} (int8 with scales), got "
                         f"q {q.dtype}, cache {k.dtype}")
    if d != _HEAD_DIM or g > _MAX_GROUP:
        raise ValueError(f"{name}: the kernel takes d = {_HEAD_DIM} and at most "
                         f"{_MAX_GROUP} query heads per KV head, got d={d}, g={g}")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device).expand(B).contiguous()
    scales = () if k_s is None else (k_s, v_s)
    for x in (q, k, v, pos, *scales):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: every input must be contiguous, 16-byte "
                             f"aligned and on {q.device}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError(f"{name}: the scales must be float32")
    o = torch.empty_like(q)
    lib = _build.library("flash_decode")
    with torch.cuda.device(q.device):
        rc = lib.qa_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if k_s is not None else None,
            v_s.data_ptr() if v_s is not None else None,
            pos.data_ptr(), o.data_ptr(), B, S, Hkv, g, d, _Q_TYPES[q.dtype],
            _KV_TYPES[k.dtype], float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, name)
    return o


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 sm_scale: float) -> torch.Tensor:
    """q (B, Hq, d), the cache k/v (B, S, Hkv, d), pos (B,) int (or an int
    for every stream): the query's position, rows 0..pos[b] visible.
    Returns (B, Hq, d) in q's type.

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    _check("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    o = _launch("flash_decode", q, k, v, pos, sm_scale)
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


def flash_decode_quant(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                       v_q: torch.Tensor, v_s: torch.Tensor, pos, *,
                       sm_scale: float) -> torch.Tensor:
    """``flash_decode`` over the int8 cache: k_q/v_q (B, S, Hkv, d) int8 and
    their float32 per-vector scales k_s/v_s (B, S, Hkv)."""
    _check("flash_decode_quant", q, k_q, v_q, (k_s, v_s))
    if q.device.type == "cpu":
        return flash_decode_quant_plain(q, k_q, k_s, v_q, v_s, pos, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_quant: unsupported device {q.device}")
    if k_q.dtype != torch.int8:
        raise ValueError(f"flash_decode_quant: the cache must be int8, got {k_q.dtype}")
    o = _launch("flash_decode_quant", q, k_q, v_q, pos, sm_scale, k_s, v_s)
    flash_decode_quant.launches += 1
    return o


flash_decode_quant.launches = 0
