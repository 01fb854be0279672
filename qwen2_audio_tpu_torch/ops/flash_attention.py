"""Encoder attention and causal decoder-prefill attention: the CUDA kernels
of csrc/attention_single.cu and their plain versions.

Replaces the TPU kernel
qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel_single: non-causal
softmax(Q K^T) V over the whole key sequence, Q pre-scaled by the caller,
keys at or past ``kv_valid`` masked, GQA (query head h reads KV head
h // (H // Hkv)), float32 softmax and accumulation, the l == 0 -> 1 guard,
output in the input type. It is bound by arithmetic (11.5 GFLOP per layer
at the encoder's T = 1500, d = 64, 20 heads; about 12 us at the card's
989 TFLOP/s bf16 peak).

The TPU kernel held the whole (128 x 1536) float32 score tile in VMEM; a
Hopper block has at most 227 KB of shared memory, so the CUDA kernel streams
the keys in chunks of 64 with a running max and sum (online softmax) inside
one block. bf16 runs on mma.sync tensor-core tiles, float32 on plain FMA (no
TF32). Design notes are in the CUDA source.

``attention_single`` launches the kernel for CUDA tensors and runs
``attention_single_plain`` for CPU tensors.

``attention_causal`` replaces the TPU kernel
qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel as the decoder prefill
calls it (``flash_attention(causal=True)``): sm_scale applied to the float32
scores, key j visible to query i iff j <= i and j < kv_valid, GQA, and each
query block's key loop stopped at its diagonal (the TPU kernel's tile skip).
Its non-causal blockwise use and the lite / nopad / exp2 / pexp16 variants
are not ported yet (ROADMAP.md, section 2).
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops import _build

_KERNEL_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (64,)}
_CAUSAL_HEAD_DIMS = {torch.bfloat16: (128,), torch.float32: (128,)}   # the decoder's


def attention_single_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid: int | None = None) -> torch.Tensor:
    """q (B, H, Tq, d), k/v (B, Hkv, Tk, d) -> (B, H, Tq, d) in q's type.
    Scores, softmax and the P V sum in float32; p is cast to V's type before
    the P V product, as the TPU kernel does."""
    H, Hkv, Tk = q.shape[1], k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    group = H // Hkv
    kf = k[:, :, :kv_valid].float().repeat_interleave(group, dim=1)
    vv = v[:, :, :kv_valid].repeat_interleave(group, dim=1)
    s = q.float() @ kf.transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vv.float()
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def attention_single(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: int | None = None) -> torch.Tensor:
    """softmax(Q K^T) V for pre-scaled Q; q (B, H, Tq, d), k/v (B, Hkv, Tk, d)
    with any strides whose last one is 1 (heads may be views into one fused
    projection). Returns (B, H, Tq, d), laid out in memory as (B, Tq, H, d).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    B, H, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    if k.shape != (B, Hkv, Tk, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"attention_single: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= kv_valid <= Tk:
        raise ValueError(f"attention_single: kv_valid {kv_valid} not in [1, {Tk}]")
    if q.device.type == "cpu":
        return attention_single_plain(q, k, v, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention_single: unsupported device {q.device}")
    o = _launch("qa_attention_single", _KERNEL_HEAD_DIMS, q, k, v, kv_valid)
    attention_single.launches += 1
    return o


attention_single.launches = 0


def _launch(entry: str, head_dims: dict, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, kv_valid: int, *extra) -> torch.Tensor:
    """Check the card's inputs and launch ``entry`` of csrc/attention_single.cu;
    returns (B, H, Tq, d) laid out in memory as (B, Tq, H, d)."""
    B, H, Tq, d = q.shape
    Hkv = k.shape[1]
    if d not in head_dims.get(q.dtype, ()):
        raise ValueError(f"{entry}: the kernel takes head dims {head_dims} by "
                         f"type, got {q.dtype} d={d}")
    vec = 16 // q.element_size()   # the kernel moves rows in 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device or x.stride(-1) != 1 \
                or x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
            raise ValueError(f"{entry}: {name} must be {q.dtype} on "
                             f"{q.device} with a unit last stride, 16-byte "
                             f"aligned rows and strides divisible by {vec}")
    o = torch.empty((B, Tq, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lib = _build.library("attention_single")
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            B, H, Hkv, Tq, kv_valid, d, int(q.dtype == torch.bfloat16),
            *extra, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, entry)
    return o


def attention_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float, kv_valid: int | None = None
                           ) -> torch.Tensor:
    """q (B, H, T, d), k/v (B, Hkv, T, d) -> (B, H, T, d) in q's type: causal
    softmax(sm_scale * Q K^T) V. Scores, softmax and the P V sum in float32;
    p is cast to V's type before the P V product, as the TPU kernel does."""
    B, H, T, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    qg = q.float().unflatten(1, (Hkv, H // Hkv))             # (B, Hkv, g, T, d)
    s = (qg @ k.float()[:, :, None].transpose(-1, -2)) * sm_scale
    col = torch.arange(Tk, device=q.device)
    visible = (col[None, :] <= torch.arange(T, device=q.device)[:, None]) \
        & (col < kv_valid)
    s = s.masked_fill(~visible, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()[:, :, None]
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).flatten(1, 2).to(q.dtype)


def attention_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float, kv_valid: int | None = None) -> torch.Tensor:
    """Causal softmax(sm_scale * Q K^T) V; q (B, H, T, d), k/v (B, Hkv, T, d)
    with any strides whose last one is 1. Returns (B, H, T, d), laid out in
    memory as (B, T, H, d).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    kv_valid = T if kv_valid is None else kv_valid
    if k.shape != (B, Hkv, T, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"attention_causal: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= kv_valid <= T:
        raise ValueError(f"attention_causal: kv_valid {kv_valid} not in [1, {T}]")
    if q.device.type == "cpu":
        return attention_causal_plain(q, k, v, sm_scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention_causal: unsupported device {q.device}")
    o = _launch("qa_attention_causal", _CAUSAL_HEAD_DIMS, q, k, v, kv_valid,
                float(sm_scale))
    attention_causal.launches += 1
    return o


attention_causal.launches = 0


def _merged_heads(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """Run ``attend`` over merged-head activations (B, T, D) -> (B, T, D).

    Applies the reference's d_head^-0.5 scaling as a Q pre-scale
    (src/qwen2-whisper.cpp:2030). K and V are passed as strided head views,
    so slices of a fused QKV output are not copied."""
    B, T, D = q.shape
    dh = D // n_head
    q = q * (float(dh) ** -0.5)

    def split(x):
        return x.unflatten(-1, (n_head, dh)).transpose(1, 2)

    out = attend(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(B, T, D)


def flash_attention_encoder(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """Encoder-layer entry over merged-head activations (B, T, D), through
    ``attention_single`` (the kernel for CUDA tensors)."""
    return _merged_heads(attention_single, q, k, v, n_head)


def attention_encoder_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """``flash_attention_encoder`` through the plain version on any device."""
    return _merged_heads(attention_single_plain, q, k, v, n_head)
