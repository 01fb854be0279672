"""Encoder attention and causal decoder-prefill attention: the CUDA kernels
of csrc/attention_single.cu and their plain versions.

Replaces the TPU kernel
qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel_single: non-causal
softmax(sm_scale * Q K^T) V over the whole key sequence (sm_scale 1 where
the caller pre-scaled Q), keys at or past ``kv_valid`` masked, GQA (query
head h reads KV head h // (H // Hkv)), float32 softmax and accumulation,
the l == 0 -> 1 guard, output in the input type. It is bound by arithmetic
(11.5 GFLOP per layer at the encoder's T = 1500, d = 64, 20 heads; about
12 us at the card's 989 TFLOP/s bf16 peak).

The TPU kernel held the whole (128 x 1536) float32 score tile in VMEM; a
Hopper block has at most 227 KB of shared memory, so the CUDA kernels stream
the keys in chunks with a running max and sum (online softmax) inside one
block. bf16 runs on a TMA-fed wgmma tile (128 queries a block, keys in
chunks of 128, a producer warpgroup and two consumer warpgroups), float32 on
plain FMA (no TF32). ``launch_plan`` says which kernel a call takes and how
it is launched; design notes are in the CUDA source.

``attention_single`` launches the kernel for CUDA tensors and runs
``attention_single_plain`` for CPU tensors.

``attention_causal`` replaces the TPU kernel
qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel as the decoder prefill
calls it (``flash_attention(causal=True)``): sm_scale applied to the float32
scores, key j visible to query i iff j <= i and j < kv_valid, GQA, and each
query block's key loop stopped at its diagonal (the TPU kernel's tile skip).
``attention_blockwise`` is the same TPU kernel's non-causal use, which
computes the function of ``attention_single``: on the card it is the same
kernel, counted apart.

The TPU kernels' options are arguments here: ``exp2`` (scores in the log2
domain, exponentials base 2) on all three, ``pexp16`` (p = bf16(exp(bf16(s -
m)))) on the one-shot kernel. The JAX entry's dispatch (``flash_attention``),
the lite and unpadded variants, the encoder's entry
(``flash_attention_encoder``) and the process switch it reads are in
ops/fa_variants.py, above this module.
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# option bits of the kernel's ``flags`` (csrc/attention_single.cu)
EXP2, PEXP16, LITE = 1, 2, 4
_KERNEL_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (64, 128)}
_CAUSAL_HEAD_DIMS = {torch.bfloat16: (128,), torch.float32: (128,)}   # the decoder's


def _exp(x: torch.Tensor, exp2: bool) -> torch.Tensor:
    return torch.exp2(x) if exp2 else torch.exp(x)


def flags(*, exp2: bool = False, pexp16: bool = False, lite: bool = False) -> int:
    """The kernel's option bits."""
    return EXP2 * bool(exp2) | PEXP16 * bool(pexp16) | LITE * bool(lite)


def attention_single_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid: int | None = None, *, sm_scale: float = 1.0,
                           exp2: bool = False, pexp16: bool = False,
                           lite: bool = False) -> torch.Tensor:
    """q (B, H, Tq, d), k/v (B, Hkv, Tk, d) -> (B, H, Tq, d) in q's type.
    Scores, softmax and the P V sum in float32, sm_scale on the scores;
    p is cast to V's type before the P V product, as the TPU kernel does.
    ``pexp16``: p = bf16(exp(bf16(s - m))) and l sums those bf16 values;
    ``lite``: l sums p after its cast to V's type."""
    H, Hkv, Tk = q.shape[1], k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    group = H // Hkv
    kf = k[:, :, :kv_valid].float().repeat_interleave(group, dim=1)
    vv = v[:, :, :kv_valid].repeat_interleave(group, dim=1)
    s = q.float() @ kf.transpose(-1, -2)
    if sm_scale != 1.0:
        s = s * sm_scale
    x = s - s.amax(dim=-1, keepdim=True)
    if pexp16:
        p = _exp(x.to(torch.bfloat16).float(), exp2).to(torch.bfloat16).float()
    else:
        p = _exp(x, exp2)
    pv = p.to(v.dtype).float()
    l = (pv if lite else p).sum(dim=-1, keepdim=True)
    acc = pv @ vv.float()
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def attention_single(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: int | None = None, *, sm_scale: float = 1.0,
                     exp2: bool = False, pexp16: bool = False) -> torch.Tensor:
    """softmax(sm_scale * Q K^T) V; q (B, H, Tq, d), k/v (B, Hkv, Tk, d)
    with any strides whose last one is 1 (heads may be views into one fused
    projection). Returns (B, H, Tq, d), laid out in memory as (B, Tq, H, d).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    kv_valid = _check("attention_single", q, k, v, kv_valid)
    return counted(attention_single, lambda: attention_single_plain(
        q, k, v, kv_valid, sm_scale=sm_scale, exp2=exp2, pexp16=pexp16),
        q, k, v, kv_valid, sm_scale, flags(exp2=exp2, pexp16=pexp16))


attention_single.launches = 0


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_valid: int | None) -> int:
    """Shapes every device takes; returns kv_valid (default: every key).
    Raises for a device other than the CPU and CUDA."""
    B, H, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    if k.shape != (B, Hkv, Tk, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= kv_valid <= Tk:
        raise ValueError(f"{name}: kv_valid {kv_valid} not in [1, {Tk}]")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return kv_valid


# the bf16 wgmma tile (csrc/attention_single.cu): queries a block, keys a
# chunk, threads (a producer and two consumer warpgroups)
_BQ, _BK, _THREADS = 128, 128, 384
_F32_ROWS = {"f32": 128, "f32_causal": 64}   # query rows per block of 128 threads


def _refuse(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> None:
    """Raise for what the kernels do not take rather than copying it:
    another type or head dim, inputs of mixed type or device, a last stride
    other than 1, a base not 16-byte aligned or a stride not a multiple of
    16 bytes (the TMA boxes and 16-byte loads)."""
    head_dims = _CAUSAL_HEAD_DIMS if causal else _KERNEL_HEAD_DIMS
    if q.shape[-1] not in head_dims.get(q.dtype, ()):
        raise ValueError(f"{entry}: the kernel takes head dims {head_dims} by "
                         f"type, got {q.dtype} d={q.shape[-1]}")
    vec = 16 // q.element_size()   # the kernel moves rows in 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        st = x.stride()
        if x.dtype != q.dtype or x.device != q.device or st[3] != 1 \
                or x.data_ptr() % 16 or st[0] % vec or st[1] % vec or st[2] % vec:
            raise ValueError(f"{entry}: {name} must be {q.dtype} on "
                             f"{q.device} with a unit last stride, 16-byte "
                             f"aligned rows and strides divisible by {vec}")


def launch_plan(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_valid: int, *, causal: bool = False, sm_scale: float = 1.0,
                option_bits: int = 0) -> dict:
    """How ``entry`` launches for these inputs, from shapes, types, strides
    and addresses alone (no device is touched). ``kernel``: ``"wgmma"`` (the
    bf16 tile), ``"f32"`` (float32, d = 64, non-causal) or ``"f32_causal"``
    (float32 causal, and non-causal d = 128); ``grid`` as launched, and for
    the bf16 tile ``tiles`` (the query tile each blockIdx.y takes: the last
    first for causal, heaviest first), ``chunks`` (key chunks per tile),
    ``kv_extent`` (the K/V tensor maps' token extent, kv_valid: TMA
    zero-fills every key past it) and ``opts`` (the instantiation that
    reads flags and sm_scale). Raises as the wrapper does (``_refuse``).

    The plan describes the launch but does not drive it: the C launcher of
    csrc/attention_single.cu computes the same grid, tile order and chunks
    itself, so a change to one must be made in the other."""
    _refuse(entry, q, k, v, causal)
    B, H, Tq, d = q.shape
    if q.dtype == torch.bfloat16:
        n = -(-Tq // _BQ)
        tiles = tuple(range(n))[::-1] if causal else tuple(range(n))
        full = -(-kv_valid // _BK)
        chunks = tuple(min(full, t + 1) if causal else full for t in tiles)
        return {"kernel": "wgmma", "grid": (B * H, n, 1), "threads": _THREADS,
                "block_q": _BQ, "block_k": _BK, "tiles": tiles,
                "chunks": chunks, "kv_extent": kv_valid,
                "opts": bool(option_bits) or (not causal and sm_scale != 1.0)}
    kernel = "f32" if d == 64 and not causal else "f32_causal"
    rows = _F32_ROWS[kernel]
    return {"kernel": kernel, "grid": (-(-Tq // rows), H, B), "threads": 128,
            "kv_extent": kv_valid}


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_valid: int, sm_scale: float, option_bits: int, causal: bool
            ) -> torch.Tensor:
    """Check the card's inputs and launch ``entry`` of csrc/attention_single.cu;
    returns (B, H, Tq, d) laid out in memory as (B, Tq, H, d)."""
    _refuse(entry, q, k, v, causal)
    B, H, Tq, d = q.shape
    Hkv = k.shape[1]
    o = torch.empty((B, Tq, H, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lib = _build.library("attention_single")
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            B, H, Hkv, Tq, kv_valid, d, int(q.dtype == torch.bfloat16),
            sm_scale, option_bits, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, entry)
    return o


def counted(entry, plain, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_valid: int, sm_scale: float, option_bits: int,
            kernel: str = "qa_attention_single") -> torch.Tensor:
    """``plain()`` for CPU tensors; for CUDA tensors ``kernel`` launched
    with these arguments and counted on ``entry.launches``."""
    if q.device.type == "cpu":
        return plain()
    o = _launch(kernel, q, k, v, kv_valid, float(sm_scale), option_bits,
                causal=kernel == "qa_attention_causal")
    entry.launches += 1
    return o


def attention_blockwise_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              sm_scale: float, kv_valid: int | None = None, *,
                              exp2: bool = False, block_k: int = 512) -> torch.Tensor:
    """The TPU kernel _attn_kernel with causal=False in plain PyTorch: keys
    in tiles of ``block_k``, running max and sum in float32, each tile's p
    cast to V's type before its P V product, the accumulator rescaled by
    exp(m_prev - m_next). The same function as ``attention_single_plain``;
    only the tiles at which p is rounded differ."""
    H, Hkv, Tk = q.shape[1], k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    group = H // Hkv
    kf = k[:, :, :kv_valid].float().repeat_interleave(group, dim=1)
    vv = v[:, :, :kv_valid].repeat_interleave(group, dim=1)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    for k0 in range(0, kv_valid, block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        if sm_scale != 1.0:
            s = s * sm_scale
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = _exp(m - mn, exp2)
        p = _exp(s - mn, exp2)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vv[:, :, k0:k0 + block_k].float()
        m = mn
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, kv_valid: int | None = None, *,
                        exp2: bool = False, block_k: int = 512) -> torch.Tensor:
    """Non-causal softmax(sm_scale * Q K^T) V as the TPU's blockwise kernel
    computes it; shapes and layouts as ``attention_single``. ``block_k``
    sets the plain version's key tiles (the JAX kernel's), not the CUDA
    kernel's chunk."""
    kv_valid = _check("attention_blockwise", q, k, v, kv_valid)
    return counted(attention_blockwise, lambda: attention_blockwise_plain(
        q, k, v, sm_scale, kv_valid, exp2=exp2, block_k=block_k),
        q, k, v, kv_valid, sm_scale, flags(exp2=exp2))


attention_blockwise.launches = 0


def attention_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float, kv_valid: int | None = None, *,
                           exp2: bool = False) -> torch.Tensor:
    """q (B, H, T, d), k/v (B, Hkv, T, d) -> (B, H, T, d) in q's type: causal
    softmax(sm_scale * Q K^T) V. Scores, softmax and the P V sum in float32;
    p is cast to V's type before the P V product, as the TPU kernel does.
    Keys at or past kv_valid are not read, as the kernel reads none."""
    B, H, T, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    k, v = k[:, :, :kv_valid], v[:, :, :kv_valid]
    qg = q.float().unflatten(1, (Hkv, H // Hkv))             # (B, Hkv, g, T, d)
    s = (qg @ k.float()[:, :, None].transpose(-1, -2)) * sm_scale
    col = torch.arange(kv_valid, device=q.device)
    visible = col[None, :] <= torch.arange(T, device=q.device)[:, None]
    s = s.masked_fill(~visible, -torch.inf)
    p = _exp(s - s.amax(dim=-1, keepdim=True), exp2)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()[:, :, None]
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).flatten(1, 2).to(q.dtype)


def attention_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float, kv_valid: int | None = None, *,
                     exp2: bool = False) -> torch.Tensor:
    """Causal softmax(sm_scale * Q K^T) V; q (B, H, T, d), k/v (B, Hkv, T, d)
    with any strides whose last one is 1. Returns (B, H, T, d), laid out in
    memory as (B, T, H, d).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    T = q.shape[2]
    if k.shape[2] != T:
        raise ValueError(f"attention_causal: {T} queries over {k.shape[2]} keys")
    kv_valid = _check("attention_causal", q, k, v, kv_valid)
    return counted(attention_causal, lambda: attention_causal_plain(
        q, k, v, sm_scale, kv_valid, exp2=exp2), q, k, v, kv_valid, sm_scale,
        flags(exp2=exp2), kernel="qa_attention_causal")


attention_causal.launches = 0


def prescale(q: torch.Tensor, n_head: int, exp2: bool = False) -> torch.Tensor:
    """The reference's d_head^-0.5 Q pre-scale (src/qwen2-whisper.cpp:2030),
    times LOG2E under ``exp2``. The scale is rounded to Q's type before the
    multiply, as the JAX entry's ``jnp.asarray(scale, q.dtype)`` rounds it."""
    scale = float(q.shape[-1] // n_head) ** -0.5 * (LOG2E if exp2 else 1.0)
    return q * torch.tensor(scale, dtype=q.dtype).item()


def _merged_heads(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """Run ``attend`` over merged-head activations (B, T, D) -> (B, T, D).
    K and V are passed as strided head views, so slices of a fused QKV
    output are not copied."""
    B, T, D = q.shape

    def split(x):
        return x.unflatten(-1, (n_head, D // n_head)).transpose(1, 2)

    out = attend(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(B, T, D)


def attention_encoder_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """The default ``flash_attention_encoder`` through the plain version on
    any device."""
    return _merged_heads(attention_single_plain, prescale(q, n_head), k, v, n_head)
