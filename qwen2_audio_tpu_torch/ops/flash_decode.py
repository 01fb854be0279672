"""Decode-step attention over the KV cache and the int8 cache's
quantize-and-write: the CUDA kernels of csrc/flash_decode.cu and their plain
versions.

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
by the bytes of the valid cache prefix; it splits each (stream, KV head)'s
rows over CTAs that fill the card (``decode_plan``), and the last CTA of
each (stream, KV head) merges the splits' partials from a workspace, found
by a ticket counter (design notes in the CUDA source). ``kv_append_quant``
quantizes a layer's fresh K and V and writes them into the int8 cache in
one launch.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its launches.
"""

from __future__ import annotations

import functools

import torch

from qwen2_audio_tpu_torch.ops import _build
from qwen2_audio_tpu_torch.ops.quant_matmul import ticket_array

_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}   # kv_append_quant's K and V
_HEAD_DIM = 128
_MAX_GROUP = 8
# the launch plan's constants, as csrc/flash_decode.cu has them
_CHUNK = 64             # rows per shared-memory stage
_GRANULE = _CHUNK       # a split's rows start at a multiple of this
_MAX_SPLITS = 16        # CTAs per (stream, KV head)
_MAX_STAGES = 16
_THREADS = 256
_SMEM_MAX = 232448      # a block's shared memory on sm_90
_SMEM_TWO = 115712      # a block's share when two blocks share an SM (228 KB, 1 KB each reserved)
# mbarriers; q (4 floats of padding every 32), p, the chunks', the warps' and
# the split's row maxima and sums, the last-CTA flag
_TAIL_BYTES = _MAX_STAGES * 8 + (_MAX_GROUP * _HEAD_DIM // 32 * 36 + _CHUNK * _MAX_GROUP
                                 + _MAX_STAGES * _MAX_GROUP + 8 * _MAX_GROUP + _MAX_GROUP
                                 + 8) * 4
_RED_BYTES = 8 * _MAX_GROUP * _HEAD_DIM * 4   # the warps' sums, over the stages
_PART_BYTES = (2 * _MAX_GROUP + _MAX_GROUP * _HEAD_DIM) * 4   # a split's m, l and P V sums


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, d) -> int8 values + per-vector float32 scale.

    Both divisions are tensor by tensor: on the card PyTorch divides by a
    Python number through its reciprocal, which can round ``amax / 127``
    otherwise than IEEE division does (and than the JAX package does)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0)
    inv = torch.where(s > 0, torch.ones_like(s) / s, torch.zeros_like(s))
    return torch.round(xf * inv[..., None]).to(torch.int8), s


def split_ranges(pos: int, S: int, splits: int) -> list[tuple[int, int]]:
    """The cache rows [lo, hi) each of the ``splits`` CTAs of one (stream,
    KV head) takes at position ``pos``, as the kernel computes them from
    pos on the device: n = min(pos + 1, S) visible rows, c = ceil(n /
    splits) rounded up to the granule (a 64-row stage), CTA j takes
    [j c, min(n, (j + 1) c)) (empty where j c >= n). A stream of at most
    64 rows stays in one split."""
    n = max(0, min(pos + 1, S))
    c = -(-n // splits)
    c = -(-c // _GRANULE) * _GRANULE
    return [(min(n, j * c), min(n, j * c + c)) for j in range(splits)]


def _stage_bytes(kv_type: torch.dtype) -> int:
    """A stage's K and V rows (and, int8, their scales) in shared memory."""
    return 2 * _CHUNK * _HEAD_DIM * kv_type.itemsize + (2 * _CHUNK * 4 if kv_type == torch.int8
                                                        else 0)


def tensor_path(q_type: torch.dtype, kv_type: torch.dtype) -> bool:
    """Whether the kernel takes its tensor-core path (a bf16 query over a
    bf16 or int8 cache: two CTAs an SM) or its float32 FMA path (one)."""
    return q_type == torch.bfloat16 and kv_type in (torch.bfloat16, torch.int8)


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, S: int, Hkv: int, g: int, kv_type: torch.dtype,
                n_sm: int = 132, q_type: torch.dtype = torch.bfloat16) -> dict:
    """How the decode kernel launches for a batch of B streams over a cache
    of capacity S with Hkv KV heads of g query heads each, from the shapes
    alone (never from the positions): ``splits`` CTAs per (stream, KV head),
    as many as one wave of the card's CTA slots gives each of the B * Hkv
    pairs (``per_sm`` CTAs an SM: 2 on the tensor-core path, 1 on the FMA
    path), at most 16 and at most the 64-row stages of a full cache;
    ``grid`` (splits, Hkv, B); ``stages`` 64-row stages of shared memory,
    enough for the longest range (at pos = S - 1) where they fit in the
    block's share (the whole of an SM's where the grid fits the SMs one
    CTA each, else an SM's share) so that the range's copies are all in
    flight at once, else the most that fit (a ring); ``smem`` bytes;
    ``workspace`` bytes (each split's partial) and ``tickets`` (a counter per
    (stream, KV head)), both 0 with one split; ``ranges(pos)`` the rows each
    split takes; ``ctas_with_keys(positions)`` how many CTAs of the grid hold
    at least one row at these per-stream positions. Raises for what the
    kernel does not take. Cached: the wrapper asks on every call."""
    if not 1 <= g <= _MAX_GROUP or kv_type not in _KV_TYPES or q_type not in _Q_TYPES:
        raise ValueError(f"decode_plan: the kernel takes 1 to {_MAX_GROUP} query heads "
                         f"per KV head, q in {list(_Q_TYPES)} and a cache in "
                         f"{list(_KV_TYPES)}, got g={g}, q {q_type}, cache {kv_type}")
    if min(B, S, Hkv, n_sm) < 1:
        raise ValueError(f"decode_plan: empty shape B={B} S={S} Hkv={Hkv}")
    per_sm = 2 if tensor_path(q_type, kv_type) else 1
    splits = max(1, min(_MAX_SPLITS, -(-S // _GRANULE), n_sm * per_sm // (B * Hkv)))
    lo, hi = split_ranges(S - 1, S, splits)[0]
    ctas = splits * Hkv * B
    stage = _stage_bytes(kv_type)
    share = _SMEM_MAX if per_sm == 1 or ctas <= n_sm else _SMEM_TWO
    most = min(_MAX_STAGES, (share - _TAIL_BYTES) // stage)
    stages = min(most, max(-(-(hi - lo) // _CHUNK), -(-_RED_BYTES // stage)))
    ranges = functools.partial(split_ranges, S=S, splits=splits)
    return {"grid": (splits, Hkv, B), "threads": _THREADS, "per_sm": per_sm,
            "splits": splits, "granule": _GRANULE, "chunk": _CHUNK, "stages": stages,
            "smem": _TAIL_BYTES + stages * stage, "ranges": ranges,
            "workspace": ctas * _PART_BYTES if splits > 1 else 0,
            "tickets": B * Hkv if splits > 1 else 0,
            "ctas_with_keys": lambda positions: Hkv * sum(
                hi > lo for p in positions for lo, hi in ranges(int(p)))}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _refuse(name: str, q, k, v, pos, k_s=None, v_s=None) -> None:
    """Raise for inputs the kernel does not take: q in bf16 or float32, a
    cache in bf16, float32 or int8 (int8 with float32 scales), d = 128, at
    most 8 query heads per KV head, every tensor (pos a (B,) int32 tensor)
    contiguous, aligned and on q's device: 16 bytes, the scales 4 (the
    kernel reads them a float at a time, so that a layer's scales may start
    anywhere on the float grid, whatever the capacity)."""
    B, Hq, d = q.shape
    g = Hq // k.shape[2]
    if q.dtype not in _Q_TYPES or k.dtype not in _KV_TYPES or v.dtype != k.dtype \
            or (k.dtype == torch.int8) != (k_s is not None):
        raise ValueError(f"{name}: the kernel takes q in {list(_Q_TYPES)} and a "
                         f"cache in {list(_KV_TYPES)} (int8 with scales), got "
                         f"q {q.dtype}, cache {k.dtype}")
    if d != _HEAD_DIM or g > _MAX_GROUP:
        raise ValueError(f"{name}: the kernel takes d = {_HEAD_DIM} and at most "
                         f"{_MAX_GROUP} query heads per KV head, got d={d}, g={g}")
    scales = () if k_s is None else (k_s, v_s)
    if any(s.dtype != torch.float32 for s in scales) or pos.dtype != torch.int32 \
            or pos.shape != (B,):
        raise ValueError(f"{name}: the scales must be float32 and pos (B,) int32")
    for x, align in ((q, 16), (k, 16), (v, 16), (pos, 16), *((s, 4) for s in scales)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % align:
            raise ValueError(f"{name}: every input must be contiguous, aligned "
                             f"(16 bytes, the scales 4) and on {q.device}")


def _launch(name: str, q, k, v, pos, sm_scale, k_s=None, v_s=None) -> torch.Tensor:
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device).expand(B).contiguous()
    _refuse(name, q, k, v, pos, k_s, v_s)
    plan = decode_plan(B, S, Hkv, Hq // Hkv, k.dtype, _sm_count(q.device.index or 0), q.dtype)
    o = torch.empty_like(q)
    lib = _build.library("flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = tickets = None
        if plan["splits"] > 1:   # the splits' partials, and a counter per (stream, KV head)
            ws = torch.empty(plan["workspace"] // 4, dtype=torch.float32, device=q.device)
            tickets = ticket_array(q.device, stream, "flash_decode")
            if plan["tickets"] > tickets.numel():
                raise ValueError(f"{name}: {plan['tickets']} (stream, KV head) pairs, more "
                                 f"than the {tickets.numel()} tickets of an array")
        rc = lib.qa_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if k_s is not None else None,
            v_s.data_ptr() if v_s is not None else None,
            pos.data_ptr(), o.data_ptr(), ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            B, S, Hkv, Hq // Hkv, d, _Q_TYPES[q.dtype], _KV_TYPES[k.dtype], float(sm_scale),
            plan["splits"], plan["stages"], stream)
    _build.check(rc, name)
    return o


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 sm_scale: float) -> torch.Tensor:
    """q (B, Hq, d), the cache k/v (B, S, Hkv, d), pos (B,) int (or an int
    for every stream): the query's position, rows 0..pos[b] visible.
    Returns (B, Hq, d) in q's type.

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors. On the card pos is read on the device only: a (B,) int32
    tensor there lets a captured graph replay with pos changed in place."""
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


def kv_append_quant_plain(k, v, k_q, k_s, v_q, v_s, pos) -> None:
    """``quantize_kv`` of k and v, written into the int8 cache at rows
    pos[b] .. pos[b] + T - 1 of each stream b in place (rows at or past the
    capacity are dropped)."""
    B, T = k.shape[:2]
    S = k_q.shape[1]
    pos = torch.as_tensor(pos).expand(B)
    for x, xq, xs in ((k, k_q, k_s), (v, v_q, v_s)):
        q, s = quantize_kv(x)
        for b in range(B):
            p = int(pos[b])
            n = max(0, min(T, S - p))
            xq[b, p:p + n] = q[b, :n]
            xs[b, p:p + n] = s[b, :n]


def kv_append_quant(k: torch.Tensor, v: torch.Tensor, k_q: torch.Tensor,
                    k_s: torch.Tensor, v_q: torch.Tensor, v_s: torch.Tensor,
                    pos) -> None:
    """Quantize one layer's fresh k and v, (B, T, Hkv, d) in the activation
    type (d contiguous, any other strides), and write them into its int8
    cache views k_q/v_q (B, S, Hkv, d) and scales k_s/v_s (B, S, Hkv) at
    rows pos[b] .. pos[b] + T - 1, in place: ``quantize_kv`` and the sliced
    writes, bit for bit. pos is a (B,) int32 tensor (or an int for every
    stream), read on the device by the kernel.

    Runs the CUDA kernel for CUDA tensors (one launch) and the plain version
    for CPU tensors."""
    B, T, Hkv, d = k.shape
    if v.shape != k.shape or k_q.dim() != 4 or k_q.shape[0] != B \
            or k_q.shape[2:] != (Hkv, d) or v_q.shape != k_q.shape \
            or k_s.shape != k_q.shape[:3] or v_s.shape != k_q.shape[:3]:
        raise ValueError(f"kv_append_quant: shapes k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"cache {tuple(k_q.shape)}, scales {tuple(k_s.shape)}")
    if k.device.type == "cpu":
        return kv_append_quant_plain(k, v, k_q, k_s, v_q, v_s, pos)
    if k.device.type != "cuda":
        raise ValueError(f"kv_append_quant: unsupported device {k.device}")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k.device).expand(B).contiguous()
    if k.dtype not in _X_TYPES or v.dtype != k.dtype or d != _HEAD_DIM \
            or k.stride(-1) != 1 or v.stride(-1) != 1 \
            or k_q.dtype != torch.int8 or v_q.dtype != torch.int8 \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError(f"kv_append_quant: the kernel takes k, v in {list(_X_TYPES)} "
                         f"with d = {_HEAD_DIM} contiguous and an int8 cache with "
                         f"float32 scales, got {k.dtype}, d={d}, cache {k_q.dtype}")
    for x in (v, k_q, k_s, v_q, v_s, pos):
        if x.device != k.device:
            raise ValueError(f"kv_append_quant: every input must be on {k.device}")
    for x, align in ((k_q, 16), (k_s, 4), (v_q, 16), (v_s, 4)):
        if not x.is_contiguous() or x.data_ptr() % align:
            raise ValueError("kv_append_quant: the cache must be contiguous and "
                             "aligned (16 bytes, the scales 4)")
    lib = _build.library("flash_decode")
    with torch.cuda.device(k.device):
        rc = lib.qa_kv_append_quant(
            k.data_ptr(), v.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), pos.data_ptr(), *k.stride()[:3], *v.stride()[:3], B, T, Hkv,
            d, k_q.shape[1], _X_TYPES[k.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "kv_append_quant")
    kv_append_quant.launches += 1


kv_append_quant.launches = 0
