"""Symmetric q4_0 nibbles in int32 words ("qs4b", ``Q4Form(b32=True)``)
through the exact-integer group matmul of ops/quant_matmul_int8.py.

Replaces the TPU kernel _kernel_q4b_stacked of
qwen2_audio_tpu/ops/quant_matmul_q4b.py at ``quant_matmul_q4b_stacked``; its
CUDA kernel is the words form of csrc/quant_matmul_int8.cu.

    qs4b    (K // 8, N) int32: word r of a column packs byte rows 4r .. 4r + 3
            of the packed nibble form "qs4" (K // 2, N), least significant
            byte first (``pack_b32``): its low nibbles hold k = 32 g + 4 (r %
            4) + 0..3 and its high nibbles the same + 16, for g = r // 4
    scales  (K // 32, N) float16 or float32

The values are nibble - 8, symmetric q4_0 only. On the same bytes
``quant_matmul_q4b_stacked`` gives the bits of
``quant_matmul_int8_stacked(..., off=8)`` over "qs4", on the card and on the
CPU: the JAX package holds its two kernels to that. ``quant_linear_q4b``
runs the stacked entry on a one-layer view, as JAX runs its stacked kernel
at L = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen2_audio_tpu_torch.ops.quant_matmul import _layer, block_weight, unpack4
from qwen2_audio_tpu_torch.ops.quant_matmul_int8 import WORDS, group_matmul_plain, run


def pack_b32(qs4):
    """(..., K // 2, N) nibble bytes, uint8 or int8 -> (..., K // 8, N) int32
    words, 4 byte rows per word, least significant first (the JAX package's
    order). A torch tensor stays on its device; numpy in, numpy out."""
    if isinstance(qs4, torch.Tensor):
        b = qs4.view(torch.uint8) if qs4.dtype == torch.int8 else qs4
        if b.dtype != torch.uint8:
            raise ValueError(f"pack_b32: nibble bytes are uint8 or int8, got {b.dtype}")
    else:
        b = np.asarray(qs4)
        b = b if b.dtype == np.uint8 else b.view(np.uint8)
    *lead, R, N = b.shape
    if R % 4:
        raise ValueError(f"pack_b32: {R} byte rows do not pack 4 to a word")
    b = b.reshape(*lead, R // 4, 4, N)
    if isinstance(b, torch.Tensor):   # the 4 byte rows last, then one word each
        return b.transpose(-1, -2).contiguous().view(torch.int32).squeeze(-1)
    return np.ascontiguousarray(np.swapaxes(b, -1, -2)).view(np.int32)[..., 0]


def unpack_b32(w):
    """(..., K // 8, N) int32 words -> (..., K // 2, N) uint8 bytes, torch or
    numpy; the inverse of ``pack_b32``."""
    if isinstance(w, torch.Tensor):
        u = w.contiguous().view(torch.uint8)
    else:
        u = np.ascontiguousarray(w).view(np.uint8)
    *lead, R4, N4 = u.shape
    u = u.reshape(*lead, R4, N4 // 4, 4)
    u = u.transpose(-1, -2) if isinstance(u, torch.Tensor) else np.swapaxes(u, -1, -2)
    return u.reshape(*lead, R4 * 4, N4 // 4)


def dequantize_weight_q4b(qw: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (K, N) weight of a {"qs4b", "scales"} dict: (nibble - 8) * d."""
    return block_weight(unpack_b32(qw["qs4b"]), qw["scales"], packed=True, off=8).to(dtype)


def quant_matmul_q4b_plain(x: torch.Tensor, qp: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    return group_matmul_plain(x, unpack4(unpack_b32(qp)) - 8, scales)


def quant_matmul_q4b_stacked(x: torch.Tensor, qp_all: torch.Tensor, sc_all: torch.Tensor,
                             li: int) -> torch.Tensor:
    """x (M, K) @ layer ``li`` of qp_all (L, K // 8, N) int32 words with
    sc_all (L, K // 32, N), read in place; q8_1 activations, exact integer
    group dots, (M, N) in x's type."""
    name = "quant_matmul_q4b_stacked"
    return run(quant_matmul_q4b_stacked, x, _layer(name, qp_all, li),
               _layer(name, sc_all, li), WORDS, 8, quant_matmul_q4b_plain)


quant_matmul_q4b_stacked.launches = 0
ENTRIES = (quant_matmul_q4b_stacked,)


def quant_linear_q4b_stacked(x: torch.Tensor, qw: dict, li: int) -> torch.Tensor:
    """x (..., K) @ layer ``li`` of {"qs4b" (L, K // 8, N), "scales" (L, K //
    32, N)} -> (..., N)."""
    x2d = x.reshape(-1, x.shape[-1])
    y = quant_matmul_q4b_stacked(x2d, qw["qs4b"], qw["scales"], li)
    return y.reshape(*x.shape[:-1], -1)


def quant_linear_q4b(x: torch.Tensor, qw: dict) -> torch.Tensor:
    """x (..., K) @ {"qs4b" (K // 8, N), "scales"}: the stacked entry on a
    one-layer view."""
    return quant_linear_q4b_stacked(x, {k: qw[k][None] for k in ("qs4b", "scales")}, 0)
