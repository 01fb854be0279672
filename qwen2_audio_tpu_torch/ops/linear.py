"""Linear-layer dispatch on the parameter dict's keys:

    {"w"[, "b"]}                        dense: a plain ``torch.matmul``
                                        (cuBLAS on the card), as the JAX
                                        package left it to XLA outside Pallas
    {"qs", "scales"[, "mins", "b"]}     ggml blocks as int8 values
    {"qs4", "scales"[, "mins", "b"]}    ggml blocks as packed nibbles
    {"qs_p" | "qs4_p", "scales_p"[, "mins", "b"]}
                                        the same in contiguous column panels
                                        (ops.quant_matmul.panelize_weight)
    {"qs4b", "scales"[, "b"]}           symmetric q4_0 nibbles in int32 words
                                        (``Q4Form(b32=True)``)

How the block forms multiply is a process-wide mode:

    "bf16"     the dequantizing kernels of ops/quant_matmul.py: x and the
               dequantized weight each rounded once to bf16, one tensor-core
               pass, float32 sums (the default)
    "dequant"  the same kernels, the exact float32 product of x and the
               float32 dequantized weight (slow at large M)
    "int8"     ggml's mmq numerics (ops/quant_matmul_int8.py): x quantized
               to int8 per 32-group, exact integer group dots. ``linear_at``
               takes it for "qs" and "qs4" with 32-groups ("qs4" without
               "mins" is symmetric q4_0), ``linear`` for a flat "qs" with
               32-groups only; everything else (the 16-group k-quants, the
               panels, a flat "qs4", as in JAX) takes the exact dequantizing
               kernels

In the bf16 mode ``set_dequant16`` (the JAX package's QA_Q4_DQ16 and
QA_Q8_DQ16) rounds the block scales to bf16 before the dequantizing
multiply: ``q4`` for the packed forms ("qs4", "qs4_p"), ``q8`` for the int8
forms ("qs", "qs_p"), through ``linear`` and ``linear_at``; the one-launch
SwiGLU and the integer kernels take no such option.

"qs4b" goes through the integer kernel's word form (ops/quant_matmul_q4b.py)
in every mode. ``linear_at`` is ``linear`` over layer ``li`` (a host integer)
of a dict whose leaves carry a leading (n_layers,) axis; the layer is a
view, never a copy. ``fused_mlp_at`` and ``fused_mlp_split_at`` run a whole
SwiGLU MLP (gate, up, SiLU, down) of strided block dicts in one launch at
decode M (ops/fused_mlp.py) or return None, and the caller then takes
``linear_at`` per projection; ``set_fused_mlp(False)`` switches them off for
the process, and mode "int8" has no one-launch kernel.

The per-channel w8a8 form {"qs8", "scale_n"[, "b"]} (quant/qparams.py,
``mode="fast"``) multiplies as the JAX package's ``_w8a8``: x quantized to
int8 per row (s_x = max|x| / 127, x_q = round(x / s_x) half to even), one
int8 x int8 -> int32 product, y = acc * s_x * scale_n. No TPU kernel backs
it (an XLA ``dot_general`` there), so on the card the product is one
library call, ``torch._int_mm`` (cuBLAS), with the rows of a decode product
padded past its 16-row minimum; on the CPU the exact plain product. The
decoder and encoder modules hold "qs8" K-major (``w8a8_layout``), the
layout the library call reads at speed.
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops import fused_mlp as fm
from qwen2_audio_tpu_torch.ops.quant_matmul import (quant_linear, quant_linear_panel,
                                                    quant_linear_stacked)
from qwen2_audio_tpu_torch.ops.quant_matmul_int8 import (GROUP, quant_linear_int8,
                                                         quant_linear_int8_stacked)
from qwen2_audio_tpu_torch.ops.quant_matmul_q4b import quant_linear_q4b, quant_linear_q4b_stacked

_MODES = ("bf16", "dequant", "int8")
_GROUP_MATMUL_MODE: str | None = None
_FUSED_MLP: bool | None = None
_DEQUANT16 = (False, False)      # (q4, q8)
_BLOCK_KEYS = ("qs", "qs4", "qs_p", "qs4_p")

# torch._int_mm on the card takes more than 16 rows, and K and N multiples of 8
INT_MM_MIN_M = 17
INT_MM_ALIGN = 8


def set_group_matmul_mode(mode: str | None) -> None:
    if mode is not None and mode not in _MODES:
        raise ValueError(f"group matmul mode {mode!r}: want one of {_MODES} or None")
    global _GROUP_MATMUL_MODE
    _GROUP_MATMUL_MODE = mode


def group_matmul_mode() -> str:
    """The mode in force; None resolves to "bf16" on every device."""
    return _GROUP_MATMUL_MODE or "bf16"


def set_fused_mlp(on: bool | None) -> None:
    """Switch the one-launch SwiGLU MLP on or off for the process; None is
    the default, on."""
    global _FUSED_MLP
    _FUSED_MLP = None if on is None else bool(on)


def fused_mlp_enabled() -> bool:
    return True if _FUSED_MLP is None else _FUSED_MLP


def set_dequant16(q4: bool = False, q8: bool = False) -> None:
    """Switch the bf16-domain dequant of the bf16 mode on or off for the
    process: ``q4`` for packed nibbles, ``q8`` for int8 values."""
    global _DEQUANT16
    _DEQUANT16 = (bool(q4), bool(q8))


def dequant16() -> tuple[bool, bool]:
    """(q4, q8): the switches of ``set_dequant16``."""
    return _DEQUANT16


def _dq16(p: dict) -> bool:
    """The dequant16 switch of this block dict's form."""
    q4, q8 = _DEQUANT16
    return q4 if ("qs4" in p or "qs4_p" in p) else q8


def _fast() -> bool:
    """True for the bf16 mode; the exact dequantizing kernels otherwise."""
    return group_matmul_mode() == "bf16"


def _int8(x: torch.Tensor, scales: torch.Tensor) -> bool:
    """Mode "int8" and 32-groups along K (scales (..., K // group, N))."""
    return group_matmul_mode() == "int8" and x.shape[-1] // scales.shape[-2] == GROUP


def _refuse(p: dict):
    raise ValueError(f"not a linear layer's parameters: keys {sorted(p)}")


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (x_q int8 (M, K), s_x float32 (M, 1)): s_x = max|x| / 127
    per row, x_q = round(x * (1 / s_x)) (0 where s_x is 0), half to even, as
    the JAX package's ``_w8a8``; the quotients tensor by tensor, which the
    card computes as IEEE divisions (a division by a Python number is a
    multiplication by its reciprocal there)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = amax / torch.full_like(amax, 127.0)
    pos = s_x > 0
    one = torch.ones_like(s_x)
    inv = torch.where(pos, one / torch.where(pos, s_x, one), torch.zeros_like(s_x))
    return torch.round(xf * inv).to(torch.int8), s_x


# rows of K a float32 product sums exactly: 1024 * 127 * 127 < 2^24
PLAIN_K_CHUNK = 1024


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> int32, exact: float32 products over
    chunks of ``PLAIN_K_CHUNK`` rows of K (every partial sum an integer
    below 2^24, so exact in any order), summed in int32. The float32 copy
    of b is made a chunk at a time."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.int32, device=a.device)
    for k0 in range(0, a.shape[1], PLAIN_K_CHUNK):
        k1 = k0 + PLAIN_K_CHUNK
        acc += (a[:, k0:k1].float() @ b[k0:k1].float()).to(torch.int32)
    return acc


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> int32 (M, N). On the card one
    ``torch._int_mm`` (cuBLAS), a's rows padded with zeros to
    ``INT_MM_MIN_M`` where there are fewer; K and N must be multiples of 8.
    The plain version for CPU tensors; any other device raises."""
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: no product for device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if K % INT_MM_ALIGN or N % INT_MM_ALIGN:
        raise ValueError(f"int8_matmul: K {K} and N {N} must be multiples of "
                         f"{INT_MM_ALIGN} for torch._int_mm")
    a = a.contiguous()
    if M < INT_MM_MIN_M:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_M - M, K)])
    int8_matmul.launches += 1
    return torch._int_mm(a, b)[:M]


int8_matmul.launches = 0


def w8a8_layout(tree):
    """The tree with every per-channel w8a8 weight ("qs8", (..., K, N))
    stored K-major: the same (..., K, N) view over memory laid out
    (..., N, K), which ``torch._int_mm`` reads 5-14 times faster on the card
    than the row-major layout (PERF.md section 6). Values and every other
    leaf unchanged; a K-major leaf is kept as it is."""
    if isinstance(tree, (list, tuple)):
        return [w8a8_layout(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: w8a8_layout(v) for k, v in tree.items()}
    q = tree.get("qs8")
    if isinstance(q, torch.Tensor) and q.dim() >= 2 and q.stride(-2) != 1:
        out["qs8"] = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    return out


def w8a8(x: torch.Tensor, qs8: torch.Tensor, scale_n: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ the per-channel w8a8 weight (qs8 (K, N), scale_n (N,)):
    the JAX package's ``_w8a8``, in x's type."""
    lead = x.shape[:-1]
    x_q, s_x = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = int8_matmul(x_q, qs8)
    y = acc.float() * s_x * scale_n.float()
    return y.to(x.dtype).reshape(*lead, -1)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
    elif "qs8" in p:
        y = w8a8(x, p["qs8"], p["scale_n"])
    elif "qs4b" in p:
        y = quant_linear_q4b(x, p)
    elif "qs_p" in p or "qs4_p" in p:
        y = quant_linear_panel(x, p, fast=_fast(), dq16=_dq16(p))
    elif "qs" in p and _int8(x, p["scales"]):
        y = quant_linear_int8(x, p)
    elif "qs4" in p or "qs" in p:
        y = quant_linear(x, p, fast=_fast(), dq16=_dq16(p))
    else:
        _refuse(p)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def linear_at(x: torch.Tensor, p: dict, li: int) -> torch.Tensor:
    """``linear`` with layer ``li`` of the stacked leaves."""
    if "w" in p:
        y = x @ p["w"][li].to(x.dtype)
    elif "qs8" in p:
        y = w8a8(x, p["qs8"][li], p["scale_n"][li])
    elif "qs4b" in p:
        y = quant_linear_q4b_stacked(x, p, li)
    elif ("qs" in p or "qs4" in p) and _int8(x, p["scales"]):
        y = quant_linear_int8_stacked(x, p, li)
    elif any(k in p for k in _BLOCK_KEYS):
        y = quant_linear_stacked(x, p, li, fast=_fast(), dq16=_dq16(p))
    else:
        _refuse(p)
    if "b" in p:
        y = y + p["b"][li].to(y.dtype)
    return y


def _fused_form(x: torch.Tensor, ws: tuple[dict, ...]) -> tuple[bool, tuple] | None:
    """Whether the one-launch SwiGLU takes these block dicts (gate_up and
    down, or gate, up and down) at this x: (packed, leaf order), else None.
    A dispatch on the weight form and on M alone."""
    if not fused_mlp_enabled() or any("b" in w for w in ws):
        return None
    K = x.shape[-1]
    dn = ws[-1]
    packed = all("qs4" in w for w in ws)
    if not packed and not all("qs" in w for w in ws):
        return None
    mins = ["mins" in w for w in ws]
    if any(mins) != all(mins):
        return None
    qkey = "qs4" if packed else "qs"
    I = dn[qkey].shape[1] * (2 if packed else 1)
    g_group, d_group = K // ws[0]["scales"].shape[1], I // dn["scales"].shape[1]
    if g_group != d_group or (packed and g_group != 32):
        return None
    if any(w.keys() != ws[0].keys() for w in ws[1:-1]):
        return None
    if x.numel() // K > fm.ONE_LAUNCH_MAX_M:   # above, the two-launch path is faster
        return None
    if group_matmul_mode() == "int8":
        return None
    return packed, (qkey, "scales", "mins") if mins[0] else (qkey, "scales")


def fused_mlp_at(x: torch.Tensor, gu: dict, dn: dict, li: int) -> torch.Tensor | None:
    """silu(x @ gate) * (x @ up) @ down in one launch for layer ``li`` of
    stacked block dicts, ``gu`` holding the gate columns, then the up
    columns: strided int8 values ("qs") or packed nibbles ("qs4"), both with
    or both without "mins". Returns None where the one-launch kernel does
    not apply (the switch is off, a bias, a panel or dense form, forms or
    groups that differ between gate_up and down, more than
    ``fm.ONE_LAUNCH_MAX_M`` rows, mode "int8"); the caller then takes two
    ``linear_at`` calls."""
    form = _fused_form(x, (gu, dn))
    if form is None:
        return None
    packed, order = form
    fast = _fast()
    x2 = x.reshape(-1, x.shape[-1])
    leaves = [w[k] for w in (gu, dn) for k in order]
    entry = {(False, 2): fm.fused_mlp_stacked, (False, 3): fm.fused_mlp_m_stacked,
             (True, 3): fm.fused_mlp4_stacked, (True, 2): fm.fused_mlp4_sym_stacked
             }[packed, len(order)]
    return entry(x2, *leaves, li, fast=fast).reshape(*x.shape[:-1], -1)


def fused_mlp_split_at(x: torch.Tensor, g: dict, u: dict, dn: dict,
                       li: int) -> torch.Tensor | None:
    """``fused_mlp_at`` for unfused layers, gate and up in two dicts with
    equal key sets; None where it does not apply (then three ``linear_at``
    calls)."""
    form = _fused_form(x, (g, u, dn))
    if form is None:
        return None
    packed, order = form
    fast = _fast()
    x2 = x.reshape(-1, x.shape[-1])
    leaves = (tuple(w[k] for k in order) for w in (g, u, dn))
    y = fm.fused_mlp_split_stacked(x2, *leaves, li, packed=packed, fast=fast)
    return y.reshape(*x.shape[:-1], -1)
