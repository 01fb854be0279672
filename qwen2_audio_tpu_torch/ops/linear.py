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

"qs4b" goes through the integer kernel's word form (ops/quant_matmul_q4b.py)
in every mode. ``linear_at`` is ``linear`` over layer ``li`` (a host integer)
of a dict whose leaves carry a leading (n_layers,) axis; the layer is a
view, never a copy. ``fused_mlp_at`` and ``fused_mlp_split_at`` run a whole
SwiGLU MLP (gate, up, SiLU, down) of strided block dicts in one launch at
decode M (ops/fused_mlp.py) or return None, and the caller then takes
``linear_at`` per projection; ``set_fused_mlp(False)`` switches them off for
the process, and mode "int8" has no one-launch kernel. The per-channel int8
form ("qs8") is not ported and raises.
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
_BLOCK_KEYS = ("qs", "qs4", "qs_p", "qs4_p")

_NOT_PORTED = {
    "qs8": "the per-channel w8a8 form (ROADMAP.md, section 1, item 7)",
}


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


def _fast() -> bool:
    """True for the bf16 mode; the exact dequantizing kernels otherwise."""
    return group_matmul_mode() == "bf16"


def _int8(x: torch.Tensor, scales: torch.Tensor) -> bool:
    """Mode "int8" and 32-groups along K (scales (..., K // group, N))."""
    return group_matmul_mode() == "int8" and x.shape[-1] // scales.shape[-2] == GROUP


def _refuse(p: dict):
    for key, what in _NOT_PORTED.items():
        if key in p:
            raise NotImplementedError(f"weight form {sorted(p)}: {what} is not ported yet")
    raise ValueError(f"not a linear layer's parameters: keys {sorted(p)}")


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
    elif "qs4b" in p:
        y = quant_linear_q4b(x, p)
    elif "qs_p" in p or "qs4_p" in p:
        y = quant_linear_panel(x, p, fast=_fast())
    elif "qs" in p and _int8(x, p["scales"]):
        y = quant_linear_int8(x, p)
    elif "qs4" in p or "qs" in p:
        y = quant_linear(x, p, fast=_fast())
    else:
        _refuse(p)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def linear_at(x: torch.Tensor, p: dict, li: int) -> torch.Tensor:
    """``linear`` with layer ``li`` of the stacked leaves."""
    if "w" in p:
        y = x @ p["w"][li].to(x.dtype)
    elif "qs4b" in p:
        y = quant_linear_q4b_stacked(x, p, li)
    elif ("qs" in p or "qs4" in p) and _int8(x, p["scales"]):
        y = quant_linear_int8_stacked(x, p, li)
    elif any(k in p for k in _BLOCK_KEYS):
        y = quant_linear_stacked(x, p, li, fast=_fast())
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
    if x.numel() // K > fm.MAX_M:      # prefill: bound by operations
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
    groups that differ between gate_up and down, more than 64 rows, mode
    "int8"); the caller then takes two ``linear_at`` calls."""
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
