"""Linear-layer dispatch on the parameter dict's keys:

    {"w"[, "b"]}                        dense: a plain ``torch.matmul``
                                        (cuBLAS on the card), as the JAX
                                        package left it to XLA outside Pallas
    {"qs", "scales"[, "mins", "b"]}     ggml blocks as int8 values
    {"qs4", "scales"[, "mins", "b"]}    ggml blocks as packed nibbles

The block forms go through the dequantizing kernels of ops/quant_matmul.py.
How they multiply is a process-wide mode:

    "bf16"     x and the dequantized weight each rounded once to bf16, one
               tensor-core pass, float32 sums (the default)
    "dequant"  the exact float32 product of x and the float32 dequantized
               weight (slow at large M)
    "int8"     int8 activations x int8 weights: not ported

``linear_at`` is ``linear`` over layer ``li`` (a host integer) of a dict
whose leaves carry a leading (n_layers,) axis; the layer is a view, never a
copy. The panel forms ("qs_p", "qs4_p"), the word-packed nibbles ("qs4b")
and the per-channel int8 form ("qs8") are not ported and raise.
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops.quant_matmul import quant_linear, quant_linear_stacked

_MODES = ("bf16", "dequant", "int8")
_GROUP_MATMUL_MODE: str | None = None

_NOT_PORTED = {
    "qs_p": "the int8 panel kernels (ROADMAP.md, section 2, rows 7 and 9)",
    "qs4_p": "the packed-nibble panel kernels (ROADMAP.md, section 2, rows 10 and 11)",
    "qs4b": "the word-packed nibble kernel (ROADMAP.md, section 2, row 16)",
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


def _fast() -> bool:
    """True for the bf16 mode, False for the exact one."""
    mode = group_matmul_mode()
    if mode == "int8":
        raise NotImplementedError(
            "group matmul mode 'int8': the int8-activation kernels are not "
            "ported yet (ROADMAP.md, section 2, rows 14 and 15)")
    return mode == "bf16"


def _refuse(p: dict):
    for key, what in _NOT_PORTED.items():
        if key in p:
            raise NotImplementedError(f"weight form {sorted(p)}: {what} is not ported yet")
    raise ValueError(f"not a linear layer's parameters: keys {sorted(p)}")


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
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
    elif "qs4" in p or "qs" in p:
        y = quant_linear_stacked(x, p, li, fast=_fast())
    else:
        _refuse(p)
    if "b" in p:
        y = y + p["b"][li].to(y.dtype)
    return y
