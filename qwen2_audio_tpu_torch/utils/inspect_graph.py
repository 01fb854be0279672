"""Per-node inspection + cross-configuration comparison.

The reference's divergence-bisection tools are the scheduler eval-callback
(ggml_debug, src/qwen2-whisper.cpp:2215-2229) and
ggml_backend_compare_graph_backend (ggml/include/ggml-backend.h:291-294) —
run a graph, intercept every node, or run it on two backends and diff
per-node. Here: an eager instrumented encoder forward that returns every
named intermediate, plus a differ that reports the first node where two
runs diverge (float32 against bf16, dense against quantized, the CPU
against the card).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.models.encoder import (_attention, _conv1d_mm, _gelu,
                                                  _layer_norm)
from qwen2_audio_tpu_torch.ops.linear import linear


def encoder_intermediates(
    params: dict,
    mel,
    hp: WhisperHParams,
    *,
    gelu_approximate: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    callback: Callable[[str, torch.Tensor], None] | None = None,
) -> dict[str, np.ndarray]:
    """Instrumented encoder forward: returns {node_name: activation} as
    float32 host arrays (numpy has no bfloat16).

    Runs the math of models/encoder.py::encoder_forward (its helpers, the
    im2col stem, the float32 pair-mean pool) eagerly on the device the
    parameters and ``mel`` are on, so its "ln_post" equals
    ``encoder_forward(...)`` there. Attention goes through
    ops.fa_variants.flash_attention_encoder, as in the runtime's encoder:
    the CUDA kernel for CUDA tensors, its plain version on the CPU.
    ``callback(name, tensor)`` is invoked per node with the device tensor if
    given.
    """
    out: dict[str, np.ndarray] = {}

    def emit(name: str, val: torch.Tensor):
        out[name] = val.detach().float().cpu().numpy()
        if callback is not None:
            callback(name, val)

    eps = hp.eps
    mel = torch.as_tensor(mel)
    x = mel.to(compute_dtype).transpose(1, 2)     # (B, T, n_mels)
    x = _gelu(_conv1d_mm(x, params["conv1"]["w"], params["conv1"]["b"], 1),
              gelu_approximate)
    emit("conv1", x)
    x = _gelu(_conv1d_mm(x, params["conv2"]["w"], params["conv2"]["b"], 2),
              gelu_approximate)
    emit("conv2", x)

    T = x.shape[1]
    start = min(0, params["pos"].shape[0] - T)    # encoder_forward at pos_offset 0
    x = x + params["pos"][start:start + T].to(compute_dtype)[None]
    emit("pos_add", x)

    for i, layer in enumerate(params["layers"]):
        h = _layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], eps)
        emit(f"layer{i}.ln1", h)
        a = _attention(layer, h, hp.n_audio_head, True)
        emit(f"layer{i}.attn", a)
        x = x + a
        h = _layer_norm(x, layer["ln2"]["w"], layer["ln2"]["b"], eps)
        h = _gelu(linear(h, layer["fc1"]), gelu_approximate)
        emit(f"layer{i}.fc1", h)
        x = x + linear(h, layer["fc2"])
        emit(f"layer{i}.out", x)

    # the same pool as encoder_forward: (x0 + x1) * 0.5 in float32, one
    # rounding to the compute type
    T2 = x.shape[1] // 2
    xf = x[:, :2 * T2].float()
    x = ((xf[:, 0::2] + xf[:, 1::2]) * 0.5).to(x.dtype)
    emit("avg_pool", x)
    x = _layer_norm(x, params["ln_post"]["w"], params["ln_post"]["b"], eps)
    emit("ln_post", x)
    return out


def compare_runs(
    a: dict[str, np.ndarray],
    b: dict[str, np.ndarray],
    rtol: float = 1e-3,
    atol: float = 1e-4,
) -> list[dict]:
    """Per-node diff of two intermediate captures; returns a report sorted
    in graph order with the max deviation per node (the
    compare_graph_backend analog)."""
    report = []
    for name in a:
        if name not in b:
            continue
        x, y = a[name].astype(np.float64), b[name].astype(np.float64)
        max_abs = float(np.max(np.abs(x - y))) if x.size else 0.0
        denom = np.maximum(np.abs(x), 1e-9)
        max_rel = float(np.max(np.abs(x - y) / denom)) if x.size else 0.0
        report.append({
            "node": name,
            "max_abs": max_abs,
            "max_rel": max_rel,
            "ok": bool(max_abs <= atol + rtol * float(np.max(np.abs(x)))),
        })
    return report


def first_divergence(report: list[dict]) -> str | None:
    for r in report:
        if not r["ok"]:
            return r["node"]
    return None
