"""Checkpoint export and quantization.

- ``encoder_tensors_from_params`` / ``write_encoder_checkpoint``: the inverse
  of the encoder loader (replaces models/convert-pt-to-ggml.py, writer
  :266-339): f16 weights by default, f32 for 1-D tensors, conv biases and
  positional embeddings, conv bias stored [n, 1].
- ``quantize_checkpoint``: re-encodes a checkpoint's 2-D matmul weights into
  a ggml block format (examples/common-ggml.cpp:41-244): quantizes the
  weights matching the include patterns, never norms, biases, convolutions
  or embeddings, and keeps everything else as it is.
"""

from __future__ import annotations

import re
from typing import Iterable

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import (
    FTYPE_TO_TYPE,
    GGML_QNT_VERSION,
    GGML_QNT_VERSION_FACTOR,
    GGMLFType,
    GGMLType,
    WhisperHParams,
)
from qwen2_audio_tpu_torch.io.ggml_format import (
    GGMLTensor,
    read_ggml_file,
    write_ggml_file,
)
from qwen2_audio_tpu_torch.quant import codecs
from qwen2_audio_tpu_torch.utils.logging import log_info

# tensors that always stay f32 (converter rules, convert-pt-to-ggml.py:309-321)
_ALWAYS_F32 = re.compile(
    r"(\.bias$)|(^embed_positions\.weight$)|(layer_norm\.(weight|bias)$)")

# never quantized (common-ggml.cpp skips non-2-D tensors; convolutions,
# embeddings and norms stay as they are)
_NEVER_QUANT = re.compile(
    r"(^conv\d\.)|(^embed_positions\.)|(layer_norm\.)|(\.bias$)")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def encoder_tensors_from_params(params, use_f16: bool = True
                                ) -> list[GGMLTensor]:
    """Param tree (models/encoder.py layout, [in,out] linears, separate
    q/k/v) -> tensor records in the on-disk layout (torch [out,in], conv
    bias [n,1])."""

    out: list[GGMLTensor] = []

    def add(name: str, arr, force_f32: bool = False):
        arr = _np(arr)
        if use_f16 and arr.ndim >= 2 and not force_f32 \
                and not _ALWAYS_F32.search(name):
            out.append(GGMLTensor(name, arr.shape, GGMLType.F16,
                                  arr.astype(np.float16)))
        else:
            out.append(GGMLTensor(name, arr.shape, GGMLType.F32, arr))

    add("embed_positions.weight", params["pos"], force_f32=True)
    add("conv1.weight", params["conv1"]["w"])
    add("conv1.bias", _np(params["conv1"]["b"]).reshape(-1, 1), force_f32=True)
    add("conv2.weight", params["conv2"]["w"])
    add("conv2.bias", _np(params["conv2"]["b"]).reshape(-1, 1), force_f32=True)
    add("layer_norm.weight", params["ln_post"]["w"])
    add("layer_norm.bias", params["ln_post"]["b"])

    for i, lyr in enumerate(params["layers"]):
        p = f"layers.{i}"
        add(f"{p}.self_attn_layer_norm.weight", lyr["ln1"]["w"])
        add(f"{p}.self_attn_layer_norm.bias", lyr["ln1"]["b"])
        add(f"{p}.self_attn.q_proj.weight", _np(lyr["q"]["w"]).T)
        add(f"{p}.self_attn.q_proj.bias", lyr["q"]["b"])
        add(f"{p}.self_attn.k_proj.weight", _np(lyr["k"]["w"]).T)
        add(f"{p}.self_attn.v_proj.weight", _np(lyr["v"]["w"]).T)
        add(f"{p}.self_attn.v_proj.bias", lyr["v"]["b"])
        add(f"{p}.self_attn.out_proj.weight", _np(lyr["o"]["w"]).T)
        add(f"{p}.self_attn.out_proj.bias", lyr["o"]["b"])
        add(f"{p}.final_layer_norm.weight", lyr["ln2"]["w"])
        add(f"{p}.final_layer_norm.bias", lyr["ln2"]["b"])
        add(f"{p}.fc1.weight", _np(lyr["fc1"]["w"]).T)
        add(f"{p}.fc1.bias", lyr["fc1"]["b"])
        add(f"{p}.fc2.weight", _np(lyr["fc2"]["w"]).T)
        add(f"{p}.fc2.bias", lyr["fc2"]["b"])
    return out


def write_encoder_checkpoint(path_or_buf, params, hp: WhisperHParams,
                             filters: np.ndarray,
                             vocab: Iterable[bytes],
                             use_f16: bool = True) -> None:
    hp = WhisperHParams(**{**hp.__dict__, "ftype": 1 if use_f16 else 0})
    write_ggml_file(path_or_buf, hp, filters, vocab,
                    encoder_tensors_from_params(params, use_f16))


def quantize_tensor(t: GGMLTensor, ttype: GGMLType) -> GGMLTensor:
    return GGMLTensor(t.name, t.shape, ttype, codecs.quantize(t.to_f32(), ttype))


def quantize_checkpoint(
    src_path_or_buf,
    dst_path_or_buf,
    ftype: GGMLFType,
    to_quant: list[str] | None = None,
    to_skip: list[str] | None = None,
) -> dict[str, int]:
    """Re-encode a checkpoint's 2-D weights into the given block format.

    A k-quant needs rows divisible by 256; a tensor whose rows are not falls
    back to q8_0. Returns {tensor name: ggml type} of the output."""
    qtype = FTYPE_TO_TYPE[GGMLFType(ftype)]
    inc = [re.compile(p) for p in (to_quant or [r".*\.weight$"])]
    skip = [re.compile(p) for p in (to_skip or [])]

    m = read_ggml_file(src_path_or_buf)
    out_tensors: list[GGMLTensor] = []
    result: dict[str, int] = {}
    for name, t in m.tensors.items():
        quantize_this = (
            len(t.shape) == 2
            and t.n_elements % codecs.QK == 0
            and t.shape[-1] % codecs.QK == 0
            and any(p.search(name) for p in inc)
            and not any(p.search(name) for p in skip)
            and not _NEVER_QUANT.search(name)
        )
        if quantize_this:
            qt = qtype
            if qt in codecs.KBLOCK_BYTES and t.shape[-1] % codecs.QK_K:
                qt = GGMLType.Q8_0
                log_info("quantize: %s rows %% 256 != 0, falling back to "
                         "q8_0\n", name)
            t = quantize_tensor(t, qt)
            log_info("quantize: %s -> %s\n", name, qt.name)
        out_tensors.append(t)
        result[name] = int(t.ttype)

    raw_ftype = int(ftype) + GGML_QNT_VERSION * GGML_QNT_VERSION_FACTOR
    write_ggml_file(dst_path_or_buf, m.hparams, m.filters, m.vocab,
                    out_tensors, raw_ftype=raw_ftype)
    return result
