"""Qwen2-Audio encoder tower in PyTorch (the whisper-style encoder the
reference runs; graph builders src/qwen2-whisper.cpp:1892-2203):

    mel(B, n_mels, 2*n_ctx)
      -> conv1d(k3,s1,p1)+gelu -> conv1d(k3,s2,p1)+gelu   (im2col matmuls)
      -> positional embedding
      -> N x pre-LN block { LN -> QKV (K un-biased) -> attention -> out-proj
                            -> residual -> LN -> fc1 -> gelu -> fc2 -> residual }
      -> stride-2 average pool over time (1500 -> 750)
      -> final layer-norm
      -> (B, n_ctx//2, n_state)

The parameter tree has the JAX package's layout, with torch tensors:

    {
      "conv1": {"w": (n_state, n_mels, 3), "b": (n_state,)},
      "conv2": {"w": (n_state, n_state, 3), "b": (n_state,)},
      "pos":   (n_audio_ctx, n_state),
      "layers": [ {
          "ln1": {"w","b"}, "q": {"w": (d,d), "b"}, "k": {"w"},
          "v": {"w","b"}, "o": {"w","b"},      # or "qkv": {"w": (d,3d), "b"}
          "ln2": {"w","b"}, "fc1": {"w": (d,4d), "b"}, "fc2": {"w": (4d,d), "b"},
      } x n_layer ],
      "ln_post": {"w","b"},
    }

Linear weights are [in, out]; ``x @ w + b``. A layer's linear may instead be
a ggml block dict ({"qs" | "qs4" | "qs4b", "scales"[, "mins"], "b"}, see
quant/qparams.py), which ops.linear multiplies through the dequantizing
kernels or the exact-integer group matmul (mode "int8", and "qs4b").
``Encoder`` holds such a tree as module buffers, so ``.to(device)`` moves
it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.ops.flash_attention import (attention_encoder_plain,
                                                       flash_attention_encoder)
from qwen2_audio_tpu_torch.ops.linear import linear
from qwen2_audio_tpu_torch.quant.qparams import (QUANT_TYPES,
                                                 device_weight_from_ggml_tensor)

Params = dict[str, Any]


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """ggml_norm + scale/shift (reference :2018-2026); stats in f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    # ggml uses the tanh approximation (ggml_vec_gelu_f32); HF/torch
    # Qwen2AudioEncoder uses exact erf gelu.
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _unfold_time(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, T, C) -> (B, T//stride, k*C): zero-pad k//2 both sides of time,
    stack the k taps tap-major (feature = tap*C + c), as ggml_conv_1d's
    im2col does (ggml/src/ggml.c:6635)."""
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad))
    T = x.shape[1]
    return torch.cat([xp[:, i:i + T:stride] for i in range(k)], dim=-1)


def _conv1d_mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int) -> torch.Tensor:
    """(B, T, C_in) -> (B, T//stride, C_out): the conv stem as an im2col
    matmul; the product rounds once to the compute type, then the bias is
    added in the compute type."""
    k = w.shape[-1]
    m = w.permute(2, 1, 0).reshape(k * w.shape[1], w.shape[0])
    out = _unfold_time(x, k, stride) @ m.to(x.dtype)
    return out + b.to(x.dtype)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, T//stride) through F.conv1d ('ph' padding
    k//2 both sides, ggml_conv_1d_ph)."""
    k = w.shape[-1]
    out = F.conv1d(x, w.to(x.dtype), stride=stride, padding=k // 2)
    return out + b.to(x.dtype)[None, :, None]


def _attention(params: Params, x: torch.Tensor, n_head: int,
               use_flash: bool) -> torch.Tensor:
    if "qkv" in params:
        q, k, v = linear(x, params["qkv"]).chunk(3, dim=-1)
    else:
        q = linear(x, params["q"])
        k = linear(x, params["k"])                # K has no bias (:632, :2037)
        v = linear(x, params["v"])
    attend = flash_attention_encoder if use_flash else attention_encoder_plain
    return linear(attend(q, k, v, n_head), params["o"])


def encoder_forward(
    params: Params,
    mel: torch.Tensor,
    hp: WhisperHParams,
    *,
    pos_offset: int = 0,
    gelu_approximate: bool = False,
    use_flash: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    stem: str = "matmul",
) -> torch.Tensor:
    """mel (B, n_mels, 2*n_ctx) -> encoder output (B, n_ctx//2, n_state).

    ``pos_offset`` mirrors the reference's e_pe iter-view (:1999-2005), used
    when evaluating a shrunken audio_ctx window; like the JAX dynamic slice,
    the start is clamped so the slice stays inside the table. ``use_flash``
    routes attention through the kernel wrapper (the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors); ``use_flash=False`` takes
    the plain version on any device. ``stem`` picks the conv stem lowering: "matmul" (im2col) or
    "conv" (F.conv1d)."""
    eps = hp.eps
    x = mel.to(compute_dtype)

    if stem == "matmul":
        x = x.transpose(1, 2)                      # (B, T, n_mels)
        x = _gelu(_conv1d_mm(x, params["conv1"]["w"], params["conv1"]["b"], 1),
                  gelu_approximate)
        x = _gelu(_conv1d_mm(x, params["conv2"]["w"], params["conv2"]["b"], 2),
                  gelu_approximate)
    elif stem == "conv":
        x = _gelu(_conv1d(x, params["conv1"]["w"], params["conv1"]["b"], 1),
                  gelu_approximate)
        x = _gelu(_conv1d(x, params["conv2"]["w"], params["conv2"]["b"], 2),
                  gelu_approximate)
        x = x.transpose(1, 2)                      # (B, T, n_state)
    else:
        raise ValueError(f"unknown stem {stem!r}")
    T = x.shape[1]
    n_pos = params["pos"].shape[0]
    start = min(max(pos_offset * T, 0), n_pos - T)
    x = x + params["pos"][start:start + T].to(compute_dtype)[None]

    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], eps)
        x = x + _attention(layer, h, hp.n_audio_head, use_flash)
        h = _layer_norm(x, layer["ln2"]["w"], layer["ln2"]["b"], eps)
        h = _gelu(linear(h, layer["fc1"]), gelu_approximate)
        x = x + linear(h, layer["fc2"])

    # Qwen2-Audio stride-2 average pooler over time (:2160-2171):
    # (x0 + x1) * 0.5 in f32, then one rounding to the compute type
    T2 = x.shape[1] // 2
    xf = x[:, :2 * T2].float()
    x = ((xf[:, 0::2] + xf[:, 1::2]) * 0.5).to(x.dtype)

    return _layer_norm(x, params["ln_post"]["w"], params["ln_post"]["b"], eps)


def fuse_encoder_qkv(params: Params) -> Params:
    """Concatenate each layer's q/k/v projections into one "qkv" leaf dict
    along the output axis (a runtime layout; checkpoints keep q/k/v). Works
    for every weight form, dense "w" or block "qs" / "qs4" / "qs4b" /
    "scales" / "mins": the quantization groups run along the input axis.
    K's missing bias (reference :632) becomes zeros in the fused bias."""

    def fuse_layer(lyr: dict) -> dict:
        q, k, v = lyr["q"], lyr["k"], lyr["v"]
        leaves = set(q) - {"b"}
        if leaves != set(k) - {"b"} or leaves != set(v) - {"b"}:
            raise ValueError("fuse_encoder_qkv: q/k/v differ in weight form: "
                             f"{sorted(q)}, {sorted(k)}, {sorted(v)}")
        fused = {leaf: torch.cat([q[leaf], k[leaf], v[leaf]], dim=-1)
                 for leaf in sorted(leaves)}
        if "b" in q or "b" in v:
            ref = q.get("b", v.get("b"))
            zeros = torch.zeros_like(ref)
            fused["b"] = torch.cat([q.get("b", zeros), k.get("b", zeros),
                                    v.get("b", zeros)], dim=-1)
        out = {kk: vv for kk, vv in lyr.items() if kk not in ("q", "k", "v")}
        out["qkv"] = fused
        return out

    out = dict(params)
    out["layers"] = [fuse_layer(lyr) for lyr in params["layers"]]
    return out


def fingerprint(enc_out, n: int = 20) -> str:
    """First-n-floats fingerprint matching whisper_print_emb_enc
    (src/qwen2-whisper.cpp:4191-4203): channels 0..n-1 of output frame 0."""
    if isinstance(enc_out, torch.Tensor):
        enc_out = enc_out.detach().float().cpu().numpy()
    vals = np.asarray(enc_out).reshape(-1, enc_out.shape[-1])[0, :n]
    return "".join(f" {v:.3f}" for v in vals)


# --------------------------------------------------------------------------- #
# parameter construction
# --------------------------------------------------------------------------- #

def random_encoder_params(rng: np.random.Generator, hp: WhisperHParams,
                          dtype: torch.dtype = torch.float32,
                          scale: float = 0.02) -> Params:
    """Random weights on the CPU. Draws from ``rng`` in the same order, shape
    and type as the JAX package's random_encoder_params, so one seed gives
    the same weights in both packages."""
    d, m = hp.n_audio_state, hp.n_mels

    def t(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(dtype)

    def layer():
        return {
            "ln1": {"w": torch.ones(d, dtype=dtype), "b": torch.zeros(d, dtype=dtype)},
            "q": {"w": t(d, d), "b": t(d)},
            "k": {"w": t(d, d)},
            "v": {"w": t(d, d), "b": t(d)},
            "o": {"w": t(d, d), "b": t(d)},
            "ln2": {"w": torch.ones(d, dtype=dtype), "b": torch.zeros(d, dtype=dtype)},
            "fc1": {"w": t(d, 4 * d), "b": t(4 * d)},
            "fc2": {"w": t(4 * d, d), "b": t(d)},
        }

    return {
        "conv1": {"w": t(d, m, 3), "b": t(d)},
        "conv2": {"w": t(d, d, 3), "b": t(d)},
        "pos": t(hp.n_audio_ctx, d),
        "layers": [layer() for _ in range(hp.n_audio_layer)],
        "ln_post": {"w": torch.ones(d, dtype=dtype), "b": torch.zeros(d, dtype=dtype)},
    }


def encoder_params_from_ggml(model_file, dtype: torch.dtype = torch.float32,
                             device: torch.device | str = "cpu",
                             keep_quantized: bool = False) -> Params:
    """Build the param tree from a parsed GGMLModelFile, pre-transposing
    linear weights from torch [out, in] to [in, out]. Tensor names follow
    src/qwen2-whisper.cpp:1603-1662.

    ``keep_quantized``: a layer weight stored in one of the ten ggml block
    formats stays in block form as a {"qs" | "qs4", "scales"[, "mins"]} dict
    on ``device`` (bit-exact with the file's payload) and multiplies through
    the quantized kernels; otherwise it is expanded to a dense weight."""
    hp = model_file.hparams
    ts = model_file.tensors

    def get(name, transpose=False):
        arr = ts[name].to_f32()
        if transpose:
            arr = arr.T
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device, dtype)

    def lin(prefix, bias=True):
        t = ts[prefix + ".weight"]
        if keep_quantized and t.ttype in QUANT_TYPES:
            out = device_weight_from_ggml_tensor(t, device=device)
        else:
            out = {"w": get(prefix + ".weight", transpose=True)}
        if bias:
            out["b"] = get(prefix + ".bias")
        return out

    def ln(prefix):
        return {"w": get(prefix + ".weight"), "b": get(prefix + ".bias")}

    layers = []
    for i in range(hp.n_audio_layer):
        p = f"layers.{i}"
        layers.append({
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "q": lin(f"{p}.self_attn.q_proj"),
            "k": lin(f"{p}.self_attn.k_proj", bias=False),
            "v": lin(f"{p}.self_attn.v_proj"),
            "o": lin(f"{p}.self_attn.out_proj"),
            "ln2": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        })

    # conv biases are stored [n, 1] by the converter (convert-pt-to-ggml.py:299-301)
    return {
        "conv1": {"w": get("conv1.weight"), "b": get("conv1.bias").reshape(-1)},
        "conv2": {"w": get("conv2.weight"), "b": get("conv2.bias").reshape(-1)},
        "pos": get("embed_positions.weight"),
        "layers": layers,
        "ln_post": ln("layer_norm"),
    }


class _Tree(nn.Module):
    """A nested dict/list of tensors held as buffers (dict keys become
    buffer or child names, lists become ModuleLists)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_buffer(key, val)
            elif isinstance(val, dict):
                self.add_module(key, _Tree(val))
            else:
                self.add_module(key, nn.ModuleList(_Tree(x) for x in val))

    def tree(self) -> dict:
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            if isinstance(val, torch.Tensor):
                out[key] = val
            elif isinstance(val, _Tree):
                out[key] = val.tree()
            else:
                out[key] = [x.tree() for x in val]
        return out


class Encoder(nn.Module):
    """The encoder as a module: holds the parameter tree and runs
    ``encoder_forward`` with attention through ops.flash_attention (the
    CUDA kernel on the card, its plain version on the CPU)."""

    def __init__(self, params: Params, hp: WhisperHParams, *,
                 gelu_approximate: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weights = _Tree(params)
        self.hp = hp
        self.gelu_approximate = gelu_approximate
        self.compute_dtype = compute_dtype

    @property
    def params(self) -> Params:
        return self.weights.tree()

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        return encoder_forward(
            self.params, mel, self.hp, pos_offset=pos_offset,
            gelu_approximate=self.gelu_approximate, use_flash=True,
            compute_dtype=self.compute_dtype)
