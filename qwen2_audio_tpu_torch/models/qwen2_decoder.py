"""Qwen2 text decoder in PyTorch: RMSNorm, rotary embeddings (theta 1e6),
attention with Q/K/V biases and an un-biased out-projection, GQA, SwiGLU
MLP, tied or separate lm_head.

The parameter tree has the JAX package's layout, with torch tensors, every
layer leaf STACKED on a leading (n_layers, ...) axis:

    {
      "embed": (V, D),
      "layers": {
        "ln1": {"w": (L, D)}, "ln2": {"w": (L, D)},
        "q": {"w": (L, D, Hq*d), "b"}, "k": {"w", "b"}, "v": {"w", "b"},
        "o": {"w": (L, Hq*d, D)},
        "gate": {"w": (L, D, I)}, "up": {"w"}, "down": {"w": (L, I, D)},
      },                        # or "qkv" / "gate_up" (fuse_decoder_params)
      "ln_f": {"w": (D,)},
      "lm_head": {"w": (D, V)},   # absent when the embeddings are tied
    }

Linear weights are [in, out]; layer i reads ``w[i]``, a view. A linear may
instead be a ggml block dict with stacked leaves ({"qs": (L, K, N) int8,
"qs4": (L, K // 2, N) uint8 or "qs4b": (L, K // 8, N) int32, "scales": (L,
K // group, N)[, "mins"], "b"}, see quant/qparams.py), or the same in
contiguous column panels ({"qs_p": (L, P, K, bn) or "qs4_p", "scales_p"},
``panelize_decoder_params``); ``ops.linear.linear_at`` multiplies every
form, through the dequantizing kernels or, in mode "int8" and for "qs4b",
the exact-integer group matmul. The MLP of strided block dicts is one
launch of the fused SwiGLU kernel at decode M (``ops.linear.fused_mlp_at``), else two
or three such products around SiLU(gate) * up. The KV cache
is a preallocated (L, B, max_ctx, Hkv, d) buffer updated in place
(PyTorch has no buffer donation to copy). Attention goes through the kernel
wrappers of ops/: the causal prefill kernel for a fresh block
(``block_only``), the decode kernel for one position over the cache; each
wrapper runs its plain version for CPU tensors. ``use_flash=False`` runs
the plain einsum attention on any device. The cast order follows the JAX
package: RMSNorm's ``.to(x.dtype) * w``, RoPE in float32 cast back to
``x.dtype``, attention scores and softmax in float32.

Per-stream positions (continuous batching), the tensor-parallel psums, the
DTW attention tap and beam tiling are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
from qwen2_audio_tpu_torch.models.encoder import _Tree
from qwen2_audio_tpu_torch.ops.flash_attention import attention_causal
from qwen2_audio_tpu_torch.ops.flash_decode import flash_decode, flash_decode_quant
from qwen2_audio_tpu_torch.ops.linear import (fused_mlp_at, fused_mlp_split_at, linear,
                                               linear_at)
from qwen2_audio_tpu_torch.ops.quant_matmul import panelize_weight
from qwen2_audio_tpu_torch.ops.quant_matmul_q4b import pack_b32
from qwen2_audio_tpu_torch.utils.logging import log_warn

Params = dict[str, Any]


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache: k/v (n_layers, B, max_ctx, n_kv_heads, head_dim);
    ``pos`` is the number of valid positions."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0

    @classmethod
    def create(cls, cfg: Qwen2DecoderConfig, batch: int, max_ctx: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_ctx,
                 cfg.num_key_value_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_ctx(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache with per-(position, head) float32 scales:
    k_q/v_q (L, B, S, Hkv, d) int8, k_s/v_s (L, B, S, Hkv) float32."""

    k_q: torch.Tensor
    k_s: torch.Tensor
    v_q: torch.Tensor
    v_s: torch.Tensor
    pos: int = 0

    @classmethod
    def create(cls, cfg: Qwen2DecoderConfig, batch: int, max_ctx: int,
               device: torch.device | str = "cpu") -> "QuantKVCache":
        shape = (cfg.num_hidden_layers, batch, max_ctx,
                 cfg.num_key_value_heads, cfg.head_dim)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(k_q=z(shape, torch.int8), k_s=z(shape[:-1], torch.float32),
                   v_q=z(shape, torch.int8), v_s=z(shape[:-1], torch.float32))

    @property
    def max_ctx(self) -> int:
        return self.k_q.shape[2]


def create_cache(cfg: Qwen2DecoderConfig, batch: int, max_ctx: int,
                 dtype=torch.bfloat16, device: torch.device | str = "cpu"):
    """Cache factory: dtype "q8" (or torch.int8) selects the quantized cache."""
    if dtype == "q8" or dtype == torch.int8:
        return QuantKVCache.create(cfg, batch, max_ctx, device=device)
    return KVCache.create(cfg, batch, max_ctx, dtype=dtype, device=device)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, d) -> int8 values + per-vector float32 scale."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    return torch.round(xf * inv[..., None]).to(torch.int8), s


class _MixedForms(Exception):
    pass


def fuse_decoder_params(params: Params) -> Params:
    """Concatenate q/k/v -> "qkv" and gate/up -> "gate_up" along the output
    axis of the stacked leaves (a runtime layout: at decode every projection
    is a weight-bound matrix-vector product, and 7 of them per layer become
    4). Works for every weight form, dense "w" or block "qs" / "qs4" /
    "qs4b" / "scales" / "mins", because the quantization groups run along
    the input axis; biases concatenate with zeros for a missing one. Projections whose
    forms differ (a k-quant checkpoint may keep v at another type than q)
    cannot concatenate: the tree is then returned as it is, with separate
    projections."""
    layers = dict(params["layers"])
    if "qkv" in layers:
        return params

    def fuse(entries: list[dict]) -> dict:
        forms = [set(e) - {"b"} for e in entries]
        if any(f != forms[0] for f in forms):
            raise _MixedForms()
        fused = {leaf: torch.cat([e[leaf] for e in entries], dim=-1)
                 for leaf in sorted(forms[0])}
        if any("b" in e for e in entries):
            some = next(e["b"] for e in entries if "b" in e)
            width = [next(e[k] for k in ("w", "qs", "qs4", "qs4b") if k in e).shape[-1]
                     for e in entries]
            fused["b"] = torch.cat(
                [e["b"] if "b" in e else some.new_zeros(some.shape[0], n)
                 for e, n in zip(entries, width)], dim=-1)
        return fused

    try:
        layers["qkv"] = fuse([layers.pop("q"), layers.pop("k"), layers.pop("v")])
        layers["gate_up"] = fuse([layers.pop("gate"), layers.pop("up")])
    except _MixedForms:
        log_warn("fuse_decoder_params: mixed weight forms across q/k/v or "
                 "gate/up - keeping separate projections\n")
        return params
    out = dict(params)
    out["layers"] = layers
    return out


MAX_PANEL_K = 8192


def panelize_decoder_params(params: Params, *, deep_k: bool = False,
                            skip_gate_up: bool = False) -> Params:
    """Re-store the decoder's ggml block dicts in contiguous column panels
    ({"qs": (L, K, N)} -> {"qs_p": (L, P, K, bn)}, {"qs4": (L, K // 2, N)} ->
    {"qs4_p": (L, P, K // 2, bn)}, "scales" -> "scales_p"; the lm_head
    without the (L,) axis), the JAX package's decode-tuned storage. A pure
    layout transform of torch or numpy leaves: values, "mins" and "b" are
    untouched, dense and "qs4b" entries pass through. Entries with K > 8192
    (the 7B "down") stay strided unless ``deep_k``. ``skip_gate_up`` leaves the
    fused "gate_up" strided, so that ``fused_mlp_at``, which takes strided
    forms only, stays engaged beside panels on qkv, o and the lm_head.
    Compose after ``fuse_decoder_params``."""
    def wanted(e) -> bool:
        if not isinstance(e, dict) or "scales" not in e or not ("qs" in e or "qs4" in e):
            return False
        K = e["qs4"].shape[-2] * 2 if "qs4" in e else e["qs"].shape[-2]
        return deep_k or K <= MAX_PANEL_K

    layers = {key: panelize_weight(e) if wanted(e) and not (skip_gate_up and key == "gate_up")
              else e for key, e in params["layers"].items()}
    out = dict(params, layers=layers)
    if wanted(out.get("lm_head")):
        out["lm_head"] = panelize_weight(out["lm_head"])
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (T,) -> (T, head_dim) in float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, d); cos/sin (T, d). Float32 products, cast back to x's type."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos[None, :, None, :] + rotated * sin[None, :, None, :]).to(x.dtype)


def _visible_mask(q_pos0: int, T: int, S: int, device) -> torch.Tensor:
    """(T, S) causal + cache-validity mask: key j visible to query t iff
    j <= q_pos0 + t."""
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    return s <= q_pos0 + t


def _gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos0: int) -> torch.Tensor:
    """Plain attention: q (B, T, Hq, d), k/v (B, S, Hkv, d) -> (B, T, Hq*d).
    Key j is visible to query t iff j <= q_pos0 + t; scores and softmax in
    float32, weights cast to V's type before the weighted sum."""
    B, T, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.unflatten(2, (Hkv, Hq // Hkv))                         # (B,T,Hkv,g,d)
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    logits = logits * d ** -0.5
    logits = logits.masked_fill(~_visible_mask(q_pos0, T, S, q.device), -torch.inf)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", w.float(), v.float()).to(q.dtype)
    return out.reshape(B, T, Hq * d)


def _gqa_attention_quant(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                         v_q: torch.Tensor, v_s: torch.Tensor,
                         q_pos0: int) -> torch.Tensor:
    """Plain attention over the int8 cache: the per-vector K scales multiply
    the float32 logits and the V scales the softmax weights, which are then
    cast to q's type. q (B, T, Hq, d); k_q/v_q (B, S, Hkv, d); k_s/v_s
    (B, S, Hkv)."""
    B, T, Hq, d = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    qg = q.unflatten(2, (Hkv, Hq // Hkv))
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(),
                          k_q.to(q.dtype).float())
    ks = k_s.transpose(1, 2)[:, :, None, None, :]
    logits = logits * ks * (d ** -0.5)
    logits = logits.masked_fill(~_visible_mask(q_pos0, T, S, q.device), -torch.inf)
    w = torch.softmax(logits, dim=-1)
    vs = v_s.transpose(1, 2)[:, :, None, None, :]
    w = (w * vs).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", w.float(),
                       v_q.to(q.dtype).float()).to(q.dtype)
    return out.reshape(B, T, Hq * d)


def _layer(cfg: Qwen2DecoderConfig, x: torch.Tensor, layers: Params, li: int,
           cache, cos: torch.Tensor, sin: torch.Tensor, pos0: int,
           pos_dev: torch.Tensor | None, block_only: bool,
           use_flash: bool) -> torch.Tensor:
    """One decoder block over x (B, T, D); writes this layer's K/V into the
    cache at positions pos0..pos0+T-1 in place."""
    B, T, _ = x.shape
    Hq, Hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, layers["ln1"]["w"][li], cfg.rms_norm_eps)

    if "qkv" in layers:
        nq, nkv = Hq * dh, Hkv * dh
        qkv = linear_at(h, layers["qkv"], li)
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q = linear_at(h, layers["q"], li)
        k = linear_at(h, layers["k"], li)
        v = linear_at(h, layers["v"], li)
    q = apply_rope(q.unflatten(-1, (Hq, dh)), cos, sin)
    k = apply_rope(k.unflatten(-1, (Hkv, dh)), cos, sin)
    v = v.unflatten(-1, (Hkv, dh))

    rows = slice(pos0, pos0 + T)
    quant = isinstance(cache, QuantKVCache)
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache.k_q[li, :, rows] = kq
        cache.k_s[li, :, rows] = ks
        cache.v_q[li, :, rows] = vq
        cache.v_s[li, :, rows] = vs
    else:
        cache.k[li, :, rows] = k.to(cache.k.dtype)
        cache.v[li, :, rows] = v.to(cache.v.dtype)

    scale = dh ** -0.5
    if block_only and use_flash:
        # causal GQA attention within the fresh block: the prefill kernel,
        # reading the heads by stride (no transposed copies)
        attn = attention_causal(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), sm_scale=scale)
        attn = attn.transpose(1, 2).reshape(B, T, Hq * dh)
    elif block_only:
        attn = _gqa_attention(q, k.to(x.dtype), v.to(x.dtype), 0)
    elif use_flash and T == 1:
        # one position over the cache: the decode kernel reads rows 0..pos0
        if quant:
            attn = flash_decode_quant(q[:, 0], cache.k_q[li], cache.k_s[li],
                                      cache.v_q[li], cache.v_s[li], pos_dev,
                                      sm_scale=scale)
        else:
            attn = flash_decode(q[:, 0], cache.k[li], cache.v[li], pos_dev,
                                sm_scale=scale)
        attn = attn.reshape(B, 1, Hq * dh).to(x.dtype)
    elif quant:
        attn = _gqa_attention_quant(q, cache.k_q[li], cache.k_s[li],
                                    cache.v_q[li], cache.v_s[li], pos0)
    else:
        attn = _gqa_attention(q, cache.k[li], cache.v[li], pos0)
    x = x + linear_at(attn, layers["o"], li)

    h = rms_norm(x, layers["ln2"]["w"][li], cfg.rms_norm_eps)
    if "gate_up" in layers:
        # the one-launch SwiGLU where the weight form and M allow it
        y = fused_mlp_at(h, layers["gate_up"], layers["down"], li)
        if y is None:
            gu = linear_at(h, layers["gate_up"], li)
            inter = cfg.intermediate_size
            gated = F.silu(gu[..., :inter]) * gu[..., inter:]
    else:
        y = fused_mlp_split_at(h, layers["gate"], layers["up"], layers["down"], li)
        if y is None:
            gated = F.silu(linear_at(h, layers["gate"], li)) \
                * linear_at(h, layers["up"], li)
    if y is None:
        y = linear_at(gated, layers["down"], li)
    return x + y


@torch.no_grad()
def decoder_forward(params: Params, cfg: Qwen2DecoderConfig,
                    inputs_embeds: torch.Tensor, cache, pos0: int,
                    block_only: bool = False, logits_last_only: bool = False,
                    use_flash: bool = True):
    """Run T positions (absolute positions pos0..pos0+T-1) through all
    layers; returns (logits (B, T, V) float32, cache), the cache updated in
    place and its ``pos`` set to pos0 + T.

    ``block_only``: nothing precedes pos0 in the cache (a fresh prefill), so
    attention runs within the block (T x T) through the causal prefill
    kernel. Otherwise T == 1 steps go through the decode kernel. Both
    wrappers run their plain versions for CPU tensors; ``use_flash=False``
    takes the plain einsum attention on any device. ``logits_last_only``
    skips the lm_head for all but the last position."""
    x = inputs_embeds
    T = x.shape[1]
    pos0 = int(pos0)
    if pos0 + T > cache.max_ctx:
        raise ValueError(f"decoder_forward: positions {pos0}..{pos0 + T - 1} "
                         f"past the cache capacity {cache.max_ctx}")
    positions = torch.arange(pos0, pos0 + T, device=x.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    pos_dev = None
    if use_flash and not block_only and T == 1:
        pos_dev = torch.full((x.shape[0],), pos0, dtype=torch.int32, device=x.device)
    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        x = _layer(cfg, x, layers, li, cache, cos, sin, pos0, pos_dev,
                   block_only, use_flash)
    if logits_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["ln_f"]["w"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = linear(x, params["lm_head"])
    cache.pos = pos0 + T
    return logits.float(), cache


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


class Decoder(nn.Module):
    """The decoder as a module: holds the (fused) parameter tree as buffers
    and runs ``decoder_forward``."""

    def __init__(self, params: Params, cfg: Qwen2DecoderConfig):
        super().__init__()
        self.weights = _Tree(fuse_decoder_params(params))
        self.cfg = cfg

    @property
    def params(self) -> Params:
        return self.weights.tree()

    @property
    def device(self) -> torch.device:
        return self.weights.embed.device

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.params, tokens)

    def forward(self, inputs_embeds: torch.Tensor, cache, pos0: int,
                block_only: bool = False, logits_last_only: bool = False,
                use_flash: bool = True):
        return decoder_forward(self.params, self.cfg, inputs_embeds, cache, pos0,
                               block_only=block_only,
                               logits_last_only=logits_last_only,
                               use_flash=use_flash)


# --------------------------------------------------------------------------- #
# parameter construction
# --------------------------------------------------------------------------- #

def _normal(rng, shape, dtype, scale, device):
    """scale * N(0, 1) of ``shape`` in ``dtype``. A numpy Generator draws
    float32 on the host exactly as the JAX package's random_decoder_params
    does (same seed, same weights); a torch.Generator draws on its own
    device, one slice of the leading axis at a time so that a stacked leaf
    never needs a float32 copy of itself."""
    if isinstance(rng, np.random.Generator):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=rng.device)
    for row in out.view(-1, *shape[-2:]) if len(shape) > 2 else (out,):
        row.copy_(torch.randn(row.shape, generator=rng, device=rng.device).mul_(scale))
    return out


def random_decoder_params(rng, cfg: Qwen2DecoderConfig,
                          dtype: torch.dtype = torch.float32,
                          scale: float = 0.02,
                          device: torch.device | str = "cpu") -> Params:
    """Random weights, drawn in the JAX package's order. ``rng`` is a numpy
    Generator (host draws, the JAX package's numbers, placed on ``device``)
    or a torch.Generator (draws on the generator's device, for full-size
    models whose host copy would take minutes and tens of GB)."""
    if not isinstance(rng, np.random.Generator):
        device = rng.device
    D, I = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    L = cfg.num_hidden_layers

    def t(*shape):
        return _normal(rng, shape, dtype, scale, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {"ln1": {"w": ones(L, D)}}
    layers["q"] = {"w": t(L, D, Hq * dh), "b": t(L, Hq * dh)}
    layers["k"] = {"w": t(L, D, Hkv * dh), "b": t(L, Hkv * dh)}
    layers["v"] = {"w": t(L, D, Hkv * dh), "b": t(L, Hkv * dh)}
    layers["o"] = {"w": t(L, Hq * dh, D)}
    layers["ln2"] = {"w": ones(L, D)}
    layers["gate"] = {"w": t(L, D, I)}
    layers["up"] = {"w": t(L, D, I)}
    layers["down"] = {"w": t(L, I, D)}
    p = {"embed": t(cfg.vocab_size, D), "layers": layers, "ln_f": {"w": ones(D)}}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"w": t(D, cfg.vocab_size)}
    return p


def random_quant_linear(rng: torch.Generator, shape: tuple[int, ...], fmt: str = "q8_0",
                        scale: float = 0.02, b32: bool = False) -> dict:
    """A (..., K, N) linear as random ggml blocks on the generator's device:
    "q8_0" int8 values {"qs"}, or "q4_0" packed symmetric nibbles {"qs4"}
    (``b32``: the same bytes as int32 words {"qs4b"}, ``Q4Form(b32=True)``'s
    form), with float16 scales sized so that the dequantized weight has
    about ``scale`` standard deviation. Every byte value is a valid block
    content (int8 -128..127, or two nibbles), filled in place without a
    wider temporary; valid blocks, but no quantizer's output."""
    if fmt not in ("q8_0", "q4_0") or (b32 and fmt != "q4_0"):
        raise ValueError(f"random_quant_linear: fmt {fmt!r}{' b32' if b32 else ''}, want "
                         "q8_0 or q4_0 (b32: q4_0)")
    *lead, K, N = shape
    q = torch.empty(*lead, K if fmt == "q8_0" else K // 2, N, dtype=torch.uint8,
                    device=rng.device)
    q.random_(0, 256, generator=rng)
    # a uniform int8 has std 73.9, a uniform nibble - 8 std 4.61
    s_mean = scale / (73.9 if fmt == "q8_0" else 4.61)
    sc = torch.rand((*lead, K // 32, N), generator=rng, device=rng.device)
    scales = ((0.5 + sc) * s_mean).to(torch.float16)
    if fmt == "q8_0":
        return {"qs": q.view(torch.int8), "scales": scales}
    if b32:
        return {"qs4b": pack_b32(q), "scales": scales}
    return {"qs4": q, "scales": scales}


def random_quant_decoder_params(rng: torch.Generator, cfg: Qwen2DecoderConfig,
                                fmt: str = "q8_0",
                                dtype: torch.dtype = torch.bfloat16,
                                scale: float = 0.02, b32: bool = False) -> Params:
    """A decoder whose linears and lm_head are ``random_quant_linear`` blocks
    drawn on the generator's device: for full-size models, where quantizing
    dense weights with the host codecs would take minutes. Norms, biases and
    the embedding are dense ``dtype`` as in ``random_decoder_params``.
    ``b32`` packs q4_0's nibbles in int32 words: the same seed gives the
    same bytes as without it."""
    device = rng.device
    D, I = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    L = cfg.num_hidden_layers

    def qlinear(*shape):
        return random_quant_linear(rng, shape, fmt, scale, b32)

    def t(*shape):
        return _normal(rng, shape, dtype, scale, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {"ln1": {"w": ones(L, D)}}
    layers["q"] = {**qlinear(L, D, Hq * dh), "b": t(L, Hq * dh)}
    layers["k"] = {**qlinear(L, D, Hkv * dh), "b": t(L, Hkv * dh)}
    layers["v"] = {**qlinear(L, D, Hkv * dh), "b": t(L, Hkv * dh)}
    layers["o"] = qlinear(L, Hq * dh, D)
    layers["ln2"] = {"w": ones(L, D)}
    layers["gate"] = qlinear(L, D, I)
    layers["up"] = qlinear(L, D, I)
    layers["down"] = qlinear(L, I, D)
    p = {"embed": t(cfg.vocab_size, D), "layers": layers, "ln_f": {"w": ones(D)}}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = qlinear(D, cfg.vocab_size)
    return p


def decoder_params_from_hf_state_dict(sd: dict, cfg: Qwen2DecoderConfig,
                                      dtype: torch.dtype = torch.float32,
                                      prefix: str = "model.",
                                      lm_head_key: str = "lm_head.weight",
                                      device: torch.device | str = "cpu"
                                      ) -> Params:
    """Map HF Qwen2ForCausalLM (or the language_model inside Qwen2-Audio)
    state-dict names (numpy arrays or tensors) onto the stacked tree;
    linears transposed to [in, out]. No file I/O."""

    def g(name):
        return torch.as_tensor(np.asarray(sd[name], dtype=np.float32))

    def stack(fmt, transpose=False):
        arrs = [g(fmt.format(i=i)) for i in range(cfg.num_hidden_layers)]
        if transpose:
            arrs = [a.T for a in arrs]
        return torch.stack(arrs).to(device=device, dtype=dtype)

    def lin(name, bias=True):
        out = {"w": stack(prefix + f"layers.{{i}}.{name}.weight", True)}
        if bias:
            out["b"] = stack(prefix + f"layers.{{i}}.{name}.bias")
        return out

    layers = {
        "ln1": {"w": stack(prefix + "layers.{i}.input_layernorm.weight")},
        "q": lin("self_attn.q_proj"),
        "k": lin("self_attn.k_proj"),
        "v": lin("self_attn.v_proj"),
        "o": lin("self_attn.o_proj", bias=False),
        "ln2": {"w": stack(prefix + "layers.{i}.post_attention_layernorm.weight")},
        "gate": lin("mlp.gate_proj", bias=False),
        "up": lin("mlp.up_proj", bias=False),
        "down": lin("mlp.down_proj", bias=False),
    }
    p = {
        "embed": g(prefix + "embed_tokens.weight").to(device=device, dtype=dtype),
        "layers": layers,
        "ln_f": {"w": g(prefix + "norm.weight").to(device=device, dtype=dtype)},
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"w": g(lm_head_key).T.contiguous().to(device=device, dtype=dtype)}
    return p
