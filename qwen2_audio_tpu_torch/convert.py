"""Parameter conversion from the JAX package's pytrees.

``encoder_params_from_jax`` and ``decoder_params_from_jax`` take a pytree of
the JAX package (dicts, lists and arrays; ``jax.tree.map(np.asarray, ...)``
on the JAX side, or the arrays themselves, which numpy reads) and return
the port's tree of CPU tensors with the same layout, values and types, so
both packages compute the same function on the same weights.
``quant_params_from_jax`` does the same for trees that hold ggml block dicts
and turns the storage forms the JAX package keeps for its TPU compiler into
the port's (quant/qparams.py). ``bundle_from_jax`` converts a JAX
DecoderBundle, field by field. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def encoder_params_from_jax(tree):
    """Map dicts and lists through and turn every array leaf into a CPU
    tensor with the same values and type."""
    if isinstance(tree, dict):
        return {k: encoder_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [encoder_params_from_jax(v) for v in tree]
    return _tensor(tree)


# the decoder's pytree is dicts of stacked arrays: the same map
decoder_params_from_jax = encoder_params_from_jax

_NOT_PORTED_LEAVES = ("qs8", "scale_n")
_VALUE_KEYS = ("qs", "qs4", "qs4b", "qs_p", "qs4_p")


def _quant_leaf(key: str, a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if key in ("qs", "qs_p"):             # int8, or int4 where JAX holds it
        return torch.from_numpy(a.astype(np.int8))
    if key in ("qs4", "qs4_p"):           # nibble bytes, stored int8 or uint8
        return torch.from_numpy(a.view(np.uint8))
    if key == "qs4b":                     # nibble words: the same bits as int32
        return torch.from_numpy(a.view(np.int32))
    if key in ("scales", "scales_p") and a.dtype == np.uint16:   # f16 bit patterns
        return torch.from_numpy(a.view(np.float16))
    return _tensor(a)


def quant_params_from_jax(tree):
    """``encoder_params_from_jax`` for trees with ggml block dicts (numpy or
    JAX leaves): "qs" becomes int8 (from int4 too), the nibble stream "qs4"
    uint8 (the JAX package may hold the same bytes as int8), uint16 scale
    bit patterns float16, the nibble words "qs4b" int32; values are
    unchanged, and the panel leaves "qs_p", "qs4_p" and "scales_p" convert
    like their strided namesakes. Dense leaves pass through. The per-channel
    form ("qs8", "scale_n") has no counterpart in the port and raises."""
    if isinstance(tree, dict):
        bad = [k for k in _NOT_PORTED_LEAVES if k in tree]
        if bad:
            raise NotImplementedError(
                f"weight form {sorted(tree)} is not ported yet (ROADMAP.md, section 1, "
                "item 7)")
        if any(k in tree for k in _VALUE_KEYS):
            return {k: _quant_leaf(k, v) for k, v in tree.items()}
        return {k: quant_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [quant_params_from_jax(v) for v in tree]
    return _tensor(tree)


def _dtype(d):
    """A JAX cache dtype (jnp.float32, jnp.bfloat16, "q8", jnp.int8) as the
    port's."""
    if isinstance(d, str):
        return d
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}[np.dtype(d).name]


def bundle_from_jax(jb):
    """A JAX DecoderBundle as the port's: config, decoder weights (dense or
    ggml block dicts) and projector converted, token ids, limits and
    callables carried over."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import Decoder
    from qwen2_audio_tpu_torch.runtime.decoding import DecoderBundle

    cfg = Qwen2DecoderConfig(**dataclasses.asdict(jb.cfg))
    return DecoderBundle(
        cfg=cfg,
        decoder=Decoder(quant_params_from_jax(jb.params), cfg),
        proj_w=_tensor(jb.proj_w),
        proj_b=_tensor(jb.proj_b),
        eos_token_id=int(jb.eos_token_id),
        bos_tokens=list(jb.bos_tokens),
        post_audio_tokens=list(jb.post_audio_tokens),
        detokenize=jb.detokenize,
        max_ctx=jb.max_ctx,
        cache_dtype=_dtype(jb.cache_dtype),
        token_strings=jb.token_strings,
        tokenize=jb.tokenize,
        token_bytes=jb.token_bytes,
    )
