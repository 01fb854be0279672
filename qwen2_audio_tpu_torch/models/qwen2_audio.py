"""Qwen2-Audio multimodal assembly: encoder tower + projector + Qwen2 LM,
in HF Qwen2AudioForConditionalGeneration's layout:

    audio_tower            -> models/encoder.py
    multi_modal_projector  -> Linear(enc_state -> hidden), bias
    language_model         -> models/qwen2_decoder.py
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import Qwen2AudioConfig, Qwen2DecoderConfig
from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
from qwen2_audio_tpu_torch.models.qwen2_decoder import (
    Decoder,
    decoder_params_from_hf_state_dict,
    random_decoder_params,
    random_quant_decoder_params,
)
from qwen2_audio_tpu_torch.runtime.decoding import DecoderBundle


def bundle_from_hf_state_dict(
    sd: dict,
    cfg: Qwen2DecoderConfig,
    *,
    eos_token_id: int,
    bos_tokens: list[int] | None = None,
    post_audio_tokens: list[int] | None = None,
    detokenize: Callable[[list[int]], str] | None = None,
    dtype: torch.dtype = torch.float32,
    max_ctx: int = 2048,
    cache_dtype=torch.bfloat16,
    device: torch.device | str = "cpu",
    fuse: bool = True,
) -> DecoderBundle:
    """The decode-side bundle from a HF Qwen2-Audio state dict of arrays or
    tensors (keys multi_modal_projector.linear.*, language_model.model.*,
    language_model.lm_head.weight), the decoder's projections fused unless
    ``fuse`` is False. No file I/O."""
    dec = decoder_params_from_hf_state_dict(
        sd, cfg, dtype=dtype, prefix="language_model.model.",
        lm_head_key="language_model.lm_head.weight", device=device)

    def arr(name):
        a = sd[name]
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32))

    return DecoderBundle(
        cfg=cfg,
        decoder=Decoder(dec, cfg, fuse=fuse),
        proj_w=arr("multi_modal_projector.linear.weight").T.contiguous().to(device, dtype),
        proj_b=arr("multi_modal_projector.linear.bias").to(device, dtype),
        eos_token_id=eos_token_id,
        bos_tokens=bos_tokens or [],
        post_audio_tokens=post_audio_tokens or [],
        detokenize=detokenize,
        max_ctx=max_ctx,
        cache_dtype=cache_dtype,
    )


def random_bundle(rng, cfg: Qwen2DecoderConfig, enc_state: int, *,
                  eos_token_id: int | None = None,
                  dtype: torch.dtype = torch.float32, max_ctx: int = 256,
                  cache_dtype=torch.float32,
                  device: torch.device | str = "cpu",
                  quant: str | None = None, b32: bool = False,
                  fuse: bool = True) -> DecoderBundle:
    """Random weights. A numpy Generator draws what the JAX package's
    random_bundle draws from the same seed; a torch.Generator draws on its
    own device (random_decoder_params). ``quant`` ("q8_0", "q4_0" or "w8a8",
    with a torch.Generator) makes the linears and the lm_head random ggml
    blocks or per-channel int8 weights instead, q4_0 in int32 words with
    ``b32`` (random_quant_decoder_params). ``fuse=False`` keeps the
    projections unfused, the schema tensor-parallel serving needs."""
    if quant is not None:
        dec = random_quant_decoder_params(rng, cfg, quant, dtype=dtype, b32=b32)
    else:
        dec = random_decoder_params(rng, cfg, dtype=dtype, device=device)
    if isinstance(rng, np.random.Generator):
        proj_w = torch.as_tensor(
            rng.standard_normal((enc_state, cfg.hidden_size)) * 0.02).to(device, dtype)
    else:
        device = rng.device
        proj_w = (torch.randn((enc_state, cfg.hidden_size), generator=rng,
                              device=device) * 0.02).to(dtype)
    return DecoderBundle(
        cfg=cfg,
        decoder=Decoder(dec, cfg, fuse=fuse),
        proj_w=proj_w,
        proj_b=torch.zeros(cfg.hidden_size, dtype=dtype, device=device),
        eos_token_id=cfg.vocab_size - 1 if eos_token_id is None else eos_token_id,
        bos_tokens=[0],
        post_audio_tokens=[1],
        max_ctx=max_ctx,
        cache_dtype=cache_dtype,
    )


def random_qwen2_audio(rng: np.random.Generator, cfg: Qwen2AudioConfig,
                       dtype: torch.dtype = torch.float32
                       ) -> tuple[Any, DecoderBundle]:
    """(encoder_params, decoder_bundle) with random weights on the CPU."""
    enc = random_encoder_params(rng, cfg.audio, dtype=dtype)
    bundle = random_bundle(rng, cfg.text, cfg.audio.n_audio_state, dtype=dtype)
    return enc, bundle
