"""HuggingFace Qwen2-Audio checkpoint loader (safetensors or torch bins),
from a local directory.

Reads the HF layout (config.json + model.safetensors[.index.json], or
pytorch_model*.bin) and builds

    - the encoder tree   (audio_tower.*            -> models/encoder.py)
    - the decoder bundle (language_model.* and
                          multi_modal_projector    -> runtime DecoderBundle)

Weight names follow transformers' Qwen2AudioForConditionalGeneration. The
``safetensors`` and ``transformers`` packages are imported only on the
paths that need them: a directory of ``.bin`` files loads without
``safetensors``, and ``transformers`` serves only the optional tokenizer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import GGMLType, Qwen2DecoderConfig, WhisperHParams


def _load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a HF model directory (sharded safetensors, single
    files, else ``pytorch_model*.bin``), as CPU tensors of their stored
    types."""
    path = Path(path)
    sd: dict[str, torch.Tensor] = {}
    index = path / "model.safetensors.index.json"
    singles = sorted(path.glob("*.safetensors"))
    if index.exists() or singles:
        from safetensors.torch import load_file
        if index.exists():
            with open(index) as f:
                files = [path / s for s in sorted(set(json.load(f)["weight_map"].values()))]
        else:
            files = singles
        for f in files:
            sd.update(load_file(str(f)))
        return sd
    bins = sorted(path.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no safetensors/bin weights in {path}")
    for b in bins:
        sd.update(torch.load(str(b), map_location="cpu", weights_only=True, mmap=True))
    return sd


def hparams_from_hf_config(cfg: dict) -> tuple[WhisperHParams, Qwen2DecoderConfig]:
    a = cfg.get("audio_config", cfg)
    t = cfg.get("text_config", cfg)
    hp = WhisperHParams(
        n_vocab=a.get("vocab_size", 51866),
        n_audio_ctx=a.get("max_source_positions", 1500),
        n_audio_state=a.get("d_model", 1280),
        n_audio_head=a.get("encoder_attention_heads", 20),
        n_audio_layer=a.get("encoder_layers", 32),
        n_mels=a.get("num_mel_bins", 128),
        ftype=1,
    )
    heads = t.get("num_attention_heads", 28)
    dec = Qwen2DecoderConfig(
        vocab_size=t.get("vocab_size", 156032),
        hidden_size=t.get("hidden_size", 3584),
        intermediate_size=t.get("intermediate_size", 18944),
        num_hidden_layers=t.get("num_hidden_layers", 28),
        num_attention_heads=heads,
        num_key_value_heads=t.get("num_key_value_heads", 4),
        head_dim=t.get("head_dim", t.get("hidden_size", 3584) // heads),
        max_position_embeddings=t.get("max_position_embeddings", 8192),
        rope_theta=t.get("rope_theta", 1_000_000.0),
        rms_norm_eps=t.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=cfg.get("tie_word_embeddings",
                                    t.get("tie_word_embeddings", False)),
        audio_token_id=cfg.get("audio_token_index", 151646),
    )
    return hp, dec


def _f32(a) -> torch.Tensor:
    """A state-dict entry (tensor or array) as a float32 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def encoder_params_from_hf_state_dict(sd: dict, hp: WhisperHParams,
                                      dtype: torch.dtype = torch.float32,
                                      prefix: str = "audio_tower.",
                                      device: torch.device | str = "cpu") -> dict:
    """The encoder tree (models/encoder.py) from the ``audio_tower.*``
    entries: linears transposed to [in, out], K without a bias."""
    def g(name, transpose=False):
        a = _f32(sd[prefix + name])
        return (a.T if transpose else a).contiguous().to(device=device, dtype=dtype)

    def lin(p, bias=True):
        d = {"w": g(p + ".weight", transpose=True)}
        if bias:
            d["b"] = g(p + ".bias")
        return d

    def ln(p):
        return {"w": g(p + ".weight"), "b": g(p + ".bias")}

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
    return {
        "conv1": {"w": g("conv1.weight"), "b": g("conv1.bias")},
        "conv2": {"w": g("conv2.weight"), "b": g("conv2.bias")},
        "pos": g("embed_positions.weight"),
        "layers": layers,
        "ln_post": ln("layer_norm"),
    }


def _device(device) -> torch.device:
    """``device``, or the card when it is None (raises without one)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("load_qwen2_audio: no CUDA device is available; "
                           "pass device='cpu' to load onto the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def load_qwen2_audio(path: str | Path, dtype: torch.dtype = torch.bfloat16,
                     cache_dtype=torch.bfloat16, max_ctx: int = 2048,
                     decoder_quant: str | None = None, fuse: bool | None = None,
                     panel: bool | None = None,
                     device: torch.device | str | None = None) -> dict[str, Any]:
    """Load a HF Qwen2-Audio checkpoint directory onto ``device`` (default:
    the card, which must exist; "cpu" on request).

    ``decoder_quant``: None keeps the LM's linears dense in ``dtype``;
    "q8_0" / "q4_0" quantize them to ggml blocks at load (the dequantizing
    kernels), "w8a8" to the per-channel int8 form (ops/linear.py's int8 x
    int8 product). Quantization runs on the host, from the ``dtype`` weights.

    ``fuse`` (default on): q/k/v -> qkv and gate/up -> gate_up
    (models/qwen2_decoder.py::fuse_decoder_params); False keeps the separate
    projections. ``panel``: re-store the ggml block leaves in contiguous
    column panels (panelize_decoder_params); None turns it on for packed
    q4_0, the decode-tuned storage that measured fastest on the card.

    Returns {"hparams", "decoder_config", "encoder_params", "bundle",
    "tokenizer"} (the tokenizer None unless the directory has one and
    ``transformers`` loads it)."""
    from qwen2_audio_tpu_torch.models.qwen2_audio import bundle_from_hf_state_dict
    from qwen2_audio_tpu_torch.models.qwen2_decoder import (Decoder, fuse_decoder_params,
                                                            panelize_decoder_params)
    from qwen2_audio_tpu_torch.quant.qparams import quantize_decoder_params
    from qwen2_audio_tpu_torch.tokenizer import token_surface_to_bytes

    if decoder_quant not in (None, "q8_0", "q4_0", "w8a8"):
        raise ValueError(f"decoder_quant {decoder_quant!r}: want None, 'q8_0', 'q4_0' "
                         "or 'w8a8'")
    dev = _device(device)
    path = Path(path)
    with open(path / "config.json") as f:
        cfg = json.load(f)
    hp, dec_cfg = hparams_from_hf_config(cfg)
    sd = _load_state_dict(path)

    enc = encoder_params_from_hf_state_dict(sd, hp, dtype=dtype, device=dev)

    detok = None
    eos = cfg.get("text_config", {}).get("eos_token_id", 151645)
    tokenizer = None
    if (path / "tokenizer.json").exists() or (path / "tokenizer_config.json").exists():
        try:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(str(path))
            detok = tokenizer.decode
            if tokenizer.eos_token_id is not None:
                eos = tokenizer.eos_token_id
        except Exception:
            tokenizer = None

    # built on the host, where quantization runs, then moved in one go
    bundle = bundle_from_hf_state_dict(sd, dec_cfg, eos_token_id=eos, detokenize=detok,
                                       dtype=dtype, max_ctx=max_ctx, cache_dtype=cache_dtype,
                                       fuse=False)
    del sd
    if tokenizer is not None:
        bundle.tokenize = lambda s: tokenizer.encode(s)
        # byte-level BPE surfaces ('Ġ(' for ' ('), decoded to real text
        # for the suppression matchers
        bundle.token_bytes = lambda i: token_surface_to_bytes(
            tokenizer.convert_ids_to_tokens(i) or "")
        bundle.token_strings = lambda i: bundle.token_bytes(i).decode("utf-8",
                                                                      errors="replace")

    params = bundle.params
    if decoder_quant == "w8a8":
        params = quantize_decoder_params(params, GGMLType.Q8_0, mode="fast")
    elif decoder_quant is not None:
        params = quantize_decoder_params(
            params, GGMLType.Q4_0 if decoder_quant == "q4_0" else GGMLType.Q8_0)
    if fuse is None or fuse:
        params = fuse_decoder_params(params)
    if panel is None:
        panel = decoder_quant == "q4_0" and any(
            "qs4" in v for v in params["layers"].values() if isinstance(v, dict))
    if panel:
        params = panelize_decoder_params(params)
    bundle.decoder = Decoder(params, dec_cfg, fuse=False)
    bundle.to(dev)
    return {"hparams": hp, "decoder_config": dec_cfg, "encoder_params": enc,
            "bundle": bundle, "tokenizer": tokenizer}
