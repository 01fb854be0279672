"""Tensor-parallel decode through the hand-written kernels.

Each rank holds its Megatron shard of the decoder (``shard_decoder_for_tp``)
and runs this package's single-device functions on it with the ``tp``
group: ``decoder_forward``, ``prefill_slot``, ``decode_chunk_slots`` and
``decode_chunk_slots_spec`` at the per-shard config (``tp_local_cfg``), so
every kernel runs at its shard's shapes. Two all-reduces a layer (after
the row-parallel o and down projections) and one gather of the
column-split lm_head's logits join the ranks; slot state (positions,
logits, flags, draft history) stays replicated, identical on every rank,
and only the weights and the KV cache are sharded (kv heads over ``tp``).

The canonical unfused schema is required: the fused "qkv" / "gate_up"
concatenate q|k|v (gate|up) along the output axis, so a plain column split
would hand rank 0 a part of q only. The one-launch SwiGLU still runs
under TP through its split-schema entry (``ops.linear.fused_mlp_split_at``).
Panels and the word-packed q4_0 form are refused (parallel/mesh.py).

Under a TP group the pool's step runs eagerly (``capture=False``): gloo
collectives cannot be captured into a CUDA graph, and a step captured with
NCCL's waits for a host with two cards to be tested on.
"""

from __future__ import annotations

import dataclasses

from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
from qwen2_audio_tpu_torch.parallel.mesh import (decoder_param_spec, mesh_shape,
                                                 shard_params, tp_group)


def tp_local_cfg(cfg: Qwen2DecoderConfig, tp: int) -> Qwen2DecoderConfig:
    """The per-shard view of the config: head counts and the SwiGLU
    intermediate size divide by ``tp`` (column-parallel splits); hidden
    size, rope and norm hyperparameters are replicated quantities."""
    if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp \
            or cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide heads ({cfg.num_attention_heads}/"
            f"{cfg.num_key_value_heads}) and intermediate_size "
            f"({cfg.intermediate_size})")
    return dataclasses.replace(
        cfg,
        num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        intermediate_size=cfg.intermediate_size // tp)


# one-entry memo for shard_decoder_for_tp: serving re-shards the same tree
# at every _serve_pool call. Strong references keep the ids valid.
_SHARD_MEMO: dict = {}


def shard_decoder_for_tp(params, mesh, device=None):
    """This rank's Megatron shard of an unfused decoder tree (dense, ggml
    blocks or w8a8), on ``device`` (default: each leaf's own). Memoized on
    (params, mesh) identity, one entry."""
    key = (id(params), id(mesh))
    hit = _SHARD_MEMO.get(key)
    if hit is not None and hit[0] is params and hit[1] is mesh:
        return hit[2]
    if "qkv" in params["layers"] or "gate_up" in params["layers"]:
        raise ValueError(
            "TP requires the canonical unfused schema: the fused qkv/gate_up concat axes "
            "cannot be column-split; build the decoder with fuse=False")
    if any("qs_p" in v or "qs4_p" in v for v in params["layers"].values()
           if isinstance(v, dict)):
        raise ValueError("panelized layouts are single-device; panelize after sharding is "
                         "not supported")
    sharded = shard_params(params, decoder_param_spec(params), mesh, device)
    _SHARD_MEMO.clear()
    _SHARD_MEMO[key] = (params, mesh, sharded)
    return sharded


def clear_shard_memo() -> None:
    """Drop the memo's references, so that the full tree it keeps alive can
    be freed once a rank holds its shard."""
    _SHARD_MEMO.clear()


def _local(cfg, mesh):
    return tp_local_cfg(cfg, mesh_shape(mesh)["tp"]), tp_group(mesh)


def tp_decoder_forward(params, cfg: Qwen2DecoderConfig, mesh, inputs_embeds, cache, pos0, *,
                       block_only: bool = False, logits_last_only: bool = False,
                       use_flash: bool = True):
    """``decoder_forward`` over a TP mesh on this rank's shard: (logits (B,
    T, V) replicated, this rank's cache). ``pos0`` an int or per-stream
    (B,) positions; ``inputs_embeds`` and ``cache`` are this rank's (its dp
    slice of the batch; Hkv / tp kv heads, ``mesh.local_cache``)."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import decoder_forward
    lcfg, group = _local(cfg, mesh)
    return decoder_forward(params, lcfg, inputs_embeds, cache, pos0, block_only=block_only,
                           logits_last_only=logits_last_only, use_flash=use_flash,
                           tp_group=group)


def tp_prefill_slot(params, cfg: Qwen2DecoderConfig, mesh, cache, slot_pos, slot_logits,
                    slot_active, slot, prefill):
    """``generate.prefill_slot`` over a TP mesh: the stream's K/V block lands
    in this rank's kv heads; slot state replicated."""
    from qwen2_audio_tpu_torch.runtime.generate import prefill_slot
    lcfg, group = _local(cfg, mesh)
    return prefill_slot(params, lcfg, cache, slot_pos, slot_logits, slot_active, slot,
                        prefill, tp_group=group)


def tp_decode_chunk_slots(params, cfg: Qwen2DecoderConfig, mesh, cache, slot_pos,
                          slot_logits, slot_active, suppress_mask=None, *, chunk: int,
                          eos_token_id: int):
    """Plain chunk decode of the slot pool over a TP mesh (the step runs
    eagerly)."""
    from qwen2_audio_tpu_torch.runtime.generate import decode_chunk_slots
    lcfg, group = _local(cfg, mesh)
    return decode_chunk_slots(params, lcfg, cache, slot_pos, slot_logits, slot_active,
                              suppress_mask, chunk=chunk, eos_token_id=eos_token_id,
                              tp_group=group)


def tp_decode_chunk_slots_spec(params, cfg: Qwen2DecoderConfig, mesh, cache, slot_pos,
                               slot_logits, slot_active, slot_hist, slot_hlen,
                               suppress_mask=None, *, chunk: int, eos_token_id: int,
                               spec_k: int = 7, ngram: int = 2):
    """The batched speculative pool over a TP mesh: every rank runs the
    iterations on its shard, the loop's condition read from replicated
    state, so every rank runs the same number of them."""
    from qwen2_audio_tpu_torch.runtime.generate import decode_chunk_slots_spec
    lcfg, group = _local(cfg, mesh)
    return decode_chunk_slots_spec(params, lcfg, cache, slot_pos, slot_logits, slot_active,
                                   slot_hist, slot_hlen, suppress_mask, chunk=chunk,
                                   eos_token_id=eos_token_id, spec_k=spec_k, ngram=ngram,
                                   tp_group=group)

