"""Autoregressive generation with the sampling, the embedding and the KV
cache on the device.

The JAX package has two decode loops: one ``lax.while_loop`` on the device
and a host loop in decoding.py that can stop on ``abort_callback``. Here one
host loop serves both: each step samples on the device, embeds the token and
runs one decoder forward; the host reads one flag per step (have all streams
stopped?), calls ``abort_callback`` if one is given, and reads the tokens
once at the end. Capturing the step in a CUDA graph is later work
(ROADMAP.md, section 1, item 8).

``generate_on_device`` returns what the JAX function returns: tokens padded
with EOS past each stream's stop, their log-probabilities, the number of
steps taken (``T0 + count < cache_max_ctx`` bounds it), the distribution
the last token was sampled from, and the first distribution. The JAX loop
runs one more decoder forward after its last step, whose output nothing
reads; this loop stops before it, so it runs ``count - 1`` decode forwards.
Speculative decoding (``spec_k > 0``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache, decoder_forward
from qwen2_audio_tpu_torch.runtime.sampling import sample_token
from qwen2_audio_tpu_torch.utils.timings import time_us


@dataclasses.dataclass
class GenerationResult:
    tokens: list[list[int]]              # per batch element
    logprobs: list[list[float]]
    avg_logprob: list[float]
    # raw logits of the last decoded position (B, V) — whisper_get_logits
    final_logits: np.ndarray | None = None
    # raw logits of the first decode step (B, V) — the no-speech probability
    first_logits: np.ndarray | None = None
    # single-position decoder forwards the loop ran (the prefill excluded)
    n_decode_forwards: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate_on_device(params, cfg, prefill: torch.Tensor,
                       suppress_mask: torch.Tensor | None = None,
                       suppress_first: torch.Tensor | None = None, *,
                       max_new_tokens: int, eos_token_id: int,
                       cache_max_ctx: int, cache_dtype=torch.bfloat16,
                       temperature: float = 0.0, repetition_penalty: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                       abort_callback: Callable | None = None, timings=None):
    """prefill (B, T0, D) embeddings on the decoder's device. Returns
    (tokens (B, max_new) int32, logprobs (B, max_new) float32, count,
    final_logits (B, V), first_logits (B, V)), tensors on the device.

    ``abort_callback`` (optional) is called after every step that did not
    stop every stream; a true result ends the loop there. ``timings``
    (optional) receives the prefill time (t_prompt_us, n_prompt) and the
    decode loop's (t_decode_us), each ended by a device synchronisation."""
    B, T0, _ = prefill.shape
    dev = prefill.device
    t0 = time_us()
    cache = create_cache(cfg, B, cache_max_ctx, dtype=cache_dtype, device=dev)
    logits, cache = decoder_forward(params, cfg, prefill, cache, 0,
                                    block_only=True, logits_last_only=True)
    first_logits = logits[:, -1]
    if timings is not None:
        _sync(dev)
        timings.t_prompt_us += time_us() - t0
        timings.n_prompt += T0

    t1 = time_us()
    tokens = torch.full((B, max_new_tokens), eos_token_id, dtype=torch.int32, device=dev)
    logprobs = torch.zeros((B, max_new_tokens), dtype=torch.float32, device=dev)
    seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev) \
        if repetition_penalty != 1.0 else None
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed) if temperature > 0 else None
    rows = torch.arange(B, device=dev)
    last = prev = first_logits
    count = 0
    while count < max_new_tokens and T0 + count < cache_max_ctx:
        lg = last if suppress_mask is None else last + suppress_mask[None, :]
        if count == 0 and suppress_first is not None:
            # FullParams.suppress_blank: a mask for the first step only
            lg = lg + suppress_first[None, :]
        tok, lp = sample_token(lg, seen, gen, temperature, repetition_penalty,
                               top_k, top_p)
        tok = torch.where(done, eos_token_id, tok)
        tokens[:, count] = tok.to(torch.int32)
        logprobs[:, count] = lp.masked_fill(done, 0.0)
        if seen is not None:
            seen[rows, tok] = True
        done |= tok == eos_token_id
        prev = last
        count += 1
        if bool(done.all()) or (abort_callback is not None and abort_callback()) \
                or count >= max_new_tokens or T0 + count >= cache_max_ctx:
            break
        x = params["embed"][tok][:, None, :]
        logits, cache = decoder_forward(params, cfg, x, cache, T0 + count - 1)
        last = logits[:, -1]
    if timings is not None:
        _sync(dev)
        timings.t_decode_us += time_us() - t1
    return tokens, logprobs, count, prev, first_logits


def greedy_decode_device(bundle, prefill: torch.Tensor, *, max_new_tokens: int,
                         temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                         repetition_penalty: float = 1.0, seed: int = 0,
                         suppress_mask=None, spec_k: int = 0,
                         suppress_first=None, abort_callback: Callable | None = None,
                         timings=None) -> GenerationResult:
    """DecoderBundle entry over ``generate_on_device``: tokens cut after each
    stream's first EOS, suppression masks given as (V,) arrays."""
    if spec_k > 0:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP.md, section 1, item 8)")
    B, T0, _ = prefill.shape
    if T0 >= bundle.max_ctx:
        raise ValueError(
            f"prefill length {T0} exceeds DecoderBundle.max_ctx "
            f"{bundle.max_ctx}; raise max_ctx when attaching the decoder")
    max_ctx = min(bundle.max_ctx, T0 + max_new_tokens)
    dev = prefill.device

    def on_dev(m):
        return None if m is None else torch.as_tensor(m, dtype=torch.float32, device=dev)

    tokens, logprobs, count, last_logits, first_logits = generate_on_device(
        bundle.params, bundle.cfg, prefill, on_dev(suppress_mask),
        on_dev(suppress_first), max_new_tokens=max_new_tokens,
        eos_token_id=bundle.eos_token_id, cache_max_ctx=max_ctx,
        cache_dtype=bundle.cache_dtype, temperature=temperature,
        repetition_penalty=repetition_penalty, top_k=top_k, top_p=top_p,
        seed=seed, abort_callback=abort_callback, timings=timings)
    tokens = tokens.cpu().numpy()
    logprobs = logprobs.cpu().numpy()
    out_t, out_l = [], []
    for b in range(B):
        row = tokens[b, :count].tolist()   # past count: EOS padding
        n = row.index(bundle.eos_token_id) + 1 if bundle.eos_token_id in row else len(row)
        out_t.append(row[:n])
        out_l.append(logprobs[b, :n].tolist())
    if timings is not None:
        timings.n_decode += sum(len(t) for t in out_t)
    # raw (pre-suppression) logits: whisper_get_logits returns model logits
    return GenerationResult(
        tokens=out_t, logprobs=out_l,
        avg_logprob=[float(np.mean(l)) if l else 0.0 for l in out_l],
        final_logits=last_logits.cpu().numpy(),
        first_logits=first_logits.cpu().numpy(),
        n_decode_forwards=max(count - 1, 0))
