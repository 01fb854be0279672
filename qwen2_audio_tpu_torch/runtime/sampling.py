"""Token sampling: greedy, temperature with top-k/top-p, repetition penalty.

Parity targets: the reference's surviving sampling helpers
``gpt_sample_top_k_top_p`` / ``gpt_sample_top_k_top_p_repeat``
(examples/common.cpp:750-911) and the whisper_full_params decode knobs
(include/qwen2-whisper.h:359-437). Everything runs on the logits' device;
randomness comes from an explicit ``torch.Generator`` on that device, so a
temperature > 0 draw differs from the JAX package's PRNG while the greedy
(temperature 0) choice is the same.
"""

from __future__ import annotations

import torch


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor | None,
                             penalty: float) -> torch.Tensor:
    """HF-convention penalty on tokens already generated: positive logits
    divided, negative multiplied (≙ repeat_penalty in
    gpt_sample_top_k_top_p_repeat, examples/common.cpp:851-872)."""
    if penalty == 1.0 or seen_mask is None:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int, top_p: float
                       ) -> torch.Tensor:
    """Mask logits outside top-k / nucleus top-p (examples/common.cpp:764-820)."""
    V = logits.shape[-1]
    if 0 < top_k < V:
        kth = torch.sort(logits, dim=-1).values[..., V - top_k]
        logits = torch.where(logits < kth[..., None], -torch.inf, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative probability exceeds top_p
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_token(logits: torch.Tensor, seen_mask: torch.Tensor | None,
                 generator: torch.Generator | None,
                 temperature: float | torch.Tensor = 0.0,
                 repetition_penalty: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """logits (B, V) -> (token ids (B,) int64, their log-probabilities (B,)).
    temperature == 0 is the argmax (the first of equal maxima). A 0-dim
    tensor temperature (read on the device, never by the host, as in a
    captured decode step) always samples."""
    logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    logprobs = torch.log_softmax(logits, dim=-1)
    if isinstance(temperature, torch.Tensor):
        f = top_k_top_p_filter(logits / temperature.clamp(min=1e-6), top_k, top_p)
        tok = torch.multinomial(torch.softmax(f, dim=-1), 1, generator=generator)[:, 0]
    elif temperature > 0:
        f = top_k_top_p_filter(logits / max(temperature, 1e-6), top_k, top_p)
        tok = torch.multinomial(torch.softmax(f, dim=-1), 1,
                                generator=generator)[:, 0]
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok, torch.gather(logprobs, -1, tok[:, None])[:, 0]


def length_penalty_score(score: torch.Tensor | float, length: int | torch.Tensor,
                         penalty: float):
    """Beam score normalization: penalty < 0 -> simple length normalization;
    else the GNMT ((5+len)/6)^penalty rule (openai/whisper decoding.py,
    referenced from whisper_full_params :410). ``length`` may be a device
    tensor (a beam step's count), never read by the host."""
    length = length.clamp(min=1) if isinstance(length, torch.Tensor) else max(length, 1)
    if penalty < 0:
        return score / length
    return score / ((5.0 + length) / 6.0) ** penalty
