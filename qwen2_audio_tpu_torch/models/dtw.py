"""Token-level timestamps: median filter and DTW alignment over decoder
attention.

The JAX package's models/dtw.py in PyTorch, after the reference's
[EXPERIMENTAL] DTW scaffolding:
- alignment-head presets per model size (g_aheads, src/qwen2-whisper.cpp:372-401);
- the median filter (median_filter :4031-4068) and the z-normalised cost
  (:4131-4146), in torch on the attention's device;
- DTW and its backtrace (:4070-4110) in numpy on the host: the table is
  tokens x frames, small, and its recurrence runs cell by cell.
"""

from __future__ import annotations

import numpy as np
import torch

# alignment-head presets: model name -> list of (text_layer, head)
# (data table mirroring g_aheads; heads from openai/whisper)
ALIGNMENT_HEADS_PRESETS: dict[str, list[tuple[int, int]]] = {
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
              (22, 17), (23, 2), (23, 15)],
}


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median over a sliding window of odd ``width`` along the last axis,
    the ends padded with the edge values (the ggml custom op median_filter,
    src/qwen2-whisper.cpp:4031-4068)."""
    if width % 2 != 1:
        raise ValueError(f"median_filter: the width must be odd, got {width}")
    half = width // 2
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]).clamp(0, n - 1)
    return x[..., idx].median(dim=-1).values


def dtw_cost(attn: torch.Tensor) -> torch.Tensor:
    """(n_tokens, n_frames) alignment cost from attention weights: each
    token's row z-normalised (population deviation, as ``jnp.std``) and
    negated (reference :4131-4146)."""
    a = attn.float()
    mu = a.mean(dim=-1, keepdim=True)
    sd = a.std(dim=-1, keepdim=True, correction=0) + 1e-9
    return -(a - mu) / sd


def dtw_and_backtrace(cost: np.ndarray) -> np.ndarray:
    """Classic DTW over an (N, M) cost matrix; returns the alignment path
    as (2, L) [token_idx, frame_idx] (reference dtw_and_backtrace
    :4070-4110). Runs on the host in float64."""
    cost = np.asarray(cost, dtype=np.float64)
    N, M = cost.shape

    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)

    for n in range(1, N + 1):
        for m in range(1, M + 1):
            c0, c1, c2 = D[n - 1, m - 1], D[n - 1, m], D[n, m - 1]
            if c0 <= c1 and c0 <= c2:
                c, t = c0, 0
            elif c1 <= c0 and c1 <= c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            D[n, m] = cost[n - 1, m - 1] + c
            trace[n, m] = t

    path = []
    n, m = N, M
    while n > 0 and m > 0:
        path.append((n - 1, m - 1))
        t = trace[n, m]
        if t == 0:
            n, m = n - 1, m - 1
        elif t == 1:
            n = n - 1
        else:
            m = m - 1
    path.reverse()
    return np.asarray(path, dtype=np.int32).T


def token_timestamps_from_attention(
    attn,                       # (n_heads, n_tokens, n_frames), tensor or array
    n_frames_content: int,
    medfilt_width: int = 7,
    frames_per_second: float = 50.0,
) -> np.ndarray:
    """Per-token start times in seconds from attention scores: softmax over
    the content frames, median filter, mean over the heads and the cost on
    the scores' device; DTW on the host (the whisper DTW timestamp
    algorithm over this decoder's attention)."""
    a = torch.as_tensor(attn)[:, :, :n_frames_content].float()
    a = median_filter(torch.softmax(a, dim=-1), medfilt_width)
    cost = dtw_cost(a.mean(dim=0)).cpu().numpy()
    path = dtw_and_backtrace(cost)            # (2, L)

    n_tokens = a.shape[1]
    times = np.zeros(n_tokens, dtype=np.float64)
    seen = np.zeros(n_tokens, dtype=bool)
    for tok, frame in zip(path[0], path[1]):
        if not seen[tok]:
            times[tok] = frame / frames_per_second
            seen[tok] = True
    return times
