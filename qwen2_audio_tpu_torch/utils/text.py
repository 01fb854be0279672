"""Text utilities from the reference's example commons.

similarity: Levenshtein-based string similarity in [0, 1]
(≙ examples/common.cpp:801-823 — 1 - edit_distance / max_len, byte
semantics). The row recurrence cur[j] = min(sub/del, cur[j-1] + 1) has a
serial insertion chain; it resolves exactly as a prefix-min of
(candidate[k] - k) + j, so each DP row is one vectorized pass.
"""

from __future__ import annotations

import numpy as np


def similarity(s0: str, s1: str) -> float:
    """1 - levenshtein(s0, s1) / max(len); 1.0 for two empty strings."""
    a = np.frombuffer(s0.encode("utf-8"), np.uint8)
    b = np.frombuffer(s1.encode("utf-8"), np.uint8)
    n0, n1 = len(a), len(b)
    if max(n0, n1) == 0:
        return 1.0
    if n1 == 0:
        return 1.0 - n0 / n0
    prev = np.arange(n1 + 1, dtype=np.int32)
    for i in range(1, n0 + 1):
        # substitution / deletion candidates, still row-parallel
        cand = np.minimum(prev[:-1] + (a[i - 1] != b), prev[1:] + 1)
        # insertion chain cur[j] = min(cand[j], cur[j-1] + 1), cur[0] = i:
        # exact solution is prefix-min of [i, cand[1]-1, ..., cand[j]-j] + j
        t = np.concatenate(([np.int32(i)],
                            cand - np.arange(1, n1 + 1, dtype=np.int32)))
        prev = np.minimum.accumulate(t) + np.arange(n1 + 1, dtype=np.int32)
    return 1.0 - float(prev[-1]) / float(max(n0, n1))
