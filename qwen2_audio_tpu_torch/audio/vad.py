"""Voice activity detection + audio conditioning helpers.

Parity with the reference example commons: high_pass_filter and the simple
energy VAD (examples/common.cpp:750-820), numpy-vectorized instead of the
sample loop.
"""

from __future__ import annotations

import numpy as np


def high_pass_filter(samples: np.ndarray, cutoff: float,
                     sample_rate: float) -> np.ndarray:
    """One-pole RC high-pass, y[i] = a*(y[i-1] + x[i] - x[i-1]) with
    y[0] = x[0] (examples/common.cpp:754-766), as an IIR lfilter."""
    from scipy.signal import lfilter
    x = np.asarray(samples, dtype=np.float64)
    if x.size == 0:
        return np.asarray(samples, np.float32).copy()
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    # the reference applies alpha = dt/(rc+dt) directly in the recurrence
    # (common.cpp:753-758) — parity means using its coefficient, unusual as
    # the response is
    a = dt / (rc + dt)
    # H(z) = a (1 - z^-1) / (1 - a z^-1); initial state so y[0] == x[0]
    zi = np.array([x[0] - a * x[0]])
    y, _ = lfilter([a, -a], [1.0, -a], x, zi=zi)
    return y.astype(np.float32)


def vad_simple(pcm: np.ndarray, sample_rate: int, last_ms: int,
               vad_thold: float, freq_thold: float,
               verbose: bool = False) -> bool:
    """True when the trailing `last_ms` window is quiet relative to the
    whole clip — "speech has ended" (examples/common.cpp:770-820)."""
    pcm = np.asarray(pcm, dtype=np.float32).copy()
    n_samples = pcm.size
    n_samples_last = (sample_rate * last_ms) // 1000
    if n_samples_last >= n_samples:
        return False
    if freq_thold > 0:
        pcm = high_pass_filter(pcm, freq_thold, sample_rate)

    energy_all = np.abs(pcm).mean() if n_samples else 0.0
    energy_last = np.abs(pcm[-n_samples_last:]).mean()
    if verbose:
        print(f"vad: energy_all {energy_all:.6f} energy_last "
              f"{energy_last:.6f} thold {vad_thold}")
    return energy_last <= vad_thold * energy_all


def similarity(s0: str, s1: str) -> float:
    """Levenshtein similarity (examples/common.cpp:801 similarity()).

    Delegates to utils/text.py so there is exactly one implementation with
    the reference's byte semantics (the C++ walks utf-8 bytes; a
    chars-based variant diverges on non-ASCII text)."""
    from qwen2_audio_tpu_torch.utils.text import similarity as _sim
    return _sim(s0, s1)
