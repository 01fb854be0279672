"""Fused log-mel frames: the CUDA kernel csrc/mel.cu and its plain version.

Replaces the TPU kernel qwen2_audio_tpu/ops/mel_kernel.py::_mel_kernel.
One launch does framing + Hann window + 400-point real DFT + power + mel
filterbank + log10 for every content frame of a clip, without writing the
(frames x 400) frame matrix or the (frames x 201) power spectrum to device
memory. The function's least work at 30 s and 128 mels is bound by bytes
(3.56 MB of signal, filterbank and output, about 1.06 us at 3.35 TB/s); a
launch costs more than that, so the kernel aims at the launch floor: one
warp per frame, eight frames a CTA (376 CTAs at 3002 frames, 2.8 per SM),
a real FFT per frame (the 400 real samples packed as 200 complex ones, a
mixed-radix 8 x 5 x 5 FFT, one real-split pass; ``FFT_FLOPS_PER_FRAME``)
and a filterbank that reads only each mel's range of nonzero bins. It runs
float32 throughout, not TF32 or bf16 tensor cores, because the global
max - 8 clamp moves with any rounding of the loudest frame. Design notes are
in the CUDA source.

The host builds the kernel's tables (``fft_table``: the Hann window and the
twiddles, from float64 rounded once to float32; ``filter_ranges``: each mel's
range [lo, hi) of nonzero bins and the weights inside it, exact for any
filterbank). ``mel_frames_plain``, the CPU path and what the card is checked
against, keeps the dense form: the window folded into the (400, 201) cos/sin
bases, float32 matmuls.

``mel_frames`` launches the kernel for a CUDA tensor and runs
``mel_frames_plain`` for a CPU tensor. The global max - 8 clamp and the
(x + 4) / 4 normalisation need the max over all frames and stay outside the
kernel (audio/mel.py ``normalize``), on the same device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qwen2_audio_tpu_torch.audio.mel import (
    LogMelSpectrogram,
    _dft_matrices,
    hann_window,
    normalize,
    pad_signal,
)
from qwen2_audio_tpu_torch.config import WHISPER_HOP_LENGTH, WHISPER_N_FFT
from qwen2_audio_tpu_torch.ops import _build

MAX_MELS = 128
N_BINS = WHISPER_N_FFT // 2 + 1          # 201 real bins
N_HALF = WHISPER_N_FFT // 2              # 200 complex points of the packed frame

# fft_table's layout (float32): the window, W200^j for j < 200 and W400^k for
# k <= 200 as (re, im) pairs, padded to whole 16-byte words
TAB_WINDOW, TAB_TW200, TAB_TW400, TAB_LEN = 0, 400, 800, 1204

# float32 operations of csrc/mel.cu per frame, as the kernel does them: the
# window (400 multiplies); pass 1, 25 radix-8 DFTs (56 each) and 25 x 7
# twiddle products (6 each); pass 2, 40 radix-5 DFTs (44 each) and 40 x 4
# twiddle products; pass 3, 40 radix-5 DFTs; the real split and power, 16 per
# bin over 201 bins. The filterbank adds 2 per weight in the ranges.
FFT_FLOPS_PER_FRAME = (400 + 25 * 56 + 25 * 7 * 6 + 40 * (44 + 4 * 6) + 40 * 44
                       + N_BINS * 16)


@dataclasses.dataclass(frozen=True)
class MelTables:
    """Device-resident constants: the kernel's (``fft_tab``, ``ranges``,
    ``weights``) and the plain version's (``wcos``, ``wsin``, ``filt_t``)."""

    fft_tab: torch.Tensor  # (TAB_LEN,) float32, fft_table()
    ranges: torch.Tensor   # (n_mel, 4) int32: lo, hi, offset into weights, 0
    weights: torch.Tensor  # (max(1, sum of hi - lo),) float32 filterbank in the ranges
    wcos: torch.Tensor     # (400, 201) Hann window folded into the cos basis
    wsin: torch.Tensor     # (400, 201) ... and into the sin basis
    filt_t: torch.Tensor   # (201, n_mel) filterbank, transposed

    @property
    def n_mel(self) -> int:
        return self.filt_t.shape[1]


def fft_table() -> np.ndarray:
    """(TAB_LEN,) float32: the periodic Hann window, then W200^j =
    exp(-2 pi i j / 200) for j < 200 and W400^k for k <= 200 as (re, im),
    each computed in float64 and rounded once."""
    tab = np.zeros(TAB_LEN, np.float32)
    tab[TAB_WINDOW:TAB_WINDOW + WHISPER_N_FFT] = hann_window()
    for at, n, count in ((TAB_TW200, N_HALF, N_HALF), (TAB_TW400, WHISPER_N_FFT, N_BINS)):
        w = np.exp(-2j * np.pi * np.arange(count, dtype=np.float64) / n)
        tab[at:at + 2 * count:2] = w.real.astype(np.float32)
        tab[at + 1:at + 2 * count:2] = w.imag.astype(np.float32)
    return tab


def filter_ranges(filters: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each mel's range [lo, hi) from its first to past its last nonzero
    bin (an empty row has lo = hi = 0) and the weights inside the ranges,
    row after row: (n_mel, 4) int32 (lo, hi, offset, 0) and float32 weights
    (at least one, so that the tensor has an address). Exact for any
    filterbank: the products it drops are products with zero."""
    filters = np.asarray(filters, np.float32)
    if filters.ndim != 2 or filters.shape[1] != N_BINS:
        raise ValueError(f"filter_ranges: want (n_mel, {N_BINS}), got {filters.shape}")
    ranges = np.zeros((filters.shape[0], 4), np.int32)
    parts, off = [], 0
    for m, row in enumerate(filters):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        ranges[m, :3] = (lo, hi, off)
        parts.append(row[lo:hi])
        off += hi - lo
    weights = np.concatenate(parts + [np.zeros(0 if off else 1, np.float32)])
    return ranges, weights.astype(np.float32)


def mel_tables(filters: np.ndarray, device: torch.device | str) -> MelTables:
    window = hann_window()
    cos_m, sin_m = _dft_matrices()
    ranges, weights = filter_ranges(filters)
    t = lambda a, dt=np.float32: torch.as_tensor(np.ascontiguousarray(a, dt),  # noqa: E731
                                                 device=device)
    return MelTables(fft_tab=t(fft_table()), ranges=t(ranges, np.int32), weights=t(weights),
                     wcos=t(window[:, None] * cos_m),
                     wsin=t(window[:, None] * sin_m),
                     filt_t=t(np.asarray(filters, np.float32).T))


def mel_frames_plain(padded: torch.Tensor, tables: MelTables,
                     n_frames: int) -> torch.Tensor:
    """(n_frames, n_mel) log10(max(mel, 1e-10)), float32 matmuls."""
    frames = padded.unfold(0, WHISPER_N_FFT, WHISPER_HOP_LENGTH)[:n_frames]
    re = frames @ tables.wcos
    im = frames @ tables.wsin
    mel = (re * re + im * im) @ tables.filt_t
    return torch.log10(torch.clamp(mel, min=1e-10))


def mel_frames(padded: torch.Tensor, tables: MelTables,
               n_frames: int) -> torch.Tensor:
    """Log-mel of frames 0..n_frames-1 of the padded signal.

    Runs the CUDA kernel for a CUDA tensor and the plain version for a CPU
    tensor. ``padded`` must hold (n_frames - 1) * 160 + 400 samples."""
    if padded.device.type == "cpu":
        return mel_frames_plain(padded, tables, n_frames)
    if padded.device.type != "cuda":
        raise ValueError(f"mel_frames: unsupported device {padded.device}")
    need = (n_frames - 1) * WHISPER_HOP_LENGTH + WHISPER_N_FFT
    if n_frames < 1 or padded.dim() != 1 or padded.numel() < need:
        raise ValueError(f"mel_frames: need a 1-D signal of >= {need} samples "
                         f"for {n_frames} frames, got {tuple(padded.shape)}")
    for name, x, dt in (("padded", padded, torch.float32),
                        ("fft_tab", tables.fft_tab, torch.float32),
                        ("ranges", tables.ranges, torch.int32),
                        ("weights", tables.weights, torch.float32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != padded.device \
                or x.data_ptr() % 16:
            raise ValueError(f"mel_frames: {name} must be contiguous, 16-byte aligned "
                             f"{dt} on {padded.device}")
    if tables.fft_tab.shape != (TAB_LEN,) or tables.ranges.shape != (tables.n_mel, 4) \
            or not 1 <= tables.n_mel <= MAX_MELS:
        raise ValueError(f"mel_frames: tables must be fft_table() and (n_mel <= {MAX_MELS}, "
                         "4) ranges")
    out = torch.empty((n_frames, tables.n_mel), dtype=torch.float32,
                      device=padded.device)
    lib = _build.library("mel")
    with torch.cuda.device(padded.device):
        rc = lib.qa_mel_log_frames(
            padded.data_ptr(), padded.numel(), tables.fft_tab.data_ptr(),
            tables.ranges.data_ptr(), tables.weights.data_ptr(), tables.weights.numel(),
            out.data_ptr(), n_frames, tables.n_mel, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mel_frames")
    mel_frames.launches += 1
    return out


mel_frames.launches = 0


def log_mel_spectrogram_fused(samples: np.ndarray, filters: np.ndarray,
                              device: torch.device | str = "cuda",
                              tables: MelTables | None = None
                              ) -> LogMelSpectrogram:
    """Same output and semantics as audio.mel.log_mel_spectrogram, with the
    content frames computed by ``mel_frames`` on ``device``."""
    padded, n_len, n_len_org, n_content = pad_signal(samples)
    if tables is None:
        tables = mel_tables(filters, device)
    x = torch.from_numpy(padded).to(tables.wcos.device)
    content = mel_frames(x, tables, n_content)
    return LogMelSpectrogram(data=normalize(content, n_len), n_len_org=n_len_org)
