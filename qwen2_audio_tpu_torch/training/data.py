"""Training data pipeline: wav + transcript pairs -> batched (mel, tokens,
loss_mask) with background prefetch.

The mel is the port's host path (audio/mel.py: ``log_mel_spectrogram_np``
and ``mel_input_window``), computed by worker threads while the training
step runs; ``use_native=True`` reads the wav and computes the mel with the
threaded C++ of the native host library (native.py, its own host
fallbacks where the library is not built). Batches come in a
deterministic order (a permutation from ``seed``) however the workers
interleave; a worker's load error is raised in the consumer, never hangs
it, and a consumer that stops early (``break``) stops the workers.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from qwen2_audio_tpu_torch.audio.mel import (LogMelSpectrogram, log_mel_spectrogram_np,
                                             mel_input_window)
from qwen2_audio_tpu_torch.audio.wav import read_wav
from qwen2_audio_tpu_torch.config import WhisperHParams


@dataclass
class Example:
    audio_path: str
    text: str


def discover_pairs(root: str | Path, transcript_ext: str = ".txt"
                   ) -> list[Example]:
    """Pair every .wav under root with its same-stem transcript file."""
    root = Path(root)
    out = []
    for wav in sorted(root.rglob("*.wav")):
        txt = wav.with_suffix(transcript_ext)
        if txt.exists():
            out.append(Example(str(wav), txt.read_text().strip()))
    return out


class AudioTextDataset:
    """Materializes (mel_window, token_ids) examples."""

    def __init__(self, examples: Sequence[Example], hp: WhisperHParams,
                 filters: np.ndarray, tokenize: Callable[[str], list[int]],
                 max_tokens: int = 128, use_native: bool = False) -> None:
        self.use_native = use_native
        self.examples = list(examples)
        self.hp = hp
        self.filters = np.ascontiguousarray(filters, np.float32)
        self.tokenize = tokenize
        self.max_tokens = max_tokens

    def __len__(self) -> int:
        return len(self.examples)

    def load(self, idx: int) -> tuple[np.ndarray, list[int]]:
        ex = self.examples[idx]
        if self.use_native:
            from qwen2_audio_tpu_torch import native
            samples, _rate = native.wav_read(ex.audio_path)
            data, n_len_org = native.log_mel(samples, self.filters)
            mel = LogMelSpectrogram(data=torch.from_numpy(data), n_len_org=n_len_org)
        else:
            samples, _ = read_wav(ex.audio_path)
            mel = log_mel_spectrogram_np(samples, self.filters)
        win = mel_input_window(mel, 0, self.hp.n_audio_ctx).numpy()
        toks = self.tokenize(ex.text)[: self.max_tokens]
        return win, toks


class PrefetchLoader:
    """Threaded batch producer: worker threads build batches into a bounded
    queue while the training step consumes (double buffering in host RAM)."""

    def __init__(self, dataset: AudioTextDataset, batch_size: int,
                 pad_token_id: int = 0, num_workers: int = 2,
                 prefetch: int = 2, seed: int = 0,
                 drop_last: bool = True) -> None:
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_token_id = pad_token_id
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last

    def _collate(self, items: list[tuple[np.ndarray, list[int]]]
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        mels = np.stack([m for m, _ in items])
        T = max(max(len(t) for _, t in items), 1)
        tokens = np.full((len(items), T), self.pad_token_id, np.int32)
        mask = np.zeros((len(items), T), np.float32)
        for i, (_, t) in enumerate(items):
            tokens[i, : len(t)] = t
            mask[i, : len(t)] = 1.0
        return mels, tokens, mask

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.random.default_rng(self.seed).permutation(len(self.ds))
        n_full = len(order) // self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        if not self.drop_last and len(order) % self.batch_size:
            batches.append(order[n_full * self.batch_size:])

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        cursor = {"i": 0}
        lock = threading.Lock()
        stop = threading.Event()
        SENTINEL = object()

        def put(item) -> bool:
            # bounded put that aborts when the consumer goes away (an early
            # `break` in the training loop closes the generator; a plain
            # q.put would block these workers forever)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set():
                    with lock:
                        i = cursor["i"]
                        cursor["i"] += 1
                    if i >= len(batches):
                        break
                    items = [self.ds.load(int(j)) for j in batches[i]]
                    if not put((i, self._collate(items))):
                        return
            except BaseException as e:      # surface load errors, never hang
                put(("error", e))
                return
            put(SENTINEL)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            finished = 0
            pending: dict[int, tuple] = {}
            next_i = 0
            while finished < self.num_workers:
                item = q.get()
                if item is SENTINEL:
                    finished += 1
                    continue
                i, batch = item
                if i == "error":
                    raise RuntimeError("PrefetchLoader worker failed") \
                        from batch
                pending[i] = batch
                while next_i in pending:  # preserve deterministic batch order
                    yield pending.pop(next_i)
                    next_i += 1
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        finally:
            stop.set()
            for t in threads:
                t.join()
