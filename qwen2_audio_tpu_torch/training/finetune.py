"""Fine-tune the multimodal model on a directory of wav + txt pairs and
export the tuned encoder back to a ggml checkpoint:

    python -m qwen2_audio_tpu_torch.training.finetune <corpus_dir> <out.bin> [epochs]

A tiny random-weight model (seed 0), on the card unless ``--device cpu``
is given; the counterpart of the JAX package's examples/finetune.py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("corpus")
    ap.add_argument("out")
    ap.add_argument("epochs", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from qwen2_audio_tpu_torch.audio import mel_filterbank
    from qwen2_audio_tpu_torch.config import (Qwen2AudioConfig, Qwen2DecoderConfig,
                                              WhisperHParams)
    from qwen2_audio_tpu_torch.training.checkpoint import export_encoder_to_ggml
    from qwen2_audio_tpu_torch.training.data import (AudioTextDataset, PrefetchLoader,
                                                     discover_pairs)
    from qwen2_audio_tpu_torch.training.step import adamw, init_train_state, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("finetune: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    hp = WhisperHParams(n_vocab=64, n_audio_ctx=64, n_audio_state=64,
                        n_audio_head=4, n_audio_layer=2, n_mels=16)
    cfg = Qwen2AudioConfig(
        audio=hp,
        text=Qwen2DecoderConfig(
            vocab_size=64, hidden_size=64, intermediate_size=128,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, tie_word_embeddings=True))

    pairs = discover_pairs(args.corpus)
    if not pairs:
        print(f"no wav+txt pairs under {args.corpus}", file=sys.stderr)
        return 1
    filters = mel_filterbank(hp.n_mels)
    ds = AudioTextDataset(pairs, hp, filters,
                          tokenize=lambda s: [ord(c) % 60 for c in s][:16])
    loader = PrefetchLoader(ds, batch_size=min(2, len(ds)), num_workers=2)

    opt = adamw(1e-3)
    state = init_train_state(np.random.default_rng(0), cfg, opt, device=device)
    step = make_train_step(cfg, opt)
    loss = float("nan")
    for epoch in range(args.epochs):
        for mel, toks, mask in loader:
            state, loss = step(state, torch.as_tensor(mel, device=device),
                               torch.as_tensor(toks, device=device).long(),
                               torch.as_tensor(mask, device=device))
        print(f"epoch {epoch}: loss {loss:.4f}")

    export_encoder_to_ggml(args.out, state, hp, filters, [b"x"] * 60)
    print(f"exported tuned encoder -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
