"""Training checkpoint and resume with ``torch.save``.

``save_train_state`` writes the whole TrainState (parameters, the
optimizer's moments and step counts, the step) under ``<dir>/step_%08d``,
one file per rank (``state_rank<r>.pt``: under a mesh each rank keeps its
own shard); ``restore_train_state`` reads the newest step (or a given one)
back into an initialized state with ``torch.load(weights_only=True)``.
``export_encoder_to_ggml`` writes the tuned encoder back as a ggml model
file, which the inference runtime and the ggml tooling read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from qwen2_audio_tpu_torch.training.step import TrainState, tree_map, leaves


def _rank_file(path: Path) -> Path:
    rank = dist.get_rank() if dist.is_initialized() else 0
    return path / f"state_rank{rank}.pt"


def save_train_state(ckpt_dir: str | Path, state: TrainState, step: int | None = None
                     ) -> Path:
    ckpt_dir = Path(ckpt_dir).resolve()
    step = int(state.step) if step is None else step
    path = ckpt_dir / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"params": tree_map(lambda t: t.detach().cpu(), state.params),
                "opt_state": state.opt_state.state_dict(), "step": int(state.step)},
               _rank_file(path))
    return path


def restore_train_state(ckpt_dir: str | Path, template: TrainState,
                        step: int | None = None) -> TrainState:
    """Restore into ``template`` (an initialized TrainState of the same
    structure, on the device wanted): its parameters are overwritten in
    place and its optimizer loads the saved state."""
    ckpt_dir = Path(ckpt_dir).resolve()
    if step is None:
        steps = sorted(p.name for p in ckpt_dir.glob("step_*"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        path = ckpt_dir / steps[-1]
    else:
        path = ckpt_dir / f"step_{step:08d}"
    saved = torch.load(_rank_file(path), map_location="cpu", weights_only=True)
    with torch.no_grad():
        for dst, src in zip(leaves(template.params), leaves(saved["params"]), strict=True):
            dst.copy_(src)
    template.opt_state.load_state_dict(saved["opt_state"])
    return TrainState(params=template.params, opt_state=template.opt_state,
                      step=saved["step"])


def export_encoder_to_ggml(path: str, train_state: TrainState, hp, filters: np.ndarray,
                           vocab: list[bytes], use_f16: bool = True) -> None:
    """The tuned encoder of a single-process state -> ggml-model.bin."""
    from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
    enc = tree_map(lambda t: t.detach().cpu(), train_state.params["encoder"])
    write_encoder_checkpoint(path, enc, hp, filters, vocab, use_f16=use_f16)
