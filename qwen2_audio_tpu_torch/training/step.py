"""Training step of the multimodal model (fine-tuning the encoder, the
projector and the Qwen2 LM on audio -> text pairs), single-process or over
a (dp, tp) mesh.

Loss: next-token cross-entropy on the text region of

    [audio embeddings (A frames)] ++ [text tokens (T)]

with a per-token mask (prompt tokens can be masked out), the JAX package's
objective. Both towers run their plain attention (``use_flash=False``, as
in JAX: the hand-written kernels have no backward), autograd through
``encoder_forward`` and ``decoder_forward_grad``.

Under a mesh every rank holds its Megatron shard of both towers
(parallel/mesh.py) and its dp slice of the batch; the tensor-parallel
collectives carry the gradients (parallel/collectives.py), the gradients
are summed over ``dp``, and the loss is normalised by the mask count of the
whole global batch, so that it and the gradients equal the single-process
step's over that batch.

The optimizer is built by ``optimizer_factory(parameters)``; ``adamw``
gives ``torch.optim.AdamW`` at optax.adamw's defaults (weight decay 1e-4,
where torch's default is 1e-2).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from qwen2_audio_tpu_torch.config import Qwen2AudioConfig
from qwen2_audio_tpu_torch.models.encoder import encoder_forward, random_encoder_params
from qwen2_audio_tpu_torch.models.qwen2_decoder import (KVCache, decoder_forward_grad,
                                                        random_decoder_params)


class TrainState(NamedTuple):
    params: Any          # {"encoder", "proj_w", "proj_b", "decoder"}; this rank's shard
    opt_state: Any       # the torch.optim.Optimizer over the params' leaves
    step: int


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable:
    """An optimizer factory: ``torch.optim.AdamW`` with optax.adamw's
    defaults."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def random_params(rng, cfg: Qwen2AudioConfig, dtype=torch.float32) -> dict:
    """Random weights drawn in the JAX package's init_train_state order: a
    numpy Generator gives the JAX package's numbers (on the CPU), a
    torch.Generator draws on its device."""
    enc = random_encoder_params(rng, cfg.audio, dtype=dtype)
    E, D = cfg.audio.n_audio_state, cfg.text.hidden_size
    if isinstance(rng, np.random.Generator):
        proj_w = torch.as_tensor(rng.standard_normal((E, D)) * 0.02).to(dtype)
        device = torch.device("cpu")
    else:
        device = rng.device
        proj_w = (torch.randn((E, D), generator=rng, device=device) * 0.02).to(dtype)
    return {"encoder": enc, "proj_w": proj_w,
            "proj_b": torch.zeros(D, dtype=dtype, device=device),
            "decoder": random_decoder_params(rng, cfg.text, dtype=dtype, device=device)}


def shard_train_params(params: dict, mesh, device=None) -> dict:
    """This rank's tensor-parallel shard of the training tree: both towers
    by their Megatron specs, the projector replicated."""
    from qwen2_audio_tpu_torch.parallel.mesh import (decoder_param_spec,
                                                     encoder_param_spec, shard_params)
    spec = {"encoder": encoder_param_spec(params["encoder"]), "proj_w": None,
            "proj_b": None, "decoder": decoder_param_spec(params["decoder"])}
    return shard_params(params, spec, mesh, device)


def init_train_state(rng, cfg: Qwen2AudioConfig, optimizer_factory: Callable,
                     dtype=torch.float32, device=None, mesh=None) -> TrainState:
    """Random parameters (``random_params``; one numpy seed gives the JAX
    package's), on ``device`` (default: where they were drawn), this rank's
    shard under ``mesh``, with gradients on and the optimizer over them."""
    params = random_params(rng, cfg, dtype)
    if mesh is not None:
        params = shard_train_params(params, mesh, device)
    elif device is not None:
        params = tree_map(lambda t: t.to(device), params)
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    return TrainState(params=params, opt_state=optimizer_factory(leaves(params)), step=0)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def nll_sum(params: dict, cfg: Qwen2AudioConfig, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, tp_group=None) -> torch.Tensor:
    """sum(nll * loss_mask) over the batch, with autograd. ``tp_group``:
    ``params`` is this rank's tensor-parallel shard."""
    text = cfg.text
    if tp_group is not None:
        from qwen2_audio_tpu_torch.parallel.tp import tp_local_cfg
        text = tp_local_cfg(text, dist.get_world_size(tp_group))
    enc = encoder_forward(params["encoder"], mel, cfg.audio, tp_group=tp_group)   # (B, A, E)
    audio = enc @ params["proj_w"] + params["proj_b"]                           # (B, A, D)
    tok_embeds = params["decoder"]["embed"][tokens]                             # (B, T, D)
    embeds = torch.cat([audio.to(tok_embeds.dtype), tok_embeds], dim=1)
    B, S, _ = embeds.shape
    cache = KVCache.create(text, B, S, dtype=embeds.dtype, device=embeds.device)
    logits, _ = decoder_forward_grad(params["decoder"], text, embeds, cache, 0,
                                     block_only=True, use_flash=False, tp_group=tp_group)
    A, T = audio.shape[1], tokens.shape[1]
    # position A - 1 + j predicts token j (next-token objective over the text)
    pred = logits[:, A - 1:A - 1 + T]
    logp = torch.log_softmax(pred, dim=-1)
    nll = -logp.gather(-1, tokens[..., None].long())[..., 0]
    return (nll * loss_mask).sum()


def loss_fn(params: dict, cfg: Qwen2AudioConfig, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's objective: the masked mean next-token NLL."""
    return nll_sum(params, cfg, mel, tokens, loss_mask) / loss_mask.sum().clamp(min=1.0)


def make_train_step(cfg: Qwen2AudioConfig, optimizer_factory: Callable | None = None,
                    mesh=None):
    """Returns ``train_step(state, mel, tokens, loss_mask) -> (state,
    loss)``: one optimizer step over the batch, the parameters updated in
    place, the loss (a float) the JAX package's. The step's gradients stay
    in each leaf's ``.grad`` until the next step. ``optimizer_factory``
    builds the optimizer where the state has none (a restored state).

    Under ``mesh`` the batch given is this rank's dp slice
    (``parallel.mesh.local_batch``), the state this rank's shard; the loss
    returned is the global batch's, on every rank."""
    group = dp = None
    if mesh is not None:
        from qwen2_audio_tpu_torch.parallel.mesh import dp_group, tp_group
        group, dp = tp_group(mesh), dp_group(mesh)

    def train_step(state: TrainState, mel, tokens, loss_mask):
        opt = state.opt_state
        if opt is None:
            opt = optimizer_factory(leaves(state.params))
        opt.zero_grad(set_to_none=True)
        count = loss_mask.sum()
        if dp is not None:
            count = count.detach().clone()
            dist.all_reduce(count, group=dp)
        loss = nll_sum(state.params, cfg, mel, tokens, loss_mask, group) \
            / count.clamp(min=1.0)
        loss.backward()
        total = loss.detach().clone()
        if dp is not None:
            dist.all_reduce(total, group=dp)
            for p in leaves(state.params):
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=dp)
        opt.step()
        return TrainState(params=state.params, opt_state=opt, step=state.step + 1), \
            float(total)

    return train_step
