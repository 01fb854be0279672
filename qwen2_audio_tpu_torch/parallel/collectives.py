"""Megatron's tensor-parallel collectives as autograd functions, so that one
forward serves decode under ``torch.no_grad`` and training under autograd:

    copy_to_tp       identity forward, all-reduce of the gradient backward
                     (before a column-parallel linear: q/k/v, gate/up, fc1,
                     the lm_head)
    reduce_from_tp   all-reduce forward, identity backward (after a
                     row-parallel linear: o, down, fc2)
    gather_last      all-gather along the last axis forward, this rank's
                     slice of the gradient backward (the column-split
                     lm_head's logits)

Each takes the process group of the ``tp`` axis; ``group=None`` means no
tensor parallelism and returns the input unchanged.

The gather is ``all_gather`` on every backend: PyTorch's table of backends
lists only broadcast and all-reduce for gloo over CUDA tensors, but gloo's
all-gather of CUDA tensors ran right on the H100 host (PyTorch 2.11,
2 and 4 ranks on one card, chip_smoke.py phase 4i).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, in_place: bool = False) -> torch.Tensor:
    """The sum over the group; in ``x`` itself where ``in_place`` and ``x``
    is contiguous, else in a copy."""
    out = x if in_place and x.is_contiguous() else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        r, w = group_rank(ctx.group), ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or not _grad(x):
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial ``x``. Without autograd the sum is
    taken in place where ``x`` is contiguous (a fresh product)."""
    if group is None:
        return x
    if _grad(x):
        return _ReduceFromTP.apply(x, group)
    return _all_reduce(x, group, in_place=True)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if _grad(x):
        return _GatherLast.apply(x, group)
    return _gather_last(x, group)
