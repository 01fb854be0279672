"""Multi-process runtime glue: ``torch.distributed`` process groups.

Every process runs the same program; ``initialize`` joins them into one
world, and ``parallel.mesh`` lays a (dp, tp) ``DeviceMesh`` over it. A
single process needs none of this: ``initialize()`` is a no-op returning
False unless a world is configured, by arguments first, then by PyTorch's
own environment convention (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, as ``torchrun`` sets them).

The backend is the caller's choice; the default is NCCL where CUDA is
available and gloo otherwise, with no switch from one to the other. Two or
more ranks sharing one card need gloo: NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from qwen2_audio_tpu_torch.utils.logging import log_info

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout: datetime.timedelta | float = DEFAULT_TIMEOUT) -> bool:
    """Join the world. ``init_method`` is a URL such as
    ``tcp://localhost:29500``; without it ``MASTER_ADDR`` and ``MASTER_PORT``
    (``env://``). ``world_size`` and ``rank`` fall back to ``WORLD_SIZE``
    and ``RANK``. Returns True iff a world is joined; idempotent; a no-op
    returning False when nothing is configured. ``timeout`` (seconds or a
    timedelta) bounds every collective and the rendezvous."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"distributed.initialize: init_method {init_method!r}, world_size "
                         f"{world_size} and rank {rank} must all be given (or set "
                         "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend or default_backend(), init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)
    log_info("distributed: rank %d of %d, backend %s\n" % (dist.get_rank(),
                                                          dist.get_world_size(),
                                                          dist.get_backend()))
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(tp: int = 1, dp: int | None = None):
    """A (dp, tp) mesh over the whole world. ``dp`` defaults to every rank
    that ``tp`` leaves."""
    from qwen2_audio_tpu_torch.parallel.mesh import make_mesh
    n = world_size()
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} global devices")
    if dp is None:
        dp = n // tp
    return make_mesh(dp=dp, tp=tp)


def host_local_batch_to_global(batch, mesh):
    """Each rank's local batch -> one global ``DTensor`` sharded on axis 0
    over ``dp`` (replicated over ``tp``): the torch counterpart of
    ``jax.make_array_from_process_local_data``. Its ``.full_tensor()`` is
    the concatenation of every dp rank's batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = torch.as_tensor(batch).to(mesh.device_type)
    places = [Shard(0) if name == "dp" else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, places)


def process_allgather(x) -> np.ndarray:
    """Every process's small array, stacked: (P, ...) on every rank, P = 1
    when not distributed."""
    a = np.asarray(x)
    if not is_distributed():
        return a[None]
    t = torch.as_tensor(a)
    if dist.get_backend() == dist.Backend.NCCL:
        t = t.cuda()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()
