"""Start a world of ranks in one host's processes, with a deadline.

``spawn_world(fn, world, backend, timeout, args)`` starts ``world``
processes with the ``spawn`` method (a fresh interpreter each, so it works
where CUDA is already initialized in the caller), joins them into one
world over ``tcp://localhost:<a free port>`` (parallel/distributed.py) and
runs ``fn(rank, world, *args)`` in each. It returns the ranks' results in
rank order. It raises where a rank raised (with that rank's traceback) and
where the deadline passes, killing every rank still running; every rank
destroys its process group on every exit.

``fn`` must be importable by name from a module that the children can
import (a module-level function), and its results picklable; they travel
back through a pipe, so keep them small (numpy arrays, numbers).
``torchrun --nproc-per-node N`` is the other way to start ranks: there
``distributed.initialize()`` reads the environment it sets.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, backend: str, port: int, timeout: float,
               args: tuple, out) -> None:
    from qwen2_audio_tpu_torch.parallel import distributed
    try:
        distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend=backend,
                               timeout=timeout)
        out.put((rank, True, fn(rank, world, *args)))
    except Exception:       # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def spawn_world(fn, world: int, backend: str = "gloo", timeout: float = 120.0,
                args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results by rank. ``timeout`` (seconds) bounds the whole run, the
    start-up included, and each collective."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, port, timeout, args, out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results: dict[int, tuple] = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_world: {world - len(results)} of {world} ranks "
                                   f"did not finish within {timeout:g} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:     # look for ranks that died without a result
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_world: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            results[rank] = (ok, val)
            if not ok:
                raise RuntimeError(f"spawn_world: rank {rank} failed:\n{val}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        out.close()
    return [results[r][1] for r in range(world)]
