"""CUDA graphs of the port's hot calls: the decode step (runtime/generate.py)
and the encoder forward (models/encoder.py), each captured once per key and
replayed.

A graph freezes what its call read on the host while it was captured: the
addresses, shapes and types of its weights, the Python numbers of its
arguments, and the process switches that pick a kernel or a path. A call
whose key differs gets a graph of its own: ``tree_key`` keys the weights,
``switches`` the process switches, and the caller adds its own arguments.

The kernel wrappers count a launch when Python calls them, which for a
captured call happens once, at capture, while the device runs the launch
at every replay. ``Graph`` records each counter's change during the
capture, takes it back (a capture launches nothing), and adds it again at
every replay, so the counters read as if every replay were an eager call.
The warm-up call before a capture, which loads the kernels' libraries and
takes their first-launch set-up out of the capture, is set-up and is not
counted either.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch

from qwen2_audio_tpu_torch.ops import launch_counters


def switches() -> tuple:
    """The process switches a captured call may have frozen: the group
    matmul mode, the one-launch SwiGLU, dq16 and the encoder attention's
    variants."""
    from qwen2_audio_tpu_torch.ops.fa_variants import attention_variants
    from qwen2_audio_tpu_torch.ops.linear import (dequant16, fused_mlp_enabled,
                                                  group_matmul_mode)
    return group_matmul_mode(), fused_mlp_enabled(), dequant16(), attention_variants()


def tree_key(tree) -> tuple:
    """The path, address, shape, strides and type of every tensor of a
    nested dict or list: a graph captured over one tree replays rightly on
    any tree with the same key, as it reads the same bytes."""
    out = []

    def walk(path: tuple, node) -> None:
        if isinstance(node, torch.Tensor):
            out.append((path, node.data_ptr(), tuple(node.shape), node.stride(), node.dtype))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (i,), v)

    walk((), tree)
    return tuple(out)


def _counts() -> dict[str, int]:
    return {name: w.launches for name, w in launch_counters().items()}


class Graph:
    """``fn`` (no arguments; it reads and writes tensors the caller keeps)
    warmed up once on a side stream, then captured on ``device``;
    ``output`` is what the capture returned, rewritten by every replay.
    ``generators``: the torch.Generators ``fn`` draws from, registered with
    the graph so that each replay draws the numbers the next eager call
    would. A capture that fails raises; nothing falls back to eager calls."""

    def __init__(self, fn: Callable, device: torch.device,
                 generators: tuple[torch.Generator, ...] = ()):
        t0 = time.perf_counter()
        counters = launch_counters()
        before = _counts()
        try:
            with torch.cuda.device(device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream().wait_stream(side)
                warm = _counts()
                self.graph = torch.cuda.CUDAGraph()
                for gen in generators:
                    if not hasattr(self.graph, "register_generator_state"):
                        raise RuntimeError(
                            "this PyTorch cannot register a torch.Generator with a CUDA "
                            "graph (CUDAGraph.register_generator_state), so a step that "
                            "samples at temperature > 0 cannot be captured")
                    self.graph.register_generator_state(gen)
                with torch.cuda.graph(self.graph):
                    self.output = fn()
                torch.cuda.synchronize()
            captured = _counts()
            self.launches = {k: captured[k] - warm[k] for k in captured
                             if captured[k] != warm[k]}
        finally:
            for name, w in counters.items():
                w.launches = before[name]
        self.device = device
        self.replays = 0
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def replay(self, times: int = 1) -> None:
        """Replay the graph ``times`` times on the current stream and add
        the capture's launches to the counters as many times."""
        with torch.cuda.device(self.device):
            for _ in range(times):
                self.graph.replay()
        counters = launch_counters()
        for name, n in self.launches.items():
            counters[name].launches += n * times
        self.replays += times


class GraphCache:
    """The last ``size`` graphs used, by key; the least recently used goes
    first."""

    def __init__(self, size: int):
        self.size = size
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make: Callable[[], Graph]) -> Graph:
        """The graph of ``key``, made by ``make()`` when there is none."""
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = make()
            while len(self._graphs) > self.size:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        return graph

    def values(self) -> list[Graph]:
        return list(self._graphs.values())

    def drop(self, pred: Callable[[Graph], bool]) -> None:
        """Drop every graph for which ``pred`` holds."""
        for key in [k for k, g in self._graphs.items() if pred(g)]:
            del self._graphs[key]

    def clear(self) -> None:
        self._graphs.clear()

    def __len__(self) -> int:
        return len(self._graphs)
