"""Profiling helpers on top of torch.profiler.

The reference's tracing story is wall-clock phase counters plus the per-node
sched eval-callback. Here the phase counters live in utils/timings.py and
per-node inspection in utils/inspect_graph.py; this module adds the device
trace (CPU and CUDA activity as a Chrome trace, viewable in Perfetto or
chrome://tracing) and a count of a function's floating-point operations and
bytes, with the roofline of an H100 beside them.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
from pathlib import Path

# peaks of an H100 SXM (the PERF.md table): dense bf16 tensor-core rate and
# HBM3 rate
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture CPU and (where there is a card) CUDA activity: ``with
    trace(d): run_workload()`` writes ``d/trace.json``, a Chrome trace in
    which every kernel launched on the card is an event named by its
    function. ``log_dir`` defaults to ``qa_trace`` under the temporary
    directory. Yields the directory.

    On the H100 with torch 2.11 a session that follows earlier profiler
    sessions in the same process has lost its first kernel events: trace
    more than one call where a kernel must show."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "qa_trace")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()      # the trace starts from an idle device
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace (shows as a span in the timeline)."""
    from torch.profiler import record_function
    return record_function(name)


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once, counted: {'flops': ..., 'bytes
    accessed': ...}. Flops come from torch.utils.flop_counter.FlopCounterMode
    (matrix products, convolutions, attention); bytes are every dispatched
    op's input plus output bytes, views counting nothing. Neither count sees
    the port's hand-written kernels, which are launched through ctypes past
    PyTorch's dispatcher: a function that runs them on the card counts only
    the PyTorch ops around them."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                leaves, _ = tree_flatten((args, kwargs, out))
                self.total += sum(t.numel() * t.element_size() for t in leaves
                                  if isinstance(t, torch.Tensor))
            return out

    flops = FlopCounterMode(display=False)
    nbytes = _Bytes()
    with flops, nbytes:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.total)}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device in this process"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name()}, {limit or 'power limit not read'}"


def flops_summary(fn, *args, tflops_peak: float = H100_BF16_FLOPS / 1e12, **kwargs) -> str:
    """One-line roofline estimate of ``fn`` against an H100's peaks (989
    TFLOP/s bf16 dense, 3.35 TB/s), with the card this process sees."""
    c = cost_analysis(fn, *args, **kwargs)
    flops, bytes_ = c["flops"], c["bytes accessed"]
    t_compute = flops / (tflops_peak * 1e12)
    t_memory = bytes_ / H100_BYTES_PER_S
    bound = "compute" if t_compute > t_memory else "memory"
    return (f"flops={flops/1e9:.2f}G bytes={bytes_/1e6:.1f}M "
            f"t_compute={t_compute*1e3:.3f}ms t_memory={t_memory*1e3:.3f}ms "
            f"-> {bound}-bound (H100 peaks {tflops_peak:.0f} TFLOP/s, "
            f"{H100_BYTES_PER_S/1e12:.2f} TB/s; card: {_card()})")
