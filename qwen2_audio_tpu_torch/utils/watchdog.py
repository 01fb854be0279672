"""A deadline on device work: a hung kernel or device read must end the
process loudly instead of hanging it and whatever drives it.

``watchdog(seconds, label)`` arms a daemon thread that, unless cancelled
within ``seconds``, prints a diagnostic naming the CUDA device, calls
``on_timeout`` if given, and ends the process with ``os._exit(2)``.
``guarded`` is the context-manager form. The command line arms it around
the model upload and each file's ``full`` passes when its context runs on
the card, for ``DEADLINE_S`` seconds each.

The JAX package's other half, background kernel validation with marker
files (``kernel_marker``, ``ensure_kernel_validation``), is not ported: the
port's kernels have no validation markers, every kernel is held to its
plain version by the tests and by chip_smoke.py.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable

DEADLINE_S = 3600.0   # seconds the command line allows one guarded phase


def _device_name() -> str:
    try:
        import torch
        if torch.cuda.is_available():
            return f"the CUDA device ({torch.cuda.get_device_name()})"
    except Exception:   # noqa: BLE001 — the diagnostic must still print
        pass
    return "the CUDA device"


def watchdog(seconds: float, label: str = "cuda",
             on_timeout: Callable[[], None] | None = None) -> Callable[[], None]:
    """Arm a daemon-thread deadline: if not cancelled within ``seconds``,
    print a loud diagnostic (then ``on_timeout()`` if given) and
    ``os._exit(2)``. Returns a zero-cost cancel function."""
    cancelled = threading.Event()

    def _arm():
        if not cancelled.wait(seconds):
            print(f"[watchdog:{label}] {_device_name()} did not finish within "
                  f"{seconds:.0f}s — a kernel or a device read hangs; ending "
                  "the process", file=sys.stderr, flush=True)
            if on_timeout is not None:
                try:
                    on_timeout()
                except Exception:   # noqa: BLE001
                    pass
            os._exit(2)

    threading.Thread(target=_arm, name=f"watchdog:{label}", daemon=True).start()
    return cancelled.set


class guarded:
    """Context manager form: ``with guarded(300, "decode bench"): ...``"""

    def __init__(self, seconds: float, label: str = "cuda"):
        self.seconds, self.label = seconds, label

    def __enter__(self):
        self._cancel = watchdog(self.seconds, self.label)
        return self

    def __exit__(self, *exc):
        self._cancel()
        return False
