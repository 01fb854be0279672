"""Where the device-layout parameter cache lives (io/param_cache.py).

Bringing a large quantized model up is host work: ggml-block quantization
and the checkpoint -> kernel layout conversion, minutes for 7B. Both are
deterministic functions of the source weights, so their output is cached
on disk, by default under ``~/.cache/qwen2_audio_tpu_torch/param_cache``,
which survives a wipe of the temporary directory. The root is an argument;
nothing is read from the environment. Entries found in older cache
directories can be seeded into it (linked, or copied where linking fails).
"""

from __future__ import annotations

import os
import shutil
import tempfile

DEFAULT_ROOT = os.path.join("~", ".cache", "qwen2_audio_tpu_torch")


def _ensure_dir(path: str, fallback: str) -> str:
    """``path`` made and checked writable, else ``fallback`` made."""
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".w")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return path
    except OSError:
        os.makedirs(fallback, exist_ok=True)
        return fallback


def _seed(dst: str, *srcs: str) -> None:
    """Copy into ``dst`` the cache entries of ``srcs`` it lacks (a hard link
    where possible)."""
    for src in srcs:
        if not os.path.isdir(src) or os.path.realpath(src) == os.path.realpath(dst):
            continue
        try:
            for name in os.listdir(src):
                s, d = os.path.join(src, name), os.path.join(dst, name)
                if os.path.exists(d) or not os.path.isfile(s):
                    continue
                try:
                    os.link(s, d)
                except OSError:
                    shutil.copy2(s, d)
        except OSError:
            pass


def param_cache_dir(root: str | None = None, seed_from: tuple[str, ...] = ()) -> str:
    """The parameter cache directory ``<root>/param_cache`` (``root``
    default ``DEFAULT_ROOT``), made if missing; where it cannot be written,
    ``qwen2_audio_tpu_torch_param_cache`` under the temporary directory.
    Entries of the directories ``seed_from`` that it lacks are copied in."""
    root = os.path.expanduser(DEFAULT_ROOT if root is None else root)
    path = _ensure_dir(os.path.join(root, "param_cache"),
                       os.path.join(tempfile.gettempdir(), "qwen2_audio_tpu_torch_param_cache"))
    _seed(path, *seed_from)
    return path
