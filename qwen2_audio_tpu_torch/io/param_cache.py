"""Device-layout parameter disk cache.

The output of host quantization and layout conversion, the tree of tensors
exactly as the kernels read it (int8 / uint8 / int32 values, float16 or
float32 scales, dense norms), is saved to one ``.npz`` per model, so that a
later process loads it instead of quantizing again. The layout is the JAX
package's: the tree's structure in the keys (path parts joined by a
separator no parameter name holds, list items as ``#i``), one array each,
written to a temporary name and renamed into place. bfloat16 leaves are
stored as their 16 bits in a 2-byte void type, as numpy saves the JAX
package's bfloat16, and viewed back on load, so no bfloat16 numpy type is
needed and either package reads the other's files. Leaves come back as CPU
tensors; numpy leaves are saved too.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

_SEP = "\x1f"   # key separator that cannot appear in param names


def _array(leaf) -> np.ndarray:
    """A tensor, array or number as numpy, bfloat16 as its bits in "V2"."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"param_cache: key {k!r} cannot be stored")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
        return out
    out[prefix.rstrip(_SEP)] = _array(tree)
    return out


def _insert(root: dict, parts: list[str], value) -> None:
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _listify(node):
    """{'#0': .., '#1': ..} dicts back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        return [_listify(node[f"#{i}"]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def save_pytree(path: str, tree: Any) -> None:
    """Save a nested dict / list of tensors or arrays to ``path`` (one
    ``.npz``, written under a temporary name and renamed into place)."""
    flat = _flatten(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """The tree ``save_pytree`` saved, every leaf a CPU tensor of its saved
    type (bfloat16 ones viewed back from their bits)."""
    root: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = np.array(z[key])
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # bfloat16 bits
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            _insert(root, key.split(_SEP), t)
    return _listify(root)


def cached_build(path: str, build_fn: Callable[[], Any]) -> Any:
    """The tree cached at ``path``, or ``build_fn()`` built and saved there."""
    if os.path.exists(path):
        return load_pytree(path)
    tree = build_fn()
    save_pytree(path, tree)
    return tree
