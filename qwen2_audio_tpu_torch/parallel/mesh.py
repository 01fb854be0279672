"""Device mesh and Megatron sharding rules over ``torch.distributed``.

Axes:
    dp   data parallel (batch)
    tp   tensor parallel (attention heads / MLP hidden / vocabulary)

A mesh is a ``DeviceMesh`` with dims ("dp", "tp") over the initialized
world (parallel/distributed.py). Every rank holds only its own shard of a
weight (``shard_params``), runs the single-device code on it, and the
collectives of parallel/collectives.py join the partial results:

    column-parallel (output axis split): q, k, v, gate, up, fc1, lm_head
    row-parallel (input axis split):     o, down, fc2
    replicated: norms, embeddings, convs, positional tables, the biases and
                per-channel scales of the row-parallel linears

The rules are stated on this package's leaf layouts (quant/qparams.py): a
dense ``w`` (K, N); ggml blocks ``qs`` (K, N) int8, ``qs4`` (K // 2, N),
``scales`` / ``mins`` (K // group, N); the per-channel w8a8 ``qs8`` (K, N)
and ``scale_n`` (N,); every decoder leaf with a leading (L,) axis. A spec
leaf is ``None`` (replicated) or a ``Split``: the axis cut into tp
contiguous parts, each of ``parts`` equal sections cut alike (the encoder's
fused q|k|v, whose thirds are split one by one so that a rank holds whole
heads of each). A row split of ggml blocks must fall on whole 32-row
groups. The word-packed q4_0 form ``qs4b`` has no rule here: the JAX
package's rules leave it replicated beside split scales, which its tensor
parallel decode refuses, so this package refuses it too.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from qwen2_audio_tpu_torch.ops.linear import w8a8_layout

BLOCK_ROWS = 32


class Split(NamedTuple):
    axis: int          # negative: counted from the last
    parts: int = 1     # equal sections of the axis, each split alike


COL, ROW, COL3 = Split(-1), Split(-2), Split(-1, 3)


def make_mesh(dp: int = 1, tp: int = 1):
    """A (dp, tp) ``DeviceMesh`` over ranks 0 .. dp * tp - 1 of the
    initialized world; every rank of the world must call it. Its device
    type is "cuda" where CUDA is available, else "cpu"."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {world}")
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized world "
                         "(parallel.distributed.initialize)")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cuda" if torch.cuda.is_available() else "cpu",
                      torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def mesh_shape(mesh) -> dict[str, int]:
    """{"dp": n, "tp": n}, as the JAX mesh's ``shape``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def tp_group(mesh):
    """The process group of this rank's ``tp`` axis."""
    return mesh.get_group("tp")


def dp_group(mesh):
    return mesh.get_group("dp")


def coords(mesh, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis size)."""
    return mesh.get_local_rank(axis), mesh_shape(mesh)[axis]


# --------------------------------------------------------------------------- #
# spec rules
# --------------------------------------------------------------------------- #

_COL_LEAVES = r"(w|qs|qs4|qs8|scales|mins|scale_n|b)"
_ROW_LEAVES = r"(w|qs|qs4|qs8|scales|mins)"


def _walk(tree, path: str, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}" if path else str(k), fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, f"{path}/{i}", fn) for i, v in enumerate(tree)]
    return fn(path, tree)


def _spec_by_rules(params: Any, rules: list[tuple[str, Split | None]]) -> Any:
    """Leaf-wise spec by path regex, the first match winning, replicated
    (None) by default. A ``qs4b`` leaf raises."""
    compiled = [(re.compile(p), s) for p, s in rules]

    def assign(path: str, leaf):
        if path.endswith("/qs4b"):
            raise ValueError(f"{path}: the word-packed q4_0 form (qs4b) has no tensor "
                             "parallel sharding (the JAX package's tensor parallel decode "
                             "refuses it too); load q4_0 as nibble bytes (qs4)")
        for pat, spec in compiled:
            if pat.search(path):
                return spec
        return None

    return _walk(params, "", assign)


def decoder_param_spec(params: dict) -> Any:
    """Specs of models/qwen2_decoder.py's stacked tree (dense, ggml blocks
    or w8a8): Megatron column / row splits; the fused "qkv" / "gate_up" and
    the panel forms have no rule (replicated, as in the JAX package; the
    tensor parallel decode refuses them)."""
    return _spec_by_rules(params, [
        (rf"^layers/(q|k|v|gate|up)/{_COL_LEAVES}$", COL),
        (rf"^layers/(o|down)/{_ROW_LEAVES}$", ROW),
        (r"^lm_head/(w|qs|qs4|qs8|scales|mins|scale_n)$", COL),
    ])


def encoder_param_spec(params: dict) -> Any:
    """Specs of models/encoder.py's list-of-layers tree; a fused "qkv" is
    split third by third."""
    return _spec_by_rules(params, [
        (rf"^layers/\d+/(q|k|v|fc1)/{_COL_LEAVES}$", COL),
        (rf"^layers/\d+/qkv/{_COL_LEAVES}$", COL3),
        (rf"^layers/\d+/(o|fc2)/{_ROW_LEAVES}$", ROW),
    ])


def kv_cache_spec() -> dict:
    """KV cache (L, B, S, Hkv, d): batch over dp, kv heads over tp."""
    val = (None, "dp", None, "tp", None)
    return {"k": val, "v": val}


def quant_kv_cache_spec() -> dict:
    """The int8 cache: values (L, B, S, Hkv, d) and scales (L, B, S, Hkv)
    share the dp / tp layout."""
    val, sc = (None, "dp", None, "tp", None), (None, "dp", None, "tp")
    return {"k_q": val, "k_s": sc, "v_q": val, "v_s": sc}


def local_cache(cfg, batch: int, max_ctx: int, mesh, dtype=torch.bfloat16,
                device: torch.device | str = "cpu"):
    """This rank's cache of a (batch, max_ctx) pool: batch / dp streams and
    Hkv / tp kv heads (the specs above), bf16 / float32 or the int8 cache
    (``dtype`` "q8")."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache
    from qwen2_audio_tpu_torch.parallel.tp import tp_local_cfg
    shape = mesh_shape(mesh)
    if batch % shape["dp"]:
        raise ValueError(f"dp={shape['dp']} does not divide the batch {batch}")
    return create_cache(tp_local_cfg(cfg, shape["tp"]), batch // shape["dp"], max_ctx,
                        dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# this rank's shard
# --------------------------------------------------------------------------- #

def _cut(leaf: torch.Tensor, spec: Split, rank: int, n: int, path: str) -> torch.Tensor:
    ax = spec.axis % leaf.dim()
    size = leaf.shape[ax]
    if size % (n * spec.parts):
        raise ValueError(f"{path}: axis {ax} of {tuple(leaf.shape)} does not split into "
                         f"{spec.parts} x {n} parts")
    sec = size // spec.parts
    w = sec // n
    pieces = [leaf.narrow(ax, p * sec + rank * w, w) for p in range(spec.parts)]
    return torch.cat(pieces, dim=ax) if len(pieces) > 1 else pieces[0]


def _check_row_blocks(entry: dict, spec: dict, n: int, path: str) -> None:
    """A row split of ggml blocks falls on whole 32-row groups."""
    if "scales" not in entry or spec.get("scales") != ROW:
        return
    K = entry["qs4"].shape[-2] * 2 if "qs4" in entry else entry["qs"].shape[-2]
    if K % n or (K // n) % BLOCK_ROWS:
        raise ValueError(f"{path}: a row split of K = {K} over tp={n} must fall on "
                         f"{BLOCK_ROWS}-row block boundaries (K / tp = {K / n:g})")


def local_shard(params: Any, spec: Any, rank: int, n: int,
                device: torch.device | str | None = None) -> Any:
    """Rank ``rank`` of ``n``'s shard of ``params`` under ``spec``: every
    split leaf a contiguous copy of its part, replicated leaves as they are
    (moved to ``device`` where one is given); w8a8 weights laid out K-major
    again (``ops.linear.w8a8_layout``)."""
    def go(tree, sp, path):
        if isinstance(tree, dict):
            _check_row_blocks(tree, sp, n, path)
            return {k: go(v, sp[k], f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [go(v, s, f"{path}/{i}") for i, (v, s) in enumerate(zip(tree, sp))]
        if not isinstance(tree, torch.Tensor):
            return tree
        out = tree if sp is None else _cut(tree, sp, rank, n, path)
        if device is not None:
            out = out.to(device)
        # a copy even where the part is contiguous: the full leaf can be freed
        return out if sp is None else out.clone(memory_format=torch.contiguous_format)

    return w8a8_layout(go(params, spec, ""))


def shard_params(params: Any, spec: Any, mesh, device: torch.device | str | None = None
                 ) -> Any:
    """This rank's ``tp`` shard of ``params`` (``local_shard`` at the mesh's
    coordinates): contiguous copies on ``device`` (default: each leaf's
    own)."""
    rank, n = coords(mesh, "tp")
    return local_shard(params, spec, rank, n, device)


def local_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dp slice of a global batch (axis 0)."""
    r, n = coords(mesh, "dp")
    if x.shape[0] % n:
        raise ValueError(f"dp={n} does not divide the batch {x.shape[0]}")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]
