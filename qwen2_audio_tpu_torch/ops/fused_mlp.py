"""One-launch SwiGLU MLP over ggml block weights at decode M: the CUDA
kernel csrc/fused_mlp.cu and its plain version.

Replaces the TPU kernel ``_swiglu_kernel`` of qwen2_audio_tpu/ops/fused_mlp.py
behind its five entry points, each with the JAX entry's name and argument
order (leaves stacked on a leading (L,) axis, layer ``li`` read in place):

    fused_mlp_stacked        int8 values, fused gate|up columns   "strided"
    fused_mlp_m_stacked      the same with per-group mins         "strided_m"
    fused_mlp4_stacked       packed nibbles with mins             "packed_m"
    fused_mlp4_sym_stacked   packed nibbles, (q - 8) * d          "packed"
    fused_mlp_split_stacked  gate and up as two arrays, any of the four

What every entry computes, for x (M, K) with M <= 64:

    g = x @ deq(Wg), u = x @ deq(Wu)        float32 sums
    gated = g * sigmoid(g) * u              float32
    y = gated @ deq(Wd)                     float32 sums over all of I, in x's type

``fast`` rounds x and each dequantized weight once to bf16 before the
products (of q * d + m the sum is what is rounded) and ``gated`` to bf16
before the down product; otherwise every product is exact float32. The mins
are part of the weight here, not the separate ``group_min_term`` product of
the two-launch path, so with mins the two paths differ by rounding. Group
16 or 32 for int8 values and 32 for nibbles, the same for gate_up and down.

What the kernel keeps out of device memory is the (M, I) intermediate. On
the card each block owns a slice of I and the float32 partial (M, D) sums of
the slices are added in slice order by a second small kernel (one launch of
the wrapper), so a result repeats bit for bit; design notes in the CUDA
source. Each wrapper launches the kernel for CUDA tensors, runs
``fused_mlp_plain`` for CPU tensors, raises for anything else, and counts
its launches. The TPU blocking knobs (``block_i``, padding M to 8) have no
counterpart.
"""

from __future__ import annotations

import torch

from qwen2_audio_tpu_torch.ops import _build
from qwen2_audio_tpu_torch.ops.quant_matmul import GROUP, _layer, block_weight

MAX_M = 64
_TILE = 64                      # columns of I a block takes per pass
_SCRATCH_BYTES = 64 << 20       # most the partial sums may take
_X_TYPES = (torch.float32, torch.bfloat16)
_S_TYPES = (torch.float32, torch.float16)


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #

def _dequant(leaves: tuple, packed: bool) -> torch.Tensor:
    """(values, scales[, mins]) of one 2-D weight -> float32 (rows, cols):
    q * d, (q - 8) * d for nibbles without mins, q * d + m with mins, the
    product and the sum each rounded to float32."""
    q, sc, *mins = leaves
    w = block_weight(q, sc, packed=packed, off=8 if packed and not mins else 0)
    if mins:
        w = w + mins[0].float().repeat_interleave(w.shape[0] // mins[0].shape[0], dim=0)
    return w


def fused_mlp_plain(x: torch.Tensor, g: tuple, u: tuple, dn: tuple, *,
                    packed: bool = False, fast: bool = False) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu) @ Wd with the kernel's roundings; ``g``, ``u``
    and ``dn`` are (values, scales[, mins]) of 2-D leaves."""
    def rounded(t):
        return t.to(torch.bfloat16).float() if fast else t.float()

    xr = rounded(x)
    gg = xr @ rounded(_dequant(g, packed))
    uu = xr @ rounded(_dequant(u, packed))
    gated = rounded(gg * torch.sigmoid(gg) * uu)
    return (gated @ rounded(_dequant(dn, packed))).to(x.dtype)


def gated_rounding_bound(x: torch.Tensor, g: tuple, u: tuple, dn: tuple, *,
                         packed: bool = False) -> torch.Tensor:
    """How far one bf16 rounding of ``gated`` that falls the other way can
    move an output of row m in ``fast`` mode: 2^-8 * max_j |gated[m, j]| *
    max |Wd|, (M, 1) float32. Two implementations that add g and u in another
    order differ by a float32 ulp there, which now and then crosses a bf16
    rounding boundary; a comparison of two ``fast`` results allows for a few
    such flips beside the order of the sums."""
    xr = x.to(torch.bfloat16).float()
    gg = xr @ _dequant(g, packed).to(torch.bfloat16).float()
    uu = xr @ _dequant(u, packed).to(torch.bfloat16).float()
    gated = (gg * torch.sigmoid(gg) * uu).abs().amax(dim=1, keepdim=True)
    return 2.0 ** -8 * gated * _dequant(dn, packed).abs().max()


# --------------------------------------------------------------------------- #
# the kernel's wrapper
# --------------------------------------------------------------------------- #

def slice_width(M: int, I: int, D: int) -> int:
    """Columns of I per block: one 64-column tile while the float32 partial
    sums (slices, M, D) fit the scratch budget, more tiles per block for
    larger M."""
    tiles = -(-I // _TILE)
    most = max(1, _SCRATCH_BYTES // (M * D * 4))
    return -(-tiles // min(tiles, most)) * _TILE


def _check(name: str, x, g: tuple, u: tuple, dn: tuple, packed: bool) -> int:
    """Shapes and types every device takes; returns the group size."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    if M > MAX_M:
        raise ValueError(f"{name}: the fused MLP is decode-shaped (M <= {MAX_M}, got "
                         f"{M}); take the per-projection linear path for larger M")
    if not (len(g) == len(u) == len(dn)) or len(g) not in (2, 3):
        raise ValueError(f"{name}: gate, up and down each take (values, scales"
                         f"[, mins]), got {len(g)}, {len(u)}, {len(dn)} leaves")
    kdiv = 2 if packed else 1
    want = torch.uint8 if packed else torch.int8
    Kr, I = g[0].shape
    Ir, D = dn[0].shape
    if Kr * kdiv != K or Ir * kdiv != I or u[0].shape != g[0].shape or M < 1:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, gate {tuple(g[0].shape)}, "
                         f"up {tuple(u[0].shape)}, down {tuple(dn[0].shape)}")
    if g[1].shape[0] == 0 or K % g[1].shape[0]:
        raise ValueError(f"{name}: gate scales {tuple(g[1].shape)} for K={K}")
    group = K // g[1].shape[0]
    if group not in (16, 32) or (packed and group != GROUP):
        raise ValueError(f"{name}: scale group {group} (want 32, or 16 for int8 values)")
    for w, rows, cols in ((g, K, I), (u, K, I), (dn, I, D)):
        if w[0].dtype != want:
            raise ValueError(f"{name}: weight dtype {w[0].dtype}, want {want}")
        for leaf in w[1:]:
            if leaf.shape != (rows // group, cols):
                raise ValueError(f"{name}: a scales or mins leaf is {tuple(leaf.shape)}, "
                                 f"want {(rows // group, cols)} (group {group} for gate, "
                                 "up and down alike)")
    return group


def _launch(name: str, x, g: tuple, u: tuple, dn: tuple, group: int, packed: bool,
            fast: bool) -> torch.Tensor:
    M, K = x.shape
    I, D = g[0].shape[1], dn[0].shape[1]
    mins = len(g) == 3
    if x.dtype not in _X_TYPES:
        raise ValueError(f"{name}: the kernel takes x in {_X_TYPES}, got {x.dtype}")
    if K % 32 or I % 32 or D % 16:
        raise ValueError(f"{name}: the kernel takes K and I multiples of 32 and D a "
                         f"multiple of 16, got K={K}, I={I}, D={D}")
    x = x.contiguous()
    ld = g[0].stride(0)
    for w, rows_stride in ((g, ld), (u, ld), (dn, D)):
        if w[1].dtype not in _S_TYPES or (mins and w[2].dtype != torch.float32):
            raise ValueError(f"{name}: the kernel takes scales in {_S_TYPES} and float32 "
                             f"mins, got {[t.dtype for t in w[1:]]}")
        for t in w:
            if t.device != x.device or t.stride() != (rows_stride, 1) \
                    or t.data_ptr() % (4 * t.element_size()):
                raise ValueError(f"{name}: every leaf must lie on {x.device}, rows "
                                 f"{rows_stride} elements apart (gate and up alike), its "
                                 "columns contiguous and aligned to 4 elements")
    if g[1].dtype != u[1].dtype:
        raise ValueError(f"{name}: gate and up scales differ in type")
    bi = slice_width(M, I, D)
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    scratch = torch.empty((-(-I // bi), M, D), dtype=torch.float32, device=x.device)

    def ptrs(w):
        return [t.data_ptr() for t in w] + ([] if mins else [None])

    lib = _build.library("fused_mlp")
    with torch.cuda.device(x.device):
        rc = lib.qa_fused_mlp(
            x.data_ptr(), *ptrs(g), *ptrs(u), *ptrs(dn), out.data_ptr(), scratch.data_ptr(),
            M, K, I, D, ld, bi, group, int(x.dtype == torch.bfloat16),
            int(g[1].dtype == torch.float16), int(dn[1].dtype == torch.float16),
            int(packed), 8 if packed and not mins else 0, int(fast),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, name)
    return out


def _run(entry, x, g: tuple, u: tuple, dn: tuple, li: int, packed: bool,
         fast: bool) -> torch.Tensor:
    name = entry.__name__
    g, u, dn = (tuple(_layer(name, a, li) for a in w) for w in (g, u, dn))
    group = _check(name, x, g, u, dn, packed)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, g, u, dn, packed=packed, fast=fast)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch(name, x, g, u, dn, group, packed, fast)
    entry.launches += 1
    return out


def _halves(name: str, leaves: tuple) -> tuple[tuple, tuple]:
    """The gate and the up columns of fused (L, rows, 2 I) leaves, as views."""
    width = leaves[0].shape[-1]
    if width % 2 or any(a.shape[-1] != width for a in leaves):
        raise ValueError(f"{name}: fused gate|up leaves of widths "
                         f"{[a.shape[-1] for a in leaves]}")
    return (tuple(a[..., :width // 2] for a in leaves),
            tuple(a[..., width // 2:] for a in leaves))


def fused_mlp_stacked(x, gu_qs, gu_sc, dn_qs, dn_sc, li, *, fast: bool = False):
    """x (M, K); gu_qs (L, K, 2 I) int8 with gu_sc (L, K // g, 2 I): the gate
    columns, then the up columns; dn_qs (L, I, D) int8 with dn_sc
    (L, I // g, D) -> (M, D) in x's type."""
    g, u = _halves("fused_mlp_stacked", (gu_qs, gu_sc))
    return _run(fused_mlp_stacked, x, g, u, (dn_qs, dn_sc), li, False, fast)


def fused_mlp_m_stacked(x, gu_qs, gu_sc, gu_mn, dn_qs, dn_sc, dn_mn, li, *,
                        fast: bool = False):
    """``fused_mlp_stacked`` over int8 values with per-group mins (q5_1, q5_K,
    q2_K): w = q * d + m inside the products."""
    g, u = _halves("fused_mlp_m_stacked", (gu_qs, gu_sc, gu_mn))
    return _run(fused_mlp_m_stacked, x, g, u, (dn_qs, dn_sc, dn_mn), li, False, fast)


def fused_mlp4_stacked(x, gu_qp, gu_sc, gu_mn, dn_qp, dn_sc, dn_mn, li, *,
                       fast: bool = False):
    """``fused_mlp_stacked`` over packed nibbles with mins (q4_1, q4_K, q4_0
    with its -8 * d folded into a min): gu_qp (L, K // 2, 2 I) uint8, dn_qp
    (L, I // 2, D) uint8, group 32."""
    g, u = _halves("fused_mlp4_stacked", (gu_qp, gu_sc, gu_mn))
    return _run(fused_mlp4_stacked, x, g, u, (dn_qp, dn_sc, dn_mn), li, True, fast)


def fused_mlp4_sym_stacked(x, gu_qp, gu_sc, dn_qp, dn_sc, li, *, fast: bool = False):
    """``fused_mlp4_stacked`` for symmetric q4_0: (q - 8) * d, no mins."""
    g, u = _halves("fused_mlp4_sym_stacked", (gu_qp, gu_sc))
    return _run(fused_mlp4_sym_stacked, x, g, u, (dn_qp, dn_sc), li, True, fast)


def fused_mlp_split_stacked(x, g_leaves, u_leaves, dn_leaves, li, *,
                            packed: bool = False, fast: bool = False):
    """The same product with gate and up in two arrays (unfused layers):
    each of ``g_leaves``, ``u_leaves``, ``dn_leaves`` is (values, scales
    [, mins]) of stacked leaves; mins select q * d + m, their absence with
    ``packed`` (q - 8) * d."""
    return _run(fused_mlp_split_stacked, x, tuple(g_leaves), tuple(u_leaves),
                tuple(dn_leaves), li, packed, fast)


ENTRIES = (fused_mlp_stacked, fused_mlp_m_stacked, fused_mlp4_stacked,
           fused_mlp4_sym_stacked, fused_mlp_split_stacked)
for _entry in ENTRIES:
    _entry.launches = 0
