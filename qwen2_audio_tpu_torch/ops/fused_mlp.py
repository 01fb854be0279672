"""One-launch SwiGLU MLP over ggml block weights at decode M: the CUDA
kernel csrc/fused_mlp.cu (fast mode at 9 <= M <= 64 built from
csrc/fused_mlp_rows.cu, the kernel's code in csrc/swiglu_coop.cuh) and its
plain version.

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

``fast`` runs one cooperative launch that reads every weight byte once at
every M (``swiglu_plan``; design notes in the CUDA source). Phase A: each
CTA computes g, u and gated over all M rows for its 16-column units of I
and writes gated, rounded to bf16, to a device scratch. A grid barrier.
Phase B: the CTAs stream Wd in column tiles and splits of I; the splits'
float32 partial sums are added in split order by the tile's last CTA in the
same launch (ticket counters per stream and per graph capture,
``ticket_array``). At M <= 8 each warp streams 64-column blocks through its
own ring with x (or gated) staged once as B; above, a CTA's warps share a
ring of stages that carries x's rows too. The exact mode runs the float32
kernel, whose slices ``slice_width`` sets, and a second small kernel adds
the slices' partial sums in slice order. Either way a result repeats bit
for bit. Each wrapper launches the kernel for CUDA tensors, runs
``fused_mlp_plain`` for CPU tensors, raises for anything else, and counts
its launches. The TPU blocking knobs (``block_i``, padding M to 8) have no
counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qwen2_audio_tpu_torch.ops import _build
from qwen2_audio_tpu_torch.ops.quant_matmul import (GROUP, _layer, block_weight, sm_count,
                                                    ticket_array)

MAX_M = 64
# The most rows at which the decoder takes the one-launch kernel by default
# (ops/linear.py): the largest M at which it is not slower than the two-launch
# path over the dequantizing M > 8 tile in either format. chip_smoke.py's
# SwiGLU phase on an NVIDIA H100 80GB HBM3 at 700 W, graph replay, one-launch
# against two-launch ms over two runs: q8_0 M = 8 0.1113-0.1119 /
# 0.1248-0.1253, 9 0.1480-0.1481 / 0.1479-0.1488 (even), 12 0.1491-0.1492 /
# 0.1471-0.1487, 16 0.1550-0.1559 / 0.1475-0.1482, 64 0.2661-0.2664 /
# 0.1666-0.1696; q4_0 M = 8 0.0756-0.0760 / 0.0863-0.0883, 9 0.1309-0.1313 /
# 0.1412-0.1424, 16 0.1402 / 0.1400-0.1415.
ONE_LAUNCH_MAX_M = 8
_TILE = 64                      # exact mode: columns of I a block takes per pass
_SCRATCH_BYTES = 64 << 20       # exact mode: most the partial sums may take
_UNIT = 16                      # fast mode: columns of one mma A tile; phase A hands out I in these
_MAX_UNITS = 12                 # fast mode: units of I a CTA takes in one pass over K
_RING_BYTES = 160 << 10         # fast mode: most shared memory the ring of stages takes
_RING_A, _RING_B = 6, 8         # fast mode: most stages of each phase's ring
_GROUPS = (4, 2, 1)             # fast mode: groups of 32 values a stage may take, widest first
_BARRIER_WORDS = 3              # fast mode: tickets[0..2] are the grid barrier's
_MAX_TICKETS = 4096
_SCRATCH_SHARE = 0.05           # fast mode: scratch bytes at most this share of the weights'
_CO_SMEM = 232448 - 1024        # fast mode: a CTA's dynamic shared memory (beside its flag)
_CO_SMEM_HALF = 114688          # fast mode: the same where two CTAs share an SM
_WARPS = 8                      # fast mode: warps of a CTA
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
    """Exact mode: columns of I per block, one 64-column tile while the
    float32 partial sums (slices, M, D) fit the scratch budget, more tiles
    per block for larger M."""
    tiles = -(-I // _TILE)
    most = max(1, _SCRATCH_BYTES // (M * D * 4))
    return -(-tiles // min(tiles, most)) * _TILE


def _row_pitch(cols: int) -> int:
    """Bytes from one value row of a ring stage to the next: four
    neighbouring rows land on four different groups of banks."""
    return cols + (16 if cols % 128 in (0, 64) else 0)


def _stage_bytes(cols: int, packed: bool, mins: bool, srows: int, es: int, M: int,
                 xes: int, sg: int) -> int:
    """One ring stage of ``sg`` groups of 32 values of K or I: value rows,
    scale rows, min rows, x's raw rows (``xes`` bytes a value; 0 in phase
    B), B in fragment order; the CUDA source's stage_map."""
    return sg * ((16 if packed else 32) * _row_pitch(cols) + srows * cols * es
                 + (srows * cols * 4 if mins else 0) + M * 32 * xes + 64 * M)


def _coop_ctas(M: int) -> int:
    """CTAs an SM: one of 16 warps at M <= 8 (phase A streams through
    per-warp rings); two of 8 at M <= 32, so that one computes while the
    other waits at its block barrier; else one of 8."""
    return 2 if 8 < M <= 32 else 1


def _coop_warps(M: int) -> int:
    return 16 if M <= 8 else _WARPS


def _coop_items(M: int) -> int:
    """Most phase-A items (a piece over one group of a stage) a warp holds
    above 8 rows."""
    return 3 if 16 < M <= 32 else 5


def _coop_smem_cap(M: int) -> int:
    """A CTA's dynamic shared memory: its share of the SM's 228 KB."""
    return _CO_SMEM if _coop_ctas(M) == 1 else _CO_SMEM_HALF


def _round_units(n: int) -> int:
    """Most units of one pass over K when a CTA owns n units."""
    rounds = -(-n // _MAX_UNITS)
    return -(-n // rounds) if n else 0


def weight_bytes(K: int, I: int, D: int, packed: bool = False, mins: bool = False, *,
                 group: int = 32, gu_s_bytes: int = 2, dn_s_bytes: int = 2) -> int:
    """Bytes of one layer's gate, up and down leaves: values, scales, mins."""
    values = (2 * K * I + I * D) // (2 if packed else 1)
    scales = (K // group) * 2 * I * gu_s_bytes + (I // group) * D * dn_s_bytes
    return values + scales + (((K // group) * 2 * I + (I // group) * D) * 4 if mins else 0)


@functools.lru_cache(maxsize=256)
def swiglu_plan(M: int, K: int, I: int, D: int, sms: int, packed: bool = False,
                mins: bool = False, *, group: int = 32, x_bytes: int = 2,
                gu_s_bytes: int = 2, dn_s_bytes: int = 2) -> dict:
    """The launch of the fast-mode kernel (swiglu_coop_kernel), from the
    shapes and the bytes of x's and the scales' types: one cooperative grid
    of ``sms`` CTAs of 16 warps at M <= 8, of 2 ``sms`` CTAs of 8 warps at
    9 <= M <= 32, of ``sms`` CTAs of 8 warps above (``grid``, ``warps``).

    Phase A: CTA c owns the 16-column units [c U / P, (c + 1) U / P) of I
    (U = I / 16); ``phase_a[c]`` lists its passes over K as column ranges of
    I (one at M <= 8, else of at most 12 units, ``units_a`` the widest).
    Phase B: y's columns in tiles of 16 ``warps``, the 32-row groups of I in
    ``splits`` S ranges; ``phase_b`` lists the tasks (columns of D, rows of
    I), task t on CTA t % P. S is the most that keeps every CTA at one task
    and the scratch within 5 % of the weight bytes. At M <= 8 every warp
    streams through its own ring of ``ring_a`` = ``ring_b`` = 2 stages of
    ``stage_a`` bytes beside x (or a task's rows of gated) staged whole;
    above, a CTA's warps share a ring of ``ring_a`` / ``ring_b`` stages of
    ``sg_a`` / ``sg_b`` groups of 32 values (``stage_a`` / ``stage_b``
    bytes, within 160 KB, the widest of which 3 fit). The warps' sums meet
    in an ``exchange`` over the rings; ``smem``: a CTA's dynamic shared
    memory. ``scratch``: gated (bf16 (M, I)) and, for S > 1, the float32
    partial sums (S, M, D); ``tickets``: the barrier words and a ticket per
    tile. ``traffic``: the bytes the launch moves to or from device memory,
    reckoned: every weight byte once (``weights``), x and y once, each
    scratch byte and ticket once (written in the launch, read back from the
    50 MB L2; x and gated are read again from there by every CTA or task).
    Raises for shapes the kernel does not take. Cached (a wrapper call reads
    it): the caller must not change the dict."""
    if not 1 <= M <= MAX_M or K % 32 or I % 32 or D % 16 or min(K, I, D) < 1 or sms < 1:
        raise ValueError(f"swiglu_plan: M in 1..{MAX_M}, K and I multiples of 32, D of 16, "
                         f"got M={M}, K={K}, I={I}, D={D}")
    if group not in (16, 32) or (packed and group != 32):
        raise ValueError(f"swiglu_plan: group {group} (32, or 16 for int8 values)")
    U, P, warps = I // _UNIT, sms * _coop_ctas(M), _coop_warps(M)
    phase_a = []
    for c in range(P):
        a, b = c * U // P, (c + 1) * U // P
        rounds = min(1, b - a) if M <= 8 else -(-(b - a) // _MAX_UNITS)
        phase_a.append([(_UNIT * (a + r * (b - a) // rounds),
                         _UNIT * (a + (r + 1) * (b - a) // rounds)) for r in range(rounds)])
    units_a = -(-U // P) if M <= 8 else max(_round_units(U // P), _round_units(-(-U // P)))
    srows, cols_b = 32 // group, _UNIT * warps

    def stage_a_of(sg):
        return _stage_bytes(2 * _UNIT * units_a, packed, mins, srows, gu_s_bytes, M, x_bytes,
                            sg)

    def stage_b_of(sg):
        return _stage_bytes(cols_b, packed, mins, srows, dn_s_bytes, M, 0, sg)

    def exchange_of(sg):   # every item's float32 sums of its piece's 16 columns
        return sg * 2 * _UNIT * units_a * M * 4

    tiles = -(-D // cols_b)
    if _BARRIER_WORDS + tiles > _MAX_TICKETS:
        raise ValueError(f"swiglu_plan: D={D} needs {tiles} tile tickets "
                         f"(at most {_MAX_TICKETS - _BARRIER_WORDS})")
    weights = weight_bytes(K, I, D, packed, mins, group=group, gu_s_bytes=gu_s_bytes,
                           dn_s_bytes=dn_s_bytes)
    tickets = 4 * (_BARRIER_WORDS + tiles)
    GI = I // 32
    S = max(1, min(P // tiles, GI))
    while S > 1 and 2 * M * I + 4 * S * M * D + tickets > _SCRATCH_SHARE * weights:
        S -= 1
    scratch = 2 * M * I + (4 * S * M * D if S > 1 else 0)
    phase_b = [((t * cols_b, min(D, (t + 1) * cols_b)),
                (s * GI // S * 32, (s + 1) * GI // S * 32))
               for t in range(tiles) for s in range(S)]
    if M <= 8:
        # both phases stream through a ring of 2 stages a warp (qmm_stream.cuh's
        # stages of 64 columns) beside x, or a task's rows of gated, staged
        # once; a warp takes one 64-column block
        ring_a = ring_b = 2
        sg_a = sg_b = 1
        stage_a = stage_b = ((16 if packed else 32) * 64
                             + (256 if packed else 512) * (2 if mins else 1))
        exchange = warps * M * 64 * 4
        smem = max(warps * ring_a * stage_a + 2 * M * max(K, 32 * -(-GI // S)), exchange)
        blocks = -(-(-(-U // P)) // 2)
        if blocks > warps:
            raise ValueError(f"swiglu_plan: {blocks} blocks of 64 columns of I a CTA (at most "
                             f"{warps})")
    else:
        # phase A: the widest stage that divides K / 32, gives each thread at
        # most 4 chunks of x and each warp at most _coop_items(M) items, and
        # of which 3 fit, as does the exchange; phase B: the widest of which
        # 3 fit
        budget = min(_RING_BYTES, _coop_smem_cap(M))
        fits = [sg for sg in _GROUPS if (K // 32) % sg == 0
                and sg * M <= 128 and sg * M * x_bytes <= 512
                and -(-2 * units_a * sg // warps) <= _coop_items(M)
                and budget // stage_a_of(sg) >= 3 and exchange_of(sg) <= _coop_smem_cap(M)]
        sg_b = next((sg for sg in _GROUPS if budget // stage_b_of(sg) >= 3), 1)
        ring_b = min(_RING_B, budget // stage_b_of(sg_b))
        if not fits or ring_b < 3:
            raise ValueError(f"swiglu_plan: M={M}, K={K} leave no ring of 3 stages")
        sg_a = fits[0]
        ring_a = min(_RING_A, budget // stage_a_of(sg_a))
        stage_a, stage_b, exchange = stage_a_of(sg_a), stage_b_of(sg_b), exchange_of(sg_a)
        smem = max(ring_a * stage_a, ring_b * stage_b, exchange)
    if smem > _coop_smem_cap(M):
        raise ValueError(f"swiglu_plan: M={M}, K={K} need {smem} bytes of shared memory a "
                         f"CTA (at most {_coop_smem_cap(M)})")
    return {"kernel": "coop", "grid": (P,), "warps": warps, "phase_a": phase_a,
            "units_a": units_a, "tiles": tiles, "splits": S, "phase_b": phase_b,
            "ring_a": ring_a, "ring_b": ring_b, "sg_a": sg_a, "sg_b": sg_b,
            "stage_a": stage_a, "stage_b": stage_b, "exchange": exchange,
            "smem": smem,
            "scratch": scratch, "tickets": tickets,
            "weights": weights,
            "traffic": weights + M * (K + D) * x_bytes + scratch + tickets}


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
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    ld = g[0].stride(0)
    for w, rows_stride in ((g, ld), (u, ld), (dn, D)):
        if w[1].dtype not in _S_TYPES or (mins and w[2].dtype != torch.float32):
            raise ValueError(f"{name}: the kernel takes scales in {_S_TYPES} and float32 "
                             f"mins, got {[t.dtype for t in w[1:]]}")
        for t in w:
            if t.device != x.device or t.stride() != (rows_stride, 1) or t.data_ptr() % 16:
                raise ValueError(f"{name}: every leaf must lie on {x.device}, rows "
                                 f"{rows_stride} elements apart (gate and up alike), its "
                                 "columns contiguous and 16-byte aligned")
    if g[1].dtype != u[1].dtype:
        raise ValueError(f"{name}: gate and up scales differ in type")
    # fast mode above 8 rows is built from its own source (csrc/fused_mlp_rows.cu)
    rows = fast and M > 8
    entry = getattr(_build.library("fused_mlp_rows" if rows else "fused_mlp"),
                    "qa_fused_mlp_rows" if rows else "qa_fused_mlp")
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)

    def ptrs(w):
        return [t.data_ptr() for t in w] + ([] if mins else [None])

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fast:
            plan = swiglu_plan(M, K, I, D, sm_count(x.device), packed, mins, group=group,
                               x_bytes=x.element_size(), gu_s_bytes=g[1].element_size(),
                               dn_s_bytes=dn[1].element_size())
            S = plan["splits"]
            scratch = torch.empty(M * I, dtype=torch.bfloat16, device=x.device)
            partial = torch.empty((S, M, D), dtype=torch.float32, device=x.device) \
                if S > 1 else None
            tickets = ticket_array(x.device, stream, "fused_mlp")
            numbers = (ctypes.c_int * 7)(plan["grid"][0], S, plan["units_a"], plan["ring_a"],
                                         plan["ring_b"], plan["sg_a"], plan["sg_b"])
            bi, extra = 0, (partial.data_ptr() if partial is not None else None,
                            tickets.data_ptr())
            plan_ptr = ctypes.cast(numbers, ctypes.c_void_p)
        else:
            bi = slice_width(M, I, D)
            scratch = torch.empty((-(-I // bi), M, D), dtype=torch.float32, device=x.device)
            extra, plan_ptr = (None, None), None
        rc = entry(
            x.data_ptr(), *ptrs(g), *ptrs(u), *ptrs(dn), out.data_ptr(), scratch.data_ptr(),
            *extra, M, K, I, D, ld, bi, plan_ptr, group, int(x.dtype == torch.bfloat16),
            int(g[1].dtype == torch.float16), int(dn[1].dtype == torch.float16),
            int(packed), 8 if packed and not mins else 0, int(fast), stream)
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
