"""Dequantizing matrix products over ggml block weights: the CUDA kernel
csrc/quant_matmul.cu and its plain versions.

Replaces eight TPU kernels of qwen2_audio_tpu/ops/quant_matmul.py, each at
its own entry point:

    quant_matmul                 _qmm_kernel                 flat int8 values (K, N)
    quant_matmul_stacked         _qmm_stacked_kernel         the same over (L, K, N)
    quant_matmul4                _qmm4_kernel                flat packed nibbles (K/2, N)
    quant_matmul4_stacked        _qmm4_stacked_kernel        the same over (L, K/2, N)
    quant_matmul_panel           _qmm_panel_kernel           int8 panels (P, K, bn)
    quant_matmul_panel_stacked   _qmm_panel_stacked_kernel   the same over (L, P, K, bn)
    quant_matmul_panel4          _qmm4_panel_kernel          nibble panels (P, K/2, bn)
    quant_matmul_panel4_stacked  _qmm4_panel_stacked_kernel  the same over (L, P, K/2, bn)

Weight forms (quant/qparams.py builds them from ggml blocks, bit-exact):

    qs      (K, N) int8, [in, out] like a dense weight
    qs4     (K // 2, N) uint8: byte row g * 16 + j holds value g * 32 + j in
            its low and g * 32 + j + 16 in its high nibble (ggml's pairing)
    scales  (K // group, N) float16 or float32; group is 32, or 16 for
            q2_K / q3_K / q6_K, derived from the shapes
    mins    (K // group, N) float32, added outside the kernel as a small
            float32 product (group_min_term)
    qs_p, qs4_p, scales_p
            the same values in P = N // bn contiguous column panels,
            (P, rows, bn): panel p holds columns p * bn .. (p + 1) * bn - 1
            (panelize_weight). The JAX package's decode-tuned storage; "mins"
            stay (K // group, N). A panel entry gives the bits of the strided
            entry on the same values: the kernel only maps addresses otherwise.

Every entry computes ``x @ (float32(v) * scales)`` with float32 sums and
the result in x's type; ``fast`` rounds x and the dequantized weight each
once to bf16 first (the tensor-core mode), otherwise the product is exact
float32. ``dq16`` (fast mode only; the JAX package's QA_Q4_DQ16 and
QA_Q8_DQ16 dequant in bf16) rounds each scale to bf16 before the multiply:
v * bf16(s) is exact in float32 and is rounded once to bf16, as the TPU's
bf16 multiply gives it. A stacked entry reads layer ``li`` in place: ``qs_all[li]`` is a
view, so on the card both entries run one device function with a base
pointer.

On the card the kernel is bound by the weight bytes at M <= 8 (a decode
step) and by operations above (prefill, the encoder); the design notes are
in the CUDA source. At M <= 8 in fast mode the weight streams through the
tensor cores (``stream_plan``: column groups and K splits, from M, K and N
only), and a K split's partial sums are added in split order in the same
launch, by the last block of each column group, which a ticket counter
finds (``ticket_array``: one array per stream and per graph capture).
Above 8 rows in fast mode a persistent tile computes the output's
transpose with the weight dequantized in registers (``tile_plan``: rows
of x a unit, K split, CTAs, from M, K, N and the SM count only); where it
splits K, and in exact mode at M <= 8, a second small kernel adds the
splits in a fixed order. Either way results do not vary from run to run.

Each wrapper launches the kernel for CUDA tensors, runs its plain version
for CPU tensors, raises for anything else, and counts its launches. No
path on the card dequantizes a weight to a dense tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qwen2_audio_tpu_torch.ops import _build

GROUP = 32
_X_TYPES = (torch.float32, torch.bfloat16)
_S_TYPES = (torch.float32, torch.float16)
_SMALL_M = 8          # rows the weight-streaming kernels take
_SMALL_COLS = 128     # exact mode: columns per block
_STREAM_COLS = 256    # fast mode: columns per block (4 warps of 64)
_STREAM_X = 16384     # fast mode: most values of x a block stages (M x its K range)
_STREAM_SPREAD = 5    # fast mode: K splits aim at this many blocks per SM
_STREAM_SPLITS = 28   # fast mode: most K splits (each adds a partial-sum pass)
_STREAM_LEAST = 4     # fast mode: K splits wide weights take all the same
_MAX_TICKETS = 4096   # fast mode: column groups of a K-split launch
_TILE = 128           # exact mode, M > 8: rows and columns of a tile
_QT_N = 128           # fast mode, M > 8: weight columns of a unit
_QT_K = 64            # fast mode, M > 8: values of K a stage
_QT_ROWS = (16, 32, 64, 128)    # rows of x a unit takes at M <= 128: the least that hold M
_QT_WIDE = (128, 192, 256)      # the rows a unit may take above 128
_QT_SPLIT = 4         # least stages of K a split takes
_QT_FIXED = 256       # a unit's cost a stage beyond its rows, in rows of products
_QT_SUMS = 768        # outputs x splits whose float32 sums cost one row-stage to add
SMEM_LIMIT = 232448   # shared memory a block may use
_sm_count: dict[int, int] = {}
_tickets: dict[tuple[str, int, int, int], torch.Tensor] = {}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def unpack4(qs4: torch.Tensor) -> torch.Tensor:
    """(K // 2, N) nibble bytes -> (K, N) int32 values 0..15 in ggml's
    in-group order."""
    p = qs4.to(torch.int32)
    K2, N = p.shape
    n_g = K2 * 2 // GROUP
    lo = (p & 0xF).reshape(n_g, 16, N)
    hi = (p >> 4).reshape(n_g, 16, N)
    return torch.cat([lo, hi], dim=1).reshape(K2 * 2, N)


def block_weight(q: torch.Tensor, scales: torch.Tensor, *, packed: bool = False,
                 off: int = 0, dq16: bool = False) -> torch.Tensor:
    """The float32 (K, N) weight a kernel multiplies by, without mins:
    float32(v) * scales, v the int8 value or, packed, the nibble - off;
    ``dq16`` rounds the scales to bf16 first."""
    v = (unpack4(q) - off) if packed else q
    group = v.shape[0] // scales.shape[0]
    s = scales.float()
    if dq16:
        s = s.to(torch.bfloat16).float()
    return v.float() * s.repeat_interleave(group, dim=0)


def dequantize_weight(qw: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (K, N) weight of a block dict: float32(v) * scales (+ mins),
    cast to ``dtype``. A packed dict without "mins" is symmetric q4_0,
    (q - 8) * d."""
    packed = "qs4" in qw
    w = block_weight(qw["qs4" if packed else "qs"], qw["scales"], packed=packed,
                     off=8 if packed and "mins" not in qw else 0)
    if "mins" in qw:
        w = w + qw["mins"].float().repeat_interleave(w.shape[0] // qw["mins"].shape[0], dim=0)
    return w.to(dtype)


def dequantize_weight4(qw: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``dequantize_weight`` of a packed-nibble dict."""
    return dequantize_weight(qw, dtype)


def _product_plain(x: torch.Tensor, w: torch.Tensor, fast: bool) -> torch.Tensor:
    """x (M, K) @ w (K, N) float32, with the kernel's roundings."""
    if fast:
        y = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    else:
        y = x.float() @ w
    return y.to(x.dtype)


def quant_matmul_plain(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                       *, fast: bool = False, dq16: bool = False) -> torch.Tensor:
    return _product_plain(x, block_weight(qs, scales, dq16=dq16 and fast), fast)


def quant_matmul4_plain(x: torch.Tensor, qs4: torch.Tensor, scales: torch.Tensor,
                        *, fast: bool = False, off: int = 0, dq16: bool = False
                        ) -> torch.Tensor:
    return _product_plain(x, block_weight(qs4, scales, packed=True, off=off,
                                          dq16=dq16 and fast), fast)


def from_panels(a):
    """(..., P, rows, bn) column panels -> (..., rows, P * bn), a view where
    the layout allows; torch or numpy."""
    *lead, P, rows, bn = a.shape
    n = len(lead)
    perm = (*range(n), n + 1, n, n + 2)
    a = a.permute(perm) if isinstance(a, torch.Tensor) else a.transpose(perm)
    return a.reshape(*lead, rows, P * bn)


def to_panels(a, bn: int):
    """(..., rows, N) -> (..., N // bn, rows, bn) contiguous column panels;
    torch or numpy, values untouched."""
    *lead, rows, N = a.shape
    if bn < 1 or N % bn:
        raise ValueError(f"panel width {bn} does not divide N={N}")
    n = len(lead)
    perm = (*range(n), n + 1, n, n + 2)
    a = a.reshape(*lead, rows, N // bn, bn)
    if isinstance(a, torch.Tensor):
        return a.permute(perm).contiguous()
    return a.transpose(perm).copy()


def quant_matmul_panel_plain(x: torch.Tensor, qs_p: torch.Tensor, scales_p: torch.Tensor,
                             *, fast: bool = False, dq16: bool = False) -> torch.Tensor:
    return quant_matmul_plain(x, from_panels(qs_p), from_panels(scales_p), fast=fast,
                              dq16=dq16)


def quant_matmul_panel4_plain(x: torch.Tensor, qs4_p: torch.Tensor, scales_p: torch.Tensor,
                              *, fast: bool = False, off: int = 0, dq16: bool = False
                              ) -> torch.Tensor:
    return quant_matmul4_plain(x, from_panels(qs4_p), from_panels(scales_p), fast=fast,
                               off=off, dq16=dq16)


def group_min_term(x2d: torch.Tensor, mins: torch.Tensor,
                   group: int = GROUP) -> torch.Tensor:
    """The per-group-min correction: with w = q * d + m (m constant over a
    group), x @ W = x @ (q * d) + gsum(x) @ m, gsum the per-group sum of x:
    a small (M, K / group) @ (K / group, N) float32 product."""
    M, K = x2d.shape
    gsum = x2d.float().reshape(M, K // group, group).sum(-1)
    return gsum @ mins.float()


# --------------------------------------------------------------------------- #
# the kernel's wrapper
# --------------------------------------------------------------------------- #

def split_k(M: int, K: int, N: int, sm_count: int) -> int:
    """Blocks along K for the M <= 8 kernel: about four blocks per SM in
    flight, at least two 32-row blocks of K for each of a block's 4 warps."""
    if M > _SMALL_M:
        return 1
    tiles = -(-N // _SMALL_COLS)
    want = -(-4 * sm_count // tiles)
    return max(1, min(want, K // 32 // 8))


def stream_plan(M: int, K: int, N: int, sms: int, packed: bool = False) -> dict:
    """The launch of the fast-mode M <= 8 kernel (qmm_stream_kernel), from
    M, K and N only, so that row-major and panel storage of one weight get
    the same plan and the same bits: blocks of 4 warps, each warp a
    64-column block, grid (column groups of 256, K splits); split s takes
    the 32-row groups ``k_ranges[s]`` of K (whole groups, no two splits more
    than one group apart). The splits bring the blocks to about five per SM
    (``sms``; a few SMs' worth of warps hides the latency of each warp's
    short ring), and to at least 4 for wide weights (gate_up, the lm_head:
    a block's time then varies less), each split at least 8 groups and at
    most 28 splits, and
    keep a block's x (M x its K range, staged in bf16) within 16384 values;
    past 4096 column groups there is one split. ``scratch``: bytes of the
    splits' float32 sums (0 for one split); ``smem``: a block's shared
    memory (the rings, then x)."""
    if not 1 <= M <= _SMALL_M or K < 32 or K % 32 or N < 16 or N % 16:
        raise ValueError(f"stream_plan: M in 1..{_SMALL_M}, K a multiple of 32 and N of "
                         f"16, got M={M}, K={K}, N={N}")
    groups, G = -(-N // _STREAM_COLS), K // 32
    least = -(-G // (_STREAM_X // (32 * M)))   # splits that x's budget asks for
    want = max(1, min(max(_STREAM_LEAST, round(_STREAM_SPREAD * sms / groups)), G // 8,
                      _STREAM_SPLITS))
    ks = min(G, max(least, want if groups <= _MAX_TICKETS else 1))
    if ks > 1 and groups > _MAX_TICKETS:
        raise ValueError(f"stream_plan: N={N} with K={K} at M={M} needs {ks} splits of "
                         f"{groups} column groups (at most {_MAX_TICKETS})")
    k_ranges = [(s * G // ks * 32, (s + 1) * G // ks * 32) for s in range(ks)]
    kc = max(b - a for a, b in k_ranges)
    stage = (16 if packed else 32) * 64 + (256 if packed else 512)
    return {"kernel": "small", "grid": (groups, ks), "ksplit": ks, "k_ranges": k_ranges,
            "scratch": 4 * ks * M * N if ks > 1 else 0,
            "smem": 4 * (4 if packed else 2) * stage + 2 * M * kc}


def tile_ring(bm: int, packed: bool) -> tuple[int, int]:
    """Ring slots and shared memory of the fast M > 8 tile with ``bm`` rows,
    as the kernel's QtShape lays them out: a slot holds the x box (bm rows x
    64 values of K, bf16), the raw weight rows (64 int8 or 32 nibble rows of
    128 columns), 4 scale rows of float32 and two barriers; as many slots as
    fit, at most 15 (the named barriers); 1024 bytes to align."""
    slot = bm * 128 + (32 if packed else 64) * _QT_N + 4 * _QT_N * 4 + 16
    slots = min(15, (SMEM_LIMIT - 1024) // slot)
    return slots, slots * slot + 1024


@functools.lru_cache(maxsize=256)
def tile_plan(M: int, K: int, N: int, sms: int) -> dict:
    """The persistent launch of the fast M > 8 tile (qmm_tile_kernel) for an
    (M, K) x (K, N) product, from M, K, N and the SM count alone, so that
    row-major and panel storage of one weight get the same plan and the
    same bits. A unit is ``bm`` rows of x by 128 weight columns over ``ks``
    ranges of whole 64-deep stages of K; K is split only where the units
    would fill at most half the SMs, each range at least 4 stages, and a
    second launch adds the splits' float32 sums in split order. Up to 128
    rows bm is the least of 16, 32, 64 and 128 that holds M, and K is split
    into up to one unit an SM. Above, bm is 128, 192 or 256 and ks 1 to 4,
    whichever costs least: the waves of the SMs x a unit's stages x (bm +
    256) (each stage's weight load and dequantization cost about 256 rows of
    products on the H100, whatever bm), plus, for a split, ks M N / 768 for
    adding the sums; the wider and the fewer splits on a tie. ``ctas``: one
    an SM, or one a unit where there are fewer; CTA b takes units b, b +
    ctas, ... (``cta_units``). ``k_ranges``: each split's values of K."""
    if M <= _SMALL_M or K < 32 or K % 32 or N < 16 or N % 16 or sms < 1:
        raise ValueError(f"tile_plan: M above {_SMALL_M}, K a multiple of 32 and N of 16, "
                         f"got M={M}, K={K}, N={N} on {sms} SMs")
    nt, stages = -(-N // _QT_N), -(-K // _QT_K)

    def splits(r: int) -> range:   # the K splits a unit of r rows may take
        tiles = -(-M // r) * nt
        return range(1, (min(stages // _QT_SPLIT, sms // tiles) if 2 * tiles <= sms else 1) + 1)

    if M <= _QT_ROWS[-1]:
        bm = next(r for r in _QT_ROWS if r >= M)
        ks = max(splits(bm))
    else:
        def cost(r: int, k: int) -> int:
            units = -(-M // r) * nt * k
            return (-(-units // sms) * -(-stages // k) * (r + _QT_FIXED)
                    + (k * M * N // _QT_SUMS if k > 1 else 0))
        bm, ks = min(((r, k) for r in _QT_WIDE for k in splits(r) if k <= 4),
                     key=lambda c: (cost(*c), -c[0], c[1]))
    mt = -(-M // bm)
    tiles = mt * nt
    k_ranges = [(i * stages // ks * _QT_K, min(K, (i + 1) * stages // ks * _QT_K))
                for i in range(ks)]
    return {"bm": bm, "ks": ks, "tiles": (mt, nt), "units": tiles * ks,
            "ctas": min(tiles * ks, sms), "k_ranges": k_ranges}


def cta_units(plan: dict, b: int) -> list[tuple[int, int, int]]:
    """The units CTA b of a fast M > 8 plan walks, in order, as (m tile, n
    tile, split): M fastest, then the splits, then N, as the kernel's
    qt_unit decodes them, so that the CTAs at work at once share weight
    columns."""
    mt, nt = plan["tiles"]
    ks = plan["ks"]
    return [(u % (mt * ks) % mt, u // (mt * ks), u % (mt * ks) // mt)
            for u in range(b, plan["units"], plan["ctas"])]


def _check(name: str, x, q, sc, packed: bool) -> int:
    """Shapes and types every device takes, for a row-major weight (2-D) or
    column panels (3-D); returns the group size."""
    if x.dim() != 2 or q.dim() not in (2, 3) or sc.dim() != q.dim():
        raise ValueError(f"{name}: x is 2-D, weight and scales 2-D or (panels) 3-D, got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(sc.shape)}")
    M, K = x.shape
    *P, Kq, bn = q.shape
    if Kq * (2 if packed else 1) != K or sc.shape[-1] != bn or sc.shape[-2] == 0 \
            or K % sc.shape[-2] or list(sc.shape[:-2]) != P:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, weight "
                         f"{tuple(q.shape)}, scales {tuple(sc.shape)}")
    group = K // sc.shape[-2]
    if group not in (16, 32) or (packed and group != GROUP):
        raise ValueError(f"{name}: scale group {group} (want 32, or 16 for "
                         "int8 values)")
    want = torch.uint8 if packed else torch.int8
    if q.dtype != want:
        raise ValueError(f"{name}: weight dtype {q.dtype}, want {want}")
    return group


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device, read once."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_count[dev]


def launch_plan(name: str, x, q, sc, group: int, fast: bool, sms: int) -> dict:
    """The kernel's launch for x (M, K) and a row-major or panel weight, from
    shapes, types and addresses alone (no device is touched): which kernel
    (``"small"`` at M <= 8: in fast mode the tensor-core streaming kernel,
    see ``stream_plan``, in exact mode the float32 one; above, ``"wgmma"``
    the fast persistent tile, see ``tile_plan``, and ``"fma"`` the exact
    one), its grid, the K split and the bytes of scratch the wrapper
    allocates (the splits' float32 sums, then a bf16 copy of float32 x for
    the fast large-M tile; 0 for none). Raises for what the kernel does not take:
    x or scales of another type, K not a multiple of 32, N or a panel's
    width not a multiple of 16, an input that is not contiguous or not
    16-byte aligned (the TMA box and the 16-byte loads need both; nothing
    is copied)."""
    M, K = x.shape
    bn = q.shape[-1]                       # the panel width, or N
    N = bn * (q.shape[0] if q.dim() == 3 else 1)
    if x.dtype not in _X_TYPES or sc.dtype not in _S_TYPES:
        raise ValueError(f"{name}: the kernel takes x in {_X_TYPES} and scales "
                         f"in {_S_TYPES}, got {x.dtype}, {sc.dtype}")
    if M < 1 or K % 32 or bn % 16:
        raise ValueError(f"{name}: the kernel takes M >= 1, K a multiple of 32 and N "
                         f"(and a panel's width) a multiple of 16, got M={M}, K={K}, "
                         f"N={N}, width {bn}")
    for t in (x, q, sc):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every input must be contiguous, 16-byte "
                             f"aligned and on {x.device}")
    if M <= _SMALL_M and fast:
        plan = stream_plan(M, K, N, sms, packed=q.dtype == torch.uint8)
        return {**plan, "M": M, "K": K, "N": N, "bn": bn, "group": group}
    tile = {}
    if M <= _SMALL_M:
        kernel, ksplit = "small", split_k(M, K, N, sms)
        grid = (-(-N // _SMALL_COLS), ksplit)
    elif fast:
        tp = tile_plan(M, K, N, sms)
        kernel, ksplit, grid = "wgmma", tp["ks"], (tp["ctas"],)
        ring, smem = tile_ring(tp["bm"], q.dtype == torch.uint8)
        tile = {**tp, "ring": ring, "smem": smem}
    else:
        kernel, ksplit = "fma", 1
        grid = (-(-M // _TILE), -(-N // _TILE))
    # the splits' float32 sums, then (fast, M > 8, float32 x) x in bf16
    scratch = (4 * ksplit * M * N if ksplit > 1 else 0) \
        + (2 * M * K if kernel == "wgmma" and x.dtype == torch.float32 else 0)
    return {**tile, "kernel": kernel, "grid": grid, "M": M, "K": K, "N": N, "bn": bn,
            "group": group, "ksplit": ksplit, "scratch": scratch}


def ticket_array(device: torch.device, stream: int, kind: str = "quant_matmul") -> torch.Tensor:
    """The ticket counters of one kernel's launches on ``stream`` (a
    cudaStream_t), or, while a CUDA graph is being captured on it, of the
    launches in that capture: int32 (4096,), made zero once (in a capture,
    by a fill the graph replays before its first launch) and left at zero
    by each launch's last blocks. ``kind`` names the kernel that counts on
    it (the fast-mode K-split launches here, "fused_mlp" for the one-launch
    SwiGLU's grid barrier and tile tickets, "quant_matmul_int8" for the
    integer M <= 8 kernel's split tickets), so that two kernels never share
    an array. Launches on one stream, or in one graph, run one after
    another, so no two launches in flight at once share an array and no
    launch pays for zeroing one. An array lives as long as the process (16
    KB per kernel, stream and capture)."""
    lib = _build.library("quant_matmul")
    cid = ctypes.c_ulonglong(0)
    _build.check(lib.qa_stream_capture_id(stream, ctypes.byref(cid)), "ticket_array")
    key = (kind, device.index, stream, cid.value)
    if key not in _tickets:
        _tickets[key] = torch.zeros(_MAX_TICKETS, dtype=torch.int32, device=device)
    return _tickets[key]


def _launch(name: str, x, q, sc, group: int, packed: bool, off: int,
            fast: bool, dq16: bool = False) -> torch.Tensor:
    if off not in (0, 8):
        raise ValueError(f"{name}: off must be 0 or 8, got {off}")
    plan = launch_plan(name, x, q, sc, group, fast, sm_count(x.device))
    M, N = plan["M"], plan["N"]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    scratch = (torch.empty(plan["scratch"], dtype=torch.uint8, device=x.device)
               if plan["scratch"] else None)
    lib = _build.library("quant_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = ticket_array(x.device, stream) \
            if plan["kernel"] == "small" and fast and plan["ksplit"] > 1 else None
        rc = lib.qa_quant_matmul(
            x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            M, plan["K"], N, plan["bn"], group, int(x.dtype == torch.bfloat16),
            int(sc.dtype == torch.float16), int(packed), off, int(fast),
            int(dq16 and fast), plan["ksplit"], plan.get("bm", 0),
            plan["grid"][0] if plan["kernel"] == "wgmma" else 0, stream)
    _build.check(rc, name)
    return out


def _run(entry, x, q, sc, packed: bool, off: int, fast: bool,
         dq16: bool = False) -> torch.Tensor:
    name = entry.__name__
    group = _check(name, x, q, sc, packed)
    if x.device.type == "cpu":
        if q.dim() == 3:
            q, sc = from_panels(q), from_panels(sc)
        if packed:
            return quant_matmul4_plain(x, q, sc, fast=fast, off=off, dq16=dq16)
        return quant_matmul_plain(x, q, sc, fast=fast, dq16=dq16)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch(name, x, q, sc, group, packed, off, fast, dq16)
    entry.launches += 1
    return out


def _nd(name: str, a: torch.Tensor, dims: int) -> torch.Tensor:
    if a.dim() != dims:
        raise ValueError(f"{name}: a {dims}-D leaf is wanted, got {tuple(a.shape)}")
    return a


def _layer(name: str, a: torch.Tensor, li: int, dims: int = 3) -> torch.Tensor:
    return _nd(name, a, dims)[int(li)]


def quant_matmul(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, *,
                 fast: bool = False, dq16: bool = False) -> torch.Tensor:
    """x (M, K) @ (qs (K, N) int8 * scales (K // group, N)) -> (M, N) in x's
    type. Runs the CUDA kernel for CUDA tensors and the plain version for
    CPU tensors."""
    return _run(quant_matmul, x, _nd("quant_matmul", qs, 2), scales, False, 0, fast, dq16)


def quant_matmul_stacked(x: torch.Tensor, qs_all: torch.Tensor, sc_all: torch.Tensor,
                         li: int, *, fast: bool = False, dq16: bool = False) -> torch.Tensor:
    """``quant_matmul`` over layer ``li`` of qs_all (L, K, N) and sc_all
    (L, K // group, N), read in place."""
    return _run(quant_matmul_stacked, x,
                _layer("quant_matmul_stacked", qs_all, li),
                _layer("quant_matmul_stacked", sc_all, li), False, 0, fast, dq16)


def quant_matmul4(x: torch.Tensor, qs4: torch.Tensor, scales: torch.Tensor, *,
                  fast: bool = False, off: int = 0, dq16: bool = False) -> torch.Tensor:
    """x (M, K) @ ((unpack4(qs4 (K // 2, N)) - off) * scales (K // 32, N)):
    off 8 is symmetric q4_0; with off 0 the caller adds the min term."""
    return _run(quant_matmul4, x, _nd("quant_matmul4", qs4, 2), scales, True, off, fast,
                dq16)


def quant_matmul4_stacked(x: torch.Tensor, qs4_all: torch.Tensor, sc_all: torch.Tensor,
                          li: int, *, fast: bool = False, off: int = 0,
                          dq16: bool = False) -> torch.Tensor:
    """``quant_matmul4`` over layer ``li`` of qs4_all (L, K // 2, N) and
    sc_all (L, K // 32, N), read in place."""
    return _run(quant_matmul4_stacked, x,
                _layer("quant_matmul4_stacked", qs4_all, li),
                _layer("quant_matmul4_stacked", sc_all, li), True, off, fast, dq16)


def quant_matmul_panel(x: torch.Tensor, qs_p: torch.Tensor, scales_p: torch.Tensor, *,
                       fast: bool = False, dq16: bool = False) -> torch.Tensor:
    """``quant_matmul`` over column panels qs_p (P, K, bn) and scales_p
    (P, K // group, bn) -> (M, P * bn), written row-major."""
    return _run(quant_matmul_panel, x, _nd("quant_matmul_panel", qs_p, 3),
                _nd("quant_matmul_panel", scales_p, 3), False, 0, fast, dq16)


def quant_matmul_panel_stacked(x: torch.Tensor, qs_p: torch.Tensor, scales_p: torch.Tensor,
                               li: int, *, fast: bool = False, dq16: bool = False
                               ) -> torch.Tensor:
    """``quant_matmul_panel`` over layer ``li`` of qs_p (L, P, K, bn) and
    scales_p (L, P, K // group, bn), read in place."""
    return _run(quant_matmul_panel_stacked, x,
                _layer("quant_matmul_panel_stacked", qs_p, li, 4),
                _layer("quant_matmul_panel_stacked", scales_p, li, 4), False, 0, fast, dq16)


def quant_matmul_panel4(x: torch.Tensor, qs4_p: torch.Tensor, scales_p: torch.Tensor, *,
                        fast: bool = False, off: int = 0, dq16: bool = False) -> torch.Tensor:
    """``quant_matmul4`` over column panels qs4_p (P, K // 2, bn) and
    scales_p (P, K // 32, bn)."""
    return _run(quant_matmul_panel4, x, _nd("quant_matmul_panel4", qs4_p, 3),
                _nd("quant_matmul_panel4", scales_p, 3), True, off, fast, dq16)


def quant_matmul_panel4_stacked(x: torch.Tensor, qs4_p: torch.Tensor, scales_p: torch.Tensor,
                                li: int, *, fast: bool = False, off: int = 0,
                                dq16: bool = False) -> torch.Tensor:
    """``quant_matmul_panel4`` over layer ``li`` of qs4_p (L, P, K // 2, bn)
    and scales_p (L, P, K // 32, bn), read in place."""
    return _run(quant_matmul_panel4_stacked, x,
                _layer("quant_matmul_panel4_stacked", qs4_p, li, 4),
                _layer("quant_matmul_panel4_stacked", scales_p, li, 4), True, off, fast,
                dq16)


ENTRIES = (quant_matmul, quant_matmul_stacked, quant_matmul4, quant_matmul4_stacked,
           quant_matmul_panel, quant_matmul_panel_stacked, quant_matmul_panel4,
           quant_matmul_panel4_stacked)
for _entry in ENTRIES:
    _entry.launches = 0


# --------------------------------------------------------------------------- #
# linear layers over the block dicts
# --------------------------------------------------------------------------- #

def _with_mins(y: torch.Tensor, x2d: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    return y + group_min_term(x2d, mins, group=x2d.shape[1] // mins.shape[0]).to(y.dtype)


def quant_linear4(x: torch.Tensor, qw: dict, fast: bool = False,
                  dq16: bool = False) -> torch.Tensor:
    """x (..., K) @ {"qs4", "scales"[, "mins"]} -> (..., N); a dict without
    "mins" is symmetric q4_0, dequantized (q - 8) * d inside the kernel."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    sym = "mins" not in qw
    y = quant_matmul4(x2d, qw["qs4"], qw["scales"], fast=fast, off=8 if sym else 0,
                      dq16=dq16)
    if not sym:
        y = _with_mins(y, x2d, qw["mins"])
    return y.reshape(*x.shape[:-1], -1)


def quant_linear(x: torch.Tensor, qw: dict, fast: bool = False,
                 dq16: bool = False) -> torch.Tensor:
    """x (..., K) @ {"qs", "scales"[, "mins"]} -> (..., N); packed-nibble
    dicts go to quant_linear4. ``dq16`` applies to this dict's form (the
    caller picks the q4 or the q8 switch)."""
    if "qs4" in qw:
        return quant_linear4(x, qw, fast=fast, dq16=dq16)
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    y = quant_matmul(x2d, qw["qs"], qw["scales"], fast=fast, dq16=dq16)
    if "mins" in qw:
        y = _with_mins(y, x2d, qw["mins"])
    return y.reshape(*x.shape[:-1], -1)


def quant_linear_stacked(x: torch.Tensor, qw: dict, li: int,
                         fast: bool = False, dq16: bool = False) -> torch.Tensor:
    """``quant_linear`` over layer ``li`` of a dict whose every leaf has a
    leading (L,) axis, in any of the four storage forms ("qs", "qs4", or
    their panels "qs_p", "qs4_p" with "scales_p")."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    off = 8 if "mins" not in qw else 0
    if "qs4_p" in qw:
        y = quant_matmul_panel4_stacked(x2d, qw["qs4_p"], qw["scales_p"], li, fast=fast,
                                        off=off, dq16=dq16)
    elif "qs_p" in qw:
        y = quant_matmul_panel_stacked(x2d, qw["qs_p"], qw["scales_p"], li, fast=fast,
                                       dq16=dq16)
    elif "qs4" in qw:
        y = quant_matmul4_stacked(x2d, qw["qs4"], qw["scales"], li, fast=fast, off=off,
                                  dq16=dq16)
    else:
        y = quant_matmul_stacked(x2d, qw["qs"], qw["scales"], li, fast=fast, dq16=dq16)
    if "mins" in qw:
        y = _with_mins(y, x2d, qw["mins"][int(li)])
    return y.reshape(*x.shape[:-1], -1)


def quant_linear_panel(x: torch.Tensor, qw: dict, fast: bool = False,
                       dq16: bool = False) -> torch.Tensor:
    """x (..., K) @ a panelized dict {"qs_p" or "qs4_p", "scales_p"[, "mins"]}
    -> (..., N); "mins" are (K // group, N) as in the strided forms."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if "qs4_p" in qw:
        y = quant_matmul_panel4(x2d, qw["qs4_p"], qw["scales_p"], fast=fast,
                                off=8 if "mins" not in qw else 0, dq16=dq16)
    else:
        y = quant_matmul_panel(x2d, qw["qs_p"], qw["scales_p"], fast=fast, dq16=dq16)
    if "mins" in qw:
        y = _with_mins(y, x2d, qw["mins"])
    return y.reshape(*x.shape[:-1], -1)


# --------------------------------------------------------------------------- #
# contiguous-panel storage
# --------------------------------------------------------------------------- #

def pick_panel_width(N: int, pref: int = 0) -> int:
    """The panel width for N columns: the largest multiple of 128 that
    divides N and is at most ``pref`` (0: 1024), or the whole N where no
    multiple of 128 divides it."""
    pref = pref or 1024
    for cand in range(min(pref, N) // 128 * 128, 0, -128):
        if N % cand == 0:
            return cand
    return N


def panelize_weight(qw: dict, block_n: int = 0) -> dict:
    """{"qs": (K, N), "scales": (K // g, N)[, "mins", "b"]} -> {"qs_p":
    (P, K, bn), "scales_p": (P, K // g, bn)[, "mins", "b"]}, and "qs4" ->
    "qs4_p" likewise; ``block_n`` 0 takes ``pick_panel_width``. Values are
    untouched; "mins" and "b" stay as they are. Leading (L,) axes are kept."""
    packed = "qs4" in qw
    q = qw["qs4" if packed else "qs"]
    bn = block_n or pick_panel_width(q.shape[-1])
    out = {"qs4_p" if packed else "qs_p": to_panels(q, bn),
           "scales_p": to_panels(qw["scales"], bn)}
    for extra in ("mins", "b"):
        if extra in qw:
            out[extra] = qw[extra]
    return out
