"""Exact-integer group matmul over ggml block weights, ggml's mmq numerics:
the CUDA kernel csrc/quant_matmul_int8.cu and its plain versions.

Replaces two TPU kernels of qwen2_audio_tpu/ops/quant_matmul_int8.py, each at
its own entry point (ops/quant_matmul_q4b.py holds the third of the family,
the int32-word nibble form, on the same CUDA source):

    quant_matmul_int8          _kernel           flat int8 values (K, N)
    quant_matmul_int8_stacked  _kernel_stacked   int8 values (L, K, N), or
                                                 nibble bytes (L, K // 2, N)

Every entry computes, for x (M, K) and a weight of integer values v (int8,
or nibble - off) with one scale sw per 32-group of a column:

    xq, sx = quantize_activations(x)   ggml's quantize_row_q8_1 per row and
                                       32-group: sx = amax / 127, xq =
                                       round_half_even(x * (1 / sx)), 0 for
                                       an all-zero group; IEEE roundings
    out[m, n] = the sum over the groups g, in order, in float32, of
                float32(p[m, g, n]) * (sx[m, g] * sw[g, n])

p the exact integer dot of xq and v over the group; the result is in x's
type. The weights enter exactly, only the activations are rounded, to 8 bits
per group. Group 32 only: the k-quants with 16-groups take the dequantizing
kernels (ops/linear.py). A "mins" term (q4_1, q5_1, q4_K) is added outside
the kernel on the raw x (quant_matmul.group_min_term), as in JAX, so q4_0
stored symmetric (off 8: the -8 goes through the quantized activations) and
q4_0 stored with mins (-8 * d through the float32 group sums) differ by
design.

On the card the kernel is bound by the weight bytes at M <= 8 (a decode
step; the quantization of x is fused into it). Above 8 rows a quantizing
launch is followed by persistent TMA-fed tiles whose group dots run on f16
wgmma (every operand and partial sum is an exact integer in f16 / float32),
a launch planned by ``tile_plan``; the design notes are in the CUDA source.
Its float32 sums run in another order than the plain
version's, so the two agree to a tolerance, not bit for bit; two runs, a flat
and a stacked entry on the same values, and the nibble-byte and int32-word
forms of the same bytes give the same bits.

Each wrapper launches the kernel for CUDA tensors, runs its plain version
for CPU tensors, raises for anything else, and counts its launches.
"""

from __future__ import annotations

import torch

import functools

from qwen2_audio_tpu_torch.ops import _build
from qwen2_audio_tpu_torch.ops.quant_matmul import (_SMALL_COLS, _SMALL_M, _layer, _nd,
                                                    _with_mins, sm_count, split_k, unpack4)

GROUP = 32
_X_TYPES = (torch.float32, torch.bfloat16)
_S_TYPES = (torch.float32, torch.float16)
# the kernel's weight forms: stored type and values of K per stored row
STRIDED, PACKED, WORDS = 0, 1, 2
_FORMS = {STRIDED: (torch.int8, 1), PACKED: (torch.uint8, 2), WORDS: (torch.int32, 8)}
_PLAIN_CHUNK_BYTES = 1 << 28
# the M > 8 tile (csrc/quant_matmul_int8.cu): weight columns a unit, values
# of K a stage, the rows of x a unit may take, a unit's cost a stage beyond
# its rows (converting its weight, loads, barriers) in rows, the most ring
# slots (two named barriers each)
TILE_N, STAGE_K = 128, 64
TILE_ROWS = (16, 32, 64, 128)
TILE_FIXED = 32
TILE_SLOTS = 7
SMEM_LIMIT = 232448   # shared memory a block may use on sm_90


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def quantize_activations_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (xq int8 (M, K), sx float32 (M, K // 32)), bit-equal to the
    JAX package's quantize_activations."""
    M, K = x.shape
    g = x.float().reshape(M, K // GROUP, GROUP)
    amax = g.abs().amax(dim=-1)
    # tensor by tensor: on the card a division by a Python number is a
    # product with its reciprocal, which is not the IEEE quotient
    sx = amax / torch.full_like(amax, 127.0)
    inv = torch.where(sx > 0, torch.ones_like(sx) / sx, torch.zeros_like(sx))
    xq = torch.round(g * inv[..., None]).to(torch.int8).reshape(M, K)
    return xq, sx


def words_k(k):
    """The column of the M > 8 tile's xq that holds value k of a row, for
    the words form (an int or an integer tensor): inside each 16 of a
    32-group, value 4 t4 + 2 h + b sits at 8 h + 2 t4 + b (the kernel's
    words_k). The other forms keep K's order."""
    return (k & ~15) | ((k & 2) << 2) | ((k >> 1) & 6) | (k & 1)


def sx_slot(m):
    """The column of the M > 8 tile's sx_t that holds row m's scale (an int
    or an integer tensor): inside each 16 rows, rows 2 t4, 2 t4 + 1, 2 t4 +
    8, 2 t4 + 9 at 4 t4 .. 4 t4 + 3 (the kernel's sx_slot)."""
    return (m & ~15) | (((m >> 1) & 3) << 2) | (((m >> 3) & 1) << 1) | (m & 1)


def tile_activations_plain(x: torch.Tensor, form: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> the M > 8 tile's q8_1 of x: xq (M, K) float16, the values
    of ``quantize_activations_plain``'s int8 xq, in K's order or, for the
    words form, at ``words_k``; sx_t (K // 32, M rounded up to 16) float32,
    row m's scale of group g at (g, ``sx_slot(m)``), 0 in the slots of rows
    past M."""
    M, K = x.shape
    xq8, sx = quantize_activations_plain(x)
    xq = torch.empty((M, K), dtype=torch.float16, device=x.device)
    cols = torch.arange(K, device=x.device)
    xq[:, words_k(cols) if form == WORDS else cols] = xq8.to(torch.float16)
    sx_t = torch.zeros((K // GROUP, -(-M // 16) * 16), dtype=torch.float32, device=x.device)
    sx_t[:, sx_slot(torch.arange(M, device=x.device))] = sx.t()
    return xq, sx_t


def group_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ integer ``values`` (K, N) with ``scales`` (K // 32,
    N) -> (M, N) in x's type, in the kernel's arithmetic: x quantized, each
    group's integer dot exact (float64 holds it), the groups added in order
    in float32 as acc + float32(p) * (sx * sw)."""
    M, K = x.shape
    N, G = values.shape[1], K // GROUP
    xq, sx = quantize_activations_plain(x)
    xg = xq.double().reshape(M, G, GROUP).transpose(0, 1)        # (G, M, 32)
    sw = scales.float()
    acc = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    # groups whose float64 values and dots are held at once
    chunk = max(1, _PLAIN_CHUNK_BYTES // (8 * N * max(M, GROUP)))
    for g0 in range(0, G, chunk):
        g1 = min(G, g0 + chunk)
        v = values[g0 * GROUP:g1 * GROUP].double().reshape(g1 - g0, GROUP, N)
        p = torch.bmm(xg[g0:g1], v).float()                      # exact
        for g in range(g0, g1):
            acc = acc + p[g - g0] * (sx[:, g:g + 1] * sw[g:g + 1])
    return acc.to(x.dtype)


quant_matmul_int8_plain = group_matmul_plain   # int8 values: the values as stored


def quant_matmul_int8_packed_plain(x: torch.Tensor, qs4: torch.Tensor, scales: torch.Tensor,
                                   off: int = 0) -> torch.Tensor:
    return group_matmul_plain(x, unpack4(qs4) - off, scales)


# --------------------------------------------------------------------------- #
# the kernel's wrappers
# --------------------------------------------------------------------------- #

def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) float32 or bf16 -> (xq int8 (M, K), sx float32 (M, K // 32)):
    the quantizing kernel for CUDA tensors, the plain version for CPU
    tensors; the same bits either way."""
    if x.dim() != 2 or x.shape[1] % GROUP or x.shape[0] < 1:
        raise ValueError(f"quantize_activations: x must be (M, K) with K a multiple of "
                         f"{GROUP}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_activations_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_activations: unsupported device {x.device}")
    if x.dtype not in _X_TYPES:
        raise ValueError(f"quantize_activations: x in {_X_TYPES}, got {x.dtype}")
    x = x.contiguous()
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, K // GROUP), dtype=torch.float32, device=x.device)
    lib = _build.library("quant_matmul_int8")
    with torch.cuda.device(x.device):
        rc = lib.qa_quantize_q8_1(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K,
                                  int(x.dtype == torch.bfloat16), 0,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "quantize_activations")
    quantize_activations.launches += 1
    return xq, sx


def _tile_activations(x: torch.Tensor, form: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``tile_activations_plain`` by the quantizing kernel for CUDA tensors,
    the plain version for CPU tensors; the same bits either way (sx_t's
    padding rows zeroed). A check of the quantizer's tile layouts for tests,
    not a path of the port: the M > 8 entries make this launch inside their
    C entry, so it counts no launch."""
    if x.dim() != 2 or x.shape[1] % GROUP or x.shape[0] < 1 or form not in _FORMS:
        raise ValueError(f"tile_activations: x must be (M, K) with K a multiple of {GROUP} "
                         f"and form one of {tuple(_FORMS)}, got {tuple(x.shape)}, {form}")
    if x.device.type == "cpu":
        return tile_activations_plain(x, form)
    if x.device.type != "cuda" or x.dtype not in _X_TYPES:
        raise ValueError(f"tile_activations: x in {_X_TYPES} on the card, got {x.dtype} on "
                         f"{x.device}")
    x = x.contiguous()
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.float16, device=x.device)
    sx_t = torch.zeros((K // GROUP, -(-M // 16) * 16), dtype=torch.float32, device=x.device)
    lib = _build.library("quant_matmul_int8")
    with torch.cuda.device(x.device):
        rc = lib.qa_quantize_q8_1(x.data_ptr(), xq.data_ptr(), sx_t.data_ptr(), M, K,
                                  int(x.dtype == torch.bfloat16), 2 if form == WORDS else 1,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "tile_activations")
    return xq, sx_t


def _check(name: str, x, q, sc, form: int, off: int) -> None:
    """Shapes and types every device takes."""
    if x.dim() != 2 or q.dim() != 2 or sc.dim() != 2:
        raise ValueError(f"{name}: x, weight and scales are 2-D, got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(sc.shape)}")
    want, per_row = _FORMS[form]
    M, K = x.shape
    if q.dtype != want:
        raise ValueError(f"{name}: weight dtype {q.dtype}, want {want}")
    if K % GROUP or q.shape[0] * per_row != K or tuple(sc.shape) != (K // GROUP, q.shape[1]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, weight {tuple(q.shape)}, "
                         f"scales {tuple(sc.shape)}: want 32-groups of K along the weight's "
                         "rows")
    if off not in (0, 8) or (form == STRIDED and off):
        raise ValueError(f"{name}: off {off}: 0, or 8 for nibbles")


def tile_ring(bm: int, form: int) -> tuple[int, int]:
    """Ring slots and shared memory of the M > 8 tile with ``bm`` rows of x
    a unit, as the kernel's TileShape lays them out: a slot holds xq's box
    (bm rows x 64 values of K, f16), the stage's raw weight rows (64 int8
    rows or 32 nibble-byte rows of 128 columns, or 8 rows of 128 int32
    words), its scales (2 groups x 128 columns, float32 at most), sx (2
    groups x bm rows, float32) and two barriers; as many slots as fit, at
    most TILE_SLOTS (two named barriers a slot, one for each consumer
    warpgroup); 1024 bytes to align."""
    raw = STAGE_K * TILE_N if form == STRIDED else STAGE_K // 2 * TILE_N
    slot = bm * 128 + raw + 2 * TILE_N * 4 + 2 * bm * 4 + 16
    slots = min(TILE_SLOTS, (SMEM_LIMIT - 1024) // slot)
    return slots, slots * slot + 1024


@functools.lru_cache(maxsize=256)
def tile_plan(M: int, N: int, sms: int) -> dict:
    """The persistent M > 8 launch for an (M, N) output: units of ``bm``
    rows of x by 128 weight columns over all of K (no K split: each output
    is one float32 sum in group order, as ggml's numerics fix it). Up to 128
    rows bm is the least of 16, 32, 64 and 128 that holds M; above, 64 or
    128, whichever ends the waves first, counting a unit's stage as bm +
    TILE_FIXED rows of work (the wider on a tie). ``ctas``: one an SM, or one
    a unit where there are fewer; CTA b takes units b, b + ctas, ...; unit u
    is (m tile u % m tiles, n tile u // m tiles): M fastest, so that the
    CTAs at work at once share weight columns and read them from device
    memory about once (``cta_units``)."""
    if M <= _SMALL_M or N < 16 or N % 16 or sms < 1:
        raise ValueError(f"tile_plan: M above {_SMALL_M} and N a multiple of 16, got M={M}, "
                         f"N={N} on {sms} SMs")
    nt = -(-N // TILE_N)
    if M <= TILE_ROWS[-1]:
        bm = next(r for r in TILE_ROWS if r >= M)
    else:
        bm = min((128, 64), key=lambda r: -(-(-(-M // r) * nt) // sms) * (r + TILE_FIXED))
    mt = -(-M // bm)
    return {"bm": bm, "tiles": (mt, nt), "units": mt * nt, "ctas": min(mt * nt, sms)}


def cta_units(plan: dict, b: int) -> list[tuple[int, int]]:
    """The units CTA b of a "wgmma" plan walks, in order, as (m tile, n
    tile)."""
    mt = plan["tiles"][0]
    return [(u % mt, u // mt) for u in range(b, plan["units"], plan["ctas"])]


def launch_plan(name: str, x, q, sc, sms: int) -> dict:
    """The kernel's launch for x (M, K) and a weight (K, N) of one form, from
    shapes, types and addresses alone (no device is touched): which kernel
    (``"small"`` at M <= 8, x quantized inside it; ``"wgmma"`` above, after
    the quantizing launch), its grid, the K split (above 8 rows none), the
    buffers the wrapper allocates by name (shape and type): the float32
    partial sums of a split, or xq (M, K) as float16 values and sx
    transposed (K / 32, M rounded up to 16: whole 16-row blocks, the tile's
    order inside each, ``tile_activations_plain``); and above 8 rows
    ``tile_plan``'s rows a unit, tiles, units and CTAs with ``tile_ring``'s
    slots and shared memory (``cta_units`` lists a CTA's units). Raises for
    x or scales of another type, N not a multiple of 16, and an input that
    is not contiguous or not 16-byte aligned (nothing is copied)."""
    M, K = x.shape
    N = q.shape[1]
    if x.dtype not in _X_TYPES or sc.dtype not in _S_TYPES:
        raise ValueError(f"{name}: the kernel takes x in {_X_TYPES} and scales in "
                         f"{_S_TYPES}, got {x.dtype}, {sc.dtype}")
    if N % 16:
        raise ValueError(f"{name}: the kernel takes N a multiple of 16, got {N}")
    for t in (x, q, sc):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every input must be contiguous, 16-byte aligned "
                             f"and on {x.device}")
    if M <= _SMALL_M:
        ksplit = split_k(M, K, N, sms)
        bufs = {"scratch": ((ksplit, M, N), torch.float32)} if ksplit > 1 else {}
        return {"kernel": "small", "grid": (-(-N // _SMALL_COLS), ksplit), "M": M, "K": K,
                "N": N, "ksplit": ksplit, "buffers": bufs}
    tp = tile_plan(M, N, sms)
    form = next(f for f, (dt, _) in _FORMS.items() if dt == q.dtype)
    ring, smem = tile_ring(tp["bm"], form)
    return {**tp, "kernel": "wgmma", "grid": (tp["ctas"],), "M": M, "K": K, "N": N,
            "ksplit": 1, "ring": ring, "smem": smem,
            "buffers": {"xq": ((M, K), torch.float16),
                        "sx_t": ((K // GROUP, -(-M // 16) * 16), torch.float32)}}


def _launch(name: str, x, q, sc, form: int, off: int) -> torch.Tensor:
    plan = launch_plan(name, x, q, sc, sm_count(x.device))
    M, K, N = plan["M"], plan["K"], plan["N"]
    dev = x.device
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    bufs = {k: torch.empty(shape, dtype=dt, device=dev)
            for k, (shape, dt) in plan["buffers"].items()}

    def ptr(k):
        return bufs[k].data_ptr() if k in bufs else None

    lib = _build.library("quant_matmul_int8")
    with torch.cuda.device(dev):
        rc = lib.qa_quant_matmul_int8(
            x.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), ptr("scratch"),
            ptr("xq"), ptr("sx_t"), M, K, N, int(x.dtype == torch.bfloat16),
            int(sc.dtype == torch.float16), form, off, plan["ksplit"], plan.get("bm", 0),
            plan["grid"][0] if plan["kernel"] == "wgmma" else 0,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, name)
    return out


def run(entry, x, q, sc, form: int, off: int, plain) -> torch.Tensor:
    """``entry``'s kernel for CUDA tensors (counted), ``plain(x, q, sc)``
    for CPU tensors."""
    name = entry.__name__
    _check(name, x, q, sc, form, off)
    if x.device.type == "cpu":
        return plain(x, q, sc)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch(name, x, q, sc, form, off)
    entry.launches += 1
    return out


def quant_matmul_int8(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ (qs (K, N) int8 * scales (K // 32, N)) with q8_1
    activations and exact integer group dots -> (M, N) in x's type."""
    return run(quant_matmul_int8, x, _nd("quant_matmul_int8", qs, 2), scales, STRIDED, 0,
               quant_matmul_int8_plain)


def quant_matmul_int8_stacked(x: torch.Tensor, qs_all: torch.Tensor, sc_all: torch.Tensor,
                              li: int, *, off: int = 0) -> torch.Tensor:
    """``quant_matmul_int8`` over layer ``li`` of int8 values qs_all (L, K,
    N) or nibble bytes (L, K // 2, N) (values nibble - off; off 8 is
    symmetric q4_0), with sc_all (L, K // 32, N); read in place."""
    name = "quant_matmul_int8_stacked"
    q, sc = _layer(name, qs_all, li), _layer(name, sc_all, li)
    if q.dtype == torch.uint8:
        return run(quant_matmul_int8_stacked, x, q, sc, PACKED, off,
                   lambda x_, q_, s_: quant_matmul_int8_packed_plain(x_, q_, s_, off=off))
    return run(quant_matmul_int8_stacked, x, q, sc, STRIDED, off, quant_matmul_int8_plain)


quantize_activations.launches = 0
ENTRIES = (quant_matmul_int8, quant_matmul_int8_stacked)
for _entry in ENTRIES:
    _entry.launches = 0


# --------------------------------------------------------------------------- #
# linear layers over the block dicts
# --------------------------------------------------------------------------- #

def quant_linear_int8(x: torch.Tensor, qw: dict) -> torch.Tensor:
    """x (..., K) @ {"qs", "scales"[, "mins"]} -> (..., N) through the exact
    integer group matmul; the min term on the raw x outside the kernel."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    y = quant_matmul_int8(x2d, qw["qs"], qw["scales"])
    if "mins" in qw:
        y = _with_mins(y, x2d, qw["mins"])
    return y.reshape(*x.shape[:-1], -1)


def quant_linear_int8_stacked(x: torch.Tensor, qw: dict, li: int) -> torch.Tensor:
    """``quant_linear_int8`` over layer ``li`` of a stacked {"qs" | "qs4",
    "scales"[, "mins"]} dict; "qs4" without "mins" is symmetric q4_0 (off
    8)."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    packed = "qs4" in qw
    y = quant_matmul_int8_stacked(x2d, qw["qs4" if packed else "qs"], qw["scales"], li,
                                  off=8 if packed and "mins" not in qw else 0)
    if "mins" in qw:
        y = _with_mins(y, x2d, qw["mins"][int(li)])
    return y.reshape(*x.shape[:-1], -1)
