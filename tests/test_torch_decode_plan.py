"""The split-KV decode kernel's launch plan (``ops.flash_decode.decode_plan``)
and its key partition, and the wrapper's refusals: what the CUDA kernel
csrc/flash_decode.cu takes, how it divides a stream's cache rows over CTAs
that fill the card in one wave, and the workspace and ticket counters of
its merge, checked here without a card."""

import pytest
import torch

from qwen2_audio_tpu_torch.ops import flash_decode as tfd

BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8


POOL = [783, 755, 801, 760, 790, 752, 812, 770]   # the 8-slot pool's step


@pytest.mark.parametrize("B,S,positions,splits,stages,with_keys", [
    # the main path: one stream, 28 query heads on 4 KV heads, pos 783;
    # 13 of 16 splits hold keys (at 784 rows, 13 splits: none empty)
    (1, 784, [783], 13, 1, 52),
    (1, 2048, [783], 16, 2, 52),
    (1, 2048, [2047], 16, 2, 64),
    # B 4 at mixed positions: 13 splits a (stream, KV head)
    (4, 784, [17, 63, 64, 783], 13, 1, 4 * (1 + 1 + 2 + 13)),
    # S 8192: 512-row ranges over a ring of 6 bf16 stages
    (1, 8192, [8191], 16, 6, 64),
    # the beam step: 5 streams at 783, 260 CTAs of one 64-row stage each
    (5, 784, [783] * 5, 13, 1, 260),
    # the pool's step: 8 streams at 752-812, 256 CTAs of at most 128 rows
    (8, 2048, POOL, 8, 3, 4 * sum(-(-(p + 1) // 128) for p in POOL)),
])
def test_plan_at_the_main_shapes(B, S, positions, splits, stages, with_keys):
    plan = tfd.decode_plan(B, S, 4, 7, BF)
    assert plan["splits"] == splits and "cluster" not in plan
    assert plan["grid"] == (splits, 4, B) and plan["threads"] == 256
    assert plan["stages"] == stages
    assert plan["ctas_with_keys"](positions) == with_keys


@pytest.mark.parametrize("B,ctas", [(1, None), (5, 260), (8, 256)])
@pytest.mark.parametrize("S", [784, 2048, 8192])
def test_cta_count_fills_one_wave(B, S, ctas):
    """B * 4 KV heads * splits CTAs: at B = 1 at most 16 splits, 13 where
    784 rows are 13 stages; at B = 5 and 8 one wave of the card's 264 slots
    (two CTAs an SM on the tensor-core path): 260 and 256."""
    plan = tfd.decode_plan(B, S, 4, 7, BF)
    n = B * 4 * plan["splits"]
    assert n == (ctas if ctas else 4 * min(16, -(-S // 64)))
    assert n <= 2 * 132 and plan["per_sm"] == 2


def test_main_shape_puts_keys_in_at_least_48_ctas():
    """At B 1, 4 KV heads, pos 783 (today 4 CTAs, one a KV head)."""
    for S in (784, 2048):
        assert tfd.decode_plan(1, S, 4, 7, BF)["ctas_with_keys"]([783]) >= 48


@pytest.mark.parametrize("kv_type,most", [(BF, 6), (F32, 3), (I8, 13)])
def test_stages_fit_shared_memory_and_ring_long_ranges(kv_type, most):
    """The longest range's stages where they fit, else the most that fit
    (at least 3, a ring); never more than a block's shared memory, and
    enough for the warps' partial sums (int8 at least 2)."""
    for S in (1, 64, 65, 784, 2048, 8192, 32768):
        plan = tfd.decode_plan(1, S, 4, 7, kv_type)
        lo, hi = plan["ranges"](S - 1)[0]
        need = -(-(hi - lo) // 64)
        assert plan["smem"] <= 232448
        assert plan["stages"] == min(most, max(need, 2 if kv_type == I8 else 1))
        assert plan["stages"] >= 3 or need <= plan["stages"]


@pytest.mark.parametrize("B,Hkv,n_sm,splits", [
    (1, 4, 132, 16), (2, 4, 132, 16), (3, 4, 132, 16), (4, 4, 132, 16), (8, 4, 132, 8),
    (33, 4, 132, 2), (1, 4, 114, 16), (1, 8, 132, 16), (1, 32, 132, 8), (8, 4, 114, 7)])
def test_splits_from_batch_heads_and_sm_count(B, Hkv, n_sm, splits):
    """The most splits, at most 16, whose B * Hkv * splits CTAs fit one
    wave of the card's slots (two CTAs an SM for a bf16 query over a bf16
    cache), whether or not any group of them could be co-resident."""
    plan = tfd.decode_plan(B, 8192, Hkv, 4, BF, n_sm)
    assert plan["splits"] == splits
    assert B * Hkv * splits <= 2 * n_sm
    assert splits == 16 or B * Hkv * (splits + 1) > 2 * n_sm


@pytest.mark.parametrize("q_type,kv_type,per_sm", [
    (BF, BF, 2), (BF, I8, 2), (BF, F32, 1), (F32, F32, 1), (F32, BF, 1), (F32, I8, 1)])
def test_slots_by_path(q_type, kv_type, per_sm):
    """A bf16 query over a bf16 or int8 cache takes the tensor-core path (two
    CTAs an SM, each within half an SM's shared memory once the grid
    outgrows the SMs); the float32 FMA path one CTA an SM."""
    plan = tfd.decode_plan(5, 784, 4, 7, kv_type, 132, q_type)
    assert plan["per_sm"] == per_sm == (2 if tfd.tensor_path(q_type, kv_type) else 1)
    assert plan["splits"] == min(13, 132 * per_sm // 20)
    share = tfd._SMEM_TWO if per_sm == 2 else tfd._SMEM_MAX
    assert plan["smem"] <= share


@pytest.mark.parametrize("S,splits", [(1, 1), (63, 1), (64, 1), (65, 2), (129, 3),
                                      (784, 13), (1024, 16)])
def test_splits_bounded_by_the_stages_of_a_full_cache(S, splits):
    assert tfd.decode_plan(1, S, 4, 7, BF)["splits"] == splits


def test_plan_depends_on_shapes_only():
    """The same plan whatever the positions: it is made before pos is
    known, and the kernel reads pos on the device."""
    a = tfd.decode_plan(1, 2048, 4, 7, I8)
    b = tfd.decode_plan(1, 2048, 4, 7, I8)
    assert a is b   # cached: the wrapper asks on every call
    for B, S in ((5, 784), (8, 2048)):   # a bf16 query on a card of 132 SMs, by default
        plans = (tfd.decode_plan(B, S, 4, 7, BF), tfd.decode_plan(B, S, 4, 7, BF, 132, BF))
        fixed = [{k: v for k, v in p.items() if not callable(v)} for p in plans]
        assert fixed[0] == fixed[1]


@pytest.mark.parametrize("B,S,kv_type", [(1, 784, BF), (1, 2048, I8), (5, 784, BF),
                                         (5, 784, I8), (8, 2048, BF), (8, 2048, I8)])
def test_workspace_and_tickets(B, S, kv_type):
    """With more than one split: a partial of each CTA in the workspace (its
    8 row maxima, 8 row sums and 8 x 128 P V sums, float32) and a ticket
    counter per (stream, KV head), within one ticket array."""
    plan = tfd.decode_plan(B, S, 4, 7, kv_type)
    ctas = plan["splits"] * 4 * B
    assert plan["splits"] > 1
    assert plan["workspace"] == ctas * (2 * 8 + 8 * 128) * 4
    assert plan["tickets"] == B * 4 <= 4096


def test_one_split_needs_no_workspace():
    plan = tfd.decode_plan(1, 64, 4, 7, BF)
    assert plan["splits"] == 1 and plan["workspace"] == 0 and plan["tickets"] == 0


def test_ticket_arrays_are_per_stream_and_capture(monkeypatch):
    """The kernel's counters live in ``quant_matmul.ticket_array(...,
    "flash_decode")``: one array per stream and per graph capture, none
    shared with another kernel's. Checked with the capture-id query stubbed
    (it needs the card)."""
    import ctypes

    from qwen2_audio_tpu_torch.ops import quant_matmul as tqm
    capture = {"id": 0}

    class Lib:
        @staticmethod
        def qa_stream_capture_id(stream, out):
            ctypes.cast(out, ctypes.POINTER(ctypes.c_ulonglong)).contents.value = capture["id"]
            return 0

    monkeypatch.setattr(tqm._build, "library", lambda name: Lib)
    monkeypatch.setattr(tqm, "_tickets", {})
    cpu = torch.device("cpu")
    a = tqm.ticket_array(cpu, 1, "flash_decode")
    assert a is tqm.ticket_array(cpu, 1, "flash_decode")
    assert int(a.count_nonzero()) == 0 and a.dtype == torch.int32
    assert tqm.ticket_array(cpu, 2, "flash_decode") is not a        # another stream
    assert tqm.ticket_array(cpu, 1) is not a                        # another kernel
    capture["id"] = 7
    assert tqm.ticket_array(cpu, 1, "flash_decode") is not a        # a graph capture


def _check_partition(S, pos, splits):
    ranges = tfd.split_ranges(pos, S, splits)
    assert len(ranges) == splits
    n = min(pos + 1, S)
    covered = torch.zeros(S, dtype=torch.int64)
    for lo, hi in ranges:
        assert 0 <= lo <= hi <= n
        assert lo % 64 == 0 or lo == hi
        covered[lo:hi] += 1
    # every row 0..pos in exactly one range, no row past pos in any
    assert bool((covered[:n] == 1).all()) and int(covered[n:].sum()) == 0
    # balanced: the longest split (the CTA every other waits for) as short
    # in 64-row stages as any partition can make it; a stream of <= 64 rows
    # in one split
    stages = [-(-(hi - lo) // 64) for lo, hi in ranges]
    assert max(stages) == -(-n // (64 * splits))
    if n <= 64:
        assert ranges[0] == (0, n)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 784])
def test_partition_covers_every_row_once_at_every_position(S):
    for splits in {tfd.decode_plan(1, S, 4, 7, BF)["splits"], 8, 16}:
        for pos in range(S):
            _check_partition(S, pos, splits)


@pytest.mark.parametrize("B,S", [(5, 784), (8, 2048), (4, 784)])
def test_partition_at_every_position_for_the_batch_plans(B, S):
    """The beam's and the pool's split counts (13 and 8): every visible row
    in exactly one split at every position."""
    splits = tfd.decode_plan(B, S, 4, 7, BF)["splits"]
    assert splits in (8, 13)
    for pos in range(S):
        _check_partition(S, pos, splits)


@pytest.mark.parametrize("S", [2048, 8192])
def test_partition_at_sampled_positions(S):
    g = torch.Generator().manual_seed(S)
    sampled = torch.randint(0, S, (200,), generator=g).tolist()
    edges = [p + e for k in range(1, S // 64 + 1) for p in (64 * k - 1,) for e in (-1, 0, 1)]
    for pos in sorted(set(sampled + [0, S - 1] + [p for p in edges if 0 <= p < S])):
        for splits in (tfd.decode_plan(1, S, 4, 7, BF)["splits"], 8):
            _check_partition(S, pos, splits)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tfd.decode_plan(1, 784, 4, 9, BF)
    with pytest.raises(ValueError):
        tfd.decode_plan(1, 784, 4, 7, torch.float16)
    with pytest.raises(ValueError):
        tfd.decode_plan(1, 784, 4, 7, BF, 132, torch.float16)


def _inputs(kv_type=BF, d=128, Hq=28):
    q = torch.zeros(1, Hq, d, dtype=BF)
    k = torch.zeros(1, 64, 4, d, dtype=kv_type)
    pos = torch.tensor([10], dtype=torch.int32)
    scales = (torch.zeros(1, 64, 4), torch.zeros(1, 64, 4)) if kv_type == I8 else (None, None)
    return q, k, k.clone(), pos, scales


def test_wrapper_refusals():
    """What the wrapper raises for on the card, checked on CPU tensors."""
    q, k, v, pos, _ = _inputs()
    tfd._refuse("flash_decode", q, k, v, pos)          # taken
    q64, k64, v64, _, _ = _inputs(d=64)
    with pytest.raises(ValueError, match="d = 128"):
        tfd._refuse("flash_decode", q64, k64, v64, pos)
    q36 = torch.zeros(1, 36, 128, dtype=BF)             # g = 9
    with pytest.raises(ValueError, match="at most 8"):
        tfd._refuse("flash_decode", q36, k, v, pos)
    kt = torch.zeros(1, 4, 64, 128, dtype=BF).transpose(1, 2)   # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tfd._refuse("flash_decode", q, kt, kt, pos)
    buf = torch.zeros(1 * 64 * 4 * 128 + 1, dtype=BF)
    km = buf[1:].view(1, 64, 4, 128)                     # 2 bytes off the 16-byte grid
    with pytest.raises(ValueError, match="aligned"):
        tfd._refuse("flash_decode", q, km, v, pos)
    with pytest.raises(ValueError, match="int32"):
        tfd._refuse("flash_decode", q, k, v, pos.long())
    qi, ki, vi, _, (ks, vs) = _inputs(I8)
    tfd._refuse("flash_decode_quant", qi, ki, vi, pos, ks, vs)
    with pytest.raises(ValueError, match="float32"):
        tfd._refuse("flash_decode_quant", qi, ki, vi, pos, ks.double(), vs)
    with pytest.raises(ValueError, match="int8 with scales"):
        tfd._refuse("flash_decode_quant", qi, ki, vi, pos)


def test_scales_need_only_float_alignment():
    """A layer's scales start where the layer before ends: at Hkv 2 and an
    odd capacity (2 x 39 floats a layer) on the 4-byte grid, off the 16-byte
    one. The kernels read and write the scales a float at a time, so the
    wrappers take them; the int8 values keep their 16-byte rule."""
    qi = torch.zeros(1, 14, 128, dtype=BF)
    kq = torch.zeros(2, 1, 39, 2, 128, dtype=I8)
    ks = torch.zeros(2, 1, 39, 2)
    assert ks[1].data_ptr() % 16 and not ks[1].data_ptr() % 4
    tfd._refuse("flash_decode_quant", qi, kq[1], kq[1], torch.tensor([10], dtype=torch.int32),
                ks[1], ks[1])
    buf = torch.zeros(39 * 2 * 128 + 4, dtype=I8)
    km = buf[4:].view(1, 39, 2, 128)                     # 4 bytes off the 16-byte grid
    with pytest.raises(ValueError, match="aligned"):
        tfd._refuse("flash_decode_quant", qi, km, km, torch.tensor([10], dtype=torch.int32),
                    ks[1], ks[1])


def test_kv_append_quant_refuses_bad_shapes():
    k = torch.zeros(1, 3, 4, 128)
    c = [torch.zeros(1, 16, 4, 128, dtype=I8), torch.zeros(1, 16, 4)]
    with pytest.raises(ValueError):
        tfd.kv_append_quant(k, torch.zeros(1, 3, 2, 128), *c, *c, 0)
    with pytest.raises(ValueError):
        tfd.kv_append_quant(k, k, c[0], torch.zeros(1, 16, 3), *c, 0)
    m = k.to("meta")
    with pytest.raises(ValueError):
        tfd.kv_append_quant(m, m, *(t.to("meta") for t in c + c), 0)
