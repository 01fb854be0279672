"""The launch plans of the attention kernels (csrc/attention_single.cu), from
shapes, types, strides and addresses alone: which kernel a call takes, its
tiles, grid and launch order, the K/V tensor maps' token extent, and what is
refused rather than copied. The kernels themselves run only on the card
(tests/test_torch_cuda.py); these need no device."""

import pytest
import torch

from qwen2_audio_tpu_torch.ops import flash_attention as fa


def _heads(B, H, Hkv, Tq, Tk, d, dtype=torch.bfloat16, fused=False):
    """q (B, H, Tq, d), k/v (B, Hkv, Tk, d); ``fused``: head views of one
    (B, T, 3 H d) projection output, the encoder's layout."""
    if fused:
        qkv = torch.zeros(B, Tq, 3 * H * d, dtype=dtype)
        return tuple(x.unflatten(-1, (H, d)).transpose(1, 2) for x in qkv.chunk(3, -1))
    return (torch.zeros(B, H, Tq, d, dtype=dtype), torch.zeros(B, Hkv, Tk, d, dtype=dtype),
            torch.zeros(B, Hkv, Tk, d, dtype=dtype))


def test_encoder_shape_takes_240_ctas_of_the_wgmma_tile():
    q, k, v = _heads(1, 20, 20, 1500, 1500, 64, fused=True)
    plan = fa.launch_plan("qa_attention_single", q, k, v, 1500)
    assert plan["kernel"] == "wgmma" and plan["threads"] == 384
    assert (plan["block_q"], plan["block_k"]) == (128, 128)
    assert plan["grid"] == (20, 12, 1) and 20 * 12 == 240
    assert plan["tiles"] == tuple(range(12))            # no order needed
    assert plan["chunks"] == (12,) * 12                 # 1500 keys: 11 x 128 + 92
    assert plan["kv_extent"] == 1500 and not plan["opts"]


def test_prefill_shape_takes_168_ctas_heaviest_first():
    q, k, v = _heads(1, 28, 4, 752, 752, 128)
    plan = fa.launch_plan("qa_attention_causal", q, k, v, 752, causal=True,
                          sm_scale=128 ** -0.5)
    assert plan["kernel"] == "wgmma" and plan["grid"] == (28, 6, 1)
    assert 28 * 6 == 168
    assert plan["tiles"] == (5, 4, 3, 2, 1, 0)          # the last query tile first
    assert plan["chunks"] == (6, 5, 4, 3, 2, 1)         # stopped at the diagonal
    assert list(plan["chunks"]) == sorted(plan["chunks"], reverse=True)
    assert not plan["opts"]          # the causal kernel always scales


@pytest.mark.parametrize("causal,B,H,T", [(False, 1, 20, 1500), (True, 1, 28, 752),
                                           (False, 2, 14, 129), (True, 2, 7, 300)])
def test_every_unit_taken_once_heaviest_first(causal, B, H, T):
    """Block (x, y) of the bf16 tile's grid takes batch x head x and the
    query tile ``tiles[y]``: every (batch x head, query tile) unit exactly
    once; causal, tile y's key chunks never grow with y, so the blocks the
    hardware hands out first are the heaviest."""
    q, k, v = _heads(B, H, H, T, T, 128 if causal else 64)
    plan = fa.launch_plan("t", q, k, v, T, causal=causal, sm_scale=0.5)
    gx, gy, gz = plan["grid"]
    units = [(x, plan["tiles"][y]) for y in range(gy) for x in range(gx)]
    n_tiles = -(-T // 128)
    assert gz == 1 and sorted(units) == [(bh, t) for bh in range(B * H) for t in range(n_tiles)]
    work = [plan["chunks"][y] for y in range(gy)]
    assert work == sorted(work, reverse=True)
    if causal:
        assert work[0] == n_tiles and work[-1] == 1


@pytest.mark.parametrize("causal,T,kv_valid,chunks", [
    (False, 1500, 1, (1,) * 12),
    (False, 300, 237, (2, 2, 2)),
    (False, 129, 128, (1, 1)),
    (False, 129, 129, (2, 2)),
    (True, 752, 300, (3, 3, 3, 3, 2, 1)),
    (True, 129, 77, (1, 1)),
    (True, 1, 1, (1,)),
])
def test_kv_maps_end_at_kv_valid(causal, T, kv_valid, chunks):
    """The K/V maps' token extent is kv_valid, so TMA zero-fills the ragged
    tail and a NaN there is never read; the key loop covers kv_valid only."""
    q, k, v = _heads(2, 14, 2, T, T, 128)
    plan = fa.launch_plan("t", q, k, v, kv_valid, causal=causal, sm_scale=0.5)
    assert plan["kv_extent"] == kv_valid
    assert plan["chunks"] == chunks
    assert plan["grid"] == (2 * 14, -(-T // 128), 1)


def test_query_and_key_lengths_differ():
    q, _, _ = _heads(2, 4, 4, 65, 65, 64)
    _, k, v = _heads(2, 4, 4, 1, 1500, 64)
    plan = fa.launch_plan("t", q, k, v, 1400)
    assert plan["grid"] == (8, 1, 1) and plan["chunks"] == (11,)


@pytest.mark.parametrize("option_bits,sm_scale,opts", [
    (0, 1.0, False), (fa.EXP2, 1.0, True), (fa.PEXP16, 1.0, True),
    (fa.LITE, 1.0, True), (0, 0.125, True)])
def test_options_take_the_option_instantiation(option_bits, sm_scale, opts):
    q, k, v = _heads(1, 20, 20, 1500, 1500, 64, fused=True)
    plan = fa.launch_plan("t", q, k, v, 1500, sm_scale=sm_scale, option_bits=option_bits)
    assert plan["opts"] is opts


@pytest.mark.parametrize("causal,d,kernel,grid", [
    (False, 64, "f32", (12, 20, 1)),          # 128 rows a block
    (False, 128, "f32_causal", (24, 20, 1)),  # 64 rows a block, the mask off
    (True, 128, "f32_causal", (24, 20, 1)),
])
def test_float32_keeps_its_kernels(causal, d, kernel, grid):
    q, k, v = _heads(1, 20, 20, 1500, 1500, d, dtype=torch.float32)
    plan = fa.launch_plan("t", q, k, v, 1500, causal=causal)
    assert plan["kernel"] == kernel and plan["grid"] == grid
    assert plan["kv_extent"] == 1500


def test_misaligned_strides_are_refused_not_copied():
    q, k, v = _heads(1, 4, 4, 100, 100, 64)
    # a token stride of 68 values: 136 bytes, not a multiple of 16
    wide = torch.zeros(1, 4, 100, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="strides divisible by 8"):
        fa.launch_plan("t", q, wide, v, 100)
    # a base 2 bytes past a 16-byte boundary
    off = torch.zeros(1 * 4 * 100 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 4, 100, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa.launch_plan("t", q, k, off, 100)
    # d not contiguous
    with pytest.raises(ValueError, match="unit last stride"):
        fa.launch_plan("t", torch.zeros(1, 4, 100, 128, dtype=torch.bfloat16)[..., ::2],
                       k, v, 100)


@pytest.mark.parametrize("dtype,d,causal", [
    (torch.float16, 64, False), (torch.bfloat16, 96, False), (torch.bfloat16, 64, True)])
def test_other_types_and_head_dims_are_refused(dtype, d, causal):
    q, k, v = _heads(1, 2, 2, 64, 64, d, dtype=dtype)
    with pytest.raises(ValueError, match="head dims"):
        fa.launch_plan("t", q, k, v, 64, causal=causal)


def test_mixed_types_are_refused():
    q, k, v = _heads(1, 2, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        fa.launch_plan("t", q, k.float(), v, 64)
