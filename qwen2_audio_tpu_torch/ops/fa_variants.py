"""The encoder attention's variants and their dispatch: the lite and the
unpadded one-shot entries, the JAX entry ``flash_attention`` (which picks
one-shot, lite, blockwise or causal), the encoder's ``flash_attention_encoder``
and the process switch that stands for the JAX package's ``QA_FA_*`` gates.
The kernels' entries and plain versions are in ops/flash_attention.py.

Replaces two TPU kernels of qwen2_audio_tpu/ops/fa_variants.py:

    attention_lite         _attn_kernel_single_lite (lite_call)
    flash_attention_nopad  _attn_kernel_single at the unpadded head dim

On the TPU the lite kernel moved the softmax's bookkeeping into the lanes
that pad d = 64 to 128: Q pre-scaled in its own type with 1.0 in pad column
d, K carrying the key bias (0, or -1e30 past kv_valid) there, V carrying
1.0, so that Q K^T came out scaled and masked and column d of P V was the
row sum. What it computes, and what ``attention_lite`` computes: Q rounded
to its type after the multiply by the scale rounded to its type; p against
the row's max, exactly 0 for keys at or past kv_valid; l the float32 sum of
p after p's cast to V's type; out = (P V) / l, l = 0 -> 1. On the card it is
the one-shot kernel of csrc/attention_single.cu under its lite flag (the
row sum of the rounded p), reading d = 64 heads by stride: no pad column
exists, and keys past kv_valid are never read, so a NaN there cannot reach
the output (on the TPU, 0 * NaN would).

The unpadded TPU kernel ran the one-shot body on d = 64 blocks, K and V
zero-padded along the sequence and masked at kv_valid = Tk. The port's
one-shot kernel reads unpadded heads by stride anyway, so
``flash_attention_nopad`` is an entry over it with sm_scale and exp2,
counted by its own launch counter.

On the TPU both variants, exp2 and pexp16 lost or tied end to end
(qwen2_audio_tpu/ops/fa_variants.py:11-27); here they are off unless
``set_attention_variants`` turns them on. The JAX package's interpret-mode
default (lite on off the TPU) is not copied.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from qwen2_audio_tpu_torch.ops import flash_attention as fa

_LANES = 128          # the TPU's lane width: JAX's dispatch rules are in it


@dataclasses.dataclass(frozen=True)
class AttentionVariants:
    """The encoder attention's path: ``single`` the one-shot kernel (off:
    the blockwise kernel), ``lite`` and ``nopad`` the variants, ``exp2`` the
    base-2 softmax, ``pexp16`` the bf16-domain exponential."""
    single: bool = True
    lite: bool = False
    nopad: bool = False
    exp2: bool = False
    pexp16: bool = False


_VARIANTS = AttentionVariants()


def set_attention_variants(single: bool = True, lite: bool = False, nopad: bool = False,
                           exp2: bool = False, pexp16: bool = False) -> None:
    """Set the encoder attention's path for the process (the JAX gates
    QA_FA_SINGLE, QA_FA_LITE, QA_FA_NOPAD, QA_FA_EXP2, QA_FA_PEXP16); the
    defaults are the JAX package's on its chip: one-shot, every variant
    off."""
    global _VARIANTS
    _VARIANTS = AttentionVariants(bool(single), bool(lite), bool(nopad), bool(exp2),
                                  bool(pexp16))


def attention_variants() -> AttentionVariants:
    return _VARIANTS


def attention_lite_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         sm_scale: float, kv_valid: int | None = None,
                         exp2: bool = False) -> torch.Tensor:
    """The lite kernel's function: q (B, H, Tq, d), k/v (B, Hkv, Tk, d) ->
    (B, H, Tq, d) in q's type. Keys at or past kv_valid are left out, as
    their p is exactly 0 on the TPU."""
    q = q * torch.tensor(sm_scale, dtype=q.dtype).item()
    return fa.attention_single_plain(q, k, v, kv_valid, exp2=exp2, lite=True)


def attention_lite(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   sm_scale: float, kv_valid: int | None = None,
                   exp2: bool = False) -> torch.Tensor:
    """The lite one-shot attention; shapes and layouts as
    ``flash_attention.attention_single``. Runs the CUDA kernel for CUDA
    tensors and the plain version for CPU tensors."""
    kv_valid = fa._check("attention_lite", q, k, v, kv_valid)
    qs = q * torch.tensor(sm_scale, dtype=q.dtype).item() if sm_scale != 1.0 else q
    return fa.counted(attention_lite, lambda: fa.attention_single_plain(
        qs, k, v, kv_valid, exp2=exp2, lite=True), qs, k, v, kv_valid, 1.0,
        fa.flags(exp2=exp2, lite=True))


attention_lite.launches = 0


def flash_attention_nopad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          sm_scale: float, exp2: bool = False) -> torch.Tensor:
    """One-shot attention over unpadded heads, every key valid:
    softmax(sm_scale * Q K^T) V, q (B, H, Tq, d), k/v (B, Hkv, Tk, d). Runs
    the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors."""
    kv_valid = fa._check("flash_attention_nopad", q, k, v, None)
    return fa.counted(flash_attention_nopad, lambda: fa.attention_single_plain(
        q, k, v, kv_valid, sm_scale=sm_scale, exp2=exp2), q, k, v, kv_valid, sm_scale,
        fa.flags(exp2=exp2))


flash_attention_nopad.launches = 0


def _key_tile(block_k: int, Tk: int) -> int:
    """The JAX entry's key tile: block_k, at most Tk's next power of two
    (and at least 128)."""
    return min(block_k, max(_LANES, 1 << (Tk - 1).bit_length()))


def dispatch(Tk: int, d: int, *, causal: bool, block_k: int, single: bool,
             lite: bool) -> str:
    """Which TPU kernel the JAX ``flash_attention`` runs for these
    arguments: "lite", "single", "causal" or "blockwise". One-shot needs the
    whole (padded) key sequence in one key tile, lite also a head dim that
    the TPU pads to 128 lanes."""
    block_k = _key_tile(block_k, Tk)
    one_tile = Tk + (-Tk % block_k) == block_k
    if single and lite and not causal and one_tile and d % _LANES:
        return "lite"
    if single and not causal and one_tile:
        return "single"
    return "causal" if causal else "blockwise"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = False, kv_valid: int | None = None,
                    block_q: int = 256, block_k: int = 512, single: bool = False,
                    lite: bool = False, exp2: bool = False, pexp16: bool = False
                    ) -> torch.Tensor:
    """O = softmax(sm_scale * Q K^T) V, q (B, Hq, Tq, d), k/v (B, Hkv, Tk, d)
    -> (B, Hq, Tq, d): the JAX entry's signature and dispatch (``dispatch``).
    ``block_k`` chooses the path as in JAX and sets the blockwise plain
    version's key tiles, not a CUDA tile. ``block_q`` is ignored: the JAX
    entry only pads Tq to it. ``exp2`` treats the scaled scores as
    log2-domain logits; ``pexp16`` applies on the one-shot path only, as in
    JAX."""
    if block_k < 1:
        raise ValueError(f"flash_attention: block_k {block_k}")
    path = dispatch(k.shape[2], q.shape[-1], causal=causal, block_k=block_k,
                    single=single, lite=lite)
    if path == "lite":
        return attention_lite(q, k, v, sm_scale=sm_scale, kv_valid=kv_valid, exp2=exp2)
    if path == "single":
        return fa.attention_single(q, k, v, kv_valid, sm_scale=sm_scale, exp2=exp2,
                                   pexp16=pexp16)
    if path == "causal":
        return fa.attention_causal(q, k, v, sm_scale, kv_valid, exp2=exp2)
    return fa.attention_blockwise(q, k, v, sm_scale, kv_valid, exp2=exp2,
                                  block_k=_key_tile(block_k, k.shape[2]))


def flash_attention_encoder(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """Encoder-layer entry over merged-head activations (B, T, D), Q
    pre-scaled, through the path that ``set_attention_variants`` picks, as
    the JAX entry does from its ``QA_FA_*`` gates: the one-shot kernel by
    default, else lite, the unpadded entry, the blockwise kernel (single
    off), with exp2 and pexp16 where set."""
    var = _VARIANTS
    q = fa.prescale(q, n_head, var.exp2)
    if var.nopad:
        attend = functools.partial(flash_attention_nopad, sm_scale=1.0, exp2=var.exp2)
    else:
        T = q.shape[1]
        attend = functools.partial(
            flash_attention, sm_scale=1.0, block_k=max(_LANES, T + (-T % _LANES)),
            single=var.single, lite=var.lite, exp2=var.exp2, pexp16=var.pexp16)
    return fa._merged_heads(attend, q, k, v, n_head)
