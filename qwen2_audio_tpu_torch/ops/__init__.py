"""Hand-written CUDA kernels for Hopper (csrc/*.cu) with their plain PyTorch
versions. Each wrapper runs its kernel for CUDA tensors and its plain
version for CPU tensors, and counts its launches in ``<wrapper>.launches``;
so does the w8a8 product's library call (``linear.int8_matmul``).
"""


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches, by name: the objects
    whose ``launches`` a run sets to 0 and reads, and whose counts a CUDA
    graph adds again at each replay (ops/graphs.py)."""
    from qwen2_audio_tpu_torch.ops import (fa_variants, flash_attention, flash_decode,
                                           fused_mlp, linear, mel_kernel, quant_matmul,
                                           quant_matmul_int8, quant_matmul_q4b)
    wrappers = (mel_kernel.mel_frames, flash_attention.attention_single,
                flash_attention.attention_blockwise, flash_attention.attention_causal,
                fa_variants.attention_lite, fa_variants.flash_attention_nopad,
                flash_decode.flash_decode, flash_decode.flash_decode_quant,
                flash_decode.kv_append_quant, quant_matmul_int8.quantize_activations,
                *quant_matmul.ENTRIES, *fused_mlp.ENTRIES, *quant_matmul_int8.ENTRIES,
                *quant_matmul_q4b.ENTRIES, linear.int8_matmul)
    return {"mel_log_frames" if w is mel_kernel.mel_frames else w.__name__: w
            for w in wrappers}
