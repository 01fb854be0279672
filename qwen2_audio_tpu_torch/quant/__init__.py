"""ggml block codecs (codecs.py) and the card-side weight forms built from
them (qparams.py)."""
from qwen2_audio_tpu_torch.quant.codecs import (  # noqa: F401
    QK,
    BLOCK_BYTES,
    quantize,
    dequantize,
    quantize_q4_0,
    quantize_q4_1,
    quantize_q5_0,
    quantize_q5_1,
    quantize_q8_0,
    dequantize_q4_0,
    dequantize_q4_1,
    dequantize_q5_0,
    dequantize_q5_1,
    dequantize_q8_0,
)
