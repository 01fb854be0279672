"""qwen2_audio_tpu_torch — the PyTorch/CUDA port of qwen2_audio_tpu for an
NVIDIA H100 (sm_90a). It does everything the JAX package does; the JAX
package stays the reference its tests are held to. This package imports
nothing of it and nothing of JAX.

- ``audio``    — wav/mp3 input, capture, VAD, mel filterbank, log-mel
- ``io``       — ggml-model.bin reader/writer, HF checkpoints, quantized
                 export, the parameter cache
- ``quant``    — ggml block codecs and the card-side weight forms
- ``ops``      — the hand-written Hopper kernels (csrc/*.cu, built with nvcc
                 at first use, loaded with ctypes) beside their plain
                 versions; CUDA graphs of the hot calls
- ``models``   — the Qwen2-Audio encoder tower, the Qwen2 text decoder, DTW
- ``runtime``  — whisper.cpp-style context/state and ``full`` (encode, then
                 greedy, beam or speculative decoding), serving, and remote
                 offload over TCP (``RpcServer``, ``RemoteWhisperContext``)
- ``parallel`` — tensor and data parallelism on torch.distributed
- ``training`` — the training step, data, checkpoints, fine-tuning
- ``capi``     — every whisper_* function of the C API; ``native_src/`` the
                 C shim that embeds Python to serve it to C callers
- ``cli``      — the command line (``python -m qwen2_audio_tpu_torch.cli``)
- ``native``   — bindings of the native host library (native/)
- ``utils``    — logging, timings, text helpers, the mul_mat bench, and the
                 debug tools: a deadline on device work (watchdog), the
                 torch.profiler trace (profiling), per-node encoder diffs
                 (inspect_graph)

Float32 matrix products and convolutions are kept in full float32 on the
card: importing the package turns TF32 off for cuBLAS and cuDNN, since the
JAX reference computes those in float32 (HIGHEST) and the mel clamp moves
with TF32 rounding.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from qwen2_audio_tpu_torch.config import (  # noqa: E402,F401
    GGMLFType,
    GGMLType,
    Qwen2DecoderConfig,
    WhisperHParams,
)
