// One-launch SwiGLU MLP over ggml block weights for Hopper (sm_90a), fast
// mode at 9 <= M <= 64 rows (a speculative verify, a pool's verify), plain
// C interface for ctypes: qa_fused_mlp_rows, with qa_fused_mlp's arguments
// (bi and fast are ignored).
//
// Replaces the TPU kernel _swiglu_kernel of qwen2_audio_tpu/ops/fused_mlp.py
// at these rows, with fused_mlp.cu (M <= 8 and the exact mode): this source
// holds the instantiations of swiglu_coop_kernel (swiglu_coop.cuh) with 2, 4
// or 8 n-tiles of 8 rows, so that nvcc builds the two sources in parallel.
//
// What bounds it: the weight bytes (0.065 ms for a q8_0 layer of the 7B
// tower at 3.35 TB/s) against 2 M 3 K I operations on the tensor cores (26
// GFLOP at 64 rows, 0.026 ms at the bf16 peak); every weight value is
// dequantized once for all rows. The design: fused_mlp.cu.

#include "swiglu_coop.cuh"

extern "C" int qa_fused_mlp_rows(const void* x, const void* gq, const void* gs,
                                 const void* gm, const void* uq, const void* us,
                                 const void* um, const void* dq, const void* ds,
                                 const void* dm, void* out, void* scratch, void* partial,
                                 void* tickets, int M, int K, int I, int D, long long ld_gu,
                                 int bi, const int* plan, int group, int x_bf16, int gu_s_f16,
                                 int dn_s_f16, int packed, int off, int fast, void* stream) {
  (void)bi;
  (void)fast;
  CoopArgs a;
  if (M <= 8 || !coop_args(a, x, gq, gs, gm, uq, us, um, dq, ds, dm, out, scratch, partial,
                           tickets, M, K, I, D, ld_gu, plan, group, x_bf16, gu_s_f16,
                           dn_s_f16, packed, off))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mins = gm != nullptr;
  if (M <= 16) return (int)coop_launch<2>(a, packed != 0, mins, st);
  if (M <= 32) return (int)coop_launch<4>(a, packed != 0, mins, st);
  return (int)coop_launch<8>(a, packed != 0, mins, st);
}
