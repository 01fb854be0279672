// One-launch SwiGLU MLP over ggml block weights for Hopper (sm_90a), plain C
// interface for ctypes: qa_fused_mlp.
//
// Replaces the TPU kernel _swiglu_kernel of qwen2_audio_tpu/ops/fused_mlp.py
// (behind fused_mlp_stacked, fused_mlp_m_stacked, fused_mlp4_stacked,
// fused_mlp4_sym_stacked and fused_mlp_split_stacked).
//
// What it computes, for M <= 64 rows of x (a decode step):
//   g = x @ Wg, u = x @ Wu                      float32 sums over K
//   gated = g * sigmoid(g) * u                  float32
//   y = gated @ Wd                              float32 sums over I, cast to x's type
// with each weight dequantized in one of four ways (group g values a scale):
//   strided    w = float(int8) * s              group 32 or 16
//   strided_m  w = float(int8) * s + m
//   packed     w = (nibble - 8) * s             group 32
//   packed_m   w = nibble * s + m
// exact mode: every product in float32. fast mode: x and each w (q * s + m as a
// whole) rounded once to bf16, and gated rounded to bf16 before the down
// product. Wg and Wu are the halves of one fused (K, 2 I) array or two (K, I)
// arrays: the kernel takes a gate pointer, an up pointer and one row stride.
//
// What bounds it: the weight bytes, at every M it takes. A q8_0 layer of the
// 7B tower (K = D = 3584, I = 18944) is 203.7 MB of int8 and 12.7 MB of f16
// scales, 0.065 ms at 3.35 TB/s; packed symmetric q4_0 114.6 MB, 0.034 ms. The
// (M, I) intermediate never reaches device memory.
// - The TPU grid walks I in order and carries the (M, D) sum in scratch. Here
//   blocks run in parallel and nothing carries over: a block owns a slice of
//   I. For each 64 columns of it, it streams the gate and up columns over all
//   of K (lanes 0-15 of a warp own 4 gate columns each, lanes 16-31 the same 4
//   up columns, so one warp reads both halves of a row; the block's 4 warps
//   share K and meet in shared memory in a fixed order), forms the 64 gated
//   values per row in shared memory, then streams its 64 rows of Wd (a warp
//   reads 128 contiguous bytes of a row) into its own float32 partial (M, D).
// - The partials are summed across slices in slice order by
//   reduce_partials_kernel: no float atomics, so a result repeats bit for
//   bit. At M = 1 and I = 18944 there are 296 slices of 64 columns (4.2 MB of
//   partials); the wrapper widens the slices as M grows to bound the scratch.
// - More than 8 rows are taken 8 at a time, and each pass streams the block's
//   weights again: right at M <= 64, but made for M <= 8.
// I must be a multiple of 32, K of 32, D of 16 (the wrapper checks).

#include "qmm_common.cuh"

namespace {

using namespace qa;

constexpr int kTile = 64;    // columns of I per pass
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Weight {              // one dequantizing operand
  const uint8_t* q;
  const void* s;
  const float* m;            // nullptr unless the flavour has mins
};

template <typename XT, bool PACKED, bool MINS, int MT>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const XT* __restrict__ x, Weight gate, Weight up, long long ld_gu,
              int gu_s_f16, Weight down, int dn_s_f16, float* __restrict__ partial,
              int M, int K, int I, int D, int bi, int group, float zero, int fast) {
  __shared__ __align__(16) float red[kWarps][MT][2 * kTile];
  __shared__ __align__(16) float gated[MT][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j_begin = blockIdx.x * bi;
  const int j_end = min(I, j_begin + bi);
  float* mine = partial + (long long)blockIdx.x * M * D;
  // lanes 0-15 stream gate columns, lanes 16-31 the same columns of up
  const Weight gu{lane < 16 ? gate.q : up.q, lane < 16 ? gate.s : up.s,
                  lane < 16 ? gate.m : up.m};
  const int lc = (lane & 15) * 4;

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int rows = min(MT, M - m0);
    for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
      const int width = min(kTile, j_end - j0);   // 32 or 64

      // g and u of this tile: all of K, shared by the block's warps
      float acc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      if (lc < width) {
        const long long col = j0 + lc;
        for (int b32 = warp; b32 < K / 32; b32 += kWarps) {
          const int k0 = b32 * 32;
          block32_fma<XT, PACKED, MINS, MT>(
              acc, gu.q + (long long)(PACKED ? k0 / 2 : k0) * ld_gu + col, ld_gu, gu.s,
              gu_s_f16, gu.m, (long long)(k0 / group) * ld_gu + col,
              (long long)((k0 + 16) / group) * ld_gu + col, zero, fast,
              x + (long long)m0 * K + k0, K, rows);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      __syncthreads();
      for (int e = threadIdx.x; e < MT * kTile; e += kThreads) {
        const int m = e / kTile, j = e % kTile;
        float g = red[0][m][j], u = red[0][m][kTile + j];
#pragma unroll
        for (int wi = 1; wi < kWarps; ++wi) {
          g += red[wi][m][j];
          u += red[wi][m][kTile + j];
        }
        const float v = j < width ? g * (1.f / (1.f + expf(-g))) * u : 0.f;
        gated[m][j] = fast ? round_bf16(v) : v;
      }
      __syncthreads();

      // this tile's rows of Wd into the block's partial (M, D)
      for (int c = threadIdx.x * 4; c < D; c += kThreads * 4) {
        float out[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) out[m][0] = out[m][1] = out[m][2] = out[m][3] = 0.f;
        for (int jb = 0; jb < width; jb += 32) {
          const int r0 = j0 + jb;
          block32_fma<float, PACKED, MINS, MT>(
              out, down.q + (long long)(PACKED ? r0 / 2 : r0) * D + c, D, down.s, dn_s_f16,
              down.m, (long long)(r0 / group) * D + c, (long long)((r0 + 16) / group) * D + c,
              zero, fast, &gated[0][jb], kTile, rows);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < rows) {
            float4* o = reinterpret_cast<float4*>(mine + (long long)(m0 + m) * D + c);
            float4 v = make_float4(out[m][0], out[m][1], out[m][2], out[m][3]);
            if (j0 != j_begin) {
              const float4 p = *o;
              v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
            }
            *o = v;
          }
        }
      }
      __syncthreads();   // red and gated are written again by the next tile
    }
  }
}

template <typename XT, bool PACKED, bool MINS>
cudaError_t launch(const void* x, Weight gate, Weight up, long long ld_gu, int gu_s_f16,
                   Weight down, int dn_s_f16, void* out, float* scratch, int M, int K, int I,
                   int D, int bi, int group, int off, int fast, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const float zero = zero_point(PACKED, off);
  const int slices = (I + bi - 1) / bi;
#define SWIGLU(MT)                                                                   \
  swiglu_kernel<XT, PACKED, MINS, MT><<<slices, kThreads, 0, st>>>(                  \
      xp, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, scratch, M, K, I, D, bi, group, \
      zero, fast)
  if (M == 1) SWIGLU(1);
  else if (M == 2) SWIGLU(2);
  else if (M <= 4) SWIGLU(4);
  else SWIGLU(8);
#undef SWIGLU
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const long long md = (long long)M * D;
  reduce_partials_kernel<XT><<<(unsigned)((md + 255) / 256), 256, 0, st>>>(
      scratch, static_cast<XT*>(out), slices, md);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) float32 or bf16. gate / up: values (K or K / 2, .) with ld_gu
// bytes per row, scales and mins (K / group, .) with ld_gu elements per row
// (the halves of a fused array: up = gate + I columns, ld_gu = 2 I; a split
// pair: ld_gu = I). down: values (I or I / 2, D), scales and mins
// (I / group, D). Scales float16 or float32, mins float32 or null. out (M, D)
// in x's type. scratch: float32 (ceil(I / bi), M, D). bi: columns of I per
// block, a multiple of 64.
extern "C" int qa_fused_mlp(const void* x, const void* gq, const void* gs, const void* gm,
                            const void* uq, const void* us, const void* um, const void* dq,
                            const void* ds, const void* dm, void* out, void* scratch, int M,
                            int K, int I, int D, long long ld_gu, int bi, int group,
                            int x_bf16, int gu_s_f16, int dn_s_f16, int packed, int off,
                            int fast, void* stream) {
  const bool mins = gm != nullptr;
  if (M < 1 || M > 64 || K % 32 || I % 32 || D % 16 || ld_gu % 4 || bi < kTile ||
      bi % kTile || (group != 16 && group != 32) || (packed && group != 32) ||
      (um != nullptr) != mins || (dm != nullptr) != mins || (off != 0 && off != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const Weight gate{static_cast<const uint8_t*>(gq), gs, static_cast<const float*>(gm)};
  const Weight up{static_cast<const uint8_t*>(uq), us, static_cast<const float*>(um)};
  const Weight down{static_cast<const uint8_t*>(dq), ds, static_cast<const float*>(dm)};
#define FUSED(XT, PACKED, MINS)                                                          \
  launch<XT, PACKED, MINS>(x, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, out, scr, M, K, \
                           I, D, bi, group, off, fast, st)
  cudaError_t rc;
  if (x_bf16) {
    rc = packed ? (mins ? FUSED(__nv_bfloat16, true, true) : FUSED(__nv_bfloat16, true, false))
                : (mins ? FUSED(__nv_bfloat16, false, true) : FUSED(__nv_bfloat16, false, false));
  } else {
    rc = packed ? (mins ? FUSED(float, true, true) : FUSED(float, true, false))
                : (mins ? FUSED(float, false, true) : FUSED(float, false, false));
  }
#undef FUSED
  return (int)rc;
}
