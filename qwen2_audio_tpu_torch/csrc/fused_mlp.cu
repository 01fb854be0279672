// One-launch SwiGLU MLP over ggml block weights for Hopper (sm_90a), plain C
// interface for ctypes: qa_fused_mlp (fused_mlp_rows.cu: qa_fused_mlp_rows).
//
// Replaces the TPU kernel _swiglu_kernel of qwen2_audio_tpu/ops/fused_mlp.py
// (behind fused_mlp_stacked, fused_mlp_m_stacked, fused_mlp4_stacked,
// fused_mlp4_sym_stacked and fused_mlp_split_stacked).
//
// What it computes, for M <= 64 rows of x (a decode step, a beam step, a
// speculative verify):
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
// scales, 0.065 ms at 3.35 TB/s; packed symmetric q4_0 114.6 MB, 0.034 ms.
// At M = 64 its 26 GFLOP take 0.026 ms at the bf16 peak, so the products
// must run on the tensor cores and each weight value must be dequantized
// once for all rows.
//
// fast mode: swiglu_coop_kernel (swiglu_coop.cuh; this source builds it for
// M <= 8, fused_mlp_rows.cu for 9 <= M <= 64, so that nvcc builds the two
// in parallel), one cooperative launch (every CTA resident; the wrapper's
// swiglu_plan sizes it) in two phases, which reads every byte
// of Wg, Wu and Wd (values, scales, mins) from device memory once at every
// M:
// - Phase A. CTA c owns the 16-column units [c U / P, (c + 1) U / P) of I
//   (U = I / 16) and computes g and u of those columns for all M rows, then
//   gated = g * sigmoid(g) * u, rounded to bf16, into a device scratch (M,
//   I) laid out in B's fragment order for phase B (at most 2.4 MB, which
//   stays in the 50 MB L2).
// - A grid barrier: each CTA adds one to a counter, the last sets a flag,
//   each CTA then adds one to a second counter, and the last of those sets
//   all three words back to 0. The words are the caller's, one array per
//   stream and per CUDA-graph capture (ops/fused_mlp.py), so that two
//   launches in flight at once never share them; a wait of more than 4 s
//   (a fault, never a real wait) traps.
// - Phase B. y's columns in tiles (16 columns a warp), the rows of I in S
//   splits of whole 32-row groups: task (tile, split) on one CTA, streaming
//   that part of Wd once with gated as B. Wd does not depend on gated, so
//   each CTA puts its first task's first stages of Wd in flight before the
//   barrier. With S > 1 the splits write float32 partial sums and the
//   tile's last CTA to finish, found by a ticket counter in the same array
//   (left at 0), adds them in split order and writes y. No float atomics:
//   a result repeats bit for bit, eager or replayed. The plan keeps the
//   scratch (gated, partials, tickets), each byte reckoned once, within 5 %
//   of the weight bytes.
// - The products. Every weight value is dequantized once, as the A operand
//   of mma.sync m16n8k16 (bf16 -> f32), and multiplied by every n-tile of 8
//   rows of B (x in phase A, gated in phase B) that M has:
//   * M <= 8 (one CTA of 16 warps an SM): qmm_stream.cuh's core. A warp
//     streams one 64-column block (4 A tiles a lane, one 8-byte read a
//     byte row) through its own cp.async ring of 2 stages, with no block
//     barrier between stages (4 stages measured slower, as in the matmul);
//     x, or a task's rows of gated, is staged once in B's fragment order.
//     Phase A's blocks are of the CTA's gate and up columns side by side
//     (a block may hold both; a 16-byte chunk never straddles them), and a
//     block's rows of K are split over 16 / blocks warps interleaved, every
//     split-th group of 32 rows: all the CTA's warps read one band of rows
//     at a time, as the other CTAs do, which DRAM pages favour (a
//     contiguous range of blocks and groups a warp measured slower on the
//     H100). The splits' sums meet in shared memory and are added in split
//     order.
//   * 9 <= M <= 64 (two CTAs of 8 warps an SM up to 32 rows, so that one
//     computes while the other waits at its barrier; one above, for the
//     registers of 8 n-tiles): x does not fit shared memory whole (458 KB
//     at 64 rows), so a CTA's warps share a ring of stages of 1-4 groups of
//     32 values of K (the CTA's gate and up columns, scales, mins and x's
//     32 values of every row), filled by cp.async of all threads (each
//     thread's chunks worked out once a pass) several stages ahead, one
//     block barrier a stage; x is rounded to bf16 into B's fragment order
//     one stage ahead. A "piece" is 16 columns, one A tile (a lane reads 2
//     bytes a byte row); the warps take items (piece, group of the stage),
//     at most 5 a warp (3 at 17-32 rows), a warp short of items repeating
//     one so that the step has no branch; the items' sums meet in shared
//     memory over the ring and are added in group order. Phase B streams
//     its tile (8 pieces, one a warp) the same way with gated as B, two
//     accumulator chains a warp.
// - Shared memory rows of the M > 8 ring are the CTA's pieces side by side,
//   16 bytes each, padded so that the four rows a warp's lanes read at once
//   fall on different banks. Lane (g, t) reads columns 2 g, 2 g + 1 of rows
//   t + 4 i: A row g is column 2 g and row g + 8 column 2 g + 1, and of each
//   16 values of K the lane holds t, t + 4, t + 8, t + 12 (mma slots 2t,
//   2t+1, 2t+8, 2t+9; B takes the same order). A nibble row holds values j
//   and j + 16 of its group.
// What still holds it back (PERF.md): at M <= 8 the weight stream stays
// below the card's rate; at 64 rows the products on mma.sync with 2 warps a
// scheduler (8 n-tiles of accumulators a warp) take longer than the weight
// bytes.
// - exact mode (every product in float32): swiglu_kernel, float32 FMA. For
//   each 64 columns of its slice, lanes 0-15 of a warp own 4 gate columns
//   each, lanes 16-31 the same 4 up columns, the block's 4 warps share K and
//   meet in shared memory in a fixed order, then its 64 rows of Wd go into
//   the block's own float32 partial (M, D); more than 8 rows are taken 8 at
//   a time; reduce_partials_kernel adds the slices in order.
// I must be a multiple of 32, K of 32, D of 16 (the wrapper checks).

#include "swiglu_coop.cuh"

namespace {

using namespace qa;

constexpr int kTile = 64;    // exact mode: columns of I per pass
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename XT, bool PACKED, bool MINS, int MT>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const XT* __restrict__ x, Weight gate, Weight up, long long ld_gu,
              int gu_s_f16, Weight down, int dn_s_f16, float* __restrict__ partial,
              int M, int K, int I, int D, int bi, int group, float zero) {
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
              (long long)((k0 + 16) / group) * ld_gu + col, zero,
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
        gated[m][j] = j < width ? g * (1.f / (1.f + expf(-g))) * u : 0.f;
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
              zero, &gated[0][jb], kTile, rows);
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

// ------------------------------------------------------------------------- //
// fast mode: the cooperative two-phase kernel
// ------------------------------------------------------------------------- //

template <typename XT, bool PACKED, bool MINS>
cudaError_t launch(const void* x, Weight gate, Weight up, long long ld_gu, int gu_s_f16,
                   Weight down, int dn_s_f16, void* out, float* scratch, int M, int K, int I,
                   int D, int bi, int group, int off, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const float zero = zero_point(PACKED, off);
  const int slices = (I + bi - 1) / bi;
#define SWIGLU(MT)                                                                   \
  swiglu_kernel<XT, PACKED, MINS, MT><<<slices, kThreads, 0, st>>>(                  \
      xp, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, scratch, M, K, I, D, bi, group, \
      zero)
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
// in x's type. fast (M <= 8 here; fused_mlp_rows.cu's qa_fused_mlp_rows
// above): scratch is gated, bf16 (M, I); partial float32 (S, M, D) or null
// for S = 1; tickets uint32 (4096,), zero, left at zero; plan = {P (the
// grid), S, units_a, ring_a, ring_b, sg_a, sg_b} from swiglu_plan. exact:
// bi, columns of I per block of swiglu_kernel (a multiple of 64), scratch
// float32 (ceil(I / bi), M, D).
extern "C" int qa_fused_mlp(const void* x, const void* gq, const void* gs, const void* gm,
                            const void* uq, const void* us, const void* um, const void* dq,
                            const void* ds, const void* dm, void* out, void* scratch,
                            void* partial, void* tickets, int M, int K, int I, int D,
                            long long ld_gu, int bi, const int* plan, int group, int x_bf16,
                            int gu_s_f16, int dn_s_f16, int packed, int off, int fast,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mins = gm != nullptr;
  if (fast) {
    CoopArgs a;
    if (M > 8 || !coop_args(a, x, gq, gs, gm, uq, us, um, dq, ds, dm, out, scratch, partial,
                            tickets, M, K, I, D, ld_gu, plan, group, x_bf16, gu_s_f16,
                            dn_s_f16, packed, off))
      return (int)cudaErrorInvalidValue;
    return (int)coop_launch<1>(a, packed != 0, mins, st);
  }
  if (M < 1 || M > 64 || K % 32 || I % 32 || D % 16 || ld_gu % 16 || bi < kTile ||
      bi % kTile || (group != 16 && group != 32) || (packed && group != 32) ||
      (um != nullptr) != mins || (dm != nullptr) != mins || (off != 0 && off != 8))
    return (int)cudaErrorInvalidValue;
  const Weight gate{static_cast<const uint8_t*>(gq), gs, static_cast<const float*>(gm)};
  const Weight up{static_cast<const uint8_t*>(uq), us, static_cast<const float*>(um)};
  const Weight down{static_cast<const uint8_t*>(dq), ds, static_cast<const float*>(dm)};
  float* scr = static_cast<float*>(scratch);
#define EXACT(XT, PACKED, MINS)                                                            \
  launch<XT, PACKED, MINS>(x, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, out, scr, M, K, I, \
                           D, bi, group, off, st)
  cudaError_t rc;
  if (x_bf16) {
    rc = packed ? (mins ? EXACT(__nv_bfloat16, true, true) : EXACT(__nv_bfloat16, true, false))
                : (mins ? EXACT(__nv_bfloat16, false, true) : EXACT(__nv_bfloat16, false, false));
  } else {
    rc = packed ? (mins ? EXACT(float, true, true) : EXACT(float, true, false))
                : (mins ? EXACT(float, false, true) : EXACT(float, false, false));
  }
#undef EXACT
  return (int)rc;
}
