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
//   I, and the partial (M, D) sums of the slices are added in a fixed order
//   by a second small kernel (no float atomics, so a result repeats bit for
//   bit): sum_slices_kernel in fast mode (8 warps an output group, each
//   adding every eighth slice, 8 loads in flight), reduce_partials_kernel in
//   exact mode (slice order).
// - fast mode: swiglu_stream_kernel, on the tensor-core streaming core of
//   qmm_stream.cuh. The slices are whole 32-column units of I spread evenly
//   over at most one block per SM (the wrapper's swiglu_plan: no block has
//   more than one unit more than another). A block of 8 warps takes its
//   slice's gate and up columns in 64-column blocks (a row's bytes one
//   64-byte piece; gate and up halves side by side in one block read as two
//   32-byte pieces and measured slower on the H100), K split over its
//   warps; the warps' sums of every block meet in shared memory and, after
//   one barrier (one per group of blocks where shared memory holds fewer),
//   are added in warp order and give gated = g * sigmoid(g) * u, rounded to
//   bf16, into shared memory in B's fragment order. Then each warp streams
//   the slice's rows of Wd for its 64-column blocks of D with gated as B,
//   and writes the block's partial (M, D) once. Every warp's ring runs on
//   from the gate and up stages into the down stages, so the down rows are
//   in flight before gated is done.
//   Rows above 8 are taken 8 at a time, each pass streaming the weights
//   again; the slices narrow to keep the partial sums within the wrapper's
//   scratch budget.
// - exact mode (every product in float32): swiglu_kernel, float32 FMA. For
//   each 64 columns of its slice, lanes 0-15 of a warp own 4 gate columns
//   each, lanes 16-31 the same 4 up columns, the block's 4 warps share K and
//   meet in shared memory in a fixed order, then its 64 rows of Wd go into
//   the block's own float32 partial (M, D); more than 8 rows are taken 8 at
//   a time.
// I must be a multiple of 32, K of 32, D of 16 (the wrapper checks).

#include "qmm_common.cuh"
#include "qmm_stream.cuh"

namespace {

using namespace qa;

constexpr int kTile = 64;    // exact mode: columns of I per pass
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSwWarps = 8;  // fast mode: warps of a block
constexpr int kMaxSmem = 232448;

struct Weight {              // one dequantizing operand
  const uint8_t* q;
  const void* s;
  const float* m;            // nullptr unless the flavour has mins
};

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

// fast mode, rows m0 .. of x 8 at a time, slice blockIdx.x of P
template <typename XT, bool PACKED, bool MINS>
__global__ void __launch_bounds__(kSwWarps * 32, 1)
swiglu_stream_kernel(const XT* __restrict__ x, Weight gate, Weight up, long long ld_gu,
                     int gu_s_f16, Weight down, int dn_s_f16, float* __restrict__ partial,
                     int M, int K, int I, int D, int P, int group, float zero, int ucap) {
  using St = Stage<PACKED, MINS>;
  constexpr int RING = St::kRing;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Mr = min(M, 8);
  uint8_t* ring = smem + warp * RING * St::kBytes;
  uint2* xs = reinterpret_cast<uint2*>(smem + kSwWarps * RING * St::kBytes);   // (Mr, K) bf16
  float* red = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(xs) + Mr * K * 2);
  uint2* gs = reinterpret_cast<uint2*>(red + 2 * ucap * kSwWarps * Mr * kWarpCols);   // gated

  const int U = I / 32, p = blockIdx.x;
  const int u0 = (int)((long long)p * U / P), nch = (int)((long long)(p + 1) * U / P) - u0;
  const int i0 = u0 * 32;
  const int G = K / 32, kg0 = warp * G / kSwWarps, ngw = (warp + 1) * G / kSwWarps - kg0;
  const int nbd = (D + kWarpCols - 1) / kWarpCols;
  const int nbw = warp < nbd ? (nbd - warp + kSwWarps - 1) / kSwWarps : 0;
  const int gu_es = gu_s_f16 ? 2 : 4, dn_es = dn_s_f16 ? 2 : 4, srows = 32 / group;
  const int npair = (nch + 1) / 2, S = nch * 32;   // 64-column pairs of units
  const int na = 2 * npair * ngw;                    // the warp's gate and up stages
  const int per_rb = na + nbw * nch;                 // its stages a row block
  const int total = (M + 7) / 8 * per_rb;

  // The warp's stages, for each row block in turn: for each pair of units
  // of the slice (64 neighbouring columns of I), the gate block and then the
  // up block (64 columns of one array, so that a row's bytes are one
  // 64-byte piece; a slice of an odd number of units ends on a half block,
  // whose other 32 columns are neither copied nor stored) over the warp's
  // groups of K; then for each of the warp's D blocks, the slice's rows of
  // Wd. A run of stages over one block shares its lane copies.
  LaneCopy cp;
  int run_left = 0;
  auto start_run = [&](int i) {   // the run that stage i begins
    int r = i % per_rb;
    if (r < na) {
      const int blk = r / ngw, kk = r % ngw, c0 = 64 * (blk >> 1);
      const Weight& w = (blk & 1) ? up : gate;
      const int qc = c0 + 16 * (lane & 3), sc = c0 + (lane % (4 * gu_es)) * (16 / gu_es);
      const int mc = c0 + (lane & 15) * 4;
      cp = lane_copy<PACKED, MINS>(
          w.q + i0 + (qc < S ? qc : 0), qc < S, ld_gu,
          static_cast<const uint8_t*>(w.s) + (long long)(i0 + (sc < S ? sc : 0)) * gu_es,
          sc < S, ld_gu * gu_es,
          MINS ? reinterpret_cast<const uint8_t*>(w.m + i0 + (mc < S ? mc : 0)) : w.q,
          MINS && mc < S, ld_gu * 4, gu_es, srows, kg0 + kk, lane);
      run_left = ngw - kk;
    } else {
      r -= na;
      const int c0 = (warp + kSwWarps * (r / nch)) * kWarpCols, ig = r % nch;
      const int qc = c0 + 16 * (lane & 3), sc = c0 + (lane % (4 * dn_es)) * (16 / dn_es);
      const int mc = c0 + (lane & 15) * 4;
      cp = lane_copy<PACKED, MINS>(
          down.q + (qc < D ? qc : 0), qc < D, D,
          static_cast<const uint8_t*>(down.s) + (long long)(sc < D ? sc : 0) * dn_es, sc < D,
          (long long)D * dn_es,
          MINS ? reinterpret_cast<const uint8_t*>(down.m + (mc < D ? mc : 0)) : down.q,
          MINS && mc < D, (long long)D * 4, dn_es, srows, u0 + ig, lane);
      run_left = nch - ig;
    }
  };
  auto issue = [&](int i) {
    if (run_left == 0) start_run(i);
    issue_stage<PACKED, MINS>(ring + (i & (RING - 1)) * St::kBytes, cp, lane);
    --run_left;
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }
  int next = RING - 1, cur = 0;
  auto advance = [&]() {   // the next stage's slot, once it has landed
    cp_async_wait<RING - 2>();
    __syncwarp();
    if (next < total) issue(next);
    ++next;
    cp_async_commit();
    return ring + (cur++ & (RING - 1)) * St::kBytes;
  };

  for (int m0 = 0; m0 < M; m0 += 8) {
    const int mr = min(8, M - m0);
    __syncthreads();   // the last row block's reads of xs and gs are done
    stage_x(x + (long long)m0 * K, K, mr, K, xs, tid, kSwWarps * 32);
    __syncthreads();
    // the blocks' warp sums in shared memory, ucap pairs between barriers
    for (int q0 = 0; q0 < npair; q0 += ucap) {
      const int qn = min(ucap, npair - q0);
      for (int b = 0; b < 2 * qn; ++b) {   // gate, up, gate, up, ...
        float acc[4][4] = {};
        for (int kk = 0; kk < ngw; ++kk) {
          const int kb = 2 * (kg0 + kk);
          consume_stage<PACKED, MINS, false>(acc, advance(), gu_es, group, zero,
                                             b_frag(xs, kb, mr, lane),
                                             b_frag(xs, kb + 1, mr, lane), lane);
        }
        float* rw = red + (b * kSwWarps + warp) * Mr * kWarpCols;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * t + h < mr) {
            float o[8];
            acc_row(acc, h, o);
            store8(rw + (2 * t + h) * kWarpCols + 8 * g, o);
          }
        }
      }
      __syncthreads();
      // g (the gate block) and u (the up block) of each column, warps added
      // in order
      __nv_bfloat16* gb = reinterpret_cast<__nv_bfloat16*>(gs);
      for (int e = tid; e < qn * mr * 64; e += kSwWarps * 32) {
        const int q = e / (mr * 64), m = (e >> 6) % mr, j = e & 63;
        const int k = 64 * (q0 + q) + j;
        if (k >= S) continue;
        const float* rg = red + 2 * q * kSwWarps * Mr * kWarpCols + m * kWarpCols + j;
        const float* ru = rg + kSwWarps * Mr * kWarpCols;
        float gv = rg[0], uv = ru[0];
#pragma unroll
        for (int w = 1; w < kSwWarps; ++w) {
          gv += rg[w * Mr * kWarpCols];
          uv += ru[w * Mr * kWarpCols];
        }
        const int b = k >> 4, r = k & 15;
        gb[((b * mr + m) * 4 + (r & 3)) * 4 + (r >> 2)] =
            __float2bfloat16_rn(gv * (1.f / (1.f + expf(-gv))) * uv);
      }
      __syncthreads();   // red is read before the next pairs overwrite it
    }
    // gated is complete
    for (int bj = 0; bj < nbw; ++bj) {
      float acc[4][4] = {};
      for (int ig = 0; ig < nch; ++ig)
        consume_stage<PACKED, MINS, false>(acc, advance(), dn_es, group, zero,
                                           b_frag(gs, 2 * ig, mr, lane),
                                           b_frag(gs, 2 * ig + 1, mr, lane), lane);
      const int col = (warp + kSwWarps * bj) * kWarpCols + 8 * g;
      if (col < D) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * t + h < mr) {
            float o[8];
            acc_row(acc, h, o);
            store8(partial + ((long long)p * M + m0 + 2 * t + h) * D + col, o);
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives its thread
}

// out[i] = the P slices' partial sums of output i added in a fixed order:
// warp w of a block adds slices w, w + 8, ... in order for 32 neighbouring
// outputs, then the 8 warps' sums are added in warp order
template <typename XT>
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* __restrict__ partial, XT* __restrict__ out, int P,
                  long long MD) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (i < MD) {
    for (int p0 = warp; p0 < P; p0 += 64) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p0 + 8 * j < P) w[j] = __ldcg(partial + (long long)(p0 + 8 * j) * MD + i);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (p0 + 8 * j < P) v += w[j];
    }
  }
  part[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && i < MD) {
    float o = part[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) o += part[w][lane];
    out[i] = from_float<XT>(o);
  }
}

// the block's shared memory: the warps' rings, x (rows of one pass), the
// warps' sums of ucap pairs of blocks, gated of the widest slice
template <bool PACKED, bool MINS>
long long stream_smem(int M, int K, int slice, int ucap) {
  const long long mr = M < 8 ? M : 8;
  return (long long)kSwWarps * Stage<PACKED, MINS>::kRing * Stage<PACKED, MINS>::kBytes +
         mr * K * 2 + 2LL * ucap * kSwWarps * mr * kWarpCols * 4 + mr * slice * 2;
}

template <typename XT, bool PACKED, bool MINS>
cudaError_t launch_stream(const void* x, Weight gate, Weight up, long long ld_gu, int gu_s_f16,
                          Weight down, int dn_s_f16, void* out, float* scratch, int M, int K,
                          int I, int D, int P, int group, int off, cudaStream_t st) {
  const int U = I / 32, widest = (U + P - 1) / P;
  if (P < 1 || P > U) return cudaErrorInvalidValue;
  // as many pairs' sums between barriers as the shared memory holds
  int ucap = (widest + 1) / 2;
  while (ucap > 1 && stream_smem<PACKED, MINS>(M, K, widest * 32, ucap) > kMaxSmem) --ucap;
  const long long smem = stream_smem<PACKED, MINS>(M, K, widest * 32, ucap);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t attr = allow_smem<swiglu_stream_kernel<XT, PACKED, MINS>>(kMaxSmem);
  if (attr != cudaSuccess) return attr;
  swiglu_stream_kernel<XT, PACKED, MINS><<<P, kSwWarps * 32, (int)smem, st>>>(
      static_cast<const XT*>(x), gate, up, ld_gu, gu_s_f16, down, dn_s_f16, scratch, M, K, I,
      D, P, group, zero_point(PACKED, off), ucap);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const long long md = (long long)M * D;
  sum_slices_kernel<XT><<<(unsigned)((md + 31) / 32), 256, 0, st>>>(
      scratch, static_cast<XT*>(out), P, md);
  return cudaGetLastError();
}

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
// in x's type. fast: slices, the blocks of swiglu_stream_kernel (at most I /
// 32), scratch float32 (slices, M, D). exact: bi, columns of I per block of
// swiglu_kernel (a multiple of 64), scratch float32 (ceil(I / bi), M, D).
extern "C" int qa_fused_mlp(const void* x, const void* gq, const void* gs, const void* gm,
                            const void* uq, const void* us, const void* um, const void* dq,
                            const void* ds, const void* dm, void* out, void* scratch, int M,
                            int K, int I, int D, long long ld_gu, int bi, int slices, int group,
                            int x_bf16, int gu_s_f16, int dn_s_f16, int packed, int off,
                            int fast, void* stream) {
  const bool mins = gm != nullptr;
  if (M < 1 || M > 64 || K % 32 || I % 32 || D % 16 || ld_gu % 4 ||
      (!fast && (bi < kTile || bi % kTile)) || (group != 16 && group != 32) ||
      (packed && group != 32) || (um != nullptr) != mins || (dm != nullptr) != mins ||
      (off != 0 && off != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const Weight gate{static_cast<const uint8_t*>(gq), gs, static_cast<const float*>(gm)};
  const Weight up{static_cast<const uint8_t*>(uq), us, static_cast<const float*>(um)};
  const Weight down{static_cast<const uint8_t*>(dq), ds, static_cast<const float*>(dm)};
#define FUSED(XT, PACKED, MINS)                                                            \
  (fast ? launch_stream<XT, PACKED, MINS>(x, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, out, \
                                          scr, M, K, I, D, slices, group, off, st)           \
        : launch<XT, PACKED, MINS>(x, gate, up, ld_gu, gu_s_f16, down, dn_s_f16, out, scr,   \
                                   M, K, I, D, bi, group, off, st))
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
