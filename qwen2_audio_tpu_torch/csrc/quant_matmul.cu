// Dequantizing matrix product over ggml block weights for Hopper (sm_90a),
// plain C interface for ctypes: qa_quant_matmul.
//
// Replaces the TPU kernels _qmm_kernel (flat int8 values),
// _qmm_stacked_kernel (the same over (L, K, N), the layer picked inside),
// _qmm4_kernel (flat packed nibbles), _qmm4_stacked_kernel and the four
// contiguous-panel kernels _qmm_panel_kernel, _qmm_panel_stacked_kernel,
// _qmm4_panel_kernel and _qmm4_panel_stacked_kernel of
// qwen2_audio_tpu/ops/quant_matmul.py. The stacked kernels existed because a
// Pallas operand sliced from (L, K, N) is materialised; here a layer is a
// base pointer into the stacked tensor. The panel kernels existed because a
// TPU grid step wants its weight block as one contiguous DMA; here a panel
// is an address map: with column panels of width bn, element (k, n) of the
// weight lies at (n / bn) * rows * bn + k * bn + n % bn (rows = K, or K / 2
// for nibble bytes) and its scale at (n / bn) * (K / group) * bn + (k / group)
// * bn + n % bn. A row-major weight is the one panel of width bn = N, so one
// entry serves all eight, and the output is written (M, N) directly.
//
// What it computes: out[m, n] = sum_k xr[m, k] * wr[k, n] with
//   w[k, n] = float(v[k, n]) * s[k / group, n]        (one float32 multiply)
//   v = the int8 value, or (nibble - off) for packed weights: byte row
//       g * 16 + j of the (K / 2, N) nibble matrix holds value g * 32 + j in
//       its low and g * 32 + j + 16 in its high nibble (ggml's block_q4_0
//       pairing); off is 8 (symmetric q4_0) or 0 (mins are added outside)
//   exact mode: xr = float32(x), wr = w
//   fast mode:  xr = bf16(x), wr = bf16(w), each rounded once to nearest even
// products summed in float32, the sum cast to x's type. group is 32 or 16
// (q2_K / q3_K / q6_K); packed weights always have group 32. The scales are
// float16 (a raw ggml block d) or float32.
//
// What bounds it:
// - M <= 8 (a decode step): the weight bytes. A 3584 x 3584 q8_0 layer is
//   12.8 MB of int8 and 0.8 MB of f16 scales, 4.1 us at 3.35 TB/s, against
//   25.7 MFLOP. fast mode: qmm_stream_kernel, the tensor-core streaming core
//   of qmm_stream.cuh (a warp's 64-column block through its own cp.async
//   ring, the dequantized weight as A of mma.sync m16n8k16, x rounded once
//   per block into shared memory as B). A block is 4 warps, 256 neighbouring
//   columns, over one range of whole 32-row groups of K; the wrapper's plan
//   (ops/quant_matmul.py stream_plan, from M, K and N only) splits K so that
//   about two blocks per SM run at once and a block stages at most 16384
//   values of x. With more than one split the blocks write float32 partial
//   sums (S, M, N); the last block of a column group to finish, found by a
//   ticket counter, adds the splits' sums in split order and writes the
//   output in the same launch, so the result does not vary from run to run
//   (no float atomics). The tickets are the caller's: one array per stream
//   and per CUDA-graph capture (ops/quant_matmul.py), made zero once and
//   left at zero by each launch's last blocks, so that launches in flight at
//   once never share one and no launch pays for zeroing them. exact mode: qmm_small_kernel, float32 FMA: a lane
//   owns 4 neighbouring columns, a warp whole 32-row blocks of K, K split
//   over the 4 warps of a block and over gridDim.y blocks (split_k), the
//   splits added in order by reduce_partials_kernel. Bytes become floats by
//   the 2^23 trick (byte_perm into the mantissa of 0x4B000000, one
//   subtract), which is exact and needs no int8 negation.
// - M > 8 (prefill M = 752, the encoder M = 1500, a speculative pool's
//   verify M = 64): operations (gate_up of the 7B tower at M = 752: 204
//   GFLOP, 0.21 ms at 989 TFLOP/s in bf16), and again the weight bytes
//   below about 128 rows. fast mode: qmm_tile_kernel computes the output's
//   transpose, out^T = w^T x^T, on wgmma m64nBMk16: the weight is A, 64
//   columns a consumer warpgroup, dequantized by the consumers themselves
//   into registers, and x is B, BM of its rows by TMA into shared memory.
//   * A from registers, without a transform: one ldmatrix.x4.trans over the
//     raw stage (TMA-swizzled, so the 8 rows of a matrix hit 8 banks) reads
//     the bytes as 16-bit pairs of neighbouring columns and gives a thread,
//     for its two columns cl and cl + 1, the values of K its A fragment
//     needs (2 t4, 2 t4 + 1, + 8): an int8 row holds one value, a nibble
//     row two (ggml's pairing puts k and k + 16 in one byte, so one load
//     serves two k16 steps). A's row g is column cl and row g + 8 column
//     cl + 1; the epilogue writes each such pair with one store. Each value
//     becomes bf16(float(v) * s) in registers (the 2^23 trick, one multiply,
//     one rounding), the plain version's numbers. No bf16 weight tile is
//     written to shared memory and no warps do nothing but convert.
//   * Shared-memory bytes a 64-deep stage of a 256-row unit (q8_0): TMA
//     writes 32 KB of x and 8.5 KB of raw weight and scales, ldmatrix reads
//     the 8 KB once, and each of the two consumer warpgroups reads x's 32 KB
//     as B: about 113 KB for 4.2 MFLOP, 27 B a kFLOP. The tile this
//     replaces moved about 97 KB for 2.1 MFLOP (46 B), and a bf16 B tile
//     written MN-major for 256 rows would move about 38. Each dequantized
//     value now serves BM rows of x (192 at the prefill's gate_up, 256 at the
//     encoder's fc1) where it served 128, and is converted once a unit.
//   * Persistent: one CTA an SM walks units of BM rows x 128 columns over a
//     range of K (the launch plan, ops/quant_matmul.py tile_plan: up to 128
//     rows BM is the least of 16, 32, 64 and 128 that holds M, so that a
//     unit never wastes half its rows; above, 128, 192 or 256, whichever
//     ends the waves first; K split in whole stages only where the units
//     would fill fewer than half the SMs, the splits' float32 sums added in
//     split order by reduce_partials_kernel), M fastest, so that the CTAs
//     at work at once share weight columns and a weight panel is read from
//     device memory about once. The producer runs on into the next unit
//     while the consumers store the last one.
//   * No serialized wgmma: a consumer never spins on an mbarrier (ptxas
//     serializes every wgmma of a function where one is in flight across
//     such a spin, C7518); the release warp waits for each slot and lets
//     the consumers in through the slot's named barrier. Each consumer keeps
//     one k16 product in flight while it converts the next step's A.
//   Rings of up to 15 slots (x, raw weight, scales) fill the 227 KB of
//   shared memory: 5 at BM = 256, 6 at 192, 8 at 128, 12 at 64 (q8_0). TMA
//   zero-fills past the ragged M, N and K edges; where a panel is narrower
//   than the tile and not the whole N, the producer's lanes copy 16-byte
//   chunks with cp.async instead, into the same swizzled layout. The
//   float32 sums run in the tensor cores' order: the results are held to a
//   tolerance against the plain version, and the panel entries, which read
//   the same values in the same order under the same plan, give the strided
//   entry's bits.
//   exact mode: qmm_fma_kernel, 128 x 128 tiles in float32 with an 8 x 8
//   register tile per thread and FMA only (no TF32): slow, and exact.
//   Blocks that share a weight panel are neighbours in launch order
//   (blockIdx.x walks M), so the panel is read from device memory about
//   once.
// The kernel masks its own ragged M edge; nothing is padded in device
// memory. N and bn must be multiples of 16 and K of 32 (the wrapper checks),
// so a thread's 4 or 8 neighbouring columns never straddle a panel. The
// split over K depends on M, K and N only: the same values give the same
// bits whether they are stored row-major or in panels.

#include "hopper_mma.cuh"
#include "qmm_common.cuh"
#include "qmm_stream.cuh"

#include <type_traits>



namespace {

using namespace qa;

__device__ __forceinline__ void load_scales8(const void* sc, int s_f16, long long idx,
                                             float (&s)[8]) {
  if (s_f16) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const __half*>(sc) + idx);
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __half22float2(h[i]);
      s[2 * i] = a.x;
      s[2 * i + 1] = a.y;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(sc) + idx);
    const float4 a = p[0], b = p[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
}

// ------------------------------------------------------------------------- //
// M <= 8: stream the weight once
// ------------------------------------------------------------------------- //

constexpr int kSmallCols = 128;    // exact mode: columns per block, 32 lanes x 4
constexpr int kSmallWarps = 4;
constexpr int kStreamWarps = 4;    // fast mode: 64-column blocks a block
constexpr int kStreamX = 16384;    // most values of x a block stages (M x its K range)
constexpr int kMaxTickets = 4096;  // column groups a K-split launch may have

// the lane's weight and scale bases: the panel of its columns, then the
// column inside the panel (one panel of width N when the weight is row-major)
struct PanelAt {
  long long q, s;   // offsets of (row 0, col) in bytes / in scale elements
};
__device__ __forceinline__ PanelAt panel_at(int col, int bn, long long q_rows,
                                            long long s_rows) {
  const int p = col / bn, c = col - p * bn;
  return {(long long)p * q_rows * bn + c, (long long)p * s_rows * bn + c};
}

template <typename XT, bool PACKED, int MT>
__global__ void __launch_bounds__(kSmallWarps * 32)
qmm_small_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
                 const void* __restrict__ sc, int s_f16, float* __restrict__ partial,
                 XT* __restrict__ out, int M, int K, int N, int bn, int group, float zero) {
  __shared__ __align__(16) float red[kSmallWarps][MT][kSmallCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kSmallCols + lane * 4;
  const int n_warps = gridDim.y * kSmallWarps;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  if (col < N) {
    const PanelAt at = panel_at(col, bn, PACKED ? K / 2 : K, K / group);
    for (int b32 = blockIdx.y * kSmallWarps + warp; b32 < K / 32; b32 += n_warps) {
      const int k0 = b32 * 32;
      block32_fma<XT, PACKED, false, MT>(
          acc, q + at.q + (long long)(PACKED ? k0 / 2 : k0) * bn, bn, sc, s_f16, nullptr,
          at.s + (long long)(k0 / group) * bn, at.s + (long long)((k0 + 16) / group) * bn,
          zero, x + k0, K, M);
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int cc = blockIdx.x * kSmallCols + threadIdx.x;
  if (cc < N) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float v = red[0][m][threadIdx.x];
#pragma unroll
        for (int wi = 1; wi < kSmallWarps; ++wi) v += red[wi][m][threadIdx.x];
        if (partial != nullptr)
          partial[((long long)blockIdx.y * M + m) * N + cc] = v;
        else
          out[(long long)m * N + cc] = from_float<XT>(v);
      }
    }
  }
}

// fast mode: 4 warps, each a 64-column block of the block's 256 columns,
// over groups g0 .. g1 - 1 (32 values of K each) of split blockIdx.y; with
// ks > 1 splits the blocks of column group g add one to tickets[g] (zero at
// the launch) as they finish, and the last one resets it to 0
template <typename XT, bool PACKED, bool DQ16>
__global__ void __launch_bounds__(kStreamWarps * 32)
qmm_stream_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
                  const void* __restrict__ sc, int s_f16, float* __restrict__ partial,
                  unsigned int* __restrict__ tickets, XT* __restrict__ out, int M, int K, int N,
                  int bn, int group, float zero, int ks) {
  using St = Stage<PACKED, false>;
  constexpr int RING = St::kRing;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = K / 32, split = blockIdx.y;
  const int g0 = (int)((long long)split * G / ks), g1 = (int)((long long)(split + 1) * G / ks);
  const int n = g1 - g0, es = s_f16 ? 2 : 4, srows = 32 / group;
  const int col0 = (blockIdx.x * kStreamWarps + warp) * kWarpCols;
  const bool active = col0 < N;
  uint8_t* ring = smem + warp * RING * St::kBytes;
  uint2* xs = reinterpret_cast<uint2*>(smem + kStreamWarps * RING * St::kBytes);

  // the lane's 16 weight columns and its scale chunk, each inside one panel
  const long long q_rows = PACKED ? K / 2 : K, s_rows = K / group;
  const int qc = col0 + 16 * (lane & 3), scol = col0 + (lane % (4 * es)) * (16 / es);
  const uint8_t* sb = static_cast<const uint8_t*>(sc);
  LaneCopy cp = lane_copy<PACKED, false>(
      q + (qc < N ? panel_at(qc, bn, q_rows, s_rows).q : 0), qc < N, bn,
      sb + (scol < N ? panel_at(scol, bn, q_rows, s_rows).s * es : 0), scol < N,
      (long long)bn * es, sb, false, 0, es, srows, g0, lane);
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (active && i < n) issue_stage<PACKED, false>(ring + i * St::kBytes, cp, lane);
    cp_async_commit();
  }
  stage_x(x + (long long)g0 * 32, K, M, n * 32, xs, threadIdx.x, kStreamWarps * 32);
  __syncthreads();

  float acc[4][4] = {};
  if (active) {
    for (int i = 0; i < n; ++i) {
      cp_async_wait<RING - 2>();
      __syncwarp();
      if (i + RING - 1 < n)
        issue_stage<PACKED, false>(ring + ((i + RING - 1) & (RING - 1)) * St::kBytes, cp, lane);
      cp_async_commit();
      consume_stage<PACKED, false, DQ16>(acc, ring + (i & (RING - 1)) * St::kBytes, es, group,
                                         zero, b_frag(xs, 2 * i, M, lane),
                                         b_frag(xs, 2 * i + 1, M, lane), lane);
    }
  }
  cp_async_wait<0>();   // no copy outlives its thread

  const int g = lane >> 2, t = lane & 3, col = col0 + 8 * g;
  if (ks == 1) {
    if (active && col < N) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * t + h < M) {
          float o[8];
          acc_row(acc, h, o);
          store8(out + (long long)(2 * t + h) * N + col, o);
        }
      }
    }
    return;
  }
  // K split: this split's float32 sums, then the group's last block adds the
  // splits in order
  if (active && col < N) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * t + h < M) {
        float o[8];
        acc_row(acc, h, o);
        store8(partial + ((long long)split * M + 2 * t + h) * N + col, o);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)ks - 1;
    if (last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kQuads = kStreamWarps * kWarpCols / 4;   // float4 of a row of the group
  const int c_base = blockIdx.x * kStreamWarps * kWarpCols;
  for (int e = threadIdx.x; e < M * kQuads; e += kStreamWarps * 32) {
    const int m = e / kQuads, c = c_base + 4 * (e % kQuads);
    if (c >= N) continue;
    const float4 v = sum_splits4(partial + (long long)m * N + c, ks, (long long)M * N);
    XT* o = out + (long long)m * N + c;
    store2(o, v.x, v.y);
    store2(o + 2, v.z, v.w);
  }
}

// ------------------------------------------------------------------------- //
// M > 8: 128 x 128 output tiles, K in steps of 32
// ------------------------------------------------------------------------- //

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTileThreads = 256;

// One K step's global loads of a thread: 8 columns of weight rows wr and
// wr + 16 (one byte row when packed) with their scales, and 16 values of x
// row xr.
template <typename XT, bool PACKED>
struct TileRegs {
  uint2 q0, q1;
  float s0[8], s1[8];
  float xv[16];
};

template <typename XT, bool PACKED>
__device__ __forceinline__ void tile_load(TileRegs<XT, PACKED>& r, const XT* x,
                                          const uint8_t* q, const void* sc, int s_f16,
                                          int M, int K, int N, int bn, int group,
                                          int k0, int row, int xh, int wr, int col) {
  if (col < N) {
    const PanelAt at = panel_at(col, bn, PACKED ? K / 2 : K, K / group);
    if (PACKED) {
      r.q0 = *reinterpret_cast<const uint2*>(q + at.q + (long long)(k0 / 2 + wr) * bn);
    } else {
      r.q0 = *reinterpret_cast<const uint2*>(q + at.q + (long long)(k0 + wr) * bn);
      r.q1 = *reinterpret_cast<const uint2*>(q + at.q + (long long)(k0 + wr + 16) * bn);
    }
    const int sr0 = (k0 + wr) / group, sr1 = (k0 + wr + 16) / group;
    load_scales8(sc, s_f16, at.s + (long long)sr0 * bn, r.s0);
    if (sr1 != sr0) {
      load_scales8(sc, s_f16, at.s + (long long)sr1 * bn, r.s1);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) r.s1[c] = r.s0[c];
    }
  } else {
    r.q0 = r.q1 = make_uint2(0, 0);
#pragma unroll
    for (int c = 0; c < 8; ++c) r.s0[c] = r.s1[c] = 0.f;
  }
  if (row < M) {
    const XT* xp = x + (long long)row * K + k0 + xh;
    float a[8], b[8];
    load_x8(xp, a);
    load_x8(xp + 8, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r.xv[i] = a[i];
      r.xv[8 + i] = b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) r.xv[i] = 0.f;
  }
}

// the 2 x 8 dequantized float32 weights of a thread: rows wr and wr + 16
template <typename XT, bool PACKED>
__device__ __forceinline__ void tile_dequant(const TileRegs<XT, PACKED>& r, float zero,
                                             float (&lo)[8], float (&hi)[8]) {
  uint32_t wl[2], wh[2];
  if (PACKED) {
    wl[0] = r.q0.x & 0x0F0F0F0Fu;
    wl[1] = r.q0.y & 0x0F0F0F0Fu;
    wh[0] = (r.q0.x >> 4) & 0x0F0F0F0Fu;
    wh[1] = (r.q0.y >> 4) & 0x0F0F0F0Fu;
  } else {
    wl[0] = r.q0.x ^ 0x80808080u;
    wl[1] = r.q0.y ^ 0x80808080u;
    wh[0] = r.q1.x ^ 0x80808080u;
    wh[1] = r.q1.y ^ 0x80808080u;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    lo[c] = (byte_as_float(wl[c >> 2], c & 3) - zero) * r.s0[c];
    hi[c] = (byte_as_float(wh[c >> 2], c & 3) - zero) * r.s1[c];
  }
}

// fast mode: persistent tiles that compute the output's transpose on wgmma,
// 320 threads in roles that never reconverge:
//   warpgroups 0, 1  consumers: weight columns 64 w .. 64 w + 63 of a unit
//                    as wgmma's A, dequantized into registers by the
//                    consumers themselves, times the unit's BM rows of x as
//                    B from shared memory: out^T, float32 registers
//   warp 8           producer: each stage's x box, raw weight rows and
//                    scales by TMA (cp.async for panels narrower than the
//                    tile) into the ring's next free slot, across units
//   warp 9           release: waits for each slot's bytes and lets the
//                    consumers in through the slot's named barrier
// A unit is BM rows of x by kQtN = 128 weight columns over one K split's
// stages of kQtK = 64 values; CTA b walks units b, b + gridDim.x, ... (the
// launch plan: ops/quant_matmul.py tile_plan). Ring slots: full (TMA bytes,
// and 32 cp.async arrivals on the panel path), empty (lane 0 of each of
// the 8 consumer warps), and the named barrier 1 + slot (256 consumers +
// the release warp).
constexpr int kQtN = 128, kQtK = 64;
constexpr int kQtScaleBytes = 4 * kQtN * 4;   // a stage's <= 4 scale rows (group 16), float32
constexpr int kSmemMax = 232448;
constexpr int kQtThreads = 320, kQtBarThreads = 256 + 32;

template <int BM, bool PACKED>
struct QtShape {
  static constexpr int kX = BM * kSwizzleRow;                    // x: (BM rows, 64 k) bf16
  static constexpr int kW = (PACKED ? kQtK / 2 : kQtK) * kQtN;   // raw weight rows, swizzled
  static constexpr int kStage = kX + kW + kQtScaleBytes + 16;    // and its two barriers
  static constexpr int kFit = (kSmemMax - 1024) / kStage;
  static constexpr int kStages = kFit < 15 ? kFit : 15;          // named barriers 1 .. 15
  static constexpr int kSmem = kStages * kStage + 1024;
};

// unit u of a launch: rows m0.., columns n0.., stages kt0 .. kt1 - 1 of K's
// `stages`, split `split`; units walk M fastest, then the splits, then N,
// so that the CTAs at work at once share weight columns
struct QtUnit {
  int m0, n0, kt0, kt1, split;
};
__device__ __forceinline__ QtUnit qt_unit(int u, int bm, int mt, int ks, int stages) {
  const int per_n = mt * ks, nt = u / per_n, r = u - nt * per_n, split = r / mt;
  return {(r - split * mt) * bm, nt * kQtN, (int)((long long)split * stages / ks),
          (int)((long long)(split + 1) * stages / ks), split};
}

// k16 step k's scales at columns cl and cl + 1: scale row k, or k / 2 for
// group 32, of a slot's rows at sr (float16 or float32), dq16 rounding each
// to bf16
__device__ __forceinline__ float2 qt_scales(const uint8_t* sr, int k, int cl, int group,
                                            int s_f16, int dq16) {
  const int row = group == 16 ? k : k >> 1;
  float2 v = s_f16 ? __half22float2(*reinterpret_cast<const __half2*>(sr + (row * kQtN + cl) * 2))
                   : *reinterpret_cast<const float2*>(sr + (row * kQtN + cl) * 4);
  if (dq16) v = make_float2(round_bf16(v.x), round_bf16(v.y));
  return v;
}

// k16 step k's A fragment from the ldmatrix words r (int8: r[2 k], r[2 k +
// 1]; packed: the low or high nibbles of r[2 (k / 2)], r[2 (k / 2) + 1]):
// each word holds bytes (row 2 t4, cl), (2 t4, cl + 1), (2 t4 + 1, cl),
// (2 t4 + 1, cl + 1), the second word rows + 8; each value becomes
// bf16(float(v) * s)
template <bool PACKED>
__device__ __forceinline__ void qt_convert(const uint32_t (&r)[8], int k, float2 sk, float zero,
                                           uint32_t (&a)[4]) {
  uint32_t w0, w1;
  if constexpr (PACKED) {
    const int sh = 4 * (k & 1);
    w0 = (r[2 * (k >> 1)] >> sh) & 0x0F0F0F0Fu;
    w1 = (r[2 * (k >> 1) + 1] >> sh) & 0x0F0F0F0Fu;
  } else {
    w0 = r[2 * k] ^ 0x80808080u;
    w1 = r[2 * k + 1] ^ 0x80808080u;
  }
  a[0] = pack_bf16((byte_as_float(w0, 0) - zero) * sk.x, (byte_as_float(w0, 2) - zero) * sk.x);
  a[1] = pack_bf16((byte_as_float(w0, 1) - zero) * sk.y, (byte_as_float(w0, 3) - zero) * sk.y);
  a[2] = pack_bf16((byte_as_float(w1, 0) - zero) * sk.x, (byte_as_float(w1, 2) - zero) * sk.x);
  a[3] = pack_bf16((byte_as_float(w1, 1) - zero) * sk.y, (byte_as_float(w1, 3) - zero) * sk.y);
}

__device__ __forceinline__ void pin4(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) pin(a[i]);
}

// a thread's two neighbouring outputs of rows ra and ra + 1 (wgmma's
// fragment of out^T: acc[4 j] and acc[4 j + 2] are columns col, col + 1 of
// row 8 j + 2 t4, acc[4 j + 1] and acc[4 j + 3] of the next row)
template <int BM, typename T>
__device__ __forceinline__ void qt_store(const float (&acc)[BM / 2], T* o, int M, int N, int r0,
                                         int col) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int ra = r0 + 8 * j;
    if (ra < M) store2(o + (long long)ra * N + col, acc[4 * j], acc[4 * j + 2]);
    if (ra + 1 < M) store2(o + (long long)(ra + 1) * N + col, acc[4 * j + 1], acc[4 * j + 3]);
  }
}

template <int BM, bool PACKED>
__global__ void __launch_bounds__(kQtThreads, 1)
qmm_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap smap, int tma_w,
                const uint8_t* __restrict__ q, const void* __restrict__ sc, int s_f16, int dq16,
                void* __restrict__ out, int out_f32, float* __restrict__ partial, int ks, int M,
                int K, int N, int bn, int group, float zero) {
  using S = QtShape<BM, PACKED>;
  constexpr int ST = S::kStages, RROWS = PACKED ? kQtK / 2 : kQtK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ws = xs + ST * S::kX;
  uint8_t* ss = ws + ST * S::kW;
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + ST * kQtScaleBytes);
  uint64_t* empty = full + ST;

  const int stages = (K + kQtK - 1) / kQtK;
  const int mt = (M + BM - 1) / BM, units = mt * ((N + kQtN - 1) / kQtN) * ks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], tma_w ? 1 : 33);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 8) {
    // ---- producer ----
    const int Kr = PACKED ? K / 2 : K, G = K / group;
    const int es = s_f16 ? 2 : 4, SR = kQtK / group, cpr = 8 * es;
    const uint32_t bytes = S::kX + (tma_w ? (RROWS + SR * es) * kQtN : 0);
    const uint8_t* scb = static_cast<const uint8_t*>(sc);
    int f = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const QtUnit t = qt_unit(u, BM, mt, ks, stages);
      // panel path: this lane's weight chunk (16 columns at (lane % 8) * 16,
      // byte rows lane / 8 + 4 i) and scale chunk (16 / es columns at
      // lane % cpr, rows lane / cpr + 32 i / cpr), each inside one panel
      const int wcol = t.n0 + (lane & 7) * 16, scol = t.n0 + (lane % cpr) * (16 / es);
      const long long wq = wcol < N ? panel_at(wcol, bn, Kr, G).q : 0;
      const long long sq = scol < N ? panel_at(scol, bn, Kr, G).s : 0;
      for (int kt = t.kt0; kt < t.kt1; ++kt, ++f) {
        const int s = f % ST;
        mbar_wait(&empty[s], ((f / ST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(xs + s * S::kX, &xmap, &full[s], kt * kQtK, t.m0);
          if (tma_w) {
            tma_load_3d(ws + s * S::kW, &wmap, &full[s], t.n0 % bn, kt * RROWS, t.n0 / bn);
            tma_load_3d(ss + s * kQtScaleBytes, &smap, &full[s], t.n0 % bn, kt * SR, t.n0 / bn);
          }
        }
        if (!tma_w) {
#pragma unroll
          for (int i = 0; i < RROWS * 8 / 32; ++i) {   // chunk lane % 8 of row r, swizzled
            const int r = (lane >> 3) + 4 * i, gr = kt * RROWS + r;
            cp_async16(ws + s * S::kW + r * kSwizzleRow + (((lane & 7) ^ (r & 7)) << 4),
                       q + wq + (long long)gr * bn, wcol < N && gr < Kr);
          }
          for (int i = lane; i < SR * cpr; i += 32) {
            const int sr = kt * SR + i / cpr;
            cp_async16(ss + s * kQtScaleBytes + i * 16, scb + (sq + (long long)sr * bn) * es,
                       scol < N && sr < G);
          }
          cp_async_arrive(&full[s]);
        }
      }
    }
    if (!tma_w) cp_async_wait_all();   // no copy outlives its thread
  } else if (warp == 9) {
    // ---- release: the consumers wait on no mbarrier (ptxas serializes
    // every wgmma of a function in which one is in flight across a spin) ----
    int f = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const QtUnit t = qt_unit(u, BM, mt, ks, stages);
      for (int kt = t.kt0; kt < t.kt1; ++kt, ++f) {
        const int s = f % ST;
        mbar_wait(&full[s], (f / ST) & 1);
        __syncwarp();
        named_arrive(1 + s, kQtBarThreads);
      }
    }
  } else if (warp < 8) {
    // ---- consumers ----
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    // the warp's 16 columns are chunk c16 of a raw row; the thread's A rows
    // g and g + 8 are columns cl and cl + 1 of the unit (ldmatrix.trans
    // reads byte pairs, so each register holds two neighbouring columns)
    const int c16 = 4 * wg + (warp & 3), cl = 16 * c16 + 2 * g;
    const uint32_t wrow = lane * kSwizzleRow + ((c16 ^ (lane & 7)) << 4);
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    // step k's A registers, kept (pin) until the wait that retires its
    // product: wgmma reads them after it is issued
    uint32_t a[4][4] = {};
    const uint32_t ws0 = smem_u32(ws) + wrow;
    int s = 0, prev = 0;   // the slot of the CTA's current and last stage
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const QtUnit t = qt_unit(u, BM, mt, ks, stages);
      for (int kt = t.kt0; kt < t.kt1; ++kt) {
        named_sync(1 + s, kQtBarThreads);
        const uint32_t wa = ws0 + s * S::kW;
        const uint8_t* sr = ss + s * kQtScaleBytes;
        const uint64_t xd = wgmma_desc(xs + s * S::kX);
        uint32_t r[8];   // int8: rows 0-31, then 32-63; packed: all 32 rows in r[0..3]
        ldsm_x4_trans(wa, *reinterpret_cast<uint32_t(*)[4]>(&r[0]));
        if constexpr (!PACKED)
          ldsm_x4_trans(wa + 32 * kSwizzleRow, *reinterpret_cast<uint32_t(*)[4]>(&r[4]));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          qt_convert<PACKED>(r, k, qt_scales(sr, k, cl, group, s_f16, dq16), zero, a[k]);
          wgmma_fence();
          wgmma_bf16_rs_k<BM>(acc, a[k], xd + 2 * k, kt > t.kt0 || k > 0);
          wgmma_commit();
          // one step in flight while the next is converted: this wait
          // retires the step before (the last stage's last at k = 0, when
          // its slot is free)
          wgmma_wait<1>();
          pin4(a[(k + 3) & 3]);
          if (k == 0 && kt > t.kt0 && lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
        s = s + 1 == ST ? 0 : s + 1;
      }
      wgmma_wait<0>();
      pin4(a[3]);
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) pin(acc[i]);
      const int col = t.n0 + cl, r0 = t.m0 + 2 * t4;
      if (col < N) {
        if (partial != nullptr)
          qt_store<BM>(acc, partial + (long long)t.split * M * N, M, N, r0, col);
        else if (out_f32)
          qt_store<BM>(acc, static_cast<float*>(out), M, N, r0, col);
        else
          qt_store<BM>(acc, static_cast<__nv_bfloat16*>(out), M, N, r0, col);
      }
    }
  }
}

// x rounded once to bf16 (round to nearest even), the wgmma tile's B operand
__global__ void __launch_bounds__(256)
round_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(x[i]);
}

// exact mode: float32 FMA
template <typename XT, bool PACKED>
__global__ void __launch_bounds__(kTileThreads)
qmm_fma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
               const void* __restrict__ sc, int s_f16, XT* __restrict__ out, int M,
               int K, int N, int bn, int group, float zero) {
  constexpr int XLD = kBM + 4, WLD = kBN + 4;
  __shared__ __align__(16) float Xs[kBK * XLD];   // [k][m]
  __shared__ __align__(16) float Ws[kBK * WLD];   // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;   // outputs: rows ty*4 (+64), cols tx*4 (+64)
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wr = tid >> 4, wc = (tid & 15) * 8;
  const int xr = tid >> 1, xh = (tid & 1) * 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  TileRegs<XT, PACKED> regs;
  tile_load(regs, x, q, sc, s_f16, M, K, N, bn, group, 0, m0 + xr, xh, wr, n0 + wc);
  const int steps = K / kBK;
  for (int kt = 0; kt < steps; ++kt) {
    __syncthreads();
    {
      float lo[8], hi[8];
      tile_dequant(regs, zero, lo, hi);
      float4* wl = reinterpret_cast<float4*>(Ws + wr * WLD + wc);
      wl[0] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      wl[1] = make_float4(lo[4], lo[5], lo[6], lo[7]);
      float4* wh = reinterpret_cast<float4*>(Ws + (wr + 16) * WLD + wc);
      wh[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      wh[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
#pragma unroll
      for (int i = 0; i < 16; ++i) Xs[(xh + i) * XLD + xr] = regs.xv[i];
    }
    __syncthreads();
    if (kt + 1 < steps)
      tile_load(regs, x, q, sc, s_f16, M, K, N, bn, group, (kt + 1) * kBK, m0 + xr, xh,
                wr, n0 + wc);
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Xs + k * XLD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(Xs + k * XLD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Ws + k * WLD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Ws + k * WLD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = n0 + jh * 64 + tx * 4;
      if (col < N) {
        store2(out + (long long)row * N + col, acc[i][jh * 4], acc[i][jh * 4 + 1]);
        store2(out + (long long)row * N + col + 2, acc[i][jh * 4 + 2], acc[i][jh * 4 + 3]);
      }
    }
  }
}

template <int BM, bool PACKED>
cudaError_t launch_tile(const void* xb, const uint8_t* q, const void* sc, int s_f16, int dq16,
                        void* out, int out_f32, float* partial, int ks, int ctas, int M, int K,
                        int N, int bn, int group, float zero, cudaStream_t st) {
  using S = QtShape<BM, PACKED>;
  const int tma_w = bn >= kQtN && (bn % kQtN == 0 || bn == N);
  // x (M, K) bf16 in swizzled (BM, 64) boxes; the weight's raw bytes
  // (swizzled, for ldmatrix without bank conflicts) and scales as (panels,
  // rows, bn) in boxes of one stage's rows and 128 columns
  CUtensorMap xmap, wmap, smap;
  const long long P = N / bn, Kr = PACKED ? K / 2 : K, G = K / group, es = s_f16 ? 2 : 4;
  const long long wd[3] = {bn, Kr, P}, ws[2] = {bn, Kr * bn};
  const long long sd[3] = {bn, G, P}, ss[2] = {bn * es, G * bn * es};
  const int wb[3] = {kQtN, PACKED ? kQtK / 2 : kQtK, 1}, sb[3] = {kQtN, kQtK / group, 1};
  if (!make_map_2d(&xmap, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, K, kQtK, BM, true))
    return cudaErrorNotSupported;
  wmap = smap = xmap;
  if (tma_w && (!make_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wd, ws, wb, true) ||
                !make_map(&smap, sc, s_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          3, sd, ss, sb, false)))
    return cudaErrorNotSupported;
  const cudaError_t attr = allow_smem<qmm_tile_kernel<BM, PACKED>>(S::kSmem);
  if (attr != cudaSuccess) return attr;
  qmm_tile_kernel<BM, PACKED><<<ctas, kQtThreads, S::kSmem, st>>>(
      xmap, wmap, smap, tma_w, q, sc, s_f16, dq16, out, out_f32, ks > 1 ? partial : nullptr, ks,
      M, K, N, bn, group, zero);
  if (ks > 1) {   // the splits' sums added in split order
    const long long mn = (long long)M * N;
    const unsigned blocks = (unsigned)((mn + 255) / 256);
    if (out_f32)
      reduce_partials_kernel<float><<<blocks, 256, 0, st>>>(partial, static_cast<float*>(out), ks,
                                                            mn);
    else
      reduce_partials_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          partial, static_cast<__nv_bfloat16*>(out), ks, mn);
  }
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_tiles(int bm, const void* xb, const uint8_t* q, const void* sc, int s_f16,
                         int dq16, void* out, int out_f32, float* partial, int ks, int ctas,
                         int M, int K, int N, int bn, int group, float zero, cudaStream_t st) {
#define QMM_TILE(BM)                                                                     \
  case BM:                                                                               \
    return launch_tile<BM, PACKED>(xb, q, sc, s_f16, dq16, out, out_f32, partial, ks, ctas, \
                                   M, K, N, bn, group, zero, st)
  switch (bm) {
    QMM_TILE(16);
    QMM_TILE(32);
    QMM_TILE(64);
    QMM_TILE(128);
    QMM_TILE(192);
    QMM_TILE(256);
  }
#undef QMM_TILE
  return cudaErrorInvalidValue;
}

// the blocks' shared memory: the 4 warps' rings, then x of the longest
// K range in bf16
template <bool PACKED>
constexpr int stream_smem(int M, int kc) {
  return kStreamWarps * Stage<PACKED, false>::kRing * Stage<PACKED, false>::kBytes + M * kc * 2;
}

template <typename XT, bool PACKED, bool DQ16>
cudaError_t launch_stream(const XT* x, const uint8_t* q, const void* sc, int s_f16,
                          void* scratch, unsigned int* tickets, XT* out, int M, int K, int N,
                          int bn, int group, float zero, int ks, cudaStream_t st) {
  const int groups = (N + kStreamWarps * kWarpCols - 1) / (kStreamWarps * kWarpCols);
  const int kc = (K / 32 + ks - 1) / ks * 32;
  if (M * kc > kStreamX ||
      (ks > 1 && (groups > kMaxTickets || scratch == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t attr =
      allow_smem<qmm_stream_kernel<XT, PACKED, DQ16>>(stream_smem<PACKED>(1, kStreamX));
  if (attr != cudaSuccess) return attr;
  qmm_stream_kernel<XT, PACKED, DQ16>
      <<<dim3(groups, ks), kStreamWarps * 32, stream_smem<PACKED>(M, kc), st>>>(
          x, q, sc, s_f16, static_cast<float*>(scratch), tickets, out, M, K, N, bn, group, zero,
          ks);
  return cudaGetLastError();
}

template <typename XT, bool PACKED>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out,
                   void* scratch, unsigned int* tickets, int M, int K, int N, int bn,
                   int group, int s_f16, int off, int fast, int dq16, int ksplit, int bm,
                   int ctas, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  const float zero = zero_point(PACKED, off);
  if (M <= 8 && fast) {
    return dq16 ? launch_stream<XT, PACKED, true>(xp, qp, sc, s_f16, scratch, tickets, op, M,
                                                  K, N, bn, group, zero, ksplit, st)
                : launch_stream<XT, PACKED, false>(xp, qp, sc, s_f16, scratch, tickets, op, M,
                                                   K, N, bn, group, zero, ksplit, st);
  } else if (M <= 8) {
    const dim3 grid((N + kSmallCols - 1) / kSmallCols, ksplit);
    float* partial = ksplit > 1 ? static_cast<float*>(scratch) : nullptr;
#define QMM_SMALL(MT)                                                             \
  qmm_small_kernel<XT, PACKED, MT><<<grid, kSmallWarps * 32, 0, st>>>(            \
      xp, qp, sc, s_f16, partial, op, M, K, N, bn, group, zero)
    if (M == 1) QMM_SMALL(1);
    else if (M == 2) QMM_SMALL(2);
    else if (M <= 4) QMM_SMALL(4);
    else QMM_SMALL(8);
#undef QMM_SMALL
    if (ksplit > 1) {
      const long long mn = (long long)M * N;
      reduce_partials_kernel<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          partial, op, ksplit, mn);
    }
  } else if (!fast) {
    const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    qmm_fma_kernel<XT, PACKED><<<grid, kTileThreads, 0, st>>>(
        xp, qp, sc, s_f16, op, M, K, N, bn, group, zero);
  } else {
    // scratch: the splits' float32 sums, then (float32 x) x in bf16
    float* partial = ksplit > 1 ? static_cast<float*>(scratch) : nullptr;
    const void* xb = x;
    if constexpr (std::is_same_v<XT, float>) {   // x rounded once to bf16 first
      if (scratch == nullptr) return cudaErrorInvalidValue;
      __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(
          static_cast<char*>(scratch) + (ksplit > 1 ? (long long)ksplit * M * N * 4 : 0));
      const long long n = (long long)M * K;
      round_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(xp, xr, n);
      xb = xr;
    }
    return launch_tiles<PACKED>(bm, xb, qp, sc, s_f16, dq16, op, std::is_same_v<XT, float>,
                                partial, ksplit, ctas, M, K, N, bn, group, zero, st);
  }
  return cudaGetLastError();
}

}  // namespace

// x (M, K) float32 or bf16; q int8 values or, packed, nibble bytes, as
// N / bn column panels of (K or K / 2, bn), bn = N for a row-major weight;
// sc (N / bn, K / group, bn) float16 or float32; out (M, N) in x's type.
// scratch: float32 (ksplit, M, N) when ksplit > 1, followed, when M > 8,
// fast and x is float32, by bf16 (M, K), x rounded for the tensor cores.
// tickets (fast mode, M <= 8, ksplit > 1): uint32, one per column group of
// 256, all 0, and no launch in flight at once may share them; the launch
// leaves them at 0.
// ksplit splits K: at M <= 8 over groups of 32 rows (fast mode: every
// split's values of x, M x its K range, at most 16384; more than one split
// at most 4096 column groups of 256), at M > 8 in fast mode over the
// 64-deep stages (at most their count); 1 in exact mode at M > 8. bm and
// ctas (fast mode, M > 8): the persistent tile's rows of x (16, 32, 64, 128,
// 192 or 256) and CTAs, from the launch plan.
// dq16 (fast mode only) rounds each scale to bf16 before the multiply, so
// that wr = bf16(v * bf16(s)), the TPU kernels' bf16-domain dequant; the M
// <= 8 kernel runs its own instantiations for it, the M > 8 tile a flag.
extern "C" int qa_quant_matmul(const void* x, const void* q, const void* sc, void* out,
                               void* scratch, void* tickets, int M, int K, int N, int bn,
                               int group, int x_bf16, int s_f16, int packed, int off, int fast,
                               int dq16, int ksplit, int bm, int ctas, void* stream) {
  const bool tile = M > 8 && fast;
  if (M < 1 || K % 32 || N % 16 || bn < 16 || bn % 16 || N % bn || (dq16 && !fast) ||
      (group != 16 && group != 32) || (packed && group != 32) || ksplit < 1 ||
      (N + kBN - 1) / kBN > 65535 || ksplit > 65535 || (M > 8 && !fast && ksplit != 1) ||
      (tile && (ksplit > (K + kQtK - 1) / kQtK || ctas < 1 ||
                (bm != 16 && bm != 32 && bm != 64 && bm != 128 && bm != 192 && bm != 256))) ||
      (ksplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* scr = scratch;
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  cudaError_t rc;
  if (x_bf16) {
    rc = packed ? launch<__nv_bfloat16, true>(x, q, sc, out, scr, tk, M, K, N, bn, group,
                                              s_f16, off, fast, dq16, ksplit, bm, ctas, st)
                : launch<__nv_bfloat16, false>(x, q, sc, out, scr, tk, M, K, N, bn, group,
                                               s_f16, off, fast, dq16, ksplit, bm, ctas, st);
  } else {
    rc = packed ? launch<float, true>(x, q, sc, out, scr, tk, M, K, N, bn, group, s_f16, off,
                                      fast, dq16, ksplit, bm, ctas, st)
                : launch<float, false>(x, q, sc, out, scr, tk, M, K, N, bn, group, s_f16, off,
                                       fast, dq16, ksplit, bm, ctas, st);
  }
  return (int)rc;
}

// *id: the id of the CUDA-graph capture under way on the stream, or 0 where
// none is (the key of the caller's ticket arrays).
extern "C" int qa_stream_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long cid = 0;
  const cudaError_t rc =
      cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &cid);
  *id = status == cudaStreamCaptureStatusActive ? cid : 0;
  return (int)rc;
}
