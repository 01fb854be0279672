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
//   25.7 MFLOP. qmm_small_kernel streams the weight once: a lane owns 4
//   neighbouring columns (one 4-byte load per k row, a warp reads 128
//   contiguous bytes), a warp owns whole 32-row blocks of K, and K is split
//   over the 4 warps of a block and over gridDim.y blocks so that about four
//   blocks per SM are in flight even where N / 128 is 28. The 4 warps meet
//   in shared memory in a fixed order; with more than one split the blocks
//   write float32 partial sums (S, M, N) and reduce_partials_kernel adds them in
//   split order, so the result does not vary from run to run (no atomics).
//   Bytes become floats by the 2^23 trick (byte_perm into the mantissa of
//   0x4B000000, one subtract), which is exact and needs no int8 negation.
// - M > 8 (prefill M = 752, the encoder M = 1500): operations (gate_up of
//   the 7B tower at M = 752: 204 GFLOP, 0.21 ms at 989 TFLOP/s in bf16).
//   fast mode: qmm_wgmma_kernel, 128 x 128 output tiles, K in stages of 64.
//   The tensor cores take shared-memory operands at full rate only through
//   wgmma, so the kernel is built around keeping wgmma fed, in roles that
//   run at once (544 threads):
//   * a producer warp issues every load as TMA boxes (hopper_mma.cuh): x,
//     bf16, in the 128-byte-swizzled K-major layout wgmma reads (float32 x
//     is rounded once, round to nearest even, by round_bf16_kernel into
//     scratch first), the stage's raw weight bytes (64 rows, or 32 nibble
//     rows, of 128 columns) and its scales; a stacked layer is a base
//     pointer, a panel weight a 3-D box, and TMA zero-fills past the ragged
//     M, N and K edges. Where a panel is narrower than the tile and not the
//     whole N, the producer's lanes copy 16-byte chunks with cp.async
//     instead (bn % 16 == 0, so no chunk straddles a panel);
//   * two transform warpgroups turn each raw stage into the bf16 B operand,
//     w = bf16(float(v) * s) (DQ16: s rounded to bf16 first), K-major and
//     swizzled, a chunk of 8 values of K at 4 columns a thread; the chunks
//     rotate over the lanes, so that neither the raw reads nor the swizzled
//     writes collide on a bank. The dequantize is off the product warps
//     and is paid once per 128 rows of x;
//   * two consumer warpgroups run wgmma m64n128k16 (float32 accumulate),
//     one stage's products in flight while the next is issued.
//   Rings of 4 x/B stages and 4 raw stages, with mbarrier completion, let
//   the three run ahead of one another. What bounds it on the H100 is not
//   the tensor cores (about 512 cycles a stage) but the delivery of x and
//   the raw stages (26 KB a stage, re-read by every block of the other
//   dimension): the consumers wait for data about as long as they compute
//   (PERF.md). Where the tiles fill a second wave of SMs less than half
//   (the prefill's o and down projections, 168 tiles on 132 SMs), the
//   wrapper splits K in two over blockIdx.z and reduce_partials_kernel adds
//   the two float32 partial sums in order. The float32 sums run in the
//   tensor cores' order: the results are held to a tolerance against the
//   plain version, and the panel entries, which read the same values in the
//   same order, give the strided entry's bits.
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

constexpr int kSmallCols = 128;    // columns per block: 32 lanes x 4
constexpr int kSmallWarps = 4;

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

template <typename XT, bool PACKED, int MT, bool DQ16>
__global__ void __launch_bounds__(kSmallWarps * 32)
qmm_small_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
                 const void* __restrict__ sc, int s_f16, float* __restrict__ partial,
                 XT* __restrict__ out, int M, int K, int N, int bn, int group, float zero,
                 int fast) {
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
      block32_fma<XT, PACKED, false, MT, DQ16>(
          acc, q + at.q + (long long)(PACKED ? k0 / 2 : k0) * bn, bn, sc, s_f16, nullptr,
          at.s + (long long)(k0 / group) * bn, at.s + (long long)((k0 + 16) / group) * bn,
          zero, fast, x + k0, K, M);
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

// fast mode: TMA-fed wgmma, 544 threads in roles that never reconverge:
//   warpgroups 0, 1   consumers: rows 64 w .. 64 w + 63 of the block's
//                     128 x 128 tile, wgmma m64n128k16 from the stage's x
//                     tile and dequantized weight tile, float32 registers
//   warpgroups 2, 3   transform: the stage's (64, 128) raw weight dequantized
//                     to bf16 in the K-major swizzled B layout, a chunk of
//                     8 values of K at 4 columns a thread
//   warp 16           producer: the x tile, the raw weight bytes and the
//                     scales by TMA (by cp.async for panels narrower than
//                     the tile), as far ahead as the rings allow
// The consumers need about 100 registers, so no setmaxnreg: the kernel's
// cap at 544 threads leaves them enough.
// Stages of 64 values of K. Rings: kStages x/B stages (full_x: TMA bytes,
// full_b: 256 transform arrivals, empty: 256 consumer arrivals) and
// kRawStages raw stages (raw_full: 32 producer lanes, raw_empty: 256
// transform arrivals).
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64, kWgThreads = 544;
constexpr int kStages = 4, kRawStages = 4;
constexpr int kXBytes = kWgBM * kSwizzleRow;    // (128, 64) bf16
constexpr int kBBytes = kWgBN * kSwizzleRow;    // (128 n, 64 k) bf16
constexpr int kRawW = kWgBK * kWgBN;            // 64 byte rows of 128 columns
constexpr int kRawS = 4 * kWgBN * 4;            // <= 4 scale rows of float32
constexpr int kWgSmem = kStages * (kXBytes + kBBytes) + kRawStages * (kRawW + kRawS) +
                        (3 * kStages + 2 * kRawStages) * 8 + 1024;

// The transform's unit of work: values 8 c .. 8 c + 7 of a stage at columns
// 4 q .. 4 q + 3, from a raw stage (rw: byte rows of kWgBN columns, rs: the
// stage's scale rows, float16 or float32) to the K-major swizzled bf16 B
// tile bd: w = bf16(float(v) * s), DQ16 rounding s to bf16 first.
template <bool PACKED, bool DQ16>
__device__ __forceinline__ void dequant_chunk(const uint8_t* rw, const uint8_t* rs, int s_f16,
                                              int group, float zero, int c, int q,
                                              uint8_t* bd) {
  const int sr = 8 * c / group;
  float sv[4];
  if (s_f16) {
    const uint2 h = *reinterpret_cast<const uint2*>(rs + sr * kWgBN * 2 + q * 8);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&h.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&h.y));
    sv[0] = a.x; sv[1] = a.y; sv[2] = b.x; sv[3] = b.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(rs + sr * kWgBN * 4 + q * 16);
    sv[0] = f.x; sv[1] = f.y; sv[2] = f.z; sv[3] = f.w;
  }
  if (DQ16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[j] = round_bf16(sv[j]);
  }
  uint32_t rw8[8];
  if (PACKED) {   // byte row g * 16 + j: value g * 32 + j low, + 16 high
    const int g = c >> 2, kk = (c & 3) * 8, sh = kk >= 16 ? 4 : 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rw8[r] = (*reinterpret_cast<const uint32_t*>(rw + (g * 16 + (kk & 15) + r) * kWgBN + q * 4) >>
                sh) &
               0x0F0F0F0Fu;
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rw8[r] = *reinterpret_cast<const uint32_t*>(rw + (8 * c + r) * kWgBN + q * 4) ^ 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = (byte_as_float(rw8[r], j) - zero) * sv[j];
    *reinterpret_cast<uint4*>(bd + swizzle_chunk(4 * q + j, c)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  }
}

// A consumer warpgroup's (64, 8 NJ) float32 sums (wgmma's fragment: rows
// r and r + 8, columns 8 j + 2 (lane % 4) + 0, 1) to out in its type, or to
// the split's float32 partial sums.
template <int NJ, typename OT>
__device__ __forceinline__ void store_tile(const float (&acc)[4 * NJ], OT* out, float* partial,
                                           int M, int N, int r0, int n0) {
  const int lane = threadIdx.x & 31, wq4 = (threadIdx.x >> 5) & 3;
  const int ra = r0 + wq4 * 16 + (lane >> 2), rb = ra + 8;
  float* p = partial != nullptr ? partial + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col < N) {
      if (p != nullptr) {
        if (ra < M) store2(p + (long long)ra * N + col, acc[4 * j], acc[4 * j + 1]);
        if (rb < M) store2(p + (long long)rb * N + col, acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        if (ra < M) store2(out + (long long)ra * N + col, acc[4 * j], acc[4 * j + 1]);
        if (rb < M) store2(out + (long long)rb * N + col, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <typename OT, bool PACKED, bool DQ16>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap smap, int tma_w,
                 const uint8_t* __restrict__ q, const void* __restrict__ sc, int s_f16,
                 OT* __restrict__ out, float* __restrict__ partial, int ks, int M, int K, int N,
                 int bn, int group, float zero) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* xs = smem;
  uint8_t* bs = xs + kStages * kXBytes;
  uint8_t* raw_w = bs + kStages * kBBytes;
  uint8_t* raw_s = raw_w + kRawStages * kRawW;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(raw_s + kRawStages * kRawS);
  uint64_t* full_b = full_x + kStages;
  uint64_t* empty = full_b + kStages;
  uint64_t* raw_full = empty + kStages;
  uint64_t* raw_empty = raw_full + kRawStages;

  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  // blockIdx.z takes stages kt0 .. kt0 + steps - 1 of K (the split ks
  // divides the stage count)
  const int steps = (K + kWgBK - 1) / kWgBK / ks, kt0 = blockIdx.z * steps;
  constexpr int RROWS = PACKED ? kWgBK / 2 : kWgBK;   // raw byte rows a stage
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_x[s], 1);
      mbar_init(&full_b[s], 256);
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(&raw_full[s], tma_w ? 1 : 32);
      mbar_init(&raw_empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 512) {
    // ---- producer ----
    const int lane = threadIdx.x & 31;
    const int Kr = PACKED ? K / 2 : K, G = K / group;
    const int es = s_f16 ? 2 : 4, SR = kWgBK / group;
    if (tma_w) {   // the tile lies inside one panel: two boxes a stage
      if (lane == 0) {
        const int pc = n0 % bn, pp = n0 / bn;
        for (int kt = 0; kt < steps; ++kt) {
          const int slot = kt % kRawStages, s = kt % kStages;
          mbar_wait(&raw_empty[slot], ((kt / kRawStages) & 1) ^ 1);
          mbar_expect_tx(&raw_full[slot], (RROWS + SR * es) * kWgBN);
          tma_load_3d(raw_w + slot * kRawW, &wmap, &raw_full[slot], pc, (kt0 + kt) * RROWS, pp);
          tma_load_3d(raw_s + slot * kRawS, &smap, &raw_full[slot], pc, (kt0 + kt) * SR, pp);
          mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
          mbar_expect_tx(&full_x[s], kXBytes);
          tma_load_2d(xs + s * kXBytes, &xmap, &full_x[s], (kt0 + kt) * kWgBK, m0);
        }
      }
    } else {   // panels narrower than the tile: 16-byte cp.async chunks
      const int cpr = 8 * es;
      // weight chunk i = lane + 32 u: byte row i / 8, 16 columns at (i % 8) * 16
      const int wcol = n0 + (lane & 7) * 16;
      const long long wq = wcol < N ? panel_at(wcol, bn, Kr, G).q : 0;
      // scale chunk i = lane + 32 u: row i / cpr, 16 / es columns at i % cpr
      const int scol = n0 + (lane % cpr) * (16 / es);
      const long long sq = scol < N ? panel_at(scol, bn, Kr, G).s : 0;
      const uint8_t* scb = static_cast<const uint8_t*>(sc);
      for (int kt = 0; kt < steps; ++kt) {
        const int slot = kt % kRawStages, s = kt % kStages;
        mbar_wait(&raw_empty[slot], ((kt / kRawStages) & 1) ^ 1);
        const int r0 = (kt0 + kt) * RROWS;
#pragma unroll
        for (int u = 0; u < RROWS * 8 / 32; ++u) {
          const int i = lane + 32 * u, r = r0 + (i >> 3);
          cp_async16(raw_w + slot * kRawW + i * 16, q + wq + (long long)r * bn,
                     wcol < N && r < Kr);
        }
        for (int i = lane; i < SR * cpr; i += 32) {
          const int sr = (kt0 + kt) * SR + i / cpr;
          cp_async16(raw_s + slot * kRawS + i * 16, scb + (sq + (long long)sr * bn) * es,
                     scol < N && sr < G);
        }
        cp_async_arrive(&raw_full[slot]);
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full_x[s], kXBytes);
          tma_load_2d(xs + s * kXBytes, &xmap, &full_x[s], (kt0 + kt) * kWgBK, m0);
        }
      }
      cp_async_wait_all();   // no copy outlives its thread
    }
  } else if (threadIdx.x >= 256) {
    // ---- transform ----
    const int t = threadIdx.x - 256, lane = t & 31, w = t >> 5;
    // values 8 c .. 8 c + 7 of the stage at columns 4 lane .. 4 lane + 3;
    // the c of neighbouring lanes differ, so neither the raw reads nor the
    // swizzled 16-byte writes collide on a bank
    const int c = (lane + w) & 7;
    for (int kt = 0; kt < steps; ++kt) {
      const int slot = kt % kRawStages, s = kt % kStages;
      mbar_wait(&raw_full[slot], (kt / kRawStages) & 1);
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      dequant_chunk<PACKED, DQ16>(raw_w + slot * kRawW, raw_s + slot * kRawS, s_f16,
                                          group, zero, c, lane, bs + s * kBBytes);
      mbar_arrive(&raw_empty[slot]);
      fence_async_shared();
      mbar_arrive(&full_b[s]);
    }
  } else {
    // ---- consumers ----
    const int wg = threadIdx.x >> 7;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      mbar_wait(&full_x[s], par);
      mbar_wait(&full_b[s], par);
      const uint64_t a = wgmma_desc(xs + s * kXBytes + wg * 64 * kSwizzleRow);
      const uint64_t b = wgmma_desc(bs + s * kBBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWgBK / 16; ++k) wgmma_bf16_n128(acc, a + 2 * k, b + 2 * k, 1);
      wgmma_commit();
      if (kt > 0) {   // the previous stage's products are done: free its slot
        wgmma_wait<1>();
        mbar_arrive(&empty[(kt - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
    store_tile<16>(acc, out, partial, M, N, m0 + wg * 64, n0);
  }
}

// x rounded once to bf16 (round to nearest even), the wgmma tile's A operand
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

template <typename OT, bool PACKED, bool DQ16>
cudaError_t launch_wgmma(const void* xb, const uint8_t* q, const void* sc, int s_f16, OT* out,
                         float* partial, int ks, int M, int K, int N, int bn, int group,
                         float zero, cudaStream_t st) {
  const int mt = (M + kWgBM - 1) / kWgBM;
  const int tma_w = bn >= kWgBN && (bn % kWgBN == 0 || bn == N);
  // x (M, K) bf16 in swizzled (128, 64) boxes; the weight's raw bytes and
  // scales as (panels, rows, bn) in boxes of one stage's rows and 128 columns
  CUtensorMap xmap, wmap, smap;
  const long long P = N / bn, Kr = PACKED ? K / 2 : K, G = K / group, es = s_f16 ? 2 : 4;
  const long long wd[3] = {bn, Kr, P}, ws[2] = {bn, Kr * bn};
  const long long sd[3] = {bn, G, P}, ss[2] = {bn * es, G * bn * es};
  const int wb[3] = {kWgBN, PACKED ? kWgBK / 2 : kWgBK, 1}, sb[3] = {kWgBN, kWgBK / group, 1};
  if (!make_map_2d(&xmap, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, K, kWgBK, kWgBM, true))
    return cudaErrorNotSupported;
  wmap = smap = xmap;
  if (tma_w && (!make_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wd, ws, wb, false) ||
                !make_map(&smap, sc, s_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          3, sd, ss, sb, false)))
    return cudaErrorNotSupported;
  const cudaError_t attr = allow_smem<qmm_wgmma_kernel<OT, PACKED, DQ16>>(kWgSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(mt, (N + kWgBN - 1) / kWgBN, ks);
  qmm_wgmma_kernel<OT, PACKED, DQ16><<<grid, kWgThreads, kWgSmem, st>>>(
      xmap, wmap, smap, tma_w, q, sc, s_f16, out, ks > 1 ? partial : nullptr, ks, M, K, N, bn,
      group, zero);
  if (ks > 1) {   // the splits' sums added in split order
    const long long mn = (long long)M * N;
    reduce_partials_kernel<OT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(partial, out, ks,
                                                                              mn);
  }
  return cudaGetLastError();
}

template <typename XT, bool PACKED>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out,
                   void* scratch, int M, int K, int N, int bn, int group, int s_f16,
                   int off, int fast, int dq16, int ksplit, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  const float zero = zero_point(PACKED, off);
  if (M <= 8) {
    const dim3 grid((N + kSmallCols - 1) / kSmallCols, ksplit);
    float* partial = ksplit > 1 ? static_cast<float*>(scratch) : nullptr;
#define QMM_SMALL(MT, DQ16)                                                        \
  qmm_small_kernel<XT, PACKED, MT, DQ16><<<grid, kSmallWarps * 32, 0, st>>>(       \
      xp, qp, sc, s_f16, partial, op, M, K, N, bn, group, zero, fast)
#define QMM_SMALL_M(DQ16)                                                          \
  if (M == 1) QMM_SMALL(1, DQ16);                                                  \
  else if (M == 2) QMM_SMALL(2, DQ16);                                             \
  else if (M <= 4) QMM_SMALL(4, DQ16);                                             \
  else QMM_SMALL(8, DQ16)
    if (dq16) {
      QMM_SMALL_M(true);
    } else {
      QMM_SMALL_M(false);
    }
#undef QMM_SMALL_M
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
    return dq16 ? launch_wgmma<XT, PACKED, true>(xb, qp, sc, s_f16, op, partial, ksplit, M, K,
                                                 N, bn, group, zero, st)
                : launch_wgmma<XT, PACKED, false>(xb, qp, sc, s_f16, op, partial, ksplit, M,
                                                  K, N, bn, group, zero, st);
  }
  return cudaGetLastError();
}

}  // namespace

// x (M, K) float32 or bf16; q int8 values or, packed, nibble bytes, as
// N / bn column panels of (K or K / 2, bn), bn = N for a row-major weight;
// sc (N / bn, K / group, bn) float16 or float32; out (M, N) in x's type.
// scratch: float32 (ksplit, M, N) when ksplit > 1, followed, when M > 8,
// fast and x is float32, by bf16 (M, K), x rounded for the tensor cores.
// ksplit splits K: at M <= 8 over blocks of 32 rows, at M > 8 in fast mode
// over the 64-deep stages (it divides their count); 1 in exact mode at
// M > 8.
// dq16 (fast mode only) rounds each scale to bf16 before the multiply, so
// that wr = bf16(v * bf16(s)), the TPU kernels' bf16-domain dequant; it runs
// its own instantiations, and the default ones compile as without it.
extern "C" int qa_quant_matmul(const void* x, const void* q, const void* sc, void* out,
                               void* scratch, int M, int K, int N, int bn, int group,
                               int x_bf16, int s_f16, int packed, int off, int fast,
                               int dq16, int ksplit, void* stream) {
  if (M < 1 || K % 32 || N % 16 || bn < 16 || bn % 16 || N % bn || (dq16 && !fast) ||
      (group != 16 && group != 32) || (packed && group != 32) || ksplit < 1 ||
      (N + kBN - 1) / kBN > 65535 || ksplit > 65535 ||
      (M > 8 && (!fast ? ksplit != 1 : (K + kWgBK - 1) / kWgBK % ksplit != 0)) ||
      (ksplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* scr = scratch;
  cudaError_t rc;
  if (x_bf16) {
    rc = packed ? launch<__nv_bfloat16, true>(x, q, sc, out, scr, M, K, N, bn, group,
                                              s_f16, off, fast, dq16, ksplit, st)
                : launch<__nv_bfloat16, false>(x, q, sc, out, scr, M, K, N, bn, group,
                                               s_f16, off, fast, dq16, ksplit, st);
  } else {
    rc = packed ? launch<float, true>(x, q, sc, out, scr, M, K, N, bn, group, s_f16, off,
                                      fast, dq16, ksplit, st)
                : launch<float, false>(x, q, sc, out, scr, M, K, N, bn, group, s_f16, off,
                                       fast, dq16, ksplit, st);
  }
  return (int)rc;
}
