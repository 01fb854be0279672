// Exact-integer group matmul over ggml block weights for Hopper (sm_90a),
// plain C interface for ctypes: qa_quantize_q8_1, qa_quant_matmul_int8.
//
// Replaces the TPU kernels _kernel (flat int8 values) and _kernel_stacked
// (int8 values or packed nibbles over (L, K, N), the layer picked inside) of
// qwen2_audio_tpu/ops/quant_matmul_int8.py, and _kernel_q4b_stacked (nibbles
// in int32 words) of qwen2_audio_tpu/ops/quant_matmul_q4b.py: ggml's mmq
// numerics. As for quant_matmul.cu, a layer is a base pointer and a flat
// weight is a stacked one at layer 0, so one device function serves all.
//
// What it computes, for x (M, K) and integer weight values v (K, N) with one
// scale sw per 32-group of a column:
//   xq, sx = q8_1(x)   ggml's quantize_row_q8_1 per row and 32-group: sx =
//                      amax / 127, inv = 1 / sx (0 where sx is 0), xq =
//                      round-half-even(x * inv), IEEE roundings as in the
//                      plain version (bit-equal; no fast math here)
//   p[m, g, n] = sum over k in g of xq[m, k] * v[k, n]      exact, int32
//   out[m, n]  = sum over g of float(p) * (sx[m, g] * sw[g, n])   float32
// cast to x's type. The weight forms, each read as it is stored:
//   strided (form 0): int8 values (K, N), q8_0 / q5_0 / q5_1 (-128 taken);
//   packed  (form 1): nibble bytes (K / 2, N), byte row g * 16 + j holding
//                     k = g * 32 + j (low) and k + 16 (high), ggml's pairing;
//   words   (form 2): int32 words (K / 8, N), word r of a column holding byte
//                     rows 4r .. 4r + 3 of the packed form, least significant
//                     first.
// Nibbles are v = nibble - off, off 8 for symmetric q4_0 (subtracted from
// every byte of a word at once: ((p | 0x80808080) - 0x08080808) ^
// 0x80808080) or 0 where the caller adds the mins outside.
//
// What bounds it:
// - M <= 8 (a decode step): the weight bytes (gate_up of the 7B tower, q8_0:
//   136 MB, 41 us at 3.35 TB/s). qmm8_small_kernel streams the weight once,
//   as qmm_small_kernel of quant_matmul.cu does: a lane owns 4 neighbouring
//   columns, a warp owns whole 32-groups of K, K is split over the 4 warps of
//   a block and over gridDim.y blocks, partial sums meet in shared memory in
//   a fixed order and, with a split, in reduce_partials_kernel in split
//   order: no atomics, the same bits from run to run. The warp quantizes its
//   own group of the <= 8 rows of x (a shuffle max, the same device function
//   as the standalone kernel, so every block sees the same xq): no extra
//   launch per linear in the host-bound decode loop. Group dots are __dp4a.
// - M > 8 (the 752-position prefill, the encoder's 1500 rows): 2 M K N int8
//   operations (fc1 of the encoder 19.7 G, 10 us at 1979 TOP/s) and, what
//   sets the pace, the rescale of every group's integer dot on the CUDA
//   cores: M N K / 32 (output, group) pairs (gate_up at M = 752: 3.19 G),
//   each an exact int -> float, a multiply sx * sw and an FMA, which ggml's
//   numerics (the float32 sum in group order) do not let us skip.
//   quantize_q8_1_kernel first writes xq (M, K) and sx transposed (K / 32,
//   M rounded up to 4, so that its rows are 16-byte aligned); then
//   qmm8_wgmma_kernel runs 128 x 128 output tiles, K in stages of four
//   groups, 384 threads:
//   * xq (in the 128-byte-swizzled K-major layout wgmma reads), the
//     stage's raw weight (any of the three forms), sw and sx arrive as TMA
//     boxes (hopper_mma.cuh), zeros past M, N and K;
//   * wgmma takes s8 operands K-major only, and the weight is stored with N
//     fastest, so a transform warpgroup turns each raw stage into the K-major
//     B tile with transpose_bytes and the nibble unpacking below (the words
//     form needs no transpose), and the scales into float32 rows beside it;
//     its thread 0 also issues the loads;
//   * two consumer warpgroups run one wgmma m64n128k32 (s32, zeroed) per
//     group, then c = fmaf(float(p), sx * sw, c) per output, float(p) by the
//     exact 2^22 trick (small_int_to_float: an integer add and a subtract
//     in place of a conversion). A group's dot is at most 32 * 128 * 127 <
//     2^22 in magnitude.
//   The rescale's 4 instructions per (output, group) are the floor (gate_up
//   at M = 752: 0.46 ms at one warp instruction per clock per SM
//   sub-partition); measured on the H100 the kernel runs at about twice
//   that, as each group's product latency is not hidden. Keeping two s32
//   register sets to hide it did not pay: at 64 + 2 x 64 values a thread the
//   consumers spill, and two half-width products per group or a fixed
//   alternation of the two warpgroups measured slower (PERF.md).
//   The integer dots are exact and each output's float32 arithmetic (one
//   FMA per group, in group order) does not depend on the tiling, so any
//   tiling gives the same bits (qmm_ab.py's digests hold two builds to it).
//
// One layout fact carries the three forms: the low nibbles of word 4g + r
// of the words form are k = 32 g + 4 r + 0..3 of its column, its high
// nibbles the same + 16, in the order the K-major B operand wants them. The
// packed form gathers the same 4 values from 4 byte rows with __byte_perm,
// and the strided form gathers k .. k + 3 of a column from 4 rows the same
// way, so the three forms feed the same integer products: the packed and the
// words forms of the same bytes give the same bits.
//
// N must be a multiple of 16 and K of 32 (the wrapper checks); the kernels
// mask their own ragged M and N edges and pad nothing in device memory.

#include "hopper_mma.cuh"
#include "qmm_common.cuh"




namespace {

using namespace qa;

constexpr int kGroup = 32;
constexpr int kStrided = 0, kPacked = 1, kWords = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q8_1 of one value whose lane holds it: the warp's 32 lanes are the group.
// Returns xq, sets sx; every rounding is IEEE round-to-nearest-even.
__device__ __forceinline__ int q8_1_lane(float v, float& sx) {
  sx = __fdiv_rn(warp_max(fabsf(v)), 127.f);
  const float inv = sx > 0.f ? __fdiv_rn(1.f, sx) : 0.f;
  return static_cast<int>(rintf(__fmul_rn(v, inv)));
}

// c[i] holds byte i of r0, r1, r2, r3 in its bytes 0..3: the 4 x 4 transpose
__device__ __forceinline__ void transpose_bytes(uint32_t r0, uint32_t r1, uint32_t r2,
                                                uint32_t r3, uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t swar_sub8(uint32_t p) {
  return ((p | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// a words-form word -> its low quad (k = 4r .. 4r + 3) and high quad (+ 16)
// as 4 int8 values each
__device__ __forceinline__ void nibble_quads(uint32_t w, int off, uint32_t& lo,
                                             uint32_t& hi) {
  lo = w & 0x0F0F0F0Fu;
  hi = (w >> 4) & 0x0F0F0F0Fu;
  if (off) {
    lo = swar_sub8(lo);
    hi = swar_sub8(hi);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The words-form words of 4 neighbouring columns (col .. col + 3) for word
// rows 4 gi + r, from either nibble form: w[c][r].
template <int FORM>
__device__ __forceinline__ void nibble_words(const uint8_t* __restrict__ q, int N, int gi,
                                             int r, int col, uint32_t (&w)[4]) {
  if constexpr (FORM == kPacked) {
    const uint8_t* p = q + ((long long)gi * 16 + 4 * r) * N + col;
    transpose_bytes(ld32(p), ld32(p + N), ld32(p + 2 * N), ld32(p + 3 * N), w);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const uint32_t*>(q) + ((long long)gi * 4 + r) * N + col);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// ------------------------------------------------------------------------- //
// q8_1 of x: one warp per row and group
// ------------------------------------------------------------------------- //

template <typename XT>
__global__ void __launch_bounds__(256)
quantize_q8_1_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K, int ldt) {
  const int G = K / kGroup;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= (long long)M * G) return;   // the whole warp
  const int m = (int)(w / G), g = (int)(w % G), lane = threadIdx.x & 31;
  const long long i = (long long)m * K + g * kGroup + lane;
  float s;
  xq[i] = static_cast<int8_t>(q8_1_lane(to_float(x[i]), s));
  if (lane == 0) sx[ldt ? (long long)g * ldt + m : (long long)m * G + g] = s;
}

// ------------------------------------------------------------------------- //
// M <= 8: stream the weight once, x quantized on the fly
// ------------------------------------------------------------------------- //

constexpr int kSmallCols = 128;    // columns per block: 32 lanes x 4
constexpr int kSmallWarps = 4;

template <typename XT, int FORM, int MT>
__global__ void __launch_bounds__(kSmallWarps * 32)
qmm8_small_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
                  const void* __restrict__ sc, int s_f16, float* __restrict__ partial,
                  XT* __restrict__ out, int M, int K, int N, int off) {
  __shared__ __align__(16) float red[kSmallWarps][MT][kSmallCols];
  __shared__ __align__(16) int8_t xqs[kSmallWarps][MT][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kSmallCols + lane * 4;
  const bool live = col < N;
  const int n_warps = gridDim.y * kSmallWarps;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int gi = blockIdx.y * kSmallWarps + warp; gi < K / kGroup; gi += n_warps) {
    // the lane's weight: wq[c][i] = k 4i .. 4i + 3 of column col + c, int8
    uint32_t wq[4][8];
    float sw[4];
    if (live) {
      if constexpr (FORM == kStrided) {
        const uint8_t* p = q + (long long)gi * kGroup * N + col;
        uint32_t rows[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) rows[j] = ld32(p + (long long)j * N);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t c4[4];
          transpose_bytes(rows[4 * i], rows[4 * i + 1], rows[4 * i + 2], rows[4 * i + 3], c4);
#pragma unroll
          for (int c = 0; c < 4; ++c) wq[c][i] = c4[c];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t w4[4];
          nibble_words<FORM>(q, N, gi, r, col, w4);
#pragma unroll
          for (int c = 0; c < 4; ++c) nibble_quads(w4[c], off, wq[c][r], wq[c][4 + r]);
        }
      }
      load_scales4(sc, s_f16, (long long)gi * N + col, sw);
    }
    // this group of the <= 8 rows, quantized by the warp
    float sxm[MT];
    __syncwarp();   // the previous group's reads of xqs are done
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M)
        xqs[warp][m][lane] = static_cast<int8_t>(
            q8_1_lane(to_float(x[(long long)m * K + gi * kGroup + lane]), sxm[m]));
    }
    __syncwarp();
    if (live) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) continue;
        const int4* xw = reinterpret_cast<const int4*>(xqs[warp][m]);
        const int4 x0 = xw[0], x1 = xw[1];
        const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int p = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) p = __dp4a(static_cast<int>(wq[c][i]), xv[i], p);
          acc[m][c] = fmaf(static_cast<float>(p), __fmul_rn(sxm[m], sw[c]), acc[m][c]);
        }
      }
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
// M > 8: TMA-fed wgmma s8 tiles, 384 threads in roles that never reconverge:
//   warpgroups 0, 1   consumers: rows 64 w .. 64 w + 63 of the block's
//                     128 x 128 tile; per 32-group one wgmma m64n128k32
//                     (s32, zeroed), then the group's rescale
//   warpgroup 2       transform: the stage's raw weight (any form) as
//                     K-major int8 in the swizzled B layout, 2 x 16 values
//                     of K at 4 columns a thread, and sw, sx as float32 rows;
//                     its thread 0 issues the TMA loads of every stage
// Stages of 128 values of K (four groups); a ragged last stage runs only its
// groups. setmaxnreg moves registers from the transform to the consumers,
// which hold 64 float32 sums and 64 int32 products.
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 128, kWgThreads = 384;
constexpr int kStages = 3, kRawStages = 3;
constexpr int kXBytes = kWgBM * kSwizzleRow;        // (128, 128) s8
constexpr int kBBytes = kWgBN * kSwizzleRow;        // (128 n, 128 k) s8
constexpr int kScBytes = 4 * kWgBN * 4;             // 4 groups x 128, float32
constexpr int kRawW = kWgBK * kWgBN;                // the strided form's 128 rows
constexpr int kWgSmem = kStages * (kXBytes + kBBytes + 2 * kScBytes) +
                        kRawStages * (kRawW + 2 * kScBytes) +
                        (3 * kStages + kRawStages) * 8 + 1024;

// float(p) for |p| < 2^22, exactly: 1.5 * 2^23 + p has p in its mantissa
__device__ __forceinline__ float small_int_to_float(int p) {
  return __fsub_rn(__int_as_float(p + 0x4B400000), 12582912.f);
}

// c[4 i + e] += float(d[4 i + e]) * (sx * sw): rows r (e < 2) and r + 8,
// columns 8 i + 2 (lane % 4) + e % 2 of the tile (swr at the first)
__device__ __forceinline__ void rescale(float (&c)[64], const int (&d)[64], float sx0, float sx1,
                                       const float* swr) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 sw = *reinterpret_cast<const float2*>(swr + 8 * i);
    c[4 * i] = fmaf(small_int_to_float(d[4 * i]), __fmul_rn(sx0, sw.x), c[4 * i]);
    c[4 * i + 1] = fmaf(small_int_to_float(d[4 * i + 1]), __fmul_rn(sx0, sw.y), c[4 * i + 1]);
    c[4 * i + 2] = fmaf(small_int_to_float(d[4 * i + 2]), __fmul_rn(sx1, sw.x), c[4 * i + 2]);
    c[4 * i + 3] = fmaf(small_int_to_float(d[4 * i + 3]), __fmul_rn(sx1, sw.y), c[4 * i + 3]);
  }
}

// One stage's GV groups: per group one wgmma m64n128k32, then its rescale.
template <int GV>
__device__ __forceinline__ void consume_stage(float (&acc)[64], int (&d)[64], uint64_t a,
                                              uint64_t b, const float* sxg, const float* swg) {
#pragma unroll
  for (int j = 0; j < GV; ++j) {
    wgmma_fence();
    wgmma_s8_n128(d, a + 2 * j, b + 2 * j);
    wgmma_commit();
    wgmma_wait<0>();
    rescale(acc, d, sxg[j * kWgBM], sxg[j * kWgBM + 8], swg + j * kWgBN);
  }
}

template <typename XT, int FORM>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __grid_constant__ CUtensorMap sxmap, int s_f16, XT* __restrict__ out,
                  int M, int K, int N, int off) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* xs = smem;
  uint8_t* bs = xs + kStages * kXBytes;
  float* sws = reinterpret_cast<float*>(bs + kStages * kBBytes);   // [stage][g][n]
  float* sxs = sws + kStages * 4 * kWgBN;                           // [stage][g][m]
  uint8_t* raw_w = reinterpret_cast<uint8_t*>(sxs + kStages * 4 * kWgBM);
  uint8_t* raw_s = raw_w + kRawStages * kRawW;
  float* raw_x = reinterpret_cast<float*>(raw_s + kRawStages * kScBytes);
  uint64_t* full_x = reinterpret_cast<uint64_t*>(raw_x + kRawStages * 4 * kWgBM);
  uint64_t* full_b = full_x + kStages;
  uint64_t* empty = full_b + kStages;
  uint64_t* raw_full = empty + kStages;

  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int G = K / kGroup, steps = (G + 3) / 4;
  // raw weight rows a stage and bytes a row: 128 int8 rows, 64 nibble-byte
  // rows, or 16 word rows of 128 int32
  constexpr int RROWS = FORM == kStrided ? 128 : FORM == kPacked ? 64 : 16;
  constexpr int RB = FORM == kWords ? 512 : 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_x[s], 1);
      mbar_init(&full_b[s], 128);
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(&raw_full[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- transform; its thread 0 also issues the loads ----
    setmaxnreg_dec<72>();
    const int t = threadIdx.x - 256, lane = t & 31, w = t >> 5;
    const uint32_t raw_bytes = RROWS * RB + 4 * kWgBN * (s_f16 ? 2 : 4) + 4 * kWgBM * 4;
    auto load_raw = [&](int kt) {   // the stage's raw weight, sw and sx
      const int slot = kt % kRawStages;
      mbar_expect_tx(&raw_full[slot], raw_bytes);
      tma_load_2d(raw_w + slot * kRawW, &wmap, &raw_full[slot], n0, kt * RROWS);
      tma_load_2d(raw_s + slot * kScBytes, &smap, &raw_full[slot], n0, kt * 4);
      tma_load_2d(raw_x + slot * 4 * kWgBM, &sxmap, &raw_full[slot], m0, kt * 4);
    };
    auto load_x = [&](int kt) {   // the stage's xq, once the consumers are done with its slot
      const int s = kt % kStages;
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      mbar_expect_tx(&full_x[s], kXBytes);
      tma_load_2d(xs + s * kXBytes, &xmap, &full_x[s], kt * kWgBK, m0);
    };
    if (t == 0) {
      for (int kt = 0; kt < kRawStages - 1 && kt < steps; ++kt) load_raw(kt);
      load_x(0);
    }
    for (int kt = 0; kt < steps; ++kt) {
      const int slot = kt % kRawStages, s = kt % kStages;
      named_sync(1, 128);   // every transform thread is done with stage kt - 1's raw slot
      if (t == 0) {
        if (kt + kRawStages - 1 < steps) load_raw(kt + kRawStages - 1);
        if (kt + 1 < steps) load_x(kt + 1);
      }
      mbar_wait(&raw_full[slot], (kt / kRawStages) & 1);
      mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
      const uint8_t* rw = raw_w + slot * kRawW;
      uint8_t* bd = bs + s * kBBytes;
#pragma unroll 1
      for (int it = 0; it < 2; ++it) {   // not unrolled: the transform has few registers
        // values 16 c .. 16 c + 15 of the stage (group c / 2, half c % 2) at
        // columns 4 lane .. 4 lane + 3; the c of neighbouring lanes differ, so
        // the swizzled 16-byte writes do not collide on a bank
        const int c = (lane + 2 * w + it) & 7;
        uint32_t col4[4][4];   // col4[j][i]: k 4i .. 4i + 3 of the chunk, column 4 lane + j
        if constexpr (FORM == kWords) {   // word row 4g + i: k 4i.. (low), + 16 (high)
          const int sh = (c & 1) * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(rw + ((c >> 1) * 4 + i) * RB + lane * 16);
            const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t b = (wv[j] >> sh) & 0x0F0F0F0Fu;
              col4[j][i] = off ? swar_sub8(b) : b;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t r4[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if constexpr (FORM == kStrided) {
                r4[r] = *reinterpret_cast<const uint32_t*>(rw + (16 * c + 4 * i + r) * RB +
                                                           lane * 4);
              } else {   // byte row 16 g + k: value k low, k + 16 high
                const uint32_t b = (*reinterpret_cast<const uint32_t*>(
                                        rw + (16 * (c >> 1) + 4 * i + r) * RB + lane * 4) >>
                                    ((c & 1) * 4)) &
                                   0x0F0F0F0Fu;
                r4[r] = off ? swar_sub8(b) : b;
              }
            }
            uint32_t t4[4];
            transpose_bytes(r4[0], r4[1], r4[2], r4[3], t4);
#pragma unroll
            for (int j = 0; j < 4; ++j) col4[j][i] = t4[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint4*>(bd + swizzle_chunk(4 * lane + j, c)) =
              make_uint4(col4[j][0], col4[j][1], col4[j][2], col4[j][3]);
      }
      // the stage's scales as float32: sw [g][n], sx [g][m], 4 each a thread
      const uint8_t* rs = raw_s + slot * kScBytes;
      const float* rx = raw_x + slot * 4 * kWgBM;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = u * 128 + t;
        sws[s * 4 * kWgBN + e] = s_f16 ? __half2float(reinterpret_cast<const __half*>(rs)[e])
                                       : reinterpret_cast<const float*>(rs)[e];
        sxs[s * 4 * kWgBM + e] = rx[e];
      }
      fence_async_shared();
      mbar_arrive(&full_b[s]);
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<216>();
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, wq4 = (threadIdx.x >> 5) & 3;
    const int rl = wg * 64 + wq4 * 16 + (lane >> 2);   // row in the tile; and rl + 8
    float acc[64];
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      d[i] = 0;
    }
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      mbar_wait(&full_x[s], par);
      mbar_wait(&full_b[s], par);
      const uint64_t a = wgmma_desc(xs + s * kXBytes + wg * 64 * kSwizzleRow);
      const uint64_t b = wgmma_desc(bs + s * kBBytes);
      const float* sxg = sxs + s * 4 * kWgBM + rl;
      const float* swg = sws + s * 4 * kWgBN + 2 * (lane & 3);
      switch (min(4, G - 4 * kt)) {   // the groups of this stage
        case 4: consume_stage<4>(acc, d, a, b, sxg, swg); break;
        case 3: consume_stage<3>(acc, d, a, b, sxg, swg); break;
        case 2: consume_stage<2>(acc, d, a, b, sxg, swg); break;
        default: consume_stage<1>(acc, d, a, b, sxg, swg); break;
      }
      mbar_arrive(&empty[s]);
    }
    const int ra = m0 + rl, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < N) {
        if (ra < M) store2(out + (long long)ra * N + col, acc[4 * j], acc[4 * j + 1]);
        if (rb < M) store2(out + (long long)rb * N + col, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <typename XT>
void quantize(const XT* x, int8_t* xq, float* sx, int M, int K, int ldt,
              cudaStream_t st) {
  const long long warps = (long long)M * (K / kGroup);
  quantize_q8_1_kernel<XT><<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(x, xq, sx, M, K,
                                                                         ldt);
}

template <typename XT, int FORM>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out, float* scratch,
                   int8_t* xq, float* sx_t, int M, int K, int N, int s_f16, int off,
                   int ksplit, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  if (M <= 8) {
    const dim3 grid((N + kSmallCols - 1) / kSmallCols, ksplit);
    float* partial = ksplit > 1 ? scratch : nullptr;
#define QMM8_SMALL(MT)                                                           \
  qmm8_small_kernel<XT, FORM, MT><<<grid, kSmallWarps * 32, 0, st>>>(            \
      xp, qp, sc, s_f16, partial, op, M, K, N, off)
    if (M == 1) QMM8_SMALL(1);
    else if (M == 2) QMM8_SMALL(2);
    else if (M <= 4) QMM8_SMALL(4);
    else QMM8_SMALL(8);
#undef QMM8_SMALL
    if (ksplit > 1) {
      const long long mn = (long long)M * N;
      reduce_partials_kernel<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          partial, op, ksplit, mn);
    }
  } else {
    const int ldt = (M + 3) / 4 * 4;   // sx_t's rows 16-byte aligned for TMA
    quantize<XT>(xp, xq, sx_t, M, K, ldt, st);
    // boxes: xq (128, 128) swizzled; the raw weight, one stage's rows of 128
    // columns; sw and sx, 4 groups of 128 columns or rows
    CUtensorMap xmap, wmap, smap, sxmap;
    const int G = K / kGroup;
    const long long rows = FORM == kStrided ? K : FORM == kPacked ? K / 2 : K / 8;
    const int welem = FORM == kWords ? 4 : 1;
    if (!make_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, K, kWgBK, kWgBM, true) ||
        !make_map_2d(&wmap, qp,
                     FORM == kWords ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     welem, rows, N, N, kWgBN, (int)(kWgBK * rows / K), false) ||
        !make_map_2d(&smap, sc,
                     s_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     s_f16 ? 2 : 4, G, N, N, kWgBN, 4, false) ||
        !make_map_2d(&sxmap, sx_t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, M, ldt, kWgBM, 4,
                     false))
      return cudaErrorNotSupported;
    const cudaError_t attr = allow_smem<qmm8_wgmma_kernel<XT, FORM>>(kWgSmem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((M + kWgBM - 1) / kWgBM, (N + kWgBN - 1) / kWgBN);
    qmm8_wgmma_kernel<XT, FORM><<<grid, kWgThreads, kWgSmem, st>>>(xmap, wmap, smap, sxmap, s_f16,
                                                                    op, M, K, N, off);
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_form(int form, const void* x, const void* q, const void* sc, void* out,
                        float* scratch, int8_t* xq, float* sx_t, int M, int K, int N,
                        int s_f16, int off, int ksplit, cudaStream_t st) {
  if (form == kStrided)
    return launch<XT, kStrided>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, 0, ksplit,
                                st);
  if (form == kPacked)
    return launch<XT, kPacked>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit,
                               st);
  return launch<XT, kWords>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit,
                            st);
}

}  // namespace

// x (M, K) float32 or bf16 -> xq (M, K) int8 and sx float32, (M, K / 32) or,
// transposed, (K / 32, M).
extern "C" int qa_quantize_q8_1(const void* x, void* xq, void* sx, int M, int K, int x_bf16,
                                int transposed, void* stream) {
  if (M < 1 || K < kGroup || K % kGroup) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (x_bf16)
    quantize<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), q, s, M, K,
                            transposed ? M : 0, st);
  else
    quantize<float>(static_cast<const float*>(x), q, s, M, K, transposed ? M : 0, st);
  return (int)cudaGetLastError();
}

// x (M, K) float32 or bf16; q the weight of layer li in form 0 (int8 (K, N)),
// 1 (nibble bytes (K / 2, N)) or 2 (int32 words (K / 8, N)); sc (K / 32, N)
// float16 or float32; out (M, N) in x's type. scratch: float32 (ksplit, M,
// N), read only when M <= 8 and ksplit > 1; xq (M, K) int8 and sx_t float32
// (K / 32, M rounded up to a multiple of 4), read only when M > 8. off: 8 (symmetric q4_0) or 0.
extern "C" int qa_quant_matmul_int8(const void* x, const void* q, const void* sc, void* out,
                                    void* scratch, void* xq, void* sx_t, int M, int K, int N,
                                    int x_bf16, int s_f16, int form, int off, int ksplit,
                                    void* stream) {
  if (M < 1 || K < kGroup || K % kGroup || N < 16 || N % 16 || form < kStrided ||
      form > kWords || (off != 0 && off != 8) || (form == kStrided && off != 0) ||
      ksplit < 1 || ksplit > 65535 || (N + kWgBN - 1) / kWgBN > 65535 ||
      (ksplit > 1 && (M > 8 || scratch == nullptr)) ||
      (M > 8 && (xq == nullptr || sx_t == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  int8_t* xqp = static_cast<int8_t*>(xq);
  float* sxp = static_cast<float*>(sx_t);
  const cudaError_t rc =
      x_bf16 ? launch_form<__nv_bfloat16>(form, x, q, sc, out, scr, xqp, sxp, M, K, N, s_f16,
                                          off, ksplit, st)
             : launch_form<float>(form, x, q, sc, out, scr, xqp, sxp, M, K, N, s_f16, off,
                                  ksplit, st);
  return (int)rc;
}
