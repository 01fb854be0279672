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
// - M > 8 (the 752-position prefill, the encoder's 1500 rows): 2 M K N
//   products (gate_up at M = 752: 0.206 ms of f16 tensor work at 989
//   TFLOP/s) and, on the CUDA cores, the rescale of every group's dot: M N K
//   / 32 (output, group) pairs (gate_up: 3.19 G), c = fmaf(p, sx * sw, c),
//   which ggml's numerics (the float32 sum in group order) do not let us
//   skip. quantize_q8_1_kernel first writes xq (M, K) int8 and sx
//   transposed (K / 32, M rounded up to 4, so that its rows are 16-byte
//   aligned); then qmm8_wgmma_kernel, one persistent CTA an SM (the launch
//   plan's grid), walks 128 x BN output tiles (BN 128, or 64 where that
//   shortens the waves by a fifth) in the order tile = CTA + k * CTAs, m
//   fastest, so the CTAs at work at once share few weight columns.
//   * The products are exact on f16 tensor cores: xq in [-127, 127], int8
//     weights in [-128, 127] and nibbles - off in [-8, 15] are exact in f16,
//     a product is below 2^14 and a group's 32 below 2^19, so every float32
//     partial sum of a wgmma m64nBNk16 pair (zeroed, then added to) is an
//     exact integer: p is the integer dot, already a float (the old s32
//     product cost an integer add and a float subtract an output and group
//     more). f16 rather than bf16 because its 10-bit mantissa lets a byte
//     become a value by one byte permute under the exponent of 1024 (0x6400
//     | u is 1024 + u) and one f16x2 add or fma. The premise is tested on the
//     CPU (tests/test_torch_int8_f16_premise.py) and on the card (qmm_ab.py's
//     digests equal the s32 kernel's).
//   * A (x) from registers: each consumer thread loads its 8 bytes of a
//     row a group (one 8-byte load; K is ordered inside a group by k_slot so
//     that they are neighbours) and converts them in registers; int8 x from
//     device memory, not f16, halves x's L2 and shared-memory bytes.
//   * B (the weight) MN-major in shared memory: 3 pairs of transform warps
//     (a pair converts every third stage, a batch of raw words loaded before
//     any of it is stored) turn each raw stage of any form into f16 without
//     a byte transpose, rows in k_slot order, and the scales into float32 in
//     the order the consumers read them (sw_slot).
//   * Two consumer warpgroups (rows 64 w .. 64 w + 63), per group: the two
//     products, a wait, then the rescale; one warpgroup's rescale runs under
//     the other's products. A consumer never spins on an mbarrier: ptxas
//     serializes every wgmma of a function where one is in flight across a
//     divergent spin (C7518), so the transform, which waits for x to land,
//     releases each warpgroup through a named barrier a B slot.
//   * Loads: one producer warp issues x (and sx) as soon as a slot is free,
//     another the raw weight (and sw) as far ahead as the raw ring goes.
//   Shared memory (BN = 128): 6 x stages of 9 KB, 4 B stages of 17 KB (f16
//   tile and float32 sw) and 8 raw stages of 9 KB, 200 KB. A stage (64 of
//   K) moves about 100 KB through it: 32 KB of B read by the products, 16 KB
//   of B written and 8 KB of raw read by the transform, 8 + 8 KB of raw and
//   x written by TMA, 8 KB of x read by the consumers, about 20 KB of scale
//   reads (64 of each 128-byte wavefront used), against 512 clocks of
//   tensor work and about 600 issue slots of rescale a sub-partition: at 128
//   bytes a clock the pipe is the busiest single resource (about 800
//   clocks). Measured on the H100 (PERF.md) the transform bounds the tile:
//   its loads and stores wait behind that traffic, and a pair takes about
//   5000 clocks a stage.
//   The integer dots are exact and each output's float32 arithmetic (one
//   FMA per group, in group order) does not depend on the tiling, so any
//   tiling gives the same bits (qmm_ab.py's digests hold two builds to it).
//
// One layout fact carries the three nibble forms of the M <= 8 kernel: the
// low nibbles of word 4g + r of the words form are k = 32 g + 4 r + 0..3 of
// its column, its high nibbles the same + 16. The packed form gathers the
// same 4 values from 4 byte rows with __byte_perm, and the strided form
// gathers k .. k + 3 of a column from 4 rows the same way, so the three forms
// feed the same integer products: the packed and the words forms of the same
// bytes give the same bits, at every M.
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
// M > 8: persistent TMA-fed tiles, each 32-group's integer dot on f16 wgmma,
// 512 threads in roles that never reconverge:
//   warpgroups 0, 1   consumers: rows 64 w .. 64 w + 63 of the 128 x BN tile
//   warp 8            x producer: the x and sx boxes of each stage
//   warps 9 .. 14     transform: 3 pairs, pair w converting stages w, w + 3, ..
//   warp 15           raw producer: the raw weight and sw boxes of each stage
// A stage is 64 values of K (two groups); a ragged last stage runs only its
// group. Rings: x (full_x: TMA bytes; empty_x: 256 consumer arrivals), B
// (empty_b: 256 consumer arrivals; ready: a named barrier a slot and
// warpgroup) and raw (raw_full: TMA bytes; raw_empty: 64 transform
// arrivals), each walked in one flat order of stages over the CTA's tiles.
constexpr int kWgBM = 128, kWgBK = 64, kWgThreads = 512, kGS = kWgBK / kGroup;
constexpr int kXStages = 6, kBStages = 4, kRawStages = 8;
// named barriers kStageBar + 2 s + w: B slot s ready for consumer warpgroup w;
// pair w of the kPairs transform pairs converts stages w, w + kPairs, ...
constexpr int kTransformThreads = 64, kPairs = 3, kStageBar = 2;
static_assert(kPairs * kTransformThreads + 64 <= kWgThreads - 256, "transform and producers");
static_assert(kStageBar + 2 * kBStages <= 16, "named barriers");
// setmaxnreg moves registers within the CTA's own 512 x 128 = 65536
constexpr int kConsumerRegs = 184, kWg2Regs = 72;      // 256 x 184 + 256 x 72 = 65536
constexpr int kXBytes = kWgBM * kWgBK;            // (128 m, 64 k) int8, 64-byte swizzle
constexpr int kSxBytes = kGS * kWgBM * 4;         // sx of the stage's groups, [g][m]
constexpr int kHalfB = kWgBK * kSwizzleRow;       // (64 k, 64 n) f16: one MN-major block

// shared memory of a BN-wide tile: x, B, sx, sw rings, the raw ring (the
// widest form's bytes, float32 scales) and the barriers, aligned to 1024
__host__ __device__ constexpr int wg_smem(int BN) {
  return kXStages * (kXBytes + kSxBytes) + kBStages * (BN / 64 * kHalfB + kGS * BN * 4) +
         kRawStages * (kWgBK * BN + kGS * BN * 4) + (2 * kXStages + kBStages + 2 * kRawStages) * 8 +
         1024;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds_f32x4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ __half lds_f16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return __ushort_as_half(v);
}
__device__ __forceinline__ void sts_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t a, uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x), "r"(y), "r"(z),
               "r"(w)
               : "memory");
}

// two f16 lanes: h + b, and h * m + b (one rounding each, exact here)
__device__ __forceinline__ uint32_t hadd2(uint32_t h, uint32_t b) {
  uint32_t r;
  asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t hfma2(uint32_t h, uint32_t m, uint32_t b) {
  uint32_t r;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(h), "r"(m), "r"(b));
  return r;
}

// The magic exponent: 0x6400 | u is the f16 1024 + u for a byte u < 1024,
// so one byte permute makes two values and one f16x2 add removes the bias.
constexpr uint32_t kMagic = 0x64646464u;
constexpr uint32_t kBias8 = 0xE480E480u;      // -1152: int8 v ^ 0x80 = v + 128
constexpr uint32_t kSixteenth = 0x2C002C00u;  // 1 / 16: a high nibble in place is 16 n

// bytes 0, 1 (sel 0x4140) or 2, 3 (0x4342) of w as two f16 1024 + byte
__device__ __forceinline__ uint32_t magic2(uint32_t w, uint32_t sel) {
  return __byte_perm(w, kMagic, sel);
}

// The order of K within a 32-group that the products use (any order gives
// the same exact dot): B row k_slot(k) holds value k, so that the 8 values
// of x a thread's A fragment needs for the group's two k16 steps are 8
// neighbouring bytes of its row (k = 8 t4 + 4 s + 2 h + e sits in slot
// 16 s + 8 h + 2 t4 + e of step s's fragment, registers a0 / a1 for h 0,
// a2 / a3 for h 1); k is the value's index in the stage, two groups
__device__ __forceinline__ int k_slot(int k) {
  return (k & 32) + ((k >> 2) & 1) * 16 + ((k >> 1) & 1) * 8 + ((k >> 3) & 3) * 2 + (k & 1);
}

// The B tile: row k of an MN-major block holds 64 f16 values of N (128
// bytes, chunk c of 8 values at (c ^ (k % 8)) * 16); block n / 64 lies
// kHalfB bytes after the last.
__device__ __forceinline__ uint32_t b_chunk(uint32_t bd, int k, int c8) {
  return bd + (c8 >> 3) * kHalfB + k * kSwizzleRow + (((c8 & 7) ^ (k & 7)) << 4);
}

// sw of column n of a group as the consumers read it: within each 16
// columns, the 4 values a lane needs (8 i + 2 (lane % 4) + 0, 1 for i = 2 j,
// 2 j + 1) side by side, one 16-byte load
__host__ __device__ __forceinline__ int sw_slot(int n) {
  return (n & ~15) + 4 * ((n & 7) >> 1) + 2 * ((n >> 3) & 1) + (n & 1);
}

// 4 words of 4 int8 values (16 neighbouring columns) as 8 f16x2 values
__device__ __forceinline__ void int8_to_f16(const uint4& v, uint32_t (&h)[8]) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = hadd2(magic2(w[i], 0x4140), kBias8);
    h[2 * i + 1] = hadd2(magic2(w[i], 0x4342), kBias8);
  }
}

// The 8 lanes of a store phase take one row and c16 0 .. 7 (16 columns
// each, B chunks 2 c16 and 2 c16 + 1); lanes with c16 % 8 >= 4 store their
// second chunk first, so that each store instruction's 8 chunks lie in 8
// different bank groups. flip16 swaps a lane's two halves (raw words) before
// conversion, without a branch; store16 then writes h[0..3] to chunk 2 c16 +
// flip and h[4..7] to the other.
__device__ __forceinline__ int flip16(int c16) { return (c16 >> 2) & 1; }
__device__ __forceinline__ uint4 flip_halves(const uint4& v, int flip) {
  return flip ? make_uint4(v.z, v.w, v.x, v.y) : v;
}
__device__ __forceinline__ void store16(uint32_t bd, int k, int c16, const uint32_t (&h)[8]) {
  const int flip = flip16(c16);
  sts128(b_chunk(bd, k, 2 * c16 + flip), h[0], h[1], h[2], h[3]);
  sts128(b_chunk(bd, k, 2 * c16 + 1 - flip), h[4], h[5], h[6], h[7]);
}

// The transform's work on one stage, shared by a pair's 64 threads (t): the
// raw weight rows at rw (TMA box, BN columns a row) into the f16 B tile at
// bd, and the stage's raw scales at rs (float16 or float32) into float32 at
// sw in the consumers' order; lo, hi the f16x2 biases of a low and a high
// nibble (-(1024 + off), -(64 + off)). A thread takes NU units (16 columns at
// an int8 or nibble-byte row, or 8 columns at a word row), NB at a time,
// each batch's raw words loaded before any is converted and stored: a shared
// load placed after a shared store waits for it (the compiler cannot tell
// that they do not alias), and under the products' operand reads that wait
// is long (2.3 us a stage, measured, when each unit's load followed the last
// unit's stores). Batches of at most 4 keep the pair within its registers.
template <int FORM, int BN>
__device__ __forceinline__ void transform_stage(uint32_t rw, uint32_t bd, uint32_t rs,
                                                int s_f16, uint32_t sw, int t, uint32_t lo,
                                                uint32_t hi) {
  constexpr int T = kTransformThreads, C16 = BN / 16, C8 = BN / 8;
  constexpr int U = FORM == kStrided ? kWgBK * C16 : FORM == kPacked ? kWgBK / 2 * C16
                                                                      : kWgBK / 8 * C8;
  // every thread takes the same number of units and scales: no predicate,
  // so the arrays stay in registers
  static_assert(U % T == 0 && kGS * BN % T == 0, "whole units a thread");
  constexpr int NU = U / T, NB = NU > 4 ? 4 : NU, NV = FORM == kWords ? 2 : 1;
  constexpr int NS = kGS * BN / T;
  float sv[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = t + T * i;
    sv[i] = s_f16 ? __half2float(lds_f16(rs + e * 2)) : lds_f32(rs + e * 4);
  }
#pragma unroll
  for (int i0 = 0; i0 < NU; i0 += NB) {
    uint4 v[NB][NV];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = t + T * (i0 + i);
      if constexpr (FORM == kWords) {
        const uint32_t a = rw + ((q / C8) * BN + (q % C8) * 8) * 4;
        v[i][0] = lds128(a);
        v[i][NV - 1] = lds128(a + 16);
      } else {
        v[i][0] = lds128(rw + (q / C16) * BN + (q % C16) * 16);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = t + T * (i0 + i);
      if constexpr (FORM == kStrided) {   // 64 int8 rows: value k at row k
        uint32_t h[8];
        int8_to_f16(flip_halves(v[i][0], flip16(q % C16)), h);
        store16(bd, k_slot(q / C16), q % C16, h);
      } else if constexpr (FORM == kPacked) {   // byte row 16 g + j: k = 32 g + j low, + 16 high
        const int jr = q / C16, c16 = q % C16, k = (jr >> 4) * 32 + (jr & 15);
        const uint4 vf = flip_halves(v[i][0], flip16(c16));
        const uint32_t w[4] = {vf.x, vf.y, vf.z, vf.w};
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t l = w[e] & 0x0F0F0F0Fu;
          h[2 * e] = hadd2(magic2(l, 0x4140), lo);
          h[2 * e + 1] = hadd2(magic2(l, 0x4342), lo);
        }
        store16(bd, k_slot(k), c16, h);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t u = w[e] & 0xF0F0F0F0u;
          h[2 * e] = hfma2(magic2(u, 0x4140), kSixteenth, hi);
          h[2 * e + 1] = hfma2(magic2(u, 0x4342), kSixteenth, hi);
        }
        store16(bd, k_slot(k + 16), c16, h);
      } else {   // word row 4 g + r of a column: byte e holds k = 32 g + 4 r + e low, + 16 high
        const int wr = q / C8, c8 = q % C8, k0 = (wr >> 2) * 32 + (wr & 3) * 4;
        const uint32_t w[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                               v[i][NV - 1].x, v[i][NV - 1].y, v[i][NV - 1].z, v[i][NV - 1].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // byte e of columns 2 p and 2 p + 1 in the two f16 lanes
          const uint32_t sel = e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12);
          uint32_t l[4], h[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t b = __byte_perm(w[2 * p], w[2 * p + 1], sel);
            l[p] = hadd2((b & 0x000F000Fu) | 0x64006400u, lo);
            h[p] = hfma2((b & 0x00F000F0u) | 0x64006400u, kSixteenth, hi);
          }
          sts128(b_chunk(bd, k_slot(k0 + e), c8), l[0], l[1], l[2], l[3]);
          sts128(b_chunk(bd, k_slot(k0 + e + 16), c8), h[0], h[1], h[2], h[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = t + T * i;
    sts_f32(sw + (e / BN * BN + sw_slot(e % BN)) * 4, sv[i]);
  }
}

// One consumer warpgroup's share of a tile: per 32-group, the products of
// its 64 rows and BN columns (two wgmma m64nBNk16 into p, the group's float32
// dots, zeroed), then acc = fmaf(p, sx * sw, acc). A warpgroup waits for its
// own products; the other warpgroup's rescale runs under them.
template <int BN>
struct Consumer {
  float acc[BN / 2];
  float p[BN / 2];
  uint32_t xs, bs, sxs, sws;   // the current stage's x, B, sx, sw slots (shared addresses)
  int wg, rl, t4;

  // group j of the current stage: outputs at rows rl (e < 2) and rl + 8,
  // columns 8 i + 2 t4 + e % 2
  __device__ __forceinline__ void group(int j) {
    // A from registers: bytes 32 j + 8 t4 .. + 7 of x's rows rl and rl + 8
    // (64-byte swizzle: 16-byte chunk c of row r at c ^ (r / 2 % 4)), the
    // group's values 8 t4 .. 8 t4 + 7 in k_slot's order, as f16 (v ^ 0x80
    // under the magic exponent is 1152 + v)
    const uint32_t xa = xs + rl * kWgBK + ((32 * j + 8 * t4) ^ (((rl >> 1) & 3) << 4));
    const uint2 r0 = lds64(xa), r1 = lds64(xa + 8 * kWgBK);
    const uint32_t u[4] = {r0.x ^ 0x80808080u, r1.x ^ 0x80808080u, r0.y ^ 0x80808080u,
                           r1.y ^ 0x80808080u};
    uint32_t a0[4], a1[4];   // the fragments of k16 steps 0 and 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a0[e] = hadd2(magic2(u[e], 0x4140), kBias8);
      a0[2 + e] = hadd2(magic2(u[e], 0x4342), kBias8);
      a1[e] = hadd2(magic2(u[2 + e], 0x4140), kBias8);
      a1[2 + e] = hadd2(magic2(u[2 + e], 0x4342), kBias8);
    }
    // B: MN-major, 2048 bytes a k16 step
    const uint64_t b = wgmma_desc_mn_at(bs, kHalfB) + (2 * j) * (2048 >> 4);
    wgmma_fence();
    wgmma_f16_rs_mn<BN>(p, a0, b, 0);
    wgmma_f16_rs_mn<BN>(p, a1, b + (2048 >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) pin(p[i]);
    const uint32_t sxa = sxs + (j * kWgBM + rl) * 4, swa = sws + (j * BN + 4 * t4) * 4;
    const float sx0 = lds_f32(sxa), sx1 = lds_f32(sxa + 32);
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      const float4 w = lds_f32x4(swa + 64 * jj);
      const int i = 8 * jj;
      acc[i + 0] = fmaf(p[i + 0], __fmul_rn(sx0, w.x), acc[i + 0]);
      acc[i + 1] = fmaf(p[i + 1], __fmul_rn(sx0, w.y), acc[i + 1]);
      acc[i + 2] = fmaf(p[i + 2], __fmul_rn(sx1, w.x), acc[i + 2]);
      acc[i + 3] = fmaf(p[i + 3], __fmul_rn(sx1, w.y), acc[i + 3]);
      acc[i + 4] = fmaf(p[i + 4], __fmul_rn(sx0, w.z), acc[i + 4]);
      acc[i + 5] = fmaf(p[i + 5], __fmul_rn(sx0, w.w), acc[i + 5]);
      acc[i + 6] = fmaf(p[i + 6], __fmul_rn(sx1, w.z), acc[i + 6]);
      acc[i + 7] = fmaf(p[i + 7], __fmul_rn(sx1, w.w), acc[i + 7]);
    }
  }

  // a tile of G groups from stage it0 of the CTA's flat order: per stage,
  // wait for the transform's named barrier, its groups, then free its slots
  __device__ __forceinline__ void tile(int G, int it0, uint32_t xs0, uint32_t bs0, uint32_t sxs0,
                                       uint32_t sws0, uint64_t* empty_x, uint64_t* empty_b) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int fx = it0 % kXStages, fb = it0 % kBStages;
    for (int g = 0; g < G; g += kGS) {
      xs = xs0 + fx * kXBytes;
      bs = bs0 + fb * (BN / 64 * kHalfB);
      sxs = sxs0 + fx * kSxBytes;
      sws = sws0 + fb * (kGS * BN * 4);
      named_sync(kStageBar + 2 * fb + wg, kTransformThreads + 128);
      group(0);
      if (g + 1 < G) group(1);
      mbar_arrive(&empty_x[fx]);
      mbar_arrive(&empty_b[fb]);
      fx = fx + 1 == kXStages ? 0 : fx + 1;
      fb = fb + 1 == kBStages ? 0 : fb + 1;
    }
  }
};

template <typename XT, int FORM, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __grid_constant__ CUtensorMap sxmap, int s_f16, XT* __restrict__ out,
                  int M, int K, int N, int off) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  constexpr int kBBytes = BN / 64 * kHalfB, kSwBytes = kGS * BN * 4;
  constexpr int kRawW = kWgBK * BN, kRawS = kGS * BN * 4;
  uint8_t* xs = smem;
  uint8_t* bs = xs + kXStages * kXBytes;
  uint8_t* sxs = bs + kBStages * kBBytes;
  uint8_t* sws = sxs + kXStages * kSxBytes;
  uint8_t* raw_w = sws + kBStages * kSwBytes;
  uint8_t* raw_s = raw_w + kRawStages * kRawW;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(raw_s + kRawStages * kRawS);
  uint64_t* empty_x = full_x + kXStages;
  uint64_t* empty_b = empty_x + kXStages;
  uint64_t* raw_full = empty_b + kBStages;
  uint64_t* raw_empty = raw_full + kRawStages;

  const int G = K / kGroup, S = (G + kGS - 1) / kGS;   // groups, stages a tile
  const int MT = (M + kWgBM - 1) / kWgBM, tiles = MT * ((N + BN - 1) / BN);
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&full_x[s], 1);
      mbar_init(&empty_x[s], 256);
    }
    for (int s = 0; s < kBStages; ++s) mbar_init(&empty_b[s], 256);
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kTransformThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<kWg2Regs>();
    // raw weight rows a stage: 64 int8 rows, 32 nibble-byte rows or 8 word rows
    constexpr int RROWS = FORM == kStrided ? kWgBK : FORM == kPacked ? kWgBK / 2 : kWgBK / 8;
    const int F = mine * S;   // the CTA's stages, flat over its tiles
    if (threadIdx.x < 256 + 32) {
      // ---- x producer: lane 0 issues stage f's x as soon as its slot is free ----
      if (threadIdx.x == 256) {
        int xt = blockIdx.x, xst = 0, m0 = xt % MT * kWgBM;   // tile, stage, first row
        for (int f = 0; f < F; ++f) {
          const int s = f % kXStages;
          mbar_wait(&empty_x[s], ((f / kXStages) & 1) ^ 1);
          mbar_expect_tx(&full_x[s], kXBytes + kSxBytes);
          tma_load_2d(xs + s * kXBytes, &xmap, &full_x[s], xst * kWgBK, m0);
          tma_load_2d(sxs + s * kSxBytes, &sxmap, &full_x[s], m0, xst * kGS);
          if (++xst == S) xst = 0, xt += gridDim.x, m0 = xt % MT * kWgBM;
        }
      }
    } else {
      // ---- transform: pair w of warps converts stages w, w + kPairs, ... ----
      const int w = (threadIdx.x - 256 - 32) / kTransformThreads;
      const int t = (threadIdx.x - 256 - 32) % kTransformThreads;
      if (threadIdx.x == kWgThreads - 32) {
        // ---- raw producer (the last warp, lane 0): the raw ring as far ahead as it goes ----
        const uint32_t raw_bytes =
            RROWS * BN * (FORM == kWords ? 4 : 1) + kGS * BN * (s_f16 ? 2 : 4);
        int rt = blockIdx.x, rst = 0, n0 = rt / MT * BN;   // tile, stage, first column
        for (int f = 0; f < F; ++f) {
          const int r = f % kRawStages;
          mbar_wait(&raw_empty[r], ((f / kRawStages) & 1) ^ 1);
          mbar_expect_tx(&raw_full[r], raw_bytes);
          tma_load_2d(raw_w + r * kRawW, &wmap, &raw_full[r], n0, rst * RROWS);
          tma_load_2d(raw_s + r * kRawS, &smap, &raw_full[r], n0, rst * kGS);
          if (++rst == S) rst = 0, rt += gridDim.x, n0 = rt / MT * BN;
        }
      }
      if (w < kPairs) {
        const uint32_t lo = off ? 0xE408E408u : 0xE400E400u;   // -(1024 + off)
        const uint32_t hi = off ? 0xD480D480u : 0xD400D400u;   // -(64 + off)
        for (int f = w; f < F; f += kPairs) {
          const int r = f % kRawStages, s = f % kBStages;
          mbar_wait(&raw_full[r], (f / kRawStages) & 1);
          mbar_wait(&empty_b[s], ((f / kBStages) & 1) ^ 1);
          transform_stage<FORM, BN>(smem_u32(raw_w + r * kRawW), smem_u32(bs + s * kBBytes),
                                    smem_u32(raw_s + r * kRawS), s_f16,
                                    smem_u32(sws + s * kSwBytes), t, lo, hi);
          mbar_arrive(&raw_empty[r]);
          // the consumers start on the named barrier of the slot once x has
          // landed too: they wait on no mbarrier, whose spin ptxas would
          // treat as a divergent path and serialize their wgmma around
          mbar_wait(&full_x[f % kXStages], (f / kXStages) & 1);
          fence_async_shared();
          named_arrive(kStageBar + 2 * s, kTransformThreads + 128);
          named_arrive(kStageBar + 2 * s + 1, kTransformThreads + 128);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<kConsumerRegs>();
    Consumer<BN> c;
    const int lane = threadIdx.x & 31;
    c.wg = threadIdx.x >> 7;
    c.rl = c.wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);   // row in the tile; and + 8
    c.t4 = lane & 3;
    for (int k = 0; k < mine; ++k) {
      const int tile = (int)blockIdx.x + k * (int)gridDim.x;
      c.tile(G, k * S, smem_u32(xs), smem_u32(bs), smem_u32(sxs), smem_u32(sws), empty_x, empty_b);
      const int ra = tile % MT * kWgBM + c.rl, rb = ra + 8;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = tile / MT * BN + 8 * i + 2 * c.t4;
        if (col < N) {
          if (ra < M) store2(out + (long long)ra * N + col, c.acc[4 * i], c.acc[4 * i + 1]);
          if (rb < M) store2(out + (long long)rb * N + col, c.acc[4 * i + 2], c.acc[4 * i + 3]);
        }
      }
    }
  }
}

template <typename XT>
void quantize(const XT* x, int8_t* xq, float* sx, int M, int K, int ldt, cudaStream_t st) {
  const long long warps = (long long)M * (K / kGroup);
  quantize_q8_1_kernel<XT><<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(x, xq, sx, M, K, ldt);
}

template <typename XT, int FORM, int BN>
cudaError_t launch_tiles(const XT* xp, const uint8_t* qp, const void* sc, XT* op, int8_t* xq,
                         float* sx_t, int M, int K, int N, int s_f16, int off, int ctas,
                         cudaStream_t st) {
  const int ldt = (M + 3) / 4 * 4;   // sx_t's rows 16-byte aligned for TMA
  quantize<XT>(xp, xq, sx_t, M, K, ldt, st);
  // boxes: xq (64 k, 128 rows) swizzled; the raw weight, one stage's rows of
  // BN columns; sw and sx, 2 groups of BN columns or 128 rows
  CUtensorMap xmap, wmap, smap, sxmap;
  const int G = K / kGroup;
  const long long rows = FORM == kStrided ? K : FORM == kPacked ? K / 2 : K / 8;
  if (!make_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, K, kWgBK, kWgBM,
                   CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_2d(&wmap, qp,
                   FORM == kWords ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   FORM == kWords ? 4 : 1, rows, N, N, BN, (int)(kWgBK * rows / K), false) ||
      !make_map_2d(&smap, sc,
                   s_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   s_f16 ? 2 : 4, G, N, N, BN, kGS, false) ||
      !make_map_2d(&sxmap, sx_t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, M, ldt, kWgBM, kGS,
                   false))
    return cudaErrorNotSupported;
  const cudaError_t attr = allow_smem<qmm8_wgmma_kernel<XT, FORM, BN>>(wg_smem(BN));
  if (attr != cudaSuccess) return attr;
  qmm8_wgmma_kernel<XT, FORM, BN><<<ctas, kWgThreads, wg_smem(BN), st>>>(
      xmap, wmap, smap, sxmap, s_f16, op, M, K, N, off);
  return cudaGetLastError();
}

template <typename XT, int FORM>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out, float* scratch,
                   void* xq, float* sx_t, int M, int K, int N, int s_f16, int off, int ksplit,
                   int bn, int ctas, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  if (M > 8) {
    int8_t* xh = static_cast<int8_t*>(xq);
    return bn == 64 ? launch_tiles<XT, FORM, 64>(xp, qp, sc, op, xh, sx_t, M, K, N, s_f16, off,
                                                 ctas, st)
                    : launch_tiles<XT, FORM, 128>(xp, qp, sc, op, xh, sx_t, M, K, N, s_f16, off,
                                                  ctas, st);
  }
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
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_form(int form, const void* x, const void* q, const void* sc, void* out,
                        float* scratch, void* xq, float* sx_t, int M, int K, int N, int s_f16,
                        int off, int ksplit, int bn, int ctas, cudaStream_t st) {
  if (form == kStrided)
    return launch<XT, kStrided>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, 0, ksplit, bn,
                                ctas, st);
  if (form == kPacked)
    return launch<XT, kPacked>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit,
                               bn, ctas, st);
  return launch<XT, kWords>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit, bn,
                            ctas, st);
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
// N), read only when M <= 8 and ksplit > 1; xq (M, K) float16 and sx_t
// float32 (K / 32, M rounded up to a multiple of 4), read only when M > 8,
// with the tile width bn (64 or 128) and ctas persistent CTAs. off: 8
// (symmetric q4_0) or 0.
extern "C" int qa_quant_matmul_int8(const void* x, const void* q, const void* sc, void* out,
                                    void* scratch, void* xq, void* sx_t, int M, int K, int N,
                                    int x_bf16, int s_f16, int form, int off, int ksplit, int bn,
                                    int ctas, void* stream) {
  if (M < 1 || K < kGroup || K % kGroup || N < 16 || N % 16 || form < kStrided ||
      form > kWords || (off != 0 && off != 8) || (form == kStrided && off != 0) ||
      ksplit < 1 || ksplit > 65535 || (N + kSmallCols - 1) / kSmallCols > 65535 ||
      (ksplit > 1 && (M > 8 || scratch == nullptr)) ||
      (M > 8 && (xq == nullptr || sx_t == nullptr || (bn != 64 && bn != 128) || ctas < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  float* sxp = static_cast<float*>(sx_t);
  const cudaError_t rc =
      x_bf16 ? launch_form<__nv_bfloat16>(form, x, q, sc, out, scr, xq, sxp, M, K, N, s_f16,
                                          off, ksplit, bn, ctas, st)
             : launch_form<float>(form, x, q, sc, out, scr, xq, sxp, M, K, N, s_f16, off,
                                  ksplit, bn, ctas, st);
  return (int)rc;
}
