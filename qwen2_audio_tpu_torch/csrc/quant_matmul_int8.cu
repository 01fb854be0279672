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
//   a multiply and an fma each (0.19 ms at 128 lanes a clock an SM and
//   1.98 GHz), which ggml's numerics (the float32 sum in group order) do
//   not let us skip. quantize_q8_1_kernel first writes xq (M, K) as f16
//   values and sx transposed (K / 32, M rounded up to 16, each 16 rows in
//   sx_slot's order); then qmm8_tile_kernel, one persistent CTA an SM (the
//   launch plan's grid), computes the output's transpose, out^T = v^T xq^T,
//   over units of BM rows x 128 columns, M fastest.
//   * The products are exact on f16 tensor cores: xq in [-127, 127], int8
//     weights in [-128, 127] and nibbles - off in [-8, 15] are exact in f16,
//     a product is below 2^14 and a group's 32 below 2^19, so every float32
//     partial sum of a group's two wgmma k16 steps (zeroed, then added to)
//     is an exact integer: p is the integer dot, already a float. f16 rather
//     than bf16 because its 10-bit mantissa lets a byte become a value by one
//     byte permute under the exponent of 1024 (0x6400 | u is 1024 + u) and
//     one f16x2 add or fma. The premise is tested on the CPU
//     (tests/test_torch_int8_f16_premise.py) and on the card (qmm_ab.py's
//     digests equal the s32 kernel's).
//   * A (the weight) from registers, with no transform and no f16 weight
//     tile: the consumers read each stage's raw bytes (TMA-swizzled) with
//     ldmatrix.trans, as quant_matmul.cu's qmm_tile_kernel does, or a
//     column's int32 word with one 8-byte load of two columns, and convert
//     them in registers (a_frag). Inside a group the products take K in the
//     words form's own order (words_k), in which the quantizer writes xq.
//   * B (xq) K-major by TMA, BM rows a unit (16, 32, 64 or 128), so that a
//     converted weight stage serves up to 128 rows.
//   * Each group's products in two halves of the unit's rows, the rescale
//     of one under the products of the other; two consumer warpgroups that
//     drift apart; sx for a thread's four rows a float4 (sx_slot).
//   Measured on the H100 (PERF.md, qmm_ab.py --tile-variants int8): the
//   loads are hidden (the tile without its TMA loads takes as long as with
//   them), but the products and the rescale do not overlap: gate_up takes
//   about as long as the products alone plus the rescale alone.
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

#include <type_traits>




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

// The order of K inside a group in which the words form's products take it
// (any order gives the same exact dot; xq is written in it): k16 step s of
// a group takes, at slot 8 h + 2 t4 + b, value 16 s + 4 t4 + 2 h + b, so
// that thread t4 of a fragment needs nibbles of its column's word row t4
// only (the byte holding 4 t4 + e, e = 2 h + b, low for s 0, high for s 1)
__host__ __device__ __forceinline__ int words_k(int k) {
  return (k & ~15) | ((k & 2) << 2) | ((k >> 1) & 6) | (k & 1);
}

// Where sx of row m of a unit lies in its group's row: within each 16 rows,
// the 4 values thread t4 of a fragment needs (rows 8 j + 2 t4 + 0, 1 for j
// = 2 i, 2 i + 1) side by side, one 16-byte load
__host__ __device__ __forceinline__ int sx_slot(int m) {
  return (m & ~15) | (((m >> 1) & 3) << 2) | (((m >> 3) & 1) << 1) | (m & 1);
}

// ------------------------------------------------------------------------- //
// q8_1 of x: one warp per row and group
// ------------------------------------------------------------------------- //

template <typename T> __device__ __forceinline__ T from_int(int v);
template <> __device__ __forceinline__ int8_t from_int<int8_t>(int v) {
  return static_cast<int8_t>(v);
}
template <> __device__ __forceinline__ __half from_int<__half>(int v) { return __int2half_rn(v); }

// xq of type QT (int8, or f16 values for the M > 8 tile) at (m, k), or with
// WORDS at (m, words_k(k)); sx at (m, g) where ldt is 0, else at (g,
// sx_slot(m)) of rows ldt long
template <typename XT, typename QT, bool WORDS>
__global__ void __launch_bounds__(256)
quantize_q8_1_kernel(const XT* __restrict__ x, QT* __restrict__ xq, float* __restrict__ sx,
                     int M, int K, int ldt) {
  const int G = K / kGroup;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= (long long)M * G) return;   // the whole warp
  const int m = (int)(w / G), g = (int)(w % G), lane = threadIdx.x & 31;
  const long long row = (long long)m * K + g * kGroup;
  float s;
  xq[row + (WORDS ? words_k(lane) : lane)] = from_int<QT>(q8_1_lane(to_float(x[row + lane]), s));
  if (lane == 0) sx[ldt ? (long long)g * ldt + sx_slot(m) : (long long)m * G + g] = s;
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
// M > 8: persistent tiles of the output's transpose on f16 wgmma, 384
// threads in roles that never reconverge:
//   warpgroups 0, 1  consumers: weight columns 64 w .. 64 w + 63 of a unit
//                    as wgmma's A, read raw and converted exactly into f16
//                    registers by the consumers themselves, times the unit's
//                    BM rows of xq (f16) as B from shared memory: per
//                    32-group p = the group's dots (out^T), then the rescale
//   warp 8           producer: each stage's xq and sx boxes, raw weight rows
//                    and scales by TMA into the ring's next free slot,
//                    across units
//   warp 9           release: waits for each slot's bytes and lets each
//                    consumer warpgroup in through its own named barrier of
//                    the slot (warps 10, 11 only make the third warpgroup
//                    whole, which setmaxnreg asks for)
// A unit is BM rows of x by kTileN = 128 weight columns over all of K in
// stages of kTileK = 64 values (two groups); CTA b walks units b, b +
// gridDim.x, ... (the launch plan: ops/quant_matmul_int8.py tile_plan), M
// fastest. Ring slots: full (TMA bytes), empty (lane 0 of each of the 8
// consumer warps), and the named barriers 1 + 2 slot + w (warpgroup w's 128
// consumers + the release warp), so that the two warpgroups drift apart.
constexpr int kTileN = 128, kTileK = 64, kGS = kTileK / kGroup;
constexpr int kTileThreads = 384, kTileBarThreads = 128 + 32;
// setmaxnreg moves registers within the CTA's pool of 384 x 168: the
// consumers take 232 (c, p's two halves and two groups' A fragments at BM =
// 128), the producer's warpgroup 40: 2 x 128 x 232 + 128 x 40 = 384 x 168
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kTileScaleBytes = kGS * kTileN * 4;   // a stage's sw, float32 at most
constexpr int kSmemMax = 232448;

template <int BM, int FORM>
struct TileShape {
  static constexpr int kX = BM * kSwizzleRow;   // xq: (BM rows, 64 k) f16, swizzled
  // the raw weight rows of a stage: 64 int8 or 32 nibble-byte rows of 128
  // columns (swizzled), or 8 rows of 128 int32 words
  static constexpr int kW = FORM == kStrided ? kTileK * kTileN : kTileK / 2 * kTileN;
  static constexpr int kSx = kGS * BM * 4;      // sx of the stage's groups, [g][sx_slot(m)]
  static constexpr int kStage = kX + kW + kTileScaleBytes + kSx + 16;   // and two barriers
  static constexpr int kFit = (kSmemMax - 1024) / kStage;
  static constexpr int kStages = kFit < 7 ? kFit : 7;   // named barriers 1 .. 14, 2 a slot
  static constexpr int kSmem = kStages * kStage + 1024;
};

__device__ __forceinline__ float2 lds_f32x2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds_f32x4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// scales e and e + 1 of a stage's row-major (groups, columns) scales at
// shared address a, float16 or float32, as float32
__device__ __forceinline__ float2 ld_scales2(uint32_t a, int e, int s_f16) {
  if (!s_f16) return lds_f32x2(a + e * 4);
  const uint32_t h = lds32(a + e * 2);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
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
constexpr uint32_t kLoNibbles = 0x0F0F0F0Fu, kHiNibbles = 0xF0F0F0F0u;

// two bytes of w, chosen by sel (their indices in its nibbles 0 and 2, 4 in
// 1 and 3), as two f16 1024 + byte
__device__ __forceinline__ uint32_t magic2(uint32_t w, uint32_t sel) {
  return __byte_perm(w, kMagic, sel);
}

// k16 step k (0 .. 3) of a stage as the A fragment of a thread's two
// columns cl (rows g of A) and cl + 1 (rows g + 8), from the raw words r:
//   strided: r[2 k], r[2 k + 1] from ldmatrix.trans, each with bytes (row
//            2 t4, cl), (2 t4, cl + 1), (2 t4 + 1, cl), (2 t4 + 1, cl + 1) of
//            rows 16 k .. 16 k + 7 and + 8 .. 15 (an int8 row holds one value)
//   packed:  the low (k even) or high nibbles of r[2 (k / 2)], r[2 (k / 2) +
//            1], byte rows as for strided (a byte row holds values j and j +
//            16 of its group, ggml's pairing)
//   words:   the low (k even) or high nibbles of r[2 (k / 2)] (column cl)
//            and r[2 (k / 2) + 1] (cl + 1), word row t4 of the group: bytes
//            0, 1 hold values 4 t4 + 0, 1 and bytes 2, 3 values 4 t4 + 2, 3
//            of the step (words_k's order)
// lo, hi: the f16x2 biases of a low and a high nibble (-(1024 + off),
// -(64 + off)). Every value is exact: no scale is folded in.
template <int FORM>
__device__ __forceinline__ void a_frag(const uint32_t (&r)[8], int k, uint32_t lo, uint32_t hi,
                                       uint32_t (&a)[4]) {
  if constexpr (FORM == kStrided) {
    const uint32_t w0 = r[2 * k] ^ 0x80808080u, w1 = r[2 * k + 1] ^ 0x80808080u;
    a[0] = hadd2(magic2(w0, 0x4240), kBias8);
    a[1] = hadd2(magic2(w0, 0x4341), kBias8);
    a[2] = hadd2(magic2(w1, 0x4240), kBias8);
    a[3] = hadd2(magic2(w1, 0x4341), kBias8);
  } else {
    // the packed form pairs (row, cl) with (row + 1, cl) in bytes 0, 2; the
    // words form a column's values 2 h, 2 h + 1 in bytes 2 h, 2 h + 1
    constexpr uint32_t s0 = FORM == kPacked ? 0x4240 : 0x4140;   // a[0], a[1]
    constexpr uint32_t s1 = FORM == kPacked ? 0x4341 : 0x4342;   // a[1] packed; a[2] words
    const uint32_t m = (k & 1) ? kHiNibbles : kLoNibbles;
    const uint32_t w0 = r[2 * (k >> 1)] & m, w1 = r[2 * (k >> 1) + 1] & m;
    uint32_t v[4];
    if constexpr (FORM == kPacked) {
      v[0] = magic2(w0, s0);   // cl, rows 2 t4, 2 t4 + 1
      v[1] = magic2(w0, s1);   // cl + 1
      v[2] = magic2(w1, s0);   // cl, rows + 8
      v[3] = magic2(w1, s1);
    } else {
      v[0] = magic2(w0, s0);   // cl, values 4 t4 + 0, 1
      v[1] = magic2(w1, s0);   // cl + 1
      v[2] = magic2(w0, s1);   // cl, values 4 t4 + 2, 3
      v[3] = magic2(w1, s1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = (k & 1) ? hfma2(v[i], kSixteenth, hi) : hadd2(v[i], lo);
  }
}

__device__ __forceinline__ void pin4(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) pin(a[i]);
}

// A group's products are taken in P = 2 pieces of the unit's rows (halves:
// a wgmma m64n(8 J)k16 each, J blocks of 8 rows), so that one piece's
// rescale runs under the other's products; F floats of a thread's fragment
// a piece. (Four pieces of 32 rows at BM = 128 were slower on the H100, the
// products of the narrower wgmma most: PERF.md.)
template <int BM>
struct Pieces {
  static constexpr int P = 2;
  static constexpr int J = BM / 8 / P;
  static constexpr int F = 4 * J;
};

// sx of piece i of a group for one consumer thread, from the group's slotted
// row at sxa: rows 16 m + 2 t4 + 0, 1 and 16 m + 8 + 2 t4 + 0, 1 side by side
// at 16 m + 4 t4, one float4 for each pair of the piece's blocks of 8 rows (a
// float2 where a piece holds one block)
template <int BM>
__device__ __forceinline__ void load_sx(float (&v)[Pieces<BM>::F / 2], uint32_t sxa, int i) {
  constexpr int J = Pieces<BM>::J;
  if constexpr (J == 1) {
    const float2 w = lds_f32x2(sxa + (16 * (i >> 1) + 2 * (i & 1)) * 4);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int jj = 0; jj < J; jj += 2) {
      const float4 w = lds_f32x4(sxa + 64 * ((i * J + jj) >> 1));
      v[2 * jj] = w.x;
      v[2 * jj + 1] = w.y;
      v[2 * jj + 2] = w.z;
      v[2 * jj + 3] = w.w;
    }
  }
}

// One consumer thread's rescale of piece i of a group's products: c =
// fmaf(p, sx * sw, c) for its outputs (fragment of out^T: c[4 j + b] column
// cl, c[4 j + 2 + b] column cl + 1, both of unit row 8 j + 2 t4 + b; piece i
// holds j = i J .. i J + J - 1 as p[4 (j - i J) + ..], its sx from load_sx)
template <int BM>
__device__ __forceinline__ void rescale_piece(float (&c)[BM / 2], const float (&p)[Pieces<BM>::F],
                                              const float (&sx)[Pieces<BM>::F / 2], float2 sw,
                                              int i) {
  constexpr int J = Pieces<BM>::J;
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float x = sx[2 * jj + b];
      const int k = 4 * jj + b, o = 4 * (i * J + jj) + b;
      c[o] = fmaf(p[k], __fmul_rn(x, sw.x), c[o]);
      c[o + 2] = fmaf(p[k + 2], __fmul_rn(x, sw.y), c[o + 2]);
    }
  }
}

// wgmma.wait_group with n (0 or 1) known once the caller's loop is unrolled
__device__ __forceinline__ void wgmma_wait_n(int n) {
  if (n == 0)
    wgmma_wait<0>();
  else
    wgmma_wait<1>();
}

// a thread's two neighbouring outputs of rows ra and ra + 1 (wgmma's
// fragment of out^T: c[4 j] and c[4 j + 2] are columns col, col + 1 of row
// 8 j + 2 t4, c[4 j + 1] and c[4 j + 3] of the next row)
template <int BM, typename T>
__device__ __forceinline__ void tile_store(const float (&c)[BM / 2], T* o, int M, int N, int r0,
                                           int col) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const int ra = r0 + 8 * j;
    if (ra < M) store2(o + (long long)ra * N + col, c[4 * j], c[4 * j + 2]);
    if (ra + 1 < M) store2(o + (long long)(ra + 1) * N + col, c[4 * j + 1], c[4 * j + 3]);
  }
}

// One consumer thread's work on a unit, each group's products in Pieces<BM>
// pieces of the unit's rows, so that a piece's rescale runs under the other
// pieces' products. Per stage: issue group 0's pieces; for each piece, wait
// for it (the oldest of P in flight), rescale it and issue the same piece
// of group 1; then wait for and rescale group 1's pieces. No product is in
// flight across the loop over stages: ptxas serializes every wgmma of a
// function where a consumer reads accumulators with products of a loop's
// next turn in flight (C7514). A stage's two groups take A registers a0 and
// a1, each pinned until the wait that retires its last piece (wgmma reads
// them after issue). Every stage runs both its groups: where K ends a
// stage's first group, the second reads zeros past K (TMA's fill of x, the
// weight and both scales), and fma(0, 0, c) leaves c's bits as they are (c
// is never -0).
template <int BM, int FORM>
struct Consumer {
  using S = TileShape<BM, FORM>;
  static constexpr int P = Pieces<BM>::P, F = Pieces<BM>::F, N = BM / P;
  float c[BM / 2], pc[P][F];
  uint32_t a0[2][4], a1[2][4];   // groups 0 and 1 of a stage: k16 step, registers
  uint32_t r[8];                 // the stage's raw words
  uint32_t ws0, ss0, sx0;
  uint8_t* xs;
  uint32_t lo, hi;
  int s_f16, wg, cl, t4;

  // the stage in slot s: wait for its named barrier, then its raw words
  __device__ __forceinline__ void open(int s) {
    named_sync(1 + 2 * s + wg, kTileBarThreads);
    const uint32_t wa = ws0 + s * S::kW;
    if constexpr (FORM == kWords) {
#pragma unroll
      for (int j = 0; j < kGS; ++j) {   // group j: word row 4 j + t4, columns cl, cl + 1
        const uint2 v = lds64(wa + 4 * j * kTileN * 4);
        r[2 * j] = v.x;
        r[2 * j + 1] = v.y;
      }
    } else {
      ldsm_x4_trans(wa, *reinterpret_cast<uint32_t(*)[4]>(&r[0]));
      if constexpr (FORM == kStrided)
        ldsm_x4_trans(wa + 32 * kSwizzleRow, *reinterpret_cast<uint32_t(*)[4]>(&r[4]));
    }
  }

  // group j of the open stage as A fragments
  __device__ __forceinline__ void convert(int j, uint32_t (&ag)[2][4]) {
    a_frag<FORM>(r, 2 * j, lo, hi, ag[0]);
    a_frag<FORM>(r, 2 * j + 1, lo, hi, ag[1]);
  }

  // group j of slot s's stage, rows i N .. i N + N - 1 of the unit, into p
  // (zeroed): exact integer dots
  __device__ __forceinline__ void issue(float (&p)[F], const uint32_t (&ag)[2][4], int s, int j,
                                        int i) {
    const uint64_t b = wgmma_desc(xs + s * S::kX + i * N * kSwizzleRow);
    wgmma_fence();
    wgmma_f16_rs_k<N>(p, ag[0], b + 2 * (2 * j), 0);
    wgmma_f16_rs_k<N>(p, ag[1], b + 2 * (2 * j + 1), 1);
    wgmma_commit();
  }

  __device__ __forceinline__ float2 scales(int s, int j) {
    return ld_scales2(ss0 + s * kTileScaleBytes, j * kTileN + cl, s_f16);
  }
  __device__ __forceinline__ uint32_t sx_at(int s, int j) {
    return sx0 + s * S::kSx + (j * BM + 4 * t4) * 4;
  }

  __device__ __forceinline__ void pin_p(float (&p)[F]) {
#pragma unroll
    for (int k = 0; k < F; ++k) pin(p[k]);
  }
  __device__ __forceinline__ void pin_a(uint32_t (&ag)[2][4]) {
    pin4(ag[0]);
    pin4(ag[1]);
  }

  // a unit of `stages` stages from slot s on, whose first stage is open (its
  // raw words in r); opens the stage after its last (the release warp lets
  // the consumers through one slot past the CTA's last stage) and returns
  // its slot. c holds the unit's outputs after it.
  __device__ __forceinline__ int unit(int stages, int s, uint64_t* empty, int lane) {
#pragma unroll
    for (int k = 0; k < BM / 2; ++k) c[k] = 0.f;
    for (int kt = 0; kt < stages; ++kt) {
      const int sn = s + 1 == S::kStages ? 0 : s + 1;
      float sx[F / 2];
      convert(0, a0);
#pragma unroll
      for (int i = 0; i < P; ++i) issue(pc[i], a0, s, 0, i);
      convert(1, a1);
      const float2 sw0 = scales(s, 0), sw1 = scales(s, 1);
#pragma unroll
      for (int i = 0; i < P; ++i) {   // group 0's piece i, then group 1's
        load_sx<BM>(sx, sx_at(s, 0), i);
        wgmma_wait_n(P - 1);
        pin_p(pc[i]);
        if (i == P - 1) pin_a(a0);
        rescale_piece<BM>(c, pc[i], sx, sw0, i);
        issue(pc[i], a1, s, 1, i);
      }
      open(sn);   // the next stage's raw words while group 1 runs
#pragma unroll
      for (int i = 0; i < P; ++i) {
        load_sx<BM>(sx, sx_at(s, 1), i);
        wgmma_wait_n(P - 1 - i);
        pin_p(pc[i]);
        if (i == P - 1) {
          pin_a(a1);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);   // the stage is read to its end
        }
        rescale_piece<BM>(c, pc[i], sx, sw1, i);
      }
      s = sn;
    }
    return s;
  }
};

template <int BM, int FORM>
__global__ void __launch_bounds__(kTileThreads, 1)
qmm8_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap smap,
                 const __grid_constant__ CUtensorMap sxmap, int s_f16, void* __restrict__ out,
                 int out_f32, int M, int K, int N, int off) {
  using S = TileShape<BM, FORM>;
  constexpr int ST = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ws = xs + ST * S::kX;
  uint8_t* ss = ws + ST * S::kW;
  uint8_t* sxs = ss + ST * kTileScaleBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sxs + ST * S::kSx);
  uint64_t* empty = full + ST;

  const int G = K / kGroup, stages = (G + kGS - 1) / kGS;
  const int mt = (M + BM - 1) / BM, units = mt * ((N + kTileN - 1) / kTileN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 8) setmaxnreg_dec<kProducerRegs>();   // warps 10 and 11 do nothing else
  if (warp == 8) {
    // ---- producer (lane 0) ----
    if (lane == 0) {
      // raw weight rows a stage: 64 int8 rows, 32 nibble-byte rows or 8 word rows
      constexpr int RROWS = FORM == kStrided ? kTileK : FORM == kPacked ? kTileK / 2 : kTileK / 8;
      const uint32_t bytes = S::kX + S::kSx + S::kW + kGS * kTileN * (s_f16 ? 2 : 4);
      int f = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = u % mt * BM, n0 = u / mt * kTileN;
        for (int kt = 0; kt < stages; ++kt, ++f) {
          const int s = f % ST;
          mbar_wait(&empty[s], ((f / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(xs + s * S::kX, &xmap, &full[s], kt * kTileK, m0);
          tma_load_2d(sxs + s * S::kSx, &sxmap, &full[s], m0, kt * kGS);
          tma_load_2d(ws + s * S::kW, &wmap, &full[s], n0, kt * RROWS);
          tma_load_2d(ss + s * kTileScaleBytes, &smap, &full[s], n0, kt * kGS);
        }
      }
    }
  } else if (warp == 9) {
    // ---- release: the consumers wait on no mbarrier (ptxas serializes
    // every wgmma of a function in which one is in flight across a spin) ----
    int f = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      for (int kt = 0; kt < stages; ++kt, ++f) {
        const int s = f % ST;
        mbar_wait(&full[s], (f / ST) & 1);
        __syncwarp();
        named_arrive(1 + 2 * s, kTileBarThreads);
        named_arrive(2 + 2 * s, kTileBarThreads);
      }
    }
    // the consumers open one stage past their last (its bytes unused)
    named_arrive(1 + 2 * (f % ST), kTileBarThreads);
    named_arrive(2 + 2 * (f % ST), kTileBarThreads);
  } else if (warp < 8) {
    // ---- consumers ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    // the warp's 16 columns are chunk c16 of a raw row; the thread's A rows
    // g and g + 8 are columns cl and cl + 1 of the unit
    const int c16 = 4 * wg + (warp & 3), cl = 16 * c16 + 2 * g;
    // ldmatrix: lane l gives row l of the stage's raw rows (chunk c16,
    // swizzled); words: word row t4 of each group at column cl
    const uint32_t wrow = FORM == kWords ? (uint32_t)(t4 * kTileN + cl) * 4
                                         : (uint32_t)(lane * kSwizzleRow + ((c16 ^ (lane & 7)) << 4));
    const uint32_t lo = off ? 0xE408E408u : 0xE400E400u;   // -(1024 + off)
    const uint32_t hi = off ? 0xD480D480u : 0xD400D400u;   // -(64 + off)
    Consumer<BM, FORM> k;
    k.ws0 = smem_u32(ws) + wrow;
    k.ss0 = smem_u32(ss);
    k.sx0 = smem_u32(sxs);
    k.xs = xs;
    k.lo = lo;
    k.hi = hi;
    k.s_f16 = s_f16;
    k.wg = wg;
    k.cl = cl;
    k.t4 = t4;
    int s = 0;   // the slot of the CTA's current stage
    k.open(s);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = u % mt * BM, n0 = u / mt * kTileN;
      s = k.unit(stages, s, empty, lane);
      const int col = n0 + cl, r0 = m0 + 2 * t4;
      if (col < N) {
        if (out_f32)
          tile_store<BM>(k.c, static_cast<float*>(out), M, N, r0, col);
        else
          tile_store<BM>(k.c, static_cast<__nv_bfloat16*>(out), M, N, r0, col);
      }
    }
  }
}

// x's q8_1 for the kernels: layout 0, xq int8 (M, K) and sx (M, K / 32), the
// plain version's; 1 and 2, the M > 8 tile's: xq as f16 values (M, K), in
// K's order (1) or, within each group, in words_k's (2: the words form),
// and sx transposed (K / 32, ldt) with each row's 16-row blocks in sx_slot's
// order
template <typename XT>
void quantize(const XT* x, void* xq, float* sx, int M, int K, int layout, int ldt,
              cudaStream_t st) {
  const long long warps = (long long)M * (K / kGroup);
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  if (layout == 0)
    quantize_q8_1_kernel<XT, int8_t, false><<<blocks, 256, 0, st>>>(
        x, static_cast<int8_t*>(xq), sx, M, K, 0);
  else if (layout == 1)
    quantize_q8_1_kernel<XT, __half, false><<<blocks, 256, 0, st>>>(
        x, static_cast<__half*>(xq), sx, M, K, ldt);
  else
    quantize_q8_1_kernel<XT, __half, true><<<blocks, 256, 0, st>>>(
        x, static_cast<__half*>(xq), sx, M, K, ldt);
}

// the M > 8 tile's sx_t row length: M rounded up to whole 16-row blocks
int tile_ldt(int M) { return (M + 15) / 16 * 16; }

template <int BM, int FORM>
cudaError_t launch_tile(const __half* xq, const uint8_t* q, const void* sc, int s_f16,
                        const float* sx_t, void* out, int out_f32, int M, int K, int N, int off,
                        int ctas, cudaStream_t st) {
  using S = TileShape<BM, FORM>;
  // boxes: xq (BM rows, 64 k) f16, 128-byte swizzled (wgmma's K-major B);
  // the raw weight, one stage's rows of 128 columns (int8 and nibble bytes
  // swizzled for ldmatrix); sw, 2 groups of 128 columns; sx_t, 2 groups of
  // BM rows
  CUtensorMap xmap, wmap, smap, sxmap;
  const int G = K / kGroup;
  const long long rows = FORM == kStrided ? K : FORM == kPacked ? K / 2 : K / 8;
  if (!make_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, M, K, K, kTileK, BM, true) ||
      !make_map_2d(&wmap, q,
                   FORM == kWords ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   FORM == kWords ? 4 : 1, rows, N, N, kTileN, (int)(kTileK * rows / K),
                   FORM != kWords) ||
      !make_map_2d(&smap, sc,
                   s_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   s_f16 ? 2 : 4, G, N, N, kTileN, kGS, false) ||
      !make_map_2d(&sxmap, sx_t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, tile_ldt(M), tile_ldt(M),
                   BM, kGS, false))
    return cudaErrorNotSupported;
  const cudaError_t attr = allow_smem<qmm8_tile_kernel<BM, FORM>>(S::kSmem);
  if (attr != cudaSuccess) return attr;
  qmm8_tile_kernel<BM, FORM><<<ctas, kTileThreads, S::kSmem, st>>>(
      xmap, wmap, smap, sxmap, s_f16, out, out_f32, M, K, N, off);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_tiles(int bm, const __half* xq, const uint8_t* q, const void* sc, int s_f16,
                         const float* sx_t, void* out, int out_f32, int M, int K, int N, int off,
                         int ctas, cudaStream_t st) {
#define QMM8_TILE(BM)                                                                      \
  case BM:                                                                                 \
    return launch_tile<BM, FORM>(xq, q, sc, s_f16, sx_t, out, out_f32, M, K, N, off, ctas, st)
  switch (bm) {
    QMM8_TILE(16);
    QMM8_TILE(32);
    QMM8_TILE(64);
    QMM8_TILE(128);
  }
#undef QMM8_TILE
  return cudaErrorInvalidValue;
}

template <typename XT, int FORM>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out, float* scratch,
                   void* xq, float* sx_t, int M, int K, int N, int s_f16, int off, int ksplit,
                   int bm, int ctas, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  if (M > 8) {
    quantize<XT>(xp, xq, sx_t, M, K, FORM == kWords ? 2 : 1, tile_ldt(M), st);
    return launch_tiles<FORM>(bm, static_cast<const __half*>(xq), qp, sc, s_f16, sx_t, out,
                              std::is_same_v<XT, float>, M, K, N, off, ctas, st);
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
                        int off, int ksplit, int bm, int ctas, cudaStream_t st) {
  if (form == kStrided)
    return launch<XT, kStrided>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, 0, ksplit, bm,
                                ctas, st);
  if (form == kPacked)
    return launch<XT, kPacked>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit,
                               bm, ctas, st);
  return launch<XT, kWords>(x, q, sc, out, scratch, xq, sx_t, M, K, N, s_f16, off, ksplit, bm,
                            ctas, st);
}

}  // namespace

// x (M, K) float32 or bf16 -> q8_1 in layout 0 (xq (M, K) int8, sx (M, K /
// 32) float32), or the M > 8 tile's layout 1 or 2 (xq (M, K) float16 values
// in K's order or, within each group, the words form's; sx (K / 32, M
// rounded up to 16) float32, each 16 rows in the tile's order)
extern "C" int qa_quantize_q8_1(const void* x, void* xq, void* sx, int M, int K, int x_bf16,
                                int layout, void* stream) {
  if (M < 1 || K < kGroup || K % kGroup || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sx);
  if (x_bf16)
    quantize<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), xq, s, M, K, layout,
                            tile_ldt(M), st);
  else
    quantize<float>(static_cast<const float*>(x), xq, s, M, K, layout, tile_ldt(M), st);
  return (int)cudaGetLastError();
}

// x (M, K) float32 or bf16; q the weight of layer li in form 0 (int8 (K, N)),
// 1 (nibble bytes (K / 2, N)) or 2 (int32 words (K / 8, N)); sc (K / 32, N)
// float16 or float32; out (M, N) in x's type. scratch: float32 (ksplit, M,
// N), read only when M <= 8 and ksplit > 1; xq (M, K) float16 and sx_t
// float32 (K / 32, M rounded up to a multiple of 16), written and read only
// when M > 8, with bm rows of x a unit (16, 32, 64 or 128) and ctas
// persistent CTAs. off: 8 (symmetric q4_0) or 0.
extern "C" int qa_quant_matmul_int8(const void* x, const void* q, const void* sc, void* out,
                                    void* scratch, void* xq, void* sx_t, int M, int K, int N,
                                    int x_bf16, int s_f16, int form, int off, int ksplit, int bm,
                                    int ctas, void* stream) {
  if (M < 1 || K < kGroup || K % kGroup || N < 16 || N % 16 || form < kStrided ||
      form > kWords || (off != 0 && off != 8) || (form == kStrided && off != 0) ||
      ksplit < 1 || ksplit > 65535 || (N + kSmallCols - 1) / kSmallCols > 65535 ||
      (ksplit > 1 && (M > 8 || scratch == nullptr)) ||
      (M > 8 && (xq == nullptr || sx_t == nullptr || ctas < 1 ||
                 (bm != 16 && bm != 32 && bm != 64 && bm != 128))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  float* sxp = static_cast<float*>(sx_t);
  const cudaError_t rc =
      x_bf16 ? launch_form<__nv_bfloat16>(form, x, q, sc, out, scr, xq, sxp, M, K, N, s_f16,
                                          off, ksplit, bm, ctas, st)
             : launch_form<float>(form, x, q, sc, out, scr, xq, sxp, M, K, N, s_f16, off,
                                  ksplit, bm, ctas, st);
  return (int)rc;
}
