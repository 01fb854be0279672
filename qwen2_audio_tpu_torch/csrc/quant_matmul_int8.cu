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
// - M > 8 (the 752-position prefill, the encoder's 1500 rows): operations
//   (2 M K N int8 operations; fc1 of the encoder 19.7 G, 10 us at 1979
//   TOP/s). quantize_q8_1_kernel first writes xq (M, K) and sx transposed
//   (K / 32, M), one warp per row and group; then qmm8_mma_kernel runs 128 x
//   128 output tiles, 8 warps of 32 x 64, K one 32-group at a time: one
//   mma.sync m16n8k32 (s8 in, s32 out) per 16 x 8 piece and group, whose
//   int32 result is turned to float and added to a float32 accumulator
//   with sx * sw. A fragments are 32-bit words of row-major xq, B fragments
//   the words above, both from shared memory with padded rows (12 and 136
//   words) so that a warp's fragment reads hit 32 distinct banks. A simple
//   tile: no cp.async, TMA, wgmma or pipelining yet.
//
// One layout fact carries the three forms: a word of the words form is
// already the B operand of mma.sync m16n8k32 s8 for its column. Lane t's B
// registers hold k = 4 (t % 4) + 0..3 of column t / 4 and the same + 16; the
// low nibbles of word 4g + t % 4 are the first, its high nibbles the second.
// The packed form gathers the same word from 4 byte rows with __byte_perm,
// and the strided form gathers k .. k + 3 of a column from 4 rows the same
// way, so the three forms feed the same integer products: the packed and the
// words forms of the same bytes give the same bits.
//
// N must be a multiple of 16 and K of 32 (the wrapper checks); the kernels
// mask their own ragged M and N edges and pad nothing in device memory.

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
                     float* __restrict__ sx, int M, int K, int transposed) {
  const int G = K / kGroup;
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= (long long)M * G) return;   // the whole warp
  const int m = (int)(w / G), g = (int)(w % G), lane = threadIdx.x & 31;
  const long long i = (long long)m * K + g * kGroup + lane;
  float s;
  xq[i] = static_cast<int8_t>(q8_1_lane(to_float(x[i]), s));
  if (lane == 0) sx[transposed ? (long long)g * M + m : (long long)m * G + g] = s;
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
// M > 8: 128 x 128 output tiles, one 32-group of K per step, s8 tensor cores
// ------------------------------------------------------------------------- //

constexpr int kBM = 128, kBN = 128, kTileThreads = 256;
constexpr int kLDA = 12;    // words per row of the xq tile (8 used)
constexpr int kLDB = 136;   // words per k-quad row of the weight tile (128 used)

// d = a (16 x 32, row) * b (32 x 8, col), s8 in, exact s32 out
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  d[0] = d[1] = d[2] = d[3] = 0;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bs[i * kLDB + n]: k 4i .. 4i + 3 of the group at tile column n, int8
template <int FORM>
__device__ __forceinline__ void load_weight_tile(uint32_t* Bs, const uint8_t* __restrict__ q,
                                                 int N, int gi, int n0, int off, int tid) {
  const int r = tid >> 5, cq = tid & 31, col = n0 + cq * 4;
  if constexpr (FORM == kStrided) {   // 8 k-quads x 32 column quads: one a thread
    uint32_t c4[4] = {0u, 0u, 0u, 0u};
    if (col < N) {
      const uint8_t* p = q + ((long long)gi * kGroup + 4 * r) * N + col;
      transpose_bytes(ld32(p), ld32(p + N), ld32(p + 2 * N), ld32(p + 3 * N), c4);
    }
    *reinterpret_cast<uint4*>(Bs + r * kLDB + cq * 4) = make_uint4(c4[0], c4[1], c4[2], c4[3]);
  } else if (tid < 128) {   // 4 word rows x 32 column quads
    uint32_t w4[4] = {0u, 0u, 0u, 0u}, lo[4], hi[4];
    if (col < N) nibble_words<FORM>(q, N, gi, r, col, w4);
#pragma unroll
    for (int c = 0; c < 4; ++c) nibble_quads(w4[c], off, lo[c], hi[c]);
    *reinterpret_cast<uint4*>(Bs + r * kLDB + cq * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(Bs + (4 + r) * kLDB + cq * 4) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

template <typename XT, int FORM>
__global__ void __launch_bounds__(kTileThreads)
qmm8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx_t,
                const uint8_t* __restrict__ q, const void* __restrict__ sc, int s_f16,
                XT* __restrict__ out, int M, int K, int N, int off) {
  __shared__ __align__(16) uint32_t As[kBM * kLDA];   // [m][k quad]
  __shared__ __align__(16) uint32_t Bs[8 * kLDB];     // [k quad][n]
  __shared__ float sxs[kBM], sws[kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;      // 4 x 2 warps of 32 x 64 outputs
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int gid = lane >> 2, tig = lane & 3;
  const int xr = tid >> 1, xh = tid & 1;        // the thread's 16 bytes of the xq tile

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int G = K / kGroup;
  for (int gi = 0; gi < G; ++gi) {
    __syncthreads();   // every warp is done with the previous group's tiles
    {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + xr < M)
        a = *reinterpret_cast<const uint4*>(xq + (long long)(m0 + xr) * K + gi * kGroup +
                                            xh * 16);
      *reinterpret_cast<uint4*>(As + xr * kLDA + xh * 4) = a;
    }
    load_weight_tile<FORM>(Bs, q, N, gi, n0, off, tid);
    if (tid < kBM) {
      sxs[tid] = m0 + tid < M ? sx_t[(long long)gi * M + m0 + tid] : 0.f;
    } else {
      const int c = n0 + tid - kBM;
      const long long idx = (long long)gi * N + c;
      sws[tid - kBM] = c >= N ? 0.f
                       : s_f16 ? __half2float(static_cast<const __half*>(sc)[idx])
                               : static_cast<const float*>(sc)[idx];
    }
    __syncthreads();

    uint32_t a[2][4];
    float sxr[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + gid;
      a[mt][0] = As[r * kLDA + tig];
      a[mt][1] = As[(r + 8) * kLDA + tig];
      a[mt][2] = As[r * kLDA + 4 + tig];
      a[mt][3] = As[(r + 8) * kLDA + 4 + tig];
      sxr[mt][0] = sxs[r];
      sxr[mt][1] = sxs[r + 8];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = wn * 64 + nt * 8;
      const uint32_t b0 = Bs[tig * kLDB + n + gid], b1 = Bs[(4 + tig) * kLDB + n + gid];
      const float s0 = sws[n + 2 * tig], s1 = sws[n + 2 * tig + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        int d[4];
        mma_s8(d, a[mt], b0, b1);
        float* c = acc[mt][nt];
        c[0] = fmaf(static_cast<float>(d[0]), __fmul_rn(sxr[mt][0], s0), c[0]);
        c[1] = fmaf(static_cast<float>(d[1]), __fmul_rn(sxr[mt][0], s1), c[1]);
        c[2] = fmaf(static_cast<float>(d[2]), __fmul_rn(sxr[mt][1], s0), c[2]);
        c[3] = fmaf(static_cast<float>(d[3]), __fmul_rn(sxr[mt][1], s1), c[3]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = m0 + wm * 32 + mt * 16 + gid, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn * 64 + nt * 8 + 2 * tig;
      if (col < N) {
        if (ra < M) store2(out + (long long)ra * N + col, acc[mt][nt][0], acc[mt][nt][1]);
        if (rb < M) store2(out + (long long)rb * N + col, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

template <typename XT>
void quantize(const XT* x, int8_t* xq, float* sx, int M, int K, int transposed,
              cudaStream_t st) {
  const long long warps = (long long)M * (K / kGroup);
  quantize_q8_1_kernel<XT><<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(x, xq, sx, M, K,
                                                                         transposed);
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
    quantize<XT>(xp, xq, sx_t, M, K, 1, st);
    const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    qmm8_mma_kernel<XT, FORM><<<grid, kTileThreads, 0, st>>>(xq, sx_t, qp, sc, s_f16, op,
                                                             M, K, N, off);
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
    quantize<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), q, s, M, K, transposed, st);
  else
    quantize<float>(static_cast<const float*>(x), q, s, M, K, transposed, st);
  return (int)cudaGetLastError();
}

// x (M, K) float32 or bf16; q the weight of layer li in form 0 (int8 (K, N)),
// 1 (nibble bytes (K / 2, N)) or 2 (int32 words (K / 8, N)); sc (K / 32, N)
// float16 or float32; out (M, N) in x's type. scratch: float32 (ksplit, M,
// N), read only when M <= 8 and ksplit > 1; xq (M, K) int8 and sx_t float32
// (K / 32, M), read only when M > 8. off: 8 (symmetric q4_0) or 0.
extern "C" int qa_quant_matmul_int8(const void* x, const void* q, const void* sc, void* out,
                                    void* scratch, void* xq, void* sx_t, int M, int K, int N,
                                    int x_bf16, int s_f16, int form, int off, int ksplit,
                                    void* stream) {
  if (M < 1 || K < kGroup || K % kGroup || N < 16 || N % 16 || form < kStrided ||
      form > kWords || (off != 0 && off != 8) || (form == kStrided && off != 0) ||
      ksplit < 1 || ksplit > 65535 || (N + kBN - 1) / kBN > 65535 ||
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
