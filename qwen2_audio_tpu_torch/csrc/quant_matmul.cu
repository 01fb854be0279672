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
// - M > 8 (prefill M = 752, the encoder M = 1500): operations.
//   fast mode: qmm_mma_kernel, a 128 x 128 output tile per block of 8 warps,
//   K in steps of 32; each step dequantizes a (32, 128) weight tile to bf16
//   in shared memory, rounds the (128, 32) x tile to bf16, and runs
//   mma.sync m16n8k16 (bf16 in, float32 accumulate) with ldmatrix (.trans
//   for the row-major weight tile). The next step's global loads are started
//   before the current step's products. Row strides are padded by 8
//   elements so the 8 rows of an ldmatrix fall on distinct banks.
//   exact mode: qmm_fma_kernel, the same tiles in float32 with an 8 x 8
//   register tile per thread and FMA only (no TF32): slow, and exact.
//   Blocks that share a weight panel are neighbours in launch order
//   (blockIdx.x walks M), so the panel is read from device memory about
//   once. cp.async/TMA pipelines and wgmma are left for later work.
// The kernel masks its own ragged M edge; nothing is padded in device
// memory. N and bn must be multiples of 16 and K of 32 (the wrapper checks),
// so a thread's 4 or 8 neighbouring columns never straddle a panel. The
// split over K depends on M, K and N only: the same values give the same
// bits whether they are stored row-major or in panels.

#include "qmm_common.cuh"

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

// the 2 x 8 dequantized float32 weights of a thread: rows wr and wr + 16;
// DQ16 rounds each scale to bf16 first
template <bool DQ16, typename XT, bool PACKED>
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
    const float s0 = DQ16 ? round_bf16(r.s0[c]) : r.s0[c];
    const float s1 = DQ16 ? round_bf16(r.s1[c]) : r.s1[c];
    lo[c] = (byte_as_float(wl[c >> 2], c & 3) - zero) * s0;
    hi[c] = (byte_as_float(wh[c >> 2], c & 3) - zero) * s1;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fast mode: bf16 tensor cores
template <typename XT, bool PACKED, bool DQ16>
__global__ void __launch_bounds__(kTileThreads)
qmm_mma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
               const void* __restrict__ sc, int s_f16, XT* __restrict__ out, int M,
               int K, int N, int bn, int group, float zero) {
  constexpr int XLD = kBK + 8, WLD = kBN + 8;
  __shared__ __align__(16) __nv_bfloat16 Xs[kBM * XLD];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Ws[kBK * WLD];   // [k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;     // 4 x 2 warps of 32 x 64 outputs
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wr = tid >> 4, wc = (tid & 15) * 8;   // weight rows wr, wr + 16
  const int xr = tid >> 1, xh = (tid & 1) * 16;   // x row, first of 16 k

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  TileRegs<XT, PACKED> regs;
  tile_load(regs, x, q, sc, s_f16, M, K, N, bn, group, 0, m0 + xr, xh, wr, n0 + wc);
  const int steps = K / kBK;
  for (int kt = 0; kt < steps; ++kt) {
    __syncthreads();   // every warp is done with the previous step's tiles
    {
      float lo[8], hi[8];
      tile_dequant<DQ16>(regs, zero, lo, hi);
      *reinterpret_cast<uint4*>(Ws + wr * WLD + wc) =
          make_uint4(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                     pack_bf16(lo[4], lo[5]), pack_bf16(lo[6], lo[7]));
      *reinterpret_cast<uint4*>(Ws + (wr + 16) * WLD + wc) =
          make_uint4(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]),
                     pack_bf16(hi[4], hi[5]), pack_bf16(hi[6], hi[7]));
      const float* xv = regs.xv;
      *reinterpret_cast<uint4*>(Xs + xr * XLD + xh) =
          make_uint4(pack_bf16(xv[0], xv[1]), pack_bf16(xv[2], xv[3]),
                     pack_bf16(xv[4], xv[5]), pack_bf16(xv[6], xv[7]));
      *reinterpret_cast<uint4*>(Xs + xr * XLD + xh + 8) =
          make_uint4(pack_bf16(xv[8], xv[9]), pack_bf16(xv[10], xv[11]),
                     pack_bf16(xv[12], xv[13]), pack_bf16(xv[14], xv[15]));
    }
    __syncthreads();
    if (kt + 1 < steps)
      tile_load(regs, x, q, sc, s_f16, M, K, N, bn, group, (kt + 1) * kBK, m0 + xr, xh,
                wr, n0 + wc);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], Xs + (wm * 32 + mt * 16 + (lane & 15)) * XLD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD +
                                 wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = m0 + wm * 32 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn * 64 + nt * 8 + 2 * t4;
      if (col < N) {
        if (ra < M) store2(out + (long long)ra * N + col, acc[mt][nt][0], acc[mt][nt][1]);
        if (rb < M) store2(out + (long long)rb * N + col, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
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
      tile_dequant<false>(regs, zero, lo, hi);
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

template <typename XT, bool PACKED>
cudaError_t launch(const void* x, const void* q, const void* sc, void* out,
                   float* scratch, int M, int K, int N, int bn, int group, int s_f16,
                   int off, int fast, int dq16, int ksplit, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  XT* op = static_cast<XT*>(out);
  const float zero = zero_point(PACKED, off);
  if (M <= 8) {
    const dim3 grid((N + kSmallCols - 1) / kSmallCols, ksplit);
    float* partial = ksplit > 1 ? scratch : nullptr;
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
  } else {
    const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    if (dq16)
      qmm_mma_kernel<XT, PACKED, true><<<grid, kTileThreads, 0, st>>>(
          xp, qp, sc, s_f16, op, M, K, N, bn, group, zero);
    else if (fast)
      qmm_mma_kernel<XT, PACKED, false><<<grid, kTileThreads, 0, st>>>(
          xp, qp, sc, s_f16, op, M, K, N, bn, group, zero);
    else
      qmm_fma_kernel<XT, PACKED><<<grid, kTileThreads, 0, st>>>(
          xp, qp, sc, s_f16, op, M, K, N, bn, group, zero);
  }
  return cudaGetLastError();
}

}  // namespace

// x (M, K) float32 or bf16; q int8 values or, packed, nibble bytes, as
// N / bn column panels of (K or K / 2, bn), bn = N for a row-major weight;
// sc (N / bn, K / group, bn) float16 or float32; out (M, N) in x's type.
// scratch: float32 (ksplit, M, N), read only when M <= 8 and ksplit > 1.
// dq16 (fast mode only) rounds each scale to bf16 before the multiply, so
// that wr = bf16(v * bf16(s)), the TPU kernels' bf16-domain dequant; it runs
// its own instantiations, and the default ones compile as without it.
extern "C" int qa_quant_matmul(const void* x, const void* q, const void* sc, void* out,
                               void* scratch, int M, int K, int N, int bn, int group,
                               int x_bf16, int s_f16, int packed, int off, int fast,
                               int dq16, int ksplit, void* stream) {
  if (M < 1 || K % 32 || N % 16 || bn < 16 || bn % 16 || N % bn || (dq16 && !fast) ||
      (group != 16 && group != 32) || (packed && group != 32) || ksplit < 1 ||
      (N + kBN - 1) / kBN > 65535 || ksplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
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
