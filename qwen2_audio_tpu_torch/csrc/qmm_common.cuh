// Shared by quant_matmul.cu, fused_mlp.cu and quant_matmul_int8.cu: how a
// thread turns the bytes of a ggml block weight into floats, the float32
// weight-streaming step of the first two's exact mode at M <= 8, and the
// deterministic sum of split partials all three use.
//
// A weight is stored [in, out]: byte row r of a column holds int8 value r,
// or (packed) the nibbles of values g * 32 + j (low) and g * 32 + j + 16
// (high) in byte row g * 16 + j. One scale (and, where the format has one,
// one min) covers `group` values of a column: w = float(v) * s (+ m).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qa {

constexpr float kTwo23 = 8388608.f;

// 2^23 + byte i of word, as a float (exact)
__device__ __forceinline__ float byte_as_float(uint32_t word, int i) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650 + i));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring outputs, cast to the output's type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// what byte_as_float's result is reduced by: packed, nibble - off; int8,
// the byte xored with 0x80, - 128
__device__ __host__ __forceinline__ float zero_point(bool packed, int off) {
  return kTwo23 + (packed ? (float)off : 128.f);
}

__device__ __forceinline__ void load_scales4(const void* sc, int s_f16, long long idx,
                                             float (&s)[4]) {
  if (s_f16) {
    const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const __half*>(sc) + idx);
    const __half2* h = reinterpret_cast<const __half2*>(&r);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    s[0] = a.x; s[1] = a.y; s[2] = b.x; s[3] = b.y;
  } else {
    const float4 r = *reinterpret_cast<const float4*>(static_cast<const float*>(sc) + idx);
    s[0] = r.x; s[1] = r.y; s[2] = r.z; s[3] = r.w;
  }
}

__device__ __forceinline__ void load_x8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    v[2 * i] = a.x;
    v[2 * i + 1] = a.y;
  }
}

// One lane's share of 32 values of K in float32 (the exact mode of the
// M <= 8 kernels): acc[m][c] += sum over k of x[m][k] * w[k][c] for the
// lane's 4 neighbouring columns c.
//   qp      the byte row of the first value (row k0, or k0 / 2 packed) at
//           the lane's first column; ldq bytes from one row to the next
//   s0, s1  element index, at the lane's first column, of the scale row of
//           values k0 .. k0 + 15 and of k0 + 16 .. k0 + 31 (the same row when
//           group is 32); mn, if MINS, is indexed the same way
//   x       value k0 of the first row of x; ldx elements from row to row;
//           rows >= 1 rows are valid, a row past them repeats the last one
// The weight bytes are read once, 4 bytes per lane and row, so a warp reads
// 128 contiguous bytes of each row. q * s + m is a multiply and an add, each
// rounded, as the plain version does it.
template <typename XT, bool PACKED, bool MINS, int MT>
__device__ __forceinline__ void block32_fma(
    float (&acc)[MT][4], const uint8_t* __restrict__ qp, long long ldq,
    const void* __restrict__ sc, int s_f16, const float* __restrict__ mn, long long s0,
    long long s1, float zero, const XT* __restrict__ x, long long ldx, int rows) {
  constexpr int ROWS = PACKED ? 16 : 32;   // byte rows per 32 values of K
  uint32_t wq[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
    wq[j] = *reinterpret_cast<const uint32_t*>(qp + (long long)j * ldq);
  float s[2][4], mv[2][4];
  load_scales4(sc, s_f16, s0, s[0]);
  if (MINS) load_scales4(mn, 0, s0, mv[0]);
  if (s1 != s0) {
    load_scales4(sc, s_f16, s1, s[1]);
    if (MINS) load_scales4(mn, 0, s1, mv[1]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[1][c] = s[0][c];
      if (MINS) mv[1][c] = mv[0][c];
    }
  }
#pragma unroll
  for (int c8 = 0; c8 < 4; ++c8) {
    float w[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int k = c8 * 8 + jj;
      const uint32_t word = PACKED ? ((wq[k & 15] >> ((k >> 4) * 4)) & 0x0F0F0F0Fu)
                                   : (wq[k & (ROWS - 1)] ^ 0x80808080u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = __fmul_rn(byte_as_float(word, c) - zero, s[k >> 4][c]);
        if (MINS) v = __fadd_rn(v, mv[k >> 4][c]);
        w[jj][c] = v;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mr = m < rows ? m : rows - 1;
      float xv[8];
      load_x8(x + (long long)mr * ldx + c8 * 8, xv);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv[jj], w[jj][c], acc[m][c]);
      }
    }
  }
}

// out = the S float32 partial sums added in split order, cast to XT
template <typename XT>
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ partial, XT* __restrict__ out, int S,
                       long long MN) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < MN) {
    float v = partial[i];
    for (int s = 1; s < S; ++s) v += partial[(long long)s * MN + i];
    out[i] = from_float<XT>(v);
  }
}

}  // namespace qa
