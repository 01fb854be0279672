// The M <= 8 weight-streaming core of quant_matmul.cu (qmm_stream_kernel)
// and fused_mlp.cu (swiglu_coop_kernel at M <= 8), fast mode: x and each weight
// rounded once to bf16, products on the tensor cores, float32 sums.
//
// What bounds these kernels is the weight bytes, so the design keeps the
// card's 3.35 TB/s covered and spends as few instructions per weight value
// as it can:
// - The weight ring. A warp owns a block of 64 columns and streams its raw
//   bytes and scales (and mins) through its own ring of shared-memory
//   stages of 32 values of K (32 int8 byte rows, or 16 nibble rows, of 64
//   bytes, and their 1 or 2 scale rows), filled by 16-byte cp.async of its
//   own lanes Stage::kRing - 1 stages ahead (2-3 KB a warp, 32-48 KB an
//   SM; deeper rings measured slower on the H100), and no block barrier
//   between a warp's stages. A lane's copy addresses are set once per run
//   of stages and step by a constant.
// - The products: mma.sync m16n8k16 bf16 -> f32 with the dequantized weight
//   as A (16 columns x 16 values of K) and x as B (16 values of K x 8 rows,
//   rows past M zero), so that M <= 8 fills n = 8. x is rounded to bf16 once
//   per block into shared memory (stage_x), already in B's fragment order.
//   A weight value costs its dequantize: a byte permute and a subtract
//   (2^23 + byte, exact), the float32 multiply by its scale (and the add of
//   its min), and half of one F2FP, which rounds two values to a bf16 pair.
// - The fragment map. Lane (g = lane / 4, t = lane % 4) holds four A tiles:
//   in tile j, A row g is column 8 g + 2 j and row g + 8 column 8 g + 2 j + 1,
//   so that the lane's columns are the 8 neighbours 8 g .. 8 g + 7; and of
//   each 16 values of K it holds values t, t + 4, t + 8, t + 12 (mma slots
//   2t, 2t+1, 2t+8, 2t+9; B takes the same order, so the sum is the same).
//   Its reads are one 8-byte word per byte row, and the four rows that the
//   four t read at once are neighbours, in both halves of the banks: two
//   wavefronts, no conflict. A nibble row g * 16 + j holds values j and
//   j + 16 of its group, so one read of the 16 rows feeds both k16 steps.
// The sums run in the tensor cores' order and the plan depends on M, K and
// N only: the same values give the same bits in row-major and panel storage.

#pragma once

#include "hopper_mma.cuh"
#include "qmm_common.cuh"

namespace qa {

constexpr int kWarpCols = 64;   // columns of a warp's block

// one ring stage: 32 values of K of a 64-column block
template <bool PACKED, bool MINS>
struct Stage {
  static constexpr int kRows = PACKED ? 16 : 32;      // byte rows
  static constexpr int kData = kRows * kWarpCols;
  static constexpr int kScale = PACKED ? 256 : 512;   // <= 32 / group rows of 64 float32
  static constexpr int kBytes = kData + kScale * (MINS ? 2 : 1);
  static constexpr int kRing = PACKED ? 4 : 2;        // stages of a warp's ring
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// A lane's copies of a run of stages of one 64-column block: its 16
// columns 16 (lane % 4) .. of byte rows lane / 4 + 8 u of each stage, and at
// most one 16-byte chunk of scales (scale row lane / (4 es) of the stage, es
// bytes a scale) and one of mins (row lane / 16). The pointers are at the
// next stage and step by a stage's rows. A chunk past the weight's columns
// is not copied (*ok false): its products land in outputs past N, which are
// never stored.
struct LaneCopy {
  const uint8_t* q;
  const uint8_t* s;
  const uint8_t* m;
  long long q8, qstep, sstep, mstep;   // bytes: 8 byte rows; one stage
  int ds, dm;                          // slot offsets of the scale and min chunks
  bool qok, sok, mok;
};

// the lane's copies from stage kg (32-row group kg of K) on: q0, s0, m0 are
// its chunks' addresses in row 0 (any address where not ok), ldq / lds / ldm
// the bytes from one row to the next, srows the scale rows a stage has
template <bool PACKED, bool MINS>
__device__ __forceinline__ LaneCopy lane_copy(const uint8_t* q0, bool qok, long long ldq,
                                             const uint8_t* s0, bool sok, long long lds,
                                             const uint8_t* m0, bool mok, long long ldm,
                                             int es, int srows, long long kg, int lane) {
  using St = Stage<PACKED, MINS>;
  LaneCopy c;
  const int sr = lane / (4 * es), mr = lane >> 4;
  c.qok = qok;
  c.sok = sok && sr < srows;
  c.mok = MINS && mok && mr < srows;
  c.q = q0 + (qok ? (kg * St::kRows + (lane >> 2)) * ldq : 0);
  c.s = s0 + (c.sok ? (kg * srows + sr) * lds : 0);
  c.m = m0 + (c.mok ? (kg * srows + mr) * ldm : 0);
  c.q8 = 8 * ldq;
  c.qstep = qok ? St::kRows * ldq : 0;
  c.sstep = c.sok ? srows * lds : 0;
  c.mstep = c.mok ? srows * ldm : 0;
  c.ds = St::kData + sr * kWarpCols * es + (lane % (4 * es)) * 16;
  c.dm = St::kData + St::kScale + mr * kWarpCols * 4 + (lane & 15) * 16;
  return c;
}

// one stage's copies into slot, then the pointers step to the next stage
template <bool PACKED, bool MINS>
__device__ __forceinline__ void issue_stage(uint8_t* slot, LaneCopy& c, int lane) {
  using St = Stage<PACKED, MINS>;
  uint8_t* d = slot + (lane >> 2) * kWarpCols + 16 * (lane & 3);
  if (c.qok) {
#pragma unroll
    for (int u = 0; u < St::kRows / 8; ++u)
      cp_async16(d + u * 8 * kWarpCols, c.q + u * c.q8, true);
  }
  if (c.sok) cp_async16(slot + c.ds, c.s, true);
  if (MINS && c.mok) cp_async16(slot + c.dm, c.m, true);
  c.q += c.qstep;
  c.s += c.sstep;
  if (MINS) c.m += c.mstep;
}

// x rows 0 .. M - 1 (ldx elements apart), values 0 .. kc - 1 (a multiple of
// 16), rounded once to bf16 (round to nearest even) into B's fragment
// order: xs[(b * M + m) * 4 + t] holds values 16 b + t, + 4 | + 8, + 12 of
// row m
template <typename XT>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x, long long ldx, int M, int kc,
                                        uint2* xs, int tid, int nthreads) {
  const int nb = kc / 16;
  for (int e = tid; e < M * nb; e += nthreads) {
    const int m = e / nb, b = e - m * nb;
    float v[16], w[8];
    load_x8(x + (long long)m * ldx + 16 * b, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i];
    load_x8(x + (long long)m * ldx + 16 * b + 8, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[8 + i] = w[i];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      xs[(b * M + m) * 4 + t] = make_uint2(pack_bf16(v[t], v[t + 4]), pack_bf16(v[t + 8], v[t + 12]));
  }
}

// B of k16 block b for this lane (rows past M are zero)
__device__ __forceinline__ uint2 b_frag(const uint2* xs, int b, int M, int lane) {
  const int g = lane >> 2;
  return g < M ? xs[(b * M + g) * 4 + (lane & 3)] : make_uint2(0u, 0u);
}

// the lane's 8 scales (or mins, float32) of scale row sr of a stage
__device__ __forceinline__ void stage_scales8(const uint8_t* p, int sr, int es, int g,
                                             float (&s)[8]) {
  if (es == 2) {
    const uint4 r = *reinterpret_cast<const uint4*>(p + sr * kWarpCols * 2 + g * 16);
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __half22float2(h[i]);
      s[2 * i] = a.x;
      s[2 * i + 1] = a.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(p + sr * kWarpCols * 4 + g * 32);
    const float4 a = f[0], b = f[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
}

// one k16 step: the 4 byte words w[i] (8 columns of the lane's row t + 4 i,
// already masked to values), dequantized and multiplied into acc
template <bool MINS>
__device__ __forceinline__ void step_mma(float (&acc)[4][4], const uint2 (&w)[4],
                                         const float (&s)[8], const float (&mn)[8], float zero,
                                         uint2 b) {
  float v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float q = byte_as_float(c < 4 ? w[i].x : w[i].y, c & 3) - zero;
      v[i][c] = MINS ? __fadd_rn(__fmul_rn(q, s[c]), mn[c]) : __fmul_rn(q, s[c]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mma_bf16_16816(acc[j], pack_bf16(v[0][2 * j], v[1][2 * j]),
                   pack_bf16(v[0][2 * j + 1], v[1][2 * j + 1]),
                   pack_bf16(v[2][2 * j], v[3][2 * j]),
                   pack_bf16(v[2][2 * j + 1], v[3][2 * j + 1]), b);
}

// consume one ring stage (32 values of K): B blocks xb0 (values 0-15) and
// xb1 (16-31); group 32 or 16 (then scale row h for step h)
template <bool PACKED, bool MINS, bool DQ16>
__device__ __forceinline__ void consume_stage(float (&acc)[4][4], const uint8_t* slot, int es,
                                              int group, float zero, uint2 xb0, uint2 xb1,
                                              int lane) {
  using St = Stage<PACKED, MINS>;
  const int g = lane >> 2, t = lane & 3;
  float s[8], mn[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0 || group == 16) {
      stage_scales8(slot + St::kData, h, es, g, s);
      if (MINS) stage_scales8(slot + St::kData + St::kScale, h, 4, g, mn);
      if (DQ16) {
#pragma unroll
        for (int c = 0; c < 8; ++c) s[c] = round_bf16(s[c]);
      }
    }
    uint2 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = PACKED ? t + 4 * i : 16 * h + t + 4 * i;
      const uint2 r = *reinterpret_cast<const uint2*>(slot + row * kWarpCols + 8 * g);
      if (PACKED) {
        const int sh = 4 * h;
        w[i] = make_uint2((r.x >> sh) & 0x0F0F0F0Fu, (r.y >> sh) & 0x0F0F0F0Fu);
      } else {
        w[i] = make_uint2(r.x ^ 0x80808080u, r.y ^ 0x80808080u);
      }
    }
    step_mma<MINS>(acc, w, s, mn, zero, h == 0 ? xb0 : xb1);
  }
}

// the lane's outputs of row 2 t + h (h = 0, 1) at columns 8 g .. 8 g + 7
__device__ __forceinline__ void acc_row(const float (&acc)[4][4], int h, float (&o)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = acc[j][h];
    o[2 * j + 1] = acc[j][2 + h];
  }
}

__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&o)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                 pack_bf16(o[6], o[7]));
}

// out[i] = the S float32 partial sums p[s * stride + i] added in split
// order, the loads of 8 splits at a time in flight together
__device__ __forceinline__ float4 sum_splits4(const float* p, int S, long long stride) {
  float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  for (int s0 = 1; s0 < S; s0 += 8) {
    float4 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < S) w[j] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + j) * stride));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (s0 + j < S) {
        v.x += w[j].x; v.y += w[j].y; v.z += w[j].z; v.w += w[j].w;
      }
    }
  }
  return v;
}

}  // namespace qa
