// Softmax attention for Hopper (sm_90a), plain C interface for ctypes: the
// one-shot encoder attention (qa_attention_single) and the causal decoder
// prefill (qa_attention_causal).
//
// Replaces the TPU kernel
// qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel_single:
// O = softmax(sm_scale * Q K^T) V over keys [0, kv_valid), sm_scale applied
// to the float32 scores (1 where the caller pre-scaled Q), query head h
// reads KV head h / (H / Hkv), float32 softmax and accumulation, the
// l == 0 -> 1 guard, output in the input type.
// qa_attention_causal replaces the TPU kernel
// qwen2_audio_tpu/ops/flash_attention.py::_attn_kernel with causal=True (the
// decoder prefill): the same, with key j visible to query i iff j <= i and
// j < kv_valid, and each query block's key loop stopped at its diagonal
// chunk (the TPU kernel's tile skip).
//
// What bounds it: arithmetic. The encoder shape (T = 1500, d = 64, 20 heads)
// does 4*T^2*d*H = 11.5 GFLOP per layer on 15.4 MB of bf16 Q/K/V/O: about
// 12 us at the 989 TFLOP/s bf16 tensor-core peak against about 5 us for the
// bytes. The decoder prefill (T = 752, d = 128, 28 query heads on 4 KV
// heads, causal) does about 4.1 GFLOP per layer: about 4 us at the bf16
// peak, 61 us at the 67 TFLOP/s float32 peak.
//
// The same entries serve the TPU kernels' options and variants, chosen by
// the runtime `flags`. Each kernel has two instantiations: OPTS = false is
// the default path (no flag, sm_scale 1 for the one-shot kernel, causal for
// the float32 causal kernel) compiled as it was before the options came, so
// that they cost it no registers or branches; OPTS = true reads the flags,
// sm_scale and the causal switch at run time. The build stays about as long
// (fused_mlp.cu, built beside it, takes the longest):
// - kExp2: the scores are log2-domain logits (the caller folded LOG2E into
//   its Q pre-scale) and both the running-max rescale and p take exp2f
//   (flash_attention.py:56, :136-143, fa_variants.py:136);
// - kPexp16 (one-shot kernels): p = bf16(exp(bf16(s - m))), the row sum adds
//   those bf16 values in float32 and P V takes them as rounded
//   (flash_attention.py:132-140);
// - kLite (fa_variants.py:105 _attn_kernel_single_lite, the caller pre-scales
//   Q in Q's type): the row sum adds p after its cast to V's type, as the TPU
//   kernel's ones column of V makes it; with float32 V nothing changes.
//   The TPU kernel masked keys by a -1e30 bias in K's pad column, which gives
//   them p = 0 exactly; here keys at or past kv_valid are never read, so a
//   NaN there cannot reach P V.
// The non-causal use of _attn_kernel (blockwise online softmax over block_k
// tiles, flash_attention.py:242 with causal=False) computes the same function
// as _attn_kernel_single, sm_scale on the float32 scores in both: this
// kernel already streams the keys with an online softmax, so that use is
// qa_attention_single too, not a third loop. In every case m is a running
// maximum, so p (and, under kPexp16, s - m) is rounded against another
// maximum than in the TPU kernels' whole-row tile: the bits differ, within
// the stated tolerance.
//
// Design: the TPU kernel held a whole (128 x 1536) float32 score tile in
// VMEM (768 KB); a Hopper block has at most 227 KB of shared memory, so the
// keys stream through shared memory in chunks of 64 with a running max and
// sum per query row (online softmax) inside one block, and the scores never
// leave registers.
// - bf16: one block of 4 warps per (batch, head, 64 queries); each warp owns
//   16 query rows and runs mma.sync m16n8k16 (bf16 in, float32 accumulate)
//   for Q K^T and for P V. P goes from the score accumulators straight into
//   the A fragments of the second product, cast to bf16 as the TPU kernel
//   casts p to V's type; the row sum is taken over the float32 p (over the
//   bf16 p under kPexp16 or kLite). V is stored transposed in shared memory
//   so both products read their B fragments as 32-bit words; rows are
//   padded by 8 elements so the 8 rows a fragment load touches fall on
//   distinct banks.
// - float32: FMA only (no TF32), one thread per query row, 128 rows per
//   block, keys in chunks of 32 that every thread reads by broadcast (d = 64;
//   d = 128 takes the causal float32 kernel below with the mask off).
// - causal bf16: the bf16 kernel above with the mask and the loop bound
//   of the causal template flag.
// - causal float32 (d = 128): one query row would need 2*d float
//   registers for q and the accumulator, so two threads share a row, each
//   holding every other float4 of d (the two halves then read neighbouring
//   16-byte words of a shared key row, no bank conflict), and the partial
//   dot products meet with one shuffle; 64 rows per block of 128 threads.
// Heads are read by stride, so Q/K/V may be views into the fused QKV
// projection output; the output is written in the layout the strides give.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, t;
};

constexpr int kBQ = 64;      // bf16: queries per block (4 warps x 16 rows)
constexpr int kBK = 64;      // bf16: keys per chunk
constexpr int kWarps = 4;
constexpr int kPad = 8;      // bf16 elements of padding per shared row

// option bits of `flags`
constexpr int kExp2 = 1;     // exp2f in place of expf
constexpr int kPexp16 = 2;   // p = bf16(exp(bf16(s - m))), the row sum of those
constexpr int kLite = 4;     // the row sum of p as cast to V's type

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the softmax's exponential, e^x or (kExp2) 2^x
__device__ __forceinline__ float expo(float x, int flags) {
  return (flags & kExp2) ? exp2f(x) : expf(x);
}

// p for shifted score x = s - m
__device__ __forceinline__ float prob(float x, int flags) {
  if (flags & kPexp16) return round_bf16(expo(round_bf16(x), flags));
  return expo(x, flags);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBQ * (D + kPad) + kBK * (D + kPad) + D * (kBK + kPad)) * 2;
}

template <int D, bool CAUSAL, bool OPTS>
__global__ void __launch_bounds__(kWarps * 32)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, Strides so, int group, int Tq, int kv_valid,
                 float sm_scale, int opt_flags) {
  const int flags = OPTS ? opt_flags : 0;
  constexpr bool SCALE = CAUSAL || OPTS;   // the one-shot default: Q pre-scaled
  constexpr int LD = D + kPad;      // row stride of Qs and Ks
  constexpr int LDV = kBK + kPad;   // row stride of Vt
  constexpr int V8 = D / 8;         // 16-byte vectors per row
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][LD]
  __nv_bfloat16* Ks = Qs + kBQ * LD;                               // [kBK][LD]
  __nv_bfloat16* Vt = Ks + kBK * LD;                               // [D][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / group;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // the row sum adds p as P V takes it, rounded to bf16
  const bool sum16 = flags & (kPexp16 | kLite);

  for (int i = tid; i < kBQ * V8; i += kWarps * 32) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = zero;
    if (q0 + r < Tq)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sq.t + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;     // this thread's rows: r0 and r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = ld32(Qs + r0 * LD + ks * 16 + 2 * t4);
    qf[ks][1] = ld32(Qs + (r0 + 8) * LD + ks * 16 + 2 * t4);
    qf[ks][2] = ld32(Qs + r0 * LD + ks * 16 + 2 * t4 + 8);
    qf[ks][3] = ld32(Qs + (r0 + 8) * LD + ks * 16 + 2 * t4 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int n_chunks = (kv_valid + kBK - 1) / kBK;
  if (CAUSAL)   // tile skip: no key past the block's last query row
    n_chunks = min(n_chunks, (q0 + kBQ - 1) / kBK + 1);
  const int qa = q0 + r0, qc = qa + 8;   // this thread's two query rows
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int k0 = ch * kBK;
    __syncthreads();   // every warp is done with the previous chunk
    for (int i = tid; i < kBK * V8; i += kWarps * 32) {
      // K: lanes walk along a row (16-byte stores, conflict-free)
      const int r = i / V8, c = (i % V8) * 8;
      uint4 kv = zero;
      if (k0 + r < kv_valid)
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * sk.t + c);
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      // V: lanes walk along the keys, so the transposed stores of one
      // element index land on consecutive halves of shared memory
      const int rv = i % kBK, cv = (i / kBK) * 8;
      uint4 vv = zero;
      if (k0 + rv < kv_valid)
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + rv) * sv.t + cv);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(cv + e) * LDV + rv] = ve[e];
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t4;
        mma16816(s[nt], qf[ks], ld32(kr), ld32(kr + 8));
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + e;
        const float x0 = SCALE ? s[nt][e] * sm_scale : s[nt][e];
        const float x1 = SCALE ? s[nt][2 + e] * sm_scale : s[nt][2 + e];
        s[nt][e] = col < kv_valid && (!CAUSAL || col <= qa) ? x0 : -INFINITY;
        s[nt][2 + e] = col < kv_valid && (!CAUSAL || col <= qc) ? x1 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every chunk holds key k0 < kv_valid (and, causal, k0 <= q0 <= both
    // rows), so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expo(m0 - mn0, flags), a1 = expo(m1 - mn1, flags);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = prob(s[nt][0] - mn0, flags);
      s[nt][1] = prob(s[nt][1] - mn0, flags);
      s[nt][2] = prob(s[nt][2] - mn1, flags);
      s[nt][3] = prob(s[nt][3] - mn1, flags);
      if (sum16) {
        ls0 += round_bf16(s[nt][0]) + round_bf16(s[nt][1]);
        ls1 += round_bf16(s[nt][2]) + round_bf16(s[nt][3]);
      } else {
        ls0 += s[nt][0] + s[nt][1];
        ls1 += s[nt][2] + s[nt][3];
      }
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= a0;
      acc[nd][1] *= a0;
      acc[nd][2] *= a1;
      acc[nd][3] *= a1;
    }

#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vr = Vt + (nd * 8 + g) * LDV + j * 16 + 2 * t4;
        mma16816(acc[nd], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t4;
    if (qa < Tq)
      *reinterpret_cast<uint32_t*>(ob + qa * so.t + col) =
          pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (qc < Tq)
      *reinterpret_cast<uint32_t*>(ob + qc * so.t + col) =
          pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

constexpr int kRowsF32 = 128;   // float32: query rows (threads) per block
constexpr int kKeysF32 = 32;    // float32: keys per chunk

template <int D, bool OPTS>
__global__ void __launch_bounds__(kRowsF32)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, Strides sq,
                Strides sk, Strides sv, Strides so, int group, int Tq,
                int kv_valid, float sm_scale, int opt_flags) {
  const int flags = OPTS ? opt_flags : 0;
  constexpr int D4 = D / 4;
  __shared__ float4 Ks[kKeysF32][D4];
  __shared__ float4 Vs[kKeysF32][D4];
  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int qi = blockIdx.x * kRowsF32 + tid;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Tq)
      x = *reinterpret_cast<const float4*>(q + b * sq.b + h * sq.h + qi * sq.t + 4 * c);
    qr[4 * c] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < kv_valid; k0 += kKeysF32) {
    __syncthreads();
    for (int i = tid; i < kKeysF32 * D4; i += kRowsF32) {
      const int r = i / D4, c = i % D4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < kv_valid) {
        kk = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.t + 4 * c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.t + 4 * c);
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();

    float s[kKeysF32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 kk = Ks[j][c];
        d = fmaf(qr[4 * c], kk.x, d);
        d = fmaf(qr[4 * c + 1], kk.y, d);
        d = fmaf(qr[4 * c + 2], kk.z, d);
        d = fmaf(qr[4 * c + 3], kk.w, d);
      }
      s[j] = k0 + j < kv_valid ? (OPTS ? d * sm_scale : d) : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);   // finite: key k0 is valid
    const float alpha = expo(m - mn, flags);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      const float p = prob(s[j] - mn, flags);
      l += p;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 vv = Vs[j][c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
  }

  if (qi >= Tq) return;
  const float inv = l == 0.f ? 1.f : 1.f / l;
  float* orow = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
  for (int c = 0; c < D4; ++c)
    *reinterpret_cast<float4*>(orow + 4 * c) =
        make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                    acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

constexpr int kRowsC = 64;    // causal float32: query rows per block

// With causal = 0 the mask and the tile skip are off: the non-causal float32
// kernel for d = 128, whose q and accumulator would not fit one thread.

template <int D, bool OPTS>
__global__ void __launch_bounds__(2 * kRowsC)
attn_f32_causal_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int group, int Tq, int kv_valid, float sm_scale, int opt_causal,
                       int opt_flags) {
  const int causal = OPTS ? opt_causal : 1, flags = OPTS ? opt_flags : 0;
  constexpr int D4 = D / 4;       // float4s per row
  constexpr int H4 = D4 / 2;      // float4s this thread owns: 2 * j + half
  // keys per chunk: the scores of a chunk stay in registers beside q and
  // the accumulator (2 * H4 float4s), so wider heads take shorter chunks
  constexpr int kKeysC = 2048 / D;
  __shared__ float4 Ks[kKeysC][D4];
  __shared__ float4 Vs[kKeysC][D4];
  const int tid = threadIdx.x, half = tid & 1;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int q0 = blockIdx.x * kRowsC, qi = q0 + (tid >> 1);
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  float4 qr[H4], acc[H4];
#pragma unroll
  for (int j = 0; j < H4; ++j) {
    qr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Tq)
      qr[j] = *reinterpret_cast<const float4*>(
          q + b * sq.b + h * sq.h + qi * sq.t + 4 * (2 * j + half));
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  // tile skip: keys past the block's last query row are never visible
  const int k_end = causal ? min(kv_valid, q0 + kRowsC) : kv_valid;
  for (int k0 = 0; k0 < k_end; k0 += kKeysC) {
    __syncthreads();
    for (int i = tid; i < kKeysC * D4; i += 2 * kRowsC) {
      const int r = i / D4, c = i % D4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < k_end) {
        kk = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.t + 4 * c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.t + 4 * c);
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();

    float s[kKeysC];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysC; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < H4; ++c) {
        const float4 kk = Ks[j][2 * c + half];
        d = fmaf(qr[c].x, kk.x, d);
        d = fmaf(qr[c].y, kk.y, d);
        d = fmaf(qr[c].z, kk.z, d);
        d = fmaf(qr[c].w, kk.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      const int col = k0 + j;
      s[j] = col < kv_valid && (!causal || col <= qi) ? d * sm_scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    // key 0 is visible to every row and comes first, so m is finite from
    // the first chunk on and a chunk with no visible key leaves it alone
    const float mn = fmaxf(m, mx);
    const float alpha = expo(m - mn, flags);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < H4; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeysC; ++j) {
      const float p = prob(s[j] - mn, flags);
      l += p;
#pragma unroll
      for (int c = 0; c < H4; ++c) {
        const float4 vv = Vs[j][2 * c + half];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
  }

  if (qi >= Tq) return;
  const float inv = l == 0.f ? 1.f : 1.f / l;
  float* orow = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
  for (int c = 0; c < H4; ++c)
    *reinterpret_cast<float4*>(orow + 4 * (2 * c + half)) =
        make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
}

template <int D, bool CAUSAL>
void launch_bf16(const void* q, const void* k, const void* v, void* o,
                 Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                 int group, int Tq, int kv_valid, float sm_scale, int flags,
                 cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D>();
  const bool opts = flags != 0 || (!CAUSAL && sm_scale != 1.f);
  auto kernel = opts ? attn_bf16_kernel<D, CAUSAL, true> : attn_bf16_kernel<D, CAUSAL, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, sv, so, group, Tq, kv_valid, sm_scale, flags);
}

template <int D>
void launch_f32_causal(const void* q, const void* k, const void* v, void* o,
                       Strides sq, Strides sk, Strides sv, Strides so, int B,
                       int H, int group, int Tq, int kv_valid, float sm_scale,
                       int causal, int flags, cudaStream_t stream) {
  const dim3 grid((Tq + kRowsC - 1) / kRowsC, H, B);
  auto kernel = flags != 0 || !causal ? attn_f32_causal_kernel<D, true>
                                      : attn_f32_causal_kernel<D, false>;
  kernel<<<grid, 2 * kRowsC, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      group, Tq, kv_valid, sm_scale, causal, flags);
}

}  // namespace

// q: (B, H, Tq, d), k/v: (B, Hkv, Tk, d), o: (B, H, Tq, d), each addressed by
// its (batch, head, token) strides in elements with a unit stride along d.
// bf16 and float32 take d = 64 or 128. 1 <= kv_valid <= Tk. sm_scale
// multiplies the float32 scores; flags: kExp2 | kPexp16 | kLite.
// Returns cudaGetLastError() after the launch.
extern "C" int qa_attention_single(
    const void* q, const void* k, const void* v, void* o,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost,
    int B, int H, int Hkv, int Tq, int kv_valid, int d, int is_bf16,
    float sm_scale, int flags, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || kv_valid < 1 ||
      (flags & ~(kExp2 | kPexp16 | kLite)))
    return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst},
      so{osb, osh, ost};
  const int group = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && d == 64) {
    launch_bf16<64, false>(q, k, v, o, sq, sk, sv, so, B, H, group, Tq, kv_valid,
                           sm_scale, flags, st);
  } else if (is_bf16 && d == 128) {
    launch_bf16<128, false>(q, k, v, o, sq, sk, sv, so, B, H, group, Tq, kv_valid,
                            sm_scale, flags, st);
  } else if (!is_bf16 && d == 64) {
    const dim3 grid((Tq + kRowsF32 - 1) / kRowsF32, H, B);
    auto kernel = flags != 0 || sm_scale != 1.f ? attn_f32_kernel<64, true>
                                                : attn_f32_kernel<64, false>;
    kernel<<<grid, kRowsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
        group, Tq, kv_valid, sm_scale, flags);
  } else if (!is_bf16 && d == 128) {
    launch_f32_causal<128>(q, k, v, o, sq, sk, sv, so, B, H, group, Tq, kv_valid,
                           sm_scale, 0, flags, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Causal prefill. q: (B, H, T, d), k/v: (B, Hkv, T, d), o: (B, H, T, d), each
// addressed by its (batch, head, token) strides in elements with a unit
// stride along d; key j is visible to query i iff j <= i and j < kv_valid.
// bf16 and float32 take d = 128 (the decoder's head dim). 1 <= kv_valid <= T.
// flags: kExp2. Returns cudaGetLastError() after the launch.
extern "C" int qa_attention_causal(
    const void* q, const void* k, const void* v, void* o,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost,
    int B, int H, int Hkv, int T, int kv_valid, int d, int is_bf16,
    float sm_scale, int flags, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || T < 1 || kv_valid < 1 || kv_valid > T ||
      d != 128 || (flags & ~kExp2))
    return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst},
      so{osb, osh, ost};
  const int group = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch_bf16<128, true>(q, k, v, o, sq, sk, sv, so, B, H, group, T, kv_valid, sm_scale,
                           flags, st);
  } else {
    launch_f32_causal<128>(q, k, v, o, sq, sk, sv, so, B, H, group, T, kv_valid, sm_scale,
                           1, flags, st);
  }
  return (int)cudaGetLastError();
}
