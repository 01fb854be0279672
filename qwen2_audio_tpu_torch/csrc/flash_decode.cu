// Decode-step attention over the KV cache for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel qwen2_audio_tpu/ops/flash_decode.py::_decode_kernel
// at both of its pallas_call sites: flash_decode (bf16 or float32 cache) and
// flash_decode_quant (int8 cache with float32 per-vector scales). One query
// per stream and query head: o[b, h] = softmax(sm_scale * q[b, h] . K^T) V
// over cache rows 0..pos[b] of KV head h / g, scores and the P V sum in
// float32, K and V converted to q's type before use, the int8 K scales
// multiplied into the scores and the V scales into p, p cast to q's type
// before P V, the l == 0 -> 1 guard, output in q's type.
//
// What bounds it: bytes. Every valid cache row is read once per KV head:
// 2 * d * (element size) bytes of K and V, 512 bytes per position for a bf16
// cache at d = 128 (2 KB over the 4 KV heads of the 7B decoder), so about
// 0.5 us per layer at pos = 780 at 3.35 TB/s. The arithmetic is small
// (4 * g * d FLOP per position and head).
//
// Design: the TPU kernel walked the cache in 512-row tiles whose index map
// was clamped at the last valid tile, and zeroed the V rows past pos so that
// stale bits could not reach the P V product (0 * NaN). Here one block of
// 8 warps takes one (stream, KV head) and holds its g <= 8 query rows (padded
// to 8) in shared memory, so each K/V row is read once for the whole group.
// Keys stream through shared memory in chunks of 64 with cp.async, two
// chunks in flight; a row past pos[b] is never read: its copy is issued with
// a source size of 0, which fills the shared row with zeros instead. Per
// chunk: (1) scores: four lanes per key, each lane dotting 32 of the d
// elements against all 8 query rows and two shuffles summing them; (2) the
// online softmax of row r in warp r; (3) P V: each warp accumulates 8 keys of
// the chunk for all 8 rows (each lane 4 of the d elements), and the 8
// partial sums meet in shared memory at the end. Float32 FMA throughout, for
// every combination of q type (bf16, float32) and cache type (bf16, float32,
// int8). Shared rows are padded by 64 bytes so that the two keys a quarter
// warp reads in the score pass fall on different banks.
// With one block per (stream, KV head), a batch of 1 occupies only 4 of the
// 132 SMs: splitting the keys across blocks (split-K) and tensor-core
// products are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;              // head dim
constexpr int kG = 8;                // query rows per block (g padded to 8)
constexpr int kCH = 64;              // keys per chunk
constexpr int kWarps = 8;            // kWarps * 8 == kCH, kWarps == kG
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// round a float32 value to the query type, as the TPU kernel's astype does
template <typename QT>
__device__ __forceinline__ float round_q(float x) {
  if constexpr (sizeof(QT) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

template <typename QT>
__device__ __forceinline__ QT from_f(float x) {
  if constexpr (sizeof(QT) == 2) return __float2bfloat16_rn(x);
  else return x;
}

// 16 bytes of shared memory as floats
template <typename KT>
__device__ __forceinline__ void load16(const unsigned char* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const KT* e = reinterpret_cast<const KT*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(KT); ++i) f[i] = to_f(e[i]);
}

// 4 elements of shared memory as floats
template <typename KT>
__device__ __forceinline__ void load4(const unsigned char* src, float (&f)[4]) {
  if constexpr (sizeof(KT) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else if constexpr (sizeof(KT) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = to_f(e[i]);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = to_f(e[i]);
  }
}

// global -> shared copies; ok == false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename KT>
__host__ __device__ constexpr int row_bytes() { return kD * (int)sizeof(KT) + 64; }   // padded

template <typename KT>
__host__ __device__ constexpr int stage_bytes() { return 2 * kCH * row_bytes<KT>() + 2 * kCH * 4; }

template <typename KT>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * stage_bytes<KT>() + (kG * kD + kCH * kG + 2 * kG) * 4;
}

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              QT* __restrict__ o, int S, int Hkv, int G, float sm_scale) {
  constexpr int RS = row_bytes<KT>();
  constexpr int VPR = kD * (int)sizeof(KT) / 16;   // 16-byte vectors per row
  constexpr int VEC = 16 / (int)sizeof(KT);        // elements per vector
  constexpr int NV = VPR / 4;                      // vectors per lane, score pass
  constexpr int STAGE = stage_bytes<KT>();
  static_assert(kWarps * 8 == kCH && kWarps == kG, "one key group per warp");
  static_assert(kWarps * kG * kD * 4 <= 2 * STAGE, "reduction fits the stages");

  extern __shared__ float4 smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(base + 2 * STAGE);   // [kG][kD]
  float* Ps = Qs + kG * kD;                                  // [kCH][kG]
  float* As = Ps + kCH * kG;                                 // [kG] rescale
  float* Ls = As + kG;                                       // [kG] row sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n = min(pos[b] + 1, S);                // visible cache rows
  const int n_chunks = (max(n, 0) + kCH - 1) / kCH;
  const size_t row_el = (size_t)Hkv * kD;          // elements between rows
  const KT* kb = k + (size_t)b * S * row_el + (size_t)hk * kD;
  const KT* vb = v + (size_t)b * S * row_el + (size_t)hk * kD;
  const float* ksb = QUANT ? ks + (size_t)b * S * Hkv + hk : nullptr;
  const float* vsb = QUANT ? vs + (size_t)b * S * Hkv + hk : nullptr;

  for (int i = tid; i < kG * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    Qs[i] = r < G ? to_f(q[((size_t)b * Hkv * G + (size_t)hk * G + r) * kD + c]) : 0.f;
  }

  auto load_chunk = [&](int c) {
    unsigned char* st = base + (c & 1) * STAGE;
    const int k0 = c * kCH;
    for (int i = tid; i < kCH * VPR; i += kThreads) {
      const int r = i / VPR, cv = i % VPR;
      const bool ok = k0 + r < n;
      const size_t off = ok ? (size_t)(k0 + r) * row_el : 0;
      cp_async16(st + r * RS + cv * 16,
                 reinterpret_cast<const unsigned char*>(kb + off) + cv * 16, ok);
      cp_async16(st + (kCH + r) * RS + cv * 16,
                 reinterpret_cast<const unsigned char*>(vb + off) + cv * 16, ok);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(st + 2 * kCH * RS);
      for (int r = tid; r < kCH; r += kThreads) {
        const bool ok = k0 + r < n;
        const size_t off = ok ? (size_t)(k0 + r) * Hkv : 0;
        cp_async4(sc + r, ksb + off, ok);
        cp_async4(sc + kCH + r, vsb + off, ok);
      }
    }
    cp_async_commit();
  };

  float m_run = -INFINITY, l_run = 0.f;   // softmax state of row `warp`
  float acc[kG][4];
#pragma unroll
  for (int r = 0; r < kG; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  if (n_chunks > 0) load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();   // the stage refilled next is no longer read; Qs written
    if (c + 1 < n_chunks) load_chunk(c + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // chunk c has landed
    const unsigned char* Kst = base + (c & 1) * STAGE;
    const unsigned char* Vst = Kst + kCH * RS;
    const float* KSs = reinterpret_cast<const float*>(Kst + 2 * kCH * RS);
    const float* VSs = KSs + kCH;
    const int k0 = c * kCH;

    // (1) scores: warp w takes keys 8w..8w+7 of the chunk, four lanes a key
    {
      const int kr = warp * 8 + (lane >> 2), l4 = lane & 3;
      float dot[kG];
#pragma unroll
      for (int r = 0; r < kG; ++r) dot[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v16 = l4 + 4 * j;   // vector index within the row
        float kf[VEC];
        load16<KT>(Kst + kr * RS + v16 * 16, kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = round_q<QT>(kf[e]);
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const float* qr = Qs + r * kD + v16 * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + e);
            dot[r] = fmaf(qq.x, kf[e], dot[r]);
            dot[r] = fmaf(qq.y, kf[e + 1], dot[r]);
            dot[r] = fmaf(qq.z, kf[e + 2], dot[r]);
            dot[r] = fmaf(qq.w, kf[e + 3], dot[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
      }
      if (l4 == 0) {
        const bool ok = k0 + kr < n;
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          float s = dot[r] * sm_scale;
          if constexpr (QUANT) s *= KSs[kr];
          Ps[kr * kG + r] = ok ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // (2) online softmax: warp r owns query row r; key k0 < n is visible,
    // so the new maximum is finite
    {
      const int r = warp;
      const float s0 = Ps[lane * kG + r], s1 = Ps[(lane + 32) * kG + r];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_run, mx);
      const float alpha = expf(m_run - mn);
      float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run = l_run * alpha + ps;
      m_run = mn;
      if constexpr (QUANT) {   // fold the V scales in (zero past pos)
        p0 *= VSs[lane];
        p1 *= VSs[lane + 32];
      }
      Ps[lane * kG + r] = round_q<QT>(p0);
      Ps[(lane + 32) * kG + r] = round_q<QT>(p1);
      if (lane == 0) As[r] = alpha;
    }
    __syncthreads();

    // (3) P V: warp w takes keys 8w..8w+7, lane owns d elements 4*lane..+3
#pragma unroll
    for (int r = 0; r < kG; ++r) {
      const float a = As[r];
      acc[r][0] *= a; acc[r][1] *= a; acc[r][2] *= a; acc[r][3] *= a;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kr = warp * 8 + j;
      float vf[4];
      load4<KT>(Vst + kr * RS + lane * 4 * (int)sizeof(KT), vf);
#pragma unroll
      for (int e = 0; e < 4; ++e) vf[e] = round_q<QT>(vf[e]);
      const float4 plo = *reinterpret_cast<const float4*>(Ps + kr * kG);
      const float4 phi = *reinterpret_cast<const float4*>(Ps + kr * kG + 4);
      const float pr[kG] = {plo.x, plo.y, plo.z, plo.w, phi.x, phi.y, phi.z, phi.w};
#pragma unroll
      for (int r = 0; r < kG; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();   // every copy landed and every chunk was read
  if (lane == 0) Ls[warp] = l_run;
  float* Red = reinterpret_cast<float*>(base);   // [kWarps][kG][kD], over the stages
#pragma unroll
  for (int r = 0; r < kG; ++r)
    *reinterpret_cast<float4*>(Red + (warp * kG + r) * kD + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < G * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += Red[(w * kG + r) * kD + c];
    const float l = Ls[r];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    o[((size_t)b * Hkv * G + (size_t)hk * G + r) * kD + c] = from_f<QT>(s * inv);
  }
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* o, int B, int S, int Hkv,
           int G, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<KT>();
  auto kern = decode_kernel<QT, KT, QUANT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<QT*>(o), S, Hkv, G, sm_scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_type, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* pos, void* o,
                int B, int S, int Hkv, int G, float sm_scale, cudaStream_t st) {
  switch (kv_type) {
    case 0: return launch<QT, float, false>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, st);
    case 1: return launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, st);
    case 2: return launch<QT, int8_t, true>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Hkv * G, d) in q_type (0 float32, 1 bf16); k, v: the cache of one
// layer, (B, S, Hkv, d) contiguous, in kv_type (0 float32, 1 bf16, 2 int8
// with ks, vs: (B, S, Hkv) float32 scales; ks and vs are ignored otherwise);
// pos: (B,) int32 on the device, the query's position (rows 0..pos[b] are
// visible); o: (B, Hkv * G, d) in q_type. d = 128, 1 <= G <= 8. Pointers 16-
// byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int qa_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* pos,
                               void* o, int B, int S, int Hkv, int G, int d,
                               int q_type, int kv_type, float sm_scale,
                               void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > kG || d != kD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_type == 0)
    return dispatch_kv<float>(kv_type, q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, st);
  if (q_type == 1)
    return dispatch_kv<__nv_bfloat16>(kv_type, q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
