// Decode-step attention over the KV cache, and the int8 cache's quantize-
// and-write, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel qwen2_audio_tpu/ops/flash_decode.py::_decode_kernel
// (qa_flash_decode) at both of its pallas_call sites: flash_decode (bf16 or
// float32 cache) and flash_decode_quant (int8 cache with float32 per-vector
// scales). One query per stream and query head:
// o[b, h] = softmax(sm_scale * q[b, h] . K^T) V over cache rows 0..pos[b] of KV head h / g, scores and the P V sum in
// float32, K and V converted to q's type before use, the int8 K scales
// multiplied into the scores and the V scales into p, p cast to q's type
// before P V, the l == 0 -> 1 guard, output in q's type.
//
// What bounds it: bytes, and below a few microseconds the latency of
// reaching them. Every valid cache row is read once per KV head: 2 * d *
// (element size) bytes of K and V, 512 bytes per position for a bf16 cache
// at d = 128 (2 KB over the 4 KV heads of the 7B decoder), 1.6 MB at pos
// 783, about 0.5 us at 3.35 TB/s. The arithmetic is 4 * g * d FLOP per
// position and head, about 3.5 FLOP per cache byte: at g = 7 query rows a
// wgmma would fill 7 of its 64 rows (mma.sync 7 of 16), so the products stay
// float32 FMA.
//
// Design (split-KV): a thread-block cluster of `splits` CTAs (at most 16, a
// non-portable cluster size above 8) takes one (stream, KV head). Each CTA
// reads pos[b] itself and takes the rows [j * c, min(n, (j + 1) * c)) of
// n = min(pos[b] + 1, S), c = ceil(n / splits) rounded up to whole 64-row
// stages (kGranule), so at every position the longest split is as short
// as any partition into stages makes it, no row past pos[b] is read, a stream of at most 64 rows stays
// in one split (p rounded against its true maximum, as the plain version),
// and nothing about pos reaches the host (a captured graph replays with pos
// changed in place). The split count, the stage count and so the shared
// memory are the launch plan's (ops/flash_decode.py::decode_plan), from the
// shapes alone. A CTA issues cp.async copies for its whole range at once,
// one 64-row chunk per stage, each stage completing on an mbarrier, so it
// waits one DRAM round trip rather than one per chunk; a range longer than
// the stages loops over them as a ring (3 to 13 stages by cache type); q's
// loads are issued before pos is read. Per chunk, one block barrier: (1)
// scores: warp w takes keys 8w..8w+7, eight lanes a pair of keys, each lane
// dotting 16 of the d elements of both keys against all 8 query rows (g
// padded to 8; each q value read from shared memory serves two keys, the
// reads' bound), a reduce-scatter of 14 shuffles summing them, then each
// row's maximum over the warp's keys into the chunk's row maxima by an
// atomic max (order-free); the barrier; (2) p
// against the split's running maximum, the V scales folded in, p rounded to
// q's type into shared memory for the warp's own keys, the warp's row sums
// kept per warp; (3) P V: each warp accumulates its 8 keys for all 8 rows
// (each lane 4 of the d elements). The CTA's partial (m, l and the
// un-normalised sum, per row) is pushed through distributed shared memory:
// each CTA of the cluster owns an equal slice of the outputs and receives
// every split's sums of that slice, with every split's row maxima and sums;
// after one cluster barrier each CTA merges its slice from its own shared
// memory: M = max m_j, L = sum l_j e^(m_j - M), O = sum acc_j e^(m_j - M) /
// L, a split with no rows (m = -inf, l = 0, acc = 0) weighing 0. One launch,
// no workspace, and no CTA reads another's shared memory, so none waits for
// the others before it leaves.
//
// qa_kv_append_quant replaces the JAX package's _quantize_kv and the int8
// cache's update (qwen2_audio_tpu/models/qwen2_decoder.py:105-111, :488-493):
// one warp per (stream, position, KV head) vector of K or V takes its amax
// over d, s = amax / 127 and inv = 1 / s by IEEE division (0 where s is 0),
// q = rint(x * inv) (ties to even), and writes q and s at row pos[b] + t of
// the cache, bit-equal to the CPU's. One launch per layer and forward where
// the plain route took about a dozen elementwise ops per tensor and four
// indexed writes.

#include "hopper_mma.cuh"

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;              // head dim
constexpr int kG = 8;                // query rows per block (g padded to 8)
constexpr int kCH = 64;              // keys per chunk (one stage)
constexpr int kWarps = 8;            // kWarps * 8 == kCH: 8 keys a warp
constexpr int kThreads = kWarps * 32;
constexpr int kGranule = kCH;        // a split's rows start at a multiple of this
constexpr int kMaxSplits = 16;       // CTAs per cluster
constexpr int kMaxStages = 16;
static_assert(kMaxStages >= kMaxSplits, "the merge's weights reuse the chunks' maxima");
constexpr int kBarBytes = kMaxStages * 8;
constexpr int kSmemMax = 232448;     // a block's shared memory on sm_90
// q in shared memory with 4 floats of padding after every 32, so that the
// eight d-slices the lanes of a key pair read fall on distinct banks
constexpr int kQFloats = kG * kD / 32 * 36;
__host__ __device__ constexpr int qidx(int i) { return i + (i >> 5) * 4; }
// Qs, Ps [kCH][kG], Cmax [kMaxStages][kG], Lw [kWarps][kG], and what the
// cluster's CTAs push here: Rm, Rl [kMaxSplits][kG] (each split's row maxima
// and sums) and Rp (each split's P V sums of this CTA's slice of the
// outputs, at most kG * kD + kMaxSplits floats in all)
constexpr int kTailBytes = (kQFloats + kCH * kG + kMaxStages * kG + kWarps * kG +
                            2 * kMaxSplits * kG + kG * kD + kMaxSplits) * 4;
constexpr int kRedBytes = kWarps * kG * kD * 4;   // the warps' sums, over the stages

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// 4 int8 values (one 32-bit word) as floats, exactly and at the full
// arithmetic rate: each byte, its sign bit flipped, as the low mantissa of
// 2^23, less 2^23 + 128
__device__ __forceinline__ void s8x4_to_f(uint32_t u, float* f) {
  u ^= 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// 16 bytes of shared memory as floats
template <typename KT>
__device__ __forceinline__ void load16(const unsigned char* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(KT) == 1) {
    s8x4_to_f(u.x, f);
    s8x4_to_f(u.y, f + 4);
    s8x4_to_f(u.z, f + 8);
    s8x4_to_f(u.w, f + 12);
  } else {
    const KT* e = reinterpret_cast<const KT*>(&u);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(KT); ++i) f[i] = to_f(e[i]);
  }
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
    s8x4_to_f(*reinterpret_cast<const uint32_t*>(src), f);
  }
}

// 4 bytes global -> shared; ok == false reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(qa::smem_u32(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

// the cluster barrier, split: arrive (releasing this thread's writes to
// its own and the other CTAs' shared memory) and wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// x into the shared memory of CTA `rank` of the cluster, at the address p
// has in this CTA's
__device__ __forceinline__ void st_cluster(float* p, int rank, float x) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(qa::smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(x) : "memory");
}

// max of a shared float and x, by the integer order of the float's bits
// (x not NaN)
__device__ __forceinline__ void atomic_max(float* p, float x) {
  if (x >= 0.f) atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
  else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
}

// a shared row: a quarter warp reads 128 contiguous bytes of one key in the
// score pass and a warp a contiguous span of one in P V, so none is padded
template <typename KT>
__host__ __device__ constexpr int row_bytes() { return kD * (int)sizeof(KT); }

template <typename KT, bool QUANT>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kCH * row_bytes<KT>() + (QUANT ? 2 * kCH * 4 : 0);
}

template <typename KT, bool QUANT>
constexpr int max_stages() {
  const int n = (kSmemMax - kBarBytes - kTailBytes) / stage_bytes<KT, QUANT>();
  return n < kMaxStages ? n : kMaxStages;
}

template <typename KT, bool QUANT>
constexpr int smem_bytes(int stages) {
  return kBarBytes + stages * stage_bytes<KT, QUANT>() + kTailBytes;
}

// one CTA an SM (its shared memory sees to that), so all 255 registers
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads, 1)
split_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    QT* __restrict__ o, int S, int Hkv, int G, float sm_scale, int stages) {
  constexpr int RS = row_bytes<KT>();
  constexpr int VPR = kD * (int)sizeof(KT) / 16;   // 16-byte vectors per row
  constexpr int VEC = 16 / (int)sizeof(KT);        // elements per vector
  constexpr int STAGE = stage_bytes<KT, QUANT>();
  constexpr int NR = kG / 4;                       // rows a lane keeps after the dots
  // K and V reach q's type exactly except float32 into bf16
  constexpr bool kRoundKV = sizeof(KT) == 4 && sizeof(QT) == 2;
  static_assert(kWarps * 8 == kCH, "one key group per warp");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage0 = smem + kBarBytes;
  float* Qs = reinterpret_cast<float*>(stage0 + stages * STAGE);   // [kG][kD], qidx
  float* Ps = Qs + kQFloats;                                       // [kCH][kG] p
  float* Cmax = Ps + kCH * kG;                                     // [kMaxStages][kG]
  float* Lw = Cmax + kMaxStages * kG;                              // [kWarps][kG]
  float* Rm = Lw + kWarps * kG;                                    // [kMaxSplits][kG]
  float* Rl = Rm + kMaxSplits * kG;                                // [kMaxSplits][kG]
  float* Rp = Rl + kMaxSplits * kG;                                // [splits][per]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int splits = gridDim.x, j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (size_t)b * Hkv * G + (size_t)hk * G;   // the first query row, in q and o
  // every CTA of the cluster has started before any writes to another's
  // shared memory (the matching wait comes before the first such write)
  cluster_arrive_relaxed();

  // q first: its loads are in flight while pos is read and the copies issued
  float qreg[kG * kD / kThreads];
#pragma unroll
  for (int i = 0; i < kG * kD / kThreads; ++i) {
    const int e = tid + i * kThreads;
    qreg[i] = e / kD < G ? to_f(q[qrow * kD + e]) : 0.f;
  }

  const int pos_b = pos[b];   // in flight while the barriers are made
  if (tid < stages) qa::mbar_init(&bars[tid], kThreads);
  for (int i = tid; i < kMaxStages * kG; i += kThreads) Cmax[i] = -INFINITY;
  qa::mbar_fence_init();
  __syncthreads();   // the barriers exist before any copy arrives on them

  // this split's rows [r0, r1) of the n visible ones
  const int n = max(0, min(pos_b + 1, S));
  const int c = ((n + splits - 1) / splits + kGranule - 1) / kGranule * kGranule;
  const int r0 = min(n, j * c), r1 = min(n, r0 + c);
  const int n_chunks = (r1 - r0 + kCH - 1) / kCH;

  const size_t row_el = (size_t)Hkv * kD;          // elements between rows
  const KT* kb = k + (size_t)b * S * row_el + (size_t)hk * kD;
  const KT* vb = v + (size_t)b * S * row_el + (size_t)hk * kD;
  const float* ksb = QUANT ? ks + (size_t)b * S * Hkv + hk : nullptr;
  const float* vsb = QUANT ? vs + (size_t)b * S * Hkv + hk : nullptr;

  // chunk ci of the range into stage ci % stages; every thread arrives once
  auto load_chunk = [&](int ci) {
    unsigned char* st = stage0 + (ci % stages) * STAGE;
    const int k0 = r0 + ci * kCH;
    for (int i = tid; i < kCH * VPR; i += kThreads) {
      const int r = i / VPR, cv = i % VPR;
      const bool ok = k0 + r < r1;
      const size_t off = ok ? (size_t)(k0 + r) * row_el : 0;
      qa::cp_async16(st + r * RS + cv * 16,
                     reinterpret_cast<const unsigned char*>(kb + off) + cv * 16, ok);
      qa::cp_async16(st + (kCH + r) * RS + cv * 16,
                     reinterpret_cast<const unsigned char*>(vb + off) + cv * 16, ok);
    }
    if constexpr (QUANT) {   // the scales travel with their rows
      float* sc = reinterpret_cast<float*>(st + 2 * kCH * RS);
      for (int r = tid; r < kCH; r += kThreads) {
        const bool ok = k0 + r < r1;
        const size_t off = ok ? (size_t)(k0 + r) * Hkv : 0;
        cp_async4(sc + r, ksb + off, ok);
        cp_async4(sc + kCH + r, vsb + off, ok);
      }
    }
    qa::cp_async_arrive(&bars[ci % stages]);
  };

  const int first = min(n_chunks, stages);
  for (int ci = 0; ci < first; ++ci) load_chunk(ci);   // the whole range, or a full ring
#pragma unroll
  for (int i = 0; i < kG * kD / kThreads; ++i) Qs[qidx(tid + i * kThreads)] = qreg[i];
  __syncthreads();   // Qs written

  // the score pass's lanes: warp w takes keys 8w..8w+7 of the chunk, eight
  // lanes (d8) a pair of keys key0 and key0 + 4, each lane 16 of the d
  // elements of both; after it, the lane keeps key kr's rows rq * NR + i
  const int d8 = lane & 7, b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1, b0 = lane & 1;
  const int key0 = warp * 8 + (lane >> 3), kr = key0 + 4 * b2, rq = lane & 3;
  float m_run[kG];               // the split's running row maxima (every warp alike)
  float lsum[NR];               // the kept rows: this warp's keys' running sums
  float acc[kG][4];              // P V: lane owns d elements 4*lane..+3 of every row
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    m_run[r] = -INFINITY;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) lsum[i] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci % stages;
    qa::mbar_wait(&bars[st], (ci / stages) & 1);   // chunk ci has landed
    const unsigned char* Kst = stage0 + st * STAGE;
    const unsigned char* Vst = Kst + kCH * RS;
    const float* KSs = reinterpret_cast<const float*>(Kst + 2 * kCH * RS);
    const float* VSs = KSs + kCH;
    float* cmax = Cmax + st * kG;

    // (1) scores, and each row's maximum over the chunk: the warp's over its
    // 8 keys, then an atomic max (order-free) into the chunk's row maxima
    float sk[NR];
    {
      float dot[2][kG];   // keys key0 and key0 + 4
#pragma unroll
      for (int r = 0; r < kG; ++r) dot[0][r] = dot[1][r] = 0.f;
#pragma unroll
      for (int jv = 0; jv < 16 / VEC; ++jv) {
        const int v16 = d8 + 8 * jv;   // vector index within the row
        float k0[VEC], k1[VEC];
        load16<KT>(Kst + key0 * RS + v16 * 16, k0);
        load16<KT>(Kst + (key0 + 4) * RS + v16 * 16, k1);
        if constexpr (kRoundKV) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            k0[e] = round_q<QT>(k0[e]);
            k1[e] = round_q<QT>(k1[e]);
          }
        }
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const float* qr = Qs + qidx(r * kD + v16 * VEC);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + e);
            dot[0][r] = fmaf(qq.x, k0[e], dot[0][r]);
            dot[0][r] = fmaf(qq.y, k0[e + 1], dot[0][r]);
            dot[0][r] = fmaf(qq.z, k0[e + 2], dot[0][r]);
            dot[0][r] = fmaf(qq.w, k0[e + 3], dot[0][r]);
            dot[1][r] = fmaf(qq.x, k1[e], dot[1][r]);
            dot[1][r] = fmaf(qq.y, k1[e + 1], dot[1][r]);
            dot[1][r] = fmaf(qq.z, k1[e + 2], dot[1][r]);
            dot[1][r] = fmaf(qq.w, k1[e + 3], dot[1][r]);
          }
        }
      }
      // the 16 sums over the key pair's 8 lanes, scattered: each lane ends
      // with key kr's rows 2 * rq, 2 * rq + 1 (lane bits 2, 1, 0 pick the
      // key, the half of the rows, the pair of rows)
      float w[kG], x[4];
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        const float send = b2 ? dot[0][r] : dot[1][r];
        w[r] = (b2 ? dot[1][r] : dot[0][r]) + __shfl_xor_sync(0xffffffffu, send, 4);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float send = b1 ? w[t] : w[4 + t];
        x[t] = (b1 ? w[4 + t] : w[t]) + __shfl_xor_sync(0xffffffffu, send, 2);
      }
      const bool ok = r0 + ci * kCH + kr < r1;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float send = b0 ? x[i] : x[2 + i];
        float sc = ((b0 ? x[2 + i] : x[i]) + __shfl_xor_sync(0xffffffffu, send, 1)) * sm_scale;
        if constexpr (QUANT) sc *= KSs[kr];
        sk[i] = ok ? sc : -INFINITY;
        float mx = sk[i];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane < 4) atomic_max(cmax + rq * NR + i, mx);   // lanes 0-3: the warp's maxima
      }
    }
    __syncthreads();   // the chunk's row maxima are complete

    // (2) p against the split's running maximum, the V scales folded in,
    // p rounded to q's type into shared memory for the warp's own keys (so
    // only the warp waits for it); the warp's keys' sums of the kept rows
    float alpha[kG];
#pragma unroll
    for (int r = 0; r < kG; ++r) {
      const float mn = fmaxf(m_run[r], cmax[r]);
      alpha[r] = expf(m_run[r] - mn);
      m_run[r] = mn;
    }
    __syncwarp();   // the warp's reads of Ps for the last chunk are done
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float mn = m_run[i], a = alpha[i];
#pragma unroll
      for (int q4 = 1; q4 < 4; ++q4) {
        mn = rq == q4 ? m_run[q4 * NR + i] : mn;
        a = rq == q4 ? alpha[q4 * NR + i] : a;
      }
      float p = expf(sk[i] - mn);
      float sum = p;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lsum[i] = lsum[i] * a + sum;
      if constexpr (QUANT) p *= VSs[kr];   // zero past the range
      Ps[kr * kG + rq * NR + i] = round_q<QT>(p);
    }
    __syncwarp();

    // (3) P V over the warp's 8 keys
#pragma unroll
    for (int r = 0; r < kG; ++r) {
      acc[r][0] *= alpha[r]; acc[r][1] *= alpha[r];
      acc[r][2] *= alpha[r]; acc[r][3] *= alpha[r];
    }
#pragma unroll
    for (int jk = 0; jk < 8; ++jk) {
      const int key = warp * 8 + jk;
      float vf[4];
      load4<KT>(Vst + key * RS + lane * 4 * (int)sizeof(KT), vf);
      if constexpr (kRoundKV) {
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[e] = round_q<QT>(vf[e]);
      }
      float pr[kG];
#pragma unroll
      for (int r4 = 0; r4 < kG; r4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + key * kG + r4);
        pr[r4] = p4.x; pr[r4 + 1] = p4.y; pr[r4 + 2] = p4.z; pr[r4 + 3] = p4.w;
      }
#pragma unroll
      for (int r = 0; r < kG; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
    }
    if (ci + stages < n_chunks) {   // a ring: refill this stage
      __syncthreads();   // every warp is done with the stage and its maxima
      if (tid < kG) cmax[tid] = -INFINITY;
      load_chunk(ci + stages);
    }
  }

  // the split's partial: the warps' P V sums meet over the stages, each
  // output's pushed to the CTA whose slice of the outputs holds it, with
  // the row maxima and sums to every CTA
  __syncthreads();   // every warp is done with the stages
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < NR; ++i) Lw[warp * kG + rq * NR + i] = lsum[i];
  }
  float* Red = reinterpret_cast<float*>(stage0);   // [kWarps][kG][kD]
#pragma unroll
  for (int r = 0; r < kG; ++r)
    *reinterpret_cast<float4*>(Red + (warp * kG + r) * kD + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int per = (G * kD + splits - 1) / splits;   // outputs a CTA merges
  cluster_wait();   // every CTA of the cluster has started
  for (int e = tid; e < G * kD; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += Red[w * kG * kD + e];
    st_cluster(Rp + j * per + e % per, e / per, s);
  }
  if (tid < splits * kG) {
    const int r = tid % kG, to = tid / kG;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += Lw[w * kG + r];
    float m = m_run[0];
#pragma unroll
    for (int rr = 1; rr < kG; ++rr) m = r == rr ? m_run[rr] : m;
    st_cluster(Rm + j * kG + r, to, m);
    st_cluster(Rl + j * kG + r, to, l);
  }
  cluster_arrive();
  cluster_wait();   // every split's partial has arrived

  // the merge of this CTA's slice, from its own shared memory: first each
  // split's weight e^(m_j - M) a row (over the chunks' maxima, now unused)
  float* W = Cmax;   // [kG][kMaxSplits]
  if (tid < kG * splits) {
    const int r = tid / splits, sp = tid % splits;
    float M = -INFINITY;
    for (int i = 0; i < splits; ++i) M = fmaxf(M, Rm[i * kG + r]);
    const float m = Rm[sp * kG + r];
    W[r * kMaxSplits + sp] = m == -INFINITY ? 0.f : expf(m - M);   // no rows: weight 0
  }
  __syncthreads();
  for (int t = tid; t < per; t += kThreads) {
    const int e = j * per + t;
    if (e >= G * kD) break;
    const int r = e / kD;
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        L += Rl[sp * kG + r] * W[r * kMaxSplits + sp];
        O += Rp[sp * per + t] * W[r * kMaxSplits + sp];
      }
    }
    o[qrow * kD + e] = from_f<QT>(O * (L == 0.f ? 1.f : 1.f / L));
  }
}

// the decode kernel's attributes, once per device and instantiation: the
// most shared memory any stage count takes, and clusters of up to 16 CTAs
template <typename QT, typename KT, bool QUANT>
cudaError_t configure() {
  auto kern = split_decode_kernel<QT, KT, QUANT>;
  const int smem_max = smem_bytes<KT, QUANT>(max_stages<KT, QUANT>());
  static std::atomic<unsigned> configured{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured.fetch_or(1u << dev);
  }
  return cudaSuccess;
}

// a launch of (splits, Hkv, B) CTAs in clusters of splits; attr holds the
// cluster dimension
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int splits, int Hkv,
                                         int B, int smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* o, int B, int S, int Hkv,
           int G, float sm_scale, int splits, int stages, cudaStream_t stream) {
  if (stages < 1 || stages > max_stages<KT, QUANT>() ||
      stages * stage_bytes<KT, QUANT>() < kRedBytes)
    return (int)cudaErrorInvalidValue;
  auto kern = split_decode_kernel<QT, KT, QUANT>;
  cudaError_t err = configure<QT, KT, QUANT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, splits, Hkv, B,
                                                smem_bytes<KT, QUANT>(stages), stream);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const QT*>(q), static_cast<const KT*>(k),
                           static_cast<const KT*>(v), static_cast<const float*>(ks),
                           static_cast<const float*>(vs), static_cast<const int*>(pos),
                           static_cast<QT*>(o), S, Hkv, G, sm_scale, stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_type, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* pos, void* o,
                int B, int S, int Hkv, int G, float sm_scale, int splits, int stages,
                cudaStream_t st) {
  switch (kv_type) {
    case 0: return launch<QT, float, false>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, splits, stages, st);
    case 1: return launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, splits, stages, st);
    case 2: return launch<QT, int8_t, true>(q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, splits, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// one warp per vector of d = 128 elements: K vectors first, then V
template <typename XT>
__global__ void __launch_bounds__(kThreads)
kv_append_quant_kernel(const XT* __restrict__ k, const XT* __restrict__ v,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       int8_t* __restrict__ kq, float* __restrict__ kscale,
                       int8_t* __restrict__ vq, float* __restrict__ vscale,
                       const int* __restrict__ pos, int B, int T, int Hkv, int S) {
  const int lane = threadIdx.x & 31;
  const long long vec = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long per = (long long)B * T * Hkv;
  if (vec >= 2 * per) return;
  const bool is_v = vec >= per;
  const long long w = is_v ? vec - per : vec;
  const int h = (int)(w % Hkv), t = (int)((w / Hkv) % T), b = (int)(w / ((long long)Hkv * T));
  const int row = pos[b] + t;
  if (row < 0 || row >= S) return;   // past the capacity: dropped, as by a scatter
  const XT* x = is_v ? v + b * vsb + t * vst + h * vsh : k + b * ksb + t * kst + h * ksh;
  float f[4], amax = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[e] = to_f(x[lane * 4 + e]);
    amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(amax, 127.f);
  const float inv = s > 0.f ? __fdiv_rn(1.f, s) : 0.f;
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qi = (int)rintf(__fmul_rn(f[e], inv));
    packed |= (uint32_t)(uint8_t)(int8_t)qi << (8 * e);
  }
  const size_t slot = ((size_t)b * S + row) * Hkv + h;
  int8_t* dst = (is_v ? vq : kq) + slot * kD;
  reinterpret_cast<uint32_t*>(dst)[lane] = packed;
  if (lane == 0) (is_v ? vscale : kscale)[slot] = s;
}

template <typename XT>
int launch_append(const void* k, const void* v, long long ksb, long long kst, long long ksh,
                  long long vsb, long long vst, long long vsh, void* kq, void* kscale,
                  void* vq, void* vscale, const void* pos, int B, int T, int Hkv, int S,
                  cudaStream_t st) {
  const long long warps = 2LL * B * T * Hkv;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  kv_append_quant_kernel<XT><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const XT*>(k), static_cast<const XT*>(v), ksb, kst, ksh, vsb, vst, vsh,
      static_cast<int8_t*>(kq), static_cast<float*>(kscale), static_cast<int8_t*>(vq),
      static_cast<float*>(vscale), static_cast<const int*>(pos), B, T, Hkv, S);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hkv * G, d) in q_type (0 float32, 1 bf16); k, v: the cache of one
// layer, (B, S, Hkv, d) contiguous, in kv_type (0 float32, 1 bf16, 2 int8
// with ks, vs: (B, S, Hkv) float32 scales; ks and vs are ignored otherwise);
// pos: (B,) int32 on the device, the query's position (rows 0..pos[b] are
// visible); o: (B, Hkv * G, d) in q_type. d = 128, 1 <= G <= 8; splits (the
// cluster size, 1..16) and stages (64-row stages of shared memory) from the
// launch plan. Pointers 16-byte aligned, ks and vs 4-byte (read a float at
// a time). Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int qa_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* pos,
                               void* o, int B, int S, int Hkv, int G, int d,
                               int q_type, int kv_type, float sm_scale, int splits,
                               int stages, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > kG || d != kD || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_type == 0)
    return dispatch_kv<float>(kv_type, q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, splits, stages, st);
  if (q_type == 1)
    return dispatch_kv<__nv_bfloat16>(kv_type, q, k, v, ks, vs, pos, o, B, S, Hkv, G, sm_scale, splits, stages, st);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `splits` CTAs of the bf16-cache kernel (bf16 q) with
// `stages` stages the device can hold at once
// (cudaOccupancyMaxActiveClusters), in *out. Returns the query's error.
extern "C" int qa_flash_decode_resident_clusters(int splits, int stages, int* out) {
  if (splits < 1 || splits > kMaxSplits || stages < 1 ||
      stages > max_stages<__nv_bfloat16, false>())
    return (int)cudaErrorInvalidValue;
  auto kern = split_decode_kernel<__nv_bfloat16, __nv_bfloat16, false>;
  cudaError_t err = configure<__nv_bfloat16, __nv_bfloat16, false>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, splits, 1, 1, smem_bytes<__nv_bfloat16, false>(stages), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// k, v: (B, T, Hkv, d) in x_type (0 float32, 1 bf16), element strides
// (b, t, h) given, d contiguous; kq, vq: (B, S, Hkv, d) int8 and kscale,
// vscale: (B, S, Hkv) float32, the cache of one layer, contiguous; pos: (B,)
// int32 on the device, the first row to write. d = 128. Rows at or past S
// are not written. Returns cudaGetLastError() after the launch.
extern "C" int qa_kv_append_quant(const void* k, const void* v, void* kq, void* kscale,
                                  void* vq, void* vscale, const void* pos, long long ksb,
                                  long long kst, long long ksh, long long vsb, long long vst,
                                  long long vsh, int B, int T, int Hkv, int d, int S,
                                  int x_type, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || S < 1 || d != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_type == 0)
    return launch_append<float>(k, v, ksb, kst, ksh, vsb, vst, vsh, kq, kscale, vq, vscale,
                                pos, B, T, Hkv, S, st);
  if (x_type == 1)
    return launch_append<__nv_bfloat16>(k, v, ksb, kst, ksh, vsb, vst, vsh, kq, kscale, vq,
                                        vscale, pos, B, T, Hkv, S, st);
  return (int)cudaErrorInvalidValue;
}
