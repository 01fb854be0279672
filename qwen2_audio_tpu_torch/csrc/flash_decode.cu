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
// 783, about 0.5 us at 3.35 TB/s; 8 MB at the beam step's B = 5, 13 MB at an
// 8-slot pool's step. The arithmetic is 4 * g * d FLOP per position and
// head, about 3.5 FLOP per cache byte.
//
// Design (split-KV, no clusters): `splits` CTAs take one (stream, KV head).
// Each CTA reads pos[b] itself and takes the rows [j * c, min(n, (j + 1) *
// c)) of n = min(pos[b] + 1, S), c = ceil(n / splits) rounded up to whole
// 64-row stages (kGranule), so at every position the longest split is as
// short as any partition into stages makes it, no row past pos[b] is read,
// a stream of at most 64 rows stays in one split (p rounded against its
// true maximum, as the plain version), and nothing about pos reaches the
// host (a captured graph replays with pos changed in place). The split
// count, the stage count and so the shared memory are the launch plan's
// (ops/flash_decode.py::decode_plan), from the shapes alone: about one
// CTA for each of the card's CTA slots (two an SM for a bf16 query), so
// that the beam's and the pool's batches fill the card in one wave. A CTA
// issues cp.async copies for its whole range at once, one 64-row chunk per
// stage, each stage completing on an mbarrier, so it waits one DRAM round
// trip rather than one per chunk; a range longer than the stages loops
// over them as a ring; q's loads are issued before pos is read.
//
// Per chunk, warp w takes keys 8w..8w+7 for all 8 query rows (g padded to
// 8), and one block barrier orders the chunk's row maxima:
// - bf16 q (bf16 or int8 cache), on the tensor cores (mma.sync; the old
//   float32 FMA loop took 1.2 us a chunk, measured by leaving its parts out,
//   which held the B > 1 shapes at 19-20 % of their bound): S = Q K^T by 8
//   m16n8k16 steps, Q's rows as A (rows 8-15 zero) and the warp's 8 keys as
//   B, K converted to bf16 exactly (int8 values are integers below 2^8); p
//   against the split's running maximum, the V scales folded in, rounded to
//   bf16; then O^T += V^T P^T by 8 m16n8k8 steps with V^T as A and P^T as B:
//   S's accumulator fragment is, register for register, P^T's B fragment, so
//   p never leaves registers, and the 8 query rows fill the n = 8 tile. The
//   d elements are permuted consistently (A's and B's k index of the score
//   product, V^T's m index and the output's columns) so that each lane reads
//   16 contiguous bytes of a row; rows are stored with their 16-byte
//   vectors XOR-swizzled so that no two lanes of a phase hit one bank.
// - float32 q, or a float32 cache under a bf16 q: float32 FMA. Warp w takes
//   keys 8w..8w+7, eight lanes a pair of keys, each lane dotting 16 of the d
//   elements of both keys against all 8 query rows from shared memory, a
//   reduce-scatter of 14 shuffles summing them; p against the split's
//   running maximum into shared memory; P V: each warp accumulates its 8
//   keys for all 8 rows (each lane 4 of the d elements).
// After its range the CTA sums its warps' partials (m, l and the
// un-normalised P V sums, per row). With one split it writes the output.
// Otherwise it writes its partial to a workspace and takes a ticket (a
// counter per (stream, KV head), in an array per stream and per graph
// capture, by one acquire-release atomic after a block barrier), and the
// last CTA of each (stream, KV head) merges the partials, in one round of
// loads and shuffles: M = max m_j, L = sum l_j e^(m_j - M), O = sum acc_j
// e^(m_j - M) / L, a split with no rows (m = -inf, l = 0, acc = 0) weighing
// 0; it leaves the counter at 0. No CTA waits for another, so the grid needs
// no co-resident clusters: the old merge through a cluster's distributed
// shared memory had to keep all B * Hkv clusters resident at once, which
// cut the beam step's (B = 5) and the pool's (B = 8) splits to 4 and 2,
// 60-80 of 132 SMs, and clusters of at most 8 would have halved B = 1's 16
// splits. What holds the kernel now (H100, graph replay, parts left out by
// qmm_ab.py --tile-variants decode): the merge's chain (partial, ticket,
// loads), about 2 us of B = 5's 8.6 and of B = 1's 6.4; the products
// 0.3-0.7 us. Hence one round of loads and one acquire-release atomic:
// loads split by split, or a sequentially consistent fence on each side of
// the ticket, lengthen that chain.
//
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
constexpr int kMaxSplits = 16;       // CTAs per (stream, KV head)
constexpr int kMaxStages = 16;
static_assert(kMaxStages >= kMaxSplits, "the merge's weights reuse the chunks' maxima");
static_assert(kMaxSplits == 16 && kG * kMaxSplits % 32 == 0, "the merge's row lanes: 16 a row, whole warps");
constexpr int kBarBytes = kMaxStages * 8;
constexpr int kSmemMax = 232448;     // a block's shared memory on sm_90
// q in shared memory (the FMA path) with 4 floats of padding after every 32,
// so that the eight d-slices the lanes of a key pair read fall on distinct banks
constexpr int kQFloats = kG * kD / 32 * 36;
__host__ __device__ constexpr int qidx(int i) { return i + (i >> 5) * 4; }
// Qs, Ps [kCH][kG], Cmax [kMaxStages][kG], Lw [kWarps][kG], Mrow [kG], the
// last-CTA flag and its padding
constexpr int kTailBytes = (kQFloats + kCH * kG + kMaxStages * kG + kWarps * kG + kG + 8) * 4;
constexpr int kRedBytes = kWarps * kG * kD * 4;   // the warps' sums, over the stages
// a split's partial in the workspace: m [kG], l [kG], the P V sums [kG][kD]
constexpr int kPart = 2 * kG + kG * kD;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 int8 values (two words) as 4 bf16 pairs, exactly
__device__ __forceinline__ void s8x8_to_bf16(uint2 u, uint32_t (&w)[4]) {
  float f[8];
  s8x4_to_f(u.x, f);
  s8x4_to_f(u.y, f + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
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

// max of a shared float and x, by the integer order of the float's bits
// (x not NaN)
__device__ __forceinline__ void atomic_max(float* p, float x) {
  if (x >= 0.f) atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
  else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
}

// atomically add 1 to a device counter with acquire-release semantics at
// device scope; returns the old value
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// d += A B, m16n8k16 and m16n8k8, bf16 in, float32 out
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// a shared row: d elements of the cache type, no padding
template <typename KT>
__host__ __device__ constexpr int row_bytes() { return kD * (int)sizeof(KT); }

template <typename KT, bool QUANT>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kCH * row_bytes<KT>() + (QUANT ? 2 * kCH * 4 : 0);
}

// The tensor-core path (a bf16 query over a bf16 or int8 cache) and its
// swizzles: the 16-byte vector v of a K or V row r is stored at v ^ swz(r),
// so that the lanes of one phase of a score (K) or P V (V) read hit distinct
// banks. A score read: lane (g, t) reads 16 (bf16) or 8 (int8) bytes at
// 32-element block kp, lane t's part, of key row g; bf16 rows g and g + 1
// share a phase, int8 rows g .. g + 3. A P V read: lane (g, t) reads d 8 g ..
// 8 g + 7 (and 64 + 8 g ..) of rows 2 t and 2 t + 1; rows 0, 2, 4, 6 share
// a phase. The FMA path reads rows unswizzled.
template <typename QT, typename KT>
__host__ __device__ constexpr bool tensor_path() {
  return sizeof(QT) == 2 && sizeof(KT) <= 2;
}

template <bool TC, typename KT, bool V>
__device__ __forceinline__ int swz(int r) {
  if constexpr (!TC) return 0;
  else if constexpr (V) return 2 * ((r >> 1) & 3);
  else if constexpr (sizeof(KT) == 2) return (r & 1) << 2;
  else return 2 * (r & 3);
}

template <typename KT, bool QUANT>
constexpr int max_stages(int smem) {
  const int n = (smem - kBarBytes - kTailBytes) / stage_bytes<KT, QUANT>();
  return n < kMaxStages ? n : kMaxStages;
}

template <typename KT, bool QUANT>
constexpr int smem_bytes(int stages) {
  return kBarBytes + stages * stage_bytes<KT, QUANT>() + kTailBytes;
}

// The tensor-core path holds few registers (its q fragments, O^T's 32
// accumulators), so two CTAs share an SM; the FMA path takes all 255.
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads, tensor_path<QT, KT>() ? 2 : 1)
split_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    QT* __restrict__ o, float* __restrict__ ws, int* __restrict__ tickets,
                    int S, int Hkv, int G, float sm_scale, int stages) {
  constexpr bool TC = tensor_path<QT, KT>();
  constexpr int RS = row_bytes<KT>();
  constexpr int VPR = kD * (int)sizeof(KT) / 16;   // 16-byte vectors per row
  constexpr int VEC = 16 / (int)sizeof(KT);        // elements per vector
  constexpr int STAGE = stage_bytes<KT, QUANT>();
  constexpr int NR = kG / 4;                       // FMA: rows a lane keeps after the dots
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
  float* Mrow = Lw + kWarps * kG;                                  // [kG]
  int* last = reinterpret_cast<int*>(Mrow + kG);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int splits = gridDim.x, j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (size_t)b * Hkv * G + (size_t)hk * G;   // the first query row, in q and o
  const int g = lane >> 2, t = lane & 3;                       // the tensor path's lane roles

  // q first: its loads are in flight while pos is read and the copies issued.
  // The tensor path keeps Q's A fragments: qf[kp] = row g, d 32 kp + 8 t ..
  // + 7 (rows 8-15 are zero registers); the FMA path stages q in shared memory.
  constexpr int QR = TC ? 4 : kG * kD / kThreads;
  uint4 qf[TC ? 4 : 1];
  float qreg[TC ? 1 : QR];
  if constexpr (TC) {
#pragma unroll
    for (int kp = 0; kp < 4; ++kp)
      qf[kp] = g < G ? *reinterpret_cast<const uint4*>(q + (qrow + g) * kD + 32 * kp + 8 * t)
                     : make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < QR; ++i) {
      const int e = tid + i * kThreads;
      qreg[i] = e / kD < G ? to_f(q[qrow * kD + e]) : 0.f;
    }
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
      qa::cp_async16(st + r * RS + (cv ^ swz<TC, KT, false>(r)) * 16,
                     reinterpret_cast<const unsigned char*>(kb + off) + cv * 16, ok);
      qa::cp_async16(st + (kCH + r) * RS + (cv ^ swz<TC, KT, true>(r)) * 16,
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
  if constexpr (!TC) {
#pragma unroll
    for (int i = 0; i < QR; ++i) Qs[qidx(tid + i * kThreads)] = qreg[i];
  }
  __syncthreads();   // Qs written

  // the FMA path's lanes: warp w takes keys 8w..8w+7 of the chunk, eight
  // lanes (d8) a pair of keys key0 and key0 + 4, each lane 16 of the d
  // elements of both; after it, the lane keeps key kr's rows rq * NR + i
  const int d8 = lane & 7, b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1, b0 = lane & 1;
  const int key0 = warp * 8 + (lane >> 3), kr = key0 + 4 * b2, rq = lane & 3;
  constexpr int MR = TC ? 1 : kG;   // running maxima a lane keeps (TC: row g's)
  float m_run[MR];                  // the split's running row maxima (every warp alike)
  float lsum[TC ? 1 : NR];          // this lane's (TC: row g, its 2 keys) running sums
  // P V: TC, O^T's fragments acc[mt] = rows 2t, 2t + 1 at d 8 g + mt (0, 1)
  // and 64 + 8 g + mt (2, 3); FMA, lane owns d elements 4*lane..+3 of every row
  float acc[kG][4];
#pragma unroll
  for (int r = 0; r < kG; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll
  for (int r = 0; r < MR; ++r) m_run[r] = -INFINITY;
#pragma unroll
  for (int i = 0; i < (TC ? 1 : NR); ++i) lsum[i] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int st = ci % stages;
    qa::mbar_wait(&bars[st], (ci / stages) & 1);   // chunk ci has landed
    const unsigned char* Kst = stage0 + st * STAGE;
    const unsigned char* Vst = Kst + kCH * RS;
    const float* KSs = reinterpret_cast<const float*>(Kst + 2 * kCH * RS);
    const float* VSs = KSs + kCH;
    float* cmax = Cmax + st * kG;

    if constexpr (TC) {
      // (1) S = Q K^T over the warp's 8 keys: c[0], c[1] row g, keys 8w + 2t (+ 1)
      const int key = warp * 8 + g;
      const unsigned char* krow = Kst + key * RS;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t bw[4];   // K[key][32 kp + 8 t .. + 7] as bf16 pairs
        if constexpr (sizeof(KT) == 2) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              krow + ((4 * kp + t) ^ swz<TC, KT, false>(key)) * 16);
          bw[0] = u.x; bw[1] = u.y; bw[2] = u.z; bw[3] = u.w;
        } else {
          s8x8_to_bf16(*reinterpret_cast<const uint2*>(
                           krow + ((2 * kp + (t >> 1)) ^ swz<TC, KT, false>(key)) * 16 +
                           (t & 1) * 8),
                       bw);
        }
        mma_16816(sc, qf[kp].x, qf[kp].y, bw[0], bw[1]);
        mma_16816(sc, qf[kp].z, qf[kp].w, bw[2], bw[3]);
      }
      const int kk = warp * 8 + 2 * t;   // this lane's keys kk, kk + 1
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[e] * sm_scale;
        if constexpr (QUANT) x *= KSs[kk + e];
        s[e] = r0 + ci * kCH + kk + e < r1 ? x : -INFINITY;
      }
      float mx = fmaxf(s[0], s[1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0) atomic_max(cmax + g, mx);
      __syncthreads();   // the chunk's row maxima are complete

      // (2) p against the split's running maximum, the V scales folded in,
      // rounded to bf16: P^T's B fragment
      const float mn = fmaxf(m_run[0], cmax[g]);
      const float alpha = expf(m_run[0] - mn);
      m_run[0] = mn;
      float p0 = expf(s[0] - mn), p1 = expf(s[1] - mn);
      lsum[0] = lsum[0] * alpha + (p0 + p1);
      if constexpr (QUANT) {   // zero past the range
        p0 *= VSs[kk];
        p1 *= VSs[kk + 1];
      }
      const uint32_t pb = pack_bf16(p0, p1);
      const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * t);       // row 2t's
      const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);   // row 2t + 1's

      // (3) O^T += V^T P^T: V rows kk and kk + 1, d 8 g .. (lo) and 64 + 8 g .. (hi)
      const unsigned char* v0 = Vst + kk * RS;
      const unsigned char* v1 = v0 + RS;
      const int s0 = swz<TC, KT, true>(kk), s1 = swz<TC, KT, true>(kk + 1);
      uint32_t alo[8], ahi[8];   // V^T's A fragments, m-tile mt
      if constexpr (sizeof(KT) == 2) {
        const uint4 x0 = *reinterpret_cast<const uint4*>(v0 + (g ^ s0) * 16);
        const uint4 x1 = *reinterpret_cast<const uint4*>(v0 + ((8 + g) ^ s0) * 16);
        const uint4 y0 = *reinterpret_cast<const uint4*>(v1 + (g ^ s1) * 16);
        const uint4 y1 = *reinterpret_cast<const uint4*>(v1 + ((8 + g) ^ s1) * 16);
        const uint32_t xl[4] = {x0.x, x0.y, x0.z, x0.w}, xh[4] = {x1.x, x1.y, x1.z, x1.w};
        const uint32_t yl[4] = {y0.x, y0.y, y0.z, y0.w}, yh[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int mt = 0; mt < 8; ++mt) {
          const uint32_t sel = (mt & 1) ? 0x7632u : 0x5410u;
          alo[mt] = __byte_perm(xl[mt >> 1], yl[mt >> 1], sel);
          ahi[mt] = __byte_perm(xh[mt >> 1], yh[mt >> 1], sel);
        }
      } else {
        const int half = (g & 1) * 8;
        float xl[8], xh[8], yl[8], yh[8];
        const uint2 ux0 = *reinterpret_cast<const uint2*>(v0 + ((g >> 1) ^ s0) * 16 + half);
        const uint2 ux1 = *reinterpret_cast<const uint2*>(v0 + ((4 + (g >> 1)) ^ s0) * 16 + half);
        const uint2 uy0 = *reinterpret_cast<const uint2*>(v1 + ((g >> 1) ^ s1) * 16 + half);
        const uint2 uy1 = *reinterpret_cast<const uint2*>(v1 + ((4 + (g >> 1)) ^ s1) * 16 + half);
        s8x4_to_f(ux0.x, xl); s8x4_to_f(ux0.y, xl + 4);
        s8x4_to_f(ux1.x, xh); s8x4_to_f(ux1.y, xh + 4);
        s8x4_to_f(uy0.x, yl); s8x4_to_f(uy0.y, yl + 4);
        s8x4_to_f(uy1.x, yh); s8x4_to_f(uy1.y, yh + 4);
#pragma unroll
        for (int mt = 0; mt < 8; ++mt) {
          alo[mt] = pack_bf16(xl[mt], yl[mt]);
          ahi[mt] = pack_bf16(xh[mt], yh[mt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        acc[mt][0] *= al0; acc[mt][1] *= al1;
        acc[mt][2] *= al0; acc[mt][3] *= al1;
        mma_1688(acc[mt], alo[mt], ahi[mt], pb);
      }
    } else {
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
        for (int tt = 0; tt < 4; ++tt) {
          const float send = b1 ? w[tt] : w[4 + tt];
          x[tt] = (b1 ? w[4 + tt] : w[tt]) + __shfl_xor_sync(0xffffffffu, send, 2);
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
    }
    if (ci + stages < n_chunks) {   // a ring: refill this stage
      __syncthreads();   // every warp is done with the stage and its maxima
      if (tid < kG) cmax[tid] = -INFINITY;
      load_chunk(ci + stages);
    }
  }

  // the split's partial: the warps' P V sums and row sums meet over the
  // stages, the row maxima (alike in every warp) beside them
  __syncthreads();   // every warp is done with the stages
  float* Red = reinterpret_cast<float*>(stage0);   // [kWarps][kG][kD]
  if constexpr (TC) {
    float l = lsum[0];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0) Lw[warp * kG + g] = l;
    if (warp == 0 && t == 0) Mrow[g] = m_run[0];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = Red + (warp * kG + 2 * t + e) * kD + 64 * half + 8 * g;
        const int i = 2 * half + e;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4][i], acc[5][i], acc[6][i], acc[7][i]);
      }
  } else {
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < NR; ++i) Lw[warp * kG + rq * NR + i] = lsum[i];
    }
    if (tid < kG) {
      float m = m_run[0];
#pragma unroll
      for (int r = 1; r < kG; ++r) m = tid == r ? m_run[r] : m;
      Mrow[tid] = m;
    }
#pragma unroll
    for (int r = 0; r < kG; ++r)
      *reinterpret_cast<float4*>(Red + (warp * kG + r) * kD + lane * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // each thread: 4 outputs of row r (kThreads * 4 == kG * kD)
  static_assert(kThreads * 4 == kG * kD, "one float4 of outputs a thread");
  const int e = tid * 4, r = e / kD;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 x = *reinterpret_cast<const float4*>(Red + w * kG * kD + e);
    sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
  }
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += Lw[w * kG + r];
  QT* orow = o + qrow * kD;
  if (splits == 1) {
    if (r < G) {
      const float inv = l == 0.f ? 1.f : 1.f / l;
      orow[e] = from_f<QT>(sum.x * inv);
      orow[e + 1] = from_f<QT>(sum.y * inv);
      orow[e + 2] = from_f<QT>(sum.z * inv);
      orow[e + 3] = from_f<QT>(sum.w * inv);
    }
    return;
  }

  // several splits: the partial to the workspace, then a ticket; the last
  // CTA of the (stream, KV head) merges every split's partial
  const int pair = b * Hkv + hk;
  float* part = ws + ((size_t)pair * splits + j) * kPart;
  *reinterpret_cast<float4*>(part + 2 * kG + e) = sum;
  if (tid < kG) {
    part[tid] = Mrow[tid];
    float lr = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lr += Lw[w * kG + tid];
    part[kG + tid] = lr;
  }
  // the ticket, by one acquire-release atomic through the barrier: every
  // thread's part is written before it and so visible on the device first
  // (release), and the other splits' parts are read after it (acquire)
  __syncthreads();
  if (tid == 0) *last = ticket_acq_rel(&tickets[pair]) == splits - 1;
  __syncthreads();
  if (!*last) return;

  // the merge, in one round of loads: this thread's 4 outputs of every split
  // (each split wrote its partial, zeros where it held no rows) and, in the
  // first kG * kMaxSplits threads (16 lanes a row, lane sp), each split's
  // row maximum and sum; each split's weight e^(m_j - M) a row and 1 / L by
  // shuffles over the row's lanes, through shared memory (the chunks'
  // maxima and the warps' sums, now unused) to every thread
  float* W = Cmax;                         // [kG][kMaxSplits]
  float* Linv = Lw;                        // [kG]
  const float* parts = ws + (size_t)pair * splits * kPart;
  float4 x[kMaxSplits];
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp)
    if (sp < splits)
      x[sp] = __ldcg(reinterpret_cast<const float4*>(parts + sp * kPart + 2 * kG + e));
  if (tid < kG * kMaxSplits) {
    const int sp = tid % kMaxSplits, rr = tid / kMaxSplits;
    const bool has = sp < splits;
    const float m = has ? __ldcg(parts + sp * kPart + rr) : -INFINITY;
    const float lv = has ? __ldcg(parts + sp * kPart + kG + rr) : 0.f;
    float M = m;
#pragma unroll
    for (int off = 1; off < kMaxSplits; off <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float wgt = m == -INFINITY ? 0.f : expf(m - M);   // no rows: weight 0
    float L = lv * wgt;
#pragma unroll
    for (int off = 1; off < kMaxSplits; off <<= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    W[rr * kMaxSplits + sp] = wgt;
    if (sp == 0) Linv[rr] = L == 0.f ? 1.f : 1.f / L;
  }
  __syncthreads();
  if (tid == 0) tickets[pair] = 0;   // every split has arrived: ready for the next launch
  if (r >= G) return;
  float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp) {
    const float wgt = sp < splits ? W[r * kMaxSplits + sp] : 0.f;
    if (wgt == 0.f) continue;
    O.x = fmaf(x[sp].x, wgt, O.x); O.y = fmaf(x[sp].y, wgt, O.y);
    O.z = fmaf(x[sp].z, wgt, O.z); O.w = fmaf(x[sp].w, wgt, O.w);
  }
  const float inv = Linv[r];
  orow[e] = from_f<QT>(O.x * inv);
  orow[e + 1] = from_f<QT>(O.y * inv);
  orow[e + 2] = from_f<QT>(O.z * inv);
  orow[e + 3] = from_f<QT>(O.w * inv);
}

// the decode kernel's shared-memory attribute, once per device and
// instantiation: the most any stage count takes
template <typename QT, typename KT, bool QUANT>
cudaError_t configure() {
  auto kern = split_decode_kernel<QT, KT, QUANT>;
  const int smem_max = smem_bytes<KT, QUANT>(max_stages<KT, QUANT>(kSmemMax));
  static std::atomic<unsigned> configured{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return err;
    configured.fetch_or(1u << dev);
  }
  return cudaSuccess;
}

template <typename QT, typename KT, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* o, void* ws, void* tickets, int B, int S,
           int Hkv, int G, float sm_scale, int splits, int stages, cudaStream_t stream) {
  if (stages < 1 || stages > max_stages<KT, QUANT>(kSmemMax) ||
      stages * stage_bytes<KT, QUANT>() < kRedBytes || (splits > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure<QT, KT, QUANT>();
  if (err != cudaSuccess) return (int)err;
  split_decode_kernel<QT, KT, QUANT><<<dim3(splits, Hkv, B), kThreads,
                                       smem_bytes<KT, QUANT>(stages), stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<QT*>(o), static_cast<float*>(ws), static_cast<int*>(tickets), S, Hkv, G,
      sm_scale, stages);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_type, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* pos, void* o, void* ws,
                void* tickets, int B, int S, int Hkv, int G, float sm_scale, int splits,
                int stages, cudaStream_t st) {
  switch (kv_type) {
    case 0: return launch<QT, float, false>(q, k, v, ks, vs, pos, o, ws, tickets, B, S, Hkv, G, sm_scale, splits, stages, st);
    case 1: return launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, pos, o, ws, tickets, B, S, Hkv, G, sm_scale, splits, stages, st);
    case 2: return launch<QT, int8_t, true>(q, k, v, ks, vs, pos, o, ws, tickets, B, S, Hkv, G, sm_scale, splits, stages, st);
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
// visible); o: (B, Hkv * G, d) in q_type. d = 128, 1 <= G <= 8; splits (CTAs
// per (stream, KV head), 1..16) and stages (64-row stages of shared memory)
// from the launch plan. With more than one split, ws: splits * B * Hkv
// partials of (2 + d) * 8 floats, and tickets: B * Hkv int32 counters, zero
// before the launch and left zero by it. Pointers 16-byte aligned, ks and vs
// 4-byte (read a float at a time). Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int qa_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* pos,
                               void* o, void* ws, void* tickets, int B, int S, int Hkv, int G,
                               int d, int q_type, int kv_type, float sm_scale, int splits,
                               int stages, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > kG || d != kD || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_type == 0)
    return dispatch_kv<float>(kv_type, q, k, v, ks, vs, pos, o, ws, tickets, B, S, Hkv, G,
                              sm_scale, splits, stages, st);
  if (q_type == 1)
    return dispatch_kv<__nv_bfloat16>(kv_type, q, k, v, ks, vs, pos, o, ws, tickets, B, S, Hkv,
                                      G, sm_scale, splits, stages, st);
  return (int)cudaErrorInvalidValue;
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
