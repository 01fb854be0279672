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
// the float32 causal kernel), which carries no option branch; OPTS = true
// reads the flags, sm_scale and the causal switch at run time (the bf16
// tile picks one branch-free softmax body per flag set once per chunk):
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
// keys stream through shared memory in chunks with a running max and sum
// per query row (online softmax) inside one block, and the scores never
// leave registers.
// - bf16, attn_wgmma_kernel: one block of three warpgroups (384 threads) per
//   (batch, head, 128 queries), in roles that never reconverge:
//   * warpgroup 0, the producer, gives its registers up (setmaxnreg 24); one
//     thread issues every load as a TMA box (hopper_mma.cuh) in the
//     128-byte-swizzled layout wgmma reads: the block's Q once, then K and
//     V in chunks of 128 keys into a ring of kStages stages, K and V of a
//     stage on mbarriers of their own so that Q K^T starts before V lands;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 240), 64 query rows
//     each: S = Q K^T by wgmma m64n128k16 from shared memory, both operands
//     K-major (Q and K rows are d-contiguous); the softmax on S in the
//     accumulator's registers; then O += P V by wgmma m64n{d}k16 with A from
//     registers (S's float32 accumulator packed to bf16 is, register for
//     register, the A fragment of the next product) and B = V as it lies,
//     MN-major, read with the transpose bit. A stage's K is released by an
//     mbarrier arrival once its Q K^T has completed, its V once its P V has.
//   The producer runs up to kStages chunks ahead, so the next chunk's K and
//   V are in flight while the consumers work. Warpgroup 1 starts once
//   warpgroup 0's first Q K^T has completed, so that the two stay out of
//   step and one's softmax runs under the other's products. What limited
//   the tile was the softmax: clock64 stamps of one block (on an H100) put
//   47-51 % of a consumer's time in it, 12-19 % in each product and 12-17 %
//   in waiting for a K stage that the other warpgroup had not released, and
//   half of its instructions were an exact expf. So:
//   * the exponential is one fma and the special-function unit's 2^x (ex2
//     above); the lite sums read the rounded p back from the packed words
//     rather than converting each value (a conversion runs on the unit
//     that computes the exponentials);
//   * at d = 64, the default softmax, a consumer issues chunk j's Q K^T and
//     chunk j - 1's P V together and waits for the first only, so the
//     softmax of chunk j runs while the P V is on the tensor cores; the P V
//     is waited for before its sums are rescaled and P is packed anew. P
//     stays live beside the next scores, which fits a consumer's registers
//     at d = 64 only (12 warps put 3 on each SM sub-partition, so ptxas
//     holds a thread to about 168 registers whatever setmaxnreg allows at
//     run time). The first chunk is peeled so that every turn of the loop
//     waits alike: where ptxas cannot tell which product a wait leaves in
//     flight, it serializes every wgmma of the tile (C7515). The options'
//     softmax (a switch on the flags) and d = 128 take the products in turn.
//   At the encoder shape on an H100 (graph replay; qmm_ab.py
//   --attention-only and --tile-variants attention): 0.048-0.049 ms before,
//   0.037 with the exponential, 0.034 with the overlap; bf16 SDPA 0.038.
//   Tried and not kept, each slower or no faster: a persistent grid of a
//   block an SM taking the 240 units in turn (the 240 equal units leave 108
//   SMs two whatever the order, and the causal tile loses the hardware's
//   load balance); three K/V stages; FA3's ping-pong of the two warpgroups'
//   products on named barriers (+4 %); no stagger (+20 %); an FMA
//   polynomial for an eighth of the exponentials (+4 %), so the
//   special-function unit is not what holds the tile: its consumers' other
//   instructions (max, sums, rescale, packing) are.
//   Heads are read by stride: Q, K and V are each a 4-D tensor map (d,
//   token, head, batch) over the caller's strides, so views into the fused
//   QKV projection are read in place. d = 128 is two 64-column swizzle
//   boxes; the K-major descriptors step into the second box after four k16
//   steps, and the MN-major V descriptor finds it by its leading byte
//   offset. The K and V maps end at kv_valid, so TMA zero-fills every key at
//   or past it and a NaN there is never read; the mask is applied only on
//   the chunk that crosses kv_valid and, causal, on the chunks that cross
//   the diagonal. Grid: (batch x head, query tiles); causal query tiles are
//   launched heaviest first (blockIdx.y 0 takes the last tile), so that an
//   uneven last wave does not end on a long tile.
// - float32: FMA only (no TF32), one thread per query row, 128 rows per
//   block, keys in chunks of 32 that every thread reads by broadcast (d = 64;
//   d = 128 takes the causal float32 kernel below with the mask off).
// - causal float32 (d = 128): one query row would need 2*d float
//   registers for q and the accumulator, so two threads share a row, each
//   holding every other float4 of d (the two halves then read neighbouring
//   16-byte words of a shared key row, no bank conflict), and the partial
//   dot products meet with one shuffle; 64 rows per block of 128 threads.
// Heads are read by stride, so Q/K/V may be views into the fused QKV
// projection output; the output is written in the layout the strides give.

#include "hopper_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace qa;

struct Strides {
  long long b, h, t;
};

constexpr int kBQ = 128;        // bf16: queries per block (2 consumer warpgroups x 64)
constexpr int kBK = 128;        // bf16: keys per chunk
constexpr int kStages = 2;      // bf16: K/V chunks in the ring
constexpr int kThreads = 384;   // bf16: the producer and 2 consumer warpgroups
constexpr int kBox = kBQ * kSwizzleRow;   // one (128 rows, 64 values) bf16 box: 16 KB

// option bits of `flags`
constexpr int kExp2 = 1;     // exp2f in place of expf
constexpr int kPexp16 = 2;   // p = bf16(exp(bf16(s - m))), the row sum of those
constexpr int kLite = 4;     // the row sum of p as cast to V's type

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the softmax's exponential, e^x or (kExp2) 2^x: the float32 kernels'
__device__ __forceinline__ float expo(float x, int flags) {
  return (flags & kExp2) ? exp2f(x) : expf(x);
}

// p for shifted score x = s - m
__device__ __forceinline__ float prob(float x, int flags) {
  if (flags & kPexp16) return round_bf16(expo(round_bf16(x), flags));
  return expo(x, flags);
}

// 2^x by the special-function unit alone (ex2.approx.ftz: about 2 ulp,
// results below 2^-126 flushed to 0), the bf16 tile's exponential: the
// tile takes e^(s - m) as 2^(s log2e - m log2e), one fma and this, where
// expf took about 8 instructions. Its error (about 1e-6 relative over the
// softmax's range, the fma's rounding of s log2e included) stays far below
// p's bf16 rounding (2^-9), which P V takes either way.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Q, then kStages stages of K and of V, each (128 rows, D) in D / 64 boxes;
// the mbarriers; 1024 bytes to align the boxes to the swizzle atom
template <int D>
constexpr int bf16_smem_bytes() {
  return (1 + 2 * kStages) * (D / 64) * kBox + (1 + 4 * kStages) * 8 + 1024;
}

// A consumer thread's part of a (64, 128) chunk of scores, in wgmma's
// accumulator layout: sc[4 n + e] is row qa and sc[4 n + 2 + e] row qc = qa
// + 8, key k0 + 8 n + 2 t4 + e (e = 0, 1). Scales (SCALE) and masks (EDGE:
// the chunk crosses kv_valid or, causal, the diagonal) the scores in place
// and returns the two rows' maxima over the quad.
template <bool CAUSAL, bool SCALE, bool EDGE>
__device__ __forceinline__ void scale_mask_max(float (&sc)[kBK / 2], int k0,
                                               int t4, int kv_valid, int qa, int qc,
                                               float sm_scale, float& mx0, float& mx1) {
  float pm0[4], pm1[4];   // four partial maxima a row: shorter dependency chains
#pragma unroll
  for (int i = 0; i < 4; ++i) pm0[i] = pm1[i] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = SCALE ? sc[4 * n + e] * sm_scale : sc[4 * n + e];
      float x1 = SCALE ? sc[4 * n + 2 + e] * sm_scale : sc[4 * n + 2 + e];
      if (EDGE) {
        const int col = k0 + 8 * n + 2 * t4 + e;
        x0 = col < kv_valid && (!CAUSAL || col <= qa) ? x0 : -INFINITY;
        x1 = col < kv_valid && (!CAUSAL || col <= qc) ? x1 : -INFINITY;
      }
      sc[4 * n + e] = x0;
      sc[4 * n + 2 + e] = x1;
      pm0[n & 3] = fmaxf(pm0[n & 3], x0);
      pm1[n & 3] = fmaxf(pm1[n & 3], x1);
    }
  mx0 = fmaxf(fmaxf(pm0[0], pm0[1]), fmaxf(pm0[2], pm0[3]));
  mx1 = fmaxf(fmaxf(pm1[0], pm1[1]), fmaxf(pm1[2], pm1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
}

// p = prob(s - m) in place, (PACK) P packed to bf16 as the A fragments of
// P V's k16 steps (``pack_p``), and the two rows' sums of p (kLite: of p
// rounded to bf16, read back from the packed words: a conversion a value
// would load the unit that computes the exponentials; kPexp16: p is a bf16
// value already), for the option bits F known at compile time: no branch
// inside the loop. The
// exponential is 2^(s L - m L), L = log2e (1 under kExp2: the logits are in
// base 2 already). Keys 16 kk .. 16 kk + 15 are column groups n = 2 kk and
// 2 kk + 1: the fragment's values 2 t4 (+ 1) and 2 t4 + 8 (+ 1) of rows g
// and g + 8. Four partial sums a row shorten the chain of dependent adds.
template <int F, bool PACK>
__device__ __forceinline__ void chunk_probs(float (&sc)[kBK / 2], float mn0, float mn1,
                                            uint32_t (&pa)[kBK / 16][4], float& ls0,
                                            float& ls1) {
  static_assert(PACK || F == 0, "only the default softmax leaves P unpacked");
  constexpr float L = (F & kExp2) ? 1.f : kLog2e;
  const float ml0 = mn0 * L, ml1 = mn1 * L;
  float ps0[4] = {0.f, 0.f, 0.f, 0.f}, ps1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (F & kPexp16) {
        sc[4 * n + e] = round_bf16(ex2(round_bf16(sc[4 * n + e] - mn0) * L));
        sc[4 * n + 2 + e] = round_bf16(ex2(round_bf16(sc[4 * n + 2 + e] - mn1) * L));
      } else {
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], L, -ml0));
        sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], L, -ml1));
      }
    }
    uint32_t w0 = 0, w1 = 0;
    if constexpr (PACK) {
      w0 = pack_bf16(sc[4 * n], sc[4 * n + 1]);
      w1 = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      pa[n >> 1][2 * (n & 1)] = w0;
      pa[n >> 1][2 * (n & 1) + 1] = w1;
    }
    if ((F & kLite) && !(F & kPexp16)) {
      ps0[n & 3] += bf16_lo(w0) + bf16_hi(w0);
      ps1[n & 3] += bf16_lo(w1) + bf16_hi(w1);
    } else {
      ps0[n & 3] += sc[4 * n] + sc[4 * n + 1];
      ps1[n & 3] += sc[4 * n + 2] + sc[4 * n + 3];
    }
  }
  ls0 = (ps0[0] + ps0[1]) + (ps0[2] + ps0[3]);
  ls1 = (ps1[0] + ps1[1]) + (ps1[2] + ps1[3]);
}

// P packed to bf16 as the A fragments of P V's k16 steps (as chunk_probs
// packs it)
__device__ __forceinline__ void pack_p(const float (&sc)[kBK / 2], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
    pa[n >> 1][2 * (n & 1)] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// The online-softmax step of one chunk: the scores become p (and, PACK, P
// in pa), the running maxima and sums move on, and a0 / a1 are the factors
// that rescale the rows' earlier sums of P V. Every chunk holds key k0 < kv_valid, and key 0
// is visible to every row (causal too), so the maxima are finite from the
// first chunk on and a chunk with no visible key for a row leaves its
// maximum alone.
template <bool CAUSAL, bool OPTS, bool PACK>
__device__ __forceinline__ void softmax_chunk(float (&sc)[kBK / 2], uint32_t (&pa)[kBK / 16][4],
                                              bool edge, int k0, int t4, int kv_valid, int qa,
                                              int qc, float sm_scale, int flags, float& m0,
                                              float& m1, float& l0, float& l1, float& a0,
                                              float& a1) {
  constexpr bool SCALE = CAUSAL || OPTS;   // the one-shot default: Q pre-scaled
  float mx0, mx1;
  if (edge)   // a branch, not selects on every chunk
    scale_mask_max<CAUSAL, SCALE, true>(sc, k0, t4, kv_valid, qa, qc, sm_scale, mx0, mx1);
  else
    scale_mask_max<CAUSAL, SCALE, false>(sc, k0, t4, kv_valid, qa, qc, sm_scale, mx0, mx1);
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float L = (flags & kExp2) ? 1.f : kLog2e;
  a0 = ex2(fmaf(m0, L, -mn0 * L));   // m = -inf (the first chunk): 0
  a1 = ex2(fmaf(m1, L, -mn1 * L));
  m0 = mn0;
  m1 = mn1;
  float ls0, ls1;
  if constexpr (!OPTS) {
    chunk_probs<0, PACK>(sc, mn0, mn1, pa, ls0, ls1);
  } else if constexpr (CAUSAL) {   // the causal entry takes kExp2 only
    if (flags & kExp2)
      chunk_probs<kExp2, PACK>(sc, mn0, mn1, pa, ls0, ls1);
    else
      chunk_probs<0, PACK>(sc, mn0, mn1, pa, ls0, ls1);
  } else {
    switch (flags) {   // kPexp16 | kLite sums as kPexp16 does (p is bf16)
      case kExp2: chunk_probs<kExp2, PACK>(sc, mn0, mn1, pa, ls0, ls1); break;
      case kPexp16:
      case kPexp16 | kLite: chunk_probs<kPexp16, PACK>(sc, mn0, mn1, pa, ls0, ls1); break;
      case kPexp16 | kExp2:
      case kPexp16 | kLite | kExp2:
        chunk_probs<kPexp16 | kExp2, PACK>(sc, mn0, mn1, pa, ls0, ls1);
        break;
      case kLite: chunk_probs<kLite, PACK>(sc, mn0, mn1, pa, ls0, ls1); break;
      case kLite | kExp2: chunk_probs<kLite | kExp2, PACK>(sc, mn0, mn1, pa, ls0, ls1); break;
      default: chunk_probs<0, PACK>(sc, mn0, mn1, pa, ls0, ls1); break;
    }
  }
  l0 = l0 * a0 + ls0;
  l1 = l1 * a1 + ls1;
}

// S = Q K^T for the warpgroup's 64 rows over one K stage, both operands
// K-major: box kk / 4, 32 bytes a k16 step
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], const uint8_t* qw,
                                         const uint8_t* kst) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_bf16_n128(sc, wgmma_desc(qw + off), wgmma_desc(kst + off), kk > 0);
  }
}

// O += P V over one V stage: P from registers, V MN-major, 16 keys (two
// 8-row atoms) a k16 step
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[kBK / 16][4],
                                         const uint8_t* vst) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t bd = wgmma_desc_mn(vst + kk * 2 * kSwizzleAtom, kBox);
    if constexpr (D == 64)
      wgmma_bf16_rs_n64(acc, pa[kk], bd);
    else
      wgmma_bf16_rs_n128(acc, pa[kk], bd);
  }
}

// keep the registers an in-flight wgmma reads or writes where they are
template <int N>
__device__ __forceinline__ void pin_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
__device__ __forceinline__ void pin_all(uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pin(pa[kk][i]);
}

template <int D, bool CAUSAL, bool OPTS>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ o, Strides so, int H, int group, int Tq,
                  int kv_valid, float sm_scale, int opt_flags) {
  constexpr int NB = D / 64;          // 64-value swizzle boxes per row
  constexpr int kTile = NB * kBox;    // Q, or one stage's K or V
  // d = 64, the default softmax: the next chunk's Q K^T beside this chunk's
  // P V (P stays live beside the next scores, which fits a consumer's
  // registers at d = 64 only; the options' softmax, a switch on the flags,
  // takes the products in turn)
  constexpr bool OVL = D == 64 && !OPTS;
  const int flags = OPTS ? opt_flags : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* ks = qs + kTile;              // [kStages][kTile]
  uint8_t* vs = ks + kStages * kTile;    // [kStages][kTile]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* full_k = full_q + 1;         // [kStages] each
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H, hk = h / group;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  int n_chunks = (kv_valid + kBK - 1) / kBK;
  if (CAUSAL)   // tile skip: no key past the block's last query row
    n_chunks = min(n_chunks, (q0 + kBQ - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 256);
      mbar_init(&empty_v[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, kTile);
      for (int c = 0; c < NB; ++c) tma_load_4d(qs + c * kBox, &qmap, full_q, 64 * c, q0, h, b);
      for (int j = 0; j < n_chunks; ++j) {
        const int s = j % kStages;
        const uint32_t free_par = ((j / kStages) & 1) ^ 1;
        mbar_wait(&empty_k[s], free_par);
        mbar_expect_tx(&full_k[s], kTile);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(ks + s * kTile + c * kBox, &kmap, &full_k[s], 64 * c, j * kBK, hk, b);
        mbar_wait(&empty_v[s], free_par);
        mbar_expect_tx(&full_v[s], kTile);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(vs + s * kTile + c * kBox, &vmap, &full_v[s], 64 * c, j * kBK, hk, b);
      }
    }
  } else {
    // ---- consumers ----
    // Per chunk: S = Q K^T, the softmax, O += P V, each product waited for
    // before its registers are read (at d = 64 the next Q K^T beside the P V,
    // OVL). A stage's K is released once its Q K^T has completed, its V once
    // its P V has, so the producer refills K while the softmax runs. (FA3's
    // ping-pong of the two warpgroups measured slower: PERF.md.)
    setmaxnreg_inc<240>();
    const int wg = (threadIdx.x >> 7) - 1;   // rows 64 wg .. 64 wg + 63 of the block
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_lo = q0 + 64 * wg;
    const int qa = row_lo + 16 * warp + g, qc = qa + 8;   // this thread's two rows
    const uint8_t* qw = qs + wg * 64 * kSwizzleRow;
    float acc[D / 2];            // O: rows qa, qc; columns 8 n + 2 t4 (+ 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBK / 2];           // S, then P, of the chunk
    uint32_t pa[kBK / 16][4];    // P as the A fragments of the k16 steps of P V
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
    // only a chunk that crosses kv_valid or (causal) the diagonal is masked
    const int clean_end = CAUSAL ? min(kv_valid, row_lo + 1) : kv_valid;

    // warpgroup 1 starts once warpgroup 0's first Q K^T has completed: out
    // of step, one's softmax runs under the other's products (in step, both
    // wait on the tensor cores at once: 9 % slower at the encoder shape)
    if (wg == 1) named_sync(1, 256);
    mbar_wait(full_q, 0);
    if constexpr (OVL) {
      // chunk 0's scores and P, then per chunk j: Q K^T of j and P V of j - 1
      // issued together, the softmax of j under the P V, the P V waited for
      // before its sums are rescaled and P is packed anew; the first chunk
      // peeled, so that every turn of the loop waits alike (ptxas serializes
      // the tile's wgmma where it cannot tell which product a wait leaves
      // in flight)
      mbar_wait(&full_k[0], 0);
      wgmma_fence();
      issue_qk<D>(sc, qw, ks);
      wgmma_commit();
      wgmma_wait<0>();
      pin_all(sc);
      mbar_arrive(&empty_k[0]);
      if (wg == 0) named_arrive(1, 256);
      softmax_chunk<CAUSAL, OPTS, true>(sc, pa, kBK > clean_end, 0, t4, kv_valid, qa, qc,
                                        sm_scale, flags, m0, m1, l0, l1, a0, a1);
      pin_all(pa);
      for (int j = 1; j < n_chunks; ++j) {
        const int s = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(&full_k[s], (j / kStages) & 1);
        wgmma_fence();
        issue_qk<D>(sc, qw, ks + s * kTile);
        wgmma_commit();
        mbar_wait(&full_v[sp], ((j - 1) / kStages) & 1);
        issue_pv<D>(acc, pa, vs + sp * kTile);
        wgmma_commit();
        wgmma_wait<1>();   // chunk j's Q K^T; chunk j - 1's P V runs on
        pin_all(sc);
        mbar_arrive(&empty_k[s]);
        softmax_chunk<CAUSAL, OPTS, false>(sc, pa, (j + 1) * kBK > clean_end, j * kBK, t4,
                                           kv_valid, qa, qc, sm_scale, flags, m0, m1, l0, l1,
                                           a0, a1);
        wgmma_wait<0>();
        pin_all(acc);
        pin_all(pa);
        mbar_arrive(&empty_v[sp]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= a0;
          acc[4 * n + 1] *= a0;
          acc[4 * n + 2] *= a1;
          acc[4 * n + 3] *= a1;
        }
        pack_p(sc, pa);
        pin_all(acc);
        pin_all(pa);
      }
      const int sl = (n_chunks - 1) % kStages;   // the last chunk's P V
      mbar_wait(&full_v[sl], ((n_chunks - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<D>(acc, pa, vs + sl * kTile);
      wgmma_commit();
      wgmma_wait<0>();
      pin_all(acc);
      pin_all(pa);
      mbar_arrive(&empty_v[sl]);
    } else {
      for (int j = 0; j < n_chunks; ++j) {
        const int s = j % kStages;
        const uint32_t par = (j / kStages) & 1;
        mbar_wait(&full_k[s], par);
        wgmma_fence();
        issue_qk<D>(sc, qw, ks + s * kTile);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(sc);
        mbar_arrive(&empty_k[s]);
        if (wg == 0 && j == 0) named_arrive(1, 256);
        softmax_chunk<CAUSAL, OPTS, true>(sc, pa, (j + 1) * kBK > clean_end, j * kBK, t4,
                                          kv_valid, qa, qc, sm_scale, flags, m0, m1, l0, l1,
                                          a0, a1);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= a0;
          acc[4 * n + 1] *= a0;
          acc[4 * n + 2] *= a1;
          acc[4 * n + 3] *= a1;
        }
        pin_all(acc);
        pin_all(pa);
        mbar_wait(&full_v[s], par);
        wgmma_fence();
        issue_pv<D>(acc, pa, vs + s * kTile);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(acc);
        pin_all(pa);
        mbar_arrive(&empty_v[s]);
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
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (qa < Tq)
        *reinterpret_cast<uint32_t*>(ob + qa * so.t + col) =
            pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (qc < Tq)
        *reinterpret_cast<uint32_t*>(ob + qc * so.t + col) =
            pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
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

// A (B, heads, tokens, D) bf16 operand read by stride: a 4-D tensor map
// (d, token, head, batch) in (64, 128, 1, 1) boxes with the 128-byte
// swizzle; tokens at or past `tokens` read as zero. The stride of an
// extent-1 dimension is never used, so it is replaced by one TMA takes.
template <int D>
bool head_map(CUtensorMap* map, const void* base, Strides s, int B, int heads, int tokens) {
  const long long dims[4] = {D, tokens, heads, B};
  long long st[3] = {s.t * 2, s.h * 2, s.b * 2};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) st[i] = D * 2;
  const int box[4] = {64, kBK, 1, 1};
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims, st, box, true);
}

template <int D, bool CAUSAL, bool OPTS>
cudaError_t launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                         void* o, Strides so, int B, int H, int group, int Tq, int kv_valid,
                         float sm_scale, int flags, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D>();
  const cudaError_t attr = allow_smem<attn_wgmma_kernel<D, CAUSAL, OPTS>>(smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  attn_wgmma_kernel<D, CAUSAL, OPTS><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), so, H, group, Tq, kv_valid, sm_scale, flags);
  return cudaGetLastError();
}

// the bf16 tile: three tensor maps encoded on the host, then the launch
// (OPTS: the instantiation that reads flags and sm_scale)
template <int D, bool CAUSAL>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                        int Hkv, int Tq, int kv_valid, float sm_scale, int flags,
                        cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!head_map<D>(&qm, q, sq, B, H, Tq) || !head_map<D>(&km, k, sk, B, Hkv, kv_valid) ||
      !head_map<D>(&vm, v, sv, B, Hkv, kv_valid))
    return cudaErrorNotSupported;
  const int group = H / Hkv;
  const bool opts = flags != 0 || (!CAUSAL && sm_scale != 1.f);
  return opts ? launch_wgmma<D, CAUSAL, true>(qm, km, vm, o, so, B, H, group, Tq, kv_valid,
                                              sm_scale, flags, stream)
              : launch_wgmma<D, CAUSAL, false>(qm, km, vm, o, so, B, H, group, Tq, kv_valid,
                                               sm_scale, flags, stream);
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
// Returns cudaGetLastError() after the launch, or cudaErrorNotSupported
// where a bf16 operand cannot be described as a tensor map.
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
    return (int)launch_bf16<64, false>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Tq, kv_valid,
                                       sm_scale, flags, st);
  } else if (is_bf16 && d == 128) {
    return (int)launch_bf16<128, false>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Tq, kv_valid,
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
// flags: kExp2. Returns as qa_attention_single does.
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
    return (int)launch_bf16<128, true>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, T, kv_valid,
                                       sm_scale, flags, st);
  } else {
    launch_f32_causal<128>(q, k, v, o, sq, sk, sv, so, B, H, group, T, kv_valid, sm_scale,
                           1, flags, st);
  }
  return (int)cudaGetLastError();
}
