// The fast mode of the one-launch SwiGLU: swiglu_coop_kernel, the
// cooperative two-phase kernel, and its launch. fused_mlp.cu instantiates it
// for M <= 8 (beside the exact mode) and fused_mlp_rows.cu for 9 <= M <= 64,
// so that nvcc builds the two in parallel; the design notes are in
// fused_mlp.cu.

#pragma once

#include "qmm_common.cuh"
#include "qmm_stream.cuh"

namespace {

using namespace qa;

constexpr int kMaxSmem = 232448;

constexpr int kPiece = 16;                    // fast mode: columns of a piece, one A tile
constexpr int kMaxUnits = 12;                 // phase A: units of I in one pass over K
constexpr int kBarrierWords = 3;              // tickets[0..2]: the grid barrier
constexpr int kMaxTickets = 4096;

struct Weight {              // one dequantizing operand
  const uint8_t* q;
  const void* s;
  const float* m;            // nullptr unless the flavour has mins
};

// bytes from one value row of a stage to the next for `cols` columns (a
// multiple of 32): four neighbouring rows on four different groups of banks
__host__ __device__ inline int row_pitch(int cols) {
  const int r = cols % 128;
  return cols + ((r == 0 || r == 64) ? 16 : 0);
}

// the byte offsets of one ring stage's parts, for sg groups of 32 values of
// K (phase A) or of I (phase B): value rows (group gi's rows after group gi
// - 1's), scale rows, min rows, x's raw rows (phase A: 32 sg values of each
// row, xes bytes a value; 0 in phase B), B in fragment order (bf16; k16
// block bk of row m at uint2 (bk * M + m) * 4 + t)
struct StageMap {
  int pitch, scales, mins, xraw, frag, bytes;
};

__host__ __device__ inline StageMap stage_map(int cols, bool packed, bool mins, int srows,
                                              int es, int M, int xes, int sg) {
  StageMap s;
  s.pitch = row_pitch(cols);
  s.scales = sg * (packed ? 16 : 32) * s.pitch;
  s.mins = s.scales + sg * srows * cols * es;
  s.xraw = s.mins + (mins ? sg * srows * cols * 4 : 0);
  s.frag = s.xraw + M * 32 * sg * xes;
  s.bytes = s.frag + 64 * M * sg;
  return s;
}

struct CoopArgs {
  const void* x;
  Weight gate, up, down;
  long long ld_gu;              // elements from one row of gate (and up) to the next
  int gu_es, dn_es;             // bytes of a scale
  void* out;
  __nv_bfloat16* gated;         // (I / 32, 2, M, 4, 4): B's fragment order by 32-row group
  float* partial;               // (S, M, D), or nullptr for S = 1
  unsigned int* tickets;        // barrier words, then one ticket per column tile
  int M, K, I, D, group, x_bf16;
  // the plan (ops/fused_mlp.py swiglu_plan): grid, splits of I, units of a
  // pass's ring slot, ring stages and groups a stage of each phase
  int P, S, units_a, ring_a, ring_b, sg_a, sg_b;
  float zero;
};

// the CTAs of an SM and their warps: at M <= 8 one CTA of 16 warps (phase A
// streams through per-warp rings); at M <= 32 two CTAs of 8 warps, so that
// one computes while the other waits at its block barrier (a warp's
// accumulators fit 128 registers a thread); else one CTA of 8
__host__ __device__ constexpr int coop_warps(int NT) { return NT == 1 ? 16 : 8; }
__host__ __device__ constexpr int coop_ctas(int NT) { return NT == 1 ? 1 : NT <= 4 ? 2 : 1; }
// phase A above 8 rows: most items (piece, group of the stage) a warp holds
__host__ __device__ constexpr int coop_items(int NT) { return NT == 4 ? 3 : 5; }
// a CTA's dynamic shared memory: its share of the SM's 228 KB, 1 KB a CTA
// and a flag aside
__host__ __device__ constexpr int coop_smem_cap(int NT) {
  return coop_ctas(NT) == 1 ? kMaxSmem - 1024 : 114688;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// cp.async.wait_group with a count known at run time (the plan's ring
// depth): all but the newest n groups have landed
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ void grid_barrier(unsigned int* w) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* flag = w + 1;
    __threadfence();
    if (atomicAdd(w, 1u) == gridDim.x - 1) {
      atomicExch(w, 0u);
      __threadfence();
      atomicExch(w + 1, 1u);
    } else {
      uint64_t t0 = 0;
      for (unsigned spins = 1; *flag == 0; ++spins) {
        __nanosleep(64);
        if ((spins & 1023) == 0) {
          const uint64_t now = globaltimer_ns();
          if (t0 == 0)
            t0 = now;
          else if (now - t0 > 4000000000ull)
            __trap();
        }
      }
    }
    __threadfence();
    if (atomicAdd(w + 2, 1u) == gridDim.x - 1) {   // every CTA has seen the flag
      atomicExch(w + 1, 0u);
      atomicExch(w + 2, 0u);
    }
  }
  __syncthreads();
}

// the lane's two weights (columns c, c + 1 of a piece) of scale or min row
// sr of a stage: es bytes a scale
__device__ __forceinline__ float2 stage_pair(const uint8_t* p, int row_bytes, int sr, int c,
                                             int es) {
  if (es == 2)
    return __half22float2(*reinterpret_cast<const __half2*>(p + sr * row_bytes + 2 * c));
  return *reinterpret_cast<const float2*>(p + sr * row_bytes + 4 * c);
}

// one k16 step (h = 0: values 0-15 of group gi of the stage, 1: 16-31) of
// one piece (16 columns at byte col of each value row): its A tile
// dequantized once, multiplied into acc[nt] for every n-tile of B (rows past
// M are zero in B, so those products add nothing)
template <bool PACKED, bool MINS, int NT>
__device__ __forceinline__ void piece_step(float (&acc)[NT][4], const uint8_t* st,
                                           const StageMap& sm, int cols, int col, int es,
                                           int srows, float zero, const uint2 (&b)[NT], int gi,
                                           int h, int lane) {
  constexpr int ROWS = PACKED ? 16 : 32;
  const int g = lane >> 2, t = lane & 3, c = col + 2 * g;
  const int sr = gi * srows + (srows == 2 ? h : 0);
  const float2 s = stage_pair(st + sm.scales, cols * es, sr, c, es);
  float2 mn = make_float2(0.f, 0.f);
  if (MINS) mn = stage_pair(st + sm.mins, cols * 4, sr, c, 4);
  const uint8_t* vr = st + (gi * ROWS + (PACKED ? t : 16 * h + t)) * sm.pitch + c;
  float v[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w = *reinterpret_cast<const uint16_t*>(vr + 4 * i * sm.pitch);
    w = PACKED ? (w >> (4 * h)) & 0x0F0Fu : w ^ 0x8080u;
    const float q0 = byte_as_float(w, 0) - zero, q1 = byte_as_float(w, 1) - zero;
    v[i][0] = MINS ? __fadd_rn(__fmul_rn(q0, s.x), mn.x) : __fmul_rn(q0, s.x);
    v[i][1] = MINS ? __fadd_rn(__fmul_rn(q1, s.y), mn.y) : __fmul_rn(q1, s.y);
  }
  const uint32_t a0 = pack_bf16(v[0][0], v[1][0]), a1 = pack_bf16(v[0][1], v[1][1]);
  const uint32_t a2 = pack_bf16(v[2][0], v[3][0]), a3 = pack_bf16(v[2][1], v[3][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[nt], a0, a1, a2, a3, b[nt]);
}

// the lane's B fragments of k16 block bk for every n-tile (rows past M zero)
template <int NT>
__device__ __forceinline__ void load_b(uint2 (&b)[NT], const uint8_t* frag, int bk, int M,
                                       int lane) {
  const uint2* f = reinterpret_cast<const uint2*>(frag);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = 8 * nt + g;
    b[nt] = m < M ? f[(bk * M + m) * 4 + t] : make_uint2(0u, 0u);
  }
}

// M <= 8: a warp streams one 64-column block over every ks-th group of 32
// rows from group kg0 on (n stages) through its own ring of RING stages
// (qmm_stream.cuh's core, no block barrier between stages; 2 stages, one
// in flight while the other is read: 4 measured slower), so that the CTA's
// warps, spread over its
// blocks and ks interleaved splits of the rows, read one band of rows at a
// time, as the other CTAs do. cp is the lane's copies of the block from
// group kg0 on; bx the B operand (group kg: k16 blocks 2 kg, 2 kg + 1,
// rows below M).
constexpr int kStreamRing = 2;

template <bool PACKED, bool MINS>
__device__ __forceinline__ void stream_block(float (&acc)[4][4], uint8_t* ring, LaneCopy cp,
                                             int n, int kg0, int ks, const uint2* bx, int M,
                                             int es, int group, float zero, int lane,
                                             bool prologue_done) {
  using St = Stage<PACKED, MINS>;
  constexpr int RING = kStreamRing;
  cp.qstep *= ks;
  cp.sstep *= ks;
  cp.mstep *= ks;
  if (prologue_done) {   // the first RING - 1 stages are in flight: step past them
    const int k = min(RING - 1, n);
    cp.q += k * cp.qstep;
    cp.s += k * cp.sstep;
    if (MINS) cp.m += k * cp.mstep;
  } else {
    for (int i = 0; i < RING - 1; ++i) {
      if (i < n) issue_stage<PACKED, MINS>(ring + i * St::kBytes, cp, lane);
      cp_async_commit();
    }
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING - 2>();
    __syncwarp();
    if (i + RING - 1 < n)
      issue_stage<PACKED, MINS>(ring + ((i + RING - 1) & (RING - 1)) * St::kBytes, cp, lane);
    cp_async_commit();
    const int kg = kg0 + i * ks;
    consume_stage<PACKED, MINS, false>(acc, ring + (i & (RING - 1)) * St::kBytes, es, group,
                                       zero, b_frag(bx, 2 * kg, M, lane),
                                       b_frag(bx, 2 * kg + 1, M, lane), lane);
  }
  cp_async_wait<0>();
}

// the first RING - 1 stages of stream_block's ring (a commit group each)
template <bool PACKED, bool MINS>
__device__ __forceinline__ void stream_prologue(uint8_t* ring, LaneCopy cp, int n, int ks,
                                                int lane) {
  using St = Stage<PACKED, MINS>;
  cp.qstep *= ks;
  cp.sstep *= ks;
  cp.mstep *= ks;
  for (int i = 0; i < kStreamRing - 1; ++i) {
    if (i < n) issue_stage<PACKED, MINS>(ring + i * St::kBytes, cp, lane);
    cp_async_commit();
  }
}

// the warps' block sums meet in shared memory: exch[((s * nb + b) * M + m)
// * 64 + column] for split s of block b; the warp's rows below M
__device__ __forceinline__ void stream_exchange(float* exch, const float (&acc)[4][4], int slot,
                                                int M, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (2 * t + hh < M) {
      float o[8];
      acc_row(acc, hh, o);
      store8(exch + (slot * M + 2 * t + hh) * kWarpCols + 8 * g, o);
    }
  }
}

// column c of row m: the ks splits' sums of its block, in split order
__device__ __forceinline__ float stream_sum(const float* exch, int nb, int ks, int M, int m,
                                            int c) {
  const int b = c / kWarpCols, col = c % kWarpCols;
  float sum = exch[(b * M + m) * kWarpCols + col];
  for (int s = 1; s < ks; ++s) sum += exch[((s * nb + b) * M + m) * kWarpCols + col];
  return sum;
}

template <typename XT, bool PACKED, bool MINS, int NT>
__global__ void __launch_bounds__(coop_warps(NT) * 32, coop_ctas(NT))
swiglu_coop_kernel(const CoopArgs a) {
  constexpr int WARPS = coop_warps(NT), THREADS = WARPS * 32;
  constexpr int IW = coop_items(NT);                // most phase-A items a warp holds
  constexpr int ROWS = PACKED ? 16 : 32;           // value rows of a group
  constexpr int TPR = THREADS / ROWS;              // threads copying one value row
  constexpr int VCH = (2 * kMaxUnits + TPR - 1) / TPR;   // a thread's chunks of a row
  constexpr int XES = (int)sizeof(XT);
  constexpr int XCH = 32 * XES / 16;               // 16-byte chunks of 32 values of x
  // a thread's scale (and min) chunks of a stage and its chunks and
  // fragments of x: at most 4 groups x 2 scale rows x 2 halves x 12 units
  // of 4-byte scales; 2 groups x 64 rows x 8 chunks of float32 x, or 4
  // groups x 32 rows; as many fragments
  constexpr int SCH = (4 * 2 * 2 * kMaxUnits * 4 + THREADS - 1) / THREADS;
  constexpr int XQ = (4 * 32 * 8 + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int M = a.M, srows = 32 / a.group;

  // ---- phase A: g, u and gated for the CTA's units of I
  const int U = a.I / kPiece;
  const int ua = (int)((long long)blockIdx.x * U / a.P);
  const int ub = (int)((long long)(blockIdx.x + 1) * U / a.P);
  const int rounds = (ub - ua + kMaxUnits - 1) / kMaxUnits;
  const int cols_a = 2 * kPiece * a.units_a, sga = a.sg_a;
  const StageMap sa = stage_map(cols_a, PACKED, MINS, srows, a.gu_es, M, XES, sga);
  const int GS = a.K / 32 / sga, RA = a.ring_a;   // stages of a pass (sg_a divides K / 32)
  float* exch = reinterpret_cast<float*>(smem);   // over the ring, once a pass's stages are done
  const XT* x = static_cast<const XT*>(a.x);

  if constexpr (NT == 1) {
    // M <= 8: the CTA's gate and up columns side by side (the combined row,
    // 32 nu columns) in nb 64-column blocks (at most 16: the plan sees to
    // it); warp w streams block w % nb over the groups of K of split w / nb
    // of ks = 16 / nb interleaved splits, with x, staged once, as B; the
    // splits' sums of a column meet in the exchange and are added in split
    // order
    constexpr int RING = kStreamRing;
    const int nu = ub - ua, i0 = kPiece * ua, ncol = 2 * kPiece * nu, h16 = kPiece * nu;
    const int G = a.K / 32, nb = (ncol + kWarpCols - 1) / kWarpCols, ks = max(1, WARPS / nb);
    uint2* xs = reinterpret_cast<uint2*>(smem + WARPS * RING * Stage<PACKED, MINS>::kBytes);
    uint8_t* ring = smem + warp * RING * Stage<PACKED, MINS>::kBytes;
    // the lane's copies of block b from group kg on: a chunk lies in gate
    // (combined column < 16 nu) or in up, never across
    auto copy_of = [&](int b, int kg) {
      const int es = a.gu_es;
      const int qc = kWarpCols * b + 16 * (lane & 3);
      const int sc = kWarpCols * b + (lane % (4 * es)) * (16 / es);
      const int mc = kWarpCols * b + (lane & 15) * 4;
      auto at = [&](int c, int part) -> const uint8_t* {
        const bool gt = c < h16;
        const Weight& w = gt ? a.gate : a.up;
        const int col = i0 + (c < ncol ? (gt ? c : c - h16) : 0);
        return part == 0 ? w.q + col
             : part == 1 ? static_cast<const uint8_t*>(w.s) + (long long)col * es
                         : (MINS ? reinterpret_cast<const uint8_t*>(w.m + col) : w.q);
      };
      return lane_copy<PACKED, MINS>(at(qc, 0), qc < ncol, a.ld_gu, at(sc, 1), sc < ncol,
                                     a.ld_gu * es, at(mc, 2), MINS && mc < ncol, a.ld_gu * 4,
                                     es, srows, kg, lane);
    };
    if (nu > 0) {
      // warp w: split w / nb (groups s, s + ks, ...) of block w % nb
      const int s0 = warp / nb, n0 = s0 < ks ? (G - s0 + ks - 1) / ks : 0;
      if (n0 > 0) stream_prologue<PACKED, MINS>(ring, copy_of(warp % nb, s0), n0, ks, lane);
      stage_x(x, a.K, M, a.K, xs, tid, THREADS);
      __syncthreads();
      float acc[4][4] = {};
      if (n0 > 0)
        stream_block<PACKED, MINS>(acc, ring, copy_of(warp % nb, s0), n0, s0, ks, xs, M,
                                   a.gu_es, a.group, a.zero, lane, true);
      __syncthreads();   // every warp is done with the rings and x
      if (s0 < ks) stream_exchange(exch, acc, warp, M, lane);   // zeros where a split is empty
      __syncthreads();
      // g and u (the splits' sums of each column in split order), gated,
      // rounded to bf16, into the scratch as below
      for (int e = tid; e < M * h16; e += THREADS) {
        const int m = e / h16, j = e - m * h16;
        const float gv = stream_sum(exch, nb, ks, M, m, j);
        const float uv = stream_sum(exch, nb, ks, M, m, j + h16);
        const int col = i0 + j, ig = col >> 5, rr = col & 15, hb = (col >> 4) & 1;
        a.gated[(((long long)ig * 2 + hb) * M + m) * 16 + (rr & 3) * 4 + (rr >> 2)] =
            __float2bfloat16_rn(gv * (1.f / (1.f + expf(-gv))) * uv);
      }
      __syncthreads();   // exch lies where phase B's rings go
    }
  } else {
  for (int r = 0; r < rounds; ++r) {
    const int u0 = ua + (int)((long long)r * (ub - ua) / rounds);
    const int nu = ua + (int)((long long)(r + 1) * (ub - ua) / rounds) - u0;
    const int npc = 2 * nu, i0 = kPiece * u0;
    // the thread's 16-byte chunks of a value row: gate pieces, then up pieces
    const int vrow = tid / TPR;
    const uint8_t* vsrc[VCH];
    int vdst[VCH];
#pragma unroll
    for (int k = 0; k < VCH; ++k) {
      const int c = tid % TPR + k * TPR;
      vdst[k] = c < npc ? vrow * sa.pitch + 16 * c : -1;
      vsrc[k] = (c < nu ? a.gate.q + 16 * c : a.up.q + 16 * (c - nu)) + vrow * a.ld_gu + i0;
    }
    const long long vstep = (long long)ROWS * a.ld_gu;
    // the thread's scale (and min) chunks of a stage: chunk c of stage row
    // gr (gate, then up) from row gr of the pass's first stage; x's chunks
    // (row m, group gi, 16 bytes c); the fragments it converts (uint2 e)
    const int sch = nu * a.gu_es, mch = 4 * nu;     // 16-byte chunks of a row's half
    const uint8_t* ssrc[SCH];
    const uint8_t* msrc[SCH];
    int sdst[SCH], mdst[SCH], xoff[XQ], xdst[XQ], foff[XQ];
#pragma unroll
    for (int k = 0; k < SCH; ++k) {
      const int e = tid + k * THREADS, gr = e / (2 * sch), c = e - gr * 2 * sch;
      const bool gt = c < sch;
      sdst[k] = gr < sga * srows ? sa.scales + gr * cols_a * a.gu_es + 16 * c : -1;
      ssrc[k] = static_cast<const uint8_t*>(gt ? a.gate.s : a.up.s) +
                ((long long)gr * a.ld_gu + i0) * a.gu_es + 16 * (gt ? c : c - sch);
      const int gm = e / (2 * mch), cm = e - gm * 2 * mch;
      const bool gtm = cm < mch;
      mdst[k] = MINS && gm < sga * srows ? sa.mins + gm * cols_a * 4 + 16 * cm : -1;
      msrc[k] = reinterpret_cast<const uint8_t*>(gtm ? a.gate.m : a.up.m) +
                ((long long)gm * a.ld_gu + i0) * 4 + 16 * (gtm ? cm : cm - mch);
    }
#pragma unroll
    for (int k = 0; k < XQ; ++k) {
      const int e = tid + k * THREADS, c = e % XCH, rm = e / XCH, m = rm % M, gi = rm / M;
      xdst[k] = gi < sga ? sa.xraw + (m * 32 * sga + gi * 32) * XES + 16 * c : -1;
      xoff[k] = m * a.K + gi * 32 + c * (16 / XES);
      const int bk = e / (4 * M);
      foff[k] = bk < 2 * sga ? ((e >> 2) % M) * 32 * sga + 16 * bk + (e & 3) : -1;
    }
    const long long sstep = (long long)srows * a.ld_gu * a.gu_es, mstep = (long long)srows * a.ld_gu * 4;
    // stage s of the pass (groups s * sg_a ..) into slot st
    auto issue_a = [&](int s, uint8_t* st) {
      const int kg0 = s * sga;
      for (int gi = 0; gi < sga; ++gi) {
#pragma unroll
        for (int k = 0; k < VCH; ++k)
          if (vdst[k] >= 0)
            cp_async16(st + gi * ROWS * sa.pitch + vdst[k], vsrc[k] + (kg0 + gi) * vstep, true);
      }
#pragma unroll
      for (int k = 0; k < SCH; ++k) {
        if (sdst[k] >= 0) cp_async16(st + sdst[k], ssrc[k] + kg0 * sstep, true);
        if (MINS && mdst[k] >= 0) cp_async16(st + mdst[k], msrc[k] + kg0 * mstep, true);
      }
#pragma unroll
      for (int k = 0; k < XQ; ++k)
        if (xdst[k] >= 0) cp_async16(st + xdst[k], x + xoff[k] + kg0 * 32, true);
    };
    // x's raw rows of a landed stage into B's fragment order, rounded to bf16
    auto frag_a = [&](uint8_t* st) {
      const XT* xr = reinterpret_cast<const XT*>(st + sa.xraw);
      uint2* f = reinterpret_cast<uint2*>(st + sa.frag);
#pragma unroll
      for (int k = 0; k < XQ; ++k) {
        if (foff[k] < 0) continue;
        const XT* p = xr + foff[k];
        f[tid + k * THREADS] =
            make_uint2(pack_bf16(to_f(p[0]), to_f(p[4])), pack_bf16(to_f(p[8]), to_f(p[12])));
      }
    };
    // the warp's items: item i = piece i % npc over group i / npc of each
    // stage, item i on warp i % WARPS; a warp with fewer than IW items
    // repeats one (its sums are never read), so that the step has no branch
    const int items = npc * sga;
    int icol[IW], igrp[IW];
#pragma unroll
    for (int k = 0; k < IW; ++k) {
      const int i = (warp + WARPS * k) % items;
      icol[k] = kPiece * (i % npc);
      igrp[k] = i / npc;
    }

    float acc[IW][NT][4];
#pragma unroll
    for (int k = 0; k < IW; ++k)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[k][nt][0] = acc[k][nt][1] = acc[k][nt][2] = acc[k][nt][3] = 0.f;

    for (int i = 0; i < RA - 1; ++i) {
      if (i < GS) issue_a(i, smem + i * sa.bytes);
      cp_async_commit();
    }
    cp_async_wait_dyn(RA - 2);
    __syncthreads();
    frag_a(smem);
    // slots of stage i (consumed), i + 1 (converted), i + RA - 1 (issued)
    int sc = 0, sf = 1 % RA, si = RA - 1;
    for (int i = 0; i < GS; ++i) {
      cp_async_wait_dyn(RA - 3);   // stage i + 1 has landed
      __syncthreads();             // stage i's B is in order; stage i - 1 is consumed
      if (i + RA - 1 < GS) issue_a(i + RA - 1, smem + si * sa.bytes);
      cp_async_commit();
      if (i + 1 < GS) frag_a(smem + sf * sa.bytes);
      const uint8_t* st = smem + sc * sa.bytes;
      sc = sc + 1 == RA ? 0 : sc + 1;
      sf = sf + 1 == RA ? 0 : sf + 1;
      si = si + 1 == RA ? 0 : si + 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < IW; ++k) {
          uint2 b[NT];
          load_b<NT>(b, st + sa.frag, 2 * igrp[k] + h, M, lane);
          piece_step<PACKED, MINS, NT>(acc[k], st, sa, cols_a, icol[k], a.gu_es, srows,
                                       a.zero, b, igrp[k], h, lane);
        }
      }
    }
    cp_async_wait_dyn(0);
    __syncthreads();   // every warp is done with the ring
    // the items' sums meet in shared memory:
    // exch[((group * npc + piece) * M + m) * 16 + column]
#pragma unroll
    for (int k = 0; k < IW; ++k) {
      const int i = warp + WARPS * k;
      if (i >= items) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = 8 * nt + 2 * t + hh;
          if (m < M) {
            float* e = exch + (i * M + m) * 16 + 2 * g;
            e[0] = acc[k][nt][hh];
            e[1] = acc[k][nt][2 + hh];
          }
        }
      }
    }
    __syncthreads();
    // g and u (the groups' sums added in group order), gated, rounded to
    // bf16, into the scratch in B's fragment order by 32-row group of I:
    // element ((group * 2 + b) * M + m) * 16 + t * 4 + r / 4 holds value
    // 16 b + r of row m, t = r % 4
    const int w16 = 16 * nu, gstride = npc * M * 16;
    for (int e = tid; e < M * w16; e += THREADS) {
      const int m = e / w16, c = e - m * w16, j = c >> 4, cc = c & 15;
      const float* pg = exch + (j * M + m) * 16 + cc;
      const float* pu = exch + ((nu + j) * M + m) * 16 + cc;
      float gv = pg[0], uv = pu[0];
      for (int q = 1; q < sga; ++q) {
        gv += pg[q * gstride];
        uv += pu[q * gstride];
      }
      const int col = i0 + c, ig = col >> 5, rr = col & 15, b = (col >> 4) & 1;
      a.gated[(((long long)ig * 2 + b) * M + m) * 16 + (rr & 3) * 4 + (rr >> 2)] =
          __float2bfloat16_rn(gv * (1.f / (1.f + expf(-gv))) * uv);
    }
    __syncthreads();   // exch is written again by the next pass
  }

  }

  // ---- phase B: tasks (column tile of y, split of I) over Wd
  const int cols_b = WARPS * kPiece, sgb = a.sg_b;
  const int tiles = (a.D + cols_b - 1) / cols_b;
  const int tasks = tiles * a.S, GI = a.I / 32, RB = a.ring_b;
  const StageMap sbm = stage_map(cols_b, PACKED, MINS, srows, a.dn_es, M, 0, sgb);
  int task = blockIdx.x, tile = 0, split = 0, c0 = 0, wc = 0, g0 = 0, n = 0, ns = 0;
  auto set_task = [&](int tk) {
    tile = tk / a.S;
    split = tk - tile * a.S;
    c0 = tile * cols_b;
    wc = min(cols_b, a.D - c0);
    g0 = (int)((long long)split * GI / a.S);
    n = (int)((long long)(split + 1) * GI / a.S) - g0;
    ns = (n + sgb - 1) / sgb;
  };
  // the tile's columns of row m from the task's sums (S = 1: y; else the
  // split's float32 partial, then the tile's last CTA adds the splits in
  // split order)
  auto tile_ticket = [&]() {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      unsigned int* tk = a.tickets + kBarrierWords + tile;
      last = atomicAdd(tk, 1u) == (unsigned)a.S - 1;
      if (last) atomicExch(tk, 0u);
    }
    __syncthreads();
    if (last) {
      __threadfence();
      XT* out = static_cast<XT*>(a.out);
      const int q4 = wc / 4;
      for (int e = tid; e < M * q4; e += THREADS) {
        const int m = e / q4, c = c0 + 4 * (e - m * q4);
        const float4 v = sum_splits4(a.partial + (long long)m * a.D + c, a.S, (long long)M * a.D);
        XT* o = out + (long long)m * a.D + c;
        store2(o, v.x, v.y);
        store2(o + 2, v.z, v.w);
      }
    }
  };

  if constexpr (NT == 1) {
    // M <= 8: the tile's 64-column blocks of Wd over the split's rows, as in
    // phase A (warp w: block w % nb of the tile over the groups of split
    // w / nb of the task's rows), with the task's rows of gated, staged once
    // a task, as B
    constexpr int RING = kStreamRing;
    uint2* gs = reinterpret_cast<uint2*>(smem + WARPS * RING * Stage<PACKED, MINS>::kBytes);
    uint8_t* ring = smem + warp * RING * Stage<PACKED, MINS>::kBytes;
    int nbt = 1, kst = 1, s0 = 0, n0 = 0;
    auto copy_b = [&](int b, int kg) {
      const int es = a.dn_es, lim = c0 + wc;
      const int qc = c0 + kWarpCols * b + 16 * (lane & 3);
      const int sc = c0 + kWarpCols * b + (lane % (4 * es)) * (16 / es);
      const int mc = c0 + kWarpCols * b + (lane & 15) * 4;
      return lane_copy<PACKED, MINS>(
          a.down.q + (qc < lim ? qc : 0), qc < lim, a.D,
          static_cast<const uint8_t*>(a.down.s) + (long long)(sc < lim ? sc : 0) * es, sc < lim,
          (long long)a.D * es,
          MINS ? reinterpret_cast<const uint8_t*>(a.down.m + (mc < lim ? mc : 0)) : a.down.q,
          MINS && mc < lim, (long long)a.D * 4, es, srows, g0 + kg, lane);
    };
    auto start = [&](int tk) {
      set_task(tk);
      nbt = (wc + kWarpCols - 1) / kWarpCols;
      kst = max(1, WARPS / nbt);
      s0 = warp / nbt;
      n0 = s0 < kst ? (n - s0 + kst - 1) / kst : 0;
    };
    // the first task's first stages of Wd are in flight during the barrier
    if (task < tasks) {
      start(task);
      if (n0 > 0) stream_prologue<PACKED, MINS>(ring, copy_b(warp % nbt, s0), n0, kst, lane);
    }
    grid_barrier(a.tickets);
    for (bool first = true; task < tasks; task += a.P, first = false) {
      if (!first) start(task);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(a.gated) + (long long)g0 * 64 * M;
      for (int e = tid; e < 4 * M * n; e += THREADS)
        cp_async16(reinterpret_cast<uint8_t*>(gs) + 16 * e, src + 16 * e, true);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();   // the task's rows of gated are in
      float acc[4][4] = {};
      if (n0 > 0)
        stream_block<PACKED, MINS>(acc, ring, copy_b(warp % nbt, s0), n0, s0, kst, gs, M,
                                   a.dn_es, a.group, a.zero, lane, first);
      __syncthreads();   // every warp is done with the rings and gated
      if (s0 < kst) stream_exchange(exch, acc, warp, M, lane);   // zeros where a split is empty
      __syncthreads();
      for (int e = tid; e < M * wc; e += THREADS) {
        const int m = e / wc, c = e - m * wc;
        const float v = stream_sum(exch, nbt, kst, M, m, c);
        if (a.S == 1)
          static_cast<XT*>(a.out)[(long long)m * a.D + c0 + c] = from_float<XT>(v);
        else
          a.partial[((long long)split * M + m) * a.D + c0 + c] = v;
      }
      if (a.S > 1) tile_ticket();
      __syncthreads();   // `last`, exch and the rings are used again by the next task
    }
  } else {
  // stage s of the task (I groups g0 + s * sg_b ..) into slot st: the
  // values, scales and mins of Wd (what & 1) and gated's fragments (what & 2);
  // a thread's chunks are the same in every stage
  const int vrow = tid / TPR, vc = tid % TPR;
  const int sbch = cols_b * a.dn_es / 16, mbch = cols_b / 4;   // chunks of a full row
  const int se = tid / sbch, sc2 = tid - se * sbch, me = tid / mbch, mc2 = tid - me * mbch;
  auto issue_b = [&](int s, uint8_t* st, int what) {
    const int kg0 = g0 + s * sgb, ng = min(sgb, g0 + n - kg0);
    if (what & 1) {
      if (16 * vc < wc) {
        const uint8_t* src = a.down.q + (long long)(kg0 * ROWS + vrow) * a.D + c0 + 16 * vc;
        for (int gi = 0; gi < ng; ++gi)
          cp_async16(st + (gi * ROWS + vrow) * sbm.pitch + 16 * vc,
                     src + (long long)gi * ROWS * a.D, true);
      }
      if (se < ng * srows && 16 * sc2 < wc * a.dn_es)
        cp_async16(st + sbm.scales + se * cols_b * a.dn_es + 16 * sc2,
                   static_cast<const uint8_t*>(a.down.s) +
                       ((long long)(kg0 * srows + se) * a.D + c0) * a.dn_es + 16 * sc2, true);
      if (MINS && me < ng * srows && 16 * mc2 < wc * 4)
        cp_async16(st + sbm.mins + me * cols_b * 4 + 16 * mc2,
                   reinterpret_cast<const uint8_t*>(a.down.m) +
                       ((long long)(kg0 * srows + me) * a.D + c0) * 4 + 16 * mc2, true);
    }
    if (what & 2) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(a.gated) + (long long)kg0 * 64 * M;
      for (int e = tid; e < 4 * M * ng; e += THREADS)
        cp_async16(st + sbm.frag + 16 * e, src + 16 * e, true);
    }
  };

  // the first task's first stages of Wd are in flight during the barrier
  if (task < tasks) {
    set_task(task);
    for (int i = 0; i < RB - 1; ++i) {
      if (i < ns) issue_b(i, smem + i * sbm.bytes, 1);
      cp_async_commit();
    }
  }
  grid_barrier(a.tickets);

  for (bool first = true; task < tasks; task += a.P, first = false) {
    set_task(task);
    for (int i = 0; i < RB - 1; ++i) {
      if (i < ns) issue_b(i, smem + i * sbm.bytes, first ? 2 : 3);
      cp_async_commit();
    }
    if (first) cp_async_wait_dyn(0);
    float acc[2][NT][4];   // the two k16 steps of a group: two chains, added at the end
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[h][nt][0] = acc[h][nt][1] = acc[h][nt][2] = acc[h][nt][3] = 0.f;
    const bool mine = kPiece * warp < wc;
    int sc = 0, si = RB - 1;   // slots of stage i (consumed) and i + RB - 1 (issued)
    for (int i = 0; i < ns; ++i) {
      cp_async_wait_dyn(RB - 2);   // stage i has landed
      __syncthreads();             // everyone's copies of it; stage i - 1 is consumed
      if (i + RB - 1 < ns) issue_b(i + RB - 1, smem + si * sbm.bytes, 3);
      cp_async_commit();
      const uint8_t* st = smem + sc * sbm.bytes;
      sc = sc + 1 == RB ? 0 : sc + 1;
      si = si + 1 == RB ? 0 : si + 1;
      if (mine) {
        const int ng = min(sgb, n - i * sgb);
        for (int gi = 0; gi < ng; ++gi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint2 b[NT];
            load_b<NT>(b, st + sbm.frag, 2 * gi + h, M, lane);
            piece_step<PACKED, MINS, NT>(acc[h], st, sbm, cols_b, kPiece * warp, a.dn_es,
                                         srows, a.zero, b, gi, h, lane);
          }
        }
      }
    }
    cp_async_wait_dyn(0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] += acc[1][nt][e];
    const int col = c0 + kPiece * warp + 2 * g;
    if (a.S == 1) {
      XT* out = static_cast<XT*>(a.out);
      if (mine) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = 8 * nt + 2 * t + hh;
            if (m < M) store2(out + (long long)m * a.D + col, acc[0][nt][hh], acc[0][nt][2 + hh]);
          }
        }
      }
      __syncthreads();   // the ring is filled again by the next task
      continue;
    }
    if (mine) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = 8 * nt + 2 * t + hh;
          if (m < M)
            store2(a.partial + ((long long)split * M + m) * a.D + col, acc[0][nt][hh],
                   acc[0][nt][2 + hh]);
        }
      }
    }
    tile_ticket();
    __syncthreads();   // `last` and the ring are used again by the next task
  }
  }
  cp_async_wait_dyn(0);   // no copy outlives its thread
}

// what the plan's rings (or the exchange over them) take of a CTA's shared
// memory
template <typename XT, bool PACKED, bool MINS, int NT>
int coop_smem(const CoopArgs& a) {
  const int srows = 32 / a.group;
  const StageMap sb = stage_map(coop_warps(NT) * kPiece, PACKED, MINS, srows, a.dn_es, a.M, 0,
                                a.sg_b);
  if constexpr (NT == 1) {   // the warps' rings and x or a split's gated, or the exchange
    using St = Stage<PACKED, MINS>;
    const int rings = coop_warps(NT) * kStreamRing * St::kBytes;
    const int rows = 2 * a.M * max(a.K, 32 * ((a.I / 32 + a.S - 1) / a.S));
    return max(rings + rows, coop_warps(NT) * a.M * kWarpCols * 4);
  } else {
    const StageMap sa = stage_map(2 * kPiece * a.units_a, PACKED, MINS, srows, a.gu_es, a.M,
                                  (int)sizeof(XT), a.sg_a);
    return max(max(a.ring_a * sa.bytes, a.ring_b * sb.bytes),
               a.sg_a * 2 * kPiece * a.units_a * a.M * 4);
  }
}

template <typename XT, bool PACKED, bool MINS, int NT>
cudaError_t launch_coop(const CoopArgs& a, cudaStream_t st) {
  const int tiles = (a.D + coop_warps(NT) * kPiece - 1) / (coop_warps(NT) * kPiece);
  const int smem = coop_smem<XT, PACKED, MINS, NT>(a);
  const int items = 2 * a.units_a * a.sg_a;   // every item of a pass has a warp
  if (smem > coop_smem_cap(NT) || kBarrierWords + tiles > kMaxTickets ||
      (NT > 1 && items > coop_warps(NT) * coop_items(NT)))
    return cudaErrorInvalidValue;
  auto kern = swiglu_coop_kernel<XT, PACKED, MINS, NT>;
  const cudaError_t attr =
      allow_smem<swiglu_coop_kernel<XT, PACKED, MINS, NT>>(coop_smem_cap(NT));
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P);
  cfg.blockDim = dim3(coop_warps(NT) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, a);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// the checks of the plan's numbers every row count takes; then those of the
// shared-ring path above 8 rows
inline cudaError_t coop_check(const CoopArgs& a) {
  const int U = a.I / kPiece;
  if (a.P < 1 || a.S < 1 || a.S > a.I / 32 || (a.S > 1) != (a.partial != nullptr) ||
      a.tickets == nullptr || a.gated == nullptr)
    return cudaErrorInvalidValue;
  if (a.M <= 8)   // at most one 64-column block a warp
    return ((U + a.P - 1) / a.P + 1) / 2 > coop_warps(1) ? cudaErrorInvalidValue : cudaSuccess;
  const int xes = a.x_bf16 ? 2 : 4;
  if (a.units_a < 1 || a.units_a > kMaxUnits || a.ring_a < 3 || a.sg_a < 1 || a.sg_a > 4 ||
      a.ring_b < 3 || a.sg_b < 1 || a.sg_b > 4 || (a.K / 32) % a.sg_a || a.sg_a * a.M > 128 ||
      a.sg_a * a.M * xes > 512)
    return cudaErrorInvalidValue;
  // every pass of every CTA fits the ring's slots
  const int owned[2] = {U / a.P, (U + a.P - 1) / a.P};
  for (const int nu : owned) {
    const int rounds = (nu + kMaxUnits - 1) / kMaxUnits;
    if (rounds > 0 && (nu + rounds - 1) / rounds > a.units_a) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the launch at NT n-tiles of 8 rows, for x's type and the weights' flavour
template <int NT>
cudaError_t coop_launch(const CoopArgs& a, bool packed, bool mins, cudaStream_t st) {
  const cudaError_t rc = coop_check(a);
  if (rc != cudaSuccess) return rc;
#define COOP(XT, PACKED, MINS) launch_coop<XT, PACKED, MINS, NT>(a, st)
  if (a.x_bf16)
    return packed ? (mins ? COOP(__nv_bfloat16, true, true) : COOP(__nv_bfloat16, true, false))
                  : (mins ? COOP(__nv_bfloat16, false, true) : COOP(__nv_bfloat16, false, false));
  return packed ? (mins ? COOP(float, true, true) : COOP(float, true, false))
                : (mins ? COOP(float, false, true) : COOP(float, false, false));
#undef COOP
}

// the C entries' arguments as CoopArgs (fast mode); false where they are
// not a launch the kernel takes
inline bool coop_args(CoopArgs& a, const void* x, const void* gq, const void* gs,
                      const void* gm, const void* uq, const void* us, const void* um,
                      const void* dq, const void* ds, const void* dm, void* out, void* scratch,
                      void* partial, void* tickets, int M, int K, int I, int D,
                      long long ld_gu, const int* plan, int group, int x_bf16, int gu_s_f16,
                      int dn_s_f16, int packed, int off) {
  const bool mins = gm != nullptr;
  if (M < 1 || M > 64 || K % 32 || I % 32 || D % 16 || ld_gu % 16 || plan == nullptr ||
      (group != 16 && group != 32) || (packed && group != 32) || (um != nullptr) != mins ||
      (dm != nullptr) != mins || (off != 0 && off != 8))
    return false;
  const Weight gate{static_cast<const uint8_t*>(gq), gs, static_cast<const float*>(gm)};
  const Weight up{static_cast<const uint8_t*>(uq), us, static_cast<const float*>(um)};
  const Weight down{static_cast<const uint8_t*>(dq), ds, static_cast<const float*>(dm)};
  a = CoopArgs{x, gate, up, down, ld_gu, gu_s_f16 ? 2 : 4, dn_s_f16 ? 2 : 4, out,
               static_cast<__nv_bfloat16*>(scratch), static_cast<float*>(partial),
               static_cast<unsigned int*>(tickets), M, K, I, D, group, x_bf16,
               plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6],
               zero_point(packed != 0, off)};
  return true;
}

}  // namespace
