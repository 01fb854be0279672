// Fused log-mel frames for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel qwen2_audio_tpu/ops/mel_kernel.py::_mel_kernel.
// out[f, m] = log10(max(sum_b |X_f[b]|^2 * filt[m, b], 1e-10)), X_f the
// 400-point DFT of frame f = window * padded[160 f : 160 f + 400], bins
// b = 0..200.
//
// What bounds it: the function's least work at 30 s (3002 frames, 128 mels)
// is a real FFT per frame plus the filterbank's nonzeros, about 31 MFLOP,
// on 3.56 MB of signal, filterbank and output: bytes bound it, at 1.06 us
// at 3.35 TB/s. One launch costs more than that, so what is left to win is
// latency: fill every SM at once, keep each frame's chain of dependent steps
// short, and touch device memory once. This design does 10546 float32
// operations a frame for the FFT (ops/mel_kernel.py FFT_FLOPS_PER_FRAME,
// 31.7 MFLOP at 3002 frames) and 2 per filterbank weight inside the mels'
// ranges, against 1.12 GFLOP for the dense DFT it replaces. Float32
// throughout, no TF32 or bf16 tensor cores: the global max - 8 clamp
// downstream moves with any rounding of the loudest frame.
//
// Design:
// - One warp per frame, kWarps = 8 frames a CTA: 376 CTAs at 3002 frames,
//   2.8 per SM of 132. The CTA's overlapping sample span ((8 - 1) * 160 +
//   400 floats) and the tables (window and twiddles, 4.8 KB) are staged in
//   shared memory with 16-byte loads; that is the CTA's one block barrier.
// - The 400 windowed real samples of a frame are packed as 200 complex ones,
//   z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1], transformed by a 200-point FFT
//   of radices 8 x 5 x 5 (decimation in time, n = 25 n1 + n2, then n2 = 5 m1
//   + m2), and split into the 201 real bins by one pass: X[k] = (E - i
//   W400^k D) / 2, E = Z[k] + conj Z[200 - k], D = Z[k] - conj Z[200 - k].
//   The passes are warp-local (__syncwarp), in place in the warp's 200
//   complex slots of shared memory; the twiddles come from the host's
//   float64 values rounded once (ops/mel_kernel.py fft_table).
// - The power spectrum stays in shared memory; a lane takes mels lane,
//   lane + 32, ... and sums only the bins of the mel's range [lo, hi) with
//   the weights inside it, so a triangular bank costs its nonzeros and any
//   bank stays exact. The ranges, and the weights where they fit in kMaxW
//   floats, are staged in shared memory with the samples, so that no
//   dependent global load sits in a frame's chain; a larger bank's weights
//   are read through the L1.

#include <cuda_runtime.h>

namespace {

constexpr int kHop = 160;
constexpr int kNFFT = 400;
constexpr int kHalf = 200;      // complex points of the packed frame
constexpr int kBins = 201;
constexpr int kWarps = 8;       // frames per CTA, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kSpan = (kWarps - 1) * kHop + kNFFT;   // 1520, a multiple of 4
constexpr int kMaxMel = 128;
// the table's layout (ops/mel_kernel.py TAB_*): window, W200^j, W400^k
constexpr int kTabWin = 0, kTabTw200 = 400, kTabTw400 = 800, kTabLen = 1204;
constexpr int kPow = 204;       // a warp's power spectrum, padded
// filterbank weights staged in shared memory: a Slaney bank has at most 402
// (a bin lies in at most two triangles); 34 KB a CTA keeps 6 CTAs on an SM
constexpr int kMaxW = 512;

struct Smem {
  float4 x[kSpan / 4];
  float4 tab[kTabLen / 4];
  float2 z[kWarps][kHalf];
  float p[kWarps][kPow];
  int4 ranges[kMaxMel];
  float w[kMaxW];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// forward DFTs, exp(-2 pi i jk / n)
__device__ __forceinline__ void dft4(float2 a0, float2 a1, float2 a2, float2 a3,
                                     float2 (&y)[4]) {
  const float2 s0 = cadd(a0, a2), s1 = csub(a0, a2), s2 = cadd(a1, a3), s3 = csub(a1, a3);
  y[0] = cadd(s0, s2);
  y[2] = csub(s0, s2);
  y[1] = make_float2(s1.x + s3.y, s1.y - s3.x);   // s1 - i s3
  y[3] = make_float2(s1.x - s3.y, s1.y + s3.x);   // s1 + i s3
}

__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  constexpr float r = 0.70710678118654752f;
  float2 e[4], o[4];
  dft4(a[0], a[2], a[4], a[6], e);
  dft4(a[1], a[3], a[5], a[7], o);
  // W8^k o[k], W8 = exp(-i pi / 4)
  const float2 o1 = make_float2(r * (o[1].x + o[1].y), r * (o[1].y - o[1].x));
  const float2 o2 = make_float2(o[2].y, -o[2].x);
  const float2 o3 = make_float2(r * (o[3].y - o[3].x), -r * (o[3].x + o[3].y));
  a[0] = cadd(e[0], o[0]);
  a[4] = csub(e[0], o[0]);
  a[1] = cadd(e[1], o1);
  a[5] = csub(e[1], o1);
  a[2] = cadd(e[2], o2);
  a[6] = csub(e[2], o2);
  a[3] = cadd(e[3], o3);
  a[7] = csub(e[3], o3);
}

__device__ __forceinline__ void dft5(float2 (&a)[5]) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;   // cos 2pi/5, 4pi/5
  constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;    // sin 2pi/5, 4pi/5
  const float2 t1 = cadd(a[1], a[4]), t2 = cadd(a[2], a[3]);
  const float2 t3 = csub(a[1], a[4]), t4 = csub(a[2], a[3]);
  const float2 b1 = make_float2(a[0].x + c1 * t1.x + c2 * t2.x, a[0].y + c1 * t1.y + c2 * t2.y);
  const float2 b2 = make_float2(a[0].x + c2 * t1.x + c1 * t2.x, a[0].y + c2 * t1.y + c1 * t2.y);
  const float2 d1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 d2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  a[0] = make_float2(a[0].x + t1.x + t2.x, a[0].y + t1.y + t2.y);
  a[1] = make_float2(b1.x + d1.y, b1.y - d1.x);   // b1 - i d1
  a[4] = make_float2(b1.x - d1.y, b1.y + d1.x);   // b1 + i d1
  a[2] = make_float2(b2.x + d2.y, b2.y - d2.x);   // b2 - i d2
  a[3] = make_float2(b2.x - d2.y, b2.y + d2.x);   // b2 + i d2
}

// where Z[k] lies after pass 3: k = k1 + 8 j1 + 40 j2 at 25 k1 + 5 j1 + j2
__device__ __forceinline__ int slot(int k) { return 25 * (k & 7) + 5 * ((k >> 3) % 5) + k / 40; }

__global__ void __launch_bounds__(kThreads)
mel_log_frames_kernel(const float* __restrict__ padded, long long n_padded,
                      const float* __restrict__ tab, const int4* __restrict__ ranges,
                      const float* __restrict__ weights, int n_weights,
                      float* __restrict__ out, int n_frames, int n_mel) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long f0 = (long long)blockIdx.x * kWarps;
  const long long s0 = f0 * kHop;   // a multiple of 4 floats

  for (int i = tid; i < kSpan / 4; i += kThreads) {
    const long long j = s0 + 4 * i;
    float4 v;
    if (j + 4 <= n_padded) {
      v = __ldg(reinterpret_cast<const float4*>(padded + j));
    } else {
      v.x = j < n_padded ? padded[j] : 0.f;
      v.y = j + 1 < n_padded ? padded[j + 1] : 0.f;
      v.z = j + 2 < n_padded ? padded[j + 2] : 0.f;
      v.w = 0.f;
    }
    sm.x[i] = v;
  }
  for (int i = tid; i < kTabLen / 4; i += kThreads)
    sm.tab[i] = __ldg(reinterpret_cast<const float4*>(tab) + i);
  for (int i = tid; i < n_mel; i += kThreads) sm.ranges[i] = __ldg(ranges + i);
  const bool w_staged = n_weights <= kMaxW;
  if (w_staged)
    for (int i = tid; i < n_weights; i += kThreads) sm.w[i] = __ldg(weights + i);
  __syncthreads();

  const long long frame = f0 + warp;
  if (frame >= n_frames) return;
  const float* x = reinterpret_cast<const float*>(sm.x) + warp * kHop;
  const float* t = reinterpret_cast<const float*>(sm.tab);
  const float2* win = reinterpret_cast<const float2*>(t + kTabWin);
  const float2* w200 = reinterpret_cast<const float2*>(t + kTabTw200);
  const float2* w400 = reinterpret_cast<const float2*>(t + kTabTw400);
  float2* z = sm.z[warp];
  float* p = sm.p[warp];

  // pass 1: lane n2 < 25 takes z[25 n1 + n2], n1 = 0..7, through the radix-8
  // DFT over n1, times W200^(n2 k1), into z[25 k1 + n2]
  if (lane < 25) {
    float2 a[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const float2 xv = *reinterpret_cast<const float2*>(x + 50 * n1 + 2 * lane);
      const float2 wv = win[25 * n1 + lane];
      a[n1] = make_float2(xv.x * wv.x, xv.y * wv.y);
    }
    dft8(a);
    z[lane] = a[0];
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) z[25 * k1 + lane] = cmul(a[k1], w200[lane * k1]);
  }
  __syncwarp();
  // pass 2: the 25-point DFT over n2 = 5 m1 + m2 of each k1 as 5 x 5: the
  // radix-5 DFT over m1 of each (k1, m2), times W25^(m2 j1) = W200^(8 m2 j1),
  // in place
  for (int job = lane; job < 40; job += 32) {
    float2* r = z + 25 * (job / 5) + job % 5;
    const int m2 = job % 5;
    float2 a[5];
#pragma unroll
    for (int m1 = 0; m1 < 5; ++m1) a[m1] = r[5 * m1];
    dft5(a);
    r[0] = a[0];
#pragma unroll
    for (int j1 = 1; j1 < 5; ++j1) r[5 * j1] = cmul(a[j1], w200[8 * m2 * j1]);
  }
  __syncwarp();
  // pass 3: the radix-5 DFT over m2 of each (k1, j1), job = 5 k1 + j1, in
  // place: Z[k1 + 8 j1 + 40 j2] lands at 25 k1 + 5 j1 + j2
  for (int job = lane; job < 40; job += 32) {
    float2* r = z + 5 * job;
    float2 a[5];
#pragma unroll
    for (int m2 = 0; m2 < 5; ++m2) a[m2] = r[m2];
    dft5(a);
#pragma unroll
    for (int j2 = 0; j2 < 5; ++j2) r[j2] = a[j2];
  }
  __syncwarp();
  // the real split and the power of bins 0..200
  for (int k = lane; k < kBins; k += 32) {
    const float2 zk = z[slot(k == kHalf ? 0 : k)];
    const float2 zr = z[slot(k == 0 ? 0 : kHalf - k)];   // conj Z[200 - k] below
    const float2 e = make_float2(zk.x + zr.x, zk.y - zr.y);
    const float2 d = make_float2(zk.x - zr.x, zk.y + zr.y);
    const float2 wd = cmul(d, w400[k]);
    const float xr = e.x + wd.y, xi = e.y - wd.x;   // e - i wd
    p[k] = 0.25f * (xr * xr + xi * xi);
  }
  __syncwarp();

  const float* w = w_staged ? sm.w : weights;
  float* o = out + frame * n_mel;
  for (int m = lane; m < n_mel; m += 32) {
    const int4 r = sm.ranges[m];
    float acc = 0.f;
    for (int b = r.x; b < r.y; ++b) acc = fmaf(p[b], w[r.z + (b - r.x)], acc);
    o[m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// padded: (n_padded,) float32, 16-byte aligned, n_padded >= (n_frames - 1) *
// 160 + 400; tab: (1204,) float32, ops/mel_kernel.py fft_table(), 16-byte
// aligned; ranges: (n_mel, 4) int32 (lo, hi, offset, 0), 0 <= lo <= hi <=
// 201; weights: (n_weights,) float32, weights[offset + b - lo] the
// filterbank's (m, b); out: (n_frames, n_mel), n_mel <= 128. Returns
// cudaGetLastError() after the launch.
extern "C" int qa_mel_log_frames(const float* padded, long long n_padded, const float* tab,
                                 const int* ranges, const float* weights, int n_weights,
                                 float* out, int n_frames, int n_mel, void* stream) {
  if (n_mel < 1 || n_mel > kMaxMel || n_frames < 1 || n_weights < 1 ||
      n_padded < (long long)(n_frames - 1) * kHop + kNFFT ||
      reinterpret_cast<unsigned long long>(padded) % 16 ||
      reinterpret_cast<unsigned long long>(tab) % 16 ||
      reinterpret_cast<unsigned long long>(ranges) % 16)
    return (int)cudaErrorInvalidValue;
  const int grid = (n_frames + kWarps - 1) / kWarps;
  mel_log_frames_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      padded, n_padded, tab, reinterpret_cast<const int4*>(ranges), weights, n_weights, out,
      n_frames, n_mel);
  return (int)cudaGetLastError();
}
