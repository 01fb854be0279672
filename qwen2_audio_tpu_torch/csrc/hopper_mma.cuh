// Hopper (sm_90a) building blocks of the large-M quantized matmul tiles in
// quant_matmul.cu and quant_matmul_int8.cu and of the bf16 attention tile in
// attention_single.cu: mbarriers, TMA tile loads and the host-side tensor
// map, cp.async with zero fill, wgmma descriptors and the wgmma shapes the
// tiles issue (m64n128k16 bf16 -> f32 from shared memory, m64n64k16 and
// m64n128k16 bf16 -> f32 with A from registers and B MN-major, m64nNk16
// bf16 and f16 -> f32 with A from registers and B K-major), setmaxnreg, and
// the 128-byte swizzle the operands are stored in.
//
// Operand layout: every shared-memory wgmma operand here has a 128-byte
// swizzle. A tile of R rows holds 128 bytes per row (64 bf16 or 128 s8
// values); the 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) *
// 16). TMA writes tiles in this layout (CU_TENSOR_MAP_SWIZZLE_128B); the
// transform warpgroups write the weight tiles in it by hand (swizzle_chunk).
// - K-major (wgmma_desc): a row holds 64 values of K. One wgmma reads 32
//   bytes of K per row, so the k-th step within a tile is the descriptor
//   of the tile plus 32 * k bytes.
// - MN-major (wgmma_desc_mn, the attention tile's V): a row holds 64 values
//   of N and rows walk K, 8 rows (1024 bytes) to an atom. One k16 step is
//   two atoms, so the k-th step is the descriptor plus 2048 * k bytes; a
//   second block of 64 values of N lies `lbo` bytes after the first.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qa {

constexpr int kSwizzleRow = 128;    // bytes of K per operand row
constexpr int kSwizzleAtom = 1024;  // 8 rows: the unit that repeats

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk c (16 bytes) of row r in a swizzled operand tile
__device__ __forceinline__ uint32_t swizzle_chunk(int r, int c) {
  return (uint32_t)(r * kSwizzleRow + ((c ^ (r & 7)) << 4));
}

// ---- mbarriers ---------------------------------------------------------- //

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// returns once the phase of parity `parity` has completed; a wait of more
// than 20 s (a pipeline fault, never a real wait) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (++spins & 4095) == 0) {
      const uint64_t now = globaltimer_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 20000000000ull)
        __trap();
    }
  } while (!done);
}

// ---- TMA and cp.async --------------------------------------------------- //

// a 3-D box at (c0 inner, c1, c2) into shared memory; completes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 2-D box at (c0 inner, c1 outer) into shared memory; completes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes, or zeros where ok is false (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// arrives on bar once every cp.async this thread has issued so far has
// landed (the arrival is counted in bar's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// returns once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// named barrier id (1..15) among count threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive at named barrier id (1..15) of count threads without waiting
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// shared-memory writes of this thread made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 matrices of 16-bit values, transposed: lane l gives the
// address of row l % 8 of matrix l / 8, and r[i] holds, of matrix i, rows
// 2 (lane % 4) and 2 (lane % 4) + 1 of column lane / 4 (low half first)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// a 4-D box at (c0 inner, c1, c2, c3) into shared memory; completes on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------- //

// descriptor of a K-major, 128-byte-swizzled tile at p (1024-byte aligned):
// stride between 8-row atoms 1024 bytes, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(kSwizzleAtom >> 4) << 32) |
         (1ull << 62);
}

// descriptor of an MN-major, 128-byte-swizzled tile at p (1024-byte
// aligned): rows of 128 bytes (64 values of N) walk K, atoms of 8 rows are
// 1024 bytes apart (the stride byte offset), and the next 64 values of N lie
// lbo bytes on (the leading byte offset; unused where N is 64)
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(kSwizzleAtom >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving a register that a wgmma is writing or reading
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define QA_R8(T, d, i)                                                                     \
  T(d[i]), T(d[i + 1]), T(d[i + 2]), T(d[i + 3]), T(d[i + 4]), T(d[i + 5]), T(d[i + 6]), \
      T(d[i + 7])
#define QA_R32(T, d) QA_R8(T, d, 0), QA_R8(T, d, 8), QA_R8(T, d, 16), QA_R8(T, d, 24)
#define QA_R64(T, d)                                                                      \
  QA_R8(T, d, 0), QA_R8(T, d, 8), QA_R8(T, d, 16), QA_R8(T, d, 24), QA_R8(T, d, 32),      \
      QA_R8(T, d, 40), QA_R8(T, d, 48), QA_R8(T, d, 56)
#define QA_OPS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define QA_OPS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= a (64 x 16 bf16) * b (16 x 128 bf16), both
// K-major in shared memory; d is added to where accumulate is not 0
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QA_OPS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : QA_R64("+f", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += a (64 x 16 bf16, the register fragment: a[0..3]
// rows g and g + 8 of the warp's 16, values 2 t4, 2 t4 + 1 and + 8) * b
// (16 x 64 bf16), b MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " QA_OPS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : QA_R32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, float32) += a (64 x 16 bf16, registers) * b (16 x 128 bf16,
// MN-major in shared memory)
__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QA_OPS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : QA_R64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N, float32) (+)= a (64 x 16 bf16 or f16, the register fragment,
// as for wgmma_bf16_rs_n64) * b (16 x N of the same type, K-major in shared
// memory: no transpose), N 8, 16, 32, 64, 128, 192 or 256; d is added to where
// accumulate is not 0. wgmma_bf16_rs_k and wgmma_f16_rs_k, one text.
#define QA_RS_K_DECL(NAME, N)                                                            \
  template <>                                                                            \
  __device__ __forceinline__ void NAME<N>(float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, \
                                          int accumulate)
#define QA_RS_K(NAME, TY)                                                                 \
  template <int N>                                                                        \
  __device__ __forceinline__ void NAME(float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, \
                                       int accumulate);                                  \
  QA_RS_K_DECL(NAME, 8) {                                                                 \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"                                      \
        "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "                        \
        "{%0, %1, %2, %3}"                                                                \
        ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"                                        \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 16) {                                                                \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                     \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                       \
        "{%0, %1, %2, %3, %4, %5, %6, %7}"                                                \
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"                                     \
        : QA_R8("+f", d, 0)                                                               \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 32) {                                                                \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                     \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                       \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"          \
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"                                   \
        : QA_R8("+f", d, 0), QA_R8("+f", d, 8)                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 64) {                                                                \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                       \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}" \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                   \
        : QA_R8("+f", d, 0), QA_R8("+f", d, 8), QA_R8("+f", d, 16), QA_R8("+f", d, 24)    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 128) {                                                               \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                     \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                      \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}" \
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                                   \
        : QA_R8("+f", d, 0), QA_R8("+f", d, 8), QA_R8("+f", d, 16), QA_R8("+f", d, 24),   \
          QA_R8("+f", d, 32), QA_R8("+f", d, 40), QA_R8("+f", d, 48), QA_R8("+f", d, 56)  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 192) {                                                               \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                                    \
        "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " "                      \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}" \
        ", {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"                                  \
        : QA_R8("+f", d, 0), QA_R8("+f", d, 8), QA_R8("+f", d, 16), QA_R8("+f", d, 24),   \
          QA_R8("+f", d, 32), QA_R8("+f", d, 40), QA_R8("+f", d, 48), QA_R8("+f", d, 56), \
          QA_R8("+f", d, 64), QA_R8("+f", d, 72), QA_R8("+f", d, 80), QA_R8("+f", d, 88)  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }                                                                                       \
  QA_RS_K_DECL(NAME, 256) {                                                               \
    asm volatile(                                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                    \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "                      \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
        "%124, %125, %126, %127}"                                                         \
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"                              \
        : QA_R8("+f", d, 0), QA_R8("+f", d, 8), QA_R8("+f", d, 16), QA_R8("+f", d, 24),   \
          QA_R8("+f", d, 32), QA_R8("+f", d, 40), QA_R8("+f", d, 48), QA_R8("+f", d, 56), \
          QA_R8("+f", d, 64), QA_R8("+f", d, 72), QA_R8("+f", d, 80), QA_R8("+f", d, 88), \
          QA_R8("+f", d, 96), QA_R8("+f", d, 104), QA_R8("+f", d, 112), QA_R8("+f", d, 120) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
  }

QA_RS_K(wgmma_bf16_rs_k, "bf16")
QA_RS_K(wgmma_f16_rs_k, "f16")

#undef QA_RS_K
#undef QA_RS_K_DECL
#undef QA_OPS32
#undef QA_OPS64
#undef QA_R32
#undef QA_R64
#undef QA_R8

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- the host side ------------------------------------------------------ //

// raises Kernel's dynamic shared memory limit to bytes, once per device
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < 64 && done[dev])) return rc;
  rc = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess && dev < 64) done[dev] = true;
  return rc;
}

// cuTensorMapEncodeTiled is a driver function: reached through the runtime,
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor of up to 4 dimensions, innermost first: dims[i] values with
// strides[i] bytes from one index of dimension i + 1 to the next, read in
// boxes of box[i] values, with or without the 128-byte swizzle; values out
// of range read as zero.
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                     const long long* dims, const long long* strides, const int* box,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || rank < 1 || rank > 4) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], es[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    es[i] = 1;
    if (i + 1 < rank) st[i] = (cuuint64_t)strides[i];
  }
  return fn(map, type, rank, const_cast<void*>(base), d, st, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                     const long long* dims, const long long* strides, const int* box,
                     bool swizzle128) {
  return make_map(map, base, type, rank, dims, strides, box,
                  swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// a row-major (rows, cols) matrix with rows ld values apart
inline bool make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                        int elem, long long rows, long long cols, long long ld, int box_cols,
                        int box_rows, CUtensorMapSwizzle swizzle) {
  const long long dims[2] = {cols, rows}, strides[1] = {ld * elem};
  const int box[2] = {box_cols, box_rows};
  return make_map(map, base, type, 2, dims, strides, box, swizzle);
}
inline bool make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                        int elem, long long rows, long long cols, long long ld, int box_cols,
                        int box_rows, bool swizzle128) {
  return make_map_2d(map, base, type, elem, rows, cols, ld, box_cols, box_rows,
                     swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace qa
