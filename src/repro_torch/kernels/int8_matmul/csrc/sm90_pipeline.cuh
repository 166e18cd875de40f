// Hopper (sm_90a) building blocks of a TMA-fed wgmma pipeline: mbarriers,
// 2-D TMA tile loads, shared-memory matrix descriptors and the int8
// warpgroup MMA (s8 x s8 -> s32) at the token widths the W8A8 kernel
// uses.  PTX as in the PTX ISA 8.x; descriptor fields and the integer
// wgmma atoms as CUTLASS lays them out (cute/arch/mma_sm90_desc.hpp,
// cute/arch/mma_sm90_gmma.hpp, the SM90_64xNx32_S32S8S8_SS_TN atoms).
#pragma once

#include <cuda.h>   // CUtensorMap (types only; libcuda is not linked)
#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// spins until the phase of parity ``parity`` has completed (a fresh
// barrier is in phase 0, so waiting on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box of ``map`` at (c0 innermost, c1) into ``dst``, completing on
// ``bar``; elements past the tensor's edge arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- distributed shared memory ------------------------------------------

// the shared::cluster address of the same offset in block ``rank``
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes at a shared::cluster address (another block's shared memory)
__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a K-major tile written by TMA with 128-byte swizzle:
// rows of 128 K bytes, 8-row groups 1024 bytes apart (stride byte offset),
// the leading byte offset unused for this layout (1, as CUTLASS sets it),
// layout type 1 = SWIZZLE_128B.  The tile must be 1024-byte aligned; a
// k32 step within the 128-byte row adds 32 bytes (2 units) to the start.
__device__ __forceinline__ uint64_t desc_k_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)
         | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x N, s32, the warpgroup's fragment, N / 2 registers a thread) +=
// A (64 x 32 int8, K-major) . B (N x 32 int8, K-major)^T
template <int N> struct MmaS8;

#define SM90_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SM90_R8(i) SM90_R4(i), SM90_R4(i + 4)
#define SM90_R16(i) SM90_R8(i), SM90_R8(i + 8)
#define SM90_R32(i) SM90_R16(i), SM90_R16(i + 16)
#define SM90_PRED(n) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n ", 0;\n"

template <> struct MmaS8<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(SM90_PRED(6)
                 "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
                 "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
                 : SM90_R4(0) : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct MmaS8<16> {
  __device__ __forceinline__ static void mma(int (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(SM90_PRED(10)
                 "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
                 : SM90_R8(0) : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct MmaS8<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(SM90_PRED(18)
                 "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
                 : SM90_R16(0) : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct MmaS8<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(SM90_PRED(34)
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
                 : SM90_R32(0) : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct MmaS8<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(SM90_PRED(66)
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, "
                 "%40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, "
                 "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
                 : SM90_R32(0), SM90_R32(32) : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef SM90_R4
#undef SM90_R8
#undef SM90_R16
#undef SM90_R32
#undef SM90_PRED

}  // namespace sm90
