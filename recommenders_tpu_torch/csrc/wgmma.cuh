// Hopper building blocks shared by the port's wgmma bodies (sm_90a): the
// mbarriers and 1-D bulk copies (cp.async.bulk, no tensor map) of a
// producer / consumer ring in shared memory, warpgroup register
// rebalancing, and the bf16 wgmma with its A operand in registers and its
// B operand in shared memory.
//
// wgmma.m64nNk16 (A in registers, B from shared memory, f32 accumulators).
// A warpgroup's four warps w = 0..3 own rows [16w, 16w + 16) of the 64-row
// tile; within a warp (lane = 4g + t) the A fragment is mma.sync's:
//   a0 (row g, k 2t, 2t+1), a1 (row g+8, k 2t, 2t+1),
//   a2 (row g, k 2t+8, 2t+9), a3 (row g+8, k 2t+8, 2t+9),
// the lower k in the lower half of each register; the accumulator holds,
// for j = 0 .. N/8 - 1, d[4j] (row g, col 8j + 2t), d[4j + 1] (row g,
// col 8j + 2t + 1), d[4j + 2] and d[4j + 3] (row g + 8, the same cols).
// So a thread's accumulators cover two rows of the tile and N / 4 of its
// columns.
//
// B is [N][K] bf16, K-major, in the 128-byte swizzled canonical layout:
// per 64 k (a K block, N * 128 bytes, 1024-byte aligned), row n's 128
// bytes at n * 128, its 16-byte chunk c at chunk c ^ (n % 8) (`b_offset`).
// Without the swizzle, the tensor cores' reads of eight rows fall on the
// same banks. The descriptor's stride byte offset is 1024 (eight rows),
// its leading byte offset unused (1); k-step s starts at K block s / 4
// plus (s % 4) * 32 bytes, the swizzle taken from the address bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace wg {

// ----------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst`; completion counts `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy shared memory accesses before later
// async-proxy ones (wgmma's reads of B, bulk copies into a released stage).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1 .. 15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at barrier `id` without waiting (its count is `threads`).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register rebalancing between warpgroups (every warp of the warpgroup
// executes it).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers of `d` to this point of the program, so the compiler
// moves no access of them across a wgmma fence, commit or wait.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of B element (n, k) in the layout above, for a B of N rows.
template <int N>
__device__ __forceinline__ int b_offset(int n, int k) {
  return (k >> 6) * N * 128 + n * 128 + ((((k >> 3) & 7) ^ (n & 7)) << 4) +
         (k & 7) * 2;
}

// Descriptor of k-step s of a B of N rows at shared address `base`
// (1024-byte aligned).
template <int N>
__device__ __forceinline__ uint64_t b_desc(uint32_t base, int s) {
  const uint32_t start = base + (s >> 2) * N * 128 + (s & 3) * 32;
  return static_cast<uint64_t>((start & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Position k of feature c in a code body's B (and A): a lane reads 16
// consecutive code bytes of its row for each 64 features, bytes 16t ..
// 16t + 15 of the block, and takes word s (bytes 4s .. 4s + 3) as k-step
// s's k = 2t, 2t + 8, 2t + 1, 2t + 9 (`decode_int8`); storing the query's
// features in that order keeps every product aligned (the sum over k is
// the same).
__device__ __forceinline__ int code_k(int c) {
  const int t = (c & 63) >> 4, s = (c & 15) >> 2, j = c & 3;
  return (c & ~63) + 16 * s + (j & 1) * 8 + 2 * t + (j >> 1);
}

// Two int8 codes, bytes 0 and 2 of w (bits 0-7 and 16-23), as a bf16
// pair, exactly and on the packed bf16 unit: a code is -128 b + m (b its
// sign bit, m its low seven bits); each 16-bit lane takes 0x4300 | m
// (128 + m) less 0x4300 | b << 7 (128, or 256 where b is set).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w) {
  const uint32_t magic = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t bias = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&magic),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragments of k-steps 4kb .. 4kb + 3 from lane (g, t)'s 16 code
// bytes of row g (`lo`) and of row g + 8 (`hi`) in 64-feature block kb:
// int8 codes as bf16 (exact).
__device__ __forceinline__ void decode_int8(const uint4& lo, const uint4& hi,
                                            uint32_t (&a)[4][4]) {
  const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = int8x2_to_bf16x2(l[s]);       // row g: k 2t, 2t + 1
    a[s][1] = int8x2_to_bf16x2(h[s]);       // row g + 8
    a[s][2] = int8x2_to_bf16x2(l[s] >> 8);  // row g: k 2t + 8, 2t + 9
    a[s][3] = int8x2_to_bf16x2(h[s] >> 8);
  }
}

// d (+)= A . B for one k-step; accumulate = 0 overwrites d.
template <int N>
struct Mma;

template <>
struct Mma<16> {
  __device__ static __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<32> {
  __device__ static __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  __device__ static __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

}  // namespace wg
