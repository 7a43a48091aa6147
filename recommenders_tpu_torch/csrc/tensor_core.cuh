// Tensor-core building blocks shared by the port's kernels (sm_90a):
// cp.async copies into shared memory, ldmatrix fragment loads, the bf16
// mma.sync.aligned.m16n8k16 product with f32 accumulators, the exact
// three-term bf16 split of an f32 value and the code-to-bf16 decoders.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A [16 x 16] row-major, 4 registers of two bf16:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, cols 2t, 2t+1),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B [16 x 8] (k x n), 2 registers: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9);
//   C [16 x 8] f32, 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring n-blocks, rounded to bf16 and
// packed in pairs, are the A fragment of a 16-deep product: the
// FlashAttention-2 register reuse.
//
// Shared tiles hold rows of `stride` bf16 with stride = width + 8: the 16
// bytes of padding put the 8 row addresses of one ldmatrix 8 x 8 matrix in
// 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global `src` to shared `dst` asynchronously; with
// src_bytes = 0 it reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 4 bytes (through L1: cp.async.cg takes only 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i of lane l holds row l / 4, columns 2(l % 4) and
// 2(l % 4) + 1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, transposed: register i of lane l holds rows 2(l % 4) and
// 2(l % 4) + 1, column l / 4 of matrix i (a B fragment from a [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a · b on the tensor cores: bf16 inputs, exact products, f32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats x0, x1 as three bf16 pairs h + m + l (`x0` in the low
// halves): h = bf16(x), m = bf16(x - h), l = bf16(x - h - m), each
// rounded to nearest even. Both subtractions are exact (Sterbenz), and for
// 2^-110 <= |x| < (2 - 2^-8) 2^127 h + m + l = x exactly, with |m| <=
// (1 + 2^-8) 2^-8 |x| and |l| <= 2^-16 |x|: x's 24 bits are 3 x 8. Below
// 2^-110, x's last bits fall under bf16's subnormal grid (2^-133) and l
// rounds onto it: the split misses x by at most 2^-134. (Larger |x| round
// h to infinity.)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  h = pack_bf16(x0, x1);
  const float r0 = __fsub_rn(x0, __uint_as_float(h << 16));
  const float r1 = __fsub_rn(x1, __uint_as_float(h & 0xFFFF0000u));
  m = pack_bf16(r0, r1);
  l = pack_bf16(__fsub_rn(r0, __uint_as_float(m << 16)),
                __fsub_rn(r1, __uint_as_float(m & 0xFFFF0000u)));
}

// Two int8 codes, bytes i and i + 1 of w ^ 0x80808080 (x + 128 each), as
// bf16 pairs without the quarter-rate int-to-float unit: the f32 with bits
// 0x4B000000 | (x + 128) is 2^23 + x + 128, so one subtraction gives x
// exactly, and x (8 significant bits) is the f32's upper half.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int i) {
  const float f0 =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Two int4 codes as a bf16 pair, from the nibbles n (two's complement) in
// bits [0, 4) of each 16-bit half of h: 0x4300 | (n ^ 8) is the bf16
// 128 + n + 8, and subtracting 136 leaves n exactly.
__device__ __forceinline__ uint32_t int4x2_to_bf16x2(uint32_t h) {
  const uint32_t v = (h & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major
// shared tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int stride, int k0, int lane) {
  ldmatrix_x4(a, t + (lane & 15) * stride + k0 + (lane >> 4) * 8);
}

// B fragments of two n-blocks, n rows [0, 16) of an [n][k] shared tile at
// columns [k0, k0 + 16): (b[0], b[1]) for n-block 0, (b[2], b[3]) for 1.
__device__ __forceinline__ void load_b(uint32_t b[4], const __nv_bfloat16* t,
                                       int stride, int k0, int lane) {
  ldmatrix_x4(b, t + ((lane & 7) + (lane >> 4) * 8) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks from a [k][n] shared tile: k rows
// [0, 16), n columns [n0, n0 + 16).
__device__ __forceinline__ void load_b_trans(uint32_t b[4],
                                             const __nv_bfloat16* t,
                                             int stride, int n0, int lane) {
  ldmatrix_x4_trans(b, t + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                           n0 + (lane >> 4) * 8);
}

}  // namespace tc
