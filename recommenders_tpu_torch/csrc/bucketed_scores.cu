// Bucketed corpus scoring for retrieval serving, written for Hopper (sm_90a).
//
// Replaces the TPU kernel family K3:
// recommenders_tpu/ops/scoring.py::bucketed_scores (:217, pallas_call :333)
// and its three Pallas bodies _bucket_kernel (:59),
// _bucket_kernel_quantized (:108) and _bucket_kernel_packed4 (:154).
//
// What it computes. Queries q [Q, D] against a corpus of N rows (N a
// multiple of the bucket count B). Bucket b of query i keeps the best row
// among r = g*B + b, g = 0 .. N/B-1:
//   vals[i, b] = max_g score(i, g*B + b),  rows[i, b] = that row,
// where score(i, r) is q_i . c_r accumulated in f32, times the row's f32
// scale for the quantized formats, and `mask_value` (MIN_FLOAT) for
// r >= valid_rows. A row replaces the running best only when strictly
// greater, or equal with a lower row, so ties go to the lowest row, as
// jnp.argmax does in the reference; an all-masked bucket reports its first
// row. The exact top-k over the [Q, B] state runs outside the kernel
// (torch.topk), as it does in the JAX package.
//
// Corpus formats, all multiplied on the bf16 tensor cores:
//   bf16 rows with a bf16 query; int8 codes [N, D] plus f32 scales [N];
//   int4 codes packed two per byte along rows, [N/2, D] (byte (c, d) holds
//   row c in its low nibble and row c + N/2 in its high nibble; it
//   sign-extends and decodes as lo = (p << 28) >> 28, hi = p >> 4). For
//   these three the query is bf16 (the wrapper rounds it for codes) and
//   every code is exact in bf16, so each product is exact in f32; sums are
//   f32 and the scale multiplies after the dot.
//   f32 rows with an f32 query, in split precision: both operands split
//   into three bf16 terms, x = h + m + l (tc::split3, exact for normal
//   values), and six of the nine term products taken, hh, hm, mh, hl, lh
//   and mm, each exact in f32. The dropped ml, lm and ll are at most
//   2 (1 + 2^-8) 2^-8 2^-16 + 2^-32 <= 1.006 * 2^-23 of |q_k||c_k| a
//   product, so the six sum to q.c within 1.006 * 2^-23 * sum_k |q_k||c_k|
//   (plus 2^-134 (|q_k| + |c_k|) a product for terms below 2^-110, which
//   round onto bf16's subnormal grid). hh sums in one f32 accumulator, as
//   the bf16 body sums its products; the other five, together 2^-7 as
//   large, in a second, added once a group. The plain twin is a full f32
//   dot, within gamma_D(2^-24) ~ D * 2^-24 * sum|q||c| of q.c. So the
//   split and the twin together take 1.006 + D/2 of the D units of
//   2^-23 * sum|q||c| in the tolerance the tests hold the kernel to
//   (D * 2^-23 * sum|q||c|): 65 of 128 at D = 128, and the rest is the
//   room for the kernel's own f32 sum, as for the bf16 body (the textbook
//   worst case of that sum, (D - 1) 2^-24, is within 1 % of it).
//   tests/test_torch_split_precision.py checks the split's bound against
//   float64 on adversarial inputs.
//
// What bounds it on the H100. At Q=1024, N=1M, D=128 the work is
// 2*Q*N*D = 2.7e11 FLOP, while one sweep of the corpus reads 512 MB (f32),
// 256 MB (bf16), 128 MB (int8) or 64 MB (int4): hundreds of FLOP per byte,
// so the kernel is bound by arithmetic: 0.27 ms a bf16 pass at the
// tensor-core peak, so 1.6 ms for f32's six (3.9 ms at the f32 CUDA-core
// peak, which the CUDA-core body this replaced ran at 46 % of). On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, tools/kernel_ab.py)
// bf16 / int4 take 1.20 / 1.51 ms and f32 4.5 ms (the CUDA-core body
// 8.5). The tensor cores do not set these bodies' pace: each stage
// waits at two (bf16) or three (int4) block barriers,
// and warps resident matter more than shared-memory traffic (keeping a
// warp's query fragments in registers instead of reloading them every
// group needs 220+ registers, one block an SM, and was slower on that
// card). The int8 body below takes that step.
//
// The int8 body (`bucketed_int8_kernel`). At the 100M catalog's request
// (Q = 256, N = 100,003,840, D = 128, B = 4,096) the codes are 12.8 GB
// and the products 6.6 TFLOP: 3.9 ms of bytes, 6.6 ms at the bf16 peak,
// so it is bound by operations. The mma.sync body it replaced read every
// code once a 128-query tile (twice here), ran one and a half waves and
// waited at three block barriers a stage (43 ms). Here a block owns 64
// buckets x all of a request's queries (a tile of 256, 128 or 64: one
// read of the codes up to 256 queries), one block an SM, and the plan
// splits the group walk until the grid is one wave. A producer warp
// copies each group's slab (64 contiguous code rows) into a ring of up to
// eight stages with one cp.async.bulk completing on an mbarrier, and the
// slab's 64 scales beside it by cp.async on the same barrier; two
// consumer warpgroups, each with NQ = tile / 2 of the queries as wgmma's
// B (bf16 in shared memory, 128-byte swizzled, stored once), read their
// slab rows 16 bytes a lane and decode them to bf16 A fragments in
// registers (exact, three instructions a pair of codes; the query's
// features are stored in the matching order, wg::code_k). Each
// warpgroup decodes a pair of k-blocks (D = 128 is one pair a group),
// releases the stage with one arrival a warp, takes its turn at the
// tensor cores (named barriers), issues the pair's eight wgmma.m64nNQk16
// under one fence as one commit group and hands the turn on at once:
// the turn holds no wait at D = 128. The wait for its products and the
// fold run outside the turn, beside the other warpgroup's products. No
// block-wide barrier follows the set-up. Each thread's accumulators
// cover two buckets x NQ / 4 queries, so the fold needs two scales a
// group and keeps a running (max, group) beside them: 64 + 64 + 64
// registers and 32 of A at NQ = 128, which setmaxnreg makes room for
// (the producer warpgroup drops to 24). Past its first 1,024 groups a
// walk folds by a compare-only pass (fold_group_fast), since a new best
// is rare there; the B descriptors are formed once, in uniform
// registers; a width of D is a template instance (KB = D / 64).
//
// What bounds it now (PERF.md, section 6, PR 22): the consumers'
// instructions beside the products, not the products. A consumer warp
// issues about 340 instructions a group at D = 128 (decode 112, fold
// about 140, the rest addresses, barriers and issue), two such warps a
// sub-partition, and on the H100 ALU work on one warpgroup hides only
// about half of itself under another warpgroup's wgmma (1.19 ms of
// wgmma alone and 0.83 ms of a fold alone took 1.59 ms together, in a
// standalone test on the card), so the walk takes about twice its tensor
// time. Decoding a k-block while the one before it is in flight, the
// schedule the two sets of A fragments allow, was no faster: the fence
// before a k-block's products waits for those in flight, and a second
// set leaves no registers at NQ = 128 (ptxas serialized or spilled each
// such body).
//
// What the design does about it. The TPU ran its grid (query tile, corpus
// chunk) in order and carried the running max/argmax in VMEM across
// chunks. Here a block owns a TQ-query x 64-bucket tile of the output and
// walks the row groups g itself, its running max/argmax in registers; the
// [Q, N] score matrix never exists. The queries sit in shared memory for
// the whole sweep; each group's 64-row corpus slab, 128 feature columns a
// stage, comes in by cp.async into a double buffer while the previous
// stage is in use. (TQ / 32) x 2 warps, each 32 queries x 32 buckets,
// multiply with mma.sync.m16n8k16 (tensor_core.cuh); the epilogue scales,
// masks and folds the f32 accumulator fragments into a running (max, row)
// held in the same fragment layout. Where the tiles leave the card short
// of blocks, the wrapper splits the group walk over `splits` blocks, each
// over a contiguous range of groups, and a second kernel merges their
// (value, lowest row) pairs: that merge is associative and commutative,
// so the result equals the unsplit walk's.
//   bf16 / int4: TQ = 128 (64 for D > 512), two blocks an SM; the int4
//   codes are decoded to bf16 in shared memory (the low or the high
//   nibble by the group's half of the corpus) with integer tricks, not
//   the quarter-rate int-to-float unit.
//   f32: the query's three bf16 planes ([TQ][D + 8] each, split once) and
//   the raw f32 slab ring ([64][136] floats a stage) take 170 KB at TQ =
//   128, D = 128, so one block an SM; TQ = 64 from D = 256 and 32 from D =
//   512 (the wrapper picks the largest that fits 227 KB). Each B fragment
//   is split as it is loaded (two 8-byte shared loads a lane, no bank
//   conflict at a 136-float stride): each of the tile's query warps splits
//   it again, ALU work beside the tensor cores. On the H100 that was as
//   fast as splitting the slab once a stage into three bf16 planes in
//   shared memory (a third barrier, 51 KB more) and faster than 64-query
//   tiles at two blocks an SM; unrolling the stage's eight k-steps fully
//   gained 7 % (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// kRows, kInt8 and kPacked4 are the C interface's format codes (bf16 for
// kRows); kF32 is f32 rows, format kRows with bf16 = 0.
enum Format { kRows = 0, kInt8 = 1, kPacked4 = 2, kF32 = 3 };

constexpr int kTB = 64;            // buckets per block
constexpr int kKC = 128;           // feature columns per stage
constexpr int kSlab = kKC + 8;     // stride of a staged slab row (bf16 or f32)

// Replaces (best, best_row) by (v, r) if v is larger, or equal with a
// lower row.
__device__ __forceinline__ void keep_best(float& best, int& best_row, float v,
                                          int r) {
  if (v > best || (v == best && r < best_row)) {
    best = v;
    best_row = r;
  }
}

// Shared bytes: the query tile (three bf16 planes for f32), and the slab
// ring (bf16 or f32 rows), or the decoded slab plus the ring of raw code
// slabs (int8, int4).
size_t tc_smem(int fmt, int tq, int d) {
  const size_t q_bytes = sizeof(bf16) * tq * (d + 8) * (fmt == kF32 ? 3 : 1);
  const size_t slab = sizeof(bf16) * kTB * kSlab;
  switch (fmt) {
    case kRows: return q_bytes + 2 * slab;
    case kF32: return q_bytes + 2 * sizeof(float) * kTB * kSlab;
    default: return q_bytes + slab + 2 * kTB * kKC;
  }
}

// A block owns TQ queries x 64 buckets and walks groups [g_begin, g_end)
// of its split (blockIdx.z of gridDim.z); (TQ / 32) x 2 warps own 32
// queries x 32 buckets each. Writes its [Q, B] plane at
// vals / rows + blockIdx.z * Q * B.
template <int FMT, int TQ>
__global__ void __launch_bounds__(TQ * 2, FMT == kF32 ? 1 : 2)
bucketed_tc_kernel(const void* __restrict__ q, const void* __restrict__ c,
                   const float* __restrict__ scales,
                   float* __restrict__ vals, int* __restrict__ rows,
                   int num_q, int64_t n, int d, int buckets,
                   int64_t valid_rows, float mask_value) {
  constexpr int kThreadsTc = TQ * 2;
  constexpr int kPlanes = FMT == kF32 ? 3 : 1;  // query planes: h, m, l
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int qstride = d + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // kPlanes x [TQ][d + 8]
  // bf16: 2 x [kTB][kSlab]; codes: [kTB][kSlab]; f32: 2 x [kTB][kSlab] f32.
  bf16* slabs = qs + kPlanes * TQ * qstride;
  float* slabs32 = reinterpret_cast<float*>(slabs);
  int8_t* raw = reinterpret_cast<int8_t*>(slabs + kTB * kSlab);  // 2 x [kTB][kKC]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wq = warp >> 1, wb = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * TQ;
  const int b0 = blockIdx.x * kTB;
  const int64_t groups = n / buckets;
  const int64_t half_groups = groups / 2;
  const int64_t g_begin = groups * blockIdx.z / gridDim.z;
  const int64_t g_end = groups * (blockIdx.z + 1) / gridDim.z;
  const int kchunks = d / kKC;
  const int64_t stages = (g_end - g_begin) * kchunks;

  // The query tile, once (rows past num_q are zeros); f32 queries are
  // split into their h, m and l planes.
  if constexpr (FMT == kF32) {
    const float* qf = static_cast<const float*>(q);
    const int q_chunks = d / 4;
    for (int idx = tid; idx < TQ * q_chunks; idx += kThreadsTc) {
      const int r = idx / q_chunks;
      const int k = (idx - r * q_chunks) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < num_q) {
        v = *reinterpret_cast<const float4*>(
            qf + static_cast<int64_t>(q0 + r) * d + k);
      }
      uint32_t h[2], m[2], l[2];
      tc::split3(v.x, v.y, h[0], m[0], l[0]);
      tc::split3(v.z, v.w, h[1], m[1], l[1]);
      bf16* dst = qs + r * qstride + k;
      *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(dst + TQ * qstride) = make_uint2(m[0], m[1]);
      *reinterpret_cast<uint2*>(dst + 2 * TQ * qstride) =
          make_uint2(l[0], l[1]);
    }
  } else {
    const bf16* qb = static_cast<const bf16*>(q);
    const int q_chunks = d / 8;
    for (int idx = tid; idx < TQ * q_chunks; idx += kThreadsTc) {
      const int r = idx / q_chunks;
      const int ch = idx - r * q_chunks;
      const bool ok = q0 + r < num_q;
      tc::cp_async16(qs + r * qstride + ch * 8,
                     ok ? qb + static_cast<int64_t>(q0 + r) * d + ch * 8 : qb,
                     ok ? 16 : 0);
    }
  }

  // Stage s: group g_begin + s / kchunks, columns (s % kchunks) * kKC.
  auto stage_slab = [&](int64_t s) {
    const int64_t grp = g_begin + s / kchunks;
    const int col0 = static_cast<int>(s % kchunks) * kKC;
    if constexpr (FMT == kF32) {
      float* dst = slabs32 + (s & 1) * kTB * kSlab;
      const float* src = static_cast<const float*>(c);
      for (int idx = tid; idx < kTB * (kKC / 4); idx += kThreadsTc) {
        const int i = idx / (kKC / 4);
        const int ch = idx % (kKC / 4);
        const bool ok = b0 + i < buckets;
        const float* p = src + (grp * buckets + b0 + i) * d + col0 + ch * 4;
        tc::cp_async16(dst + i * kSlab + ch * 4, ok ? p : src, ok ? 16 : 0);
      }
    } else if constexpr (FMT == kRows) {
      bf16* dst = slabs + (s & 1) * kTB * kSlab;
      const bf16* src = static_cast<const bf16*>(c);
      for (int idx = tid; idx < kTB * (kKC / 8); idx += kThreadsTc) {
        const int i = idx / (kKC / 8);
        const int ch = idx % (kKC / 8);
        const bool ok = b0 + i < buckets;
        const bf16* p = src + (grp * buckets + b0 + i) * d + col0 + ch * 8;
        tc::cp_async16(dst + i * kSlab + ch * 8, ok ? p : src, ok ? 16 : 0);
      }
    } else {
      int8_t* dst = raw + (s & 1) * kTB * kKC;
      const int8_t* src = static_cast<const int8_t*>(c);
      // Packed int4: the group's rows sit in the low nibbles of packed
      // rows g*B + b (first half of the corpus) or the high nibbles of
      // (g - G/2)*B + b (second half).
      const int64_t prow0 =
          (FMT == kPacked4 && grp >= half_groups ? grp - half_groups : grp) *
          buckets;
      for (int idx = tid; idx < kTB * (kKC / 16); idx += kThreadsTc) {
        const int i = idx / (kKC / 16);
        const int ch = idx % (kKC / 16);
        const bool ok = b0 + i < buckets;
        const int8_t* p = src + (prow0 + b0 + i) * d + col0 + ch * 16;
        tc::cp_async16(dst + i * kKC + ch * 16, ok ? p : src, ok ? 16 : 0);
      }
    }
  };

  // Running best of the fragment positions: [m-block][n-block][c-index];
  // c-index 2h + e is query row g + 8h, bucket column 2t + e.
  float best[2][4][4];
  int best_row[2][4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r0 = static_cast<int>(g_begin * buckets) + b0 + wb * 32 +
                     nb * 8 + 2 * t + e;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // The first group always replaces this, so an all-masked bucket
          // reports its first row.
          best[mb][nb][2 * h + e] = -CUDART_INF_F;
          best_row[mb][nb][2 * h + e] = r0;
        }
      }
    }
  }

  if (stages > 0) stage_slab(0);
  tc::cp_async_commit();
  // acc: the products (f32: hh); small: f32's five smaller term products.
  float acc[2][4][4];
  float small[2][4][4];
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) stage_slab(s + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int64_t grp = g_begin + s / kchunks;
    const int kc = static_cast<int>(s % kchunks);
    const bf16* slab = slabs;
    if constexpr (FMT == kRows) {
      slab = slabs + (s & 1) * kTB * kSlab;
    } else if constexpr (FMT != kF32) {
      // Decode the int4 codes to bf16 (exact), 8 a thread per step.
      const int8_t* src = raw + (s & 1) * kTB * kKC;
      const bool high = grp >= half_groups;
      for (int idx = tid; idx < kTB * (kKC / 8); idx += kThreadsTc) {
        const int i = idx / (kKC / 8);
        const int u = idx % (kKC / 8);
        const uint2 word = *reinterpret_cast<const uint2*>(src + i * kKC + u * 8);
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t w = j == 0 ? word.x : word.y;
          // Bytes (0, 1) and (2, 3) spread to the two 16-bit halves; the
          // group's half of the corpus picks the nibble.
          const int shift = high ? 4 : 0;
          packed[2 * j] =
              tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4140) >> shift);
          packed[2 * j + 1] =
              tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4342) >> shift);
        }
        *reinterpret_cast<uint4*>(slabs + i * kSlab + u * 8) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      __syncthreads();
    }
    if (kc == 0) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mb][nb][i] = 0.f;
            small[mb][nb][i] = 0.f;
          }
        }
      }
    }
    if constexpr (FMT == kF32) {
      const float* slab32 = slabs32 + (s & 1) * kTB * kSlab;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 16) {
        uint32_t a[3][2][4];  // [plane h, m, l][m-block]
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            tc::load_a(a[p][mb],
                       qs + (p * TQ + wq * 32 + mb * 16) * qstride, qstride,
                       kc * kKC + k0, lane);
          }
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          // B fragment of bucket row g: k = 2t, 2t+1 and 2t+8, 2t+9.
          const float* src =
              slab32 + (wb * 32 + nb * 8 + g) * kSlab + k0 + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(src);
          const float2 hi = *reinterpret_cast<const float2*>(src + 8);
          uint32_t bh[2], bm[2], bl[2];
          tc::split3(lo.x, lo.y, bh[0], bm[0], bl[0]);
          tc::split3(hi.x, hi.y, bh[1], bm[1], bl[1]);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            tc::mma_bf16(acc[mb][nb], a[0][mb], bh[0], bh[1]);    // hh
            tc::mma_bf16(small[mb][nb], a[1][mb], bm[0], bm[1]);  // mm
            tc::mma_bf16(small[mb][nb], a[2][mb], bh[0], bh[1]);  // lh
            tc::mma_bf16(small[mb][nb], a[0][mb], bl[0], bl[1]);  // hl
            tc::mma_bf16(small[mb][nb], a[1][mb], bh[0], bh[1]);  // mh
            tc::mma_bf16(small[mb][nb], a[0][mb], bm[0], bm[1]);  // hm
          }
        }
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          tc::load_a(a[mb], qs + (wq * 32 + mb * 16) * qstride, qstride,
                     kc * kKC + k0, lane);
        }
#pragma unroll
        for (int nb2 = 0; nb2 < 2; ++nb2) {
          uint32_t bb[4];
          tc::load_b(bb, slab + (wb * 32 + nb2 * 16) * kSlab, kSlab, k0,
                     lane);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            tc::mma_bf16(acc[mb][2 * nb2], a[mb], bb[0], bb[1]);
            tc::mma_bf16(acc[mb][2 * nb2 + 1], a[mb], bb[2], bb[3]);
          }
        }
      }
    }
    if (kc == kchunks - 1) {
      // Fold group grp: scale, mask, keep the best.
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bucket = b0 + wb * 32 + nb * 8 + 2 * t + e;
          const int64_t r = grp * buckets + bucket;
          float scale = 1.f;
          if constexpr (FMT == kPacked4) {
            scale = bucket < buckets ? __ldg(scales + r) : 0.f;
          }
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = acc[mb][nb][2 * h + e];
              if constexpr (FMT == kF32) {
                v = __fadd_rn(v, small[mb][nb][2 * h + e]);
              } else if constexpr (FMT != kRows) {
                v *= scale;
              }
              if (r >= valid_rows) v = mask_value;
              if (v > best[mb][nb][2 * h + e]) {
                best[mb][nb][2 * h + e] = v;
                best_row[mb][nb][2 * h + e] = static_cast<int>(r);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // The next stage overwrites this buffer.
  }

  const int64_t plane = static_cast<int64_t>(blockIdx.z) * num_q * buckets;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = q0 + wq * 32 + mb * 16 + g + 8 * h;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bucket = b0 + wb * 32 + nb * 8 + 2 * t + e;
          if (qrow < num_q && bucket < buckets) {
            const int64_t o =
                plane + static_cast<int64_t>(qrow) * buckets + bucket;
            vals[o] = best[mb][nb][2 * h + e];
            rows[o] = best_row[mb][nb][2 * h + e];
          }
        }
      }
    }
  }
}

// Merges the splits' [Q, B] planes: the best value, ties to the lowest row.
__global__ void merge_splits_kernel(const float* __restrict__ split_vals,
                                    const int* __restrict__ split_rows,
                                    int64_t plane, int splits,
                                    float* __restrict__ vals,
                                    int* __restrict__ rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= plane) return;
  float v = split_vals[i];
  int r = split_rows[i];
  for (int p = 1; p < splits; ++p) {
    keep_best(v, r, split_vals[p * plane + i], split_rows[p * plane + i]);
  }
  vals[i] = v;
  rows[i] = r;
}

// ------------------------------------------------------- int8 on wgmma

constexpr int kSlabRows = 64;            // buckets of a block: wgmma's M
constexpr int kConsumerWarpgroups = 2;   // each multiplies NQ queries
constexpr int kConsumerWarps = 4 * kConsumerWarpgroups;
// + a producer warpgroup: setmaxnreg moves registers between whole
// warpgroups (ptxas sizes the launch for three), and only its first warp
// works.
constexpr int kInt8Threads = 32 * (kConsumerWarps + 4);
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;         // full, empty
constexpr size_t kInt8MaxSmem = 232448;  // 227 KB a block on the H100

// Shared bytes of the int8 body: the query tile (2 NQ rows of D bf16),
// its barriers and `stages` stages of 64 code rows and their 64 scales.
__host__ __device__ constexpr size_t int8_smem(int nq, int d, int stages) {
  return kBarrierBytes + static_cast<size_t>(kConsumerWarpgroups) * nq * d *
                             2 +
         static_cast<size_t>(stages) * kSlabRows * (d + sizeof(float));
}

// Copies 4 bytes from global `src` to shared `dst` asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Holds `bar`'s phase open (one more pending arrival) until this thread's
// cp.async copies so far have landed, then arrives.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}

// Waits for the phase of parity `parity` of `bar`: one test first, which
// does not suspend the warp, for the usual case of a stage that has
// landed.
__device__ __forceinline__ void mbar_ready(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(tc::smem_addr(bar)), "r"(parity)
      : "memory");
  if (!done) wg::mbar_wait(bar, parity);
}

// Folds one group's scores into the running best: accumulator d[4j + e]
// is bucket row `ra` and d[4j + 2 + e] row `ra + 8` (rows `row_a`,
// `row_a + 8` of the corpus, scales sa, sb), each against query column
// 8j + 2t + e. MASKED: rows >= valid_rows score mask_value.
template <int R, bool MASKED>
__device__ __forceinline__ void fold_group(const float (&acc)[R],
                                           float (&best)[R],
                                           int (&best_g)[R], int grp,
                                           float sa, float sb, int row_a,
                                           int valid_rows, float mask_value) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool lower = (i & 2) == 0;
    float v = acc[i] * (lower ? sa : sb);
    if constexpr (MASKED) {
      if ((lower ? row_a : row_a + 8) >= valid_rows) v = mask_value;
    }
    if (v > best[i]) {
      best[i] = v;
      best_g[i] = grp;
    }
  }
}

// The unmasked fold once a walk is past its first groups. There a
// group rarely holds a new best (the i-th group of a walk holds one for a
// given score with chance 1 / i, so a warp's chunk of 32 x 16 scores with
// chance about 512 / i), so a compare-only pass comes first: one multiply
// and one compare a score, or-ed into a flag a chunk, and only a chunk
// whose flag is set in some lane of the warp is folded as fold_group
// folds it, with the same products, the same strict > and the same group
// order. Up to kFastFoldAfter groups into a walk every chunk would take
// the update, so fold_group runs there.
constexpr int kFoldChunk = 16;
constexpr int kFastFoldAfter = 1024;

// Chunks the compare-only pass checked, and those that took the update,
// summed over launches (one atomic add a warp at the block's end); the
// host reads and clears them with bucketed_scores_fold_counts.
__device__ unsigned long long g_fold_checked, g_fold_updated;

// a * b, rounded as the fold rounds it, but opaque to the compiler, so
// that the compare-only pass keeps none of its products for the update.
__device__ __forceinline__ float mul_again(float a, float b) {
  float c;
  asm volatile("mul.rn.f32 %0, %1, %2;" : "=f"(c) : "f"(a), "f"(b));
  return c;
}

template <int R>
__device__ __forceinline__ void fold_group_fast(const float (&acc)[R],
                                                float (&best)[R],
                                                int (&best_g)[R], int grp,
                                                float sa, float sb,
                                                uint32_t& updated) {
  constexpr int kChunks = R / kFoldChunk;
  bool up[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) up[c] = false;
  // The chunks' compares interleaved, so their or-chains run side by side.
#pragma unroll
  for (int i = 0; i < kFoldChunk; ++i) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * kFoldChunk + i;
      up[c] |= mul_again(acc[j], (j & 2) == 0 ? sa : sb) > best[j];
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (__any_sync(0xffffffffu, up[c])) {
      ++updated;
#pragma unroll
      for (int j = c * kFoldChunk; j < (c + 1) * kFoldChunk; ++j) {
        const float v = acc[j] * ((j & 2) == 0 ? sa : sb);
        if (v > best[j]) {
          best[j] = v;
          best_g[j] = grp;
        }
      }
    }
  }
}

// (w & MASK) | k in one instruction; k, a constant, stays in a register,
// so that the mask can be the instruction's immediate.
template <uint32_t MASK>
__device__ __forceinline__ uint32_t and_or(uint32_t w, uint32_t k) {
  uint32_t out;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(out) : "r"(w), "n"(MASK),
      "r"(k));
  return out;
}

// wg::int8x2_to_bf16x2, bit for bit, in three instructions: the magic
// word 0x4300 | m and the bias word 0x4300 | b << 7 are one lop3 each
// (k holds 0x43004300), their difference one packed bf16 subtraction.
__device__ __forceinline__ uint32_t int8x2_bf16x2(uint32_t w, uint32_t k) {
  const uint32_t magic = and_or<0x007F007Fu>(w, k);
  const uint32_t bias = and_or<0x00800080u>(w, k);
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&magic),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Loads lane t's 16 code bytes of k-block kb from its two slab rows (`lo`
// at row ra, row ra + 8 at lo + 8 d) and decodes them into the A
// fragments that wg::decode_int8 gives.
__device__ __forceinline__ void decode_kblock(const unsigned char* lo, int d,
                                              int kb, uint32_t k,
                                              uint32_t (&a)[4][4]) {
  const uint4 wa = *reinterpret_cast<const uint4*>(lo + kb * 64);
  const uint4 wb = *reinterpret_cast<const uint4*>(lo + 8 * d + kb * 64);
  const uint32_t l[4] = {wa.x, wa.y, wa.z, wa.w};
  const uint32_t h[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = int8x2_bf16x2(l[s], k);       // row g: k 2t, 2t + 1
    a[s][1] = int8x2_bf16x2(h[s], k);       // row g + 8
    a[s][2] = int8x2_bf16x2(l[s] >> 8, k);  // row g: k 2t + 8, 2t + 9
    a[s][3] = int8x2_bf16x2(h[s] >> 8, k);
  }
}

// wg::b_desc<N>(b_base, s), bit for bit, from `lo0`, the low word of
// wg::b_desc<N>(b_base, 0): k-step s moves only the start address field
// (bits 0-13, the address over 16, which stays below 2^14 in shared
// memory), so each descriptor is one add; the high word is a constant
// (stride 1024 bytes, 128-byte swizzle).
template <int N>
__device__ __forceinline__ uint64_t b_desc_from(uint32_t lo0, int s) {
  const uint32_t lo = lo0 + (((s >> 2) * N * 128 + (s & 3) * 32) >> 4);
  return (static_cast<uint64_t>(0x40000040u) << 32) | lo;
}

// Issues k-block kb's four k-steps into acc; k-block 0's first overwrites.
template <int NQ>
__device__ __forceinline__ void issue_kblock(float (&acc)[NQ / 2],
                                             const uint32_t (&a)[4][4],
                                             uint32_t b_lo, int kb) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wg::Mma<NQ>::run(acc, a[s], b_desc_from<NQ>(b_lo, kb * 4 + s),
                     kb + s > 0);
  }
}

// K3's int8 body for D = 64 KB features. A block owns 64 buckets x 2 NQ
// queries of the output and walks groups [g_begin, g_end) of its split
// (blockIdx.z of gridDim.z). A producer warp brings each group's slab of
// 64 code rows (contiguous: rows g*B + b0 .. + 63) into a ring of
// `stages` stages with one bulk copy, and its 64 scales by cp.async, both
// completing on the stage's `full` barrier. Two consumer warpgroups each
// own NQ of the block's queries, stored once as wgmma's B operand; each
// reads the slab's codes as A fragments, decodes them to bf16 in
// registers, releases the stage (its `empty` barrier, one arrival a
// warp), multiplies on wgmma in its turn and folds the group into a
// running (max, group) in the accumulator layout. No block-wide barrier
// follows the set-up. Writes its [Q, B] plane at vals / rows +
// blockIdx.z * Q * B.
template <int NQ, int KB>
__global__ void __launch_bounds__(kInt8Threads, 1)
bucketed_int8_kernel(const bf16* __restrict__ q,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     float* __restrict__ vals, int* __restrict__ rows,
                     int num_q, int n, int buckets, int valid_rows,
                     float mask_value, int stages) {
  constexpr int R = NQ / 2;  // accumulators a thread
  constexpr int d = 64 * KB;  // features: KB k-blocks of 64
  // The query tile first (its K blocks 1024-byte aligned for the
  // swizzle), then the barriers and the ring.
  extern __shared__ __align__(1024) unsigned char smem_i8[];
  unsigned char* qs = smem_i8;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(qs + kConsumerWarpgroups * NQ * d * 2);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = reinterpret_cast<unsigned char*>(full) + kBarrierBytes;
  float* scale_ring = reinterpret_cast<float*>(ring + stages * d * kSlabRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kSlabRows;
  const int q0 = blockIdx.y * kConsumerWarpgroups * NQ;
  const int groups = n / buckets;
  const int g_begin = static_cast<int>(static_cast<int64_t>(groups) *
                                       blockIdx.z / gridDim.z);
  const int g_end = static_cast<int>(static_cast<int64_t>(groups) *
                                     (blockIdx.z + 1) / gridDim.z);
  const int slab_bytes = d * kSlabRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumerWarps);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // The producer: one warp keeps the ring full. 168 registers a thread
    // at launch; the producer's 144 fewer give the consumers 72 more.
    wg::regs_dec<24>();
    if (warp == kConsumerWarps) {
      // The block's last slab stops at bucket B (a row past it may be past
      // the corpus); the rows it leaves stale are never written out.
      const int slab_rows = min(kSlabRows, buckets - b0);
      const uint32_t bytes = static_cast<uint32_t>(slab_rows * d);
      int stage = 0;
      uint32_t phase = 0;
      for (int grp = g_begin; grp < g_end; ++grp) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        // The group's scales, two a lane, by cp.async (4-byte aligned
        // only), each lane's copies holding the stage's phase open until
        // they land; then lane 0's one bulk copy of the codes.
        const float* src = scales + static_cast<int64_t>(grp) * buckets + b0;
        for (int i = lane; i < slab_rows; i += 32) {
          cp_async4(scale_ring + stage * kSlabRows + i, src + i);
        }
        cp_async_arrive(&full[stage]);
        __syncwarp();
        if (lane == 0) {
          wg::mbar_expect_tx(&full[stage], bytes);
          wg::bulk_load(ring + stage * slab_bytes,
                        codes + (static_cast<int64_t>(grp) * buckets + b0) * d,
                        bytes, &full[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    wg::regs_inc<240>();
    // The consumer warpgroup, as a warp-uniform value (a warp reduce
    // lands in a uniform register), so that its B descriptors are formed
    // once, in uniform registers.
    const int wgi = __reduce_max_sync(0xffffffffu, warp >> 2);
    const int g = lane >> 2, t = lane & 3;
    // The query tile as B, once: warpgroup w's NQ queries at qs + w * NQ
    // * d * 2, features in `wg::code_k` order (rows past num_q zero).
    const int chunks = d / 8;
    for (int idx = threadIdx.x; idx < kConsumerWarpgroups * NQ * chunks;
         idx += 32 * kConsumerWarps) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < num_q) {
        v = *reinterpret_cast<const uint4*>(
            q + static_cast<int64_t>(q0 + r) * d + c);
      }
      unsigned char* dst = qs + (r / NQ) * NQ * d * 2;
      const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<bf16*>(
            dst + wg::b_offset<NQ>(r % NQ, wg::code_k(c + i))) = x[i];
      }
    }
    wg::fence_proxy_async();
    wg::named_sync(1, 32 * kConsumerWarps);

    const int ra = (warp & 3) * 16 + g;  // the thread's slab rows ra, ra + 8
    const int bucket_a = b0 + ra, bucket_b = bucket_a + 8;
    // The low word of the B descriptor of k-step 0 (wg::b_desc).
    const uint32_t b_lo = static_cast<uint32_t>(
        wg::b_desc<NQ>(tc::smem_addr(qs + wgi * NQ * d * 2), 0));
    float acc[R], best[R];
    int best_g[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // The first group always replaces this, so an all-masked bucket
      // reports its first row.
      best[i] = -CUDART_INF_F;
      best_g[i] = g_begin;
    }
    const uint32_t k43 = 0x43004300u;  // decode_kblock's constant
    uint32_t updated = 0;  // chunks fold_group_fast updated
    // The two warpgroups take turns at the tensor cores, a turn a group
    // (named barriers 2 and 3), so that one's products run while the
    // other folds: warpgroup 0 goes first.
    if (wgi == 1 && g_begin < g_end) wg::named_arrive(2, 32 * kConsumerWarps);
    int stage = 0;
    uint32_t phase = 0;
    for (int grp = g_begin; grp < g_end; ++grp) {
      const int row_a = grp * buckets + bucket_a;
      mbar_ready(&full[stage], phase);
      // The rows' scales, read before the stage is released.
      const float sa = scale_ring[stage * kSlabRows + ra];
      const float sb = scale_ring[stage * kSlabRows + ra + 8];
      const unsigned char* lo = ring + stage * slab_bytes + ra * d + 16 * t;
      // Two k-blocks a step, both decoded before their products are
      // issued as one commit group: no A register is written while a
      // product that reads one is in flight. At D = 128 the turn holds
      // the group's issues alone.
#pragma unroll
      for (int kb = 0; kb < KB; kb += 2) {
        uint32_t a0[4][4], a1[4][4];
        decode_kblock(lo, d, kb, k43, a0);
        decode_kblock(lo, d, kb + 1, k43, a1);
        const bool last = kb + 2 == KB;
        if (last) {
          // Every code of the stage is in registers: release it.
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(&empty[stage]);
        }
        if (kb == 0) wg::named_sync(2 + wgi, 32 * kConsumerWarps);
        wg::fence();
        wg::hold(acc);
        issue_kblock<NQ>(acc, a0, b_lo, kb);
        issue_kblock<NQ>(acc, a1, b_lo, kb + 1);
        wg::commit();
        // The other's turn as soon as the last product is issued
        // (warpgroup 1's last turn hands none on); the wait for them and
        // the fold run outside the turn, beside the other's products.
        if (last && (wgi == 0 || grp + 1 < g_end)) {
          wg::named_arrive(3 - wgi, 32 * kConsumerWarps);
        }
        wg::hold(acc);
        wg::wait<0>();
        wg::hold(acc);
      }
      if ((grp + 1) * buckets > valid_rows) {
        fold_group<R, true>(acc, best, best_g, grp, sa, sb, row_a,
                            valid_rows, mask_value);
      } else if (grp - g_begin >= kFastFoldAfter) {
        fold_group_fast<R>(acc, best, best_g, grp, sa, sb, updated);
      } else {
        fold_group<R, false>(acc, best, best_g, grp, sa, sb, row_a,
                             valid_rows, mask_value);
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (lane == 0) {
      // Groups the fast fold took: those past kFastFoldAfter, but not the
      // masked ones at the corpus' end.
      const int fast = max(0, min(g_end, valid_rows / buckets) -
                                  (g_begin + kFastFoldAfter));
      atomicAdd(&g_fold_checked, static_cast<unsigned long long>(fast) *
                                     (R / kFoldChunk));
      atomicAdd(&g_fold_updated, static_cast<unsigned long long>(updated));
    }
    const int64_t plane = static_cast<int64_t>(blockIdx.z) * num_q * buckets;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + wgi * NQ + 8 * (i >> 2) + 2 * t + (i & 1);
      const int bucket = (i & 2) ? bucket_b : bucket_a;
      if (qi < num_q && bucket < buckets) {
        const int64_t o = plane + static_cast<int64_t>(qi) * buckets + bucket;
        vals[o] = best[i];
        rows[o] = best_g[i] * buckets + bucket;
      }
    }
  }
}

template <int NQ, int KB>
cudaError_t launch_int8(const bf16* q, const int8_t* c, const float* scales,
                        float* vals, int* rows, int num_q, int64_t n, int d,
                        int buckets, int64_t valid_rows, float mask_value,
                        int splits, float* split_vals, int* split_rows,
                        cudaStream_t stream) {
  const size_t fixed = int8_smem(NQ, d, 0);
  const size_t slab = int8_smem(NQ, d, 1) - fixed;  // a stage
  const int stages = static_cast<int>(
      std::min<size_t>(kMaxStages, (kInt8MaxSmem - fixed) / slab));
  auto kernel = bucketed_int8_kernel<NQ, KB>;
  const size_t smem = int8_smem(NQ, d, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((buckets + kSlabRows - 1) / kSlabRows,
                  (num_q + 2 * NQ - 1) / (2 * NQ), splits);
  kernel<<<grid, kInt8Threads, smem, stream>>>(
      q, c, scales, splits > 1 ? split_vals : vals,
      splits > 1 ? split_rows : rows, num_q, static_cast<int>(n), buckets,
      static_cast<int>(std::min<int64_t>(valid_rows, n)), mask_value, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t plane = static_cast<int64_t>(num_q) * buckets;
  merge_splits_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256, 0,
                        stream>>>(split_vals, split_rows, plane, splits, vals,
                                  rows);
  return cudaGetLastError();
}

// The instance for D = d: a width of 128 to 768 features whose query tile
// and two stages fit a block's shared memory.
template <int NQ>
cudaError_t launch_int8_width(const bf16* q, const int8_t* c,
                              const float* scales, float* vals, int* rows,
                              int num_q, int64_t n, int d, int buckets,
                              int64_t valid_rows, float mask_value,
                              int splits, float* split_vals, int* split_rows,
                              cudaStream_t stream) {
  switch (d) {
#define RTPU_INT8(KB)                                                       \
  case 64 * KB:                                                             \
    if constexpr (int8_smem(NQ, 64 * KB, 2) <= kInt8MaxSmem) {             \
      return launch_int8<NQ, KB>(q, c, scales, vals, rows, num_q, n, d,     \
                                 buckets, valid_rows, mask_value, splits,   \
                                 split_vals, split_rows, stream);           \
    }                                                                       \
    break;
    RTPU_INT8(2)
    RTPU_INT8(4)
    RTPU_INT8(6)
    RTPU_INT8(8)
    RTPU_INT8(10)
    RTPU_INT8(12)
#undef RTPU_INT8
  }
  return cudaErrorInvalidValue;
}

// query_tile is the block's 2 NQ queries: 256, 128 or 64.
cudaError_t launch_int8_tile(int query_tile, const void* q, const void* c,
                             const float* scales, float* vals, int* rows,
                             int num_q, int64_t n, int d, int buckets,
                             int64_t valid_rows, float mask_value, int splits,
                             float* split_vals, int* split_rows,
                             cudaStream_t stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const int8_t* codes = static_cast<const int8_t*>(c);
  switch (query_tile) {
    case 256:
      return launch_int8_width<128>(qb, codes, scales, vals, rows, num_q, n,
                                    d, buckets, valid_rows, mask_value,
                                    splits, split_vals, split_rows, stream);
    case 128:
      return launch_int8_width<64>(qb, codes, scales, vals, rows, num_q, n,
                                   d, buckets, valid_rows, mask_value, splits,
                                   split_vals, split_rows, stream);
    case 64:
      return launch_int8_width<32>(qb, codes, scales, vals, rows, num_q, n,
                                   d, buckets, valid_rows, mask_value, splits,
                                   split_vals, split_rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int FMT, int TQ>
cudaError_t launch_tc(const void* q, const void* c, const float* scales,
                      float* vals, int* rows, int num_q, int64_t n, int d,
                      int buckets, int64_t valid_rows, float mask_value,
                      int splits, float* split_vals, int* split_rows,
                      cudaStream_t stream) {
  auto kernel = bucketed_tc_kernel<FMT, TQ>;
  const size_t smem = tc_smem(FMT, TQ, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((buckets + kTB - 1) / kTB, (num_q + TQ - 1) / TQ, splits);
  kernel<<<grid, TQ * 2, smem, stream>>>(
      q, c, scales, splits > 1 ? split_vals : vals,
      splits > 1 ? split_rows : rows, num_q, n, d, buckets, valid_rows,
      mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t plane = static_cast<int64_t>(num_q) * buckets;
  merge_splits_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256, 0,
                        stream>>>(split_vals, split_rows, plane, splits, vals,
                                  rows);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_format(int query_tile, const void* q, const void* c,
                          const float* scales, float* vals, int* rows,
                          int num_q, int64_t n, int d, int buckets,
                          int64_t valid_rows, float mask_value, int splits,
                          float* split_vals, int* split_rows,
                          cudaStream_t stream) {
  switch (query_tile) {
    case 128:
      return launch_tc<FMT, 128>(q, c, scales, vals, rows, num_q, n, d,
                                 buckets, valid_rows, mask_value, splits,
                                 split_vals, split_rows, stream);
    case 64:
      return launch_tc<FMT, 64>(q, c, scales, vals, rows, num_q, n, d,
                                buckets, valid_rows, mask_value, splits,
                                split_vals, split_rows, stream);
    case 32:
      if constexpr (FMT == kF32) {
        return launch_tc<FMT, 32>(q, c, scales, vals, rows, num_q, n, d,
                                  buckets, valid_rows, mask_value, splits,
                                  split_vals, split_rows, stream);
      }
      [[fallthrough]];
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// format: 0 = rows, 1 = int8 codes, 2 = packed int4 codes.
// bf16: for format 0, 1 when q and the rows are bf16, 0 when both are f32;
// q is bf16 for formats 1 and 2.
// n is the logical row count (twice the packed rows for format 2).
// query_tile (128 or 64; f32 rows also 32) and splits (1 .. N/B groups)
// shape the launch; with splits > 1, split_vals / split_rows hold
// splits * Q * B entries.
// Returns the cudaError_t of the launches (0 on success).
int bucketed_scores_launch(int format, int bf16, const void* q, const void* c,
                           const float* scales, float* vals, int* rows,
                           int num_q, long long n, int d, int buckets,
                           long long valid_rows, float mask_value,
                           int query_tile, int splits, float* split_vals,
                           int* split_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t groups = buckets > 0 ? n / buckets : 0;
  if (num_q <= 0 || buckets <= 0 || d <= 0 || n % buckets != 0 ||
      d % kKC != 0 || splits < 1 || splits > groups ||
      (splits > 1 && (split_vals == nullptr || split_rows == nullptr)) ||
      (format == kPacked4 && groups % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (format == kRows && !bf16 ? kF32 : format) {
    case kF32:
      return launch_format<kF32>(query_tile, q, c, scales, vals, rows, num_q,
                                 n, d, buckets, valid_rows, mask_value,
                                 splits, split_vals, split_rows, s);
    case kRows:
      return launch_format<kRows>(query_tile, q, c, scales, vals, rows,
                                  num_q, n, d, buckets, valid_rows,
                                  mask_value, splits, split_vals, split_rows,
                                  s);
    case kInt8:
      return launch_int8_tile(query_tile, q, c, scales, vals, rows, num_q, n,
                              d, buckets, valid_rows, mask_value, splits,
                              split_vals, split_rows, s);
    case kPacked4:
      return launch_format<kPacked4>(query_tile, q, c, scales, vals, rows,
                                     num_q, n, d, buckets, valid_rows,
                                     mask_value, splits, split_vals,
                                     split_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fast fold's chunks checked and updated (`bucketed_int8_kernel`)
// since the library loaded or the last reset; waits for the device. For
// the end of a run, never inside a request.
int bucketed_scores_fold_counts(long long* checked, long long* updated,
                                int reset) {
  unsigned long long c = 0, u = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&c, g_fold_checked, sizeof(c));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(&u, g_fold_updated, sizeof(u));
  }
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_fold_checked, &zero, sizeof(zero));
    if (err == cudaSuccess) {
      err = cudaMemcpyToSymbol(g_fold_updated, &zero, sizeof(zero));
    }
  }
  *checked = static_cast<long long>(c);
  *updated = static_cast<long long>(u);
  return static_cast<int>(err);
}

const char* bucketed_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
