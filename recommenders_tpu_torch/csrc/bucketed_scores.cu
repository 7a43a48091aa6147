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
// bf16 / int8 / int4 take 1.22 / 1.45 / 1.51 ms and f32 4.5 ms (the
// CUDA-core body 8.5). The tensor cores do not set the one-pass bodies'
// pace: each stage waits at two (bf16) or three (codes) block barriers,
// and warps resident matter more than shared-memory traffic (keeping a
// warp's query fragments in registers instead of reloading them every
// group needs 220+ registers, one block an SM, and was slower on that
// card). wgmma with a TMA ring is the next step.
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
//   bf16 / int8 / int4: TQ = 128 (64 for D > 512), two blocks an SM; the
//   codes are decoded to bf16 in shared memory (int8 sign-extends; int4
//   takes the low or the high nibble by the group's half of the corpus)
//   with integer and f32 tricks, not the quarter-rate int-to-float unit.
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

#include "tensor_core.cuh"

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
      // Decode the codes to bf16 (exact), 8 a thread per step.
      const int8_t* src = raw + (s & 1) * kTB * kKC;
      const bool high = FMT == kPacked4 && grp >= half_groups;
      for (int idx = tid; idx < kTB * (kKC / 8); idx += kThreadsTc) {
        const int i = idx / (kKC / 8);
        const int u = idx % (kKC / 8);
        const uint2 word = *reinterpret_cast<const uint2*>(src + i * kKC + u * 8);
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t w = j == 0 ? word.x : word.y;
          if constexpr (FMT == kInt8) {
            packed[2 * j] = tc::int8x2_to_bf16x2(w ^ 0x80808080u, 0);
            packed[2 * j + 1] = tc::int8x2_to_bf16x2(w ^ 0x80808080u, 2);
          } else {
            // Bytes (0, 1) and (2, 3) spread to the two 16-bit halves;
            // the group's half of the corpus picks the nibble.
            const int shift = high ? 4 : 0;
            packed[2 * j] =
                tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4140) >> shift);
            packed[2 * j + 1] =
                tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4342) >> shift);
          }
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
          if constexpr (FMT == kInt8 || FMT == kPacked4) {
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
      return launch_format<kInt8>(query_tile, q, c, scales, vals, rows,
                                  num_q, n, d, buckets, valid_rows,
                                  mask_value, splits, split_vals, split_rows,
                                  s);
    case kPacked4:
      return launch_format<kPacked4>(query_tile, q, c, scales, vals, rows,
                                     num_q, n, d, buckets, valid_rows,
                                     mask_value, splits, split_vals,
                                     split_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bucketed_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
