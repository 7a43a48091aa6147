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
// Corpus formats:
//   f32 rows with an f32 query: exact f32 FMAs on the CUDA cores.
//   bf16 rows with a bf16 query; int8 codes [N, D] plus f32 scales [N];
//   int4 codes packed two per byte along rows, [N/2, D] (byte (c, d) holds
//   row c in its low nibble and row c + N/2 in its high nibble; it
//   sign-extends and decodes as lo = (p << 28) >> 28, hi = p >> 4). For
//   these three the query is bf16 (the wrapper rounds it for codes) and
//   every code is exact in bf16, so each product is exact in f32 on the
//   bf16 tensor cores; sums are f32 and the scale multiplies after the dot.
//
// What bounds it on the H100. At Q=1024, N=1M, D=128 the work is
// 2*Q*N*D = 2.7e11 FLOP, while one sweep of the corpus reads 512 MB (f32),
// 256 MB (bf16), 128 MB (int8) or 64 MB (int4): hundreds of FLOP per byte,
// so the kernel is bound by arithmetic: 0.27 ms at the bf16 tensor-core
// peak, 3.9 ms at the f32 CUDA-core peak. On an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py) bf16 / int8 / int4 take 1.22 / 1.45 / 1.51 ms
// (the CUDA-core design this replaces took 8.0-8.8 ms) and f32 8.54 ms.
// The tensor cores do not set the tensor-core bodies' pace: each stage
// waits at two (bf16) or three (codes) block barriers, and warps resident
// matter more than shared-memory traffic (keeping a warp's query
// fragments in registers instead of reloading them every group needs 220+
// registers, one block an SM, and was slower on that card). wgmma with a
// TMA ring is the next step.
//
// What the design does about it. The TPU ran its grid (query tile, corpus
// chunk) in order and carried the running max/argmax in VMEM across
// chunks. Here a block owns a TQ-query x 64-bucket tile of the output and
// walks the row groups g itself, its running max/argmax in registers; the
// [Q, N] score matrix never exists.
//   bf16 / int8 / int4: TQ = 128 (64 for D > 512) queries in shared memory
//   for the whole sweep; each group's 64-row corpus slab, 128 feature
//   columns a stage, comes in by cp.async into a double buffer while the
//   previous stage is in use, and the codes are decoded to bf16 in shared
//   memory (int8 sign-extends; int4 takes the low or the high nibble by the
//   group's half of the corpus) with integer and f32 tricks, not the
//   quarter-rate int-to-float unit. Eight warps, each 32 queries x 32 buckets,
//   multiply with mma.sync.m16n8k16 (tensor_core.cuh); the epilogue scales,
//   masks and folds the f32 accumulator fragments into a running (max,
//   row) held in the same fragment layout. Where the tiles leave fewer than
//   two blocks an SM, the wrapper splits the group walk over `splits`
//   blocks, each over a contiguous range of groups, and a second kernel
//   merges their (value, lowest row) pairs: that merge is associative and
//   commutative, so the result equals the unsplit walk's.
//   f32: a block owns 64 queries x 64 buckets, each thread 4 x 4, the
//   slab staged through shared memory 32 columns at a time (exact f32, as
//   the plain PyTorch twin computes it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Format { kRows = 0, kInt8 = 1, kPacked4 = 2 };

// Replaces (best, best_row) by (v, r) if v is larger, or equal with a
// lower row.
__device__ __forceinline__ void keep_best(float& best, int& best_row, float v,
                                          int r) {
  if (v > best || (v == best && r < best_row)) {
    best = v;
    best_row = r;
  }
}

// --- f32 rows: CUDA-core FMAs ------------------------------------------------

constexpr int kTQ = 64;        // queries per block
constexpr int kTB = 64;        // buckets per block (both paths)
constexpr int kKC32 = 32;      // feature columns per shared-memory stage
constexpr int kCStride = kTB + 1;  // padded row of the staged slab (no bank conflicts)
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 queries x 4 buckets

// Loads feature columns [col, col + 8) of corpus row `row`.
__device__ __forceinline__ void load8(const float* __restrict__ c,
                                      int64_t row, int d, int col,
                                      float out[8]) {
  const float4* p = reinterpret_cast<const float4*>(c + row * d + col);
  const float4 a = __ldg(p);
  const float4 b = __ldg(p + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
bucketed_f32_kernel(const float* __restrict__ q, const float* __restrict__ c,
                    float* __restrict__ vals, int* __restrict__ rows,
                    int num_q, int64_t n, int d, int buckets,
                    int64_t valid_rows, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [d][kTQ]: query tile, transposed
  float* cs = smem + static_cast<size_t>(d) * kTQ;  // [kKC32][kCStride]: corpus stage

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // buckets tx + 16*j
  const int ty = tid / 16;  // queries 4*ty + i
  const int q0 = blockIdx.y * kTQ;
  const int b0 = blockIdx.x * kTB;

  for (int idx = tid; idx < kTQ * d; idx += kThreads) {
    const int qi = idx / d;
    const int k = idx - qi * d;
    const int qrow = q0 + qi;
    qs[k * kTQ + qi] =
        qrow < num_q ? q[static_cast<int64_t>(qrow) * d + k] : 0.f;
  }

  float best[4][4];
  int best_row[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Group 0 always replaces this, so an all-masked bucket reports its
      // first row, as argmax over the group axis does.
      best[i][j] = -CUDART_INF_F;
      best_row[i][j] = b0 + tx + 16 * j;
    }
  }

  // The row and 8 columns of each stage that this thread stages.
  const int load_bucket = tid / 4;
  const int load_col = (tid % 4) * 8;
  const bool load_ok = b0 + load_bucket < buckets;

  const int64_t groups = n / buckets;
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t base = g * buckets + b0;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += kKC32) {
      float v[8];
      if (load_ok) {
        load8(c, base + load_bucket, d, k0 + load_col, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      __syncthreads();  // The previous stage is consumed; qs is written.
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(load_col + j) * kCStride + load_bucket] = v[j];
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC32; ++kk) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(k0 + kk) * kTQ + 4 * ty]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        float cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = cs[kk * kCStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], cv[j], acc[i][j]);
        }
      }
    }
    // Fold group g into the running per-bucket max/argmax.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      const int64_t r = g * buckets + b;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        if (r >= valid_rows) s = mask_value;
        if (s > best[i][j]) {
          best[i][j] = s;
          best_row[i][j] = static_cast<int>(r);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (qrow < num_q && b < buckets) {
        const int64_t o = static_cast<int64_t>(qrow) * buckets + b;
        vals[o] = best[i][j];
        rows[o] = best_row[i][j];
      }
    }
  }
}

// --- bf16 rows, int8 and int4 codes: tensor cores ---------------------------

constexpr int kKC = 128;           // feature columns per stage
constexpr int kSlab = kKC + 8;     // bf16 stride of a staged slab row

// Shared bytes: the query tile, and the slab ring (bf16 rows), or the
// decoded slab plus the ring of raw code slabs (int8, int4).
size_t tc_smem(int fmt, int tq, int d) {
  const size_t q_bytes = sizeof(bf16) * tq * (d + 8);
  const size_t slab = sizeof(bf16) * kTB * kSlab;
  return q_bytes + (fmt == kRows ? 2 * slab : slab + 2 * kTB * kKC);
}

// A block owns TQ queries x 64 buckets and walks groups [g_begin, g_end)
// of its split (blockIdx.z of gridDim.z); (TQ / 32) x 2 warps own 32
// queries x 32 buckets each. Writes its [Q, B] plane at
// vals / rows + blockIdx.z * Q * B.
template <int FMT, int TQ>
__global__ void __launch_bounds__(TQ * 2, 2)
bucketed_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ c,
                   const float* __restrict__ scales,
                   float* __restrict__ vals, int* __restrict__ rows,
                   int num_q, int64_t n, int d, int buckets,
                   int64_t valid_rows, float mask_value) {
  constexpr int kThreadsTc = TQ * 2;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int qstride = d + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [TQ][d + 8]
  bf16* slabs = qs + TQ * qstride;  // bf16: 2 x [kTB][kSlab]; codes: [kTB][kSlab]
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

  // The query tile, once (rows past num_q are zeros).
  const int q_chunks = d / 8;
  for (int idx = tid; idx < TQ * q_chunks; idx += kThreadsTc) {
    const int r = idx / q_chunks;
    const int ch = idx - r * q_chunks;
    const bool ok = q0 + r < num_q;
    tc::cp_async16(qs + r * qstride + ch * 8,
                   ok ? q + static_cast<int64_t>(q0 + r) * d + ch * 8 : q,
                   ok ? 16 : 0);
  }

  // Stage s: group g_begin + s / kchunks, columns (s % kchunks) * kKC.
  auto stage_slab = [&](int64_t s) {
    const int64_t grp = g_begin + s / kchunks;
    const int col0 = static_cast<int>(s % kchunks) * kKC;
    if constexpr (FMT == kRows) {
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
  float acc[2][4][4];
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) stage_slab(s + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int64_t grp = g_begin + s / kchunks;
    const int kc = static_cast<int>(s % kchunks);
    const bf16* slab;
    if constexpr (FMT == kRows) {
      slab = slabs + (s & 1) * kTB * kSlab;
    } else {
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
      slab = slabs;
    }
    if (kc == 0) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;
        }
      }
    }
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
        tc::load_b(bb, slab + (wb * 32 + nb2 * 16) * kSlab, kSlab, k0, lane);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          tc::mma_bf16(acc[mb][2 * nb2], a[mb], bb[0], bb[1]);
          tc::mma_bf16(acc[mb][2 * nb2 + 1], a[mb], bb[2], bb[3]);
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
          if constexpr (FMT != kRows) {
            scale = bucket < buckets ? __ldg(scales + r) : 0.f;
          }
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = acc[mb][nb][2 * h + e];
              if constexpr (FMT != kRows) v *= scale;
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
      static_cast<const bf16*>(q), c, scales, splits > 1 ? split_vals : vals,
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
  if (query_tile == 128) {
    return launch_tc<FMT, 128>(q, c, scales, vals, rows, num_q, n, d,
                               buckets, valid_rows, mask_value, splits,
                               split_vals, split_rows, stream);
  }
  return launch_tc<FMT, 64>(q, c, scales, vals, rows, num_q, n, d, buckets,
                            valid_rows, mask_value, splits, split_vals,
                            split_rows, stream);
}

}  // namespace

extern "C" {

// format: 0 = rows, 1 = int8 codes, 2 = packed int4 codes.
// bf16: for format 0, 1 when q and the rows are bf16, 0 when both are f32;
// q is bf16 for formats 1 and 2.
// n is the logical row count (twice the packed rows for format 2).
// query_tile (64 or 128) and splits (1 .. N/B groups) shape the
// tensor-core path; with splits > 1, split_vals / split_rows hold
// splits * Q * B entries. The f32 path ignores the three.
// Returns the cudaError_t of the launches (0 on success).
int bucketed_scores_launch(int format, int bf16, const void* q, const void* c,
                           const float* scales, float* vals, int* rows,
                           int num_q, long long n, int d, int buckets,
                           long long valid_rows, float mask_value,
                           int query_tile, int splits, float* split_vals,
                           int* split_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_q <= 0 || buckets <= 0 || d <= 0 || n % buckets != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (format == kRows && !bf16) {
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(d) * kTQ + kKC32 * kCStride);
    cudaError_t err = cudaFuncSetAttribute(
        bucketed_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((buckets + kTB - 1) / kTB, (num_q + kTQ - 1) / kTQ);
    bucketed_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), vals,
        rows, num_q, n, d, buckets, valid_rows, mask_value);
    return cudaGetLastError();
  }
  const int64_t groups = n / buckets;
  if (d % kKC != 0 || (query_tile != 64 && query_tile != 128) ||
      splits < 1 || splits > groups ||
      (splits > 1 && (split_vals == nullptr || split_rows == nullptr)) ||
      (format == kPacked4 && groups % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (format) {
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
