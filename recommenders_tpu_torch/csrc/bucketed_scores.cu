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
// r >= valid_rows. Rows are visited in ascending order and replace the
// running best only when strictly greater, so ties go to the lowest row,
// as jnp.argmax does in the reference. The exact top-k over the [Q, B]
// state runs outside the kernel (torch.topk), as it does in the JAX package.
//
// Corpus formats (one template, three layouts):
//   kRows    f32 rows with an f32 query, or bf16 rows with a bf16 query
//            (bf16 x bf16 products are exact in f32; the sum is f32).
//   kInt8    int8 codes [N, D] plus f32 scales [N]. The query arrives
//            rounded to bf16 and the codes are exact in bf16, so every
//            product is exact in f32; the scale multiplies after the dot.
//   kPacked4 int4 codes packed two per byte along rows, [N/2, D]: byte
//            (c, d) holds row c in its low nibble and row c + N/2 in its
//            high nibble. The byte sign-extends to int32 and decodes as
//            lo = (p << 28) >> 28, hi = p >> 4 (arithmetic shift).
//
// What bounds it on the H100. At Q=1024, N=1M, D=128 the work is
// 2*Q*N*D = 2.7e11 FLOP, while one sweep of the corpus reads 512 MB (f32),
// 256 MB (bf16), 128 MB (int8) or 64 MB (int4): hundreds of FLOP per byte,
// so the kernel is bound by arithmetic, not by memory.
//
// What the design does about it. The TPU ran its grid (query tile, corpus
// chunk) in order and carried the running max/argmax in VMEM across
// chunks. Hopper runs blocks in no order, so here each block owns one
// 64-query x 64-bucket tile of the output and walks every row group g
// itself. Its running max/argmax lives in registers: no cross-block
// reduction, no atomics, and the [Q, N] score matrix never exists. The
// query tile sits in shared memory for the whole sweep; each group's
// 64-row corpus slab is staged through shared memory 32 columns at a time,
// decoded to f32 on the way in. Each thread accumulates 4 queries x 4
// buckets with f32 FMAs on the CUDA cores, which keeps the arithmetic the
// same as the plain PyTorch twin's. The 16 query tiles that share a
// bucket range read the same corpus rows at about the same time, so most
// of the 16 re-reads per corpus row come from L2. Tensor cores (wgmma) and
// a TMA pipeline are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTQ = 64;        // queries per block
constexpr int kTB = 64;        // buckets per block
constexpr int kKC = 32;        // feature columns per shared-memory stage
constexpr int kCStride = kTB + 1;  // padded row of the staged slab (no bank conflicts)
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 queries x 4 buckets

enum Format { kRows = 0, kInt8 = 1, kPacked4 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Loads feature columns [col, col + 8) of logical corpus row `row` as f32.
template <int FMT, typename CT>
__device__ __forceinline__ void load8(const CT* __restrict__ c, int64_t row,
                                      int d, int col, int64_t half_rows,
                                      float out[8]) {
  if constexpr (FMT == kRows && std::is_same<CT, float>::value) {
    const float4* p = reinterpret_cast<const float4*>(c + row * d + col);
    const float4 a = __ldg(p);
    const float4 b = __ldg(p + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (FMT == kRows) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(c + row * d + col));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
  } else if constexpr (FMT == kInt8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(c + row * d + col));
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(b[j]);
  } else {
    const bool high = row >= half_rows;
    const int64_t packed_row = high ? row - half_rows : row;
    const uint2 u =
        __ldg(reinterpret_cast<const uint2*>(c + packed_row * d + col));
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = b[j];
      const int code =
          high ? (p >> 4)
               : (static_cast<int>(static_cast<unsigned>(p) << 28) >> 28);
      out[j] = static_cast<float>(code);
    }
  }
}

template <int FMT, typename QT, typename CT>
__global__ void __launch_bounds__(kThreads)
bucketed_scores_kernel(const QT* __restrict__ q, const CT* __restrict__ c,
                       const float* __restrict__ scales,
                       float* __restrict__ vals, int* __restrict__ rows,
                       int num_q, int64_t n, int d, int buckets,
                       int64_t valid_rows, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // [d][kTQ]: query tile, transposed
  float* cs = smem + static_cast<size_t>(d) * kTQ;  // [kKC][kCStride]: corpus stage

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // buckets tx + 16*j
  const int ty = tid / 16;  // queries 4*ty + i
  const int q0 = blockIdx.y * kTQ;
  const int b0 = blockIdx.x * kTB;
  const int64_t half_rows = n / 2;

  for (int idx = tid; idx < kTQ * d; idx += kThreads) {
    const int qi = idx / d;
    const int k = idx - qi * d;
    const int qrow = q0 + qi;
    qs[k * kTQ + qi] =
        qrow < num_q ? to_float(q[static_cast<int64_t>(qrow) * d + k]) : 0.f;
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
    for (int k0 = 0; k0 < d; k0 += kKC) {
      float v[8];
      if (load_ok) {
        load8<FMT>(c, base + load_bucket, d, k0 + load_col, half_rows, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      __syncthreads();  // The previous stage is consumed; qs is written.
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(load_col + j) * kCStride + load_bucket] = v[j];
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
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
      float scale = 1.f;
      if constexpr (FMT != kRows) {
        scale = b < buckets ? __ldg(scales + r) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        if constexpr (FMT != kRows) s *= scale;
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

template <int FMT, typename QT, typename CT>
cudaError_t launch(const void* q, const void* c, const float* scales,
                   float* vals, int* rows, int num_q, int64_t n, int d,
                   int buckets, int64_t valid_rows, float mask_value,
                   cudaStream_t stream) {
  auto kernel = bucketed_scores_kernel<FMT, QT, CT>;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d) * kTQ + kKC * kCStride);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((buckets + kTB - 1) / kTB, (num_q + kTQ - 1) / kTQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), scales, vals,
      rows, num_q, n, d, buckets, valid_rows, mask_value);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// format: 0 = rows, 1 = int8 codes, 2 = packed int4 codes.
// bf16: for format 0, 1 when q and the rows are bf16, 0 when both are f32.
// n is the logical row count (twice the packed rows for format 2).
// Returns the cudaError_t of the launch (0 on success).
int bucketed_scores_launch(int format, int bf16, const void* q, const void* c,
                           const float* scales, float* vals, int* rows,
                           int num_q, long long n, int d, int buckets,
                           long long valid_rows, float mask_value,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (format) {
    case kRows:
      if (bf16) {
        return launch<kRows, __nv_bfloat16, __nv_bfloat16>(
            q, c, scales, vals, rows, num_q, n, d, buckets, valid_rows,
            mask_value, s);
      }
      return launch<kRows, float, float>(q, c, scales, vals, rows, num_q, n,
                                         d, buckets, valid_rows, mask_value,
                                         s);
    case kInt8:
      return launch<kInt8, __nv_bfloat16, int8_t>(
          q, c, scales, vals, rows, num_q, n, d, buckets, valid_rows,
          mask_value, s);
    case kPacked4:
      return launch<kPacked4, __nv_bfloat16, int8_t>(
          q, c, scales, vals, rows, num_q, n, d, buckets, valid_rows,
          mask_value, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bucketed_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
