// Flash-style in-batch softmax cross-entropy for retrieval training,
// written for Hopper (sm_90a): forward, dQ and dC.
//
// Replaces the TPU kernel family K2:
// recommenders_tpu/ops/fused_retrieval.py::fused_retrieval_loss (:307,
// built by _make_fused :202, pallas_calls :215, :262, :275) and its
// Pallas bodies _fwd_kernel (:97), _dq_kernel (:130) and _dc_kernel (:160).
//
// What it computes. Queries q [B, D] and candidates c [C, D] (f32,
// C >= B; row i of c is query i's positive). Every logit is built as the
// TPU kernel's _score_tile (:62-94) builds it, in this order:
//   s_ij = q_i . c_j            (f32 sums; with bf16 on, q and c are
//                                rounded to bf16 first: exact products)
//   s_ij = s_ij / divisor       (divisor = 1/(1/temperature), a division)
//   s_ij = s_ij - logq_j        (log-q correction, when given)
//   s_ij = s_ij + MIN_FLOAT     (accidental hit: ids_i == ids_j, i != j)
// and y_ij = (i == j).
//   fwd: lse_i = log sum_j exp(s_ij) (online, per query row), pos_i = s_ii.
//        The loss sum_i w_i (lse_i - pos_i) is summed outside the kernel.
//   dq:  dq_i = inv_temp * sum_j (exp(s_ij - lse_i) - y_ij) c_j
//   dc:  dc_j = inv_temp * sum_i (exp(s_ij - lse_i) - y_ij) w_i q_i
// With bf16 on, the probability coefficients and the operand they
// multiply are rounded to bf16 before each product, and sums are f32.
// The upstream gradient and the weights of dq multiply outside.
//
// What bounds it on the H100. At the training step's shape (B = C =
// 4096, D = 64) the model work is three products of 2*B*C*D = 2.1 GFLOP
// each (6.4 GFLOP; the backward's recomputed scores add two more), while
// the inputs and outputs are a few MB: the kernels are bound by
// arithmetic, at about 6.5 us against the bf16 tensor-core peak and
// 96 us against the f32 CUDA-core peak.
//
// What the design does about it. The TPU ran an ordered grid and carried
// the running (max, sum-exp) and the dQ / dC accumulators in VMEM across
// grid steps. Here a block owns a 64-row tile of the output and loops
// over the other operand's 64-row tiles itself, so every running value
// lives in registers: no cross-block reduction, no atomics, and the
// [B, C] score matrix never leaves the block. Both operand tiles sit in
// shared memory transposed (a padded stride of 65 keeps the banks apart);
// 256 threads each own 4 x 4 scores and, in the backward kernels, 4 rows
// x D/16 columns of the accumulator. The products are f32 FMAs on the
// CUDA cores: right first; tensor cores (wgmma), TMA and a split over the
// loop dimension for more blocks are later work. Ragged tile edges are
// masked, so any B, C >= B and D <= 256 run through the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of each operand tile
constexpr int kS = kT + 1;      // padded shared-memory stride
constexpr int kThreads = 256;   // 16 x 16; each owns 4 x 4 scores
constexpr int kMaxCols = 16;    // accumulator columns a thread owns (D <= 256)
constexpr float kMinFloat = -3.4028234663852886e+36f;  // f32 min / 100

struct Score {
  const float* logq;   // [C] or null
  const int* ids;      // [C] or null (no accidental-hit removal)
  float divisor;       // used when has_div
  int has_div;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst[k * kS + r] = src[(row0 + r) * d + k] for r < kT, zero past `rows`.
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
                                            int row0, int rows, int d,
                                            int bf16) {
  for (int idx = threadIdx.x; idx < kT * d; idx += kThreads) {
    const int r = idx / d;
    const int k = idx - r * d;
    float x = 0.f;
    if (row0 + r < rows) {
      x = src[static_cast<int64_t>(row0 + r) * d + k];
      if (bf16) x = round_bf16(x);
    }
    dst[k * kS + r] = x;
  }
}

// acc[i][j] = a-tile row (4*ty + i) . b-tile row (tx + 16*j).
__device__ __forceinline__ void tile_dots(const float* as, const float* bs,
                                          int d, int ty, int tx,
                                          float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k = 0; k < d; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[k * kS + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[k * kS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// The corrected logit of query `row`, candidate `col` (the order of
// _score_tile).
__device__ __forceinline__ float correct(float s, int row, int col,
                                         const Score& sc) {
  if (sc.has_div) s = __fdiv_rn(s, sc.divisor);
  if (sc.logq != nullptr) s = __fsub_rn(s, __ldg(sc.logq + col));
  if (sc.ids != nullptr && row != col &&
      __ldg(sc.ids + row) == __ldg(sc.ids + col)) {
    s = __fadd_rn(s, kMinFloat);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ c, int b,
           int cn, int d, Score sc, int bf16, float* __restrict__ lse,
           float* __restrict__ pos) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* cs = smem + d * kS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kT;
  load_tile_t(qs, q, q0, b, d, bf16);

  float m[4], l[4], p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
    p[i] = 0.f;
  }
  for (int c0 = 0; c0 < cn; c0 += kT) {
    __syncthreads();
    load_tile_t(cs, c, c0, cn, d, bf16);
    __syncthreads();
    float acc[4][4];
    tile_dots(qs, cs, d, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row >= b) continue;
      float s[4];
      float tmax = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        s[j] = col < cn ? correct(acc[i][j], row, col, sc) : -FLT_MAX;
        if (col < cn) {
          tmax = fmaxf(tmax, s[j]);
          if (col == row) p[i] += s[j];
        }
      }
      const float m_new = fmaxf(m[i], tmax);
      float sum = l[i] * expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + tx + 16 * j < cn) sum += expf(s[j] - m_new);
      }
      l[i] = sum;
      m[i] = m_new;
    }
  }
  // Fold the 16 threads that share each row.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float po = __shfl_xor_sync(0xffffffffu, p[i], off);
      const float mm = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mm) + lo * expf(mo - mm);
      m[i] = mm;
      p[i] += po;
    }
    const int row = q0 + 4 * ty + i;
    if (tx == 0 && row < b) {
      lse[row] = m[i] + logf(l[i]);
      pos[row] = p[i];
    }
  }
}

// dq (MODE 0): the block owns 64 queries and loops over candidate tiles.
// dc (MODE 1): the block owns 64 candidates and loops over query tiles.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ q, const float* __restrict__ c, int b,
           int cn, int d, Score sc, int bf16, const float* __restrict__ lse,
           const float* __restrict__ w, float inv_temp,
           float* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* cs = smem + d * kS;
  float* ps = smem + 2 * d * kS;  // [64 queries][kS]: coefficients
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int own0 = blockIdx.x * kT;
  if (MODE == 0) {
    load_tile_t(qs, q, own0, b, d, bf16);
  } else {
    load_tile_t(cs, c, own0, cn, d, bf16);
  }
  float acc_out[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc_out[i][j] = 0.f;
  }
  const int loop_rows = MODE == 0 ? cn : b;
  for (int t0 = 0; t0 < loop_rows; t0 += kT) {
    const int q0 = MODE == 0 ? own0 : t0;
    const int c0 = MODE == 0 ? t0 : own0;
    __syncthreads();
    if (MODE == 0) {
      load_tile_t(cs, c, c0, cn, d, bf16);
    } else {
      load_tile_t(qs, q, q0, b, d, bf16);
    }
    __syncthreads();
    float acc[4][4];
    tile_dots(qs, cs, d, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      const float lse_row = row < b ? __ldg(lse + row) : 0.f;
      const float w_row =
          (MODE == 1 && w != nullptr && row < b) ? __ldg(w + row) : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float pij = 0.f;
        if (row < b && col < cn) {
          const float s = correct(acc[i][j], row, col, sc);
          pij = __fsub_rn(expf(__fsub_rn(s, lse_row)), row == col ? 1.f : 0.f);
          if (MODE == 1) pij = __fmul_rn(pij, w_row);
          if (bf16) pij = round_bf16(pij);
        }
        ps[(4 * ty + i) * kS + tx + 16 * j] = pij;
      }
    }
    __syncthreads();
    // MODE 0: out row (4ty+i) = query, sum over the tile's candidates.
    // MODE 1: out row (4ty+i) = candidate, sum over the tile's queries.
    for (int k = 0; k < kT; ++k) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = MODE == 0 ? ps[(4 * ty + i) * kS + k] : ps[k * kS + 4 * ty + i];
      }
      const float* other = MODE == 0 ? cs : qs;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float ov = other[col * kS + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_out[i][j] = fmaf(pv[i], ov, acc_out[i][j]);
          }
        }
      }
    }
  }
  const int own_rows = MODE == 0 ? b : cn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = own0 + 4 * ty + i;
    if (row >= own_rows) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        out[static_cast<int64_t>(row) * d + col] =
            __fmul_rn(acc_out[i][j], inv_temp);
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Shared by the three entry points: logq and ids may be null; has_div
// says whether to divide the raw scores by `divisor`; bf16 rounds the
// operands (and the backward coefficients) to bf16 before each product.
// Each returns the cudaError_t of its launch (0 on success).

int fused_retrieval_fwd(const float* q, const float* c, int b, int cn, int d,
                        const float* logq, const int* ids, int has_div,
                        float divisor, int bf16, float* lse, float* pos,
                        void* stream) {
  if (d <= 0 || d > 16 * kMaxCols || b <= 0 || cn < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Score sc{logq, ids, divisor, has_div};
  const size_t smem = sizeof(float) * 2 * d * kS;
  cudaError_t err = set_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<<<(b + kT - 1) / kT, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(q, c, b, cn, d, sc, bf16,
                                                    lse, pos);
  return cudaGetLastError();
}

// mode 0: out = dq [b, d]; mode 1: out = dc [cn, d] (w may be null).
int fused_retrieval_bwd(int mode, const float* q, const float* c, int b,
                        int cn, int d, const float* logq, const int* ids,
                        int has_div, float divisor, int bf16,
                        const float* lse, const float* w, float inv_temp,
                        float* out, void* stream) {
  if (d <= 0 || d > 16 * kMaxCols || b <= 0 || cn < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Score sc{logq, ids, divisor, has_div};
  const size_t smem = sizeof(float) * (2 * d * kS + kT * kS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = set_smem(bwd_kernel<0>, smem);
    if (err != cudaSuccess) return err;
    bwd_kernel<0><<<(b + kT - 1) / kT, kThreads, smem, s>>>(
        q, c, b, cn, d, sc, bf16, lse, w, inv_temp, out);
  } else if (mode == 1) {
    err = set_smem(bwd_kernel<1>, smem);
    if (err != cudaSuccess) return err;
    bwd_kernel<1><<<(cn + kT - 1) / kT, kThreads, smem, s>>>(
        q, c, b, cn, d, sc, bf16, lse, w, inv_temp, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cudaGetLastError();
}

const char* fused_retrieval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
