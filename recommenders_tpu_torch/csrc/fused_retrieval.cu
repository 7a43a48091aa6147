// Flash-style in-batch softmax cross-entropy for retrieval training,
// written for Hopper (sm_90a): forward, dQ and dC.
//
// Replaces the TPU kernel family K2:
// recommenders_tpu/ops/fused_retrieval.py::fused_retrieval_loss (:307,
// built by _make_fused :202, pallas_calls :215, :262, :275) and its
// Pallas bodies _fwd_kernel (:97), _dq_kernel (:130) and _dc_kernel (:160).
//
// What it computes. Queries q [B, D] and candidates c [C, D] (C >= B;
// row i of c is query i's positive). Every logit is built as the TPU
// kernel's _score_tile (:62-94) builds it, in this order:
//   s_ij = q_i . c_j            (f32 sums; with bf16 scores q and c arrive
//                                rounded to bf16: exact products)
//   s_ij = s_ij / divisor       (divisor = 1/(1/temperature), a division)
//   s_ij = s_ij - logq_j        (log-q correction, when given)
//   s_ij = s_ij + MIN_FLOAT     (accidental hit: ids_i == ids_j, i != j)
// and y_ij = (i == j).
//   fwd: lse_i = log sum_j exp(s_ij) (online, per query row), pos_i = s_ii.
//        The loss sum_i w_i (lse_i - pos_i) is summed outside the kernel.
//   dq:  dq_i = inv_temp * sum_j (exp(s_ij - lse_i) - y_ij) c_j
//   dc:  dc_j = inv_temp * sum_i (exp(s_ij - lse_i) - y_ij) w_i q_i
// With bf16 scores the probability coefficients are rounded to bf16 before
// each product (the operand they multiply is bf16 already), and sums are
// f32. The upstream gradient and the weights of dq multiply outside.
//
// What bounds it on the H100. At the training step's shape (B = C = 4096,
// D = 64) the forward takes one product of 2*B*C*D = 2.1 GFLOP and dq and
// dc two each (the recomputed scores and the coefficient product), against
// a few MB of inputs and outputs, and each kernel takes B*C = 16.8 M exps.
// On the bf16 tensor cores the products need 2.2 / 4.3 us; the exps, at
// the SFU's 16 a clock an SM, 4.0 us at 1.98 GHz; the bytes 0.3-0.6 us.
// What bounds the kernels in practice is the per-score epilogue (an IEEE
// division, the log-q and id tests, the online max, an exp) and the
// latency of its loads: on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py k2-parts) fwd / dq / dc take 0.061 / 0.081 / 0.084
// ms, 15-20x that bound, against 0.63 / 1.25 / 1.50 ms for the CUDA-core
// design this replaces.
//
// What the design does about it (bf16 scores, the training step's path).
// FlashAttention-2's pattern on mma.sync.m16n8k16 (tensor_core.cuh): a
// block of 4 warps owns a 64-row tile of its output, 16 rows a warp, and
// loops over the other operand's 64-row tiles, staged with cp.async into a
// double buffer while the previous tile is in use; D is padded to a
// multiple of 16 with zeros in shared memory, so any D <= 256 runs. The
// score tile's f32 accumulator fragments are corrected in registers in
// _score_tile's order; the backward rounds the coefficients to bf16 and
// feeds them straight from registers as the A operand of its second
// product, the loop tile coming in through ldmatrix.trans. dc computes the
// transposed tile S^T = C Q^T for the 64 candidates it owns, so P^T is
// already in the accumulator layout. The epilogue's vectors (log-q, ids,
// lse, weights) are loaded for the whole tile before its products, so
// their latencies overlap the tensor cores' work. To fill the 132 SMs
// the loop dimension is split into `parts` (chosen by the wrapper, 2
// blocks an SM; 4 were slower): each part
// writes its partial (max, sum-exp, pos) or its partial
// dQ / dC rows to scratch, and a second small kernel folds the parts in a
// fixed order. No float atomics: two launches give bit-identical outputs.
//
// f32 scores keep exact f32 FMAs on the CUDA cores (TF32 would break their
// tolerance): a block of 256 threads owns a 64-row tile, each thread 4 x 4
// scores, operand tiles transposed in shared memory, no split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;          // rows of each operand tile
constexpr int kMaxDim = 256;    // widest D either path takes
constexpr float kMinFloat = -3.4028234663852886e+36f;  // f32 min / 100

struct Score {
  const float* logq;   // [C] or null
  const int* ids;      // [C] or null (no accidental-hit removal)
  float divisor;       // used when has_div
  int has_div;
};

// The vectors `correct` reads, loaded by the caller: a candidate's log-q
// and id, a query's id (0 where absent).
__device__ __forceinline__ float logq_of(const Score& sc, int col) {
  return sc.logq != nullptr ? __ldg(sc.logq + col) : 0.f;
}
__device__ __forceinline__ int id_of(const Score& sc, int i) {
  return sc.ids != nullptr ? __ldg(sc.ids + i) : 0;
}

// The corrected logit of query `row` (id `row_id`), candidate `col` (log-q
// `col_logq`, id `col_id`), in the order of _score_tile.
__device__ __forceinline__ float correct(float s, int row, int col,
                                         int row_id, float col_logq,
                                         int col_id, const Score& sc) {
  if (sc.has_div) s = __fdiv_rn(s, sc.divisor);
  if (sc.logq != nullptr) s = __fsub_rn(s, col_logq);
  if (sc.ids != nullptr && row != col && row_id == col_id) {
    s = __fadd_rn(s, kMinFloat);
  }
  return s;
}

// Folds (m, l) of another partial log-sum-exp into (m, l).
__device__ __forceinline__ void fold_lse(float& m, float& l, float mo,
                                         float lo) {
  const float mm = fmaxf(m, mo);
  l = l * expf(m - mm) + lo * expf(mo - mm);
  m = mm;
}

// --- f32 scores: CUDA-core FMAs --------------------------------------------

constexpr int kS = kT + 1;      // padded shared-memory stride
constexpr int kThreads = 256;   // 16 x 16; each owns 4 x 4 scores
constexpr int kMaxCols = kMaxDim / 16;  // accumulator columns a thread owns

// dst[k * kS + r] = src[(row0 + r) * d + k] for r < kT, zero past `rows`.
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
                                            int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < kT * d; idx += kThreads) {
    const int r = idx / d;
    const int k = idx - r * d;
    dst[k * kS + r] =
        row0 + r < rows ? src[static_cast<int64_t>(row0 + r) * d + k] : 0.f;
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

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ c, int b,
           int cn, int d, Score sc, float* __restrict__ lse,
           float* __restrict__ pos) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* cs = smem + d * kS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kT;
  load_tile_t(qs, q, q0, b, d);

  float m[4], l[4], p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
    p[i] = 0.f;
  }
  for (int c0 = 0; c0 < cn; c0 += kT) {
    __syncthreads();
    load_tile_t(cs, c, c0, cn, d);
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
        s[j] = col < cn ? correct(acc[i][j], row, col, id_of(sc, row),
                                  logq_of(sc, col), id_of(sc, col), sc)
                        : -FLT_MAX;
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
      p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
      fold_lse(m[i], l[i], mo, lo);
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
           int cn, int d, Score sc, const float* __restrict__ lse,
           const float* __restrict__ w, float inv_temp,
           float* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* cs = smem + d * kS;
  float* ps = smem + 2 * d * kS;  // [64 queries][kS]: coefficients
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int own0 = blockIdx.x * kT;
  if (MODE == 0) {
    load_tile_t(qs, q, own0, b, d);
  } else {
    load_tile_t(cs, c, own0, cn, d);
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
      load_tile_t(cs, c, c0, cn, d);
    } else {
      load_tile_t(qs, q, q0, b, d);
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
          const float s = correct(acc[i][j], row, col, id_of(sc, row),
                                  logq_of(sc, col), id_of(sc, col), sc);
          pij = __fsub_rn(expf(__fsub_rn(s, lse_row)), row == col ? 1.f : 0.f);
          if (MODE == 1) pij = __fmul_rn(pij, w_row);
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

// --- bf16 scores: tensor cores ---------------------------------------------

constexpr int kTcWarps = 4;                 // each owns 16 rows of the tile
constexpr int kTcThreads = 32 * kTcWarps;

// Shared bytes of the three staged tiles (owned + two loop buffers).
size_t tc_smem(int dp) { return sizeof(bf16) * 3 * kT * (dp + 8); }

// Tiles [begin, end) of `tiles` that part `part` of `parts` walks.
__device__ __forceinline__ void part_range(int tiles, int& begin, int& end) {
  begin = static_cast<int>(static_cast<int64_t>(tiles) * blockIdx.y /
                           gridDim.y);
  end = static_cast<int>(static_cast<int64_t>(tiles) * (blockIdx.y + 1) /
                         gridDim.y);
}

// Stages rows [row0, row0 + 64) and columns [0, dp) of src [rows, d] into
// the shared tile dst (stride dp + 8), zeros past `rows` and past `d`:
// cp.async when the rows are 16-byte aligned (d % 8 == 0), else plain
// loads.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int rows, int d,
                                           int dp) {
  const int stride = dp + 8;
  if ((d & 7) == 0) {
    const int chunks = dp >> 3;
    for (int idx = threadIdx.x; idx < kT * chunks; idx += kTcThreads) {
      const int r = idx / chunks;
      const int ch = idx - r * chunks;
      const bool ok = row0 + r < rows && ch * 8 < d;
      const bf16* s =
          ok ? src + static_cast<int64_t>(row0 + r) * d + ch * 8 : src;
      tc::cp_async16(dst + r * stride + ch * 8, s, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * dp; idx += kTcThreads) {
      const int r = idx / dp;
      const int k = idx - r * dp;
      bf16 x = __float2bfloat16_rn(0.f);
      if (row0 + r < rows && k < d) {
        x = src[static_cast<int64_t>(row0 + r) * d + k];
      }
      dst[r * stride + k] = x;
    }
  }
}

// acc[nb] = the warp's 16 rows of `own` . rows [8 nb, 8 nb + 8) of `loop`
// (both shared tiles of dp columns): a 16 x 64 score tile.
__device__ __forceinline__ void score_tile(float acc[8][4], const bf16* own,
                                           const bf16* loop, int dp,
                                           int lane) {
  const int stride = dp + 8;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
  }
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[4];
    tc::load_a(a, own, stride, k0, lane);
#pragma unroll
    for (int nb2 = 0; nb2 < 4; ++nb2) {
      uint32_t bb[4];
      tc::load_b(bb, loop + nb2 * 16 * stride, stride, k0, lane);
      tc::mma_bf16(acc[2 * nb2], a, bb[0], bb[1]);
      tc::mma_bf16(acc[2 * nb2 + 1], a, bb[2], bb[3]);
    }
  }
}

// Log-q and ids of the 16 candidate columns c0 + 8 nb + 2t + e a lane
// holds in a score tile (clamped into [0, cn); the caller masks), loaded
// together so that their latencies overlap.
__device__ __forceinline__ void load_cols(const Score& sc, int c0, int cn,
                                          int t, float logq[8][2],
                                          int ids[8][2]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = min(c0 + nb * 8 + 2 * t + e, cn - 1);
      logq[nb][e] = logq_of(sc, col);
      ids[nb][e] = id_of(sc, col);
    }
  }
}

// Forward, one part: the block owns 64 queries and walks its part of the
// candidate tiles; writes (max, sum-exp, pos) of each row to
// part_m / part_l / part_p [parts, b].
__global__ void __launch_bounds__(kTcThreads)
fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ c, int b,
              int cn, int d, int dp, Score sc, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int tile_elems = kT * (dp + 8);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* cs = qs + tile_elems;  // two loop buffers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kT;
  int t_begin, t_end;
  part_range((cn + kT - 1) / kT, t_begin, t_end);

  stage_rows(qs, q, q0, b, d, dp);
  stage_rows(cs, c, t_begin * kT, cn, d, dp);
  tc::cp_async_commit();
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const int row_ids[2] = {id_of(sc, min(rows[0], b - 1)),
                          id_of(sc, min(rows[1], b - 1))};
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, p[2] = {0.f, 0.f};
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage_rows(cs + (buf ^ 1) * tile_elems, c, (tile + 1) * kT, cn, d,
                 dp);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int c0 = tile * kT;
    float col_logq[8][2];
    int col_ids[8][2];
    load_cols(sc, c0, cn, t, col_logq, col_ids);
    float acc[8][4];
    score_tile(acc, qs + 16 * warp * (dp + 8), cs + buf * tile_elems, dp,
               lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows[h];
      float tmax = -FLT_MAX;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + nb * 8 + 2 * t + e;
          const bool ok = row < b && col < cn;
          const float s = correct(acc[nb][2 * h + e], row, col, row_ids[h],
                                  col_logq[nb][e], col_ids[nb][e], sc);
          tmax = ok ? fmaxf(tmax, s) : tmax;
          p[h] += ok && col == row ? s : 0.f;
          acc[nb][2 * h + e] = ok ? s : -FLT_MAX;
        }
      }
      const float m_new = fmaxf(m[h], tmax);
      float sum = l[h] * expf(m[h] - m_new);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = expf(acc[nb][2 * h + e] - m_new);
          sum += c0 + nb * 8 + 2 * t + e < cn ? x : 0.f;
        }
      }
      l[h] = sum;
      m[h] = m_new;
    }
    __syncthreads();  // The next stage overwrites this buffer.
  }
  // Fold the 4 lanes that share each row.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], off);
      fold_lse(m[h], l[h], mo, lo);
    }
    if (t == 0 && rows[h] < b) {
      const int64_t o = static_cast<int64_t>(blockIdx.y) * b + rows[h];
      part_m[o] = m[h];
      part_l[o] = l[h];
      part_p[o] = p[h];
    }
  }
}

// Folds the forward's parts in order: lse = m + log l, pos = sum of p.
__global__ void fwd_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_p, int b,
                                   int parts, float* __restrict__ lse,
                                   float* __restrict__ pos) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  float m = part_m[row], l = part_l[row], p = part_p[row];
  for (int i = 1; i < parts; ++i) {
    const int64_t o = static_cast<int64_t>(i) * b + row;
    fold_lse(m, l, part_m[o], part_l[o]);
    p += part_p[o];
  }
  lse[row] = m + logf(l);
  pos[row] = p;
}

// Backward, one part. dq (MODE 0): the block owns 64 queries and walks its
// part of the candidate tiles, dq += P C. dc (MODE 1): the block owns 64
// candidates and walks its part of the query tiles, dc += P^T Q with
// P^T = exp(C Q^T - lse) - y, times w. Writes the unscaled partial rows
// to partial [parts, own_rows, d]. NB: n-blocks of 8 columns the
// accumulator holds (dp <= 8 NB).
template <int MODE, int NB>
__global__ void __launch_bounds__(kTcThreads)
bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ c, int b,
              int cn, int d, int dp, Score sc, const float* __restrict__ lse,
              const float* __restrict__ w, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int stride = dp + 8;
  const int tile_elems = kT * stride;
  bf16* own_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* loop_s = own_s + tile_elems;  // two loop buffers
  const bf16* own = MODE == 0 ? q : c;
  const bf16* loop = MODE == 0 ? c : q;
  const int own_rows = MODE == 0 ? b : cn;
  const int loop_rows = MODE == 0 ? cn : b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int own0 = blockIdx.x * kT;
  int t_begin, t_end;
  part_range((loop_rows + kT - 1) / kT, t_begin, t_end);

  stage_rows(own_s, own, own0, own_rows, d, dp);
  stage_rows(loop_s, loop, t_begin * kT, loop_rows, d, dp);
  tc::cp_async_commit();
  const int own_r[2] = {own0 + 16 * warp + g, own0 + 16 * warp + g + 8};
  // The owned rows' vectors: a query's lse and id (dq), or a candidate's
  // log-q and id (dc), clamped into range (the caller masks).
  float own_lse[2], own_logq[2];
  int own_ids[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(own_r[h], own_rows - 1);
    own_lse[h] = MODE == 0 ? __ldg(lse + r) : 0.f;
    own_logq[h] = MODE == 1 ? logq_of(sc, r) : 0.f;
    own_ids[h] = id_of(sc, r);
  }
  float out[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[nb][i] = 0.f;
  }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage_rows(loop_s + (buf ^ 1) * tile_elems, loop, (tile + 1) * kT,
                 loop_rows, d, dp);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    float acc[8][4];
    // The loop rows' vectors: a candidate's log-q and id (dq), or a
    // query's lse, weight and id (dc).
    const int l0 = tile * kT;
    float loop_f[8][2], loop_w[8][2];
    int loop_ids[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = min(l0 + nb * 8 + 2 * t + e, loop_rows - 1);
        loop_f[nb][e] = MODE == 0 ? logq_of(sc, r) : __ldg(lse + r);
        loop_w[nb][e] = MODE == 1 && w != nullptr ? __ldg(w + r) : 1.f;
        loop_ids[nb][e] = id_of(sc, r);
      }
    }
    const bf16* lt = loop_s + buf * tile_elems;
    score_tile(acc, own_s + 16 * warp * stride, lt, dp, lane);
    // The coefficients, rounded to bf16 and packed as A fragments:
    // pa[nb][h] holds row (g + 8h), columns 8nb + 2t and 8nb + 2t + 1.
    uint32_t pa[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int loop_r = l0 + nb * 8 + 2 * t + e;
          const int row = MODE == 0 ? own_r[h] : loop_r;   // query
          const int col = MODE == 0 ? loop_r : own_r[h];   // candidate
          const float s = correct(
              acc[nb][2 * h + e], row, col,
              MODE == 0 ? own_ids[h] : loop_ids[nb][e],
              MODE == 0 ? loop_f[nb][e] : own_logq[h],
              MODE == 0 ? loop_ids[nb][e] : own_ids[h], sc);
          const float lse_row = MODE == 0 ? own_lse[h] : loop_f[nb][e];
          float pij = __fsub_rn(expf(__fsub_rn(s, lse_row)),
                                row == col ? 1.f : 0.f);
          if (MODE == 1) pij = __fmul_rn(pij, loop_w[nb][e]);
          pe[e] = row < b && col < cn ? pij : 0.f;
        }
        pa[nb][h] = tc::pack_bf16(pe[0], pe[1]);
      }
    }
    // out += P (16 x 64) . loop tile (64 x dp), the tile as [k][n].
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        if (n2 * 16 < dp) {
          uint32_t bb[4];
          tc::load_b_trans(bb, lt + kk * 16 * stride, stride, n2 * 16, lane);
          tc::mma_bf16(out[2 * n2], a, bb[0], bb[1]);
          tc::mma_bf16(out[2 * n2 + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // The next stage overwrites this buffer.
  }
  float* dst = partial + static_cast<int64_t>(blockIdx.y) * own_rows * d;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * 8 + 2 * t + e;
        if (own_r[h] < own_rows && col < d) {
          dst[static_cast<int64_t>(own_r[h]) * d + col] = out[nb][2 * h + e];
        }
      }
    }
  }
}

// out = inv_temp * (sum over parts of partial), the parts in order.
__global__ void bwd_combine_kernel(const float* __restrict__ partial,
                                   int64_t n, int parts, float inv_temp,
                                   float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int p = 1; p < parts; ++p) s = __fadd_rn(s, partial[p * n + i]);
  out[i] = __fmul_rn(s, inv_temp);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int MODE, int NB>
cudaError_t launch_bwd_tc(int blocks, int parts, int dp, cudaStream_t s,
                          const bf16* q, const bf16* c, int b, int cn, int d,
                          Score sc, const float* lse, const float* w,
                          float* partial) {
  const size_t smem = tc_smem(dp);
  cudaError_t err = set_smem(bwd_tc_kernel<MODE, NB>, smem);
  if (err != cudaSuccess) return err;
  bwd_tc_kernel<MODE, NB><<<dim3(blocks, parts), kTcThreads, smem, s>>>(
      q, c, b, cn, d, dp, sc, lse, w, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared by the two entry points: logq and ids may be null; has_div says
// whether to divide the raw scores by `divisor`. bf16_scores = 0: q and c
// are f32 and `parts` / `scratch` are unused. bf16_scores = 1: q and c are
// bf16, the loop dimension is split into `parts` (1 .. its 64-row tiles),
// and `scratch` holds the parts' partial results (fwd: 3 * parts * b floats;
// dq / dc: parts * rows * d floats). Each returns the cudaError_t of its
// launches (0 on success).

int fused_retrieval_fwd(const void* q, const void* c, int b, int cn, int d,
                        const float* logq, const int* ids, int has_div,
                        float divisor, int bf16_scores, int parts,
                        float* scratch, float* lse, float* pos,
                        void* stream) {
  if (d <= 0 || d > kMaxDim || b <= 0 || cn < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Score sc{logq, ids, divisor, has_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16_scores) {
    const size_t smem = sizeof(float) * 2 * d * kS;
    err = set_smem(fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    fwd_kernel<<<(b + kT - 1) / kT, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), b, cn, d,
        sc, lse, pos);
    return cudaGetLastError();
  }
  if (parts < 1 || parts > (cn + kT - 1) / kT || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (d + 15) / 16 * 16;
  const size_t smem = tc_smem(dp);
  err = set_smem(fwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  float* part_m = scratch;
  float* part_l = scratch + static_cast<int64_t>(parts) * b;
  float* part_p = scratch + 2 * static_cast<int64_t>(parts) * b;
  fwd_tc_kernel<<<dim3((b + kT - 1) / kT, parts), kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(c), b, cn, d, dp,
      sc, part_m, part_l, part_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fwd_combine_kernel<<<(b + 255) / 256, 256, 0, s>>>(part_m, part_l, part_p,
                                                      b, parts, lse, pos);
  return cudaGetLastError();
}

// mode 0: out = dq [b, d]; mode 1: out = dc [cn, d] (w may be null).
int fused_retrieval_bwd(int mode, const void* q, const void* c, int b,
                        int cn, int d, const float* logq, const int* ids,
                        int has_div, float divisor, int bf16_scores,
                        const float* lse, const float* w, float inv_temp,
                        int parts, float* scratch, float* out, void* stream) {
  if (d <= 0 || d > kMaxDim || b <= 0 || cn < b || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Score sc{logq, ids, divisor, has_div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16_scores) {
    const float* qf = static_cast<const float*>(q);
    const float* cf = static_cast<const float*>(c);
    const size_t smem = sizeof(float) * (2 * d * kS + kT * kS);
    if (mode == 0) {
      err = set_smem(bwd_kernel<0>, smem);
      if (err != cudaSuccess) return err;
      bwd_kernel<0><<<(b + kT - 1) / kT, kThreads, smem, s>>>(
          qf, cf, b, cn, d, sc, lse, w, inv_temp, out);
    } else {
      err = set_smem(bwd_kernel<1>, smem);
      if (err != cudaSuccess) return err;
      bwd_kernel<1><<<(cn + kT - 1) / kT, kThreads, smem, s>>>(
          qf, cf, b, cn, d, sc, lse, w, inv_temp, out);
    }
    return cudaGetLastError();
  }
  const int own_rows = mode == 0 ? b : cn;
  const int loop_rows = mode == 0 ? cn : b;
  if (parts < 1 || parts > (loop_rows + kT - 1) / kT || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (d + 15) / 16 * 16;
  const int blocks = (own_rows + kT - 1) / kT;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* cb = static_cast<const bf16*>(c);
  if (mode == 0) {
    err = dp <= 64 ? launch_bwd_tc<0, 8>(blocks, parts, dp, s, qb, cb, b, cn,
                                         d, sc, lse, w, scratch)
        : dp <= 128 ? launch_bwd_tc<0, 16>(blocks, parts, dp, s, qb, cb, b,
                                           cn, d, sc, lse, w, scratch)
                    : launch_bwd_tc<0, 32>(blocks, parts, dp, s, qb, cb, b,
                                           cn, d, sc, lse, w, scratch);
  } else {
    err = dp <= 64 ? launch_bwd_tc<1, 8>(blocks, parts, dp, s, qb, cb, b, cn,
                                         d, sc, lse, w, scratch)
        : dp <= 128 ? launch_bwd_tc<1, 16>(blocks, parts, dp, s, qb, cb, b,
                                           cn, d, sc, lse, w, scratch)
                    : launch_bwd_tc<1, 32>(blocks, parts, dp, s, qb, cb, b,
                                           cn, d, sc, lse, w, scratch);
  }
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(own_rows) * d;
  bwd_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      scratch, n, parts, inv_temp, out);
  return cudaGetLastError();
}

const char* fused_retrieval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
