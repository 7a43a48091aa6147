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
// f32 scores (the multitask path's) take the same design in split
// precision, as K3's f32 body does (bucketed_scores.cu): every f32
// operand becomes three bf16 terms x = h + m + l (tc::split3, exact for
// 2^-110 <= |x| < (2 - 2^-8) 2^127), and each product is the sum of six
// of the nine term products (hh, hm, mh, hl, lh, mm), each exact in f32,
// on the same mma.sync; single-pass TF32 (10-bit mantissas) would break
// the f32 tolerance. That covers both products of a kernel:
//   - the scores q.c (fwd, and recomputed in dq and dc): the owned tile is
//     split once a block into three planes in shared memory; each loop
//     tile arrives as raw f32 through a cp.async ring of two and is split
//     once into three planes, which ldmatrix serves to the score product
//     and ldmatrix.trans to the coefficient product. hh sums in one f32
//     accumulator, the other five (2^-7 as large) in a second, added once;
//   - the coefficient product (P C in dq, (P w)^T Q in dc): the f32
//     coefficients split into three bf16 A fragments straight from the
//     score tile's registers (FlashAttention-2's reuse, as in the bf16
//     body); each 16-deep step's six products sum in a fresh accumulator
//     that is added to the output once, so the output takes one f32
//     rounding a step, as the bf16 body's does.
// The dropped ml, lm and ll are at most 1.006 * 2^-23 of sum |a_k||b_k| a
// product (plus 2^-134 a term below 2^-110), on the scores and on the
// coefficient product alike; ops/fused_retrieval.py::split_model carries
// that through the softmax to a bound on the loss, dq and dc, and
// tests/test_torch_k2_split.py holds it, with the plain twin's own f32
// error, inside the tolerance the card tests hold the kernels to (the
// loss to rtol 1e-5; dq and dc to 1e-5 relative plus 1e-4 of their
// largest magnitude). The loop tile has 32 rows: at D = 64 the owned
// planes (27.6 KB), the loop planes (13.8 KB) and the ring (16.4 KB) take
// 58 KB, and three blocks share an SM (with 64-row loop tiles, 88 KB and
// more registers, two did, 12-16 % slower; tools/kernel_ab.py k2-parts
// --f32); D = 256 fits one block (213 KB). The loop dimension is split
// into as many parts as one wave of resident blocks holds
// (fused_retrieval_f32_blocks_per_sm asks the runtime): a second, partial
// wave of these longer blocks costs a whole block's time. The parts fold
// in the same fixed-order kernels as the bf16 path's. At B = C = 4096,
// D = 64 the six passes need 0.0130 ms (fwd) and 0.0261 ms (dq, dc) at
// the bf16 peak; the CUDA-core FMA kernels they replace took 0.48 / 1.05
// / 1.02 ms against an f32 CUDA-core bound of 0.032 / 0.064 / 0.064 ms
// (PERF.md).

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

// --- f32 scores: split precision on the tensor cores -----------------------

// Rows of the loop operand's tile. 32, not 64: at D = 64 a block then
// takes 58 KB of shared memory and 128-166 registers a thread, so three
// blocks share an SM (two with 64-row tiles), and dq / dc of a 256-wide
// row still fit (213 KB, one block).
constexpr int kLoop = 32;
constexpr int kLoopBlocks = kLoop / 8;  // n-blocks of 8 in a score tile

// Shared bytes: the owned tile's three bf16 planes ([64][dp + 8] each),
// the loop tile's three planes ([kLoop][dp + 8] each) and a ring of two
// raw f32 loop tiles ([kLoop][dp] each).
size_t split_smem(int dp) {
  return sizeof(bf16) * 3 * (kT + kLoop) * (dp + 8) +
         sizeof(float) * 2 * kLoop * dp;
}

// Four f32 values (x0 first) as three bf16 terms each (tc::split3), stored
// at dst in the h plane and `plane` and 2 * `plane` elements after it.
__device__ __forceinline__ void store_split4(bf16* dst, int plane, float x0,
                                             float x1, float x2, float x3) {
  uint32_t h[2], m[2], l[2];
  tc::split3(x0, x1, h[0], m[0], l[0]);
  tc::split3(x2, x3, h[1], m[1], l[1]);
  *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
  *reinterpret_cast<uint2*>(dst + plane) = make_uint2(m[0], m[1]);
  *reinterpret_cast<uint2*>(dst + 2 * plane) = make_uint2(l[0], l[1]);
}

// The owned tile: rows [row0, row0 + 64) and columns [0, dp) of src
// [rows, d], read once from global memory and split into the planes at
// dst (each [64][dp + 8], `plane` elements apart), zeros past `rows` and
// past `d`. Runs while the first loop tile's copy is in flight.
__device__ __forceinline__ void split_owned(bf16* dst, int plane,
                                            const float* src, int row0,
                                            int rows, int d, int dp) {
  const int chunks = dp >> 2;
  for (int idx = threadIdx.x; idx < kT * chunks; idx += kTcThreads) {
    const int r = idx / chunks;
    const int k = (idx - r * chunks) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = row0 + r < rows && k + e < d
                 ? __ldg(src + static_cast<int64_t>(row0 + r) * d + k + e)
                 : 0.f;
    }
    store_split4(dst + r * (dp + 8) + k, plane, v[0], v[1], v[2], v[3]);
  }
}

// Copies rows [row0, row0 + kLoop) and columns [0, dp) of src [rows, d]
// (f32) into the raw tile dst ([kLoop][dp]) with cp.async, zeros past
// `rows` and past `d`: 16 bytes a copy where rows are 16-byte aligned,
// else 4.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int rows, int d,
                                          int dp) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = dp >> 2;
    for (int idx = threadIdx.x; idx < kLoop * chunks; idx += kTcThreads) {
      const int r = idx / chunks;
      const int ch = idx - r * chunks;
      const bool ok = row0 + r < rows && ch * 4 < d;
      const float* s =
          ok ? src + static_cast<int64_t>(row0 + r) * d + ch * 4 : src;
      tc::cp_async16(dst + r * dp + ch * 4, s, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kLoop * dp; idx += kTcThreads) {
      const int r = idx / dp;
      const int k = idx - r * dp;
      const bool ok = row0 + r < rows && k < d;
      const float* s = ok ? src + static_cast<int64_t>(row0 + r) * d + k : src;
      tc::cp_async4(dst + r * dp + k, s, ok ? 4 : 0);
    }
  }
}

// Splits the raw loop tile ([kLoop][dp] f32) into its three planes at
// dst (each [kLoop][dp + 8], `plane` elements apart).
__device__ __forceinline__ void split_staged(bf16* dst, int plane,
                                             const float* raw, int dp) {
  const int chunks = dp >> 2;
  for (int idx = threadIdx.x; idx < kLoop * chunks; idx += kTcThreads) {
    const int r = idx / chunks;
    const int k = (idx - r * chunks) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * dp + k);
    store_split4(dst + r * (dp + 8) + k, plane, v.x, v.y, v.z, v.w);
  }
}

// acc[nb] = the warp's 16 rows of `own` . rows [8 nb, 8 nb + 8) of `loop`,
// both as three planes (`own_plane` and `loop_plane` elements apart): a
// 16 x kLoop score tile in split precision. Six of the nine term products
// (hh, hm, mh, hl, lh, mm), each exact in f32: hh sums in `acc`, the
// other five, together 2^-7 as large, in `small`, added once at the end.
__device__ __forceinline__ void split_score_tile(float acc[kLoopBlocks][4],
                                                 const bf16* own,
                                                 int own_plane,
                                                 const bf16* loop,
                                                 int loop_plane, int dp,
                                                 int lane) {
  const int stride = dp + 8;
  float small[kLoopBlocks][4];
#pragma unroll
  for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = small[nb][i] = 0.f;
  }
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[3][4];  // [plane h, m, l]
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      tc::load_a(a[p], own + p * own_plane, stride, k0, lane);
    }
#pragma unroll
    for (int nb2 = 0; nb2 < kLoopBlocks / 2; ++nb2) {
      uint32_t bb[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        tc::load_b(bb[p], loop + p * loop_plane + nb2 * 16 * stride, stride,
                   k0, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* sm = small[2 * nb2 + j];
        const uint32_t* bh = bb[0] + 2 * j;
        const uint32_t* bm = bb[1] + 2 * j;
        const uint32_t* bl = bb[2] + 2 * j;
        tc::mma_bf16(acc[2 * nb2 + j], a[0], bh[0], bh[1]);  // hh
        tc::mma_bf16(sm, a[1], bm[0], bm[1]);                // mm
        tc::mma_bf16(sm, a[2], bh[0], bh[1]);                // lh
        tc::mma_bf16(sm, a[0], bl[0], bl[1]);                // hl
        tc::mma_bf16(sm, a[1], bh[0], bh[1]);                // mh
        tc::mma_bf16(sm, a[0], bm[0], bm[1]);                // hm
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nb][i] = __fadd_rn(acc[nb][i], small[nb][i]);
    }
  }
}

// Forward, one part, f32 scores: the block owns 64 queries and walks its
// part of the candidate tiles (kLoop rows each); writes (max, sum-exp,
// pos) of each row to part_m / part_l / part_p [parts, b], as
// fwd_tc_kernel does.
__global__ void __launch_bounds__(kTcThreads)
fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 int b, int cn, int d, int dp, Score sc,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int stride = dp + 8;
  const int own_plane = kT * stride, loop_plane = kLoop * stride;
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // 3 planes [64][stride]
  bf16* cs = qs + 3 * own_plane;                // 3 planes [kLoop][stride]
  // The ring: 2 x [kLoop][dp] f32.
  float* raw = reinterpret_cast<float*>(cs + 3 * loop_plane);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kT;
  int t_begin, t_end;
  part_range((cn + kLoop - 1) / kLoop, t_begin, t_end);

  if (t_begin < t_end) stage_f32(raw, c, t_begin * kLoop, cn, d, dp);
  tc::cp_async_commit();
  split_owned(qs, own_plane, q, q0, b, d, dp);
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const int row_ids[2] = {id_of(sc, min(rows[0], b - 1)),
                          id_of(sc, min(rows[1], b - 1))};
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, p[2] = {0.f, 0.f};
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage_f32(raw + (buf ^ 1) * kLoop * dp, c, (tile + 1) * kLoop, cn, d,
                dp);
    }
    tc::cp_async_commit();
    const int c0 = tile * kLoop;
    float col_logq[kLoopBlocks][2];
    int col_ids[kLoopBlocks][2];
#pragma unroll
    for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = min(c0 + nb * 8 + 2 * t + e, cn - 1);
        col_logq[nb][e] = logq_of(sc, col);
        col_ids[nb][e] = id_of(sc, col);
      }
    }
    tc::cp_async_wait<1>();
    // This tile's raw rows have landed; every warp is done with the last
    // tile's planes.
    __syncthreads();
    split_staged(cs, loop_plane, raw + buf * kLoop * dp, dp);
    __syncthreads();
    float acc[kLoopBlocks][4];
    split_score_tile(acc, qs + 16 * warp * stride, own_plane, cs,
                     loop_plane, dp, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows[h];
      float tmax = -FLT_MAX;
#pragma unroll
      for (int nb = 0; nb < kLoopBlocks; ++nb) {
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
      for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = expf(acc[nb][2 * h + e] - m_new);
          sum += c0 + nb * 8 + 2 * t + e < cn ? x : 0.f;
        }
      }
      l[h] = sum;
      m[h] = m_new;
    }
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

// Backward, one part, f32 scores. dq (MODE 0): the block owns 64 queries
// and walks its part of the candidate tiles, dq += P C. dc (MODE 1): the
// block owns 64 candidates and walks its part of the query tiles, dc +=
// P^T Q with P^T = exp(C Q^T - lse) - y, times w. Both products in split
// precision; the f32 coefficients split into three bf16 A fragments in
// registers. Writes the unscaled partial rows to partial [parts,
// own_rows, d]. NB: n-blocks of 8 columns the accumulator holds (dp <=
// 8 NB).
template <int MODE, int NB>
__global__ void __launch_bounds__(kTcThreads)
bwd_split_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 int b, int cn, int d, int dp, Score sc,
                 const float* __restrict__ lse, const float* __restrict__ w,
                 float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int stride = dp + 8;
  const int own_plane = kT * stride, loop_plane = kLoop * stride;
  bf16* own_s = reinterpret_cast<bf16*>(smem_tc);  // 3 planes [64][stride]
  bf16* loop_s = own_s + 3 * own_plane;  // 3 planes [kLoop][stride]
  float* raw = reinterpret_cast<float*>(loop_s + 3 * loop_plane);
  const float* own = MODE == 0 ? q : c;
  const float* loop = MODE == 0 ? c : q;
  const int own_rows = MODE == 0 ? b : cn;
  const int loop_rows = MODE == 0 ? cn : b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int own0 = blockIdx.x * kT;
  int t_begin, t_end;
  part_range((loop_rows + kLoop - 1) / kLoop, t_begin, t_end);

  if (t_begin < t_end) {
    stage_f32(raw, loop, t_begin * kLoop, loop_rows, d, dp);
  }
  tc::cp_async_commit();
  split_owned(own_s, own_plane, own, own0, own_rows, d, dp);
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
      stage_f32(raw + (buf ^ 1) * kLoop * dp, loop, (tile + 1) * kLoop,
                loop_rows, d, dp);
    }
    tc::cp_async_commit();
    // The loop rows' vectors: a candidate's log-q and id (dq), or a
    // query's lse, weight and id (dc).
    const int l0 = tile * kLoop;
    float loop_f[kLoopBlocks][2], loop_w[kLoopBlocks][2];
    int loop_ids[kLoopBlocks][2];
#pragma unroll
    for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = min(l0 + nb * 8 + 2 * t + e, loop_rows - 1);
        loop_f[nb][e] = MODE == 0 ? logq_of(sc, r) : __ldg(lse + r);
        loop_w[nb][e] = MODE == 1 && w != nullptr ? __ldg(w + r) : 1.f;
        loop_ids[nb][e] = id_of(sc, r);
      }
    }
    tc::cp_async_wait<1>();
    __syncthreads();  // As in fwd_split_kernel.
    split_staged(loop_s, loop_plane, raw + buf * kLoop * dp, dp);
    __syncthreads();
    float acc[kLoopBlocks][4];
    split_score_tile(acc, own_s + 16 * warp * stride, own_plane, loop_s,
                     loop_plane, dp, lane);
    // The f32 coefficients, in place: acc[nb][2h + e] is row g + 8h,
    // loop row 8nb + 2t + e.
#pragma unroll
    for (int nb = 0; nb < kLoopBlocks; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
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
          acc[nb][2 * h + e] = row < b && col < cn ? pij : 0.f;
        }
      }
    }
    // out += P (16 x kLoop) . loop tile (kLoop x dp), the tile's planes as
    // [k][n]. Each 16-deep step's six term products sum in `step`, which
    // is added to `out` once: one f32 rounding a step, as in the bf16 body.
#pragma unroll
    for (int kk = 0; kk < kLoop / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
      tc::split3(acc[2 * kk][0], acc[2 * kk][1], ph[0], pm[0], pl[0]);
      tc::split3(acc[2 * kk][2], acc[2 * kk][3], ph[1], pm[1], pl[1]);
      tc::split3(acc[2 * kk + 1][0], acc[2 * kk + 1][1], ph[2], pm[2],
                 pl[2]);
      tc::split3(acc[2 * kk + 1][2], acc[2 * kk + 1][3], ph[3], pm[3],
                 pl[3]);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        if (n2 * 16 < dp) {
          uint32_t bb[3][4];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            tc::load_b_trans(bb[p],
                             loop_s + p * loop_plane + kk * 16 * stride,
                             stride, n2 * 16, lane);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t* bh = bb[0] + 2 * j;
            const uint32_t* bm = bb[1] + 2 * j;
            const uint32_t* bl = bb[2] + 2 * j;
            float step[4] = {0.f, 0.f, 0.f, 0.f};
            tc::mma_bf16(step, pm, bm[0], bm[1]);  // mm
            tc::mma_bf16(step, pl, bh[0], bh[1]);  // lh
            tc::mma_bf16(step, ph, bl[0], bl[1]);  // hl
            tc::mma_bf16(step, pm, bh[0], bh[1]);  // mh
            tc::mma_bf16(step, ph, bm[0], bm[1]);  // hm
            tc::mma_bf16(step, ph, bh[0], bh[1]);  // hh
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              out[2 * n2 + j][i] = __fadd_rn(out[2 * n2 + j][i], step[i]);
            }
          }
        }
      }
    }
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

using BwdSplitFn = void (*)(const float*, const float*, int, int, int, int,
                           Score, const float*, const float*, float*);

// dq (MODE 0) or dc (MODE 1) with f32 scores for padded width dp: 8, 16
// or 32 n-blocks of accumulators.
template <int MODE>
BwdSplitFn bwd_split_fn(int dp) {
  if (dp <= 64) return &bwd_split_kernel<MODE, 8>;
  if (dp <= 128) return &bwd_split_kernel<MODE, 16>;
  return &bwd_split_kernel<MODE, 32>;
}

// Blocks of `kernel` an SM holds with `smem` bytes of shared memory, or a
// negative cudaError_t.
template <typename K>
int blocks_per_sm(K kernel, size_t smem) {
  cudaError_t err = set_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kTcThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Shared by the two entry points: logq and ids may be null; has_div says
// whether to divide the raw scores by `divisor`. q and c are f32
// (bf16_scores = 0, split precision) or bf16 (bf16_scores = 1). The loop
// dimension is split into `parts` (1 .. its 64-row tiles), and `scratch`
// holds the parts' partial results (fwd: 3 * parts * b floats; dq / dc:
// parts * rows * d floats). Each returns the cudaError_t of its launches
// (0 on success).

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
  if (parts < 1 || parts > (cn + kT - 1) / kT || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (d + 15) / 16 * 16;
  const int blocks = (b + kT - 1) / kT;
  float* part_m = scratch;
  float* part_l = scratch + static_cast<int64_t>(parts) * b;
  float* part_p = scratch + 2 * static_cast<int64_t>(parts) * b;
  if (!bf16_scores) {
    const size_t smem = split_smem(dp);
    err = set_smem(fwd_split_kernel, smem);
    if (err != cudaSuccess) return err;
    fwd_split_kernel<<<dim3(blocks, parts), kTcThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), b, cn, d,
        dp, sc, part_m, part_l, part_p);
    err = cudaGetLastError();
  } else {
    const size_t smem = tc_smem(dp);
    err = set_smem(fwd_tc_kernel, smem);
    if (err != cudaSuccess) return err;
    fwd_tc_kernel<<<dim3(blocks, parts), kTcThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(c), b, cn, d,
        dp, sc, part_m, part_l, part_p);
    err = cudaGetLastError();
  }
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
  const int own_rows = mode == 0 ? b : cn;
  const int loop_rows = mode == 0 ? cn : b;
  if (parts < 1 || parts > (loop_rows + kT - 1) / kT || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (d + 15) / 16 * 16;
  const int blocks = (own_rows + kT - 1) / kT;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* cb = static_cast<const bf16*>(c);
  if (!bf16_scores) {
    const BwdSplitFn fn = mode == 0 ? bwd_split_fn<0>(dp) : bwd_split_fn<1>(dp);
    const size_t smem = split_smem(dp);
    err = set_smem(fn, smem);
    if (err != cudaSuccess) return err;
    fn<<<dim3(blocks, parts), kTcThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(c), b, cn, d,
        dp, sc, lse, w, scratch);
    err = cudaGetLastError();
  } else if (mode == 0) {
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

// Blocks an SM holds of the f32-score kernel that `kernel` (0 fwd, 1 dq,
// 2 dc) launches at width d, or a negative cudaError_t: the wrapper sizes
// its parts to one wave of them.
int fused_retrieval_f32_blocks_per_sm(int kernel, int d) {
  if (d <= 0 || d > kMaxDim || kernel < 0 || kernel > 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (d + 15) / 16 * 16;
  const size_t smem = split_smem(dp);
  if (kernel == 0) return blocks_per_sm(fwd_split_kernel, smem);
  return blocks_per_sm(kernel == 1 ? bwd_split_fn<0>(dp) : bwd_split_fn<1>(dp),
                       smem);
}

const char* fused_retrieval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
