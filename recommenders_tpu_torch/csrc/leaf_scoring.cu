// Probed leaf scoring for the ScaNN index, written for Hopper (sm_90a).
//
// Replaces the TPU kernel K4:
// recommenders_tpu/ops/leaf_scoring.py::probed_leaf_scores (:108, pallas_call
// :175) and its bodies _kernel_f32 (:56), _kernel_quantized (:66) and
// _kernel_quantized4 (:102, decode :80).
// Replaces the TPU kernel K5:
// recommenders_tpu/ops/leaf_scoring.py::probed_bucketed_scores (:310,
// pallas_call :416) and its bodies _kernel_bucketed_f32 (:248),
// _kernel_bucketed_quantized (:268) and _kernel_bucketed_quantized4 (:288),
// with the fold _fold_buckets (:203).
//
// What they compute. Leaves are stored [L, cap, D]; the query scores slot s
// of leaf l as q . leaf[l, s] accumulated in f32, where
//   kF32 / kBF16  f32 or bf16 rows against the f32 query (bf16 promotes to
//                 f32, the query is not rounded);
//   kInt8         int8 codes [L, cap, D] and f32 scales [L, cap]: the query
//                 rounds to bf16, the codes are exact there, so every
//                 product is exact in f32; the scale multiplies after the
//                 dot;
//   kInt4         codes packed two per byte [L, cap/2, D]: packed row r
//                 holds slot r in its low nibble and slot r + cap/2 in its
//                 high nibble, decoded as (p << 28) >> 28 and p >> 4.
// K4 writes every probed slot's score: out[q, p*cap + s] for probe p of
// query q, probe-major. K5 shares one probe list between the `query_tile`
// queries of a tile and folds slot s of each probed leaf into bucket
// s % B, in order of probe, then group of B slots; a score replaces the
// bucket's running best only when strictly greater, so the first maximum
// wins, as jnp.argmax over the [P * groups] candidates does in the
// reference. A partial tail group (cap % B slots) folds into buckets
// 0 .. tail-1. A slot whose global row is -1 (padding) never wins, and an
// empty bucket reports `mask_value` (MIN_FLOAT) and row -1. A probe
// outside [0, L) is never read: K4 scores it `mask_value`, K5 skips it.
//
// What bounds it on the H100. K4 at the bf16 shape (Q=256 queries, P=128
// probes of cap=1280 rows, D=128, L=1024) probes almost every leaf about
// 32 times: read once a (query, probe) pair that is 10.7 GB, read once a
// leaf 335 MB, and the [Q, P*cap] f32 scores are 168 MB more, so staged
// once per leaf it is bound by memory (~0.15 ms). K5 shares each leaf
// among a tile of T queries: at T=64, P=256, cap=1280, D=128, Q=1024 it
// does 86 GFLOP on 0.2-0.4 GB of distinct leaves, hundreds of FLOP a
// byte, so it is bound by the products, 0.06 ms at the bf16 tensor-core
// peak (3x that for bf16 rows, below). On an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py) K4 takes 0.23-0.33 ms and K5 0.26-1.12 ms, 2-15x
// their bounds: each 64 x 64 x 128 stage costs a block barrier, the code
// decode and the fold, with 12 warps an SM (160-168 registers a thread).
//
// What the design does about it. The TPU ran its grid (query, probe) in
// order and carried K5's running argmax in VMEM from one probe to the
// next. Hopper runs blocks in no order.
//   Tensor cores. The bf16, int8 and int4 bodies multiply a 64-query x
//   64-slot tile with mma.sync.m16n8k16 (tensor_core.cuh): four warps of
//   32 x 32, the slot rows coming in stages of 128 feature columns (64
//   where a block would outgrow shared memory) through a three-stage
//   cp.async ring with one block barrier a stage, each stage carrying the
//   tile's slot rows and scales for the epilogue. Codes are decoded to
//   bf16 (exact) as they are multiplied: a lane reads 4 code bytes of its
//   slot row a k-step and the query columns are stored permuted to match
//   (`permuted`). Codes meet the query rounded to bf16. bf16 rows must
//   meet the unrounded f32 query, so the query is split into three bf16
//   terms, h = bf16(q), m = bf16(q - h), l = bf16(q - h - m), whose sum is
//   q exactly (in the normal range); the rows are exact in bf16, so the
//   three products are exact and only the f32 sums round, as in the f32
//   twin.
//   K4, leaf-major: the wrapper sorts the Q*P (query, probe) pairs by leaf
//   on the device and cuts each leaf's run into groups of at most 64
//   pairs (probes outside [0, L) form a run of their own), one block a
//   group on a grid of ceil(Q*P/64) + L blocks, so no host
//   synchronisation sizes it (ops/leaf_scoring.py `leaf_groups`,
//   `group_of` below); a block gathers its group's queries into shared
//   memory, walks the leaf's slots 64 at a time and stores each query
//   row's scores, scaled, as float2 runs. A leaf is read once a group
//   instead of once a pair; blocks past the live groups exit at once.
//   K5: a block owns 64 queries x 64 buckets of one query tile and walks a
//   contiguous range of that tile's probes (split z of S, its probe ids in
//   shared memory), with its running (max, row) in registers in the
//   accumulator layout; S is chosen by the wrapper to fill the card. A
//   second kernel merges the S partial planes in order of z with strict
//   `>`, so the first maximum in fold order still wins (not K3's merge,
//   which sends ties to the lowest row: here an earlier probe's higher row
//   must win).
//   The f32 bodies take the same grids with f32 FMAs on the CUDA cores (a
//   block owns 64 queries x 64 slots, each thread 4 x 4, the slot rows
//   staged 32 columns at a time), exact f32 as the twin computes it.
// Any D <= 512 and any cap are taken: ragged edges are masked, and rows
// that are not 16-byte aligned are staged by plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Format { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

constexpr int kMaxDim = 512;
constexpr int kTQ = 64;  // query rows of a block: a K4 group, a K5 query block
constexpr int kNS = 64;  // slots (K5: buckets) of a block's tile

// Tensor-core bodies: stages of KC = 128 feature columns (64 where 128
// would not fit in shared memory).
constexpr int kRing = 3;            // stages of the cp.async ring
constexpr int kTcThreads = 128;     // 4 warps, each 32 queries x 32 slots
constexpr size_t kWideSmem = 200 * 1024;  // most bytes a KC = 128 block takes
constexpr int kSplitProbes = 256;   // most probes a K5 split walks

// CUDA-core f32 bodies.
constexpr int kFKC = 32;            // feature columns a stage
constexpr int kCStride = kNS + 1;   // padded slab row (no bank conflicts)
constexpr int kF32Threads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ int low_nibble(int p) {
  return static_cast<int>(static_cast<unsigned>(p) << 28) >> 28;
}

// Stored row of slot s of `leaf` (for int4, the packed row holding it).
template <int FMT>
__device__ __forceinline__ int64_t stored_row(int64_t leaf, int s, int cap) {
  if constexpr (FMT == kInt4) {
    const int half = cap / 2;
    return leaf * half + (s < half ? s : s - half);
  } else {
    return leaf * cap + s;
  }
}

// K4's plan, decoded for block blockIdx.x: returns its leaf and sets its
// first position in `order` and its pairs. The plan: `order` lists the
// flat (query, probe) pairs sorted by leaf, leaf l's pairs at
// [bounds[l], bounds[l + 1]) (leaf L: probes outside [0, L)), cut in
// groups of at most kTQ; the leaf's groups are the blocks in
// [last[l] - groups, last[l]), and block_leaf[b] is b's leaf (L + 1 past
// the live groups, where it sets 0 pairs).
__device__ __forceinline__ int group_of(const int* __restrict__ bounds,
                                        const int* __restrict__ last,
                                        const int* __restrict__ block_leaf,
                                        int num_leaves, int* start,
                                        int* count) {
  const int leaf = block_leaf[blockIdx.x];
  *count = 0;
  if (leaf > num_leaves) return leaf;
  const int pairs = bounds[leaf + 1] - bounds[leaf];
  const int j = static_cast<int>(blockIdx.x) -
                (last[leaf] - (pairs + kTQ - 1) / kTQ);
  *start = bounds[leaf] + j * kTQ;
  *count = min(kTQ, pairs - j * kTQ);
  return leaf;
}

// Fills the score rows of `count` pairs from `order[start]` with `value`:
// the pairs of probes outside [0, L).
__device__ void fill_pairs(float* __restrict__ out,
                           const int* __restrict__ order, int start,
                           int count, int cap, float value) {
  for (int i = 0; i < count; ++i) {
    float* o = out + static_cast<int64_t>(order[start + i]) * cap;
    for (int s = threadIdx.x; s < cap; s += blockDim.x) o[s] = value;
  }
}

// ------------------------------------------------- f32 bodies (CUDA cores)

// Loads columns [col, col + 8) of f32 row `row` (columns >= d read as 0);
// `vec`: d % 8 == 0 and an aligned table, so two float4 loads serve.
__device__ __forceinline__ void load8(const float* __restrict__ leaves,
                                      int64_t row, int d, int col, bool vec,
                                      float out[8]) {
  const float* p = leaves + row * d + col;
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = col + j < d ? p[j] : 0.f;
  }
}

// acc[i][j] = q_(4ty+i) . row (row0 + tx + 16j) for the f32 rows
// [row0, row0 + nrows): the block's 64 queries sit transposed in `qs`
// ([dpad][kTQ]), the rows pass through `cs` 32 columns at a time.
__device__ __forceinline__ void f32_tile(const float* __restrict__ qs,
                                         float* __restrict__ cs,
                                         const float* __restrict__ leaves,
                                         int64_t row0, int nrows, int d,
                                         int dpad, bool vec,
                                         float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int load_slot = tid / 4;       // row of the tile this thread stages
  const int load_col = (tid % 4) * 8;  // and its 8 columns of each stage
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < dpad; k0 += kFKC) {
    float v[8];
    if (load_slot < nrows && k0 + load_col < d) {
      load8(leaves, row0 + load_slot, d, k0 + load_col, vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    __syncthreads();  // The previous stage is consumed; qs is written.
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(load_col + j) * kCStride + load_slot] = v[j];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFKC; ++kk) {
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
}

// Shared floats of the f32 bodies: the query block, transposed, and a stage.
size_t f32_smem(int d) {
  const int dpad = (d + kFKC - 1) / kFKC * kFKC;
  return sizeof(float) * (static_cast<size_t>(dpad) * kTQ + kFKC * kCStride);
}

// K4, f32 rows: the group of block blockIdx.x (`group_of`).
__global__ void __launch_bounds__(kF32Threads)
probed_leaf_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ leaves,
                       const int* __restrict__ order,
                       const int* __restrict__ bounds,
                       const int* __restrict__ last,
                       const int* __restrict__ block_leaf,
                       float* __restrict__ out, int num_probes,
                       int num_leaves, int cap, int d, int vec,
                       float mask_value) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int pair[kTQ];
  int start, count;
  const int leaf = group_of(bounds, last, block_leaf, num_leaves, &start,
                            &count);
  if (count == 0) return;  // past the live groups
  if (leaf >= num_leaves) {
    fill_pairs(out, order, start, count, cap, mask_value);
    return;
  }
  const int dpad = (d + kFKC - 1) / kFKC * kFKC;
  float* qs = smem;                                    // [dpad][kTQ]
  float* cs = smem + static_cast<size_t>(dpad) * kTQ;  // [kFKC][kCStride]
  const int tid = threadIdx.x;
  if (tid < kTQ) pair[tid] = tid < count ? order[start + tid] : -1;
  __syncthreads();
  for (int idx = tid; idx < kTQ * dpad; idx += kF32Threads) {
    const int r = idx / dpad;
    const int k = idx - r * dpad;
    const int qp = pair[r];
    qs[k * kTQ + r] =
        qp >= 0 && k < d ? q[static_cast<int64_t>(qp / num_probes) * d + k]
                         : 0.f;
  }
  const int tx = tid % 16, ty = tid / 16;
  for (int s0 = 0; s0 < cap; s0 += kNS) {
    float acc[4][4];
    f32_tile(qs, cs, leaves, static_cast<int64_t>(leaf) * cap + s0,
             min(kNS, cap - s0), d, dpad, vec != 0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= count) continue;
      float* o = out + static_cast<int64_t>(pair[r]) * cap + s0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s0 + tx + 16 * j < cap) o[tx + 16 * j] = acc[i][j];
      }
    }
  }
}

// K5, f32 rows: a 64-query x 64-bucket block of one query tile over the
// probes of split blockIdx.z; writes plane blockIdx.z of vals / rows.
__global__ void __launch_bounds__(kF32Threads)
probed_bucketed_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ leaves,
                           const int* __restrict__ leaf_rows,
                           const int* __restrict__ probes,
                           float* __restrict__ vals, int* __restrict__ rows_out,
                           int query_tile, int num_probes, int num_leaves,
                           int cap, int d, int buckets, int vec,
                           float mask_value) {
  extern __shared__ __align__(16) float smem[];
  const int dpad = (d + kFKC - 1) / kFKC * kFKC;
  float* qs = smem;                                    // [dpad][kTQ]
  float* cs = smem + static_cast<size_t>(dpad) * kTQ;  // [kFKC][kCStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // buckets b0 + tx + 16*j
  const int ty = tid / 16;  // tile members t0 + 4*ty + i
  const int qblocks = (query_tile + kTQ - 1) / kTQ;
  const int tile = blockIdx.y / qblocks;
  const int t0 = (blockIdx.y % qblocks) * kTQ;
  const int b0 = blockIdx.x * kNS;
  const int64_t q0 = static_cast<int64_t>(tile) * query_tile;
  const int p_begin =
      static_cast<int>(static_cast<int64_t>(num_probes) * blockIdx.z / gridDim.z);
  const int p_end = static_cast<int>(static_cast<int64_t>(num_probes) *
                                     (blockIdx.z + 1) / gridDim.z);

  for (int idx = tid; idx < kTQ * dpad; idx += kF32Threads) {
    const int qi = idx / dpad;
    const int k = idx - qi * dpad;
    qs[k * kTQ + qi] =
        t0 + qi < query_tile && k < d ? q[(q0 + t0 + qi) * d + k] : 0.f;
  }

  float best[4][4];
  int best_row[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[i][j] = mask_value;
      best_row[i][j] = -1;
    }
  }
  const int groups = (cap - b0 + buckets - 1) / buckets;  // b0 < B <= cap
  for (int p = p_begin; p < p_end; ++p) {
    const int leaf = probes[static_cast<int64_t>(tile) * num_probes + p];
    if (leaf < 0 || leaf >= num_leaves) continue;  // uniform in the block
    for (int g = 0; g < groups; ++g) {
      const int s0 = g * buckets + b0;
      float acc[4][4];
      f32_tile(qs, cs, leaves, static_cast<int64_t>(leaf) * cap + s0,
               min(min(kNS, buckets - b0), cap - s0), d, dpad, vec != 0, acc);
      // Fold group g of probe p into the running per-bucket max/argmax.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + tx + 16 * j;
        const int s = g * buckets + b;
        if (b >= buckets || s >= cap) continue;
        const int r = __ldg(leaf_rows + static_cast<int64_t>(leaf) * cap + s);
        if (r < 0) continue;  // padding scores MIN_FLOAT: never replaces
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (acc[i][j] > best[i][j]) {
            best[i][j] = acc[i][j];
            best_row[i][j] = r;
          }
        }
      }
    }
  }

  const int64_t plane = static_cast<int64_t>(blockIdx.z) *
                        (gridDim.y / qblocks) * query_tile * buckets;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (t < query_tile && b < buckets) {
        const int64_t o = plane + (q0 + t) * buckets + b;
        vals[o] = best[i][j];
        rows_out[o] = best_row[i][j];
      }
    }
  }
}

// --------------------------------------- tensor-core bodies (bf16, codes)

// bf16 terms a query value is split into: 3 for bf16 rows, 1 for codes.
__host__ __device__ constexpr int terms(int fmt) {
  return fmt == kBF16 ? 3 : 1;
}

// The NT bf16 terms of one query value: NT = 1 rounds it (codes); NT = 3
// splits it as h + m + l, whose sum is v exactly in the normal range.
template <int NT>
__device__ __forceinline__ void query_terms(float v, bf16 out[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    out[i] = __float2bfloat16(v);
    v -= __bfloat162float(out[i]);
  }
}

// Shared memory of a tensor-core block, in order: NT query planes
// [kTQ][dp + 8] bf16, then a ring of kRing stages, each the tile's slot
// rows for KC feature columns (bf16 rows: [kNS][KC + 8] bf16; codes: raw
// [kNS][KC + 16] bytes, decoded as they are multiplied) and its slot rows
// and scales (2 x kNS x 4 bytes).
template <int KC>
struct TcLayout {
  static constexpr int kSlab = KC + 8;  // bf16 stride of a staged slot row
  static constexpr int kRaw = KC + 16;  // byte stride of a staged code row
  int qstride, q_elems, stage_bytes;
  __host__ __device__ TcLayout(int fmt, int d)
      : qstride((d + 15) / 16 * 16 + 8),
        q_elems(terms(fmt) * kTQ * qstride),
        stage_bytes(kNS * row_bytes(fmt) + 2 * kNS * 4) {}
  __host__ __device__ static constexpr int row_bytes(int fmt) {
    return fmt == kBF16 ? kSlab * 2 : kRaw;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * static_cast<size_t>(q_elems) +
           static_cast<size_t>(kRing) * stage_bytes;
  }
};

// Column of feature k in a code block's query planes. A B fragment of
// codes is read as 4 consecutive bytes of a slot row, columns 4t .. 4t+3
// of each 16 (lane t), which m16n8k16 takes as k = 2t, 2t+1, 2t+8, 2t+9;
// storing the query's columns in that order keeps every product aligned.
__device__ __forceinline__ int permuted(int k) {
  const int t = (k & 15) >> 2, j = k & 3;
  return (k & ~15) + (j < 2 ? 2 * t + j : 8 + 2 * t + j - 2);
}

// Writes the block's query rows (global row qrow[r], or zeros for -1) as
// NT bf16 planes [kTQ][qstride], columns [d, dp) zero; for codes (kPerm)
// in the order `permuted` gives.
template <int NT, bool kPerm>
__device__ __forceinline__ void stage_queries(bf16* qs, int qstride,
                                              const float* __restrict__ q,
                                              const int64_t* qrow, int d) {
  const int dp = qstride - 8;
  const int plane = kTQ * qstride;
  for (int idx = threadIdx.x; idx < kTQ * dp; idx += blockDim.x) {
    const int r = idx / dp;
    const int c = idx - r * dp;
    const int64_t row = qrow[r];
    bf16 t[NT];
    query_terms<NT>(row >= 0 && c < d ? q[row * d + c] : 0.f, t);
    const int at = r * qstride + (kPerm ? permuted(c) : c);
#pragma unroll
    for (int i = 0; i < NT; ++i) qs[i * plane + at] = t[i];
  }
}

// Stages columns [col0, col0 + KC) of slot rows s0 + i, i < nrows, of
// `leaf` into one ring stage (bf16 rows or raw codes, TcLayout), by
// cp.async when `vec` (16-byte aligned rows), else by plain loads; rows
// i >= nrows and columns >= d are zeros. With `fold_rows` / `fold_scales`
// it also copies the tile's slot rows / scales into the stage's fold
// block.
template <int FMT, int KC>
__device__ __forceinline__ void stage_tile(
    unsigned char* stage, const void* __restrict__ leaves,
    const int* __restrict__ fold_rows, const float* __restrict__ fold_scales,
    int64_t leaf, int s0, int nrows, int cap, int d, int col0, bool vec) {
  constexpr int kBytes = FMT == kBF16 ? 2 : 1;    // stored bytes an element
  constexpr int kRow = TcLayout<KC>::row_bytes(FMT);
  const int tid = threadIdx.x;
  const char* src = static_cast<const char*>(leaves);
  if (vec) {
    constexpr int kChunks = KC * kBytes / 16;       // 16-byte chunks a row
    for (int idx = tid; idx < kNS * kChunks; idx += kTcThreads) {
      const int i = idx / kChunks;
      const int c = (idx % kChunks) * (16 / kBytes);  // column in the stage
      const bool ok = i < nrows && col0 + c < d;
      const char* p =
          ok ? src + (stored_row<FMT>(leaf, s0 + i, cap) * d + col0 + c) *
                         kBytes
             : src;
      tc::cp_async16(stage + i * kRow + c * kBytes, p, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kNS * KC; idx += kTcThreads) {
      const int i = idx / KC;
      const int c = idx % KC;
      const bool ok = i < nrows && col0 + c < d;
      const int64_t e = ok ? stored_row<FMT>(leaf, s0 + i, cap) * d + col0 + c
                           : 0;
      if constexpr (FMT == kBF16) {
        reinterpret_cast<bf16*>(stage + i * kRow)[c] =
            ok ? static_cast<const bf16*>(leaves)[e] : __float2bfloat16(0.f);
      } else {
        stage[i * kRow + c] = ok ? src[e] : 0;
      }
    }
  }
  // The fold block after the rows: [kNS] slot rows, then [kNS] scales.
  const void* fold_src = tid < kNS ? static_cast<const void*>(fold_rows)
                                   : static_cast<const void*>(fold_scales);
  if (tid < 2 * kNS && fold_src != nullptr) {
    const int i = tid % kNS;
    const bool ok = i < nrows;
    const char* p = static_cast<const char*>(fold_src) +
                    (ok ? 4 * (leaf * cap + s0 + i) : 0);
    tc::cp_async4(stage + kNS * kRow + 4 * tid, p, ok ? 4 : 0);
  }
}

// step(kk) for kk = 0, 16, .. < width: unrolled when the stage is full.
template <int KC, class Step>
__device__ __forceinline__ void k_steps(int width, Step step) {
  if (width == KC) {
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) step(kk);
  } else {
    for (int kk = 0; kk < width; kk += 16) step(kk);
  }
}

// acc += the warp's 32 queries x 32 slots over query columns [k0, k0 +
// width) and stage columns [0, width). bf16 rows: B fragments by ldmatrix
// from the slab, meeting the NT query terms in turn. Codes: each lane
// reads 4 code bytes of its slot row a k-step and decodes them to two
// bf16 pairs (exact; int4 slots in the leaf's second half take the high
// nibbles), against the permuted query columns.
template <int FMT, int KC>
__device__ __forceinline__ void mma_tile(float acc[2][4][4], const bf16* qs,
                                         int qstride,
                                         const unsigned char* stage, int k0,
                                         int width, int s0, int cap, int wm,
                                         int wn, int lane) {
  constexpr int NT = terms(FMT);
  const int plane = kTQ * qstride;
  const bf16* qa = qs + (wm * 32) * qstride + k0;
  if constexpr (FMT == kBF16) {
    constexpr int kSlab = TcLayout<KC>::kSlab;
    const bf16* slab = reinterpret_cast<const bf16*>(stage);
    auto step = [&](int kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tc::load_b(b[h], slab + (wn * 32 + h * 16) * kSlab, kSlab, kk, lane);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          uint32_t a[4];
          tc::load_a(a, qa + t * plane + mb * 16 * qstride, qstride, kk,
                     lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tc::mma_bf16(acc[mb][2 * h], a, b[h][0], b[h][1]);
            tc::mma_bf16(acc[mb][2 * h + 1], a, b[h][2], b[h][3]);
          }
        }
      }
    };
    k_steps<KC>(width, step);
  } else {
    constexpr int kRaw = TcLayout<KC>::kRaw;
    // Lane (g, t) reads slot row wn*32 + nb*8 + g, bytes 4t .. 4t+3 of each
    // 16-column step.
    const unsigned char* rows =
        stage + (wn * 32 + (lane >> 2)) * kRaw + 4 * (lane & 3);
    int shift[4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      shift[nb] = FMT == kInt4 && s0 + wn * 32 + nb * 8 + (lane >> 2) >=
                                      cap / 2
                      ? 4
                      : 0;
    }
    auto step = [&](int kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(rows + nb * 8 * kRaw + kk);
        if constexpr (FMT == kInt8) {
          b[nb][0] = tc::int8x2_to_bf16x2(w ^ 0x80808080u, 0);
          b[nb][1] = tc::int8x2_to_bf16x2(w ^ 0x80808080u, 2);
        } else {
          b[nb][0] =
              tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4140) >> shift[nb]);
          b[nb][1] =
              tc::int4x2_to_bf16x2(__byte_perm(w, 0u, 0x4342) >> shift[nb]);
        }
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t a[4];
        tc::load_a(a, qa + mb * 16 * qstride, qstride, kk, lane);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          tc::mma_bf16(acc[mb][nb], a, b[nb][0], b[nb][1]);
        }
      }
    };
    k_steps<KC>(width, step);
  }
}

// One 64-slot tile of a block's walk: slots [s0, s0 + nrows) of `leaf`;
// a tile that is not `live` (a probe outside [0, L)) is neither read nor
// folded.
struct Tile {
  int64_t leaf;
  int s0;
  int nrows;
  bool live;
};

// The block's walk over `tiles` slot tiles, tile_of(i) giving tile i: each
// tile comes in ceil(dp / KC) column stages through a ring of kRing
// stages, kRing - 1 of them in flight while one is multiplied, one block
// barrier a stage; after a tile's last stage, epilogue(tile, acc, wm, wn,
// lane, rows, scales) with the warp's accumulators (c-index 2h + e of
// [m-block][n-block] is query row g + 8h, slot column 2t + e) and the
// tile's staged slot rows and scales (in shared memory; with null
// `fold_*`, not staged). The query planes must be written before the call.
template <int FMT, int KC, class TileOf, class Epilogue>
__device__ __forceinline__ void tc_walk(
    const bf16* qs, int qstride, unsigned char* ring, int stage_bytes,
    const void* __restrict__ leaves, const int* __restrict__ fold_rows,
    const float* __restrict__ fold_scales, int cap, int d, bool vec,
    int tiles, TileOf tile_of, Epilogue epilogue) {
  constexpr int kRow = TcLayout<KC>::row_bytes(FMT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int dp = qstride - 8;
  const int kchunks = (dp + KC - 1) / KC;
  const int stages = tiles * kchunks;
  // Cursors (tile, column chunk, ring slot) of the next stage to copy and
  // of the stage to multiply, advanced without divisions.
  int in_tile = 0, in_kc = 0, in_slot = 0;
  auto copy_next = [&]() {
    const Tile t = tile_of(in_tile);
    if (t.live) {  // uniform in the block
      stage_tile<FMT, KC>(ring + in_slot * stage_bytes, leaves, fold_rows,
                          fold_scales, t.leaf, t.s0, t.nrows, cap, d,
                          in_kc * KC, vec);
    }
    if (++in_kc == kchunks) {
      in_kc = 0;
      ++in_tile;
    }
    if (++in_slot == kRing) in_slot = 0;
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < stages) copy_next();
    tc::cp_async_commit();
  }
  int tile = 0, kc = 0, slot = 0;
  Tile t = tile_of(0);
  float acc[2][4][4];
  for (int s = 0; s < stages; ++s) {
    tc::cp_async_wait<kRing - 2>();
    // Stage s has landed for every thread, and every warp is done with
    // stage s - 1, whose ring slot the next copy refills.
    __syncthreads();
    if (s + kRing - 1 < stages) copy_next();
    tc::cp_async_commit();
    const unsigned char* st = ring + slot * stage_bytes;
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
    if (t.live) {
      mma_tile<FMT, KC>(acc, qs, qstride, st, kc * KC, min(KC, dp - kc * KC),
                        t.s0, cap, wm, wn, lane);
      if (kc == kchunks - 1) {
        const int* rows = reinterpret_cast<const int*>(st + kNS * kRow);
        epilogue(t, acc, wm, wn, lane, rows,
                 reinterpret_cast<const float*>(rows + kNS));
      }
    }
    if (++kc == kchunks) {
      kc = 0;
      if (++tile < tiles) t = tile_of(tile);
    }
    if (++slot == kRing) slot = 0;
  }
}

// K4, bf16 rows and codes. Block b takes group j of leaf block_leaf[b]:
// pairs [bounds[l] + 64 j, ...) of `order` (at most 64), where the leaf's
// groups are the last ceil(pairs / 64) before last[l]; leaf L holds the
// pairs of probes outside [0, L), and blocks past the live groups (leaf
// L + 1) exit. The group's queries against every slot of its leaf.
template <int FMT, int KC>
__global__ void __launch_bounds__(kTcThreads, 3)
probed_leaf_tc_kernel(const float* __restrict__ q,
                      const void* __restrict__ leaves,
                      const float* __restrict__ scales,
                      const int* __restrict__ order,
                      const int* __restrict__ bounds,
                      const int* __restrict__ last,
                      const int* __restrict__ block_leaf,
                      float* __restrict__ out, int num_probes,
                      int num_leaves, int cap, int d, int vec,
                      float mask_value) {
  constexpr int NT = terms(FMT);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __shared__ int64_t qrow[kTQ];
  __shared__ int pair[kTQ];
  int start, count;
  const int leaf = group_of(bounds, last, block_leaf, num_leaves, &start,
                            &count);
  if (count == 0) return;  // past the live groups
  if (leaf >= num_leaves) {
    fill_pairs(out, order, start, count, cap, mask_value);
    return;
  }
  const TcLayout<KC> lay(FMT, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  unsigned char* ring = smem_tc + 2 * lay.q_elems;
  if (threadIdx.x < kTQ) {
    const int i = threadIdx.x;
    const int qp = i < count ? order[start + i] : -1;
    pair[i] = qp;
    qrow[i] = qp >= 0 ? qp / num_probes : -1;
  }
  __syncthreads();
  stage_queries<NT, FMT != kBF16>(qs, lay.qstride, q, qrow, d);
  const bool even = (cap & 1) == 0;
  tc_walk<FMT, KC>(
      qs, lay.qstride, ring, lay.stage_bytes, leaves, nullptr,
      FMT == kBF16 ? nullptr : scales, cap, d, vec != 0,
      (cap + kNS - 1) / kNS,
      [&](int i) {
        const int s0 = i * kNS;
        return Tile{leaf, s0, min(kNS, cap - s0), true};
      },
      [&](const Tile& t, float (&acc)[2][4][4], int wm, int wn, int lane,
          const int*, const float* sc) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mb * 16 + (lane >> 2) + 8 * h;
            if (r >= count) continue;
            float* o = out + static_cast<int64_t>(pair[r]) * cap;
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              const int c = wn * 32 + nb * 8 + 2 * (lane & 3);
              const int s = t.s0 + c;
              float v0 = acc[mb][nb][2 * h], v1 = acc[mb][nb][2 * h + 1];
              if constexpr (FMT != kBF16) {
                v0 *= sc[c];
                v1 *= sc[c + 1];
              }
              if (even && s < cap) {
                *reinterpret_cast<float2*>(o + s) = make_float2(v0, v1);
              } else {
                if (s < cap) o[s] = v0;
                if (s + 1 < cap) o[s + 1] = v1;
              }
            }
          }
        }
      });
}

// K5, bf16 rows and codes: a 64-query x 64-bucket block of one query tile
// over the probes of split blockIdx.z; writes plane blockIdx.z.
template <int FMT, int KC>
__global__ void __launch_bounds__(kTcThreads, 3)
probed_bucketed_tc_kernel(const float* __restrict__ q,
                          const void* __restrict__ leaves,
                          const float* __restrict__ scales,
                          const int* __restrict__ leaf_rows,
                          const int* __restrict__ probes,
                          float* __restrict__ vals, int* __restrict__ rows_out,
                          int query_tile, int num_probes, int num_leaves,
                          int cap, int d, int buckets, int vec,
                          float mask_value) {
  constexpr int NT = terms(FMT);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __shared__ int64_t qrow[kTQ];
  __shared__ int probe_ids[kSplitProbes];  // the split's probes
  const int qblocks = (query_tile + kTQ - 1) / kTQ;
  const int tile = blockIdx.y / qblocks;
  const int t0 = (blockIdx.y % qblocks) * kTQ;
  const int b0 = blockIdx.x * kNS;
  const int64_t q0 = static_cast<int64_t>(tile) * query_tile;
  const int p_begin =
      static_cast<int>(static_cast<int64_t>(num_probes) * blockIdx.z / gridDim.z);
  const int p_end = static_cast<int>(static_cast<int64_t>(num_probes) *
                                     (blockIdx.z + 1) / gridDim.z);
  const TcLayout<KC> lay(FMT, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  unsigned char* ring = smem_tc + 2 * lay.q_elems;
  if (threadIdx.x < kTQ) {
    const int i = threadIdx.x;
    qrow[i] = t0 + i < query_tile ? q0 + t0 + i : -1;
  }
  const int* tile_probes = probes + static_cast<int64_t>(tile) * num_probes;
  for (int i = threadIdx.x; i < p_end - p_begin; i += blockDim.x) {
    probe_ids[i] = tile_probes[p_begin + i];
  }
  __syncthreads();
  stage_queries<NT, FMT != kBF16>(qs, lay.qstride, q, qrow, d);

  // Running best of the fragment positions, in the accumulator layout.
  float best[2][4][4];
  int best_row[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best[mb][nb][i] = mask_value;
        best_row[mb][nb][i] = -1;
      }
    }
  }
  const int groups = (cap - b0 + buckets - 1) / buckets;  // b0 < B <= cap
  const int width = min(kNS, buckets - b0);
  tc_walk<FMT, KC>(
      qs, lay.qstride, ring, lay.stage_bytes, leaves, leaf_rows,
      FMT == kBF16 ? nullptr : scales, cap, d, vec != 0,
      (p_end - p_begin) * groups,
      [&](int i) {
        const int p = i / groups;
        const int leaf = probe_ids[p];
        const int s0 = (i - p * groups) * buckets + b0;
        return Tile{leaf, s0, min(width, cap - s0),
                    leaf >= 0 && leaf < num_leaves};
      },
      [&](const Tile& t, float (&acc)[2][4][4], int wm, int wn, int lane,
          const int* slot_rows, const float* sc) {
        // Fold the group: scale, skip padding, keep the strictly greater.
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = wn * 32 + nb * 8 + 2 * (lane & 3) + e;
            if (c >= t.nrows) continue;  // past the buckets or the leaf
            const int r = slot_rows[c];
            if (r < 0) continue;  // padding scores MIN_FLOAT: never replaces
            const float scale = FMT == kBF16 ? 1.f : sc[c];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v = acc[mb][nb][2 * h + e];
                if constexpr (FMT != kBF16) v *= scale;
                if (v > best[mb][nb][2 * h + e]) {
                  best[mb][nb][2 * h + e] = v;
                  best_row[mb][nb][2 * h + e] = r;
                }
              }
            }
          }
        }
      });

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) *
                        (gridDim.y / qblocks) * query_tile * buckets;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tq = t0 + wm * 32 + mb * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = b0 + wn * 32 + nb * 8 + 2 * (lane & 3) + e;
          if (tq < query_tile && b < buckets) {
            const int64_t o = plane + (q0 + tq) * buckets + b;
            vals[o] = best[mb][nb][2 * h + e];
            rows_out[o] = best_row[mb][nb][2 * h + e];
          }
        }
      }
    }
  }
}

// Merges K5's split planes [splits][plane] in order of split: a later
// split's value replaces only when strictly greater, so the first maximum
// in probe order wins, as in the unsplit walk.
__global__ void merge_probe_splits_kernel(const float* __restrict__ split_vals,
                                          const int* __restrict__ split_rows,
                                          int64_t plane, int splits,
                                          float* __restrict__ vals,
                                          int* __restrict__ rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= plane) return;
  float v = split_vals[i];
  int r = split_rows[i];
  for (int s = 1; s < splits; ++s) {
    const float x = split_vals[s * plane + i];
    if (x > v) {
      v = x;
      r = split_rows[s * plane + i];
    }
  }
  vals[i] = v;
  rows[i] = r;
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int FMT, int KC>
cudaError_t launch_leaf_tc(const float* q, const void* leaves,
                           const float* scales, const int* order,
                           const int* bounds, const int* last,
                           const int* block_leaf, int blocks, float* out,
                           int num_probes, int num_leaves, int cap, int d,
                           int vec, float mask_value, cudaStream_t stream) {
  auto kernel = probed_leaf_tc_kernel<FMT, KC>;
  const size_t smem = TcLayout<KC>(FMT, d).bytes();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTcThreads, smem, stream>>>(
      q, leaves, scales, order, bounds, last, block_leaf, out, num_probes,
      num_leaves, cap, d, vec, mask_value);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_leaf_format(const float* q, const void* leaves,
                               const float* scales, const int* order,
                               const int* bounds, const int* last,
                               const int* block_leaf, int blocks, float* out,
                               int num_probes, int num_leaves, int cap, int d,
                               int vec, float mask_value,
                               cudaStream_t stream) {
  if (TcLayout<128>(FMT, d).bytes() <= kWideSmem) {
    return launch_leaf_tc<FMT, 128>(q, leaves, scales, order, bounds, last,
                                    block_leaf, blocks, out, num_probes,
                                    num_leaves, cap, d, vec, mask_value,
                                    stream);
  }
  return launch_leaf_tc<FMT, 64>(q, leaves, scales, order, bounds, last,
                                 block_leaf, blocks, out, num_probes,
                                 num_leaves, cap, d, vec, mask_value, stream);
}

template <int FMT, int KC>
cudaError_t launch_bucketed_tc(const float* q, const void* leaves,
                               const float* scales, const int* leaf_rows,
                               const int* probes, float* vals, int* rows,
                               dim3 grid, int query_tile, int num_probes,
                               int num_leaves, int cap, int d, int buckets,
                               int vec, float mask_value,
                               cudaStream_t stream) {
  auto kernel = probed_bucketed_tc_kernel<FMT, KC>;
  const size_t smem = TcLayout<KC>(FMT, d).bytes();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      q, leaves, scales, leaf_rows, probes, vals, rows, query_tile,
      num_probes, num_leaves, cap, d, buckets, vec, mask_value);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_bucketed_format(const float* q, const void* leaves,
                                   const float* scales, const int* leaf_rows,
                                   const int* probes, float* vals, int* rows,
                                   dim3 grid, int query_tile, int num_probes,
                                   int num_leaves, int cap, int d,
                                   int buckets, int vec, float mask_value,
                                   cudaStream_t stream) {
  if (TcLayout<128>(FMT, d).bytes() <= kWideSmem) {
    return launch_bucketed_tc<FMT, 128>(q, leaves, scales, leaf_rows, probes,
                                        vals, rows, grid, query_tile,
                                        num_probes, num_leaves, cap, d,
                                        buckets, vec, mask_value, stream);
  }
  return launch_bucketed_tc<FMT, 64>(q, leaves, scales, leaf_rows, probes,
                                     vals, rows, grid, query_tile,
                                     num_probes, num_leaves, cap, d, buckets,
                                     vec, mask_value, stream);
}

}  // namespace

extern "C" {

// format: 0 = f32 rows, 1 = bf16 rows, 2 = int8 codes, 3 = packed int4.
// q is f32 [num_q, d]. The plan (`group_of`, ops/leaf_scoring.py
// `leaf_groups`): `order` int32 [num_q * num_probes], the flat pairs
// query * num_probes + probe sorted by leaf; `bounds` int32 [L + 2];
// `last` int32 [L + 1]; `block_leaf` int32 [blocks]. out f32
// [num_q, num_probes * cap]; cap is the logical slot count of a leaf.
// vec: rows 16-byte aligned (d % 8 == 0 for f32 and bf16, d % 16 == 0 for
// codes, an aligned table). Returns the cudaError_t of the launch.
int probed_leaf_scores_launch(int format, const float* q, const void* leaves,
                              const float* scales, const int* order,
                              const int* bounds, const int* last,
                              const int* block_leaf, int blocks, float* out,
                              int num_probes, int num_leaves, int cap, int d,
                              int vec, float mask_value, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxDim || blocks <= 0 || num_probes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (format) {
    case kF32: {
      const size_t smem = f32_smem(d);
      cudaError_t err = set_smem(probed_leaf_f32_kernel, smem);
      if (err != cudaSuccess) return err;
      probed_leaf_f32_kernel<<<blocks, kF32Threads, smem, s>>>(
          q, static_cast<const float*>(leaves), order, bounds, last,
          block_leaf, out, num_probes, num_leaves, cap, d, vec, mask_value);
      return cudaGetLastError();
    }
#define RTPU_LAUNCH_LEAF(F)                                                  \
  launch_leaf_format<F>(q, leaves, scales, order, bounds, last, block_leaf,  \
                        blocks, out, num_probes, num_leaves, cap, d, vec,    \
                        mask_value, s)
    case kBF16: return RTPU_LAUNCH_LEAF(kBF16);
    case kInt8: return RTPU_LAUNCH_LEAF(kInt8);
    case kInt4: return RTPU_LAUNCH_LEAF(kInt4);
#undef RTPU_LAUNCH_LEAF
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q is f32 [tiles * query_tile, d]; probes int32 [tiles, num_probes];
// leaf_rows int32 [num_leaves, cap]; vals f32 and rows int32
// [tiles * query_tile, buckets]. vec as for probed_leaf_scores_launch.
// splits (1 .. max(1, num_probes)) blocks share each block's probe walk,
// split z over probes [P*z/S, P*(z+1)/S); with splits > 1, split_vals /
// split_rows hold splits * Q * B entries and a second kernel merges them.
int probed_bucketed_scores_launch(int format, const float* q,
                                  const void* leaves, const float* scales,
                                  const int* leaf_rows, const int* probes,
                                  float* vals, int* rows, int tiles,
                                  int query_tile, int num_probes,
                                  int num_leaves, int cap, int d, int buckets,
                                  int vec, int splits, float* split_vals,
                                  int* split_rows, float mask_value,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxDim || buckets <= 0 || buckets > cap ||
      splits < 1 || splits > (num_probes > 1 ? num_probes : 1) ||
      (num_probes + splits - 1) / splits > kSplitProbes ||
      (splits > 1 && (split_vals == nullptr || split_rows == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((buckets + kNS - 1) / kNS,
                  tiles * ((query_tile + kTQ - 1) / kTQ), splits);
  float* v = splits > 1 ? split_vals : vals;
  int* r = splits > 1 ? split_rows : rows;
  cudaError_t err;
  switch (format) {
    case kF32: {
      const size_t smem = f32_smem(d);
      err = set_smem(probed_bucketed_f32_kernel, smem);
      if (err != cudaSuccess) return err;
      probed_bucketed_f32_kernel<<<grid, kF32Threads, smem, s>>>(
          q, static_cast<const float*>(leaves), leaf_rows, probes, v, r,
          query_tile, num_probes, num_leaves, cap, d, buckets, vec,
          mask_value);
      err = cudaGetLastError();
      break;
    }
#define RTPU_LAUNCH_BUCKETED(F)                                              \
  launch_bucketed_format<F>(q, leaves, scales, leaf_rows, probes, v, r,     \
                            grid, query_tile, num_probes, num_leaves, cap,  \
                            d, buckets, vec, mask_value, s)
    case kBF16: err = RTPU_LAUNCH_BUCKETED(kBF16); break;
    case kInt8: err = RTPU_LAUNCH_BUCKETED(kInt8); break;
    case kInt4: err = RTPU_LAUNCH_BUCKETED(kInt4); break;
#undef RTPU_LAUNCH_BUCKETED
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t plane = static_cast<int64_t>(tiles) * query_tile * buckets;
  merge_probe_splits_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256,
                              0, s>>>(split_vals, split_rows, plane, splits,
                                      vals, rows);
  return cudaGetLastError();
}

const char* leaf_scoring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
