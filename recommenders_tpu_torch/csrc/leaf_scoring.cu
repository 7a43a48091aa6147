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
// What bounds it on the H100. K4 at the served shape (Q=256 queries, P=128
// probes of cap=1280 rows, D=128, L=1024) probes almost every leaf about
// 32 times: read once a (query, probe) pair that is 10.7 GB of bf16 rows,
// read once a leaf 335 MB (671 MB of f32 rows), and the [Q, P*cap] f32
// scores are 168 MB more, so staged once per leaf it is bound by memory
// (~0.15 ms for bf16 rows, 0.25 for f32). K5 shares each leaf among a
// tile of T queries: at T=64, P=256, cap=1280, D=128, Q=1024 it does up to
// 86 GFLOP on 0.2-0.7 GB of distinct leaves, hundreds of FLOP a byte, so
// it is bound by the products: 0.06 ms a pass at the bf16 tensor-core
// peak, three passes for bf16 rows and six for f32 rows (below). On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the one-pass bodies take
// 0.23-0.33 ms (K4) and 0.26-1.05 ms (K5), 2-15x their bounds: each 64 x
// 64 x 128 stage costs a block barrier, the code decode and the fold,
// with 12 warps an SM (160-168 registers a thread). The f32 bodies run
// eight warps an SM (two 109 KB blocks), issue twice the bf16 rows'
// products and split every B fragment on the ALUs beside them (PERF.md,
// section 6, has their times).
//
// What the design does about it. The TPU ran its grid (query, probe) in
// order and carried K5's running argmax in VMEM from one probe to the
// next. Hopper runs blocks in no order.
//   Tensor cores. Every body multiplies a 64-query x 64-slot tile with
//   mma.sync.m16n8k16 (tensor_core.cuh): four warps of 32 x 32, the slot
//   rows coming in stages of 128 feature columns (64 for f32 rows, and where
//   a block would outgrow shared memory) through a three-stage cp.async ring
//   with one block barrier a stage, each stage carrying the tile's slot rows
//   and scales for the epilogue. Codes are decoded to bf16 (exact) as they
//   are multiplied: a lane reads 4 code bytes of its slot row a k-step and
//   the query columns are stored permuted to match (`permuted`). Codes meet
//   the query rounded to bf16. Rows meet the unrounded f32 query, so the
//   query is split once, into three bf16 planes, h = bf16(q),
//   m = bf16(q - h), l = bf16(q - h - m), whose sum is q exactly (in the
//   normal range).
//   bf16 rows are exact in bf16, so the three products are exact and only
//   the f32 sums round, as in the f32 twin. f32 rows come raw through the
//   ring ([64][KC + 8] f32 a stage) and each lane splits its B fragment into
//   h + m + l as it loads it (tc::split3, as K3's f32 body does,
//   csrc/bucketed_scores.cu); six of the nine term products, hh, hm, mh, hl,
//   lh and mm, are taken, each exact in f32. The dropped ml, lm and ll are
//   at most 1.006 * 2^-23 of |q_k||c_k| a product (plus 2^-134 of the
//   partner for a value below 2^-110, which the split rounds onto bf16's
//   subnormal grid: ops/scoring.py `split_error_bound`); hh sums in one f32
//   accumulator and the other five, together 2^-7 as large, in a second,
//   added once a tile. With the twin's own f32 dot (D * 2^-24 * sum|q||c|)
//   that is 1.006 + D/2 of the D units of 2^-23 * sum|q||c| the card's
//   tolerance allows (tests/test_torch_leaf_split.py). The three query
//   planes and three raw f32 stages of 64 columns take 109 KB at D = 128,
//   two blocks (8 warps) an SM; past D = 432 the stages are 32 wide in a
//   ring of two (`with_stages`). The split keeps more registers live
//   (230-238 a thread for K5, 161-171 for K4, no spills), so these bodies
//   are held to two blocks' worth (255) instead of three (168).
//   K4, leaf-major: the wrapper sorts the Q*P (query, probe) pairs by leaf
//   on the device and cuts each leaf's run into groups of at most 64
//   pairs (probes outside [0, L) form a run of their own), one block a
//   group on a grid of ceil(Q*P/64) + L blocks, so no host
//   synchronisation sizes it (ops/leaf_scoring.py `leaf_groups`,
//   `group_of` below); a block gathers its group's queries into shared
//   memory, walks the leaf's slots 64 at a time and stores each query
//   row's scores, scaled, as float2 runs. A leaf is read once a group
//   instead of once a pair; blocks past the live groups exit at once.
//   K5 (f32, bf16, int4): a block owns 64 queries x 64 buckets of one
//   query tile and walks a contiguous range of that tile's probes (split
//   z of S, its probe ids in shared memory), with its running (max, row)
//   in registers in the accumulator layout; S is chosen by the wrapper to
//   fill the card. A
//   second kernel merges the S partial planes in order of z with strict
//   `>`, so the first maximum in fold order still wins (not K3's merge,
//   which sends ties to the lowest row: here an earlier probe's higher row
//   must win).
//   K5 int8 (`probed_bucketed_int8_kernel`). At the 100M catalog's
//   request (8 tiles of T = 32 queries, P = 1,536 probes of cap 12,928
//   slots, B = 8,192, D = 128) the products are 1.1 TFLOP but the tiles'
//   probed leaves are 17.6 GB read once a (tile, leaf) pair and 10.7 GB
//   read once a leaf: it is bound by bytes (3.2 ms at 3.35 TB/s, 3.8 at
//   the 2.85 the card streams). The mma.sync body it replaced used
//   64-query blocks (half of every block's rows empty at T = 32), walked
//   each tile's probes on its own through a three-stage cp.async ring
//   with a block barrier a stage, and left the bucket tiles that fold two
//   groups a leaf twice the work of the others (17.8 ms). Here a block is
//   a consumer warpgroup and a producer warp: the query block is
//   exactly the tile (NQ = 16, 32 or 64 columns of wgmma's B), each
//   unit's 64 contiguous slot rows, their scales and rows come in by
//   cp.async.bulk on an mbarrier ring (the scales and rows the consumers
//   once loaded themselves cost two serial trips to memory a unit), and
//   the consumers decode the codes to bf16 A fragments in registers, as
//   K3's int8 body does, eight k-steps in flight a wait. It is bound by
//   the consumers' work still (their decode, products and fold; the
//   bytes alone stream in about half its time). The first maximum of the
//   reference's fold is kept by an order key, key = p * G + g (p the
//   probe's position in the tile's list, g the group, G the groups a
//   leaf): the walk visits keys in rising order, and the merge of the
//   splits (`finalize_int8_kernel`, which also turns a key into its row)
//   sends a tie to the lower key. Walking each tile's probes in leaf
//   order instead, so that the tiles sharing a leaf read it at about the
//   same time, was no faster on the H100 (PERF.md, section 6).
//   The split gives a bucket tile S * G_bt blocks, so blocks of one-group
//   and two-group tiles walk the same number of units.
// Any D <= 512 and any cap are taken: ragged edges are masked, and rows
// that are not 16-byte aligned are staged by plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Format { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

constexpr int kMaxDim = 512;
constexpr int kTQ = 64;  // query rows of a block: a K4 group, a K5 query block
constexpr int kNS = 64;  // slots (K5: buckets) of a block's tile

// Stages of KC = 128 feature columns (64 where 128 would not fit in shared
// memory); f32 rows take 64 (32 in a ring of two past D = 432).
constexpr int kRing = 3;            // stages of the cp.async ring
constexpr int kTcThreads = 128;     // 4 warps, each 32 queries x 32 slots
constexpr size_t kWideSmem = 200 * 1024;  // most bytes a KC = 128 block takes
// Most dynamic bytes a block takes: 227 KB less room for the static
// arrays (at most 1.5 KB).
constexpr size_t kMaxSmem = 232448 - 2048;
constexpr int kSplitProbes = 256;   // most probes a K5 split walks

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

// ------------------------------------------- tensor-core bodies (every format)

// bf16 terms a query value is split into: 3 for f32 and bf16 rows, 1
// for codes.
__host__ __device__ constexpr int terms(int fmt) {
  return fmt == kF32 || fmt == kBF16 ? 3 : 1;
}

// Codes (int8, int4): a scale a slot, and the query rounded once.
__host__ __device__ constexpr bool is_code(int fmt) {
  return fmt == kInt8 || fmt == kInt4;
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

// Shared memory of a block, in order: NT query planes [kTQ][dp + 8] bf16,
// then a ring of RING stages, each the tile's slot rows for KC feature
// columns (f32 rows: raw [kNS][KC + 8] f32, split as they are multiplied;
// bf16 rows: [kNS][KC + 8] bf16; codes: raw [kNS][KC + 16] bytes, decoded
// as they are multiplied) and its slot rows and scales (2 x kNS x 4
// bytes).
template <int KC, int RING = kRing>
struct TcLayout {
  static constexpr int kSlab = KC + 8;  // element stride of a f32 / bf16 row
  static constexpr int kRaw = KC + 16;  // byte stride of a staged code row
  int qstride, q_elems, stage_bytes;
  __host__ __device__ TcLayout(int fmt, int d)
      : qstride((d + 15) / 16 * 16 + 8),
        q_elems(terms(fmt) * kTQ * qstride),
        stage_bytes(kNS * row_bytes(fmt) + 2 * kNS * 4) {}
  __host__ __device__ static constexpr int row_bytes(int fmt) {
    return fmt == kF32 ? kSlab * 4 : fmt == kBF16 ? kSlab * 2 : kRaw;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * static_cast<size_t>(q_elems) +
           static_cast<size_t>(RING) * stage_bytes;
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
// `leaf` into one ring stage (f32 or bf16 rows, or raw codes, TcLayout),
// by cp.async when `vec` (16-byte aligned rows), else by plain loads; rows
// i >= nrows and columns >= d are zeros. With `fold_rows` / `fold_scales`
// it also copies the tile's slot rows / scales into the stage's fold
// block.
template <int FMT, int KC>
__device__ __forceinline__ void stage_tile(
    unsigned char* stage, const void* __restrict__ leaves,
    const int* __restrict__ fold_rows, const float* __restrict__ fold_scales,
    int64_t leaf, int s0, int nrows, int cap, int d, int col0, bool vec) {
  // Stored bytes an element.
  constexpr int kBytes = FMT == kF32 ? 4 : FMT == kBF16 ? 2 : 1;
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
      if constexpr (FMT == kF32) {
        reinterpret_cast<float*>(stage + i * kRow)[c] =
            ok ? static_cast<const float*>(leaves)[e] : 0.f;
      } else if constexpr (FMT == kBF16) {
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
// width) and stage columns [0, width). f32 rows: each lane reads its B
// fragment's four f32 values (two 8-byte loads; a row stride of KC + 8
// floats keeps them off each other's banks) and splits them into h, m and
// l (tc::split3); the six term products hh, hm, mh, hl, lh and mm are
// exact, hh sums into acc and the other five, 2^-7 as large together,
// into `small` (the caller adds it once a tile, as K3's f32 body does).
// bf16 rows: B fragments by ldmatrix from the slab, meeting the NT query
// terms in turn. Codes: each lane reads 4 code bytes of its slot row a
// k-step and decodes them to two bf16 pairs (exact; int4 slots in the
// leaf's second half take the high nibbles), against the permuted query
// columns.
template <int FMT, int KC>
__device__ __forceinline__ void mma_tile(float acc[2][4][4],
                                         float small[2][4][4], const bf16* qs,
                                         int qstride,
                                         const unsigned char* stage, int k0,
                                         int width, int s0, int cap, int wm,
                                         int wn, int lane) {
  constexpr int NT = terms(FMT);
  const int plane = kTQ * qstride;
  const bf16* qa = qs + (wm * 32) * qstride + k0;
  if constexpr (FMT == kF32) {
    constexpr int kSlab = TcLayout<KC>::kSlab;
    // Lane (g, t) reads slot row wn*32 + nb*8 + g, columns kk + 2t, 2t+1
    // (b0) and kk + 2t+8, 2t+9 (b1).
    const float* rows = reinterpret_cast<const float*>(stage) +
                        (wn * 32 + (lane >> 2)) * kSlab + 2 * (lane & 3);
    auto step = [&](int kk) {
      uint32_t a[3][2][4];  // [query term h, m, l][m-block]
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          tc::load_a(a[t][mb], qa + t * plane + mb * 16 * qstride, qstride,
                     kk, lane);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float* src = rows + nb * 8 * kSlab + kk;
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
    };
    k_steps<KC>(width, step);
  } else if constexpr (FMT == kBF16) {
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
// tile comes in ceil(dp / KC) column stages through a ring of RING
// stages, RING - 1 of them in flight while one is multiplied, one block
// barrier a stage; after a tile's last stage, epilogue(tile, acc, wm, wn,
// lane, rows, scales) with the warp's accumulators (c-index 2h + e of
// [m-block][n-block] is query row g + 8h, slot column 2t + e; for f32
// rows hh plus the five smaller term products) and the tile's staged slot
// rows and scales (in shared memory; with null `fold_*`, not staged). The
// query planes must be written before the call.
template <int FMT, int KC, int RING, class TileOf, class Epilogue>
__device__ __forceinline__ void tc_walk(
    const bf16* qs, int qstride, unsigned char* ring, int stage_bytes,
    const void* __restrict__ leaves, const int* __restrict__ fold_rows,
    const float* __restrict__ fold_scales, int cap, int d, bool vec,
    int tiles, TileOf tile_of, Epilogue epilogue) {
  constexpr int kRow = TcLayout<KC, RING>::row_bytes(FMT);
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
    if (++in_slot == RING) in_slot = 0;
  };
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < stages) copy_next();
    tc::cp_async_commit();
  }
  int tile = 0, kc = 0, slot = 0;
  Tile t = tile_of(0);
  float acc[2][4][4];
  float small[2][4][4];  // f32 rows: the five smaller term products
  for (int s = 0; s < stages; ++s) {
    tc::cp_async_wait<RING - 2>();
    // Stage s has landed for every thread, and every warp is done with
    // stage s - 1, whose ring slot the next copy refills.
    __syncthreads();
    if (s + RING - 1 < stages) copy_next();
    tc::cp_async_commit();
    const unsigned char* st = ring + slot * stage_bytes;
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
    if (t.live) {
      mma_tile<FMT, KC>(acc, small, qs, qstride, st, kc * KC,
                        min(KC, dp - kc * KC), t.s0, cap, wm, wn, lane);
      if (kc == kchunks - 1) {
        if constexpr (FMT == kF32) {
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mb][nb][i] += small[mb][nb][i];
            }
          }
        }
        const int* rows = reinterpret_cast<const int*>(st + kNS * kRow);
        epilogue(t, acc, wm, wn, lane, rows,
                 reinterpret_cast<const float*>(rows + kNS));
      }
    }
    if (++kc == kchunks) {
      kc = 0;
      if (++tile < tiles) t = tile_of(tile);
    }
    if (++slot == RING) slot = 0;
  }
}

// K4, every format. Block b takes group j of leaf block_leaf[b]:
// pairs [bounds[l] + 64 j, ...) of `order` (at most 64), where the leaf's
// groups are the last ceil(pairs / 64) before last[l]; leaf L holds the
// pairs of probes outside [0, L), and blocks past the live groups (leaf
// L + 1) exit. The group's queries against every slot of its leaf.
template <int FMT, int KC, int RING>
__global__ void __launch_bounds__(kTcThreads, FMT == kF32 ? 2 : 3)
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
  const TcLayout<KC, RING> lay(FMT, d);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  unsigned char* ring = smem_tc + 2 * lay.q_elems;
  if (threadIdx.x < kTQ) {
    const int i = threadIdx.x;
    const int qp = i < count ? order[start + i] : -1;
    pair[i] = qp;
    qrow[i] = qp >= 0 ? qp / num_probes : -1;
  }
  __syncthreads();
  stage_queries<NT, is_code(FMT)>(qs, lay.qstride, q, qrow, d);
  const bool even = (cap & 1) == 0;
  tc_walk<FMT, KC, RING>(
      qs, lay.qstride, ring, lay.stage_bytes, leaves, nullptr,
      is_code(FMT) ? scales : nullptr, cap, d, vec != 0,
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
              if constexpr (is_code(FMT)) {
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

// K5, every format: a 64-query x 64-bucket block of one query tile over
// the probes of split blockIdx.z; writes plane blockIdx.z.
template <int FMT, int KC, int RING>
__global__ void __launch_bounds__(kTcThreads, FMT == kF32 ? 2 : 3)
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
  const TcLayout<KC, RING> lay(FMT, d);
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
  stage_queries<NT, is_code(FMT)>(qs, lay.qstride, q, qrow, d);

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
  tc_walk<FMT, KC, RING>(
      qs, lay.qstride, ring, lay.stage_bytes, leaves, leaf_rows,
      is_code(FMT) ? scales : nullptr, cap, d, vec != 0,
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
            const float scale = is_code(FMT) ? sc[c] : 1.f;
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v = acc[mb][nb][2 * h + e];
                if constexpr (is_code(FMT)) v *= scale;
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

// ------------------------------------------------------- K5 int8 on wgmma

constexpr int kI8Threads = 160;      // a consumer warpgroup + a producer warp
constexpr int kI8MaxStages = 8;
constexpr int kI8BarrierBytes = 2 * kI8MaxStages * 8;
constexpr int kI8MaxSpan = 1040;     // most probes a block walks (+ 2)
constexpr int kI8Sentinel = 0x7FFFFFFF;  // the order key of no candidate
constexpr int kI8FoldSlots = kNS + 4;    // scales (and rows) a stage holds

// Groups of B slots of a leaf that reach bucket tile bt (b0 = 64 bt < B).
__host__ __device__ __forceinline__ int tile_groups(int bt, int cap,
                                                    int buckets) {
  return (cap - bt * kNS + buckets - 1) / buckets;
}

// Shared bytes of the int8 body before its ring: the query block (NQ rows
// of dp bf16), barriers and the staged probes' leaves.
__host__ __device__ constexpr size_t i8_fixed_smem(int nq, int dp) {
  return kI8BarrierBytes + static_cast<size_t>(nq) * dp * 2 +
         sizeof(int) * kI8MaxSpan;
}

// K5's int8 body. Block (x, y): query block x of its tile (x = tile *
// qblocks + j), and bucket tile bt with split z of the S * G_bt splits y
// names (G_bt = tile_groups(bt)). The tile's walk is a list of units (p,
// g), its p-th probe and group g of it, p-major; the block walks units
// [U z / S_bt, U (z + 1) / S_bt) of the U = P * G_bt, so every block walks
// about P / S units. A producer warp brings each unit's 64 slot rows
// (contiguous codes) and their scales and rows into a ring of `stages`
// stages: bulk copies where all are 16-byte aligned (`vec`), else its
// lanes' plain copies at a 16-byte row stride. The consumer warpgroup
// holds the query block as wgmma's B (NQ = 16, 32 or 64 columns: no
// empty query row past the tile's own), decodes the slab's codes to bf16
// A fragments in registers, releases the stage, multiplies, and folds
// each slot into its bucket's running (value, key) in the accumulator
// layout (key = p * G + g). Writes plane z of the planes [S * G][Q, B] of
// values and keys; `finalize_int8_kernel` merges them.
template <int NQ>
__global__ void __launch_bounds__(kI8Threads, NQ <= 32 ? 3 : 2)
probed_bucketed_int8_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, const int* __restrict__ leaf_rows,
    const int* __restrict__ probes,
    float* __restrict__ plane_vals, int* __restrict__ plane_keys,
    int query_tile, int num_probes, int num_leaves, int cap, int d,
    int buckets, int splits, int row_stride, int vec, int stages,
    float mask_value) {
  constexpr int R = NQ / 2;
  // The query block first (1024-byte aligned K blocks for the swizzle),
  // then the barriers, the staged probes and the ring.
  extern __shared__ __align__(1024) unsigned char smem_k5[];
  const int dp = (d + 63) / 64 * 64;
  unsigned char* qs = smem_k5;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + NQ * dp * 2);
  uint64_t* empty = full + kI8MaxStages;
  int* span_leaf = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(full) + kI8BarrierBytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(span_leaf + kI8MaxSpan);
  // A stage: the unit's 64 code rows, then its slots' scales and rows
  // (kI8FoldSlots each, from a 16-byte aligned slot at `vec`).
  const int slab_bytes = kNS * row_stride + 2 * 4 * kI8FoldSlots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int qblocks = (query_tile + NQ - 1) / NQ;
  const int tile = blockIdx.x / qblocks;
  const int t0 = (blockIdx.x % qblocks) * NQ;
  // Bucket tile and split of blockIdx.y.
  int bt = 0, rest = blockIdx.y, g_bt = tile_groups(0, cap, buckets);
  while (rest >= splits * g_bt) {
    rest -= splits * g_bt;
    g_bt = tile_groups(++bt, cap, buckets);
  }
  const int z = rest, s_bt = splits * g_bt;
  const int b0 = bt * kNS;
  const int groups = (cap + buckets - 1) / buckets;
  const int64_t units = static_cast<int64_t>(num_probes) * g_bt;
  const int u0 = static_cast<int>(units * z / s_bt);
  const int u1 = static_cast<int>(units * (z + 1) / s_bt);
  const int i0 = u0 / g_bt;
  const int* tile_probes = probes + static_cast<int64_t>(tile) * num_probes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);
    }
    wg::fence_mbar_init();
  }
  if (u1 > u0) {
    for (int i = i0 + threadIdx.x; i <= (u1 - 1) / g_bt; i += kI8Threads) {
      span_leaf[i - i0] = tile_probes[i];
    }
  }
  __syncthreads();

  if (warp == 4) {
    // The producer warp.
    int stage = 0;
    uint32_t phase = 0;
    // Unit u = (probe i, group gg), advanced without a division.
    for (int u = u0, i = i0, gg = u0 - i0 * g_bt; u < u1;
         ++u, gg = gg + 1 < g_bt ? gg + 1 : (++i, 0)) {
      const int leaf = span_leaf[i - i0];
      if (leaf < 0 || leaf >= num_leaves) continue;  // skipped by both
      const int s0 = gg * buckets + b0;
      const int nrows = min(kNS, min(buckets - b0, cap - s0));
      const int64_t first = static_cast<int64_t>(leaf) * cap + s0;
      unsigned char* dst = ring + stage * slab_bytes;
      float* dst_scales = reinterpret_cast<float*>(dst + kNS * row_stride);
      int* dst_rows = reinterpret_cast<int*>(dst_scales + kI8FoldSlots);
      if (vec) {
        if (lane == 0) {
          // Scales and rows from the 16-byte aligned slot at or before
          // `first`, a multiple of 4 of them (cap % 4 == 0: none past the
          // table).
          const int64_t first4 = first & ~static_cast<int64_t>(3);
          const int count = (static_cast<int>(first - first4) + nrows + 3) & ~3;
          wg::mbar_wait(&empty[stage], phase ^ 1);
          wg::mbar_expect_tx(&full[stage], nrows * d + 8 * count);
          wg::bulk_load(dst, codes + first * d, nrows * d, &full[stage]);
          wg::bulk_load(dst_scales, scales + first4, 4 * count, &full[stage]);
          wg::bulk_load(dst_rows, leaf_rows + first4, 4 * count,
                        &full[stage]);
        }
      } else {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        for (int e = lane; e < nrows * d; e += 32) {
          const int r = e / d;
          dst[r * row_stride + e - r * d] = codes[first * d + e];
        }
        for (int e = lane; e < nrows; e += 32) {
          dst_scales[e] = scales[first + e];
          dst_rows[e] = leaf_rows[first + e];
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(&full[stage]);
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // The query block as B: rows t0 .. t0 + NQ - 1 of the tile, rounded
    // to bf16, features in `wg::code_k` order, zero past the tile and D.
    const int64_t q0 = static_cast<int64_t>(tile) * query_tile + t0;
    for (int idx = threadIdx.x; idx < NQ * dp; idx += 128) {
      const int r = idx / dp;
      const int c = idx - r * dp;
      const float x = t0 + r < query_tile && c < d ? q[(q0 + r) * d + c] : 0.f;
      *reinterpret_cast<bf16*>(qs + wg::b_offset<NQ>(r, wg::code_k(c))) =
          __float2bfloat16(x);
    }
    wg::fence_proxy_async();
    wg::named_sync(1, 128);

    const int ra = warp * 16 + g;  // the thread's slot rows ra, ra + 8
    const uint32_t b_base = tc::smem_addr(qs);
    float acc[R], best[R];
    int best_key[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      best[i] = mask_value;
      best_key[i] = kI8Sentinel;
    }
    const int kblocks = dp / 64;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = u0, i = i0, gg = u0 - i0 * g_bt; u < u1;
         ++u, gg = gg + 1 < g_bt ? gg + 1 : (++i, 0)) {
      const int leaf = span_leaf[i - i0];
      if (leaf < 0 || leaf >= num_leaves) continue;
      const int key = i * groups + gg;
      const int s0 = gg * buckets + b0;
      const int nrows = min(kNS, min(buckets - b0, cap - s0));
      wg::mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * slab_bytes;
      // The slots' scales and rows; a slot past the tile, or padding (row
      // -1), never wins.
      const int64_t first = static_cast<int64_t>(leaf) * cap + s0;
      const int at = (vec ? static_cast<int>(first & 3) : 0) + ra;
      const float* st_scales =
          reinterpret_cast<const float*>(st + kNS * row_stride);
      const int* st_rows =
          reinterpret_cast<const int*>(st_scales + kI8FoldSlots);
      const bool ok_a = ra < nrows && st_rows[at] >= 0;
      const bool ok_b = ra + 8 < nrows && st_rows[at + 8] >= 0;
      const float sa = ok_a ? st_scales[at] : 0.f;
      const float sb = ok_b ? st_scales[at + 8] : 0.f;
      // -inf for such a slot: its score never beats mask_value.
      const float bias_a = ok_a ? 0.f : -CUDART_INF_F;
      const float bias_b = ok_b ? 0.f : -CUDART_INF_F;
      const unsigned char* lo = st + ra * row_stride + 16 * t;
      // Two 64-feature blocks (eight k-steps) in flight a wait.
      for (int kb = 0; kb < kblocks; kb += 2) {
        const bool pair = kb + 1 < kblocks;
        uint32_t a[2][4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 0 || pair) {
            const unsigned char* src = lo + (kb + h) * 64;
            wg::decode_int8(*reinterpret_cast<const uint4*>(src),
                            *reinterpret_cast<const uint4*>(
                                src + 8 * row_stride),
                            a[h]);
          }
        }
        if (kb + 2 >= kblocks) {
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(&empty[stage]);
        }
        wg::fence();
        wg::hold(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && !pair) break;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            wg::Mma<NQ>::run(acc, a[h][s],
                             wg::b_desc<NQ>(b_base, (kb + h) * 4 + s),
                             kb + h + s > 0);
          }
        }
        wg::commit();
        wg::hold(acc);
        wg::wait<0>();
        wg::hold(acc);
      }
      // The walk visits keys in rising order: a strictly greater score
      // replaces, so the lowest key of a maximum stays.
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool upper = (i & 2) != 0;
        const float v =
            fmaf(acc[i], upper ? sb : sa, upper ? bias_b : bias_a);
        if (v > best[i]) {
          best[i] = v;
          best_key[i] = key;
        }
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int64_t qn = static_cast<int64_t>(gridDim.x / qblocks) * query_tile;
    const int64_t base = static_cast<int64_t>(z) * qn * buckets;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int tq = t0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int b = b0 + ra + ((i & 2) ? 8 : 0);
      if (tq < query_tile && b < buckets) {
        const int64_t o = base + (static_cast<int64_t>(tile) * query_tile +
                                  tq) * buckets + b;
        plane_vals[o] = best[i];
        plane_keys[o] = best_key[i];
      }
    }
  }
}

// Merges the int8 body's planes into K5's result: bucket b of query i
// takes the best (value, lowest key) over the S * G_bt planes of its
// bucket tile, and its key's row (-1 where no candidate beat mask_value).
__global__ void finalize_int8_kernel(
    const float* __restrict__ plane_vals, const int* __restrict__ plane_keys,
    const int* __restrict__ leaf_rows, const int* __restrict__ probes,
    float* __restrict__ vals, int* __restrict__ rows, int64_t qn,
    int query_tile, int num_probes, int cap, int buckets, int splits,
    float mask_value) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= qn * buckets) return;
  const int b = static_cast<int>(idx % buckets);
  const int64_t qi = idx / buckets;
  const int planes = splits * tile_groups(b / kNS, cap, buckets);
  const int64_t stride = qn * buckets;
  float v = plane_vals[idx];
  int key = plane_keys[idx];
  for (int z = 1; z < planes; ++z) {
    const float x = plane_vals[z * stride + idx];
    const int k = plane_keys[z * stride + idx];
    if (x > v || (x == v && k < key)) {
      v = x;
      key = k;
    }
  }
  int row = -1;
  if (v > mask_value && key != kI8Sentinel) {
    const int groups = (cap + buckets - 1) / buckets;
    const int leaf = probes[(qi / query_tile) * num_probes + key / groups];
    row = leaf_rows[static_cast<int64_t>(leaf) * cap +
                    (key % groups) * buckets + b];
  }
  vals[idx] = v;
  rows[idx] = row;
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A body's stage width KC (feature columns) and ring depth RING.
template <int KC, int RING>
struct Stages {
  static constexpr int kc = KC;
  static constexpr int ring = RING;
};

// Returns launch(Stages<KC, RING>{}) for the block's stages. f32 rows:
// KC = 64, 109 KB at D = 128, two blocks an SM (KC = 128 takes 158 KB,
// one block an SM, and was 23 % slower on the H100: PERF.md, section 6),
// or, where that passes kMaxSmem (D > 432: three query planes of 64 x
// (D + 8) bf16), KC = 32 in a ring of two. The others: KC = 128 within
// kWideSmem, else 64.
template <int FMT, class Launch>
cudaError_t with_stages(int d, Launch launch) {
  if constexpr (FMT == kF32) {
    if (TcLayout<64>(FMT, d).bytes() > kMaxSmem) {
      return launch(Stages<32, 2>{});
    }
  } else {
    if (TcLayout<128>(FMT, d).bytes() <= kWideSmem) {
      return launch(Stages<128, kRing>{});
    }
  }
  return launch(Stages<64, kRing>{});
}

template <int FMT, int KC, int RING>
cudaError_t launch_leaf_tc(const float* q, const void* leaves,
                           const float* scales, const int* order,
                           const int* bounds, const int* last,
                           const int* block_leaf, int blocks, float* out,
                           int num_probes, int num_leaves, int cap, int d,
                           int vec, float mask_value, cudaStream_t stream) {
  auto kernel = probed_leaf_tc_kernel<FMT, KC, RING>;
  const size_t smem = TcLayout<KC, RING>(FMT, d).bytes();
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
  return with_stages<FMT>(d, [&](auto st) {
    using S = decltype(st);
    return launch_leaf_tc<FMT, S::kc, S::ring>(
        q, leaves, scales, order, bounds, last, block_leaf, blocks, out,
        num_probes, num_leaves, cap, d, vec, mask_value, stream);
  });
}

template <int FMT, int KC, int RING>
cudaError_t launch_bucketed_tc(const float* q, const void* leaves,
                               const float* scales, const int* leaf_rows,
                               const int* probes, float* vals, int* rows,
                               dim3 grid, int query_tile, int num_probes,
                               int num_leaves, int cap, int d, int buckets,
                               int vec, float mask_value,
                               cudaStream_t stream) {
  auto kernel = probed_bucketed_tc_kernel<FMT, KC, RING>;
  const size_t smem = TcLayout<KC, RING>(FMT, d).bytes();
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
  return with_stages<FMT>(d, [&](auto st) {
    using S = decltype(st);
    return launch_bucketed_tc<FMT, S::kc, S::ring>(
        q, leaves, scales, leaf_rows, probes, vals, rows, grid, query_tile,
        num_probes, num_leaves, cap, d, buckets, vec, mask_value, stream);
  });
}

template <int NQ>
cudaError_t launch_int8_nq(const float* q, const int8_t* codes,
                           const float* scales, const int* leaf_rows,
                           const int* probes, float* vals,
                           int* rows, float* plane_vals, int* plane_keys,
                           int tiles, int query_tile, int num_probes,
                           int num_leaves, int cap, int d, int buckets,
                           int splits, int vec, float mask_value,
                           cudaStream_t stream) {
  constexpr int kPerSm = NQ <= 32 ? 3 : 2;
  const int dp = (d + 63) / 64 * 64;
  // Bulk copies need 16-byte aligned rows, scales and slot rows.
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  vec = vec && cap % 4 == 0 && aligned(scales) && aligned(leaf_rows);
  const int row_stride = vec ? d : (d + 15) / 16 * 16;
  const size_t fixed = i8_fixed_smem(NQ, dp) + 64;  // + the last row's over-read
  const size_t slab =
      static_cast<size_t>(kNS) * row_stride + 2 * 4 * kI8FoldSlots;
  // Stages that let kPerSm blocks share an SM's 228 KB (1 KB each
  // reserved), at least two.
  const size_t budget = 233472 / kPerSm - 1024;
  int stages = budget > fixed + 2 * slab
                   ? static_cast<int>((budget - fixed) / slab)
                   : 2;
  stages = stages < kI8MaxStages ? stages : kI8MaxStages;
  const size_t smem = fixed + stages * slab;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = probed_bucketed_int8_kernel<NQ>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // All of the SM's 228 KB as shared memory, so kPerSm blocks fit.
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int y = 0;
  for (int bt = 0; bt * kNS < buckets; ++bt) {
    y += splits * tile_groups(bt, cap, buckets);
  }
  const dim3 grid(tiles * ((query_tile + NQ - 1) / NQ), y);
  kernel<<<grid, kI8Threads, smem, stream>>>(
      q, codes, scales, leaf_rows, probes, plane_vals, plane_keys,
      query_tile, num_probes, num_leaves, cap, d, buckets, splits,
      row_stride, vec, stages, mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t qn = static_cast<int64_t>(tiles) * query_tile;
  const int64_t cells = qn * buckets;
  finalize_int8_kernel<<<static_cast<unsigned>((cells + 255) / 256), 256, 0,
                         stream>>>(plane_vals, plane_keys, leaf_rows, probes,
                                   vals, rows, qn, query_tile, num_probes,
                                   cap, buckets, splits, mask_value);
  return cudaGetLastError();
}

// K5 int8: query blocks of 16, 32 or 64 queries (the smallest that holds
// the tile, else 64).
cudaError_t launch_bucketed_int8(const float* q, const void* leaves,
                                 const float* scales, const int* leaf_rows,
                                 const int* probes,
                                 float* vals, int* rows, float* plane_vals,
                                 int* plane_keys, int tiles, int query_tile,
                                 int num_probes, int num_leaves, int cap,
                                 int d, int buckets, int splits, int vec,
                                 float mask_value, cudaStream_t stream) {
  const int8_t* codes = static_cast<const int8_t*>(leaves);
#define RTPU_K5_INT8(NQ)                                                      \
  launch_int8_nq<NQ>(q, codes, scales, leaf_rows, probes, vals, rows,        \
                     plane_vals, plane_keys, tiles, query_tile, num_probes,  \
                     num_leaves, cap, d, buckets, splits, vec, mask_value,   \
                     stream)
  if (query_tile <= 16) return RTPU_K5_INT8(16);
  if (query_tile <= 32) return RTPU_K5_INT8(32);
  return RTPU_K5_INT8(64);
#undef RTPU_K5_INT8
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
#define RTPU_LAUNCH_LEAF(F)                                                  \
  launch_leaf_format<F>(q, leaves, scales, order, bounds, last, block_leaf,  \
                        blocks, out, num_probes, num_leaves, cap, d, vec,    \
                        mask_value, s)
    case kF32: return RTPU_LAUNCH_LEAF(kF32);
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
// f32, bf16, int4: splits (1 .. max(1, num_probes)) blocks share each
// block's probe walk, split z over probes [P*z/S, P*(z+1)/S); with
// splits > 1, split_vals / split_rows hold splits * Q * B entries and a
// second kernel merges them. int8: splits S (1 .. num_probes), a bucket
// tile of G_bt groups a leaf split S * G_bt ways, and split_vals /
// split_rows always hold S * ceil(cap / B) planes of Q * B (values and
// order keys).
int probed_bucketed_scores_launch(int format, const float* q,
                                  const void* leaves, const float* scales,
                                  const int* leaf_rows, const int* probes,
                                  float* vals, int* rows, int tiles, int query_tile, int num_probes,
                                  int num_leaves, int cap, int d, int buckets,
                                  int vec, int splits, float* split_vals,
                                  int* split_rows, float mask_value,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (format == kInt8) {
    if (d <= 0 || d > kMaxDim || buckets <= 0 || buckets > cap ||
        num_probes <= 0 || splits < 1 || splits > num_probes ||
        (num_probes + splits - 1) / splits + 2 > kI8MaxSpan ||
        split_vals == nullptr || split_rows == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_bucketed_int8(
        q, leaves, scales, leaf_rows, probes, vals, rows, split_vals,
        split_rows, tiles, query_tile, num_probes, num_leaves, cap, d,
        buckets, splits, vec, mask_value, s));
  }
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
#define RTPU_LAUNCH_BUCKETED(F)                                              \
  launch_bucketed_format<F>(q, leaves, scales, leaf_rows, probes, v, r,     \
                            grid, query_tile, num_probes, num_leaves, cap,  \
                            d, buckets, vec, mask_value, s)
    case kF32: err = RTPU_LAUNCH_BUCKETED(kF32); break;
    case kBF16: err = RTPU_LAUNCH_BUCKETED(kBF16); break;
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
