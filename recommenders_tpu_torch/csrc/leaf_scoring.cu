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
// What bounds it on the H100. K4 at a served shape (Q=128 queries, P=40
// probes of cap=768 int8 rows, D=128) reads Q*P*cap*D = 0.5 GB of leaves
// for 2*Q*P*cap*D = 1 GFLOP: 2 FLOP a byte, far below the card's ~300, so
// it is bound by memory. K5 shares each leaf among a tile of T queries:
// at T=64, P=256, cap=1280, D=128 and Q=1024 it does 86 GFLOP on 0.7 GB
// of int8 leaves, 120 FLOP a byte, so on CUDA cores (67 TFLOP/s f32) it is
// bound by arithmetic.
//
// What the design does about it. The TPU ran its grid (query, probe) in
// order and carried K5's running argmax in VMEM from one probe to the
// next. Hopper runs blocks in no order. K4: one block per (query, probe),
// the query in shared memory, one warp per leaf row at a time (int4: per
// packed row, two slots), neighbouring lanes on neighbouring columns and a
// warp shuffle sum; only the probed leaf is read, never a gather. K5: one
// block owns a 64-query x 64-bucket tile of one query tile's output and
// walks every probe and group itself, with its running max/argmax in
// registers (no cross-block reduction, no atomics); the query tile sits in
// shared memory, each group's 64-slot slab is staged through shared memory
// 32 columns at a time, decoded to f32 on the way in, and each thread
// accumulates 4 queries x 4 slots with f32 FMAs on the CUDA cores, as the
// bucketed corpus kernel (bucketed_scores.cu) does. Tensor cores (wgmma)
// and a TMA pipeline are left for a later change. Any D <= 512 and any cap
// are taken; ragged edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Format { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

constexpr int kMaxDim = 512;
constexpr int kLeafThreads = 256;  // K4: 8 warps a block

constexpr int kTQ = 64;            // K5: queries per block
constexpr int kTB = 64;            // K5: buckets per block
constexpr int kKC = 32;            // K5: feature columns per stage
constexpr int kCStride = kTB + 1;  // padded slab row (no bank conflicts)
constexpr int kThreads = 256;      // K5: 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));  // round to nearest even
}

__device__ __forceinline__ int low_nibble(int p) {
  return static_cast<int>(static_cast<unsigned>(p) << 28) >> 28;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Value of stored element i (rows formats and int8).
template <int FMT>
__device__ __forceinline__ float stored(const void* __restrict__ leaves,
                                        int64_t i) {
  if constexpr (FMT == kF32) {
    return static_cast<const float*>(leaves)[i];
  } else if constexpr (FMT == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(leaves)[i]);
  } else {
    return static_cast<float>(static_cast<const int8_t*>(leaves)[i]);
  }
}

// ---------------------------------------------------------------- K4 ----

template <int FMT>
__global__ void __launch_bounds__(kLeafThreads)
probed_leaf_kernel(const float* __restrict__ q,
                   const void* __restrict__ leaves,
                   const float* __restrict__ scales,
                   const int* __restrict__ probes, float* __restrict__ out,
                   int num_probes, int num_leaves, int cap, int d,
                   float mask_value) {
  __shared__ float qs[kMaxDim];
  const int64_t qp = blockIdx.x;  // query * num_probes + probe
  const int64_t qi = qp / num_probes;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float v = q[qi * d + c];
    qs[c] = (FMT == kInt8 || FMT == kInt4) ? bf16_round(v) : v;
  }
  __syncthreads();
  float* o = out + qp * cap;
  const int leaf = probes[qp];
  if (leaf < 0 || leaf >= num_leaves) {
    for (int s = threadIdx.x; s < cap; s += blockDim.x) o[s] = mask_value;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float* sc =
      scales == nullptr ? nullptr : scales + static_cast<int64_t>(leaf) * cap;
  if constexpr (FMT == kInt4) {
    const int half = cap / 2;
    const int8_t* base = static_cast<const int8_t*>(leaves) +
                         static_cast<int64_t>(leaf) * half * d;
    for (int r = warp; r < half; r += warps) {
      const int8_t* row = base + static_cast<int64_t>(r) * d;
      float lo = 0.f, hi = 0.f;
      for (int c = lane; c < d; c += 32) {
        const int p = row[c];
        lo = fmaf(qs[c], static_cast<float>(low_nibble(p)), lo);
        hi = fmaf(qs[c], static_cast<float>(p >> 4), hi);
      }
      lo = warp_sum(lo);
      hi = warp_sum(hi);
      if (lane == 0) {
        o[r] = lo * sc[r];
        o[r + half] = hi * sc[r + half];
      }
    }
  } else {
    const int64_t base = static_cast<int64_t>(leaf) * cap * d;
    for (int r = warp; r < cap; r += warps) {
      const int64_t row = base + static_cast<int64_t>(r) * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32) {
        acc = fmaf(qs[c], stored<FMT>(leaves, row + c), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) o[r] = FMT == kInt8 ? acc * sc[r] : acc;
    }
  }
}

// ---------------------------------------------------------------- K5 ----

// Loads columns [col, col + 8) of stored row `row` (a packed row for int4,
// whose `high` nibble is taken) as f32; columns >= d read as 0. `vec`:
// d % 8 == 0 and the table is 16-byte aligned, so one vector load serves.
template <int FMT>
__device__ __forceinline__ void load8(const void* __restrict__ leaves,
                                      int64_t row, int d, int col, bool high,
                                      bool vec, float out[8]) {
  const int64_t off = row * d + col;
  if constexpr (FMT == kF32) {
    const float* p = static_cast<const float*>(leaves) + off;
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
      out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = col + j < d ? p[j] : 0.f;
    }
  } else if constexpr (FMT == kBF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(leaves) + off;
    if (vec) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[j] = col + j < d ? __bfloat162float(p[j]) : 0.f;
      }
    }
  } else {
    const int8_t* p = static_cast<const int8_t*>(leaves) + off;
    int b[8];
    if (vec) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const int8_t* v = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = v[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = col + j < d ? p[j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int code = b[j];
      if constexpr (FMT == kInt4) code = high ? (code >> 4) : low_nibble(code);
      out[j] = static_cast<float>(code);
    }
  }
}

template <int FMT>
__global__ void __launch_bounds__(kThreads)
probed_bucketed_kernel(const float* __restrict__ q,
                       const void* __restrict__ leaves,
                       const float* __restrict__ scales,
                       const int* __restrict__ leaf_rows,
                       const int* __restrict__ probes,
                       float* __restrict__ vals, int* __restrict__ rows_out,
                       int query_tile, int num_probes, int num_leaves,
                       int cap, int d, int buckets, int vec,
                       float mask_value) {
  constexpr bool kQuantized = FMT == kInt8 || FMT == kInt4;
  extern __shared__ __align__(16) float smem[];
  const int dpad = (d + kKC - 1) / kKC * kKC;
  float* qs = smem;                                  // [dpad][kTQ], transposed
  float* cs = smem + static_cast<size_t>(dpad) * kTQ;  // [kKC][kCStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // buckets b0 + tx + 16*j
  const int ty = tid / 16;  // tile members t0 + 4*ty + i
  const int qblocks = (query_tile + kTQ - 1) / kTQ;
  const int tile = blockIdx.y / qblocks;
  const int t0 = (blockIdx.y % qblocks) * kTQ;
  const int b0 = blockIdx.x * kTB;
  const int64_t q0 = static_cast<int64_t>(tile) * query_tile;

  for (int idx = tid; idx < kTQ * dpad; idx += kThreads) {
    const int qi = idx / dpad;
    const int k = idx - qi * dpad;
    float v = 0.f;
    if (t0 + qi < query_tile && k < d) {
      v = q[(q0 + t0 + qi) * d + k];
      if (kQuantized) v = bf16_round(v);
    }
    qs[k * kTQ + qi] = v;
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

  const int load_slot = tid / 4;       // slot of the slab this thread stages
  const int load_col = (tid % 4) * 8;  // and its 8 columns of each stage
  const int groups = (cap + buckets - 1) / buckets;
  const int half = cap / 2;

  for (int p = 0; p < num_probes; ++p) {
    const int leaf = probes[static_cast<int64_t>(tile) * num_probes + p];
    if (leaf < 0 || leaf >= num_leaves) continue;  // uniform in the block
    for (int g = 0; g < groups; ++g) {
      if (g * buckets + b0 >= cap) break;  // uniform: nothing of this slice
      const int ls = g * buckets + b0 + load_slot;
      const bool load_ok = b0 + load_slot < buckets && ls < cap;
      bool high = false;
      int64_t row = static_cast<int64_t>(leaf) * cap + ls;
      if constexpr (FMT == kInt4) {
        high = ls >= half;
        row = static_cast<int64_t>(leaf) * half + (high ? ls - half : ls);
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int k0 = 0; k0 < dpad; k0 += kKC) {
        float v[8];
        if (load_ok && k0 + load_col < d) {
          load8<FMT>(leaves, row, d, k0 + load_col, high, vec != 0, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        __syncthreads();  // The previous stage is consumed; qs is written.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cs[(load_col + j) * kCStride + load_slot] = v[j];
        }
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
      // Fold group g of probe p into the running per-bucket max/argmax.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = b0 + tx + 16 * j;
        const int s = g * buckets + b;
        if (b >= buckets || s >= cap) continue;
        const int64_t li = static_cast<int64_t>(leaf) * cap + s;
        const int r = __ldg(leaf_rows + li);
        if (r < 0) continue;  // padding scores MIN_FLOAT: never replaces
        const float scale = kQuantized ? __ldg(scales + li) : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float score = kQuantized ? acc[i][j] * scale : acc[i][j];
          if (score > best[i][j]) {
            best[i][j] = score;
            best_row[i][j] = r;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (t < query_tile && b < buckets) {
        const int64_t o = (q0 + t) * buckets + b;
        vals[o] = best[i][j];
        rows_out[o] = best_row[i][j];
      }
    }
  }
}

template <int FMT>
cudaError_t launch_leaf(const float* q, const void* leaves,
                        const float* scales, const int* probes, float* out,
                        int num_q, int num_probes, int num_leaves, int cap,
                        int d, float mask_value, cudaStream_t stream) {
  if (d > kMaxDim) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(num_q) * num_probes;
  probed_leaf_kernel<FMT><<<blocks, kLeafThreads, 0, stream>>>(
      q, leaves, scales, probes, out, num_probes, num_leaves, cap, d,
      mask_value);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_bucketed(const float* q, const void* leaves,
                            const float* scales, const int* leaf_rows,
                            const int* probes, float* vals, int* rows,
                            int tiles, int query_tile, int num_probes,
                            int num_leaves, int cap, int d, int buckets,
                            int vec, float mask_value, cudaStream_t stream) {
  if (d > kMaxDim) return cudaErrorInvalidValue;
  auto kernel = probed_bucketed_kernel<FMT>;
  const int dpad = (d + kKC - 1) / kKC * kKC;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(dpad) * kTQ + kKC * kCStride);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((buckets + kTB - 1) / kTB,
                  tiles * ((query_tile + kTQ - 1) / kTQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      q, leaves, scales, leaf_rows, probes, vals, rows, query_tile,
      num_probes, num_leaves, cap, d, buckets, vec, mask_value);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// format: 0 = f32 rows, 1 = bf16 rows, 2 = int8 codes, 3 = packed int4.
// q is f32 [num_q, d]; probes int32 [num_q, num_probes]; out f32
// [num_q, num_probes * cap]; cap is the logical slot count of a leaf.
// Returns the cudaError_t of the launch (0 on success).
int probed_leaf_scores_launch(int format, const float* q, const void* leaves,
                              const float* scales, const int* probes,
                              float* out, int num_q, int num_probes,
                              int num_leaves, int cap, int d,
                              float mask_value, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (format) {
    case kF32:
      return launch_leaf<kF32>(q, leaves, scales, probes, out, num_q,
                               num_probes, num_leaves, cap, d, mask_value, s);
    case kBF16:
      return launch_leaf<kBF16>(q, leaves, scales, probes, out, num_q,
                                num_probes, num_leaves, cap, d, mask_value, s);
    case kInt8:
      return launch_leaf<kInt8>(q, leaves, scales, probes, out, num_q,
                                num_probes, num_leaves, cap, d, mask_value, s);
    case kInt4:
      return launch_leaf<kInt4>(q, leaves, scales, probes, out, num_q,
                                num_probes, num_leaves, cap, d, mask_value, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q is f32 [tiles * query_tile, d]; probes int32 [tiles, num_probes];
// leaf_rows int32 [num_leaves, cap]; vals f32 and rows int32
// [tiles * query_tile, buckets]. vec: d % 8 == 0 and 16-byte aligned leaves.
int probed_bucketed_scores_launch(int format, const float* q,
                                  const void* leaves, const float* scales,
                                  const int* leaf_rows, const int* probes,
                                  float* vals, int* rows, int tiles,
                                  int query_tile, int num_probes,
                                  int num_leaves, int cap, int d, int buckets,
                                  int vec, float mask_value, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTPU_LAUNCH_BUCKETED(F)                                              \
  launch_bucketed<F>(q, leaves, scales, leaf_rows, probes, vals, rows,       \
                     tiles, query_tile, num_probes, num_leaves, cap, d,      \
                     buckets, vec, mask_value, s)
  switch (format) {
    case kF32: return RTPU_LAUNCH_BUCKETED(kF32);
    case kBF16: return RTPU_LAUNCH_BUCKETED(kBF16);
    case kInt8: return RTPU_LAUNCH_BUCKETED(kInt8);
    case kInt4: return RTPU_LAUNCH_BUCKETED(kInt4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RTPU_LAUNCH_BUCKETED
}

const char* leaf_scoring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
