// Table-batched pooled lookup (the sum combiner) for Hopper (sm_90a).
//
// Replaces the TPU kernel: none. The JAX package pools a multi-hot feature
// with XLA: a gather of the bag's rows, then the combiner's sums
// (recommenders_tpu/embedding/embedding.py, combine). The port did the
// same in eager PyTorch, one launch a bag position and a feature (~400
// launches for a DLRM-DCNv2 query of 26 features and 214 ids a pair), in
// the table's dtype. This kernel pools every feature of a request in one
// launch and sums in f32 whatever the table stores.
//
// What it computes. The same function as the plain twin
// recommenders_tpu_torch/ops/pooled_lookup.py::pooled_lookup_reference.
// Input: up to 64 features, each a table [rows, D] (f32 or fp16, all of
// one dtype and D in a launch), its ids [S, bag] (int32 or int64, PAD_ID
// = -1 for padding), optional f32 weights [S, bag], and a first output
// column. Output: out[p, col + e] = sum over j in bag order, from zero, of
// w[p, j] * f32(table[id[p, j], e]), skipping PAD_ID positions; a negative
// id other than PAD_ID reads row 0 (as the port's gather does), an id at
// or past `rows` is skipped (the twin's gather raises on it). Each add is
// one IEEE f32 add (__fadd_rn) and each weight one f32 multiply
// (__fmul_rn), never fused, so the card's sums are the twin's bit for bit.
//
// What bounds it on the H100. Bytes and latency: each id read once, each
// bag's rows gathered from anywhere in tables of up to 40M rows (for
// DLRM-DCNv2 at a mean of 400 pairs: 85,600 rows of 256 B, at most 21.9
// MB, fewer where Zipf-hot rows repeat and hit L2), and [S, F, D] f32
// written once. No arithmetic worth counting.
//
// What the design does about it. A group of G lanes owns one bag (one
// pair and one feature): a row of D values is G * VPL vectors of 16
// bytes, each lane loading VPL of them (fp16 at D = 128: 16 lanes, one
// vector each, two bags a warp). A group first loads the ids of its next
// 8 / VPL positions, then issues all their row loads at once, then adds
// them in order, so 8 vectors a lane are in flight while the sums keep
// their fixed order. Units run feature-major with the features ordered
// by bag length, longest first, so the blocks of the longest bags start
// first and neighbouring groups share a bag length. The output goes
// straight to its columns of a wider row (x0 of a DCN), 16 bytes a store.
// Feature parameters travel in the launch's parameter block
// (__grid_constant__): no device copy of the plan.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFeatures = 64;
constexpr int kThreads = 256;
constexpr long long kPad = -1;

struct Feature {
  const void* table;
  const void* ids;
  const float* weights;  // null: every weight 1
  long long rows;
  int bag;
  int col;
};

struct Plan {
  Feature f[kMaxFeatures];
  float* out;
  long long stride;  // out's row stride, in floats
  int pairs;
  int count;
  int ids64;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ long long load_id(const void* ids, long long i,
                                             int ids64) {
  if (ids64) return __ldg(static_cast<const long long*>(ids) + i);
  return static_cast<long long>(__ldg(static_cast<const int*>(ids) + i));
}

// T: the table's dtype; G lanes a bag; VPL 16-byte vectors a lane of each
// row (a row is G * VPL vectors).
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kThreads)
pooled_lookup_kernel(const __grid_constant__ Plan plan) {
  constexpr int E = 16 / sizeof(T);  // values a vector
  constexpr int kRows = 8 / VPL;     // positions a group keeps in flight
  const long long unit =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (unit >= static_cast<long long>(plan.count) * plan.pairs) return;
  const int lane = threadIdx.x % G;
  const int fi = static_cast<int>(unit / plan.pairs);
  const long long pair = unit - static_cast<long long>(fi) * plan.pairs;
  const Feature& f = plan.f[fi];
  const uint4* table = static_cast<const uint4*>(f.table);
  const long long first = pair * f.bag;

  float acc[VPL][E];
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[q][e] = 0.f;
  }
  for (int j0 = 0; j0 < f.bag; j0 += kRows) {
    long long row[kRows];
    float w[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = j0 + k;
      const bool in = j < f.bag;
      row[k] = in ? load_id(f.ids, first + j, plan.ids64) : kPad;
      w[k] = (in && f.weights != nullptr) ? __ldg(f.weights + first + j)
                                          : 1.f;
    }
    uint4 v[kRows][VPL];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const bool live = row[k] != kPad && row[k] < f.rows;
      const long long r = row[k] < 0 ? 0 : row[k];
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        v[k][q] = live ? __ldg(table + r * (G * VPL) + q * G + lane)
                       : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (row[k] == kPad || row[k] >= f.rows) continue;
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const T* vals = reinterpret_cast<const T*>(&v[k][q]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float x = to_f32(vals[e]);
          if (f.weights != nullptr) x = __fmul_rn(w[k], x);
          acc[q][e] = __fadd_rn(acc[q][e], x);
        }
      }
    }
  }
  float* out = plan.out + pair * plan.stride + f.col;
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
    float4* dst = reinterpret_cast<float4*>(out + (q * G + lane) * E);
#pragma unroll
    for (int h = 0; h < E / 4; ++h) {
      dst[h] = make_float4(acc[q][4 * h], acc[q][4 * h + 1],
                           acc[q][4 * h + 2], acc[q][4 * h + 3]);
    }
  }
}

template <typename T, int G, int VPL>
int launch(const Plan& plan, cudaStream_t stream) {
  const long long threads =
      static_cast<long long>(plan.count) * plan.pairs * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pooled_lookup_kernel<T, G, VPL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(plan);
  return static_cast<int>(cudaGetLastError());
}

// A row of `vecs` 16-byte vectors: G = min(vecs, 32) lanes, vecs / G each.
template <typename T>
int launch_width(int vecs, const Plan& plan, cudaStream_t stream) {
  switch (vecs) {
    case 1: return launch<T, 1, 1>(plan, stream);
    case 2: return launch<T, 2, 1>(plan, stream);
    case 4: return launch<T, 4, 1>(plan, stream);
    case 8: return launch<T, 8, 1>(plan, stream);
    case 16: return launch<T, 16, 1>(plan, stream);
    case 32: return launch<T, 32, 1>(plan, stream);
    case 64: return launch<T, 32, 2>(plan, stream);
    case 128: return launch<T, 32, 4>(plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One launch over `count` features (1 to 64), in the order given. format:
// 0 f32 tables, 1 fp16; vecs: 16-byte vectors a row (1, 2, 4, ... 128);
// tables / ids / weights / rows / bags / cols: each feature's table, ids
// [pairs, bag] (int64 where ids64, else int32), weights (null for none),
// table rows, bag length and first output column; out: f32 with row
// stride `stride`. Every table, row, out row and column 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
int pooled_lookup_launch(int format, int vecs, int count,
                         const void* const* tables, const void* const* ids,
                         const float* const* weights, const long long* rows,
                         const int* bags, const int* cols, float* out,
                         long long stride, int pairs, int ids64,
                         void* stream) {
  if (count < 1 || count > kMaxFeatures || pairs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan{};
  for (int i = 0; i < count; ++i) {
    plan.f[i] = Feature{tables[i], ids[i], weights[i], rows[i], bags[i],
                        cols[i]};
  }
  plan.out = out;
  plan.stride = stride;
  plan.pairs = pairs;
  plan.count = count;
  plan.ids64 = ids64;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (format == 1) return launch_width<__half>(vecs, plan, s);
  if (format == 0) return launch_width<float>(vecs, plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pooled_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
