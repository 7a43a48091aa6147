// Row-sparse optimizer update over id-sorted gradients, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel K1:
// recommenders_tpu/ops/sparse_apply.py::sorted_block_apply (:330,
// pallas_call :612) and its Pallas body _kernel (:134).
//
// What it computes. The same function as the plain twin
// recommenders_tpu_torch/ops/sparse_apply.py::sorted_block_apply_reference.
// Input: states (the table [V, D] first, then up to two slot planes of
// width D or 1; each f32 or bf16), sorted_ids [n] int32 ascending with
// padding (any id outside [0, V)) never inside a run of real ids, grads
// [n, D] f32 aligned with the ids, the rule's runtime scalars [k] f32 on
// the device (lr, and Adam's 1-b1^t, 1-b2^t), the rule's constants by
// value, and an optional stochastic-rounding seed. For every run of
// equal ids (one touched row) it
//   - sums the run's grads in f32, in sorted order, starting from 0;
//   - counts the run's entries;
//   - loads the row of every state as f32, applies the rule (sgd,
//     adagrad, rowwise_adagrad, adam or ftrl; every rule is the identity
//     for count == 0, and adam/ftrl mask with count > 0), and writes the
//     row back, bf16 planes with stochastic rounding when a seed is given
//     and round-to-nearest-even otherwise.
// Rows that no id touches are never read or written. The states update
// in place.
//
// Stochastic rounding uses the reference twin's counter hash
// (sparse_apply.py:676-692): position = row * D + col with D the table's
// width for every plane, stream = the state's index. The bits depend only
// on (seed, row, col, state), so kernel and twin round identically.
//
// Arithmetic. Every rule step is one IEEE-rounded f32 operation
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs),
// in the twin's order, so sgd, adagrad and adam give the twin's bits.
// rowwise_adagrad's row mean is a warp tree sum (another order than the
// twin's reduction) and ftrl's powf differs from the host pow by an ulp
// at most; the tests bound those.
//
// What bounds it on the H100. At the training step's shape (V = 65,536
// or 131,072 rows, D = 64, n = 4,096 ids) about 4,000 rows are touched:
// each row of a bf16 table and a bf16 slot is read and written once
// (512 B a row), plus 1 MB of grads: about 3 MB, under a microsecond at
// 3.35 TB/s. The kernel is far below that size where the card is busy;
// launch latency and the id sort outside it set its time.
//
// What the design does about it. One warp per sorted entry; a warp whose
// entry does not start a run exits at once, so no host sync counts runs
// and no atomics are needed. The starting warp walks its run in order
// (deterministic f32 sums, the twin's order), each lane owning columns
// lane, lane + 32, ... (coalesced 128 B row accesses). Only touched rows
// move. The TPU kernel's block streaming and one-hot MXU routing were TPU
// layout choices and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps (entries) per block
constexpr int kMaxColsPerLane = 8;   // D <= 256

enum Kind { kSgd = 0, kAdagrad = 1, kRowwise = 2, kAdam = 3, kFtrl = 4 };

struct Consts {
  float c0, c1, c2, c3, c4;
};

__device__ __forceinline__ uint32_t mix32(uint32_t pos, uint32_t seed,
                                          uint32_t stream) {
  uint32_t x = pos * 0x9E3779B9u;
  x = x ^ (seed * 0x85EBCA6Bu + stream * 0xC2B2AE35u);
  x = x ^ (x >> 16);
  x = x * 0x85EBCA6Bu;
  x = x ^ (x >> 13);
  x = x * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return x;
}

__device__ __forceinline__ float load_plane(const void* p, int bf16,
                                            int64_t idx) {
  if (bf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
  }
  return static_cast<const float*>(p)[idx];
}

__device__ __forceinline__ void store_plane(void* p, int bf16, int64_t idx,
                                            float x, int use_sr,
                                            uint32_t seed, uint32_t stream,
                                            uint32_t pos) {
  if (!bf16) {
    static_cast<float*>(p)[idx] = x;
    return;
  }
  __nv_bfloat16 out;
  if (use_sr) {
    uint32_t u = __float_as_uint(x);
    u = u + (mix32(pos, seed, stream) & 0xFFFFu);
    u = u & 0xFFFF0000u;
    out = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  } else {
    out = __float2bfloat16_rn(x);
  }
  static_cast<__nv_bfloat16*>(p)[idx] = out;
}

// x ** e as the twin's torch.pow(tensor, e): exponent 0.5 is a square root
// there, other exponents the math library's pow.
__device__ __forceinline__ float pow_like_twin(float x, float e) {
  if (e == 0.5f) return __fsqrt_rn(x);
  return powf(x, e);
}

template <int KIND>
__global__ void __launch_bounds__(kWarps * 32)
sparse_apply_kernel(const int* __restrict__ ids,
                    const float* __restrict__ grads, int n, int64_t v,
                    int d, void* s0, void* s1, void* s2, int bf16_mask,
                    const float* __restrict__ scalars,
                    Consts k, int use_sr, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= n) return;
  const int id = ids[e];
  if (id < 0 || id >= v) return;
  if (e > 0 && ids[e - 1] == id) return;  // not the first entry of its run

  // Sum the run's grads in sorted order; count its entries.
  float g[kMaxColsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxColsPerLane; ++j) g[j] = 0.f;
  int count = 0;
  for (int r = e; r < n && ids[r] == id; ++r) {
    const float* gr = grads + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int j = 0; j < kMaxColsPerLane; ++j) {
      const int col = lane + 32 * j;
      if (col < d) g[j] = __fadd_rn(g[j], gr[col]);
    }
    ++count;
  }

  const int64_t row = id;
  const float lr = scalars[0];
  const int bf0 = bf16_mask & 1, bf1 = (bf16_mask >> 1) & 1,
            bf2 = (bf16_mask >> 2) & 1;

  float row_scale = 0.f;
  float row_accum = 0.f;
  if constexpr (KIND == kRowwise) {
    // accum [V, 1] += mean(g^2) over the row: a warp tree sum.
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxColsPerLane; ++j) {
      if (lane + 32 * j < d) part = __fadd_rn(part, __fmul_rn(g[j], g[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    }
    const float mean = __fdiv_rn(part, static_cast<float>(d));
    row_accum = __fadd_rn(load_plane(s1, bf1, row), mean);
    row_scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(row_accum, 1e-12f)));
    if (lane == 0) {
      store_plane(s1, bf1, row, row_accum, use_sr, seed, 1u,
                  static_cast<uint32_t>(row * d));
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxColsPerLane; ++j) {
    const int col = lane + 32 * j;
    if (col >= d) continue;
    const int64_t idx = row * d + col;
    const uint32_t pos = static_cast<uint32_t>(idx);
    const float t = load_plane(s0, bf0, idx);
    const float gj = g[j];
    if constexpr (KIND == kSgd) {
      store_plane(s0, bf0, idx, __fsub_rn(t, __fmul_rn(lr, gj)), use_sr,
                  seed, 0u, pos);
    } else if constexpr (KIND == kAdagrad) {
      const float acc =
          __fadd_rn(load_plane(s1, bf1, idx), __fmul_rn(gj, gj));
      const float scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(acc, 1e-12f)));
      store_plane(s0, bf0, idx,
                  __fsub_rn(t, __fmul_rn(__fmul_rn(lr, gj), scale)), use_sr,
                  seed, 0u, pos);
      store_plane(s1, bf1, idx, acc, use_sr, seed, 1u, pos);
    } else if constexpr (KIND == kRowwise) {
      store_plane(s0, bf0, idx,
                  __fsub_rn(t, __fmul_rn(__fmul_rn(lr, gj), row_scale)),
                  use_sr, seed, 0u, pos);
    } else if constexpr (KIND == kAdam) {
      // consts: beta1, 1 - beta1, beta2, 1 - beta2, epsilon.
      const float bc1 = scalars[1], bc2 = scalars[2];
      const float m = load_plane(s1, bf1, idx);
      const float vv = load_plane(s2, bf2, idx);
      const float m_rows = __fadd_rn(__fmul_rn(k.c0, m), __fmul_rn(k.c1, gj));
      const float v_rows = __fadd_rn(__fmul_rn(k.c2, vv),
                                     __fmul_rn(k.c3, __fmul_rn(gj, gj)));
      const float delta = __fdiv_rn(
          __fmul_rn(-lr, __fdiv_rn(m_rows, bc1)),
          __fadd_rn(__fsqrt_rn(__fdiv_rn(v_rows, bc2)), k.c4));
      // Only touched rows get here (count >= 1); the mask keeps the
      // rule's text.
      const bool touched = count > 0;
      store_plane(s0, bf0, idx, __fadd_rn(t, touched ? delta : 0.f), use_sr,
                  seed, 0u, pos);
      store_plane(s1, bf1, idx, touched ? m_rows : m, use_sr, seed, 1u, pos);
      store_plane(s2, bf2, idx, touched ? v_rows : vv, use_sr, seed, 2u, pos);
    } else {  // kFtrl; consts: -learning_rate_power, l1, 2 * l2.
      const float acc = load_plane(s1, bf1, idx);
      const float lin = load_plane(s2, bf2, idx);
      const float n_new = __fadd_rn(acc, __fmul_rn(gj, gj));
      const float p_new = pow_like_twin(n_new, k.c0);
      const float sigma =
          __fdiv_rn(__fsub_rn(p_new, pow_like_twin(acc, k.c0)), lr);
      const float z_new = __fsub_rn(__fadd_rn(lin, gj), __fmul_rn(sigma, t));
      const float denom = __fadd_rn(__fdiv_rn(p_new, lr), k.c2);
      const float sgn = (z_new > 0.f) ? 1.f : ((z_new < 0.f) ? -1.f : 0.f);
      const float w_new =
          fabsf(z_new) > k.c1
              ? __fdiv_rn(__fsub_rn(__fmul_rn(sgn, k.c1), z_new), denom)
              : 0.f;
      const bool touched = count > 0;
      store_plane(s0, bf0, idx, touched ? w_new : t, use_sr, seed, 0u, pos);
      store_plane(s1, bf1, idx, touched ? n_new : acc, use_sr, seed, 1u, pos);
      store_plane(s2, bf2, idx, touched ? z_new : lin, use_sr, seed, 2u, pos);
    }
  }
}

template <int KIND>
cudaError_t launch(const int* ids, const float* grads, int n, int64_t v,
                   int d, void* s0, void* s1, void* s2, int bf16_mask,
                   const float* scalars, Consts k,
                   int use_sr, uint32_t seed, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const dim3 grid((n + kWarps - 1) / kWarps);
  sparse_apply_kernel<KIND><<<grid, kWarps * 32, 0, stream>>>(
      ids, grads, n, v, d, s0, s1, s2, bf16_mask, scalars, k, use_sr, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 sgd, 1 adagrad, 2 rowwise_adagrad, 3 adam, 4 ftrl.
// s0 is the table [v, d]; s1 and s2 are the slot planes the rule reads
// (null when it has none): [v, d], or [v, 1] for rowwise_adagrad.
// bf16_mask bit i is set when state i is bf16 (else f32).
// Returns the cudaError_t of the launch (0 on success).
int sparse_apply_launch(int kind, const int* ids, const float* grads, int n,
                        long long v, int d, void* s0, void* s1, void* s2,
                        int bf16_mask, const float* scalars,
                        float c0, float c1, float c2, float c3, float c4,
                        int use_sr, unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{c0, c1, c2, c3, c4};
  if (d <= 0 || d > 32 * kMaxColsPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kind) {
    case kSgd:
      return launch<kSgd>(ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                          scalars, k, use_sr, seed, s);
    case kAdagrad:
      return launch<kAdagrad>(ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                              scalars, k, use_sr, seed, s);
    case kRowwise:
      return launch<kRowwise>(ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                              scalars, k, use_sr, seed, s);
    case kAdam:
      return launch<kAdam>(ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                           scalars, k, use_sr, seed, s);
    case kFtrl:
      return launch<kFtrl>(ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                           scalars, k, use_sr, seed, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sparse_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
