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
//   - loads the row of every state as f32, applies the rule (sgd,
//     adagrad, rowwise_adagrad, adam or ftrl; the twin's rules are the
//     identity for a row of count 0, and adam / ftrl mask with count > 0,
//     which every run passes), and writes the row back, bf16 planes with
//     stochastic rounding when a seed is given and round-to-nearest-even
//     otherwise.
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
// 3.35 TB/s. At that size the kernel's time is its dependent round trips
// to device memory and the launch, not its bytes.
//
// What the design does about it. A block of 32 warps owns 32 consecutive
// sorted entries, so n = 4,096 takes 128 blocks, one an SM: on an H100
// the count of blocks set the time more than the round trips did (8-warp
// blocks, 512 of them, took 4.5 us; 32-warp blocks 3.1 us; PERF.md). It
// loads its ids, the one before and the 32 after them into shared memory
// once, coalesced (-1 past either end, never a real id), and each warp
// its entry's grad row beside them; run starts and run ends are read in
// shared memory: no warp walks ids in device memory one entry at a time.
// The warp of entry e works iff e starts a run (a real id that differs
// from entry e - 1's); all the others exit at once, so no host sync
// counts runs and no atomics are needed. Its row is then known, so it
// loads the row's state before it finds where the run ends (one ballot
// over the next 32 ids in shared memory; a run longer than that reads the
// ids past the window 32 at a time): one round trip after the ids. The
// rest of a run's grads come four rows' loads at a time; it sums them in
// sorted order (deterministic f32 sums, the twin's order), applies the
// rule and writes the row back. Lanes own contiguous column pairs, 2 (lane + 32 j) and the next,
// so f32 rows move as float2 and bf16 rows as bf16x2 (single columns
// where D is odd or a plane is not aligned for pairs). Only touched rows
// move. The TPU kernel's block streaming and one-hot MXU routing were TPU
// layout choices and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;           // warps a block, one entry of its tile each
constexpr int kLook = 32;            // ids past each warp's entry in the window
constexpr int kWindow = kWarps + kLook + 1;  // ids [base - 1, base + kWarps + kLook)
constexpr int kMaxColsPerLane = 8;   // D <= 256
constexpr int kRowsInFlight = 4;     // grad rows a warp loads before it adds

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

// W consecutive values of a plane from element idx, as f32.
template <int W>
__device__ __forceinline__ void load_plane(const void* p, int bf16,
                                           int64_t idx, float out[W]) {
  if (bf16) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p) + idx;
    if constexpr (W == 2) {
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b));
      out[0] = v.x;
      out[1] = v.y;
    } else {
      out[0] = __bfloat162float(*b);
    }
  } else {
    const float* f = static_cast<const float*>(p) + idx;
    if constexpr (W == 2) {
      const float2 v = *reinterpret_cast<const float2*>(f);
      out[0] = v.x;
      out[1] = v.y;
    } else {
      out[0] = *f;
    }
  }
}

// The bf16 bits of x: stochastically rounded with the bits of (pos, seed,
// stream) when use_sr, else rounded to nearest even.
__device__ __forceinline__ uint32_t bf16_bits(float x, int use_sr,
                                              uint32_t seed, uint32_t stream,
                                              uint32_t pos) {
  if (use_sr) {
    return (__float_as_uint(x) + (mix32(pos, seed, stream) & 0xFFFFu)) >> 16;
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Writes W values at element idx; a bf16 plane's value i rounds with the
// bits of position pos + i.
template <int W>
__device__ __forceinline__ void store_plane(void* p, int bf16, int64_t idx,
                                            const float x[W], int use_sr,
                                            uint32_t seed, uint32_t stream,
                                            uint32_t pos) {
  if (!bf16) {
    float* f = static_cast<float*>(p) + idx;
    if constexpr (W == 2) {
      *reinterpret_cast<float2*>(f) = make_float2(x[0], x[1]);
    } else {
      f[0] = x[0];
    }
    return;
  }
  unsigned short* b = static_cast<unsigned short*>(p) + idx;
  if constexpr (W == 2) {
    *reinterpret_cast<uint32_t*>(b) =
        bf16_bits(x[0], use_sr, seed, stream, pos) |
        (bf16_bits(x[1], use_sr, seed, stream, pos + 1) << 16);
  } else {
    b[0] = static_cast<unsigned short>(
        bf16_bits(x[0], use_sr, seed, stream, pos));
  }
}

// x ** e as the twin's torch.pow(tensor, e): exponent 0.5 is a square root
// there, other exponents the math library's pow.
__device__ __forceinline__ float pow_like_twin(float x, float e) {
  if (e == 0.5f) return __fsqrt_rn(x);
  return powf(x, e);
}

// The rule on one element of a touched row: table value t, slot values a
// and b (those the rule has), summed grad g; updates them in place.
// row_scale is rowwise_adagrad's 1 / sqrt(row accumulator + 1e-12).
template <int KIND>
__device__ __forceinline__ void apply_rule(float& t, float& a, float& b,
                                           float g, float lr, float bc1,
                                           float bc2, float row_scale,
                                           const Consts& k) {
  if constexpr (KIND == kSgd) {
    t = __fsub_rn(t, __fmul_rn(lr, g));
  } else if constexpr (KIND == kAdagrad) {
    a = __fadd_rn(a, __fmul_rn(g, g));
    const float scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(a, 1e-12f)));
    t = __fsub_rn(t, __fmul_rn(__fmul_rn(lr, g), scale));
  } else if constexpr (KIND == kRowwise) {
    t = __fsub_rn(t, __fmul_rn(__fmul_rn(lr, g), row_scale));
  } else if constexpr (KIND == kAdam) {
    // consts: beta1, 1 - beta1, beta2, 1 - beta2, epsilon. Only touched
    // rows get here (count >= 1), where the twin's count mask passes the
    // update.
    a = __fadd_rn(__fmul_rn(k.c0, a), __fmul_rn(k.c1, g));
    b = __fadd_rn(__fmul_rn(k.c2, b), __fmul_rn(k.c3, __fmul_rn(g, g)));
    const float delta = __fdiv_rn(
        __fmul_rn(-lr, __fdiv_rn(a, bc1)),
        __fadd_rn(__fsqrt_rn(__fdiv_rn(b, bc2)), k.c4));
    t = __fadd_rn(t, delta);
  } else {  // kFtrl; consts: -learning_rate_power, l1, 2 * l2.
    const float n_new = __fadd_rn(a, __fmul_rn(g, g));
    const float p_new = pow_like_twin(n_new, k.c0);
    const float sigma =
        __fdiv_rn(__fsub_rn(p_new, pow_like_twin(a, k.c0)), lr);
    const float z_new = __fsub_rn(__fadd_rn(b, g), __fmul_rn(sigma, t));
    const float denom = __fadd_rn(__fdiv_rn(p_new, lr), k.c2);
    const float sgn = (z_new > 0.f) ? 1.f : ((z_new < 0.f) ? -1.f : 0.f);
    t = fabsf(z_new) > k.c1
            ? __fdiv_rn(__fsub_rn(__fmul_rn(sgn, k.c1), z_new), denom)
            : 0.f;
    a = n_new;
    b = z_new;
  }
}

// Block x owns sorted entries [32x, 32x + 32), warp w entry 32x + w;
// lanes own columns W (lane + 32 j) + [0, W).
template <int KIND, int W>
__global__ void __launch_bounds__(kWarps * 32)
sparse_apply_kernel(const int* __restrict__ ids,
                    const float* __restrict__ grads, int n, int64_t v,
                    int d, void* s0, void* s1, void* s2, int bf16_mask,
                    const float* __restrict__ scalars,
                    Consts k, int use_sr, uint32_t seed) {
  constexpr int kChunks = kMaxColsPerLane / W;
  // Planes of width D the rule reads beside the table.
  constexpr int kFullSlots =
      KIND == kAdagrad ? 1 : (KIND == kAdam || KIND == kFtrl ? 2 : 0);
  __shared__ int window[kWindow];
  const int base = blockIdx.x * kWarps;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWindow; i += kWarps * 32) {
    const int e = base - 1 + i;
    window[i] = e >= 0 && e < n ? ids[e] : -1;
  }
  const float lr = scalars[0];
  float bc1 = 1.f, bc2 = 1.f;
  if constexpr (KIND == kAdam) {
    bc1 = scalars[1];
    bc2 = scalars[2];
  }
  // This entry's grad row, which it needs if it starts a run: loaded
  // beside the ids.
  const int e = base + w;
  float g[kChunks][W];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = (lane + 32 * j) * W;
    if (e < n && col < d) {
      load_plane<W>(grads, 0, static_cast<int64_t>(e) * d + col, g[j]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) g[j][i] = 0.f;
    }
  }
  __syncthreads();
  const int id = window[w + 1];
  // Not a run start: padding (ids past n read -1), or entry e - 1's id.
  if (id < 0 || id >= v || window[w] == id) return;

  const int64_t row = id;
  const int bf0 = bf16_mask & 1, bf1 = (bf16_mask >> 1) & 1,
            bf2 = (bf16_mask >> 2) & 1;
  // The row's state: it needs only the id, so it is loaded before the
  // run's end is known.
  float t[kChunks][W], a[kChunks][W], b[kChunks][W];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = (lane + 32 * j) * W;
    if (col >= d) continue;
    load_plane<W>(s0, bf0, row * d + col, t[j]);
    if constexpr (kFullSlots >= 1) load_plane<W>(s1, bf1, row * d + col, a[j]);
    if constexpr (kFullSlots >= 2) load_plane<W>(s2, bf2, row * d + col, b[j]);
  }
  float row_accum = 0.f;
  if constexpr (KIND == kRowwise) load_plane<1>(s1, bf1, row, &row_accum);

  // The run is [e, end): the window's next 32 ids, then (a longer run)
  // device memory's, 32 at a time.
  unsigned same = __ballot_sync(0xffffffffu, window[w + 2 + lane] == id);
  int more = same == 0xffffffffu ? 32 : __ffs(~same) - 1;
  int end = e + 1 + more;
  while (more == 32) {
    const int r = end + lane;
    same = __ballot_sync(0xffffffffu, r < n && ids[r] == id);
    more = same == 0xffffffffu ? 32 : __ffs(~same) - 1;
    end += more;
  }

  // Sum the run's grads in sorted order from 0: row e's is here, the
  // rest come kRowsInFlight rows' loads before their adds.
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int i = 0; i < W; ++i) g[j][i] = __fadd_rn(0.f, g[j][i]);
  }
  for (int r0 = e + 1; r0 < end; r0 += kRowsInFlight) {
    float x[kRowsInFlight][kChunks][W];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int col = (lane + 32 * j) * W;
        if (r0 + u < end && col < d) {
          load_plane<W>(grads, 0, static_cast<int64_t>(r0 + u) * d + col,
                        x[u][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (r0 + u >= end || (lane + 32 * j) * W >= d) continue;
#pragma unroll
        for (int i = 0; i < W; ++i) g[j][i] = __fadd_rn(g[j][i], x[u][j][i]);
      }
    }
  }

  float row_scale = 0.f;
  if constexpr (KIND == kRowwise) {
    // accum [V, 1] += mean(g^2) over the row: lane L sums columns L,
    // L + 32, ... in turn, then a warp tree sum; the order of a reduction
    // of 32 threads a row (the twin's CUDA mean at D = 64 matches it).
    // With column pairs, column c sits in lane (c / 2) % 32, chunk c / 64.
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxColsPerLane; ++j) {
      const int col = lane + 32 * j;
      float x;
      if constexpr (W == 2) {
        const int src = (col >> 1) & 31;
        const float lo = __shfl_sync(0xffffffffu, g[j >> 1][0], src);
        const float hi = __shfl_sync(0xffffffffu, g[j >> 1][1], src);
        x = (lane & 1) ? hi : lo;
      } else {
        x = g[j][0];
      }
      if (col < d) part = __fadd_rn(part, __fmul_rn(x, x));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    }
    row_accum = __fadd_rn(row_accum, __fdiv_rn(part, static_cast<float>(d)));
    row_scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(row_accum, 1e-12f)));
    if (lane == 0) {
      store_plane<1>(s1, bf1, row, &row_accum, use_sr, seed, 1u,
                     static_cast<uint32_t>(row * d));
    }
  }

#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = (lane + 32 * j) * W;
    if (col >= d) continue;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      apply_rule<KIND>(t[j][i], a[j][i], b[j][i], g[j][i], lr, bc1, bc2,
                       row_scale, k);
    }
    const int64_t idx = row * d + col;
    const uint32_t pos = static_cast<uint32_t>(idx);
    store_plane<W>(s0, bf0, idx, t[j], use_sr, seed, 0u, pos);
    if constexpr (kFullSlots >= 1) {
      store_plane<W>(s1, bf1, idx, a[j], use_sr, seed, 1u, pos);
    }
    if constexpr (kFullSlots >= 2) {
      store_plane<W>(s2, bf2, idx, b[j], use_sr, seed, 2u, pos);
    }
  }
}

template <int KIND>
cudaError_t launch(bool pairs, const int* ids, const float* grads, int n,
                   int64_t v, int d, void* s0, void* s1, void* s2,
                   int bf16_mask, const float* scalars, Consts k, int use_sr,
                   uint32_t seed, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const dim3 grid((n + kWarps - 1) / kWarps);
  if (pairs) {
    sparse_apply_kernel<KIND, 2><<<grid, kWarps * 32, 0, stream>>>(
        ids, grads, n, v, d, s0, s1, s2, bf16_mask, scalars, k, use_sr,
        seed);
  } else {
    sparse_apply_kernel<KIND, 1><<<grid, kWarps * 32, 0, stream>>>(
        ids, grads, n, v, d, s0, s1, s2, bf16_mask, scalars, k, use_sr,
        seed);
  }
  return cudaGetLastError();
}

// Whether a plane (null: absent) of 4- or 2-byte values starts on a
// boundary of two of them.
bool pair_aligned(const void* p, int bf16) {
  return reinterpret_cast<uintptr_t>(p) % (bf16 ? 4 : 8) == 0;
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
  // Column pairs where D is even and every plane of width D (and the
  // grads) starts on a pair.
  const bool pairs =
      d % 2 == 0 && pair_aligned(grads, 0) &&
      pair_aligned(s0, bf16_mask & 1) &&
      (kind == kRowwise || s1 == nullptr ||
       pair_aligned(s1, (bf16_mask >> 1) & 1)) &&
      (s2 == nullptr || pair_aligned(s2, (bf16_mask >> 2) & 1));
  switch (kind) {
    case kSgd:
      return launch<kSgd>(pairs, ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                          scalars, k, use_sr, seed, s);
    case kAdagrad:
      return launch<kAdagrad>(pairs, ids, grads, n, v, d, s0, s1, s2,
                              bf16_mask, scalars, k, use_sr, seed, s);
    case kRowwise:
      return launch<kRowwise>(pairs, ids, grads, n, v, d, s0, s1, s2,
                              bf16_mask, scalars, k, use_sr, seed, s);
    case kAdam:
      return launch<kAdam>(pairs, ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                           scalars, k, use_sr, seed, s);
    case kFtrl:
      return launch<kFtrl>(pairs, ids, grads, n, v, d, s0, s1, s2, bf16_mask,
                           scalars, k, use_sr, seed, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sparse_apply_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
