// Streaming copy step over an embedding table and its accumulator, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/_alias_probe.py:111 (copy_kernel,
// called by copy_chain :118, pallas_call :119), the probe's block-streamed
// read-plus-write floor.
//
// What it computes. The same function as the plain twin
// recommenders_tpu_torch/ops/copy_chain.py::copy_step_reference. Input: a
// table of n values, f32 or bf16, and an f32 accumulator of n values (the
// probe's two [V, D] arrays, flattened). Output: table + eps and
// accumulator + 1e-7f, written in place or into a second pair. eps is
// 1e-7 rounded to the table's type first, as the Pallas body takes it
// (jnp.asarray(1e-7, t_ref.dtype)): for a bf16 table each value is
// bf16(f32(t) + f32(bf16(1e-7))), rounded to nearest even; for an f32
// table, and for the accumulator, one IEEE f32 add (__fadd_rn). The
// results are bit-equal to the twin's.
//
// What bounds it on the H100. Bytes: each input value read once and each
// output value written once, n * (table bytes + 4) * 2 in all. At the
// probe's shape (V = 131,072, D = 64) that is 100,663,296 B with a bf16
// table (30.0 us at 3.35 TB/s) and 134,217,728 B with an f32 one (40.1 us).
// Those working sets (48 or 64 MiB read, as much written) are about the
// size of the 50 MB L2, so a chain of steps in place may partly hit L2;
// the card's HBM copy rate is read on a pair well past it.
//
// What the design does about it. Nothing is reused, so the only aim is to
// keep enough bytes in flight: one grid-stride pass over both arrays,
// every thread moving 16 bytes of the table a step with one vector load
// and one vector store (8 bf16 or 4 f32 values), and the matching
// accumulator values as one or two float4 loads and stores. The grid is
// eight 256-thread blocks an SM, the most an SM holds, so each SM keeps
// 64 KB (f32 table) or 96 KB (bf16 table) of loads in flight. A tail that
// is not a whole vector, or arrays that do not start on 16 bytes, go value
// by value. In place and out of place are the same kernel with other
// output pointers; a thread reads its values before it writes the same
// ones, so in place is safe (the pointers are not declared __restrict__:
// they may alias). The TPU's row blocks of --br rows were a VMEM tiling
// choice and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float add_eps(float t, float eps) {
  return __fadd_rn(t, eps);
}

__device__ __forceinline__ __nv_bfloat16 add_eps(__nv_bfloat16 t,
                                                 float eps) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(t), eps));
}

// eps in the table's type, as f32: bf16(1e-7) for a bf16 table.
template <typename T>
__device__ __forceinline__ float table_eps();

template <>
__device__ __forceinline__ float table_eps<float>() {
  return kEps;
}

template <>
__device__ __forceinline__ float table_eps<__nv_bfloat16>() {
  return __bfloat162float(__float2bfloat16_rn(kEps));
}

// Values of T in 16 bytes: 4 f32 or 8 bf16.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void scalar_step(const T* t, const float* a,
                                            T* to, float* ao, long long i,
                                            float teps) {
  const T tv = t[i];
  const float av = a[i];
  to[i] = add_eps(tv, teps);
  ao[i] = add_eps(av, kEps);
}

// One grid-stride pass. VEC: the first n / kVec<T> vectors of each array
// move 16 bytes of the table at a time (every pointer 16-byte aligned),
// the tail value by value; otherwise every value goes alone.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
copy_step_kernel(const T* t, const float* a, T* to, float* ao, long long n) {
  const float teps = table_eps<T>();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  long long done = 0;
  if (VEC) {
    constexpr int W = kVec<T>;
    constexpr int kAccVecs = W / 4;   // float4s of the accumulator a vector
    const long long vecs = n / W;
    for (long long v = first; v < vecs; v += stride) {
      const uint4 tv = reinterpret_cast<const uint4*>(t)[v];
      float4 av[kAccVecs];
#pragma unroll
      for (int j = 0; j < kAccVecs; ++j) {
        av[j] = reinterpret_cast<const float4*>(a)[v * kAccVecs + j];
      }
      uint4 tout;
      const T* tin = reinterpret_cast<const T*>(&tv);
      T* tres = reinterpret_cast<T*>(&tout);
#pragma unroll
      for (int j = 0; j < W; ++j) tres[j] = add_eps(tin[j], teps);
      reinterpret_cast<uint4*>(to)[v] = tout;
#pragma unroll
      for (int j = 0; j < kAccVecs; ++j) {
        float4 r;
        r.x = add_eps(av[j].x, kEps);
        r.y = add_eps(av[j].y, kEps);
        r.z = add_eps(av[j].z, kEps);
        r.w = add_eps(av[j].w, kEps);
        reinterpret_cast<float4*>(ao)[v * kAccVecs + j] = r;
      }
    }
    done = vecs * W;
  }
  for (long long i = done + first; i < n; i += stride) {
    scalar_step(t, a, to, ao, i, teps);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* t, const float* a, void* to, float* ao, long long n,
           int sms, cudaStream_t stream) {
  const bool vec = aligned16(t) && aligned16(a) && aligned16(to) &&
                   aligned16(ao);
  const long long units = vec ? n / kVec<T> + n % kVec<T> : n;
  const long long wanted = (units + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(wanted < most ? wanted : most);
  const T* tt = static_cast<const T*>(t);
  T* tto = static_cast<T*>(to);
  if (vec) {
    copy_step_kernel<T, true><<<grid, kThreads, 0, stream>>>(tt, a, tto, ao,
                                                             n);
  } else {
    copy_step_kernel<T, false><<<grid, kThreads, 0, stream>>>(tt, a, tto, ao,
                                                              n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table_bf16: 1 when the table (t, to) is bf16, 0 when f32; the
// accumulator (a, ao) is f32. n values each, n > 0; to and ao may equal t
// and a (in place). sms: the card's SM count, which sizes the grid.
// Returns the cudaError_t of the launch (0 on success).
int copy_chain_launch(int table_bf16, const void* t, const float* a,
                      void* to, float* ao, long long n, int sms,
                      void* stream) {
  if (n <= 0 || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return launch<__nv_bfloat16>(t, a, to, ao, n, sms, s);
  }
  return launch<float>(t, a, to, ao, n, sms, s);
}

const char* copy_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
