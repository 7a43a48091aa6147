// K3, K4 and K5 as PyTorch dispatcher ops: torch.ops.recommenders_tpu_torch.*
//
// The serving kernels' binding. `torch.export` records a call of one of
// these ops as a node of the graph, and an AOTInductor package calls it
// through the dispatcher by its schema, so the same op serves the eager
// wrappers (`ops/scoring.py`, `ops/leaf_scoring.py`), an exported program
// run from Python and a package run by the C++ host
// (`csrc/serving_host.cpp`, which loads this library with RTLD_GLOBAL).
//
// Each op checks its inputs, allocates its outputs with at::empty, and
// calls the `extern "C"` launcher of `bucketed_scores.cu` (K3) or
// `leaf_scoring.cu` (K4, K5), which this library links, on the current
// CUDA stream; a non-zero cudaError_t raises. Only CUDA impls are
// registered: a CPU tensor finds no kernel here (the wrappers run the
// plain twins for CPU tensors before they reach an op). The fake (meta)
// impls are registered in Python (`torch.library.register_fake`). The
// schemas take only Tensor, int and float: an empty tensor stands for "no
// scales". The plans (K3's query tile and splits, K4's leaf groups, K5's
// splits) are computed ahead of the op in Python, so they trace into an
// exported graph.
//
// Every launch adds one to a count by op and format, which
// `recommenders_tpu_torch_launches` reads: the Python wrappers' counts
// never see a launch made inside a package.
//
// Built with g++ by `ops/cuda_build.py` against the wheel's headers; it
// includes no torch/extension.h and links no libtorch_python.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>

extern "C" {
int bucketed_scores_launch(int format, int bf16, const void* q, const void* c,
                           const float* scales, float* vals, int* rows,
                           int num_q, long long n, int d, int buckets,
                           long long valid_rows, float mask_value,
                           int query_tile, int splits, float* split_vals,
                           int* split_rows, void* stream);
const char* bucketed_scores_error_string(int err);
int probed_leaf_scores_launch(int format, const float* q, const void* leaves,
                              const float* scales, const int* order,
                              const int* bounds, const int* last,
                              const int* block_leaf, int blocks, float* out,
                              int num_probes, int num_leaves, int cap, int d,
                              int vec, float mask_value, void* stream);
int probed_bucketed_scores_launch(int format, const float* q,
                                  const void* leaves, const float* scales,
                                  const int* leaf_rows, const int* probes,
                                  float* vals, int* rows, int tiles,
                                  int query_tile, int num_probes,
                                  int num_leaves, int cap, int d, int buckets,
                                  int vec, int splits, float* split_vals,
                                  int* split_rows, float mask_value,
                                  void* stream);
const char* leaf_scoring_error_string(int err);
}

namespace {

// Ops and their formats, as the Python wrappers name them.
enum Op { kBucketed = 0, kLeaf = 1, kProbedBucketed = 2, kOps = 3 };
constexpr int kFormats = 4;  // K3: f32 bf16 int8 int4; K4/K5: f32 bf16 int8 int4
std::atomic<int64_t> g_launches[kOps][kFormats];

void check_cuda(const at::Tensor& t, const at::Tensor& like,
                const char* what) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), what, " on ",
              t.device(), ", queries on ", like.device());
  TORCH_CHECK(t.is_contiguous(), what, " must be contiguous");
}

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

const float* scales_ptr(const at::Tensor& scales) {
  return scales.numel() ? scales.data_ptr<float>() : nullptr;
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.get_device()).stream();
}

// K3 (`ops/scoring.py::_launch`). format: 0 rows (f32 or bf16, by the
// corpus dtype), 1 int8 codes, 2 packed int4 codes; scales empty for rows.
std::tuple<at::Tensor, at::Tensor> bucketed_scores(
    const at::Tensor& queries, const at::Tensor& candidates,
    const at::Tensor& scales, int64_t format, int64_t buckets,
    int64_t valid_rows, int64_t query_tile, int64_t splits,
    double mask_value) {
  c10::DeviceGuard guard(queries.device());
  check_cuda(queries, queries, "queries");
  check_cuda(candidates, queries, "corpus");
  TORCH_CHECK(queries.dim() == 2 && candidates.dim() == 2,
              "bucketed_scores takes queries [Q, D] and a corpus [N, D]");
  TORCH_CHECK(candidates.size(1) == queries.size(1), "corpus dim ",
              candidates.size(1), " != query dim ", queries.size(1));
  TORCH_CHECK(aligned16(queries) && aligned16(candidates),
              "queries and corpus must be 16-byte aligned");
  const int64_t qn = queries.size(0);
  const int64_t n = candidates.size(0) * (format == 2 ? 2 : 1);
  int fmt_index;
  if (format == 0) {
    TORCH_CHECK(candidates.scalar_type() == at::kFloat ||
                    candidates.scalar_type() == at::kBFloat16,
                "corpus rows must be float32 or bfloat16");
    TORCH_CHECK(queries.scalar_type() == candidates.scalar_type(),
                "queries and corpus must share a dtype");
    TORCH_CHECK(scales.numel() == 0, "rows take no scales");
    fmt_index = candidates.scalar_type() == at::kBFloat16 ? 1 : 0;
  } else {
    TORCH_CHECK(format == 1 || format == 2, "unknown K3 format ", format);
    TORCH_CHECK(candidates.scalar_type() == at::kChar, "codes must be int8");
    TORCH_CHECK(queries.scalar_type() == at::kBFloat16,
                "quantized corpora take bf16 queries");
    check_cuda(scales, queries, "scales");
    TORCH_CHECK(scales.scalar_type() == at::kFloat && scales.numel() == n,
                "scales must be float32 [N]");
    fmt_index = format == 2 ? 3 : 2;
  }
  auto f32 = queries.options().dtype(at::kFloat);
  auto i32 = queries.options().dtype(at::kInt);
  at::Tensor vals = at::empty({qn, buckets}, f32);
  at::Tensor rows = at::empty({qn, buckets}, i32);
  at::Tensor split_vals, split_rows;
  if (splits > 1) {
    split_vals = at::empty({splits, qn, buckets}, f32);
    split_rows = at::empty({splits, qn, buckets}, i32);
  }
  const int err = bucketed_scores_launch(
      static_cast<int>(format),
      static_cast<int>(queries.scalar_type() == at::kBFloat16 && format == 0),
      queries.data_ptr(), candidates.data_ptr(), scales_ptr(scales),
      vals.data_ptr<float>(), rows.data_ptr<int>(), static_cast<int>(qn), n,
      static_cast<int>(queries.size(1)), static_cast<int>(buckets),
      valid_rows, static_cast<float>(mask_value),
      static_cast<int>(query_tile), static_cast<int>(splits),
      splits > 1 ? split_vals.data_ptr<float>() : nullptr,
      splits > 1 ? split_rows.data_ptr<int>() : nullptr, stream_of(queries));
  TORCH_CHECK(err == 0, "bucketed_scores kernel launch failed: ",
              bucketed_scores_error_string(err), " (cudaError ", err, ")");
  g_launches[kBucketed][fmt_index]++;
  return {vals, rows};
}

// Checks what K4 and K5 share; returns `vec` (every stored row 16-byte
// aligned, so the kernels stage rows by 16-byte copies).
int check_leaves(const at::Tensor& queries, const at::Tensor& leaves,
                 const at::Tensor& scales, int64_t format) {
  check_cuda(queries, queries, "queries");
  check_cuda(leaves, queries, "leaves");
  TORCH_CHECK(queries.scalar_type() == at::kFloat, "queries must be float32");
  TORCH_CHECK(queries.dim() == 2 && leaves.dim() == 3 &&
                  leaves.size(2) == queries.size(1),
              "leaf scoring takes queries [Q, D] and leaves [L, cap, D]");
  TORCH_CHECK(format >= 0 && format < kFormats, "unknown leaf format ",
              format);
  if (format >= 2) {
    TORCH_CHECK(leaves.scalar_type() == at::kChar, "codes must be int8");
    check_cuda(scales, queries, "scales");
    TORCH_CHECK(scales.scalar_type() == at::kFloat, "scales must be float32");
  } else {
    TORCH_CHECK(leaves.scalar_type() ==
                    (format == 1 ? at::kBFloat16 : at::kFloat),
                "leaf rows do not match format ", format);
  }
  const int64_t per_chunk = format < 2 ? 8 : 16;  // elements of 16 bytes
  return static_cast<int>(leaves.size(2) % per_chunk == 0 &&
                          aligned16(leaves));
}

// K4 (`ops/leaf_scoring.py::_launch_leaf`), with its plan (`leaf_groups`).
at::Tensor probed_leaf_scores(const at::Tensor& queries,
                              const at::Tensor& leaves,
                              const at::Tensor& scales,
                              const at::Tensor& order,
                              const at::Tensor& bounds,
                              const at::Tensor& last,
                              const at::Tensor& block_leaf, int64_t format,
                              int64_t num_probes, int64_t cap,
                              double mask_value) {
  c10::DeviceGuard guard(queries.device());
  const int vec = check_leaves(queries, leaves, scales, format);
  for (const at::Tensor* t : {&order, &bounds, &last, &block_leaf}) {
    check_cuda(*t, queries, "plan");
    TORCH_CHECK(t->scalar_type() == at::kInt, "the plan must be int32");
  }
  const int64_t qn = queries.size(0);
  at::Tensor out =
      at::empty({qn, num_probes * cap}, queries.options().dtype(at::kFloat));
  if (qn * num_probes * cap == 0) return out;
  const int err = probed_leaf_scores_launch(
      static_cast<int>(format), queries.data_ptr<float>(), leaves.data_ptr(),
      scales_ptr(scales), order.data_ptr<int>(), bounds.data_ptr<int>(),
      last.data_ptr<int>(), block_leaf.data_ptr<int>(),
      static_cast<int>(block_leaf.size(0)), out.data_ptr<float>(),
      static_cast<int>(num_probes), static_cast<int>(leaves.size(0)),
      static_cast<int>(cap), static_cast<int>(queries.size(1)), vec,
      static_cast<float>(mask_value), stream_of(queries));
  TORCH_CHECK(err == 0, "probed_leaf_scores kernel launch failed: ",
              leaf_scoring_error_string(err), " (cudaError ", err, ")");
  g_launches[kLeaf][format]++;
  return out;
}

// K5 (`ops/leaf_scoring.py::_launch_bucketed`).
std::tuple<at::Tensor, at::Tensor> probed_bucketed_scores(
    const at::Tensor& queries, const at::Tensor& leaves,
    const at::Tensor& scales, const at::Tensor& leaf_rows,
    const at::Tensor& probes, int64_t format, int64_t query_tile,
    int64_t cap, int64_t buckets, int64_t splits, double mask_value) {
  c10::DeviceGuard guard(queries.device());
  const int vec = check_leaves(queries, leaves, scales, format);
  check_cuda(leaf_rows, queries, "leaf_rows");
  check_cuda(probes, queries, "probes");
  TORCH_CHECK(leaf_rows.scalar_type() == at::kInt &&
                  probes.scalar_type() == at::kInt,
              "leaf_rows and probes must be int32");
  const bool int8 = format == 2;
  const int64_t qn = queries.size(0);
  auto f32 = queries.options().dtype(at::kFloat);
  auto i32 = queries.options().dtype(at::kInt);
  at::Tensor vals = at::empty({qn, buckets}, f32);
  at::Tensor rows = at::empty({qn, buckets}, i32);
  if (qn == 0) return {vals, rows};
  // int8: S * ceil(cap / B) planes of values and order keys, always.
  const int64_t planes =
      int8 ? splits * ((cap + buckets - 1) / buckets) : splits;
  at::Tensor split_vals, split_rows;
  if (int8 || splits > 1) {
    split_vals = at::empty({planes, qn, buckets}, f32);
    split_rows = at::empty({planes, qn, buckets}, i32);
  }
  const int err = probed_bucketed_scores_launch(
      static_cast<int>(format), queries.data_ptr<float>(), leaves.data_ptr(),
      scales_ptr(scales), leaf_rows.data_ptr<int>(), probes.data_ptr<int>(),
      vals.data_ptr<float>(), rows.data_ptr<int>(),
      static_cast<int>(probes.size(0)), static_cast<int>(query_tile),
      static_cast<int>(probes.size(1)), static_cast<int>(leaves.size(0)),
      static_cast<int>(cap), static_cast<int>(queries.size(1)),
      static_cast<int>(buckets), vec, static_cast<int>(splits),
      split_vals.defined() ? split_vals.data_ptr<float>() : nullptr,
      split_rows.defined() ? split_rows.data_ptr<int>() : nullptr,
      static_cast<float>(mask_value), stream_of(queries));
  TORCH_CHECK(err == 0, "probed_bucketed_scores kernel launch failed: ",
              leaf_scoring_error_string(err), " (cudaError ", err, ")");
  g_launches[kProbedBucketed][format]++;
  return {vals, rows};
}

}  // namespace

TORCH_LIBRARY(recommenders_tpu_torch, m) {
  m.def(
      "bucketed_scores(Tensor queries, Tensor candidates, Tensor scales, "
      "int format, int buckets, int valid_rows, int query_tile, int splits, "
      "float mask_value) -> (Tensor, Tensor)");
  m.def(
      "probed_leaf_scores(Tensor queries, Tensor leaves, Tensor scales, "
      "Tensor order, Tensor bounds, Tensor last, Tensor block_leaf, "
      "int format, int num_probes, int cap, float mask_value) -> Tensor");
  m.def(
      "probed_bucketed_scores(Tensor queries, Tensor leaves, Tensor scales, "
      "Tensor leaf_rows, Tensor probes, int format, int query_tile, int cap, "
      "int buckets, int splits, float mask_value) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(recommenders_tpu_torch, CUDA, m) {
  m.impl("bucketed_scores", &bucketed_scores);
  m.impl("probed_leaf_scores", &probed_leaf_scores);
  m.impl("probed_bucketed_scores", &probed_bucketed_scores);
}

extern "C" {

// Launches of `op` (0 bucketed_scores, 1 probed_leaf_scores, 2
// probed_bucketed_scores) in `format` (0 f32, 1 bf16, 2 int8, 3 int4)
// since the library loaded or the last reset; -1 for an unknown pair.
int64_t recommenders_tpu_torch_launches(int op, int format) {
  if (op < 0 || op >= kOps || format < 0 || format >= kFormats) return -1;
  return g_launches[op][format].load();
}

void recommenders_tpu_torch_reset_launches() {
  for (auto& per_op : g_launches) {
    for (auto& count : per_op) count.store(0);
  }
}

}  // extern "C"
