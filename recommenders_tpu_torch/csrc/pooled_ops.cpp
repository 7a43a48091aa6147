// The pooled lookup as a PyTorch dispatcher op:
// torch.ops.recommenders_tpu_torch.pooled_lookup.
//
// The binding of `pooled_lookup.cu`, in a library of its own so that a
// process that never pools (the index servers) loads nothing of it: the
// op joins the `recommenders_tpu_torch` namespace as a fragment, beside
// the serving ops of `torch_ops.cpp`, whichever library loads first.
// `ops/cuda_build.py` builds it with g++ against the wheel's headers (no
// torch/extension.h, no libtorch_python) and links `pooled_lookup`.
//
// The op checks its inputs, orders the features by bag length (longest
// first: their blocks start first; each feature keeps its own output
// columns), and launches one kernel a chunk of up to 64 features on the
// current CUDA stream, writing into `out`; a non-zero cudaError_t
// raises. Only a CUDA impl is registered: the wrapper
// (`ops/pooled_lookup.py`) runs the plain twin for CPU tensors. Every
// launch adds one to a count by table format, which
// `recommenders_tpu_torch_pool_launches` reads.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {
int pooled_lookup_launch(int format, int vecs, int count,
                         const void* const* tables, const void* const* ids,
                         const float* const* weights, const long long* rows,
                         const int* bags, const int* cols, float* out,
                         long long stride, int pairs, int ids64,
                         void* stream);
const char* pooled_lookup_error_string(int err);
}

namespace {

constexpr int64_t kMaxFeatures = 64;
constexpr int kFormats = 2;  // 0 f32, 1 fp16 tables
std::atomic<int64_t> g_launches[kFormats];

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

void check_on(const at::Tensor& t, const at::Tensor& out, const char* what) {
  TORCH_CHECK(t.is_cuda() && t.device() == out.device(), what, " on ",
              t.device(), ", out on ", out.device());
  TORCH_CHECK(t.is_contiguous(), what, " must be contiguous");
}

// Feature i of `n`: tables[i] [rows, D], ids[i] [B, bag], weights[i] f32
// [B, bag] or empty, its sums into out[:, columns[i]:columns[i] + D].
void pooled_lookup(at::TensorList tables, at::TensorList ids,
                   at::TensorList weights, at::IntArrayRef columns,
                   at::Tensor& out) {
  const int64_t n = static_cast<int64_t>(tables.size());
  TORCH_CHECK(static_cast<int64_t>(ids.size()) == n &&
                  static_cast<int64_t>(weights.size()) == n &&
                  static_cast<int64_t>(columns.size()) == n,
              "pooled_lookup takes as many ids, weights and columns as "
              "tables");
  TORCH_CHECK(out.is_cuda() && out.scalar_type() == at::kFloat &&
                  out.dim() == 2 && out.stride(1) == 1,
              "out must be a CUDA float32 [B, W] with unit column stride");
  TORCH_CHECK(out.stride(0) % 4 == 0 && aligned16(out),
              "out's rows must start on 16 bytes");
  c10::DeviceGuard guard(out.device());
  const int64_t pairs = out.size(0);
  if (n == 0 || pairs == 0) return;
  const at::ScalarType dtype = tables[0].scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kHalf,
              "tables must be float32 or float16, got ", dtype);
  TORCH_CHECK(tables[0].dim() == 2, "tables must be [rows, D]");
  const int64_t d = tables[0].size(1);
  const int64_t row_bytes = d * tables[0].element_size();
  const int64_t vecs = row_bytes / 16;
  TORCH_CHECK(row_bytes % 16 == 0 && vecs >= 1 && vecs <= 128 &&
                  (vecs & (vecs - 1)) == 0,
              "a row must be a power of two of 16-byte vectors, at most "
              "128; got D = ", d, " of ", dtype);
  const at::ScalarType id_type = ids[0].scalar_type();
  TORCH_CHECK(id_type == at::kLong || id_type == at::kInt,
              "ids must be int64 or int32, got ", id_type);
  std::vector<const void*> table_ptrs(n), id_ptrs(n);
  std::vector<const float*> weight_ptrs(n);
  std::vector<long long> rows(n);
  std::vector<int> bags(n), cols(n);
  for (int64_t i = 0; i < n; ++i) {
    const at::Tensor& t = tables[i];
    const at::Tensor& x = ids[i];
    const at::Tensor& w = weights[i];
    check_on(t, out, "table");
    check_on(x, out, "ids");
    TORCH_CHECK(t.scalar_type() == dtype && t.dim() == 2 && t.size(1) == d,
                "every table of a call must be ", dtype, " [rows, ", d, "]");
    TORCH_CHECK(aligned16(t), "tables must start on 16 bytes");
    TORCH_CHECK(x.scalar_type() == id_type && x.dim() == 2 &&
                    x.size(0) == pairs,
                "ids must be ", id_type, " [", pairs, ", bag]");
    TORCH_CHECK(x.size(1) <= 0x7fffffff, "a bag is at most 2^31 - 1 ids");
    if (w.numel() > 0) {
      check_on(w, out, "weights");
      TORCH_CHECK(w.scalar_type() == at::kFloat && w.sizes() == x.sizes(),
                  "weights must be float32 shaped as their ids");
    }
    TORCH_CHECK(columns[i] >= 0 && columns[i] % 4 == 0 &&
                    columns[i] + d <= out.size(1),
                "column ", columns[i], " of ", d, " values does not fit out's ",
                out.size(1), " on 16 bytes");
    table_ptrs[i] = t.data_ptr();
    id_ptrs[i] = x.data_ptr();
    weight_ptrs[i] = w.numel() > 0 ? w.data_ptr<float>() : nullptr;
    rows[i] = t.size(0);
    bags[i] = static_cast<int>(x.size(1));
    cols[i] = static_cast<int>(columns[i]);
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return bags[a] > bags[b];
  });
  auto permuted = [&](auto& v) {
    auto copy = v;
    for (int64_t i = 0; i < n; ++i) v[i] = copy[order[i]];
  };
  permuted(table_ptrs);
  permuted(id_ptrs);
  permuted(weight_ptrs);
  permuted(rows);
  permuted(bags);
  permuted(cols);
  const int format = dtype == at::kHalf ? 1 : 0;
  void* stream = c10::cuda::getCurrentCUDAStream(out.get_device()).stream();
  for (int64_t s = 0; s < n; s += kMaxFeatures) {
    const int count = static_cast<int>(std::min(kMaxFeatures, n - s));
    const int err = pooled_lookup_launch(
        format, static_cast<int>(vecs), count, table_ptrs.data() + s,
        id_ptrs.data() + s, weight_ptrs.data() + s, rows.data() + s,
        bags.data() + s, cols.data() + s, out.data_ptr<float>(),
        out.stride(0), static_cast<int>(pairs),
        static_cast<int>(id_type == at::kLong), stream);
    TORCH_CHECK(err == 0, "pooled_lookup kernel launch failed: ",
                pooled_lookup_error_string(err), " (cudaError ", err, ")");
    g_launches[format]++;
  }
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(recommenders_tpu_torch, m) {
  m.def(
      "pooled_lookup(Tensor[] tables, Tensor[] ids, Tensor[] weights, "
      "int[] columns, Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(recommenders_tpu_torch, CUDA, m) {
  m.impl("pooled_lookup", &pooled_lookup);
}

extern "C" {

// Launches with tables in `format` (0 f32, 1 fp16) since the library
// loaded or the last reset; -1 for an unknown format.
int64_t recommenders_tpu_torch_pool_launches(int format) {
  if (format < 0 || format >= kFormats) return -1;
  return g_launches[format].load();
}

void recommenders_tpu_torch_reset_pool_launches() {
  for (auto& count : g_launches) count.store(0);
}

}  // extern "C"
