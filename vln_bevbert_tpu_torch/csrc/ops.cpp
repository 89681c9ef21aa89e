// The hand-written CUDA kernels as PyTorch operators (namespace bevbert):
//
//   seeded_dropout(Tensor x, Tensor seeds, float rate) -> Tensor
//       dropout.cu on CUDA tensors, with a C++ autograd whose backward saves
//       only the seeds and relaunches the kernel on dy;
//   splat_sums(Tensor cell, Tensor feats, Tensor? step_sel,
//              Tensor? sem_labels, int num_cells, int num_sem) -> Tensor
//       splat.cu on CUDA tensors: (B, num_cells, F + num_sem + 1) float32,
//       a view of rows padded to whole 8-column groups;
//   launch_count(str kernel) -> int, reset_launch_counts() -> ()
//       the launches of "dropout" (forward and backward) and "splat".
//
// Each operator checks its tensors, allocates its outputs and scratch with
// PyTorch's allocator, launches on PyTorch's current stream without
// synchronising, and raises if the launch fails. Only CUDA kernels are
// registered: the CPU runs the plain versions in ops/dropout.py and
// ops/splat.py, which never call these operators.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/autograd/custom_function.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <optional>

#include "kernels.h"

namespace bevbert {
namespace {

std::atomic<int64_t> dropout_launches{0};
std::atomic<int64_t> splat_launches{0};

constexpr int64_t kMaxCells = 1024;  // splat.cu: one scan thread a cell

int sm_count(int device) {
  static std::atomic<int> counts[64];
  int n = counts[device].load(std::memory_order_relaxed);
  if (n == 0) {
    C10_CUDA_CHECK(cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device));
    counts[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

at::Tensor seeded_dropout_cuda(const at::Tensor& x, const at::Tensor& seeds, double rate) {
  TORCH_CHECK_VALUE(x.is_cuda() && seeds.device() == x.device(), "seeded_dropout: x on ",
                    x.device(), ", seeds on ", seeds.device(),
                    "; both must be on one CUDA device");
  TORCH_CHECK_TYPE(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
                   "seeded_dropout: need float32 or bfloat16 x, got ", x.scalar_type());
  TORCH_CHECK_TYPE(seeds.scalar_type() == at::kInt, "seeded_dropout: need int32 seeds, got ",
                   seeds.scalar_type());
  TORCH_CHECK_VALUE(x.dim() >= 1 && seeds.dim() == 1 && seeds.size(0) == x.size(0),
                    "seeded_dropout: need one seed per row of x, got x ", x.sizes(),
                    " and seeds ", seeds.sizes());
  TORCH_CHECK_VALUE(x.is_contiguous() && seeds.is_contiguous(),
                    "seeded_dropout: x and seeds must be contiguous");
  TORCH_CHECK_VALUE(rate >= 0.0 && rate < 1.0, "dropout rate must lie in [0, 1), got ", rate);
  // ops/dropout.py:threshold_and_scale: round half to even, capped at 2^32 - 1
  const double t = std::nearbyint(rate * 4294967296.0);
  const uint32_t thresh = t >= 4294967295.0 ? 0xFFFFFFFFu : static_cast<uint32_t>(t);
  const float scale = static_cast<float>(1.0 / (1.0 - rate));

  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty_like(x);
  if (x.numel() == 0) return y;
  const int64_t rows = x.size(0), row_len = x.numel() / rows;
  const uintptr_t vec_bytes = 4 * x.element_size();
  const bool vec = row_len % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x.data_ptr()) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(y.data_ptr()) % vec_bytes == 0;
  const int64_t work = rows * ((row_len + 3) / 4);
  const int grid = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>((work + 255) / 256, 32LL * sm_count(x.get_device()))));
  C10_CUDA_CHECK(launch_dropout(x.data_ptr(), y.data_ptr(), seeds.data_ptr<int32_t>(), rows,
                                row_len, thresh, scale, x.scalar_type() == at::kBFloat16,
                                vec, grid, c10::cuda::getCurrentCUDAStream().stream()));
  dropout_launches.fetch_add(1, std::memory_order_relaxed);
  return y;
}

class SeededDropout : public torch::autograd::Function<SeededDropout> {
 public:
  static at::Tensor forward(torch::autograd::AutogradContext* ctx, const at::Tensor& x,
                            const at::Tensor& seeds, double rate) {
    ctx->save_for_backward({seeds});
    ctx->saved_data["rate"] = rate;
    return seeded_dropout_cuda(x, seeds, rate);
  }

  static torch::autograd::variable_list backward(torch::autograd::AutogradContext* ctx,
                                                 torch::autograd::variable_list grads) {
    const at::Tensor seeds = ctx->get_saved_variables()[0];
    const double rate = ctx->saved_data["rate"].toDouble();
    return {seeded_dropout_cuda(grads[0].contiguous(), seeds, rate), at::Tensor(),
            at::Tensor()};
  }
};

at::Tensor seeded_dropout_autograd(const at::Tensor& x, const at::Tensor& seeds, double rate) {
  return SeededDropout::apply(x, seeds, rate);
}

at::Tensor splat_sums_cuda(const at::Tensor& cell, const at::Tensor& feats,
                           const std::optional<at::Tensor>& step_sel,
                           const std::optional<at::Tensor>& sem_labels, int64_t num_cells,
                           int64_t num_sem) {
  const bool by_step = step_sel.has_value() && step_sel->defined();
  const bool has_sem = sem_labels.has_value() && sem_labels->defined();
  TORCH_CHECK_VALUE(cell.is_cuda() && feats.device() == cell.device(), "splat_sums: cell on ",
                    cell.device(), ", feats on ", feats.device(),
                    "; both must be on one CUDA device");
  TORCH_CHECK_TYPE(cell.scalar_type() == at::kInt, "splat_sums: need int32 cell, got ",
                   cell.scalar_type());
  const auto ft = feats.scalar_type();
  TORCH_CHECK_TYPE(ft == at::kBFloat16 || ft == at::kHalf || ft == at::kFloat,
                   "splat_sums: need bfloat16, float16 or float32 feats, got ", ft);
  TORCH_CHECK_VALUE(cell.dim() == 2 && feats.dim() == (by_step ? 4 : 3),
                    "splat_sums: need cell (B, N) and feats ",
                    by_step ? "(B, T, P, F) with step_sel" : "(B, N, F)", ", got ",
                    cell.sizes(), " and ", feats.sizes());
  const int64_t b = cell.size(0), n = cell.size(1), f = feats.size(-1);
  const int64_t steps = by_step ? feats.size(1) : 1;
  const int64_t points_per_step = by_step ? feats.size(2) : n;
  const int64_t sel_len = by_step ? step_sel->size(-1) : 1;
  TORCH_CHECK_VALUE(feats.size(0) == b && (by_step ? sel_len * points_per_step : feats.size(1)) == n,
                    "splat_sums: feats ", feats.sizes(), " do not hold the ", n,
                    " points of cell ", cell.sizes());
  TORCH_CHECK_VALUE(cell.is_contiguous() && feats.is_contiguous(),
                    "splat_sums: cell and feats must be contiguous");
  TORCH_CHECK_VALUE(f % 8 == 0 && reinterpret_cast<uintptr_t>(feats.data_ptr()) % 16 == 0,
                    "splat_sums: need 16-byte aligned feature rows (F % 8 == 0), got F = ", f);
  if (by_step) {
    TORCH_CHECK_TYPE(step_sel->scalar_type() == at::kInt, "splat_sums: need int32 step_sel");
    TORCH_CHECK_VALUE(step_sel->device() == cell.device() && step_sel->is_contiguous() &&
                          step_sel->dim() == 2 && step_sel->size(0) == b,
                      "splat_sums: need a contiguous (B, S) step_sel on the cell's device");
  }
  const int64_t sem_cols = has_sem ? num_sem : 0;
  if (has_sem) {
    TORCH_CHECK_TYPE(sem_labels->scalar_type() == at::kInt, "splat_sums: need int32 sem_labels");
    TORCH_CHECK_VALUE(sem_labels->device() == cell.device() && sem_labels->is_contiguous() &&
                          sem_labels->sizes() == cell.sizes() && num_sem >= 1,
                      "splat_sums: need contiguous (B, N) sem_labels and num_sem >= 1");
  }
  TORCH_CHECK_VALUE(num_cells >= 1 && num_cells <= kMaxCells, "splat_sums: ", num_cells,
                    " cells is outside the kernel's range (1..", kMaxCells, ")");
  TORCH_CHECK_VALUE(b * steps * points_per_step < (int64_t{1} << 31),
                    "splat_sums: more than 2^31 feature rows");

  const c10::cuda::CUDAGuard guard(cell.device());
  const int64_t d = f + sem_cols + 1, stride = (d + 7) / 8 * 8;  // whole 8-column lane groups
  at::Tensor out = at::empty({b, num_cells, stride}, cell.options().dtype(at::kFloat));
  if (b == 0 || n == 0) return out.zero_().narrow(2, 0, d);
  // one int32 scratch buffer: chunk histograms, the cell-sorted rows, cells
  // and labels, valid counts
  const int64_t chunks = (n + 1023) / 1024;
  const int64_t n_hist = b * chunks * num_cells, n_sorted = (has_sem ? 3 : 2) * b * n;
  at::Tensor scratch = at::empty({n_hist + n_sorted + b}, cell.options());

  SplatArgs args;
  args.cell = cell.data_ptr<int32_t>();
  args.feats = feats.data_ptr();
  args.feat_type = ft == at::kBFloat16 ? kSplatBF16 : ft == at::kHalf ? kSplatF16 : kSplatF32;
  args.step_sel = by_step ? step_sel->data_ptr<int32_t>() : nullptr;
  args.sem = has_sem ? sem_labels->data_ptr<int32_t>() : nullptr;
  args.out = out.data_ptr<float>();
  args.hist = scratch.data_ptr<int32_t>();
  args.order = args.hist + n_hist;
  args.sorted_cell = args.order + b * n;
  args.sorted_sem = has_sem ? args.sorted_cell + b * n : nullptr;
  args.n_valid = args.hist + n_hist + n_sorted;
  args.batch = static_cast<int>(b);
  args.n_points = static_cast<int>(n);
  args.num_cells = static_cast<int>(num_cells);
  args.feat_dim = static_cast<int>(f);
  args.num_sem = static_cast<int>(sem_cols);
  args.out_stride = static_cast<int>(stride);
  args.steps = static_cast<int>(steps);
  args.points_per_step = static_cast<int>(points_per_step);
  args.sel_len = static_cast<int>(sel_len);
  C10_CUDA_CHECK(launch_splat(args, c10::cuda::getCurrentCUDAStream().stream()));
  splat_launches.fetch_add(1, std::memory_order_relaxed);
  return out.narrow(2, 0, d);
}

int64_t launch_count(c10::string_view kernel) {
  if (kernel == "dropout") return dropout_launches.load();
  TORCH_CHECK_VALUE(kernel == "splat", "launch_count: no kernel named ", kernel);
  return splat_launches.load();
}

void reset_launch_counts() {
  dropout_launches.store(0);
  splat_launches.store(0);
}

}  // namespace
}  // namespace bevbert

TORCH_LIBRARY(bevbert, m) {
  m.def("seeded_dropout(Tensor x, Tensor seeds, float rate) -> Tensor");
  m.def("splat_sums(Tensor cell, Tensor feats, Tensor? step_sel, Tensor? sem_labels, "
        "int num_cells, int num_sem) -> Tensor");
  m.def("launch_count(str kernel) -> int", &bevbert::launch_count);
  m.def("reset_launch_counts() -> ()", &bevbert::reset_launch_counts);
}

TORCH_LIBRARY_IMPL(bevbert, CUDA, m) {
  m.impl("seeded_dropout", &bevbert::seeded_dropout_cuda);
  m.impl("splat_sums", &bevbert::splat_sums_cuda);
}

TORCH_LIBRARY_IMPL(bevbert, Autograd, m) {
  m.impl("seeded_dropout", &bevbert::seeded_dropout_autograd);
}
