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
//       the launches of "dropout" (forward and backward) and "splat" that
//       ran on the current device, counted by the kernels themselves
//       (kernels.h), so a CUDA graph's replays count and its capture does
//       not; both synchronise the device;
//   stamp(int id) -> (), stamps(bool reset) -> (Tensor, int)
//       stamp.cu: queue a stamp of the device's clock under id on the current
//       stream (also into a CUDA graph being captured, which then stamps at
//       every replay); read the stamps taken on the current device since
//       the last reset, oldest first, as an int64 (n, 2) CPU tensor of (id,
//       ns) rows, with the count of slots taken (more than n where the ring
//       wrapped), and with reset start it again; stamps synchronises.
//
// Each operator checks its tensors, allocates its outputs and scratch with
// PyTorch's allocator, launches on PyTorch's current stream without
// synchronising, and raises if the launch fails. Only CUDA kernels are
// registered: the CPU runs the plain versions in ops/dropout.py and
// ops/splat.py, which never call these operators.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/roll.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/autograd/custom_function.h>
#include <torch/library.h>

#include <cmath>
#include <cstdint>
#include <optional>
#include <tuple>

#include "kernels.h"

namespace bevbert {
namespace {

constexpr int64_t kMaxCells = 1024;  // splat.cu: one scan thread a cell

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
  // the widest access that rows of whole groups of four, the element count
  // and x's start allow (y is freshly allocated, so aligned): 16 bytes,
  // 8 bytes (bfloat16), else one element
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  const auto fits = [&](int64_t elems) {
    const uintptr_t bytes = elems * x.element_size();
    return row_len % 4 == 0 && x.numel() % elems == 0 &&
           reinterpret_cast<uintptr_t>(x.data_ptr()) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(y.data_ptr()) % bytes == 0;
  };
  const int vec = bf16 && fits(8) ? 8 : fits(4) ? 4 : 1;
  TORCH_CHECK_VALUE(row_len < (int64_t{1} << 31), "seeded_dropout: rows of ", row_len,
                    " elements; the kernel takes rows of fewer than 2^31");
  TORCH_CHECK_VALUE(rows * ((row_len + 3) / 4) < (int64_t{1} << 31), "seeded_dropout: ",
                    x.numel(), " elements in rows of ", row_len,
                    "; the kernel takes fewer than 2^31 groups of four");
  C10_CUDA_CHECK(launch_dropout(x.data_ptr(), y.data_ptr(), seeds.data_ptr<int32_t>(),
                                static_cast<uint32_t>(rows), static_cast<uint32_t>(row_len),
                                thresh, scale, bf16, vec, x.get_device(),
                                c10::cuda::getCurrentCUDAStream().stream()));
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
  // float32 slots for the pieces of runs across tile edges: two per tile of
  // 32 sorted points
  at::Tensor part = at::empty({b * ((n + 31) / 32) * 2 * stride},
                              cell.options().dtype(at::kFloat));

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
  args.part = part.data_ptr<float>();
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
  return out.narrow(2, 0, d);
}

int64_t launch_count(c10::string_view kernel) {
  TORCH_CHECK_VALUE(kernel == "dropout" || kernel == "splat", "no kernel named ", kernel);
  unsigned long long n = 0;
  C10_CUDA_CHECK(kernel == "dropout" ? dropout_launches(&n, false) : splat_launches(&n, false));
  return static_cast<int64_t>(n);
}

void reset_launch_counts() {
  C10_CUDA_CHECK(dropout_launches(nullptr, true));
  C10_CUDA_CHECK(splat_launches(nullptr, true));
}

void stamp(int64_t id) {
  TORCH_CHECK_VALUE(id >= 0 && id < (int64_t{1} << 32), "stamp id ", id, " outside 32 bits");
  C10_CUDA_CHECK(
      launch_stamp(static_cast<uint32_t>(id), c10::cuda::getCurrentCUDAStream().stream()));
}

std::tuple<at::Tensor, int64_t> stamps(bool reset) {
  at::Tensor ring = at::empty({static_cast<int64_t>(kStampSlots), 2}, at::kLong);
  unsigned long long head = 0;
  auto* slots = reinterpret_cast<unsigned long long*>(ring.data_ptr<int64_t>());
  C10_CUDA_CHECK(read_stamps(&head, slots, reset));
  const auto taken = static_cast<int64_t>(head);
  if (head <= kStampSlots) return {ring.narrow(0, 0, taken), taken};
  // wrapped: the oldest slot left is the next one to be written
  return {at::roll(ring, -static_cast<int64_t>(head % kStampSlots), 0), taken};
}

}  // namespace
}  // namespace bevbert

TORCH_LIBRARY(bevbert, m) {
  m.def("seeded_dropout(Tensor x, Tensor seeds, float rate) -> Tensor");
  m.def("splat_sums(Tensor cell, Tensor feats, Tensor? step_sel, Tensor? sem_labels, "
        "int num_cells, int num_sem) -> Tensor");
  m.def("launch_count(str kernel) -> int", &bevbert::launch_count);
  m.def("reset_launch_counts() -> ()", &bevbert::reset_launch_counts);
  m.def("stamp(int id) -> ()", &bevbert::stamp);
  m.def("stamps(bool reset) -> (Tensor, int)", &bevbert::stamps);
}

TORCH_LIBRARY_IMPL(bevbert, CUDA, m) {
  m.impl("seeded_dropout", &bevbert::seeded_dropout_cuda);
  m.impl("splat_sums", &bevbert::splat_sums_cuda);
}

TORCH_LIBRARY_IMPL(bevbert, Autograd, m) {
  m.impl("seeded_dropout", &bevbert::seeded_dropout_autograd);
}
