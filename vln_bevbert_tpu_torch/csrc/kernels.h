// Launch functions of the hand-written kernels (splat.cu, dropout.cu).
//
// Plain C++ with no PyTorch headers, so that nvcc compiles the kernels in
// seconds; ops.cpp checks the tensors, allocates, takes PyTorch's current
// stream and calls these. Each returns the launch's cudaGetLastError().

#pragma once

#include <cuda_runtime_api.h>
#include <stdint.h>

namespace bevbert {

// y = x * [bits >= thresh] * scale over rows of row_len elements, one seed a
// row. dtype 0: float32, 1: bfloat16. vec requires row_len % 4 == 0 and x, y
// aligned to four elements. grid: blocks of 256 threads, grid-strided.
cudaError_t launch_dropout(const void* x, void* y, const int32_t* seeds,
                           long long rows, long long row_len, uint32_t thresh,
                           float scale, int dtype, bool vec, int grid,
                           cudaStream_t stream);

enum SplatFeatType { kSplatF32 = 0, kSplatBF16 = 1, kSplatF16 = 2 };

// Per batch row b and cell c, out[b, c, :] = the sums over the points n with
// cell[b, n] == c of [bf16(feats row of n) | one_hot(sem[b, n]) | 1].
//
// Point n of row b reads the feature row (b, step_sel[b, n / P], n % P) of a
// (B, T, P, F) tensor, or with step_sel == nullptr the row (b, n) of a
// (B, N, F) tensor (T = 1, P = N). Points whose cell lies outside
// [0, num_cells) add nothing; semantic labels outside [0, num_sem) add to
// the count column only. Columns past F + num_sem + 1 hold zeros.
struct SplatArgs {
  const int32_t* cell;      // (B, N)
  const void* feats;        // feat_type rows of feat_dim, 16-byte aligned
  int feat_type;            // SplatFeatType
  const int32_t* step_sel;  // (B, sel_len) or nullptr
  const int32_t* sem;       // (B, N) or nullptr
  float* out;               // (B, num_cells, out_stride), written whole
  int32_t* hist;            // (B, ceil(N / 1024), num_cells) scratch
  int32_t* order;           // (B, N) scratch
  int32_t* sorted_cell;     // (B, N) scratch
  int32_t* sorted_sem;      // (B, N) scratch, with sem
  int32_t* n_valid;         // (B,) scratch
  int batch, n_points, num_cells, feat_dim, num_sem, out_stride;
  int steps, points_per_step, sel_len;
};

// feat_dim % 8 == 0, out_stride % 8 == 0 and >= feat_dim + num_sem + 1,
// num_cells <= 1024, B * T * P < 2^31, checked by the caller.
cudaError_t launch_splat(const SplatArgs& args, cudaStream_t stream);

}  // namespace bevbert
