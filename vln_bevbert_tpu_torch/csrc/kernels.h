// Launch functions of the hand-written kernels (splat.cu, dropout.cu, stamp.cu).
//
// Plain C++ with no PyTorch headers, so that nvcc compiles the kernels in
// seconds; ops.cpp checks the tensors, allocates, takes PyTorch's current
// stream and calls these. Each returns the launch's cudaGetLastError().

#pragma once

#include <cuda_runtime_api.h>
#include <stdint.h>

namespace bevbert {

// y = x * [bits >= thresh] * scale over rows of row_len elements, one seed a
// row, on device `device`. dtype 0: float32, 1: bfloat16. vec: the elements
// of one access, 8 (bfloat16) or 4, which require row_len % 4 == 0, a
// multiple of vec elements in all and x, y aligned to vec elements, or 1
// (any row length and alignment). Requires rows * ceil(row_len / 4) < 2^31;
// the grid is one wave.
cudaError_t launch_dropout(const void* x, void* y, const int32_t* seeds, uint32_t rows,
                           uint32_t row_len, uint32_t thresh, float scale, int dtype, int vec,
                           int device, cudaStream_t stream);

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
  float* part;              // (B, ceil(N / 32), 2, out_stride) scratch
  int batch, n_points, num_cells, feat_dim, num_sem, out_stride;
  int steps, points_per_step, sel_len;
};

// feat_dim % 8 == 0, out_stride % 8 == 0 and >= feat_dim + num_sem + 1,
// num_cells <= 1024, B * T * P < 2^31, checked by the caller.
cudaError_t launch_splat(const SplatArgs& args, cudaStream_t stream);

// The launches of each kernel that ran on the current device since the
// library was loaded or the last reset, counted by the kernel itself in
// device memory: a launch recorded in a CUDA graph counts at every replay,
// and a launch queued but not yet run counts once it has run. Each call
// synchronises the device first, then reads the count into *count or, with
// reset, sets it to 0.
cudaError_t dropout_launches(unsigned long long* count, bool reset);
cudaError_t splat_launches(unsigned long long* count, bool reset);

// Device phase stamps (stamp.cu): launch_stamp queues a one-thread kernel
// that takes the next slot of a ring of kStampSlots in device memory and
// writes (id, %globaltimer ns) there, at every replay where a CUDA graph
// recorded it. read_stamps synchronises the device, reads the slots taken
// since the last reset into *head, copies the first min(*head, kStampSlots)
// slots, as (id, ns) pairs, into ring (room for 2 * kStampSlots), and with
// reset starts the ring again at slot 0. Slot s lies at s % kStampSlots.
constexpr unsigned long long kStampSlots = 65536;
cudaError_t launch_stamp(uint32_t id, cudaStream_t stream);
cudaError_t read_stamps(unsigned long long* head, unsigned long long* ring, bool reset);

}  // namespace bevbert
