// BEV splat: per batch row, out[c, d] = sum_n [cell[n] == c] * payload[n, d].
//
// Replaces vln_bevbert_tpu/ops/pallas_splat.py:splat_sums, which builds the
// (points x cells) one-hot inside VMEM and contracts it on the MXU. On the
// TPU that is the natural form; done the same way on Hopper it would cost
// 2*B*N*C*D flops, about 51 GFLOP per navigation step at the slice's shape
// (B=4, N=8*2352=18816 points, C=441 cells, D=769 payload channels), for a
// result that is a segment sum. This kernel computes the same sums as a
// scatter: every payload element is read once and added into its cell, so
// the kernel is bound by bytes (reading the bf16 payload once, ~116 MB at
// the slice's shape, ~35 us at the H100 SXM's 3.35 TB/s), not by flops.
//
// Design (simple first):
// - grid (point splits, D tiles of 64 channels, batch rows); each block
//   keeps a C x 64 float accumulator in dynamic shared memory (441 cells:
//   112,896 bytes, above the 48 KB default, so the host entry raises the
//   limit with cudaFuncSetAttribute);
// - one warp handles one point at a time: all 32 lanes share its cell, so the
//   shared-memory atomics of a warp hit 32 distinct consecutive words (no
//   bank conflicts); lanes read channels lane and lane+32 of the point's row
//   (two coalesced 64-byte reads; rows of odd length D are only 2-byte
//   aligned, so no vector loads);
// - each warp loads UNROLL points before it adds any, to keep more bytes in
//   flight;
// - points whose cell lies outside [0, C) are skipped without reading their
//   payload: invalid points carry cell -1, matching the one-hot form, where
//   such a cell matches no column;
// - the point range is split over blocks so that the grid fills the card;
//   each block adds its partial tile into the zeroed output with global
//   float atomics. Float sums therefore run in another order than the
//   one-hot GEMM's, and from run to run; integer-valued columns (the count
//   column) stay exact below 2^24.
//
// Plain C entry point, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileD = 64;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
splat_sums_kernel(const int32_t* __restrict__ cell,
                  const __nv_bfloat16* __restrict__ payload,
                  float* __restrict__ out, int n_points, int num_cells, int d,
                  int points_per_split) {
  extern __shared__ float acc[];  // num_cells * kTileD
  const int split = blockIdx.x;
  const int d0 = blockIdx.y * kTileD;
  const int b = blockIdx.z;

  for (int i = threadIdx.x; i < num_cells * kTileD; i += blockDim.x) {
    acc[i] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_begin = split * points_per_split;
  const int n_end = min(n_points, n_begin + points_per_split);
  const int32_t* cell_b = cell + (size_t)b * n_points;
  const __nv_bfloat16* pay_b = payload + (size_t)b * n_points * d;
  const int ch0 = d0 + lane;
  const int ch1 = d0 + lane + 32;
  const bool has0 = ch0 < d;
  const bool has1 = ch1 < d;

  for (int n = n_begin + warp * kUnroll; n < n_end; n += n_warps * kUnroll) {
    int cs[kUnroll];
    float v0[kUnroll];
    float v1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = n + u;
      int c = idx < n_end ? cell_b[idx] : -1;
      cs[u] = (c >= 0 && c < num_cells) ? c : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v0[u] = 0.f;
      v1[u] = 0.f;
      if (cs[u] >= 0) {
        const __nv_bfloat16* row = pay_b + (size_t)(n + u) * d;
        if (has0) v0[u] = __bfloat162float(row[ch0]);
        if (has1) v1[u] = __bfloat162float(row[ch1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cs[u] >= 0) {
        float* dst = acc + cs[u] * kTileD;
        if (has0) atomicAdd(dst + lane, v0[u]);
        if (has1) atomicAdd(dst + lane + 32, v1[u]);
      }
    }
  }
  __syncthreads();

  float* out_b = out + (size_t)b * num_cells * d;
  for (int i = threadIdx.x; i < num_cells * kTileD; i += blockDim.x) {
    const int c = i / kTileD;
    const int j = i - c * kTileD;
    const float v = acc[i];
    if (d0 + j < d && v != 0.f) {
      atomicAdd(out_b + (size_t)c * d + d0 + j, v);
    }
  }
}

}  // namespace

extern "C" {

// cell (B, N) int32, payload (B, N, D) bf16, out (B, C, D) float32 zeroed;
// all contiguous on the current device.
int bevbert_splat_sums(const void* cell, const void* payload, void* out,
                       int batch, int n_points, int num_cells, int d,
                       int n_splits, void* stream) {
  const int smem = num_cells * kTileD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      splat_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int points_per_split = (n_points + n_splits - 1) / n_splits;
  dim3 grid(n_splits, (d + kTileD - 1) / kTileD, batch);
  splat_sums_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const __nv_bfloat16*)payload, (float*)out,
      n_points, num_cells, d, points_per_split);
  return (int)cudaGetLastError();
}

const char* bevbert_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
