// Seeded dropout: y = x * [bits >= thresh] * scale, bits drawn in the kernel.
//
// Replaces vln_bevbert_tpu/ops/dropout.py:_pallas_apply (kernel
// _make_kernel, custom_vjp _dropout_sr). The TPU kernel draws its mask bits
// with the TPU's own PRNG inside VMEM, so the only device-memory traffic is
// reading x and writing y, and the backward re-runs it on dy with the same
// per-row seeds instead of loading a saved mask. This kernel keeps both
// properties with a counter-based generator written out here:
//
// - bits: Philox4x32-10 (Salmon et al., SC'11) keyed by (row seed, 0), with
//   counter (g, g >> 32, 0, 0) for the group g of four consecutive elements
//   of the row; element o of a row takes word o % 4 of group o / 4. The mask
//   is a pure function of (seed, offset in the row), independent of the
//   launch geometry, so the backward launch regenerates it bit for bit and
//   ops/dropout.py:dropout_ref reproduces it with int64 tensor arithmetic;
// - keep iff bits >= thresh, compared unsigned (thresh = round(rate * 2^32),
//   capped at 2^32 - 1), and kept values are float(x) * scale rounded to the
//   type of x, the rounding PyTorch's own `x * scale` does.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (4 bytes per bf16 element, 8 per float32); at the largest site, the
// (16, 12, 441, 441) bf16 attention probabilities, that is 149 MB, ~45 us at
// 3.35 TB/s. One Philox call (20 32-bit multiplies) serves four elements,
// ~12 us of integer multiplies at that shape, below the byte bound. A thread
// handles one group: 8-byte (bf16) or 16-byte (float32) vector loads and
// stores when the row length is a multiple of 4 and the pointers are
// aligned, scalar accesses otherwise. The grid strides over
// (row, group) pairs.
//
// Launched through ops.cpp's torch.ops.bevbert.seeded_dropout on PyTorch's
// current stream (kernels.h:launch_dropout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T apply(T x, uint32_t bits, uint32_t thresh, float scale) {
  T out;
  from_float(bits >= thresh ? to_float(x) * scale : 0.f, &out);
  return out;
}

// Four consecutive elements as one aligned vector access.
template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
               const uint32_t* __restrict__ seeds, long long rows,
               long long row_len, uint32_t thresh, float scale) {
  const long long groups = (row_len + 3) / 4;
  const long long total = rows * groups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / groups;
    const long long g = i - row * groups;
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)(g >> 32), 0u, 0u), seeds[row], 0u);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const long long base = row * row_len + 4 * g;
    if (kVec) {
      Vec4<T> in = *reinterpret_cast<const Vec4<T>*>(x + base);
      Vec4<T> out;
#pragma unroll
      for (int j = 0; j < 4; ++j) out.v[j] = apply(in.v[j], bits[j], thresh, scale);
      *reinterpret_cast<Vec4<T>*>(y + base) = out;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * g + j < row_len) y[base + j] = apply(x[base + j], bits[j], thresh, scale);
      }
    }
  }
}

template <typename T>
void launch(const void* x, void* y, const int32_t* seeds, long long rows,
            long long row_len, uint32_t thresh, float scale, bool vec, int grid,
            cudaStream_t stream) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(seeds);
  if (vec) {
    dropout_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (T*)y, s, rows, row_len, thresh, scale);
  } else {
    dropout_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (T*)y, s, rows, row_len, thresh, scale);
  }
}

}  // namespace

namespace bevbert {

cudaError_t launch_dropout(const void* x, void* y, const int32_t* seeds,
                           long long rows, long long row_len, uint32_t thresh,
                           float scale, int dtype, bool vec, int grid,
                           cudaStream_t stream) {
  if (dtype == 0) {
    launch<float>(x, y, seeds, rows, row_len, thresh, scale, vec, grid, stream);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, seeds, rows, row_len, thresh, scale, vec, grid, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace bevbert
