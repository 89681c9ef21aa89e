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
// What bounds it on an H100 (cli/profile_dropout.py; NVIDIA H100 80GB
// HBM3, 700 W). At the large sites, bytes: each element is read once and
// written once (4 bytes per bf16 element, 8 per float32); the (16, 12, 441,
// 441) bf16 attention probabilities move 149 MB, 44.6 us at 3.35 TB/s. The
// card's own copy of those bytes (torch.clone) takes ~53.6 us, and this
// kernel with its generator removed (--ceiling) 54.3-55.0 us: ~82% of the
// byte bound is what a read-and-write stream of that size reaches here.
// Under ~10 MB (most of a step's launches) the launch, the first loads'
// latency and one partial wave cost as much as the bytes. Philox is the one
// sizeable piece of arithmetic: per group of four elements 19
// 32x32->64-bit products (IMAD.WIDE.U32; the first round's second product
// is of a zero word), 18 three-way XORs (LOP3) and 9 key additions, 92 of
// the 200 instructions of the loop over one access of 8 bf16 (cuobjdump
// -sass). Measured, the generator costs 0.05-1 us a launch (the kernel
// against --ceiling), 0.2-2% at (16, 12, 441, 441) and 3-5% at B=32.
//
// The design, against each of those:
// - 16-byte accesses over the flat tensor: a bf16 access is 8 elements
//   (Philox groups 2k and 2k + 1, each looking up its own row, so rows of
//   row_len % 8 == 4, such as the attention probabilities', take them too),
//   a float32 access 4 (one group). 8-byte bf16 accesses where the element
//   count or x's start does not allow 16; single elements, masked at the
//   row's end, for ragged rows and misaligned views; ops.cpp picks the path.
// - the load ahead of Philox: a thread issues its trip's kUnroll loads
//   first, then draws their bits (the counters do not depend on the data)
//   while they land, then applies and stores. Measured, kUnroll 1 at 128
//   threads (28 registers, full occupancy) beats 2-4 accesses a thread
//   (46-92 registers): the bytes in flight come from resident warps.
// - 32-bit indexing: a group's row is its flat index divided by the groups
//   per row with a precomputed multiply-and-shift (FastDivmod); the offset
//   inside the row is what remains. Nothing in the loop divides, and
//   nothing but the scalar path's element offset is 64-bit.
// - grid: one wave, the blocks that fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, cached per device
//   and path), or one access a thread where that takes fewer blocks; thread
//   t of the grid's S takes accesses t, t + S, t + 2S, ..., so no thread
//   has more than one access more than another.
//
// Launched through ops.cpp's torch.ops.bevbert.seeded_dropout on PyTorch's
// current stream (kernels.h:launch_dropout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 1;  // accesses per thread per trip
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 of the counter (g, 0, 0, 0) under the key (k0, 0). Each
// product is one 32x32->64-bit multiply giving both halves (IMAD.WIDE.U32);
// the first round's product of the counter's zero word folds away. (Forcing
// IMAD.WIDE.U32 with inline PTX, and sharing the key schedule of an
// access's two groups, both cost registers and measured slower.)
__device__ __forceinline__ uint4 philox(uint32_t g, uint32_t k0) {
  uint32_t c0 = g, c1 = 0, c2 = 0, c3 = 0, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c3 = static_cast<uint32_t>(p0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// n / d and n % d for n < 2^31 by one multiply-high, an add and a shift
// (Granlund and Montgomery's round-up method): with s = ceil(log2 d) and
// m = floor(2^32 (2^s - d) / d) + 1, n / d = (umulhi(n, m) + n) >> s.
struct FastDivmod {
  uint32_t d, m, s;

  static FastDivmod make(uint32_t d) {
    uint32_t s = 0;
    while ((1ull << s) < d) ++s;
    const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
    return {d, static_cast<uint32_t>(m), s};
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

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

// What one access of a thread covers: kVec elements of the flat tensor as
// one aligned vector (kVec 8 or 4; rows of whole groups, so each group lies
// in one row, but a vector's two groups may not), or with kVec 1 a group of
// four elements of a row read and written one at a time, masked at the
// row's end.
template <typename T, int kVec>
struct alignas(kVec * sizeof(T)) Unit {
  T v[kVec == 1 ? 4 : kVec];
};

// Launches that ran on this device: block 0's thread 0 adds one, so a launch
// recorded in a CUDA graph counts at every replay (kernels.h).
__device__ unsigned long long executed_launches = 0;

// n_units accesses; a row is per_row.d groups of four, row_len elements.
// Thread t of the grid's S takes accesses t, t + S, t + 2S, ..., kUnroll of
// them a trip, so every thread's share differs from any other's by at most
// one access.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
               const uint32_t* __restrict__ seeds, uint32_t n_units, FastDivmod per_row,
               uint32_t row_len, uint32_t thresh, float scale) {
  constexpr int kGroups = kVec == 8 ? 2 : 1;  // Philox groups per access
  using U = Unit<T, kVec>;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&executed_launches, 1ull);
  const uint32_t stride = gridDim.x * kThreads;
  // n_units < 2^31 and stride * kUnroll < 2^31 (launch), so nothing wraps
  for (uint32_t first = blockIdx.x * kThreads + threadIdx.x; first < n_units;
       first += kUnroll * stride) {
    U in[kUnroll];
    uint32_t seed[kUnroll][kGroups], group[kUnroll][kGroups], count[kUnroll];
    long long start[kUnroll];
    // 1. every load of the trip in flight, and each group's row and seed
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = first + u * stride;
      const bool valid = i < n_units;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const uint32_t flat = i * kGroups + k;
        const uint32_t row = per_row.div(flat);
        group[u][k] = flat - row * per_row.d;
        seed[u][k] = valid ? __ldg(seeds + row) : 0u;
      }
      if constexpr (kVec == 1) {
        in[u] = U{};
        start[u] = static_cast<long long>(per_row.div(i)) * row_len + 4 * group[u][0];
        count[u] = valid ? min(4u, row_len - 4 * group[u][0]) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < static_cast<int>(count[u])) in[u].v[j] = x[start[u] + j];
        }
      } else if (valid) {
        in[u] = reinterpret_cast<const U*>(x)[i];
      }
    }
    // 2. their bits, while the loads land (the counters do not depend on
    // the data)
    uint4 bits[kUnroll][kGroups];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kGroups; ++k) bits[u][k] = philox(group[u][k], seed[u][k]);
    }
    // 3. apply and store
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      U out;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const uint4 b = bits[u][k];
        out.v[4 * k + 0] = apply(in[u].v[4 * k + 0], b.x, thresh, scale);
        out.v[4 * k + 1] = apply(in[u].v[4 * k + 1], b.y, thresh, scale);
        out.v[4 * k + 2] = apply(in[u].v[4 * k + 2], b.z, thresh, scale);
        out.v[4 * k + 3] = apply(in[u].v[4 * k + 3], b.w, thresh, scale);
      }
      const uint32_t i = first + u * stride;
      if constexpr (kVec == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < static_cast<int>(count[u])) y[start[u] + j] = out.v[j];
        }
      } else if (i < n_units) {
        reinterpret_cast<U*>(y)[i] = out;
      }
    }
  }
}

constexpr int kMaxDevices = 64;
constexpr int kPaths = 5;  // float32 with kVec 4 or 1, bfloat16 with kVec 8, 4 or 1

// The blocks of `kernel` that fit on the device at once, cached per device
// and path: the grid of one wave.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int device, int path, int* blocks) {
  static std::atomic<int> cache[kMaxDevices][kPaths];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = cache[device][path].load(std::memory_order_relaxed);
  if (n == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    n = per_sm * sms;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    cache[device][path].store(n, std::memory_order_relaxed);
  }
  *blocks = n;
  return cudaSuccess;
}

template <typename T, int kVec>
cudaError_t launch(const void* x, void* y, const int32_t* seeds, uint32_t rows,
                   uint32_t row_len, uint32_t thresh, float scale, int device, int path,
                   cudaStream_t stream) {
  const auto kernel = dropout_kernel<T, kVec>;
  const uint32_t per_row = (row_len + 3) / 4;
  const uint32_t n_units = static_cast<uint32_t>(
      kVec == 1 ? uint64_t{rows} * per_row : uint64_t{rows} * row_len / kVec);
  int blocks = 0;
  const cudaError_t err = wave_blocks(kernel, device, path, &blocks);
  if (err != cudaSuccess) return err;
  // one wave, or one access a thread where that takes fewer blocks
  const uint32_t spread = (n_units + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(spread < static_cast<uint32_t>(blocks) ? spread : blocks);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), reinterpret_cast<const uint32_t*>(seeds),
      n_units, FastDivmod::make(per_row), row_len, thresh, scale);
  return cudaGetLastError();
}

}  // namespace

namespace bevbert {

cudaError_t launch_dropout(const void* x, void* y, const int32_t* seeds, uint32_t rows,
                           uint32_t row_len, uint32_t thresh, float scale, int dtype, int vec,
                           int device, cudaStream_t stream) {
  if (dtype == 0 && vec == 4) {
    return launch<float, 4>(x, y, seeds, rows, row_len, thresh, scale, device, 0, stream);
  }
  if (dtype == 0 && vec == 1) {
    return launch<float, 1>(x, y, seeds, rows, row_len, thresh, scale, device, 1, stream);
  }
  if (dtype == 1 && vec == 8) {
    return launch<__nv_bfloat16, 8>(x, y, seeds, rows, row_len, thresh, scale, device, 2,
                                    stream);
  }
  if (dtype == 1 && vec == 4) {
    return launch<__nv_bfloat16, 4>(x, y, seeds, rows, row_len, thresh, scale, device, 3,
                                    stream);
  }
  if (dtype == 1 && vec == 1) {
    return launch<__nv_bfloat16, 1>(x, y, seeds, rows, row_len, thresh, scale, device, 4,
                                    stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dropout_launches(unsigned long long* count, bool reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  if (reset) {
    const unsigned long long zero = 0;
    return cudaMemcpyToSymbol(executed_launches, &zero, sizeof zero);
  }
  return cudaMemcpyFromSymbol(count, executed_launches, sizeof *count);
}

}  // namespace bevbert
