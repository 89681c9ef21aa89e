// BEV splat with the gather fused in: per batch row b and cell c,
//   out[b, c, :] = sum over points n with cell[b, n] == c of
//                  [bf16(feature row of n) | one_hot(sem[b, n]) | 1],
// the sums that vln_bevbert_tpu/ops/pallas_splat.py:splat_sums computes on
// the payload cat([feats, one_hot(sem), ones]), without that payload ever
// existing in memory. The feature rows are read where they lie: in the
// rollout's (B, T, P, F) point-cloud store through a per-row step index
// (point n reads step step_sel[b, n / P], pixel n % P), or in a (B, N, F)
// tensor. float32 and float16 features are rounded to bf16 in registers, as
// the payload's cast rounds them, so the sums stay those of the payload.
//
// The TPU kernel builds the (points x cells) one-hot in VMEM and contracts it
// on the MXU. On Hopper that costs 2*B*N*C*D flops (51 GFLOP at the
// navigation shape B=4, N=18816, C=441, D=769), far above the bytes, for a
// result that is a segment sum. What bounds the segment sum is bytes: each
// valid point's 1536-byte feature row read once and the (B, C, D) float32
// sums written once (~82 MB at the navigation shape when two thirds of the
// points are valid, ~25 us at 3.35 TB/s).
//
// Design: sort the points by cell, then let each warp sum the runs of equal
// cells in a tile of the sorted points in registers, so that the hot loop
// reads whole rows with 16-byte loads and writes each run once.
// 1. splat_hist_kernel, grid (chunks of 1024 points, B): a shared-memory
//    histogram of the chunk's cells with warp-aggregated atomics (points of
//    one warp are neighbouring pixels and share cells).
// 2. splat_scatter_kernel, grid (chunks, B): each block scans the row's
//    chunk histograms into the start of each cell's run for its chunk and
//    writes its points' feature-row indices, cells and labels into the
//    row's cell-sorted order. The blocks of a row also zero the output rows
//    of the cells whose run crosses a tile boundary, and of empty cells.
// 3. splat_reduce_kernel: one warp per (tile of 32 sorted points, 256 output
//    columns); each lane loads 8 channels of a row with one 16-byte load,
//    sixteen rows in flight (two batches of eight, double-buffered), and
//    adds them in registers; lanes past the features add the one-hot and
//    count columns from the labels. When the cell changes, the run ends: a
//    run that is its cell's whole run is stored, a piece of a run that
//    crosses the tile's edge is added with float4 atomics (sm_90) into the
//    row zeroed in step 2.
// Float sums of a run that crosses a tile edge therefore run in another
// order than the one-hot GEMM's, and from run to run; the count and one-hot
// columns are exact (integers below 2^24).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 1024;           // points per block of the sort kernels
constexpr int kTile = 32;              // sorted points per warp of the reduce
constexpr int kLaneCh = 8;             // channels per lane: one 16-byte bf16 load
constexpr int kWarpCh = 32 * kLaneCh;  // output columns per warp
constexpr int kUnroll = 8;             // rows in flight per warp
constexpr int kReduceThreads = 256;

static_assert(kTile == 32 && 4 * kUnroll == kTile, "a tile is one warp's lanes");

// Lanes with on set add one each to base[key]; lanes with equal keys share
// one shared-memory atomic. Returns each lane's slot: the old value plus its
// rank among its peers. Every lane of the warp must call it.
__device__ __forceinline__ int aggregated_add(int* base, int key, bool on) {
  const unsigned active = __ballot_sync(kFull, on);
  int slot = 0;
  if (on) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(active, key);
    const int leader = __ffs(peers) - 1;
    if (lane == leader) slot = atomicAdd(base + key, __popc(peers));
    slot = __shfl_sync(active, slot, leader) + __popc(peers & ((1u << lane) - 1u));
  }
  return slot;
}

// Exclusive prefix sum of v over a block of kChunk threads; *total gets the
// block's sum. warp_sums holds kChunk / 32 ints and is free again on return.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = incl - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kChunk / 32 - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ int valid_cell(int c, int num_cells) {
  return (c >= 0 && c < num_cells) ? c : -1;
}

__global__ void __launch_bounds__(kChunk)
splat_hist_kernel(const int32_t* __restrict__ cell, int32_t* __restrict__ hist,
                  int n_points, int num_cells) {
  __shared__ int h[kChunk];  // num_cells <= kChunk
  if (threadIdx.x < num_cells) h[threadIdx.x] = 0;
  __syncthreads();
  const int k = blockIdx.x, b = blockIdx.y;
  const int n = k * kChunk + threadIdx.x;
  const int c = n < n_points ? valid_cell(cell[(size_t)b * n_points + n], num_cells) : -1;
  aggregated_add(h, c, c >= 0);
  __syncthreads();
  if (threadIdx.x < num_cells) {
    hist[((size_t)b * gridDim.x + k) * num_cells + threadIdx.x] = h[threadIdx.x];
  }
}

__global__ void __launch_bounds__(kChunk)
splat_scatter_kernel(bevbert::SplatArgs a) {
  __shared__ int start[kChunk];
  __shared__ int to_zero[kChunk];
  __shared__ int warp_sums[kChunk / 32];
  __shared__ int n_zero;
  const int k = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int t = threadIdx.x;
  const int num_cells = a.num_cells;
  const size_t bn = (size_t)b * a.n_points;
  if (t == 0) n_zero = 0;

  // this thread's point, loaded first so that its latency overlaps the scan
  const int n = k * kChunk + t;
  int c = -1, row = 0, label = 0;
  if (n < a.n_points) {
    c = valid_cell(a.cell[bn + n], num_cells);
    const int step = a.step_sel ? a.step_sel[(size_t)b * a.sel_len + n / a.points_per_step] : 0;
    row = (b * a.steps + step) * a.points_per_step + n % a.points_per_step;
    if (a.sem) label = a.sem[bn + n];
  }
  // thread t = cell t: its points in the whole row and in the chunks before k
  int total = 0, before = 0;
  if (t < num_cells) {
    const int32_t* hb = a.hist + (size_t)b * n_chunks * num_cells + t;
#pragma unroll 8
    for (int j = 0; j < n_chunks; ++j) {
      const int v = hb[(size_t)j * num_cells];
      total += v;
      before += j < k ? v : 0;
    }
  }
  int row_total;
  const int cell_start = block_exclusive_scan(total, warp_sums, &row_total);
  if (t < num_cells) start[t] = cell_start + before;
  if (k == 0 && t == 0) a.n_valid[b] = row_total;
  // the row's blocks share the zeroing of the output rows that the reduce
  // does not store whole: empty cells and runs across a tile boundary
  if (t < num_cells && t % n_chunks == k &&
      (total == 0 || cell_start / kTile != (cell_start + total - 1) / kTile)) {
    to_zero[atomicAdd(&n_zero, 1)] = t;
  }
  __syncthreads();
  const int row4 = a.out_stride / 4;
  float4* out_b = reinterpret_cast<float4*>(a.out + (size_t)b * num_cells * a.out_stride);
  for (int i = t; i < n_zero * row4; i += blockDim.x) {
    out_b[(size_t)to_zero[i / row4] * row4 + i % row4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int pos = aggregated_add(start, c, c >= 0);
  if (c >= 0) {
    a.order[bn + pos] = row;
    a.sorted_cell[bn + pos] = c;
    if (a.sem) a.sorted_sem[bn + pos] = label;
  }
}

// Eight channels of a feature row as loaded: 16 bytes of bf16 or f16, 32 of
// f32; add_raw adds the bf16 values the payload would hold.
template <typename T> struct Raw { uint4 v; };
template <> struct Raw<float> { float4 lo, hi; };

// Each row slice is read once: skipping L1 allocation measured 8-10% faster
// at the navigation and pretraining shapes (and slower at the CE shape, whose
// runs of one cell are long).
template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return {r};
}
template <>
__device__ __forceinline__ Raw<float> load_raw(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void add_raw(const Raw<__nv_bfloat16>& r, float* acc) {
  const uint32_t w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] += __uint_as_float(w[j] << 16);
    acc[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void add_raw(const Raw<__half>& r, float* acc) {
  const __half2* h = reinterpret_cast<const __half2*>(&r.v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    acc[2 * j] += bf16_round(f.x);
    acc[2 * j + 1] += bf16_round(f.y);
  }
}
__device__ __forceinline__ void add_raw(const Raw<float>& r, float* acc) {
  const float f[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y, r.hi.z, r.hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] += bf16_round(f[j]);
}

__device__ __forceinline__ void flush(float* dst, float* acc, bool shared) {
  const float4 lo = make_float4(acc[0], acc[1], acc[2], acc[3]);
  const float4 hi = make_float4(acc[4], acc[5], acc[6], acc[7]);
  float4* d = reinterpret_cast<float4*>(dst);
  if (shared) {
    atomicAdd(d, lo);
    atomicAdd(d + 1, hi);
  } else {
    d[0] = lo;
    d[1] = hi;
  }
#pragma unroll
  for (int j = 0; j < kLaneCh; ++j) acc[j] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
splat_reduce_kernel(const T* __restrict__ feats, const int32_t* __restrict__ order,
                    const int32_t* __restrict__ sorted_cell,
                    const int32_t* __restrict__ sorted_sem, const int32_t* __restrict__ n_valid,
                    float* __restrict__ out, int batch, int n_points, int feat_dim, int num_sem,
                    int num_cells, int out_stride, int tiles_per_row, int n_col_chunks) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * (kReduceThreads / 32) + (threadIdx.x >> 5);
  const int col_chunk = (int)(gw % n_col_chunks);
  const long long rest = gw / n_col_chunks;
  const int tile = (int)(rest % tiles_per_row);
  const int b = (int)(rest / tiles_per_row);
  if (b >= batch) return;
  const int p0 = tile * kTile;
  const int nv = n_valid[b];
  if (p0 >= nv) return;  // warp-uniform
  const int count = min(kTile, nv - p0);
  const size_t bn = (size_t)b * n_points;

  // lane i holds sorted point p0 + i: its feature row, cell and label; the
  // cells just before and after the tile say whether its edge runs go on
  int my_row = 0, my_cell = -1, my_label = -1, edge_cell = -1;
  if (lane < count) {
    my_row = order[bn + p0 + lane];
    my_cell = sorted_cell[bn + p0 + lane];
    if (sorted_sem) my_label = sorted_sem[bn + p0 + lane];
  }
  if (lane == 30 && p0 > 0) edge_cell = sorted_cell[bn + p0 - 1];
  if (lane == 31 && p0 + count < nv) edge_cell = sorted_cell[bn + p0 + count];
  const int first_cell = __shfl_sync(kFull, my_cell, 0);
  const int last_cell = __shfl_sync(kFull, my_cell, count - 1);
  const bool first_shared = __shfl_sync(kFull, edge_cell, 30) == first_cell;
  const bool last_shared = __shfl_sync(kFull, edge_cell, 31) == last_cell;

  const int ch = col_chunk * kWarpCh + lane * kLaneCh;
  const bool feat_lane = ch < feat_dim;  // feat_dim % 8 == 0
  const bool extra_lane = !feat_lane && ch < out_stride;
  const bool warp_feats = __any_sync(kFull, feat_lane);
  float* out_b = out + (size_t)b * num_cells * out_stride + ch;
  float acc[kLaneCh];
#pragma unroll
  for (int j = 0; j < kLaneCh; ++j) acc[j] = 0.f;
  int cur = first_cell;
  bool first_run = true;

  // four batches of kUnroll points, double-buffered: the next batch's loads
  // are in flight while the current one is added
  Raw<T> buf0[kUnroll], buf1[kUnroll];
  auto load = [&](Raw<T>* buf, int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = __shfl_sync(kFull, my_row, j0 + u);
      if (feat_lane && j0 + u < count) buf[u] = load_raw(feats + (size_t)row * feat_dim + ch);
    }
  };
  auto add = [&](const Raw<T>* buf, int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      const int c = __shfl_sync(kFull, my_cell, j);
      const int s = __shfl_sync(kFull, my_label, j);
      if (j < count) {  // warp-uniform
        if (c != cur) {  // a run ends; only the first can go on before the tile
          if (ch < out_stride) flush(out_b + (size_t)cur * out_stride, acc, first_run && first_shared);
          cur = c;
          first_run = false;
        }
        if (feat_lane) add_raw(buf[u], acc);
        if (extra_lane) {  // column feat_dim + s counts label s, feat_dim + num_sem points
#pragma unroll
          for (int q = 0; q < kLaneCh; ++q) {
            const int col = ch + q - feat_dim;
            acc[q] += ((col == s && s < num_sem) || col == num_sem) ? 1.f : 0.f;
          }
        }
      }
    }
  };
  if (warp_feats) load(buf0, 0);
  if (warp_feats && count > kUnroll) load(buf1, kUnroll);
  add(buf0, 0);
  if (warp_feats && count > 2 * kUnroll) load(buf0, 2 * kUnroll);
  if (count > kUnroll) add(buf1, kUnroll);
  if (warp_feats && count > 3 * kUnroll) load(buf1, 3 * kUnroll);
  if (count > 2 * kUnroll) add(buf0, 2 * kUnroll);
  if (count > 3 * kUnroll) add(buf1, 3 * kUnroll);
  if (ch < out_stride) {
    flush(out_b + (size_t)cur * out_stride, acc, (first_run && first_shared) || last_shared);
  }
}

template <typename T>
cudaError_t launch_reduce(const bevbert::SplatArgs& a, cudaStream_t stream) {
  const int tiles = (a.n_points + kTile - 1) / kTile;
  const int col_chunks = (a.out_stride + kWarpCh - 1) / kWarpCh;
  const long long warps = (long long)a.batch * tiles * col_chunks;
  const int per_block = kReduceThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  splat_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      (const T*)a.feats, a.order, a.sorted_cell, a.sem ? a.sorted_sem : nullptr, a.n_valid,
      a.out, a.batch, a.n_points, a.feat_dim, a.num_sem, a.num_cells, a.out_stride, tiles,
      col_chunks);
  return cudaGetLastError();
}

}  // namespace

namespace bevbert {

cudaError_t launch_splat(const SplatArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n_points + kChunk - 1) / kChunk, a.batch);
  splat_hist_kernel<<<grid, kChunk, 0, stream>>>(a.cell, a.hist, a.n_points, a.num_cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splat_scatter_kernel<<<grid, kChunk, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch (a.feat_type) {
    case kSplatBF16: return launch_reduce<__nv_bfloat16>(a, stream);
    case kSplatF16: return launch_reduce<__half>(a, stream);
    case kSplatF32: return launch_reduce<float>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bevbert
