// Binning's expansion (binning.cu's first three launches): each Gaussian's
// kept instances, keyed for the sort, written at their kept rank.
//
// Replaces the expansion of ops/binning.py::bin_gaussians_reference (the
// plain version), which the JAX package's ops/binning.py builds from TPU
// layout devices (a single-column scatter, a barrel-shift run gather, a
// blocked cumsum) and the eager port ran as ~100 int64 passes over every
// slot of `capacity`, empty ones included: an owner search, six gathers by
// gid, the cull, the keys. Here the work follows the Gaussians and their kept
// instances, in three launches over blocks of kGaussians Gaussians:
//   1. raw_parts: each block's sum of tiles_touched (and, for "dense", of the
//      instances past dense_cap);
//   2. count: each Gaussian's raw start (the sum of the blocks before it,
//      then a block scan), its instances inside the expansion domain
//      (binning_common.cuh: in_domain) and how many of them the precise cull
//      keeps (walk), written as gcount; each block's kept sum;
//   3. write: each Gaussian's kept start (gstart) the same way, then the key
//      and the gid of each kept instance at its kept rank (eid).
// A block finds the sum of the blocks before it by reading their partial
// sums (n / kGaussians of them, 2,442 at 5M Gaussians, from L2), so no
// launch scans them. The last block writes the call's counts to `stats`
// (binning.cu) and `live`, the sort's item count, as int32.
//
// A Gaussian is one thread's; the block's Gaussians are striped (thread t
// takes g = base + k * kThreads + t), so each load, and each run of writes,
// is contiguous across a warp. Operation order and rounding are the plain
// version's (binning_common.cuh), so the keep decisions, keys and counts are
// its bits.
//
// What bounds it on an H100: bytes. It reads each Gaussian's tiles_touched
// three times, its rect twice and, under precise_cull, its conic, opacity
// and centre twice (~48 B at most), and writes 12 B (8 B key, 4 B gid) per
// kept instance and 8 B per Gaussian: ~0.4 GB at 5M Gaussians and 6.2M kept
// instances, ~0.12 ms at 3.35 TB/s.

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include <cstdint>

#include "binning_common.cuh"

namespace binning_kernels::expansion {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kGaussians = kThreads * kPerThread;  // a block's Gaussians

using Reduce = cub::BlockReduce<long long, kThreads>;
using Scan = cub::BlockScan<long long, kThreads>;

union Temp {
  Reduce::TempStorage reduce;
  Scan::TempStorage scan;
};

struct Inputs {
  const int* tiles;  // tiles_touched
  const int* rect_min;
  const int* rect_max;
  const float* depths;
  const float* conic;
  const float* opacity;
  const float* means2d;
};

// The sum of part[0, end) over the block, in every thread.
__device__ long long sum_before(const long long* part, int end, Temp& tmp,
                                long long& out) {
  long long v = 0;
  for (int i = threadIdx.x; i < end; i += kThreads) v += part[i];
  v = Reduce(tmp.reduce).Sum(v);
  if (threadIdx.x == 0) out = v;
  __syncthreads();
  v = out;
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
    raw_parts_kernel(const int* tiles, Settings s, long long* raw_part,
                     long long* trunc_part) {
  __shared__ Temp tmp;
  const long long base = static_cast<long long>(blockIdx.x) * kGaussians;
  long long raw = 0, trunc = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const long long g = base + k * kThreads + threadIdx.x;
    if (g < s.n) {
      const int t = tiles[g];
      raw += t;
      trunc += max(t - s.dense_cap, 0);
    }
  }
  raw = Reduce(tmp.reduce).Sum(raw);
  __syncthreads();
  trunc = Reduce(tmp.reduce).Sum(trunc);
  if (threadIdx.x == 0) {
    raw_part[blockIdx.x] = raw;
    trunc_part[blockIdx.x] = trunc;
  }
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(Inputs in, Settings s, const long long* raw_part,
                 const long long* trunc_part, int* gcount,
                 long long* kept_part, long long* stats) {
  __shared__ Temp tmp;
  __shared__ long long bcast;
  const long long base = static_cast<long long>(blockIdx.x) * kGaussians;
  long long start = sum_before(raw_part, blockIdx.x, tmp, bcast);
  long long kept_sum = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const long long g = base + k * kThreads + threadIdx.x;
    const int t = g < s.n ? in.tiles[g] : 0;
    long long before, all;
    Scan(tmp.scan).ExclusiveSum(static_cast<long long>(t), before, all);
    __syncthreads();
    if (g < s.n) {
      const int count = in_domain(t, start + before, s);
      int kept = count;
      if (s.cull && count > 0) {
        const Gaussian q = gaussian(
            g, in.rect_min, in.rect_max, in.conic, in.opacity, in.means2d, s);
        kept = walk(q, count, s, [](int, int) {});
      }
      gcount[g] = kept;
      kept_sum += kept;
    }
    start += all;
  }
  kept_sum = Reduce(tmp.reduce).Sum(kept_sum);
  if (threadIdx.x == 0) kept_part[blockIdx.x] = kept_sum;
  __syncthreads();
  if (blockIdx.x == gridDim.x - 1) {
    // `start` is now the raw demand of every block
    const long long trunc =
        s.dense ? sum_before(trunc_part, gridDim.x, tmp, bcast)
                : (start > s.capacity ? start - s.capacity : 0);
    if (threadIdx.x == 0) {
      stats[0] = start;
      stats[1] = trunc;
    }
  }
}

template <class Key>
__global__ void __launch_bounds__(kThreads)
    write_kernel(Inputs in, Settings s, const long long* raw_part,
                 const long long* kept_part, const int* gcount, int* gstart,
                 Key* keys, int* gid_of, long long* stats, int* live) {
  __shared__ Temp tmp;
  __shared__ long long bcast;
  const long long base = static_cast<long long>(blockIdx.x) * kGaussians;
  long long start = sum_before(raw_part, blockIdx.x, tmp, bcast);
  long long kstart = sum_before(kept_part, blockIdx.x, tmp, bcast);
  for (int k = 0; k < kPerThread; ++k) {
    const long long g = base + k * kThreads + threadIdx.x;
    const bool in_n = g < s.n;
    const int t = in_n ? in.tiles[g] : 0;
    const int kept = in_n ? gcount[g] : 0;
    long long before, all, kbefore, kall;
    Scan(tmp.scan).ExclusiveSum(static_cast<long long>(t), before, all);
    __syncthreads();
    Scan(tmp.scan).ExclusiveSum(static_cast<long long>(kept), kbefore, kall);
    __syncthreads();
    if (in_n) {
      const long long at = kstart + kbefore;
      gstart[g] = static_cast<int>(at);
      if (kept > 0) {
        const int count = in_domain(t, start + before, s);
        const Gaussian q = gaussian(
            g, in.rect_min, in.rect_max, in.conic, in.opacity, in.means2d, s);
        const uint32_t bits = __float_as_uint(in.depths[g]);
        const int gid = static_cast<int>(g);
        walk(q, count, s, [&](int j, int tile) {
          keys[at + j] = sort_key<Key>(tile, bits, s.tile_shift);
          gid_of[at + j] = gid;
        });
      }
    }
    start += all;
    kstart += kall;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    stats[2] = kstart;
    *live = static_cast<int>(kstart);
  }
}

}  // namespace binning_kernels::expansion
