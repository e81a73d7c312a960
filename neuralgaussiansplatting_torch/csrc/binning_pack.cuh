// Binning's ranges and re-pack (binning.cu's last three launches): the
// sorted instances' per-tile runs, their 128-aligned segments, and the
// packed slots.
//
// Replaces the tail of ops/binning.py::bin_gaussians_reference (the plain
// version): two searchsorted calls over the sorted domain, the segment
// cumsums and drop, and a searchsorted owner lookup and gathers over every
// packed slot (the JAX package's ops/binning.py builds the same from a
// blocked cumsum and a barrel-shift gather). Three launches:
//   1. bounds: one thread a tile t in [0, num_tiles], the first sorted
//      place whose tile (the key's top bits) is t or more, a binary search
//      (tile_lo; tile t's run is [tile_lo[t], tile_lo[t + 1]));
//   2. ranges, one block over the tiles: each tile's count (capped at
//      max_per_tile), its segment rounded up to `align`, the conservative
//      whole-tile drop where the segments' running end passes
//      packed_capacity, the aligned starts, and the monitors (num_rendered,
//      max_tile_load, aligned_demand, dropped, culled as int32, the plain
//      version's casts of its int64 values);
//   3. pack: each packed slot finds its tile (the last whose aligned start is
//      at or before it, a binary search), and takes the eid of the sorted
//      place it maps to and that instance's gid, or the padding (n, the
//      domain) past the tile's count.
//
// What bounds it on an H100: bytes. The pack writes 9 B a packed slot and
// reads 8 B a valid one (its eid and the gid table): ~0.13 GB at 6.2M
// instances and 8.4M slots, ~40 us at 3.35 TB/s. Its gid reads land at
// random (eids in depth order within a tile), a 32 B sector each where the
// table outgrows L2. The bounds (~23 dependent
// reads a tile) and the ranges block (~1,100 tiles, two block scans) are
// latency.

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include <cstdint>

namespace binning_kernels::pack {

constexpr int kThreads = 256;
constexpr int kRangeThreads = 512;

using Scan = cub::BlockScan<long long, kRangeThreads>;
using Reduce = cub::BlockReduce<long long, kRangeThreads>;

struct Max {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

template <class Key>
__global__ void __launch_bounds__(kThreads)
    bounds_kernel(const Key* keys, const int* live, int tile_shift,
                  int num_tiles, int* tile_lo) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > num_tiles) return;
  int lo = 0, hi = *live;
  while (lo < hi) {
    const int mid = static_cast<int>((static_cast<long long>(lo) + hi) >> 1);
    if ((static_cast<unsigned long long>(keys[mid]) >> tile_shift) <
        static_cast<unsigned long long>(t)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  tile_lo[t] = lo;
}

__global__ void __launch_bounds__(kRangeThreads)
    ranges_kernel(const int* tile_lo, int num_tiles,
                  long long packed_capacity, int max_per_tile, int align,
                  long long* stats, int* tile_start, int* tile_count,
                  int* monitors) {
  __shared__ union {
    Scan::TempStorage scan;
    Reduce::TempStorage reduce;
  } tmp;
  long long demand = 0, used = 0, load = 0, kept = 0;
  for (int at = 0; at < num_tiles; at += kRangeThreads) {
    const int t = at + threadIdx.x;
    const long long raw = t < num_tiles ? tile_lo[t + 1] - tile_lo[t] : 0;
    long long count = min(raw, static_cast<long long>(max_per_tile));
    long long seg = (count + align - 1) / align * align;
    long long end, all;
    Scan(tmp.scan).InclusiveSum(seg, end, all);
    __syncthreads();
    if (demand + end > packed_capacity) count = seg = 0;
    demand += all;
    long long start;
    Scan(tmp.scan).ExclusiveSum(seg, start, all);
    __syncthreads();
    if (t < num_tiles) {
      tile_start[t] = static_cast<int>(used + start);
      tile_count[t] = static_cast<int>(count);
    }
    used += all;
    load = max(load, raw);
    kept += count;
  }
  load = Reduce(tmp.reduce).Reduce(load, Max());
  __syncthreads();
  kept = Reduce(tmp.reduce).Sum(kept);
  if (threadIdx.x == 0) {
    const long long rendered = stats[0], trunc = stats[1], total = stats[2];
    stats[3] = used;
    monitors[0] = static_cast<int>(rendered);
    monitors[1] = static_cast<int>(load);
    monitors[2] = static_cast<int>(demand);
    monitors[3] = static_cast<int>(total + trunc - kept);
    monitors[4] = static_cast<int>(rendered - trunc - total);
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const int* sorted_eid, const int* gid_of,
                const int* tile_start, const int* tile_count,
                const int* tile_lo, const long long* stats, int num_tiles,
                long long packed_capacity, int n, int domain, int* gid,
                bool* valid, int* eid) {
  const long long slot = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (slot >= packed_capacity) return;
  bool ok = false;
  int e = domain;
  if (slot < stats[3]) {
    int lo = 0, hi = num_tiles;  // the first tile starting past the slot
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_start[mid] <= slot) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int t = lo - 1;
    const long long src = slot + tile_lo[t] - tile_start[t];
    ok = src < tile_lo[t] + tile_count[t];
    if (ok) e = sorted_eid[src];
  }
  valid[slot] = ok;
  eid[slot] = e;
  gid[slot] = ok ? gid_of[e] : n;
}

}  // namespace binning_kernels::pack
