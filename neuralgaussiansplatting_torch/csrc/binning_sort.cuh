// Binning's sort (binning.cu's middle launches, and its `radix_sort`
// entry): a stable LSD radix sort of (key, eid) pairs over only the bits the
// keys span, its item count read on the device.
//
// Replaces the stable torch.sort of ops/binning.py::bin_gaussians_reference
// (the plain version): an int64 key and int64 indices over every slot of
// the expansion domain, whatever the kept count (the JAX package's
// ops/binning.py sorts the same domain with lax.sort). The kept count is a
// device value (binning_expand.cuh's `live`), so every launch is sized on the
// domain and each block reads the count and returns when its tile lies past
// it: no host read, and no work past the kept instances. A call sorts
// `bits` key bits in ceil(bits / 8) passes of 8-bit digits (42 bits and 6
// passes for the exact key at 41 x 27 tiles, 31 bits and 4 for the packed
// one); each pass is three launches:
//   1. upsweep: each block's digit counts over its tile of kTile items;
//   2. scan: one block a digit, the exclusive sum of that digit's counts
//      over the blocks, and the digit's total;
//   3. downsweep: each block ranks its items by digit, stably (per warp with
//      __match_any_sync, then across the warps), stages them in shared
//      memory in digit order and writes each digit's run at its global
//      start: the digits before it (a block scan of the totals) plus the
//      same digit in the blocks before it.
// Pass p reads buffer p % 2 and writes the other, so the result lies in
// keys_a / vals_a after an even number of passes and in keys_b / vals_b
// after an odd one. The first pass takes the item's index as its value
// (vals_a is not read): the eid of an instance is its kept rank.
//
// Stability: a block's items are ranked in the order (warp, item, lane),
// which is their index order (warp w holds items [w, w + 1) * 32 * kItems,
// item k of lane l at k * 32 + l), and blocks take their digit's places in
// block order. Equal keys keep expansion order, as torch.sort(stable=True).
//
// What bounds it on an H100: bytes. A pass reads and writes each pair once
// (12 B each way with 8 B keys, 8 B with 4 B keys) and the upsweep reads the
// keys again: 6 passes over 6.2M pairs move ~1.2 GB, ~0.36 ms at 3.35 TB/s.
// The per-(digit, block) counts are 256 x (domain / kTile) int32 (~4 MB at 8M
// slots), read and written by the scan from L2. The downsweep runs at about
// the per-pass time of CUB's onesweep sort (torch.sort); a tile of 4096 items
// (better-coalesced runs) measured no faster at garden and slower at 300k.

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_scan.cuh>

#include <cstdint>

namespace binning_kernels::radix {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;  // == kThreads: thread d owns digit d
static_assert(kRadix == kThreads, "one thread per digit");

using Scan = cub::BlockScan<int, kThreads>;

template <class Key>
__device__ __forceinline__ int digit(Key key, int shift) {
  return static_cast<int>((key >> shift) & (kRadix - 1));
}

template <class Key>
__global__ void __launch_bounds__(kThreads)
    upsweep_kernel(const Key* keys, const int* live, int shift, int stride,
                   int* counts) {
  const int n = *live;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (base >= n) return;
  __shared__ int hist[kRadix];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = base + warp * 32 * kItems + lane;
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k * 32;
    const int d = i < n ? digit(keys[i], shift) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < kRadix && lane == __ffs(peers) - 1)
      atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  counts[threadIdx.x * stride + blockIdx.x] = hist[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const int* live, int stride, int* counts, int* totals) {
  const int n = *live;
  const int blocks = (n + kTile - 1) / kTile;
  int* row = counts + static_cast<long long>(blockIdx.x) * stride;
  __shared__ Scan::TempStorage tmp;
  int carry = 0;
  for (int at = 0; at < blocks; at += kThreads * 4) {
    int v[4], before[4];
    for (int j = 0; j < 4; ++j) {
      const int i = at + threadIdx.x * 4 + j;
      v[j] = i < blocks ? row[i] : 0;
    }
    int all;
    Scan(tmp).ExclusiveSum(v, before, all);
    __syncthreads();
    for (int j = 0; j < 4; ++j) {
      const int i = at + threadIdx.x * 4 + j;
      if (i < blocks) row[i] = carry + before[j];
    }
    carry += all;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <class Key, bool kIota>
__global__ void __launch_bounds__(kThreads)
    downsweep_kernel(const Key* keys_in, const int* vals_in, Key* keys_out,
                     int* vals_out, const int* live, int shift, int stride,
                     const int* counts, const int* totals) {
  const int n = *live;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (base >= n) return;
  __shared__ Key skeys[kTile];
  __shared__ int svals[kTile];
  __shared__ int wcount[kWarps][kRadix + 1];  // + the past-the-end digit
  __shared__ int dstart[kRadix];  // the digit's first place in the tile
  __shared__ long long dglobal[kRadix];  // global place of the tile's place 0
  __shared__ Scan::TempStorage tmp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * (kRadix + 1); i += kThreads)
    (&wcount[0][0])[i] = 0;

  Key key[kItems];
  int val[kItems], dig[kItems], rank[kItems];
  const long long first = base + warp * 32 * kItems + lane;
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + k * 32;
    if (i < n) {
      key[k] = keys_in[i];
      val[k] = kIota ? static_cast<int>(i) : vals_in[i];
      dig[k] = digit(key[k], shift);
    } else {
      dig[k] = kRadix;
    }
  }
  __syncthreads();

  // rank within the warp, item by item: lanes of one digit share its count
  const unsigned below = (1u << lane) - 1u;
  for (int k = 0; k < kItems; ++k) {
    const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
    const int seen = wcount[warp][dig[k]];
    __syncwarp();
    if (lane == __ffs(peers) - 1) wcount[warp][dig[k]] = seen + __popc(peers);
    __syncwarp();
    rank[k] = seen + __popc(peers & below);
  }
  __syncthreads();

  // thread d: digit d's places before each warp, and in the tile
  const int d = threadIdx.x;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = wcount[w][d];
    wcount[w][d] = total;
    total += c;
  }
  int in_tile;
  Scan(tmp).ExclusiveSum(total, in_tile);
  __syncthreads();
  int digits_before;
  Scan(tmp).ExclusiveSum(totals[d], digits_before);
  dstart[d] = in_tile;
  dglobal[d] = static_cast<long long>(digits_before) +
               counts[static_cast<long long>(d) * stride + blockIdx.x] -
               in_tile;
  __syncthreads();

  for (int k = 0; k < kItems; ++k) {
    if (dig[k] < kRadix) {
      const int at = dstart[dig[k]] + wcount[warp][dig[k]] + rank[k];
      skeys[at] = key[k];
      svals[at] = val[k];
    }
  }
  __syncthreads();

  const int m = static_cast<int>(min(static_cast<long long>(kTile), n - base));
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const Key k = skeys[i];
    const long long to = dglobal[digit(k, shift)] + i;
    keys_out[to] = k;
    vals_out[to] = svals[i];
  }
}

template <class Key>
void sort_pairs(Key* keys_a, Key* keys_b, int* vals_a, int* vals_b,
                int* counts, int* totals, const int* live, unsigned grid,
                int passes, cudaStream_t st) {
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kBits;
    const bool even = p % 2 == 0;
    const Key* kin = even ? keys_a : keys_b;
    Key* kout = even ? keys_b : keys_a;
    const int* vin = even ? vals_a : vals_b;
    int* vout = even ? vals_b : vals_a;
    const int stride = static_cast<int>(grid);
    upsweep_kernel<Key><<<grid, kThreads, 0, st>>>(kin, live, shift, stride,
                                                   counts);
    scan_kernel<<<kRadix, kThreads, 0, st>>>(live, stride, counts, totals);
    if (p == 0) {
      downsweep_kernel<Key, true><<<grid, kThreads, 0, st>>>(
          kin, vin, kout, vout, live, shift, stride, counts, totals);
    } else {
      downsweep_kernel<Key, false><<<grid, kThreads, 0, st>>>(
          kin, vin, kout, vout, live, shift, stride, counts, totals);
    }
  }
}

}  // namespace binning_kernels::radix
