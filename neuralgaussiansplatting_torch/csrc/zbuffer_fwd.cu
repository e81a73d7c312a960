// K3: the tiled z-buffer of the neural-feature path, for Hopper (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/zbuffer_pallas.py::_zbuf_kernel
// (the Pallas TPU kernel, launched there by _zbuf_call). Same contract: for
// each 32x32 tile t and each pixel p of it, at (tx*32 + p%32, ty*32 + p/32),
// take the argmin of view depth over the tile's instances
// [tile_start[t], tile_start[t] + tile_count[t]) whose pixel rect
// [x0, x1) x [y0, y1) covers the pixel; equal depths go to the lower
// Gaussian id. The test is explicit, d < dmin || (d == dmin && g < gwin), so
// the result does not depend on the order of the instances within a tile.
// Per pixel it writes the winner's id (-1 on a miss) and its depth (0 on a
// miss).
//
// Ids are int32. The TPU kernel carries them in a float32 lane, which is
// exact only below 2^24 Gaussians; here ids and pixel coordinates compare as
// integers, and only depths compare as floats (exactly, as the JAX kernel
// compares them). A depth at or above kBig (3e38) never yields a hit, as in
// the JAX kernel, whose initial depth it is.
//
// Design: one 256-thread block per tile, each thread owning 4 pixels
// (p = threadIdx.x + 256*q: a warp covers one 32-pixel row, so the output
// stores coalesce), as in K1. The tile's instances are staged through
// shared memory in batches of 128 columns of the (5, K) int32 rect table and
// the (K,) depths (coalesced row loads); every thread then tests the batch
// in order against its 4 pixels, reading each instance as shared-memory
// broadcasts. The walk stops at tile_count: the aligned padding slots after
// it hold the zero rect, which covers no pixel. Tiles with no instances
// write misses.
//
// What bounds it on an H100: operations. Every pixel of a tile is tested
// against every instance of the tile (a rect test, 4 compares and 3 ands,
// then the depth/id test and 2 selects), against 24 bytes of input per
// instance shared by 1024 pixels and 8 bytes of output per pixel (the bound
// is worked out from each run's data in chip_smoke.py). The rects are a few
// pixels wide, so almost every test misses: skipping instances by a warp's
// row span is later work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;          // 1024 pixels per tile
constexpr int kThreads = 256;
constexpr int kPerThread = kPix / kThreads;  // 4 pixels per thread
constexpr int kBatch = 128;                  // instances staged per batch
constexpr int kRectRows = 5;                 // x0 y0 x1 y1 gid
constexpr float kBig = 3.0e38f;              // the JAX kernel's BIG

__global__ void __launch_bounds__(kThreads)
zbuffer_fwd_kernel(const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   const int* __restrict__ rects,
                   const float* __restrict__ depth, long long k, int tiles_x,
                   int* __restrict__ out_gid, float* __restrict__ out_depth) {
  __shared__ int s_rect[kRectRows][kBatch];
  __shared__ float s_depth[kBatch];

  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;

  // every pixel of a thread shares its column; rows step by 8
  const int px = tx * kTile + threadIdx.x % kTile;
  int py[kPerThread];
  float dmin[kPerThread];
  int gwin[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    py[q] = ty * kTile + p / kTile;
    dmin[q] = kBig;
    gwin[q] = INT_MAX;
  }

  for (int base = 0; base < count; base += kBatch) {
    __syncthreads();  // the previous batch is no longer read
    const int nb = min(kBatch, count - base);
    for (int idx = threadIdx.x; idx < (kRectRows + 1) * kBatch;
         idx += kThreads) {
      const int row = idx / kBatch;
      const int j = idx % kBatch;
      const long long col = start + base + j;
      const bool in = j < nb && col < k;
      if (row < kRectRows) {
        s_rect[row][j] = in ? rects[row * k + col] : 0;
      } else {
        s_depth[j] = in ? depth[col] : 0.f;
      }
    }
    __syncthreads();

    for (int j = 0; j < nb; ++j) {
      const int x0 = s_rect[0][j];
      const int y0 = s_rect[1][j];
      const int x1 = s_rect[2][j];
      const int y1 = s_rect[3][j];
      const int g = s_rect[4][j];
      const float d = s_depth[j];
      const bool in_x = px >= x0 && px < x1;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const bool hit = in_x && py[q] >= y0 && py[q] < y1;
        const bool better =
            hit && (d < dmin[q] || (d == dmin[q] && g < gwin[q]));
        if (better) {
          dmin[q] = d;
          gwin[q] = g;
        }
      }
    }
  }

  const long long o = static_cast<long long>(t) * kPix;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    const bool miss = dmin[q] >= kBig;
    out_gid[o + p] = miss ? -1 : gwin[q];
    out_depth[o + p] = miss ? 0.f : dmin[q];
  }
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; rects: (5, k) int32 row-major
// (x0, y0, x1, y1, gid); depth: (k,) float32; out_gid: (num_tiles, 1024)
// int32; out_depth: (num_tiles, 1024) float32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int zbuffer_fwd(const void* tile_start, const void* tile_count,
                const void* rects, const void* depth, long long k,
                int num_tiles, int tiles_x, void* out_gid, void* out_depth,
                void* stream) {
  if (num_tiles <= 0) return 0;
  zbuffer_fwd_kernel<<<num_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(rects), static_cast<const float*>(depth), k,
      tiles_x, static_cast<int*>(out_gid), static_cast<float*>(out_depth));
  return static_cast<int>(cudaGetLastError());
}

const char* zbuffer_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
