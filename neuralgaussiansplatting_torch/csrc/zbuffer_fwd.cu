// K3: the tiled z-buffer of the neural-feature path, for Hopper (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/zbuffer_pallas.py::_zbuf_kernel
// (the Pallas TPU kernel, launched there by _zbuf_call). Same contract: for
// each 32x32 tile t and each pixel p of it, at (tx*32 + p%32, ty*32 + p/32),
// take the argmin of view depth over the tile's instances
// [tile_start[t], tile_start[t] + tile_count[t]) whose pixel rect
// [x0, x1) x [y0, y1) covers the pixel; equal depths go to the lower
// Gaussian id. Per pixel it writes the winner's id (-1 on a miss) and its
// depth (0 on a miss). A depth at or above kBig (3e38) never yields a hit,
// as in the JAX kernel, whose initial depth it is; NaN never wins; -0.0 and
// +0.0 are equal depths, and the output is the winner's own bits.
//
// Ids are int32. The TPU kernel carries them in a float32 lane, which is
// exact only below 2^24 Gaussians; here an id is the low word of a key.
//
// Design: a scatter into a per-pixel key array, so that the work scales
// with the covered (instance, pixel) pairs, not with instances x 1024. A
// footprint is a square of radius 3/depth px, a few pixels wide, so almost
// every pixel of a tile misses almost every instance of it: a test of every
// pixel against every instance of its tile spends nearly all its tests on
// misses. One 512-thread block per tile keeps a shared array of the tile's
// 1024 pixels' 64-bit keys, (order-preserving encoding of the depth's bits)
// << 32 | (gid ^ 2^31), initialised to all ones (a miss). Thread i takes
// the tile's instances i, i + 512, ... straight from device memory (its
// six loads issue together; a warp's rows are coalesced), clips the rect to
// the tile and walks its pixels with one shared atomicMin each, skipped
// where the key held is already lower. The minimum does not depend on the
// order of the updates, so the result is exact and repeats bit for bit
// whatever the order of a tile's instances. The encoding maps -0.0 and
// +0.0 to one key, so a tie between them goes to the lower id; in the rare
// tile where a hit has depth -0.0 a second walk marks the pixels whose
// winner is such an instance, and those write -0.0. Then each thread
// decodes 2 pixels (a warp one 32-pixel row: coalesced stores).
//
// What bounds it on an H100: bytes, 24 bytes of input per instance and 8
// bytes of output per pixel (the bound is worked out from each run's data
// in chip_smoke.py); the operations, a few per covered pair, are far below
// that. What is left is latency, and the densest tiles decide: at the
// neural workload (800x800, 100k Gaussians, 625 tiles of up to 725
// instances) the kernel spans ~10 us, its slowest blocks (600-700
// instances) ~9 us, the median block ~4.6 us (block stamps on an H100
// 80GB HBM3 at 700 W). 512 threads beat 256, 128 and 1024 there; a warp
// walking each large rect together, and a warp-wide scan that spreads the
// covered pairs over the lanes, did not pay.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;          // 1024 pixels per tile
constexpr int kThreads = 512;
constexpr int kPerThread = kPix / kThreads;  // 2 pixels per thread
constexpr int kBits = 32;                    // pixels per word of a mask
constexpr float kBig = 3.0e38f;              // the JAX kernel's BIG
constexpr unsigned kSign = 0x80000000u;
constexpr unsigned long long kMiss = ~0ull;  // no real key reaches it

// Order-preserving map of a float's bits to uint32 for every float below
// kBig that is not NaN: a < b as floats iff key(a) < key(b), and -0.0 and
// +0.0 share the key 0x7fffffff. (ops/zbuffer_pallas.py: depth_key.)
__device__ __forceinline__ unsigned depth_key(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & kSign) ? ~u : u + 0x7fffffffu;
}

// The inverse, with +0.0 for the zero key (ops/zbuffer_pallas.py:
// key_depth).
__device__ __forceinline__ float key_depth(unsigned k) {
  return __uint_as_float(k >= 0x7fffffffu ? k - 0x7fffffffu : ~k);
}

// One instance's rect clipped to the tile at (ox, oy), in tile-local
// pixels [x0, x0 + w) x [y0, y0 + h); w = h = 0 where it covers nothing.
struct Clip {
  int x0, y0, w, h;
};

__device__ __forceinline__ Clip clip_rect(const int* __restrict__ rects,
                                          long long k, long long col, int ox,
                                          int oy) {
  const int x0 = max(rects[col] - ox, 0);
  const int y0 = max(rects[k + col] - oy, 0);
  const int x1 = min(rects[2 * k + col] - ox, kTile);
  const int y1 = min(rects[3 * k + col] - oy, kTile);
  Clip c{x0, y0, x1 - x0, y1 - y0};
  if (c.w <= 0 || c.h <= 0) c.w = c.h = 0;
  return c;
}

__global__ void __launch_bounds__(kThreads)
zbuffer_fwd_kernel(const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   const int* __restrict__ rects,
                   const float* __restrict__ depth, long long k, int tiles_x,
                   int* __restrict__ out_gid, float* __restrict__ out_depth) {
  __shared__ unsigned long long s_key[kPix];
  __shared__ unsigned s_neg_zero[kPix / kBits];  // pixel bits: winner -0.0
  __shared__ int s_any_neg_zero;

  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int ox = (t % tiles_x) * kTile;
  const int oy = (t / tiles_x) * kTile;

#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    s_key[threadIdx.x + q * kThreads] = kMiss;
  }
  if (threadIdx.x < kPix / kBits) s_neg_zero[threadIdx.x] = 0u;
  if (threadIdx.x == 0) s_any_neg_zero = 0;
  __syncthreads();

  // thread i takes instances i, i + 512, ...: all six loads of an
  // instance issue together, then the walk over its clipped rect
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const long long col = start + j;
    if (col >= k) break;
    const float d = depth[col];
    const Clip c = clip_rect(rects, k, col, ox, oy);
    const unsigned g = static_cast<unsigned>(rects[4 * k + col]);
    if (!(d < kBig) || c.w == 0) continue;  // NaN, >= kBig, or no pixel
    const unsigned long long key =
        (static_cast<unsigned long long>(depth_key(d)) << 32) | (g ^ kSign);
    if (__float_as_uint(d) == kSign) s_any_neg_zero = 1;
    for (int y = c.y0; y < c.y0 + c.h; ++y) {
      for (int x = c.x0; x < c.x0 + c.w; ++x) {
        const int p = y * kTile + x;
        if (key < s_key[p]) atomicMin(&s_key[p], key);
      }
    }
  }
  __syncthreads();

  // a hit at -0.0 (never in a real view, where depth > 0.2): mark the
  // pixels whose winner it is, so they write the winner's own -0.0
  if (s_any_neg_zero) {
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const long long col = start + j;
      if (col >= k || __float_as_uint(depth[col]) != kSign) continue;
      const Clip c = clip_rect(rects, k, col, ox, oy);
      const unsigned long long key =
          (static_cast<unsigned long long>(depth_key(-0.0f)) << 32)
          | (static_cast<unsigned>(rects[4 * k + col]) ^ kSign);
      for (int y = c.y0; y < c.y0 + c.h; ++y) {
        for (int x = c.x0; x < c.x0 + c.w; ++x) {
          const int p = y * kTile + x;
          if (s_key[p] == key) {
            atomicOr(&s_neg_zero[p / kBits], 1u << (p % kBits));
          }
        }
      }
    }
    __syncthreads();
  }

  const long long o = static_cast<long long>(t) * kPix;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    const unsigned long long key = s_key[p];
    const bool miss = key == kMiss;
    const bool neg_zero = (s_neg_zero[p / kBits] >> (p % kBits)) & 1u;
    const unsigned hi = static_cast<unsigned>(key >> 32);
    out_gid[o + p] =
        miss ? -1 : static_cast<int>(static_cast<unsigned>(key) ^ kSign);
    out_depth[o + p] = miss ? 0.f : neg_zero ? -0.0f : key_depth(hi);
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
