// K1: forward of the sequential 32x32-tile alpha blend, for Hopper (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/blend_seq.py::_fwd_kernel (the
// Pallas TPU kernel, launched there by _fwd_call). Same contract: for each
// 32x32 tile, blend the tile's depth-sorted instances front to back and
// write per pixel rgb, the final transmittance T and n_contrib (the 1-based
// index of the last contributor, as float):
//
//   dx = mx - px, dy = my - py         (pixel positions are integers)
//   power = -0.5*(A*dx*dx + C*dy*dy) - B*dx*dy
//   alpha = min(0.99, op*exp(power)); skipped when power > 0 or < 1/255
//   t_new = T - T*alpha; the instance blends while t_new >= 1e-4 and the
//   pixel is not done; T freezes at its last value >= 1e-4; the pixel is
//   done once t_new < 1e-4.
//
// Operation order follows the JAX kernel, and the library is built with
// --fmad=false, so no a*b+c is contracted into an FMA: each step rounds as
// the JAX kernel and the plain PyTorch version (ops/blend_seq.py) do. expf
// is the full-precision one (no fast math).
//
// Design: one 256-thread block per tile, each thread owning 4 pixels
// (p = threadIdx.x + 256*q: a warp covers one 32-pixel row, so the output
// stores coalesce). The tile's instances are staged through shared memory
// in batches of 128 columns of the (9, K) packed table (coalesced row
// loads); every thread then walks the batch in order, reading each
// instance's 9 attributes as shared-memory broadcasts. Before each batch,
// __syncthreads_count ends the block once all 1024 pixels are done (the
// TPU kernel's early exit); the same barrier also guards the batch buffer.
// The walk stops at tile_count: the aligned padding slots after it hold the
// zero sentinel column and would be no-ops.
//
// What bounds it on an H100: arithmetic. Each (instance, pixel) pair that a
// live pixel visits costs about 22 FP32 operations and one expf, against
// 9*4 bytes of attributes per instance shared by 1024 pixels and 20 bytes
// of output per pixel, so the bytes are ~1000x below the FP32 work (the
// bound is worked out from each run's data in chip_smoke.py). Threads of a
// block keep walking until every pixel of the tile is done, and threads
// whose pixels are done idle within their warp: later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;          // 1024 pixels per tile
constexpr int kThreads = 256;
constexpr int kPerThread = kPix / kThreads;  // 4 pixels per thread
constexpr int kBatch = 128;                  // instances staged per batch
constexpr int kRows = 9;                     // x y A B C opacity r g b

// The float32 values of the JAX package's constants, bit for bit.
constexpr float kAlphaMax = 0x1.fae148p-1f;  // 0.99
constexpr float kAlphaMin = 0x1.010102p-8f;  // 1/255
constexpr float kStopT = 0x1.a36e2ep-14f;    // 1e-4

__global__ void __launch_bounds__(kThreads)
blend_seq_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ packed, long long k,
                     int tiles_x, int track_contrib,
                     float* __restrict__ out) {
  __shared__ float batch[kRows][kBatch];

  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;

  float px[kPerThread], py[kPerThread], trans[kPerThread];
  float cr[kPerThread], cg[kPerThread], cb[kPerThread], last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    px[q] = static_cast<float>(tx * kTile + p % kTile);
    py[q] = static_cast<float>(ty * kTile + p / kTile);
    trans[q] = 1.f;
    cr[q] = cg[q] = cb[q] = last[q] = 0.f;
    done[q] = false;
  }

  for (int base = 0; base < count; base += kBatch) {
    int live = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) live |= !done[q];
    if (__syncthreads_count(live) == 0) break;

    const int nb = min(kBatch, count - base);
    for (int idx = threadIdx.x; idx < kRows * kBatch; idx += kThreads) {
      const int row = idx / kBatch;
      const int j = idx % kBatch;
      const long long col = start + base + j;
      batch[row][j] = (j < nb && col < k) ? packed[row * k + col] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < nb; ++j) {
      const float mx = batch[0][j];
      const float my = batch[1][j];
      const float ca = batch[2][j];
      const float cbc = batch[3][j];
      const float cc = batch[4][j];
      const float op = batch[5][j];
      const float r = batch[6][j];
      const float g = batch[7][j];
      const float b = batch[8][j];
      const float idx1 = static_cast<float>(base + j + 1);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const float dx = mx - px[q];
        const float dy = my - py[q];
        const float power =
            -0.5f * (ca * (dx * dx) + cc * (dy * dy)) - cbc * (dx * dy);
        const float alpha = fminf(kAlphaMax, op * expf(power));
        const float a = (power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
        const float ta = trans[q] * a;
        const float t_new = trans[q] - ta;
        const bool alive = t_new >= kStopT && !done[q];
        const float w = alive ? ta : 0.f;
        cr[q] = cr[q] + w * r;
        cg[q] = cg[q] + w * g;
        cb[q] = cb[q] + w * b;
        if (alive && a > 0.f) last[q] = idx1;
        if (alive) trans[q] = t_new;
        if (t_new < kStopT) done[q] = true;
      }
    }
  }

  float* o = out + static_cast<long long>(t) * 5 * kPix;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    o[0 * kPix + p] = cr[q];
    o[1 * kPix + p] = cg[q];
    o[2 * kPix + p] = cb[q];
    o[3 * kPix + p] = trans[q];
    o[4 * kPix + p] = track_contrib ? last[q] : 0.f;
  }
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (9, k) float32
// row-major; out: (num_tiles, 5, 1024) float32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int blend_seq_fwd(const void* tile_start, const void* tile_count,
                  const void* packed, long long k, int num_tiles, int tiles_x,
                  int track_contrib, void* out, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_seq_fwd_kernel<<<num_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, tiles_x, track_contrib,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* blend_seq_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
