// K2: backward of the sequential 32x32-tile alpha blend, for Hopper (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/blend_seq.py::_bwd_kernel (the
// Pallas TPU kernel, launched there by _bwd_call) together with the XLA
// _epilogue that turns its moment rows into gradient rows. Given K1's packed
// table, K1's output `raw` and the cotangent of that output, it writes for
// every instance slot of every tile the 9 gradient rows of the packed table:
// d mean2d x, d mean2d y, d conic A, B, C, d opacity, d r, d g, d b.
//
// Per tile, it re-walks the forward chain front to back (the same arithmetic
// as K1, so T, alive and done repeat K1's bit for bit) and takes dL/dalpha
// from a running prefix, as the JAX kernel does:
//
//   tot    = r*g_r + g*g_g + b*g_b + T_final*g_t        (per pixel, from raw)
//   cdot   = r_i*g_r + g_i*g_g + b_i*g_b
//   prefix = prefix + w*cdot                             (w: blend weight)
//   dalpha = T*cdot - (tot - prefix)/(1 - a)             on blended pairs
//   dpow   = op*exp(power)*dalpha     (alpha taken as unclamped even where
//                                      the forward clamped it at 0.99: the
//                                      reference's quirk, kept on purpose)
//
// and sums over the tile's pixels, in the direct form of the 16x16 backward
// (blend_pallas.py::_bwd_kernel):
//
//   d mx = sum dpow*(-A*dx - B*dy)   d A = sum dpow*(-0.5*dx*dx)
//   d my = sum dpow*(-C*dy - B*dx)   d B = sum dpow*(-dx*dy)
//   d op = sum exp(power)*dalpha     d C = sum dpow*(-0.5*dy*dy)
//   d rgb = sum w*g_rgb
//
// Pairs that are not blended contribute exactly zero. The walk stops at the
// tile's deepest contributor (the largest n_contrib of its 1024 pixels) when
// n_contrib was tracked, else at tile_count; slots past the stop are left as
// the caller's zeros. The library is built with --fmad=false and uses the
// precise expf, as K1 is.
//
// Design: one 256-thread block per tile, 4 pixels per thread with K1's pixel
// mapping (p = threadIdx.x + 256*q). The tile's instances are staged through
// shared memory in batches of 128 columns of the (9, K) table. For each
// instance every thread adds its 4 pixels' 9 terms; a fixed __shfl_xor_sync
// butterfly sums them across the warp, and lane 0 stores the warp's partial
// in shared memory as [8 warps][9 rows][128 slots]. After the batch one
// thread per (row, slot) adds the 8 warp partials in a fixed order and stores
// the sum, coalesced. No atomics: the output repeats bit for bit. A warp
// skips the butterfly for an instance that none of its pixels blended
// (__any_sync), which is most of them past the pixels' early stops.
//
// What bounds it on an H100: arithmetic. Each (instance, pixel) pair up to
// the stop costs the forward recompute (~23 FP32 operations and one expf)
// and each blended pair ~38 more for the gradient terms, against 36 bytes of
// attributes per instance shared by 1024 pixels and 36 bytes of gradient
// rows per slot. The butterfly adds 45 shuffles per warp and instance where
// any pixel blended. chip_smoke.py works the bound out from each run's data.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;          // 1024 pixels per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kPix / kThreads;  // 4 pixels per thread
constexpr int kBatch = 128;                  // instances staged per batch
constexpr int kRows = 9;                     // x y A B C opacity r g b
constexpr unsigned kFull = 0xffffffffu;

// The float32 values of the JAX package's constants, bit for bit.
constexpr float kAlphaMax = 0x1.fae148p-1f;  // 0.99
constexpr float kAlphaMin = 0x1.010102p-8f;  // 1/255
constexpr float kStopT = 0x1.a36e2ep-14f;    // 1e-4

__global__ void __launch_bounds__(kThreads)
blend_seq_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ packed, long long k,
                     const float* __restrict__ raw,
                     const float* __restrict__ cot, int tiles_x,
                     int track_contrib, float* __restrict__ grad) {
  __shared__ float batch[kRows][kBatch];
  __shared__ float part[kWarps][kRows][kBatch];
  __shared__ int warp_max[kWarps];

  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* res = raw + static_cast<long long>(t) * 5 * kPix;
  const float* ct = cot + static_cast<long long>(t) * 5 * kPix;
  float px[kPerThread], py[kPerThread], trans[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread];
  float tot[kPerThread], prefix[kPerThread];
  bool done[kPerThread];
  int deepest = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = threadIdx.x + q * kThreads;
    px[q] = static_cast<float>(tx * kTile + p % kTile);
    py[q] = static_cast<float>(ty * kTile + p / kTile);
    gr[q] = ct[0 * kPix + p];
    gg[q] = ct[1 * kPix + p];
    gb[q] = ct[2 * kPix + p];
    tot[q] = res[0 * kPix + p] * gr[q] + res[1 * kPix + p] * gg[q] +
             res[2 * kPix + p] * gb[q] + res[3 * kPix + p] * ct[3 * kPix + p];
    deepest = max(deepest, static_cast<int>(res[4 * kPix + p]));
    trans[q] = 1.f;
    prefix[q] = 0.f;
    done[q] = false;
  }

  int limit = count;
  if (track_contrib) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      deepest = max(deepest, __shfl_xor_sync(kFull, deepest, off));
    if (lane == 0) warp_max[warp] = deepest;
    __syncthreads();
    deepest = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) deepest = max(deepest, warp_max[w]);
    limit = min(count, deepest);
  }

  for (int base = 0; base < limit; base += kBatch) {
    const int nb = min(kBatch, limit - base);
    __syncthreads();  // the previous batch's buffers are consumed
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
      float acc[kRows];
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = 0.f;
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const float dx = mx - px[q];
        const float dy = my - py[q];
        const float power =
            -0.5f * (ca * (dx * dx) + cc * (dy * dy)) - cbc * (dx * dy);
        const float gexp = expf(power);
        const float opg = op * gexp;
        const float alpha = fminf(kAlphaMax, opg);
        const float a = (power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
        const float cdot = r * gr[q] + g * gg[q] + b * gb[q];
        const float ta = trans[q] * a;
        const float t_new = trans[q] - ta;
        const bool alive = t_new >= kStopT && !done[q];
        const bool blended = alive && a > 0.f;
        const float w = blended ? ta : 0.f;
        prefix[q] = prefix[q] + w * cdot;
        if (blended) {
          const float dalpha =
              trans[q] * cdot - (tot[q] - prefix[q]) / (1.f - a);
          const float dpow = opg * dalpha;
          acc[0] = acc[0] + dpow * (-ca * dx - cbc * dy);
          acc[1] = acc[1] + dpow * (-cc * dy - cbc * dx);
          acc[2] = acc[2] + dpow * (-0.5f * dx * dx);
          acc[3] = acc[3] + dpow * (-dx * dy);
          acc[4] = acc[4] + dpow * (-0.5f * dy * dy);
          acc[5] = acc[5] + gexp * dalpha;
          acc[6] = acc[6] + w * gr[q];
          acc[7] = acc[7] + w * gg[q];
          acc[8] = acc[8] + w * gb[q];
          any = true;
        }
        if (alive) trans[q] = t_new;
        if (t_new < kStopT) done[q] = true;
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int row = 0; row < kRows; ++row) {
          float v = acc[row];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v = v + __shfl_xor_sync(kFull, v, off);
          acc[row] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int row = 0; row < kRows; ++row) part[warp][row][j] = acc[row];
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < kRows * kBatch; idx += kThreads) {
      const int row = idx / kBatch;
      const int j = idx % kBatch;
      if (j < nb) {
        float s = part[0][row][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s = s + part[w][row][j];
        grad[row * k + start + base + j] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (9, k) float32
// row-major; raw, cot: (num_tiles, 5, 1024) float32 (cot's row 4 is not
// read); grad: (9, k) float32, zero-filled by the caller (slots past each
// tile's stop are not written). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int blend_seq_bwd(const void* tile_start, const void* tile_count,
                  const void* packed, long long k, const void* raw,
                  const void* cot, int num_tiles, int tiles_x,
                  int track_contrib, void* grad, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_seq_bwd_kernel<<<num_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, static_cast<const float*>(raw),
      static_cast<const float*>(cot), tiles_x, track_contrib,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

const char* blend_seq_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
