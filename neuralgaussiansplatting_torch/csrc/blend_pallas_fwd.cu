// K4: forward of the tile alpha blend at any tile shape, for Hopper (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/blend_pallas.py::_fwd_kernel (the
// Pallas TPU kernel, launched there by _fwd_call). Same contract: for each
// block_x x block_y tile (16x16 by default; 32x32 for a seq setting with
// another chunk; any shape up to 2048 pixels), blend the tile's depth-sorted
// instances front to back and write per pixel rgb, the final transmittance
// T and n_contrib (the 1-based index of the last blended instance, as
// float). Pixel p of tile t is at (tx*block_x + p % block_x,
// ty*block_y + p / block_x). The chunk that binning aligned the segments to
// changes nothing here: the kernel stages its own batches.
//
// The JAX kernel's arithmetic, with its association:
//
//   dx = mx - px, dy = my - py         (pixel positions are integers)
//   power = -0.5*((A*dx)*dx + (C*dy)*dy) - (B*dx)*dy
//   alpha = min(0.99, op*exp(power)); zero where power > 0 or < 1/255
//   T_i = T_{i-1} * (1 - alpha)        (the product form)
//   the instance blends while T_i >= 1e-4 and the pixel is not done, with
//   weight alpha*T_{i-1}; T freezes at its last value >= 1e-4; the pixel is
//   done once T_i < 1e-4.
//
// The TPU kernel forms T_i with a Hillis-Steele scan along the lane axis and
// defers its lane reductions to the end of the tile: layout devices of the
// TPU's vector unit. Here each thread carries the product and the colour
// sums of its pixels sequentially. The library is built with --fmad=false,
// so no a*b+c is contracted into an FMA and each step rounds as the plain
// PyTorch version (ops/blend_pallas.py) does; expf is the full-precision one.
//
// Design: one block per tile, min(256, pix rounded up to a warp) threads,
// each owning kPer pixels (p = threadIdx.x + blockDim.x*q: neighbouring
// threads own neighbouring pixels, so the output stores coalesce). kPer is
// a template argument (1, 2, 4 or 8) chosen by the launcher from the tile
// shape; pixel slots past the tile start done. The tile's instances are
// staged through shared memory in batches of 128 columns of the (9, K)
// packed table (coalesced row loads); every thread then walks the batch in
// order, reading each instance's 9 attributes as shared-memory broadcasts
// and skipping its pixels that are done. Before each batch,
// __syncthreads_count ends the block once every pixel is done (the TPU
// kernel's early exit); the same barrier guards the batch buffer. The walk
// stops at tile_count: the aligned padding slots after it hold the zero
// sentinel column and would be no-ops.
//
// What bounds it on an H100: arithmetic. Each (instance, pixel) pair that a
// live pixel visits costs 14 FP32 operations with one expf, and each blended
// pair 9 more, against 36 bytes of attributes per instance shared by the
// tile's pixels and 20 bytes of output per pixel (chip_smoke.py works the
// bound out from each run's data). Threads whose pixels are done idle within
// their warp until the whole block is done: later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBatch = 128;  // instances staged per batch
constexpr int kRows = 9;     // x y A B C opacity r g b

// The float32 values of the JAX package's constants, bit for bit.
constexpr float kAlphaMax = 0x1.fae148p-1f;  // 0.99
constexpr float kAlphaMin = 0x1.010102p-8f;  // 1/255
constexpr float kStopT = 0x1.a36e2ep-14f;    // 1e-4

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
blend_pallas_fwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        int tiles_x, int block_x, int block_y,
                        int track_contrib, float* __restrict__ out) {
  __shared__ float batch[kRows][kBatch];

  const int pix = block_x * block_y;
  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;

  float px[kPer], py[kPer], trans[kPer];
  float cr[kPer], cg[kPer], cb[kPer], last[kPer];
  bool done[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    px[q] = static_cast<float>(tx * block_x + p % block_x);
    py[q] = static_cast<float>(ty * block_y + p / block_x);
    trans[q] = 1.f;
    cr[q] = cg[q] = cb[q] = last[q] = 0.f;
    done[q] = p >= pix;
  }

  for (int base = 0; base < count; base += kBatch) {
    int live = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) live |= !done[q];
    if (__syncthreads_count(live) == 0) break;

    const int nb = min(kBatch, count - base);
    for (int idx = threadIdx.x; idx < kRows * kBatch; idx += blockDim.x) {
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
      for (int q = 0; q < kPer; ++q) {
        if (done[q]) continue;
        const float dx = mx - px[q];
        const float dy = my - py[q];
        const float power =
            -0.5f * ((ca * dx) * dx + (cc * dy) * dy) - (cbc * dx) * dy;
        const float alpha = fminf(kAlphaMax, op * expf(power));
        const float a = (power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
        const float t_new = trans[q] * (1.f - a);
        if (t_new < kStopT) {  // the instance that ends the pixel is not
          done[q] = true;      // blended, and T keeps its last value
          continue;
        }
        const float w = a * trans[q];
        cr[q] = cr[q] + w * r;
        cg[q] = cg[q] + w * g;
        cb[q] = cb[q] + w * b;
        if (a > 0.f) last[q] = idx1;
        trans[q] = t_new;
      }
    }
  }

  float* o = out + static_cast<long long>(t) * 5 * pix;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    if (p >= pix) continue;
    o[0 * pix + p] = cr[q];
    o[1 * pix + p] = cg[q];
    o[2 * pix + p] = cb[q];
    o[3 * pix + p] = trans[q];
    o[4 * pix + p] = track_contrib ? last[q] : 0.f;
  }
}

template <int kPer>
void launch(int num_tiles, int threads, cudaStream_t stream,
            const int* tile_start, const int* tile_count, const float* packed,
            long long k, int tiles_x, int block_x, int block_y,
            int track_contrib, float* out) {
  blend_pallas_fwd_kernel<kPer><<<num_tiles, threads, 0, stream>>>(
      tile_start, tile_count, packed, k, tiles_x, block_x, block_y,
      track_contrib, out);
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (9, k) float32
// row-major; out: (num_tiles, 5, block_x*block_y) float32. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tile of more than 2048 pixels.
int blend_pallas_fwd(const void* tile_start, const void* tile_count,
                     const void* packed, long long k, int num_tiles,
                     int tiles_x, int block_x, int block_y, int track_contrib,
                     void* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const int pix = block_x * block_y;
  const int threads = min(kMaxThreads, (pix + 31) / 32 * 32);
  const int per = (pix + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* tc = static_cast<const int*>(tile_count);
  const auto* pk = static_cast<const float*>(packed);
  auto* o = static_cast<float*>(out);
  if (per <= 1) {
    launch<1>(num_tiles, threads, s, ts, tc, pk, k, tiles_x, block_x, block_y,
              track_contrib, o);
  } else if (per <= 2) {
    launch<2>(num_tiles, threads, s, ts, tc, pk, k, tiles_x, block_x, block_y,
              track_contrib, o);
  } else if (per <= 4) {
    launch<4>(num_tiles, threads, s, ts, tc, pk, k, tiles_x, block_x, block_y,
              track_contrib, o);
  } else if (per <= 8) {
    launch<8>(num_tiles, threads, s, ts, tc, pk, k, tiles_x, block_x, block_y,
              track_contrib, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* blend_pallas_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
