// K5: backward of the tile alpha blend at any tile shape, for Hopper
// (sm_90a).
//
// Replaces neuralgaussiansplatting_tpu/ops/blend_pallas.py::_bwd_kernel (the
// Pallas TPU kernel, launched there by _bwd_call; it has no epilogue). Given
// K4's packed table, K4's output `raw` and the cotangent of that output, it
// writes for every instance slot of every tile the 9 gradient rows of the
// packed table: d mean2d x, d mean2d y, d conic A, B, C, d opacity, d r,
// d g, d b.
//
// Per tile, it re-walks K4's chain front to back (the same arithmetic, so T,
// alive and done repeat K4's bit for bit) and takes dL/dalpha from a running
// prefix, as the JAX kernel does, term for term:
//
//   total_dot = (r*g_r + g*g_g) + b*g_b         (per pixel, from raw)
//   tfin_gt   = T_final*g_t
//   cdot      = (r_i*g_r + g_i*g_g) + b_i*g_b
//   prefix    = prefix + w*cdot                 (w = alpha*T_{i-1})
//   suffix    = total_dot - prefix
//   dalpha    = T_{i-1}*cdot - (suffix + tfin_gt)/(1 - alpha)
//   dpow      = exp(power)*(op*dalpha)
//
// on the blended pairs (alive and alpha > 0; every other pair contributes
// exactly zero), with alpha taken as unclamped even where the forward
// clamped it at 0.99 (the reference's quirk, kept on purpose), and sums over
// the tile's pixels:
//
//   d mx = sum dpow*(-A*dx - B*dy)   d A = sum dpow*(-0.5*dx*dx)
//   d my = sum dpow*(-C*dy - B*dx)   d B = sum dpow*(-dx*dy)
//   d op = sum exp(power)*dalpha     d C = sum dpow*(-0.5*dy*dy)
//   d rgb = sum w*g_rgb
//
// The TPU kernel forms T and the prefix with lane scans and walks whole
// chunks; here each thread carries them sequentially. The walk stops at the
// tile's deepest contributor (the largest n_contrib of its pixels) when
// n_contrib was tracked, else at tile_count; slots past the stop are left
// as the caller's zeros. Built with --fmad=false and the precise expf, as
// K4 is.
//
// Design: K4's block shape and pixel mapping (min(256, pix rounded up to a
// warp) threads, kPer pixels each). The tile's instances are staged through
// shared memory in batches of 128 columns of the (9, K) table. For each
// instance every thread adds its pixels' 9 terms; a fixed __shfl_xor_sync
// butterfly sums them across the warp, and lane 0 stores the warp's partial
// in shared memory as [warp][row][slot]. After the batch one thread per
// (row, slot) adds the warp partials in a fixed order and stores the sum,
// coalesced. No atomics: the output repeats bit for bit. A warp skips the
// butterfly for an instance that none of its pixels blended (__any_sync).
//
// What bounds it on an H100: arithmetic. Each (instance, pixel) pair walked
// up to the stop while its pixel was not done costs K4's 14 FP32 operations
// with one expf, and each blended pair 49 more for T, the prefix and the
// gradient terms, against 36 bytes of attributes and 36 bytes of gradient
// rows per slot and 40 bytes of raw and cotangent per pixel
// (chip_smoke.py works the bound out from each run's data).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch = 128;  // instances staged per batch
constexpr int kRows = 9;     // x y A B C opacity r g b
constexpr unsigned kFull = 0xffffffffu;

// The float32 values of the JAX package's constants, bit for bit.
constexpr float kAlphaMax = 0x1.fae148p-1f;  // 0.99
constexpr float kAlphaMin = 0x1.010102p-8f;  // 1/255
constexpr float kStopT = 0x1.a36e2ep-14f;    // 1e-4

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
blend_pallas_bwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        const float* __restrict__ raw,
                        const float* __restrict__ cot, int tiles_x,
                        int block_x, int block_y, int track_contrib,
                        float* __restrict__ grad) {
  __shared__ float batch[kRows][kBatch];
  __shared__ float part[kMaxWarps][kRows][kBatch];
  __shared__ int warp_max[kMaxWarps];

  const int pix = block_x * block_y;
  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  const float* res = raw + static_cast<long long>(t) * 5 * pix;
  const float* ct = cot + static_cast<long long>(t) * 5 * pix;
  float px[kPer], py[kPer], trans[kPer];
  float gr[kPer], gg[kPer], gb[kPer];
  float total_dot[kPer], tfin_gt[kPer], prefix[kPer];
  bool done[kPer];
  int deepest = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    px[q] = static_cast<float>(tx * block_x + p % block_x);
    py[q] = static_cast<float>(ty * block_y + p / block_x);
    trans[q] = 1.f;
    prefix[q] = 0.f;
    done[q] = p >= pix;
    gr[q] = gg[q] = gb[q] = total_dot[q] = tfin_gt[q] = 0.f;
    if (p < pix) {
      gr[q] = ct[0 * pix + p];
      gg[q] = ct[1 * pix + p];
      gb[q] = ct[2 * pix + p];
      total_dot[q] = (res[0 * pix + p] * gr[q] + res[1 * pix + p] * gg[q]) +
                     res[2 * pix + p] * gb[q];
      tfin_gt[q] = res[3 * pix + p] * ct[3 * pix + p];
      deepest = max(deepest, static_cast<int>(res[4 * pix + p]));
    }
  }

  int limit = count;
  if (track_contrib) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      deepest = max(deepest, __shfl_xor_sync(kFull, deepest, off));
    if (lane == 0) warp_max[warp] = deepest;
    __syncthreads();
    deepest = 0;
    for (int w = 0; w < warps; ++w) deepest = max(deepest, warp_max[w]);
    limit = min(count, deepest);
  }

  for (int base = 0; base < limit; base += kBatch) {
    const int nb = min(kBatch, limit - base);
    __syncthreads();  // the previous batch's buffers are consumed
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
      float acc[kRows];
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = 0.f;
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (done[q]) continue;
        const float dx = mx - px[q];
        const float dy = my - py[q];
        const float power =
            -0.5f * ((ca * dx) * dx + (cc * dy) * dy) - (cbc * dx) * dy;
        const float gexp = expf(power);
        const float alpha = fminf(kAlphaMax, op * gexp);
        const float a = (power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
        const float one_minus = 1.f - a;
        const float t_new = trans[q] * one_minus;
        if (t_new < kStopT) {
          done[q] = true;
          continue;
        }
        if (a > 0.f) {
          const float w = a * trans[q];
          const float cdot = (r * gr[q] + g * gg[q]) + b * gb[q];
          prefix[q] = prefix[q] + w * cdot;
          const float suffix = total_dot[q] - prefix[q];
          const float dalpha =
              trans[q] * cdot - (suffix + tfin_gt[q]) / one_minus;
          const float dpow = gexp * (op * dalpha);
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
        trans[q] = t_new;
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

    for (int idx = threadIdx.x; idx < kRows * kBatch; idx += blockDim.x) {
      const int row = idx / kBatch;
      const int j = idx % kBatch;
      if (j < nb) {
        float s = part[0][row][j];
        for (int w = 1; w < warps; ++w) s = s + part[w][row][j];
        grad[row * k + start + base + j] = s;
      }
    }
  }
}

template <int kPer>
void launch(int num_tiles, int threads, cudaStream_t stream,
            const int* tile_start, const int* tile_count, const float* packed,
            long long k, const float* raw, const float* cot, int tiles_x,
            int block_x, int block_y, int track_contrib, float* grad) {
  blend_pallas_bwd_kernel<kPer><<<num_tiles, threads, 0, stream>>>(
      tile_start, tile_count, packed, k, raw, cot, tiles_x, block_x, block_y,
      track_contrib, grad);
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (9, k) float32
// row-major; raw, cot: (num_tiles, 5, block_x*block_y) float32 (cot's row 4
// is not read); grad: (9, k) float32, zero-filled by the caller (slots past
// each tile's stop are not written). Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a tile of
// more than 2048 pixels.
int blend_pallas_bwd(const void* tile_start, const void* tile_count,
                     const void* packed, long long k, const void* raw,
                     const void* cot, int num_tiles, int tiles_x, int block_x,
                     int block_y, int track_contrib, void* grad,
                     void* stream) {
  if (num_tiles <= 0) return 0;
  const int pix = block_x * block_y;
  const int threads = min(kMaxThreads, (pix + 31) / 32 * 32);
  const int per = (pix + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* tc = static_cast<const int*>(tile_count);
  const auto* pk = static_cast<const float*>(packed);
  const auto* rw = static_cast<const float*>(raw);
  const auto* cv = static_cast<const float*>(cot);
  auto* gd = static_cast<float*>(grad);
  if (per <= 1) {
    launch<1>(num_tiles, threads, s, ts, tc, pk, k, rw, cv, tiles_x, block_x,
              block_y, track_contrib, gd);
  } else if (per <= 2) {
    launch<2>(num_tiles, threads, s, ts, tc, pk, k, rw, cv, tiles_x, block_x,
              block_y, track_contrib, gd);
  } else if (per <= 4) {
    launch<4>(num_tiles, threads, s, ts, tc, pk, k, rw, cv, tiles_x, block_x,
              block_y, track_contrib, gd);
  } else if (per <= 8) {
    launch<8>(num_tiles, threads, s, ts, tc, pk, k, rw, cv, tiles_x, block_x,
              block_y, track_contrib, gd);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* blend_pallas_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
