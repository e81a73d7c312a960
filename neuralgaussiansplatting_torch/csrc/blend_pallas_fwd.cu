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
// What bounds it on an H100: arithmetic, as the function needs it: per
// (instance, pixel) pair that a live pixel visits, the power (4 FP32
// operations, and 4 per (instance, column) and 3 per (instance, row) for its
// terms in dx or dy alone) where the pixel lies inside the instance's box and
// an expf and 2 more where the power is at or above the cutoff; 9 more per
// blended pair; the cutoff and box once per instance; against 36 bytes of
// attributes per instance shared by the tile's pixels and 20 bytes of output
// per pixel (chip_smoke.py works the bound out from each run's data). The first
// design (one block per tile, row-strip warps, several pixels per thread at
// 32x32, an expf on every visited pair) spent its time on pairs that cannot
// blend and on the tail of the densest tiles. K1's tools (blend_common.cuh)
// apply as they are, so (PERF.md has the split of the time):
//
// - Blocks of at most 256 threads, several blocks per tile above 256 cells
//   (2 at 32x32, 4 at 2048 pixels). The blocks share nothing: each walks
//   the tile's list, ends once its own pixels are done (__syncthreads_count
//   before each batch) and writes its pixels into the unchanged (T, 5, pix)
//   layout.
// - Compact warp patches. Where the tile divides into 8x8 patches (16x16,
//   32x32, 8x8, 32x16, ...), a thread owns a 1x2 cell and a warp an 8x8
//   patch of 8x4 cells; the two pixels of a cell share their column's dx,
//   (A*dx)*dx and B*dx, and interleave. Else (any other shape, 1x1
//   included) one pixel per thread, 32 row-major pixels per warp. The
//   warp's box test uses the extent of its own pixels either way.
// - The exact alpha-floor skip: below the instance's power cutoff
//   (alpha_cutoff) alpha is below 1/255, so a = 0 and the pair is a no-op in
//   the product form: T*(1 - 0) = T, w = 0*T = 0, no colour or n_contrib
//   change, and done stays false because T >= 1e-4 already held. The pair
//   gets no expf, and the output stays bit-equal.
// - The exact per-warp box test (instance_box, which holds for this kernel's
//   association: see its comment): a warp whose pixels all lie outside an
//   instance's box skips it after one 16-byte load and four compares.
// - The expf and the blend run under a warp-wide vote, as straight-line
//   code; each instance is read from shared memory as float4 broadcasts.

#include <climits>

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kMaxPix = 2048;

// kCW x kCH pixels per thread: with kCW > 0 a cell of them in 8x4-cell warp
// patches, row-major over the tile; with kCW = 0 one row-major pixel (kCH
// = 1).
template <int kCW, int kCH>
__global__ void __launch_bounds__(kThreads, 3)
blend_pallas_fwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        int tiles_x, int block_x, int block_y, int split,
                        int track_contrib, float* __restrict__ out) {
  constexpr bool kCells = kCW > 0;
  constexpr int kW = kCells ? kCW : 1;  // cell width
  constexpr int kPer = kW * kCH;
  __shared__ Staged batch[kBatch];

  const int pix = block_x * block_y;
  const int t = blockIdx.x / split;
  const int s = (blockIdx.x % split) * blockDim.x + threadIdx.x;
  const bool in_tile = s * kPer < pix;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;

  // the thread's cell: its corner (cx, cy) in the tile
  int cx = s % block_x, cy = s / block_x;
  if (kCells) cell_corner<kW, kCH>(s, block_x, cx, cy);
  float colx[kW], rowy[kCH];
#pragma unroll
  for (int c = 0; c < kW; ++c)
    colx[c] = static_cast<float>(tx * block_x + cx + c);
#pragma unroll
  for (int r = 0; r < kCH; ++r)
    rowy[r] = static_cast<float>(ty * block_y + cy + r);
  // the extent of the warp's pixels, for the box test (empty for a warp
  // past the tile's last pixel, which starts done)
  const int ix = tx * block_x + cx, iy = ty * block_y + cy;
  const float wx0 = static_cast<float>(
      __reduce_min_sync(kFull, in_tile ? ix : INT_MAX));
  const float wx1 = static_cast<float>(
      __reduce_max_sync(kFull, in_tile ? ix + kW - 1 : INT_MIN));
  const float wy0 = static_cast<float>(
      __reduce_min_sync(kFull, in_tile ? iy : INT_MAX));
  const float wy1 = static_cast<float>(
      __reduce_max_sync(kFull, in_tile ? iy + kCH - 1 : INT_MIN));
  float trans[kPer], cr[kPer], cg[kPer], cb[kPer], last[kPer];
  bool done[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    trans[q] = 1.f;
    cr[q] = cg[q] = cb[q] = last[q] = 0.f;
    done[q] = !in_tile;
  }

  for (int base = 0; base < count; base += kBatch) {
    bool live = false;
#pragma unroll
    for (int q = 0; q < kPer; ++q) live |= !done[q];
    if (__syncthreads_count(live) == 0) break;
    const int nb = min(kBatch, count - base);
    stage_batch(batch, packed, k, start + base, nb);
    __syncthreads();
    if (!__any_sync(kFull, live)) continue;

    for (int j = 0; j < nb; ++j) {
      if (box_missed(batch, j, wx0, wx1, wy0, wy1)) continue;  // no-ops
      const Staged in = load_staged(batch, j);
      // a cell's pixels share their column's dx, (A*dx)*dx and B*dx and
      // their row's dy and (C*dy)*dy: the same values, computed once
      float dxc[kW], adx[kW], bdx[kW], dyr[kCH], cdy[kCH];
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        dxc[c] = in.mx - colx[c];
        adx[c] = (in.ca * dxc[c]) * dxc[c];
        bdx[c] = in.cbc * dxc[c];
      }
#pragma unroll
      for (int r = 0; r < kCH; ++r) {
        dyr[r] = in.my - rowy[r];
        cdy[r] = (in.cc * dyr[r]) * dyr[r];
      }
      float power[kPer];
      bool need[kPer];
      bool any_need = false, all_done = true;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int c = q % kW, r = q / kW;
        power[q] = -0.5f * (adx[c] + cdy[r]) - bdx[c] * dyr[r];
        // below the cutoff a = 0, and a done pixel takes nothing: no-ops
        need[q] = !done[q] && !(power[q] < in.cut);
        any_need |= need[q];
        all_done &= done[q];
      }
      if (!__any_sync(kFull, any_need)) {
        if (__all_sync(kFull, all_done)) break;
        continue;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float alpha = fminf(kAlphaMax, in.op * expf(power[q]));
        const float a =
            (need[q] && power[q] <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
        const float t_new = trans[q] * (1.f - a);
        // a = 0 leaves everything as it was (t_new = T >= 1e-4, w = 0);
        // the instance that ends the pixel is not blended, and T keeps its
        // value
        const bool blend = a > 0.f && t_new >= kStopT;
        done[q] = done[q] || (a > 0.f && t_new < kStopT);
        const float w = a * trans[q];
        cr[q] = blend ? cr[q] + w * in.r : cr[q];
        cg[q] = blend ? cg[q] + w * in.g : cg[q];
        cb[q] = blend ? cb[q] + w * in.b : cb[q];
        last[q] = blend ? static_cast<float>(base + j + 1) : last[q];
        trans[q] = blend ? t_new : trans[q];
      }
    }
  }

  if (!in_tile) return;
  float* o = out + static_cast<long long>(t) * 5 * pix;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = (cy + q / kW) * block_x + cx + q % kW;
    o[0 * pix + p] = cr[q];
    o[1 * pix + p] = cg[q];
    o[2 * pix + p] = cb[q];
    o[3 * pix + p] = trans[q];
    o[4 * pix + p] = track_contrib ? last[q] : 0.f;
  }
}

using Kernel = void (*)(const int*, const int*, const float*, long long,
                        int, int, int, int, int, float*);

// The kernel and blocks that a tile takes: 1x2 cells in 8x8-pixel patches
// where the tile divides into them, else row-major pixels; blocks of at
// most 256 threads, `split` of them per tile.
struct Layout {
  Kernel kernel;
  int threads;
  int split;
};

Layout layout(int block_x, int block_y) {
  const int pix = block_x * block_y;
  const bool cells = block_x % 8 == 0 && block_y % 8 == 0;
  const int n = cells ? pix / 2 : pix;
  Layout l;
  if (cells) {
    l.kernel = blend_pallas_fwd_kernel<1, 2>;
  } else {
    l.kernel = blend_pallas_fwd_kernel<0, 1>;
  }
  l.threads = min(kThreads, (n + 31) / 32 * 32);
  l.split = (n + l.threads - 1) / l.threads;
  return l;
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
  if (block_x < 1 || block_y < 1 || pix > kMaxPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(block_x, block_y);
  l.kernel<<<num_tiles * l.split, l.threads, 0, s>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, tiles_x, block_x, block_y,
      l.split, track_contrib, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launch that a block_x x block_y tile takes and its residency on the
// current device, into info[6] (blend_common.cuh's launch_info).
int blend_pallas_fwd_layout(int block_x, int block_y, int* info) {
  if (block_x < 1 || block_y < 1 || block_x * block_y > kMaxPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(block_x, block_y);
  return launch_info(reinterpret_cast<const void*>(l.kernel), l.threads,
                     l.split, 0, info);
}

const char* blend_pallas_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
