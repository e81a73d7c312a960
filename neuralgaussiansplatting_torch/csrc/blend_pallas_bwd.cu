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
// What bounds it on an H100: arithmetic, as the function needs it: per pair
// before the pixel's own n_contrib, the power (4 FP32 operations, and 4 per
// (instance, column) and 3 per (instance, row) for its terms in dx or dy alone)
// where the pixel lies inside the instance's box and an expf and 2 more where
// the power is at or above the cutoff; 49 more per blended pair; the cutoff and
// box once per instance; against 36 bytes of attributes and 36 bytes of
// gradient rows per slot and 40 bytes of raw and cotangent per pixel
// (chip_smoke.py works the bound out from each run's data). The first design
// (row-strip warps, an expf on every pair, every pixel walked to the tile's
// deepest contributor, a 45-shuffle butterfly per instance) spent its time on
// work no output uses. K2's tools (blend_common.cuh) carry over, so
// (PERF.md has the split of the time):
//
// - One CTA per tile, kPer pixels per thread. Where the tile divides into
//   them, a thread owns a cell of kCW x kCH pixels and a warp a compact
//   patch of 8x4 cells, at most 8 warps: 8x8 patches of 1x2 cells at 16x16
//   (4 warps), 8x8 and 32x16; 16x8 of 2x2 cells at 32x32 (K2's layout, 8
//   warps). Else (kCW = 0) thread i owns the row-major pixels i +
//   q*blockDim. A cell's pixels share their column's dx and (A*dx)*dx and
//   their row's dy and (C*dy)*dy: the same values, computed once.
// - Each pixel stops at its own n_contrib when it was tracked (past it the
//   pixel blends nothing) and on done; each warp at the deepest stop of its
//   pixels, writing zeros for the rest of the batch.
// - K4's exact alpha-floor skip (alpha_cutoff: a pair below the cutoff has
//   a = 0, so w = 0 and it adds exactly zero) and per-warp box test
//   (instance_box): a warp whose pixels all lie outside an instance's box
//   writes its zero partials without computing any power.
// - The per-pixel work is straight-line code under warp-wide votes (the
//   gradient terms run when any lane of the warp needs them), so that a
//   thread's pixels interleave; the terms of pairs that did not blend are
//   zeroed and add +-0.
// - Per instance a warp that blended anything sums its 9 rows by K2's
//   14-shuffle reduce-scatter (warp_rows) into the CTA's [warps][9 rows]
//   [128 slots] partials (dynamic shared memory, sized by the layout's
//   warps: 18.6 KB at 16x16, 37 KB at 32x32); after the batch one thread
//   per (row, slot) adds the warps in order and stores the sum, coalesced.
//   No atomics: the output repeats bit for bit.

#include <climits>

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kMaxPix = 2048;

// kPer pixels per thread; kCW > 0: a cell kCW wide and kPer / kCW tall in
// 8x4-cell warp patches (row-major over the tile); kCW = 0: pixels
// threadIdx.x + q*blockDim.x.
template <int kPer, int kCW>
__global__ void __launch_bounds__(kThreads, 2)
blend_pallas_bwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        const float* __restrict__ raw,
                        const float* __restrict__ cot, int tiles_x,
                        int block_x, int block_y, int track_contrib,
                        float* __restrict__ grad) {
  constexpr bool kCells = kCW > 0;
  constexpr int kW = kCells ? kCW : 1;     // cell width (cells only)
  constexpr int kCH = kPer / kW;           // cell height (cells only)
  // the cell's columns and rows; for kCW = 0, one of each per pixel
  constexpr int kCols = kCells ? kCW : kPer;
  constexpr int kRowsC = kCells ? kCH : kPer;
  __shared__ Staged batch[kBatch];
  __shared__ int warp_max[kWarps];
  // the warps' partials, [warps][kRows][kBatch + 1]; +1: the 8 lane
  // groups' stores of rows 0-7 fall in 8 banks
  extern __shared__ float partials[];
  auto part = [](int w, int row, int j) -> float& {
    return partials[(w * kRows + row) * (kBatch + 1) + j];
  };

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

  // the thread's pixels: index in the tile (-1 past its end) and position
  int p[kPer];
  int cx = 0, cy = 0;  // the cell's corner in the tile (cells only)
  if (kCells) cell_corner<kW, kCH>(threadIdx.x, block_x, cx, cy);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = kCells ? (cy + q / kW) * block_x + cx + q % kW
                         : static_cast<int>(threadIdx.x) + q * blockDim.x;
    p[q] = i < pix ? i : -1;
  }
  float colx[kCols], rowy[kRowsC];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int i = kCells ? cy * block_x + cx + c : max(p[c], 0);
    colx[c] = static_cast<float>(tx * block_x + i % block_x);
  }
#pragma unroll
  for (int r = 0; r < kRowsC; ++r) {
    const int i = kCells ? (cy + r) * block_x + cx : max(p[r], 0);
    rowy[r] = static_cast<float>(ty * block_y + i / block_x);
  }
  // pixel q's column and row
  auto col_of = [](int q) { return kCells ? q % kW : q; };
  auto row_of = [](int q) { return kCells ? q / kW : q; };

  float trans[kPer], gr[kPer], gg[kPer], gb[kPer];
  float total_dot[kPer], tfin_gt[kPer], prefix[kPer];
  int stop[kPer];  // past it the pixel blends nothing
  bool done[kPer];
  int deepest = 0;
  int x_lo = INT_MAX, x_hi = INT_MIN, y_lo = INT_MAX, y_hi = INT_MIN;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    trans[q] = 1.f;
    prefix[q] = 0.f;
    gr[q] = gg[q] = gb[q] = total_dot[q] = tfin_gt[q] = 0.f;
    stop[q] = 0;
    done[q] = p[q] < 0;
    if (p[q] >= 0) {
      const int i = p[q];
      gr[q] = ct[0 * pix + i];
      gg[q] = ct[1 * pix + i];
      gb[q] = ct[2 * pix + i];
      total_dot[q] = (res[0 * pix + i] * gr[q] + res[1 * pix + i] * gg[q]) +
                     res[2 * pix + i] * gb[q];
      tfin_gt[q] = res[3 * pix + i] * ct[3 * pix + i];
      stop[q] = track_contrib ? static_cast<int>(res[4 * pix + i]) : count;
      deepest = max(deepest, stop[q]);
      const int ix = static_cast<int>(colx[col_of(q)]);
      const int iy = static_cast<int>(rowy[row_of(q)]);
      x_lo = min(x_lo, ix), x_hi = max(x_hi, ix);
      y_lo = min(y_lo, iy), y_hi = max(y_hi, iy);
    }
  }
  // the tile's stop: its deepest contributor over all its pixels
  int warp_stop = __reduce_max_sync(kFull, deepest);
  if (lane == 0) warp_max[warp] = warp_stop;
  __syncthreads();
  deepest = 0;
  for (int w = 0; w < warps; ++w) deepest = max(deepest, warp_max[w]);
  const int limit = min(count, deepest);
  warp_stop = min(warp_stop, limit);
  // the extent of the warp's pixels, for the box test
  const float wx0 = static_cast<float>(__reduce_min_sync(kFull, x_lo));
  const float wx1 = static_cast<float>(__reduce_max_sync(kFull, x_hi));
  const float wy0 = static_cast<float>(__reduce_min_sync(kFull, y_lo));
  const float wy1 = static_cast<float>(__reduce_max_sync(kFull, y_hi));

  for (int base = 0; base < limit; base += kBatch) {
    const int nb = min(kBatch, limit - base);
    __syncthreads();  // the previous batch's buffers are consumed
    stage_batch(batch, packed, k, start + base, nb);
    __syncthreads();

    // this warp's slots past its deepest stop hold zeros
    const int nw = max(0, min(nb, warp_stop - base));
    for (int idx = lane; idx < (nb - nw) * kRows; idx += 32)
      part(warp, idx % kRows, nw + idx / kRows) = 0.f;
    // Straight-line over the thread's pixels, so that their chains
    // interleave; warp-wide votes skip what no lane needs.
    for (int j = 0; j < nw; ++j) {
      if (box_missed(batch, j, wx0, wx1, wy0, wy1)) {  // adds zero
        if ((lane & 3) == 0) part(warp, lane >> 2, j) = 0.f;
        if (lane == 0) part(warp, 8, j) = 0.f;
        continue;
      }
      const Staged in = load_staged(batch, j);
      const float ca = in.ca, cbc = in.cbc, cc = in.cc;
      float dxc[kCols], adx[kCols], dyr[kRowsC], cdy[kRowsC];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dxc[c] = in.mx - colx[c];
        adx[c] = (ca * dxc[c]) * dxc[c];
      }
#pragma unroll
      for (int r = 0; r < kRowsC; ++r) {
        dyr[r] = in.my - rowy[r];
        cdy[r] = (cc * dyr[r]) * dyr[r];
      }
      float power[kPer];
      bool need[kPer];
      bool any_need = false;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float dx = dxc[col_of(q)], dy = dyr[row_of(q)];
        power[q] =
            -0.5f * (adx[col_of(q)] + cdy[row_of(q)]) - (cbc * dx) * dy;
        // past the pixel's stop, done, or below the cutoff (a = 0), a pair
        // adds exactly zero
        need[q] = !done[q] && base + j < stop[q] && !(power[q] < in.cut);
        any_need |= need[q];
      }
      float acc[kRows];
#pragma unroll
      for (int row = 0; row < kRows; ++row) acc[row] = 0.f;
      bool any = false;
      if (__any_sync(kFull, any_need)) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const float dx = dxc[col_of(q)], dy = dyr[row_of(q)];
          const float gexp = expf(power[q]);
          const float alpha = fminf(kAlphaMax, in.op * gexp);
          const float a = (need[q] && power[q] <= 0.f && alpha >= kAlphaMin)
                              ? alpha : 0.f;
          const float one_minus = 1.f - a;
          const float t_new = trans[q] * one_minus;
          // a = 0 leaves T as it was (t_new = T >= 1e-4)
          const bool blended = a > 0.f && t_new >= kStopT;
          done[q] = done[q] || (a > 0.f && t_new < kStopT);
          const float w = blended ? a * trans[q] : 0.f;
          const float cdot = (in.r * gr[q] + in.g * gg[q]) + in.b * gb[q];
          prefix[q] = prefix[q] + w * cdot;
          const float suffix = total_dot[q] - prefix[q];
          const float dalpha =
              trans[q] * cdot - (suffix + tfin_gt[q]) / one_minus;
          // zero on pairs that did not blend, so that they add +-0
          const float dpow = blended ? gexp * (in.op * dalpha) : 0.f;
          const float dop = blended ? gexp * dalpha : 0.f;
          acc[0] = acc[0] + dpow * (-ca * dx - cbc * dy);
          acc[1] = acc[1] + dpow * (-cc * dy - cbc * dx);
          acc[2] = acc[2] + dpow * (-0.5f * dx * dx);
          acc[3] = acc[3] + dpow * (-dx * dy);
          acc[4] = acc[4] + dpow * (-0.5f * dy * dy);
          acc[5] = acc[5] + dop;
          acc[6] = acc[6] + w * gr[q];
          acc[7] = acc[7] + w * gg[q];
          acc[8] = acc[8] + w * gb[q];
          trans[q] = blended ? t_new : trans[q];
          any |= blended;
        }
      }
      float s = 0.f, row8 = 0.f;
      if (__any_sync(kFull, any)) s = warp_rows(acc, lane, row8);
      if ((lane & 3) == 0) part(warp, lane >> 2, j) = s;
      if (lane == 0) part(warp, 8, j) = row8;
    }
    __syncthreads();

    // the CTA's sum of its warps, in order
    for (int idx = threadIdx.x; idx < kRows * nb; idx += blockDim.x) {
      const int row = idx / nb;
      const int j = idx % nb;
      float s = part(0, row, j);
      for (int w = 1; w < warps; ++w) s = s + part(w, row, j);
      grad[row * k + start + base + j] = s;
    }
  }
}

// Warps of a tile in patches of 8x4 cells of cw x ch pixels, or 0 if the
// tile does not divide into them or needs more than kWarps.
int patch_warps(int block_x, int block_y, int cw, int ch) {
  if (block_x % (8 * cw) || block_y % (4 * ch)) return 0;
  const int warps = (block_x / (8 * cw)) * (block_y / (4 * ch));
  return warps <= kWarps ? warps : 0;
}

using Kernel = void (*)(const int*, const int*, const float*, long long,
                        const float*, const float*, int, int, int, int,
                        float*);

// The kernel, CTA size and dynamic shared memory (the warps' partials) that
// a tile takes: 1x2 cells, else 2x2 cells, the first whose patches cover
// the tile with at most 8 warps; else row-major pixels.
struct Layout {
  Kernel kernel;
  int threads;
  size_t smem;
};

Layout layout(int block_x, int block_y) {
  Layout l;
  if (const int w = patch_warps(block_x, block_y, 1, 2)) {
    l.kernel = blend_pallas_bwd_kernel<2, 1>;
    l.threads = 32 * w;
  } else if (const int w = patch_warps(block_x, block_y, 2, 2)) {
    l.kernel = blend_pallas_bwd_kernel<4, 2>;
    l.threads = 32 * w;
  } else {
    const int pix = block_x * block_y;
    l.threads = min(kThreads, (pix + 31) / 32 * 32);
    const int per = (pix + l.threads - 1) / l.threads;
    if (per <= 1) {
      l.kernel = blend_pallas_bwd_kernel<1, 0>;
    } else if (per <= 2) {
      l.kernel = blend_pallas_bwd_kernel<2, 0>;
    } else if (per <= 4) {
      l.kernel = blend_pallas_bwd_kernel<4, 0>;
    } else {
      l.kernel = blend_pallas_bwd_kernel<8, 0>;
    }
  }
  l.smem = sizeof(float) * (l.threads / 32) * kRows * (kBatch + 1);
  return l;
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
  if (block_x < 1 || block_y < 1 || pix > kMaxPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(block_x, block_y);
  l.kernel<<<num_tiles, l.threads, l.smem, s>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, static_cast<const float*>(raw),
      static_cast<const float*>(cot), tiles_x, block_x, block_y,
      track_contrib, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

// The launch that a block_x x block_y tile takes and its residency on the
// current device, into info[6] (blend_common.cuh's launch_info).
int blend_pallas_bwd_layout(int block_x, int block_y, int* info) {
  if (block_x < 1 || block_y < 1 || block_x * block_y > kMaxPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(block_x, block_y);
  return launch_info(reinterpret_cast<const void*>(l.kernel), l.threads, 1,
                     l.smem, info);
}

const char* blend_pallas_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
