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
// What bounds it on an H100: arithmetic, as the function needs it: per pair
// before the pixel's own n_contrib, the power (5 FP32 operations, and 3 per
// (instance, column) and 3 per (instance, row) for its terms in dx or dy alone)
// where the pixel lies inside the instance's box and an expf and 2 more where
// the power is at or above the cutoff; ~47 more per blended pair; the cutoff
// and box once per instance; against 36 bytes of attributes and 36 bytes of
// gradient rows per slot (chip_smoke.py works the bound out from each run's
// data). The design (PERF.md has the split of the time and the variants tried):
//
// - One 256-thread CTA per tile, 4 pixels per thread: a 2x2 cell, each warp
//   a compact 16x8 patch, so the lanes of a warp mostly blend or skip
//   together. A cell's pixels share their column's dx and A*dx*dx and their
//   row's dy and C*dy*dy.
// - Each pixel stops at its own n_contrib (past it the pixel blends
//   nothing) and on done; each warp at the deepest contributor of its 128
//   pixels, writing zeros for the rest of the batch.
// - K1's exact alpha-floor skip (alpha_cutoff, blend_common.cuh): a pair
//   below the cutoff has a = 0, so w = 0 and it adds exactly zero
//   everywhere; and K1's per-warp box test (instance_box): a warp whose 16x8
//   patch misses an instance's box writes its zero partials without
//   computing any power.
// - The per-pixel work is straight-line code under warp-wide votes (the
//   gradient terms run when any lane of the warp needs them), so that a
//   thread's 4 pixels interleave; the terms of pairs that did not blend are
//   zeroed and add +-0.
// - Per instance a warp that blended anything sums its 9 rows by a fixed
//   reduce-scatter: rows 0-7 by recursive halving (4 + 2 + 1 shuffles, then
//   2 butterfly steps), row 8 by a 5-step butterfly, 14 shuffles in all
//   (a full butterfly per row takes 45); the lane groups then hold one row
//   each and store it into the CTA's [8 warps][9 rows][128 slots]
//   partials. After the batch one thread per (row, slot) adds the 8 warps
//   in order and stores the sum, coalesced. No atomics: the output repeats
//   bit for bit.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kPerThread = 4;  // a 2x2 cell: pixel q at (q % 2, q / 2)

__global__ void __launch_bounds__(kThreads, 2)
blend_seq_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ packed, long long k,
                     const float* __restrict__ raw,
                     const float* __restrict__ cot, int tiles_x,
                     int track_contrib, float* __restrict__ grad) {
  __shared__ Staged batch[kBatch];
  // +1: the 8 lane groups' stores of rows 0-7 fall in 8 banks
  __shared__ float part[kWarps][kRows][kBatch + 1];
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

  // the tile's stop: its deepest contributor over all 1024 pixels
  int deepest = 0;
  for (int p = threadIdx.x; p < kPix; p += kThreads)
    deepest = max(deepest, static_cast<int>(res[4 * kPix + p]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    deepest = max(deepest, __shfl_xor_sync(kFull, deepest, off));
  if (lane == 0) warp_max[warp] = deepest;
  __syncthreads();
  deepest = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) deepest = max(deepest, warp_max[w]);
  const int limit = track_contrib ? min(count, deepest) : count;

  // The 8 warps tile the tile with 16x8 patches, 2 across and 4 down; lane
  // l owns the 2x2 cell (l % 8, l / 8) of its patch; pixel q of the cell is
  // (x0 + q % 2, y0 + q / 2).
  const int wx = (warp & 1) * 16;
  const int wy = (warp >> 1) * 8;
  const int cx = wx + (lane & 7) * 2;
  const int cy = wy + (lane >> 3) * 2;
  const float x0 = static_cast<float>(tx * kTile + cx);
  const float y0 = static_cast<float>(ty * kTile + cy);
  float trans[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread];
  float tot[kPerThread], prefix[kPerThread];
  int stop[kPerThread];  // past it the pixel blends nothing
  bool done[kPerThread];
  int warp_stop = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = (cy + q / 2) * kTile + cx + q % 2;
    gr[q] = ct[0 * kPix + p];
    gg[q] = ct[1 * kPix + p];
    gb[q] = ct[2 * kPix + p];
    tot[q] = res[0 * kPix + p] * gr[q] + res[1 * kPix + p] * gg[q] +
             res[2 * kPix + p] * gb[q] + res[3 * kPix + p] * ct[3 * kPix + p];
    stop[q] = track_contrib ? min(limit, static_cast<int>(res[4 * kPix + p]))
                            : limit;
    warp_stop = max(warp_stop, stop[q]);
    trans[q] = 1.f;
    prefix[q] = 0.f;
    done[q] = false;
  }
  warp_stop = __reduce_max_sync(kFull, warp_stop);
  // the warp's patch, for the box test
  const float wx0 = static_cast<float>(tx * kTile + wx);
  const float wy0 = static_cast<float>(ty * kTile + wy);
  const float wx1 = wx0 + 15.f;
  const float wy1 = wy0 + 7.f;

  for (int base = 0; base < limit; base += kBatch) {
    const int nb = min(kBatch, limit - base);
    __syncthreads();  // the previous batch's buffers are consumed
    stage_batch(batch, packed, k, start + base, nb);
    __syncthreads();

    // this warp's slots past its deepest contributor hold zeros
    const int nw = max(0, min(nb, warp_stop - base));
    for (int idx = lane; idx < (nb - nw) * kRows; idx += 32)
      part[warp][idx % kRows][nw + idx / kRows] = 0.f;
    // Straight-line over the thread's pixels, so that their chains
    // interleave; warp-wide votes skip what no lane needs.
    for (int j = 0; j < nw; ++j) {
      if (box_missed(batch, j, wx0, wx1, wy0, wy1)) {  // adds zero
        if ((lane & 3) == 0) part[warp][lane >> 2][j] = 0.f;
        if (lane == 0) part[warp][8][j] = 0.f;
        continue;
      }
      const Staged in = load_staged(batch, j);
      const float ca = in.ca, cbc = in.cbc, cc = in.cc;
      // a cell's pixels share their column's dx and A*dx*dx, their row's
      // dy and C*dy*dy: the same values, computed once
      float dxc[2], dyr[2], adx[2], cdy[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dxc[c] = in.mx - (x0 + static_cast<float>(c));
        adx[c] = ca * (dxc[c] * dxc[c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dyr[r] = in.my - (y0 + static_cast<float>(r));
        cdy[r] = cc * (dyr[r] * dyr[r]);
      }
      float dx[kPerThread], dy[kPerThread], power[kPerThread];
      bool need[kPerThread];
      bool any_need = false;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        dx[q] = dxc[q % 2];
        dy[q] = dyr[q / 2];
        power[q] = -0.5f * (adx[q % 2] + cdy[q / 2]) -
                   cbc * (dx[q] * dy[q]);
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
        for (int q = 0; q < kPerThread; ++q) {
          const float gexp = expf(power[q]);
          const float opg = in.op * gexp;
          const float alpha = fminf(kAlphaMax, opg);
          const float a = (need[q] && power[q] <= 0.f && alpha >= kAlphaMin)
                              ? alpha : 0.f;
          const float ta = trans[q] * a;
          const float t_new = trans[q] - ta;
          // a = 0 leaves T as it was (T*0 = 0, t_new = T >= 1e-4)
          const bool blended = a > 0.f && t_new >= kStopT;
          done[q] = done[q] || (a > 0.f && t_new < kStopT);
          const float w = blended ? ta : 0.f;
          const float cdot = in.r * gr[q] + in.g * gg[q] + in.b * gb[q];
          prefix[q] = prefix[q] + w * cdot;
          const float dalpha =
              trans[q] * cdot - (tot[q] - prefix[q]) / (1.f - a);
          // zero on pairs that did not blend, so that they add +-0
          const float dpow = blended ? opg * dalpha : 0.f;
          const float dop = blended ? gexp * dalpha : 0.f;
          acc[0] = acc[0] + dpow * (-ca * dx[q] - cbc * dy[q]);
          acc[1] = acc[1] + dpow * (-cc * dy[q] - cbc * dx[q]);
          acc[2] = acc[2] + dpow * (-0.5f * dx[q] * dx[q]);
          acc[3] = acc[3] + dpow * (-dx[q] * dy[q]);
          acc[4] = acc[4] + dpow * (-0.5f * dy[q] * dy[q]);
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
      if ((lane & 3) == 0) part[warp][lane >> 2][j] = s;
      if (lane == 0) part[warp][8][j] = row8;
    }
    __syncthreads();

    // the CTA's sum of its 8 warps, in order
    for (int idx = threadIdx.x; idx < kRows * nb; idx += kThreads) {
      const int row = idx / nb;
      const int j = idx % nb;
      float s = part[0][row][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = s + part[w][row][j];
      grad[row * k + start + base + j] = s;
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
