// What the binning kernels share with the host (csrc/binning_expand.cuh and
// the CPU test's host build, tests/binning_host): one Gaussian's walk over
// the tiles of its rect, the precise-cull decision and the sort key, in the
// operation order of ops/binning.py::bin_gaussians_reference.
//
// Order and rounding. The library is built with --fmad=false and the host
// build with -ffp-contract=off, so each a*b+c rounds twice, as PyTorch's
// eager kernels round it (one operation each). clamp and clamp_min keep
// PyTorch's NaN rule (a NaN operand comes out NaN). Dividing by 0.25, as the
// tensor code does, equals PyTorch's multiply by the float32 reciprocal on
// the card: both are exact.
//
// The expansion order. Gaussian g's raw run is its tiles_touched tiles of
// its rect, row-major (tile j at x0 + j % w, y0 + j / w); in "scatter" the
// runs lie end to end and slots past `capacity` are truncated, in "dense"
// each Gaussian keeps its first `dense_cap`. The kept instances of that
// order are the sort's input, and their ranks are `eid`.
//
// The keys. Kept depths are positive floats (the preprocess keeps z > 0.2),
// so their bits, read as int32, are 31-bit and ordered as the depths are.
// Both orders are (tile << tile_shift) + (depth_bits >> (31 - tile_shift)):
// the exact one at tile_shift 31, a 64-bit key; the packed one (`pack_keys`)
// at tile_shift 31 - bit_length(num_tiles + 1), a 31-bit key that keeps the
// top depth bits. ops/binning.py's key_layout gives the shift.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace binning_kernels {

// The settings of one call, the same for every Gaussian.
struct Settings {
  long long n;
  long long capacity;  // the scatter expansion's slots
  int tiles_x;
  int block_x, block_y, width, height;
  int dense, dense_cap;
  int cull;        // precise_cull
  int tile_shift;  // the key's tile bits start here
};

// The diagonal support intervals of a Gaussian's alpha >= 1/255 ellipse
// along u = (1, +-1): [lo1, hi1] of x + y and [lo2, hi2] of x - y.
struct Support {
  float lo1, hi1, lo2, hi2;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// conic = [[a, b], [b, c]]: u^T Sigma u = (a + c -+ 2b) / det.
// `quantize`: the scatter expansion widens each bound outward to an absolute
// 0.25 px grid, clamped to +-8192 px, so that strip renders shifted by whole
// tiles make the full frame's decisions.
__device__ __forceinline__ Support support(float a, float b, float c,
                                           float opacity, float mx, float my,
                                           bool quantize) {
  const float det = a * c - b * b;
  const float safe_det = det > 0.f ? det : 1.f;
  // opacity < 1/255 => zero support
  const float lvl = clamp_min(logf(clamp_min(opacity, 1e-12f) * 255.f), 0.f);
  const float r1 = sqrtf(clamp_min(
      2.f * lvl * (a + c - 2.f * b) / safe_det, 0.f));
  const float r2 = sqrtf(clamp_min(
      2.f * lvl * (a + c + 2.f * b) / safe_det, 0.f));
  const float s1 = mx + my, s2 = mx - my;
  Support s{s1 - r1, s1 + r1, s2 - r2, s2 + r2};
  if (quantize) {
    constexpr float kSpan = 8192.f, kStep = 0.25f;
    s.lo1 = clamp(floorf((s.lo1 + kSpan) / kStep), 0.f, 65535.f) * kStep
            - kSpan;
    s.hi1 = clamp(ceilf((s.hi1 + kSpan) / kStep), 0.f, 65535.f) * kStep
            - kSpan;
    s.lo2 = clamp(floorf((s.lo2 + kSpan) / kStep), 0.f, 65535.f) * kStep
            - kSpan;
    s.hi2 = clamp(ceilf((s.hi2 + kSpan) / kStep), 0.f, 65535.f) * kStep
            - kSpan;
  }
  return s;
}

// Whether tile (tx, ty) keeps the instance: its pixel-centre rect, clipped
// to the image, meets both diagonal intervals (a separating-axis test).
__device__ __forceinline__ bool tile_keep(int tx, int ty, const Support& sp,
                                          const Settings& s) {
  const float x0 = static_cast<float>(tx * s.block_x);
  const float y0 = static_cast<float>(ty * s.block_y);
  const float x1 = static_cast<float>(
      min(tx * s.block_x + (s.block_x - 1), s.width - 1));
  const float y1 = static_cast<float>(
      min(ty * s.block_y + (s.block_y - 1), s.height - 1));
  return sp.lo1 <= x1 + y1 && sp.hi1 >= x0 + y0 && sp.lo2 <= x1 - y0 &&
         sp.hi2 >= x0 - y1;
}

// How many of a Gaussian's tiles_touched instances lie in the expansion
// domain: its first dense_cap, or those before slot `capacity` of a run that
// starts at raw slot `start`.
__device__ __forceinline__ int in_domain(int tiles, long long start,
                                         const Settings& s) {
  if (s.dense) return min(tiles, s.dense_cap);
  const long long room = s.capacity - start;
  return room <= 0 ? 0 : (room < tiles ? static_cast<int>(room) : tiles);
}

// One Gaussian as the walk reads it.
struct Gaussian {
  int x0, y0, w;  // rect origin and width (at least 1), in tiles
  Support sp;     // read only under precise_cull
};

__device__ __forceinline__ Gaussian gaussian(long long g, const int* rect_min,
                                             const int* rect_max,
                                             const float* conic,
                                             const float* opacity,
                                             const float* means2d,
                                             const Settings& s) {
  Gaussian q;
  q.x0 = rect_min[2 * g];
  q.y0 = rect_min[2 * g + 1];
  q.w = max(rect_max[2 * g] - q.x0, 1);
  q.sp = s.cull ? support(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2],
                          opacity[g], means2d[2 * g], means2d[2 * g + 1],
                          !s.dense)
                : Support{0.f, 0.f, 0.f, 0.f};
  return q;
}

// Walks the first `count` tiles of a Gaussian's run in order and calls
// emit(k, tile) for the k-th kept one; returns how many it kept.
template <class Emit>
__device__ __forceinline__ int walk(const Gaussian& q, int count,
                                    const Settings& s, Emit&& emit) {
  int kept = 0, tx = q.x0, ty = q.y0;
  for (int j = 0; j < count; ++j) {
    if (!s.cull || tile_keep(tx, ty, q.sp, s)) {
      emit(kept, ty * s.tiles_x + tx);
      ++kept;
    }
    if (++tx == q.x0 + q.w) {
      tx = q.x0;
      ++ty;
    }
  }
  return kept;
}

// The sort key of a kept instance: 8 bytes for the exact order, 4 for the
// packed one.
template <class Key>
__device__ __forceinline__ Key sort_key(int tile, uint32_t depth_bits,
                                        int tile_shift) {
  return (static_cast<Key>(tile) << tile_shift) +
         (depth_bits >> (31 - tile_shift));
}

}  // namespace binning_kernels
