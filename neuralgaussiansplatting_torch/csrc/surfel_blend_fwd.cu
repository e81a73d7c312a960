// Forward of the surfel blend (2D Gaussian Splatting) over 32x32 tiles, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no surfels. Contract
// (ops/surfel_blend.py, whose plain version surfel_blend_fwd_reference
// repeats this recurrence in the same operation order): for each 32x32
// tile, blend the tile's depth-sorted surfels front to back by ray-splat
// intersection and write per pixel 14 channels: rgb, the final T,
// n_contrib, the normal sum, the depth sum, M1, M2, the distortion sum,
// the median depth and its 1-based index. The library is built with
// --fmad=false and the precise expf, as K1's is.
//
// What bounds it on an H100: arithmetic, as the function needs it: per
// (surfel, pixel) pair that a live pixel visits inside the surfel's box,
// the intersection (two 3-vectors, a cross product, two divisions), the
// filter's distance, the depth and the power, ~40 FP32 operations, an
// expf and 2 more where the power is at or above the cutoff, ~40 more per
// blended pair (colour, normal, depth, the distortion's three sums, the
// median), against 72 bytes of attributes per instance shared by 1024
// pixels and 56 bytes out per pixel (ngsbench/surfel_counts.py counts
// both). The design is K1's (blend_seq_fwd.cu):
//
// - Four blocks per tile, one 16x16 quadrant each, one pixel per thread,
//   each warp a compact 8x4 patch; a block ends once its 256 pixels are
//   done; a warp whose pixels are all done leaves the batch.
// - K1's exact alpha-floor skip: a pair whose power lies below its
//   surfel's cutoff gets no expf (its alpha would be below 1/255).
// - A per-warp box test: each staged surfel gets a box (surfel_box,
//   surfel_blend_common.cuh) outside which no pixel can blend; a warp whose
//   patch misses it skips the surfel after one 16-byte load.
// - The intersection and the blend run under warp-wide votes, and each
//   surfel is read from shared memory as float4 broadcasts.

#include <cuda_runtime.h>

#include "surfel_blend_common.cuh"

namespace {

using namespace surfel;

constexpr int kSplit = 4;  // blocks per tile, one 16x16 quadrant each

__global__ void __launch_bounds__(kThreads, 3)
surfel_blend_fwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        int tiles_x, float* __restrict__ out) {
  __shared__ SurfelStaged batch[kBatch];

  const int t = blockIdx.x / kSplit;
  const int sub = blockIdx.x % kSplit;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // quadrant (sub % 2, sub / 2), 8x4 patches 2 across and 4 down
  const int wx = (sub & 1) * 16 + (warp & 1) * 8;
  const int wy = (sub >> 1) * 16 + (warp >> 1) * 4;
  const int pix = (wy + (lane >> 3)) * kTile + wx + (lane & 7);
  const float px = static_cast<float>(tx * kTile + pix % kTile);
  const float py = static_cast<float>(ty * kTile + pix / kTile);
  const float wx0 = static_cast<float>(tx * kTile + wx);
  const float wy0 = static_cast<float>(ty * kTile + wy);
  const float wx1 = wx0 + 7.f;
  const float wy1 = wy0 + 3.f;
  float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, last = 0.f;
  float nx = 0.f, ny = 0.f, nz = 0.f, depth = 0.f, m1 = 0.f, m2 = 0.f;
  float dist = 0.f, med = 0.f, med_i = 0.f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(kBatch, count - base);
    stage_surfels(batch, packed, k, start + base, nb);
    __syncthreads();
    if (__all_sync(kFull, done)) continue;

    for (int j = 0; j < nb; ++j) {
      if (surfel_missed(batch, j, wx0, wx1, wy0, wy1)) continue;  // no-ops
      const SurfelStaged in = load_surfel(batch, j);
      const Pair p = pair_of(in, px, py);
      const bool need = !done && p.c2 != 0.f && p.z >= kNear &&
                        !(p.power < in.cut);
      if (!__any_sync(kFull, need)) {
        if (__all_sync(kFull, done)) break;
        continue;
      }
      const float alpha = fminf(kAlphaMax, in.op * expf(p.power));
      const float a =
          (need && p.power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
      const float ta = trans * a;
      const float t_new = trans - ta;
      // a = 0 leaves everything as it was (T*0 = 0, t_new = T >= 1e-4)
      const bool blend = a > 0.f && t_new >= kStopT;
      done = done || (a > 0.f && t_new < kStopT);
      if (blend) {
        const float w = ta;
        const float zb = p.z;
        const float m = kMScale * (1.f - kNear * (1.f / zb));
        dist = dist + ((((m * m) * (1.f - trans)) + m2) - (2.f * m) * m1) * w;
        depth = depth + zb * w;
        m1 = m1 + m * w;
        m2 = m2 + (m * m) * w;
        if (trans > kMedianT) {
          med = p.z;
          med_i = static_cast<float>(base + j + 1);
        }
        cr = cr + w * in.r;
        cg = cg + w * in.g;
        cb = cb + w * in.b;
        nx = nx + w * in.n0;
        ny = ny + w * in.n1;
        nz = nz + w * in.n2;
        last = static_cast<float>(base + j + 1);
        trans = t_new;
      }
    }
  }

  float* o = out + static_cast<long long>(t) * kChannels * kPix;
  const float v[kChannels] = {cr, cg, cb, trans, last, nx, ny, nz,
                              depth, m1, m2, dist, med, med_i};
#pragma unroll
  for (int c = 0; c < kChannels; ++c) o[c * kPix + pix] = v[c];
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (18, k) float32
// row-major; out: (num_tiles, 14, 1024) float32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int surfel_blend_fwd(const void* tile_start, const void* tile_count,
                     const void* packed, long long k, int num_tiles,
                     int tiles_x, void* out, void* stream) {
  if (num_tiles <= 0) return 0;
  surfel_blend_fwd_kernel<<<num_tiles * kSplit, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, tiles_x,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* surfel_blend_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
