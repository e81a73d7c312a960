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
// What bounds it on an H100: arithmetic, as the function needs it: per
// (instance, pixel) pair that a live pixel visits, the power (5 FP32
// operations, and 3 per (instance, column) and 3 per (instance, row) for its
// terms in dx or dy alone) where the pixel lies inside the instance's box and
// an expf and 2 more where the power is at or above the cutoff; 8 more per
// blended pair; the cutoff and box once per instance; against 36 bytes of
// attributes per instance shared by 1024 pixels (chip_smoke.py works the bound
// out from each run's data). What held the earlier design (one block per tile)
// back was the spread of the work and the work no output uses: 625 blocks at
// 800x800, the densest tile 3.7x the mean, each thread walking 4 pixels to the
// end of its tile, every pair paying an expf though ~3/4 of them cannot blend.
// So (PERF.md has the split of the time):
//
// - Four blocks per tile, one 16x16 quadrant each, one pixel per thread;
//   each warp owns a compact 8x4 patch of its quadrant, so its lanes
//   mostly skip, blend and finish together. The blocks share nothing (the
//   forward has no sum across pixels): each walks the tile's list, ends
//   once its own 256 pixels are done (__syncthreads_count before each
//   batch), and writes its pixels into the unchanged (T, 5, 1024) layout;
//   a warp whose pixels are all done leaves the batch.
// - An exact alpha-floor skip. When a batch is staged, each instance gets
//   a power cutoff (alpha_cutoff, blend_common.cuh); a pair whose power
//   lies below it gets no expf. Its alpha would be below 1/255, so a = 0
//   and the pair is a no-op: T*0 = 0, t_new = T, no colour or n_contrib
//   change, and done stays false because T >= 1e-4 already held. The
//   output stays bit-equal.
// - An exact per-warp box test. Each staged instance also gets a box
//   (instance_box) outside which every pixel's power lies below its cutoff; a
//   warp whose 8x4 patch misses the box skips the instance after one
//   16-byte load and four compares, without computing any power.
// - The expf and the blend run under a warp-wide vote (when any lane of
//   the warp needs them), so that no lane branches on its own; each
//   instance is read from shared memory as float4 broadcasts.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kSplit = 4;  // blocks per tile, one 16x16 quadrant each

__global__ void __launch_bounds__(kThreads, 4)
blend_seq_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ packed, long long k,
                     int tiles_x, int track_contrib,
                     float* __restrict__ out) {
  __shared__ Staged batch[kBatch];

  const int t = blockIdx.x / kSplit;
  const int sub = blockIdx.x % kSplit;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Quadrant (sub % 2, sub / 2); its 8 warps tile it with 8x4 patches, 2
  // across and 4 down; lane l owns pixel (l % 8, l / 8) of its patch.
  const int wx = (sub & 1) * 16 + (warp & 1) * 8;
  const int wy = (sub >> 1) * 16 + (warp >> 1) * 4;
  const int pix = (wy + (lane >> 3)) * kTile + wx + (lane & 7);
  const float px = static_cast<float>(tx * kTile + pix % kTile);
  const float py = static_cast<float>(ty * kTile + pix / kTile);
  // the warp's patch, for the box test
  const float wx0 = static_cast<float>(tx * kTile + wx);
  const float wy0 = static_cast<float>(ty * kTile + wy);
  const float wx1 = wx0 + 7.f;
  const float wy1 = wy0 + 3.f;
  float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, last = 0.f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(kBatch, count - base);
    stage_batch(batch, packed, k, start + base, nb);
    __syncthreads();
    if (__all_sync(kFull, done)) continue;

    for (int j = 0; j < nb; ++j) {
      if (box_missed(batch, j, wx0, wx1, wy0, wy1)) continue;  // no-ops
      const Staged in = load_staged(batch, j);
      const float dx = in.mx - px;
      const float dy = in.my - py;
      const float power = -0.5f * (in.ca * (dx * dx) + in.cc * (dy * dy)) -
                          in.cbc * (dx * dy);
      // below the cutoff a = 0, and a done pixel takes nothing: no-ops
      const bool need = !done && !(power < in.cut);
      if (!__any_sync(kFull, need)) {
        if (__all_sync(kFull, done)) break;
        continue;
      }
      const float alpha = fminf(kAlphaMax, in.op * expf(power));
      const float a =
          (need && power <= 0.f && alpha >= kAlphaMin) ? alpha : 0.f;
      const float ta = trans * a;
      const float t_new = trans - ta;
      // a = 0 leaves everything as it was (T*0 = 0, t_new = T >= 1e-4)
      const bool blend = a > 0.f && t_new >= kStopT;
      done = done || (a > 0.f && t_new < kStopT);
      cr = blend ? cr + ta * in.r : cr;
      cg = blend ? cg + ta * in.g : cg;
      cb = blend ? cb + ta * in.b : cb;
      last = blend ? static_cast<float>(base + j + 1) : last;
      trans = blend ? t_new : trans;
    }
  }

  float* o = out + static_cast<long long>(t) * 5 * kPix;
  o[0 * kPix + pix] = cr;
  o[1 * kPix + pix] = cg;
  o[2 * kPix + pix] = cb;
  o[3 * kPix + pix] = trans;
  o[4 * kPix + pix] = track_contrib ? last : 0.f;
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
  blend_seq_fwd_kernel<<<num_tiles * kSplit, kThreads, 0,
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
