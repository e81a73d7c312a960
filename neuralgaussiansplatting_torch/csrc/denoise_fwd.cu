// The neural path's dynamic per-pixel filter, forward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's `denoise` (models/nets.py) adds
// 81 shifted slices and XLA fuses them into one pass. Eagerly PyTorch ran
// them as 162 launches after a padded copy (models/nets.py::denoise, the
// plain version, keeps that code). Contract, for pixel (y, x), channel c:
//
//   out[y, x, c] = sum over i = 0 .. 80 of
//                  img_pad[y + i / 9, x + i % 9, c] * ker[i, y, x]
//
// img_pad the image reflected by pad = 4 without repeating the edge
// (pad < H, W); the sum starts from 0 and adds the taps in order i, each
// product and each add rounded to float32 on its own (__fmul_rn,
// __fadd_rn), as the plain version's `out = out + img * k`: the output is
// its bits on the card.
//
// What bounds it on an H100: bytes. The kernel map, (81, H, W) float32
// (207.4 MB at 800x800), is read once; the image (7.7 MB) is read
// into shared memory with its halo and the output written once: 0.066 ms
// at 3.35 TB/s against 243 FP32 multiply-adds a pixel. The map is read in
// planes, so a warp (one tile row) reads 128 contiguous bytes a tap; the
// padding is done by index when the window is staged, so no padded copy
// exists.

#include "denoise_common.cuh"

namespace {

using denoise::kK;
using denoise::kThreads;
using denoise::kTileX;
using denoise::kTileY;
using denoise::kWinSize;
using denoise::kWinW;
using denoise::Strides;

__global__ void __launch_bounds__(kThreads)
    denoise_fwd_kernel(const float* __restrict__ img, Strides is,
                       const float* __restrict__ ker, float* __restrict__ out,
                       Strides os, int h, int w) {
  __shared__ float s[3 * kWinSize];
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  denoise::stage(s, img, is, h, w, y0, x0, true);
  __syncthreads();

  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= w || y >= h) return;
  const long long hw = static_cast<long long>(h) * w;
  const float* k = ker + static_cast<long long>(y) * w + x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int i = 0; i < kK * kK; ++i) {
    const float kv = __ldcs(k + i * hw);
    const int e = (ty + i / kK) * kWinW + tx + i % kK;
    a0 = __fadd_rn(a0, __fmul_rn(s[e], kv));
    a1 = __fadd_rn(a1, __fmul_rn(s[kWinSize + e], kv));
    a2 = __fadd_rn(a2, __fmul_rn(s[2 * kWinSize + e], kv));
  }
  float* o = out + y * os.y + x * os.x;
  o[0] = a0;
  o[os.c] = a1;
  o[2 * os.c] = a2;
}

}  // namespace

extern "C" {

// out (H, W, 3) from img (H, W, 3) and the kernel map ker, (81, H, W)
// contiguous planes; img and out by element strides (y, x, c), float32 on
// the device, out apart from the inputs. Launches on `stream` and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for 4 >= H or W
// (the reflect padding's contract) or for more rows of tiles than a grid
// holds.
int denoise_fwd(const float* img, long long isy, long long isx, long long isc,
                const float* ker, float* out, long long osy, long long osx,
                long long osc, int h, int w, void* stream) {
  if (denoise::kPad >= h || denoise::kPad >= w ||
      (h + kTileY - 1) / kTileY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  denoise_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, Strides{isy, isx, isc}, ker, out, Strides{osy, osx, osc}, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* denoise_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
