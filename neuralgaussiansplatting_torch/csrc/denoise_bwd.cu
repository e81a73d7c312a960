// The neural path's dynamic per-pixel filter, backward, for Hopper (sm_90a):
// both gradients of csrc/denoise_fwd.cu's contract in one launch, without
// atomics, every sum in a fixed order, so a step repeats bit for bit.
//
// Replaces no TPU kernel: in the JAX package XLA differentiates and fuses
// the taps. Eagerly autograd ran ~10 launches a tap: each tap's slice of
// the kernel map got its gradient through a zero (H, W, 81) map, filled,
// written and added (~0.8 GB a tap at 800x800), and the padded image's
// gradient the same at (H + 2 pad, W + 2 pad, 3), then the padding's
// backward. With g the output's cotangent, pad = 4, d_i = (i / 9, i % 9):
//
//   g_ker[i, y, x] = (g[y, x, 0] img_pad[(y, x) + d_i, 0]
//                     + g[y, x, 1] img_pad[(y, x) + d_i, 1])
//                    + g[y, x, 2] img_pad[(y, x) + d_i, 2]
//
// written as contiguous (81, H, W) planes, the layout of the CNN's output.
// The image's gradient is a gather. Padded position p takes
//
//   G[p, c] = sum over i = 0 .. 80, in order, of
//             g[p - d_i, c] * ker[i, p - d_i]   (p - d_i inside the image)
//
// starting from 0, and image pixel (y, x) adds the G of the padded
// positions that reflect onto it, starting from 0, rows in the order
// direct (y + pad), top mirror (pad - y, for 1 <= y <= pad), bottom mirror
// (pad + 2 (H - 1) - y, for H - 1 - pad <= y <= H - 2), and within a row
// the columns in the same order: 1, 2 or 4 positions, up to 9 where H or W
// is at most 2 pad + 1. Each product and add is rounded to float32 on its
// own. The order differs from autograd's, so the gradients agree with the
// plain version's within rounding, not bit for bit.
//
// What bounds it on an H100: bytes. The kernel map is read once and its
// gradient written once (207.4 MB each at 800x800); the image and
// the cotangent are staged into shared memory with a halo of pad and the
// image's gradient written once: 0.131 ms at 3.35 TB/s, against 486 FP32
// multiply-adds a pixel. A warp is one row of 32 pixels, so the map's
// gradient is written and the map read (shifted by d_i, through L1/L2) 128
// contiguous bytes a tap; the cotangent's neighbours come from shared
// memory. The gather is the slower half, as its reads are shifted: a thread
// loads three rows of taps before it adds them, and a tile away from the
// borders (most of them) takes a path without the mirror and bounds checks.

#include "denoise_common.cuh"

namespace {

using denoise::kK;
using denoise::kPad;
using denoise::kThreads;
using denoise::kTileX;
using denoise::kTileY;
using denoise::kWinSize;
using denoise::kWinW;
using denoise::Strides;

// the padded position (row or column) that mirror m of image row y (of n)
// reflects from, as listed above; false where there is none
__device__ __forceinline__ bool mirror(int m, int y, int n, int& p) {
  if (m == 0) {
    p = y + kPad;
    return true;
  }
  if (m == 1) {
    p = kPad - y;
    return y >= 1 && y <= kPad;
  }
  p = kPad + 2 * (n - 1) - y;
  return y >= n - 1 - kPad && y <= n - 2;
}

// G of padded position (py, px), added into u: the sources' map values are
// loaded three rows of taps (27) at a time before they are used, so that a
// thread has that many loads in flight. Inside: every source lies in the
// image, so no tap is checked. s_g is the block's staged cotangent, (y0,
// x0) its tile.
template <bool Inside>
__device__ __forceinline__ void position_sum(const float* __restrict__ ker,
                                             const float* s_g, long long hw,
                                             int h, int w, int y0, int x0,
                                             int py, int px, float u[3]) {
  constexpr int kBatch = 3 * kK;
  const float* at = ker + static_cast<long long>(py) * w + px;
#pragma unroll
  for (int b = 0; b < kK * kK; b += kBatch) {
    float kv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int dy = (b + j) / kK, dx = (b + j) % kK;
      const bool ok =
          Inside || (py - dy >= 0 && py - dy < h && px - dx >= 0 &&
                     px - dx < w);
      kv[j] = ok ? __ldg(at + (b + j) * hw - dy * w - dx) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int dy = (b + j) / kK, dx = (b + j) % kK;
      if (!Inside && (py - dy < 0 || py - dy >= h || px - dx < 0 ||
                      px - dx >= w))
        continue;
      const int e = (py - dy - y0 + kPad) * kWinW + px - dx - x0 + kPad;
      u[0] = __fadd_rn(u[0], __fmul_rn(s_g[e], kv[j]));
      u[1] = __fadd_rn(u[1], __fmul_rn(s_g[kWinSize + e], kv[j]));
      u[2] = __fadd_rn(u[2], __fmul_rn(s_g[2 * kWinSize + e], kv[j]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    denoise_bwd_kernel(const float* __restrict__ img, Strides is,
                       const float* __restrict__ ker,
                       const float* __restrict__ g, Strides gs,
                       float* __restrict__ g_img, Strides gis,
                       float* __restrict__ g_ker, int h, int w) {
  constexpr int kN = kWinSize;
  __shared__ float s_img[3 * kN];  // the reflected image, for g_ker
  __shared__ float s_g[3 * kN];    // the cotangent, zero outside the image
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  if (g_ker != nullptr) denoise::stage(s_img, img, is, h, w, y0, x0, true);
  denoise::stage(s_g, g, gs, h, w, y0, x0, false);
  __syncthreads();

  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= w || y >= h) return;
  const long long hw = static_cast<long long>(h) * w;

  if (g_ker != nullptr) {
    const long long at = static_cast<long long>(y) * w + x;
    const int c = (ty + kPad) * kWinW + tx + kPad;
    const float g0 = s_g[c], g1 = s_g[kN + c], g2 = s_g[2 * kN + c];
#pragma unroll
    for (int i = 0; i < kK * kK; ++i) {
      const int e = (ty + i / kK) * kWinW + tx + i % kK;
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(g0, s_img[e]),
                                          __fmul_rn(g1, s_img[kN + e])),
                                __fmul_rn(g2, s_img[2 * kN + e]));
      __stcs(g_ker + i * hw + at, v);
    }
  }

  if (g_img == nullptr) return;
  float t[3] = {0.f, 0.f, 0.f};
  // a tile whose pixels reflect from no border and read no source outside
  // the image: each pixel has its direct position alone (most tiles)
  if (y0 > kPad && y0 + kTileY < h - kPad && x0 > kPad &&
      x0 + kTileX < w - kPad) {
    float u[3] = {0.f, 0.f, 0.f};
    position_sum<true>(ker, s_g, hw, h, w, y0, x0, y + kPad, x + kPad, u);
    for (int c = 0; c < 3; ++c) t[c] = __fadd_rn(t[c], u[c]);
  } else {
#pragma unroll 1
    for (int my = 0; my < 3; ++my) {
      int py;
      if (!mirror(my, y, h, py)) continue;
#pragma unroll 1
      for (int mx = 0; mx < 3; ++mx) {
        int px;
        if (!mirror(mx, x, w, px)) continue;
        float u[3] = {0.f, 0.f, 0.f};
        position_sum<false>(ker, s_g, hw, h, w, y0, x0, py, px, u);
        for (int c = 0; c < 3; ++c) t[c] = __fadd_rn(t[c], u[c]);
      }
    }
  }
  float* o = g_img + y * gis.y + x * gis.x;
  o[0] = t[0];
  o[gis.c] = t[1];
  o[2 * gis.c] = t[2];
}

}  // namespace

extern "C" {

// The gradients of denoise_fwd from the output's cotangent g (H, W, 3):
// g_img (H, W, 3) of img, and g_ker, (81, H, W) contiguous planes, of the
// kernel map ker (the same planes); img, g and g_img by element strides
// (y, x, c). Either output may be null, and is then not computed. float32
// on the device, outputs apart from the inputs. Launches on `stream` and
// returns cudaGetLastError() (0 on success); cudaErrorInvalidValue for
// 4 >= H or W (the reflect padding's contract) or for more rows of tiles
// than a grid holds.
int denoise_bwd(const float* img, long long isy, long long isx, long long isc,
                const float* ker, const float* g, long long gsy, long long gsx,
                long long gsc, float* g_img, long long gisy, long long gisx,
                long long gisc, float* g_ker, int h, int w, void* stream) {
  if (kPad >= h || kPad >= w || (h + kTileY - 1) / kTileY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_img == nullptr && g_ker == nullptr) return 0;
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  denoise_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, Strides{isy, isx, isc}, ker, g, Strides{gsy, gsx, gsc}, g_img,
      Strides{gisy, gisx, gisc}, g_ker, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* denoise_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
