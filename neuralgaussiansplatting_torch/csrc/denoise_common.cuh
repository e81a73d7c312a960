// Shared by csrc/denoise_fwd.cu and csrc/denoise_bwd.cu, the dynamic
// per-pixel filter of the neural path (models/nets.py::denoise): its tile,
// its reflect padding and the staging of a tile's window.
//
// The window is the published 9x9 (kK); the kernels are built for it
// alone. A block takes kTileX x kTileY pixels, one a thread, and stages in
// shared memory the window of an (H, W, 3) image that its pixels' kK x kK
// taps read: the tile with a halo of kPad = kK / 2 on every side,
// channel-major. The window is indexed (row, column) from the tile's corner
// less the halo.

#pragma once

#include <cuda_runtime.h>

namespace denoise {

constexpr int kTileX = 32;  // a warp is one row of the tile
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr int kK = 9;  // the filter's width: kK * kK taps a pixel
constexpr int kPad = kK / 2;
constexpr int kWinW = kTileX + 2 * kPad;  // the staged window's row
constexpr int kWinSize = kWinW * (kTileY + 2 * kPad);  // floats a channel

// element strides of an (H, W, 3) float32 tensor
struct Strides {
  long long y, x, c;
};

// the image row (or column) that padded position p + pad reads: reflected
// without repeating the edge, as nets._reflect_pad does (pad < n). A
// ragged tile's window reaches past the padded extent; those positions,
// which no pixel reads, are clamped to stay inside the image.
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) r = -r;
  if (r >= n) r = 2 * (n - 1) - r;
  return min(max(r, 0), n - 1);
}

// Copy the window of `src` around the tile at (y0, x0) into s[c * kWinSize
// + row * kWinW + col]: reflected when `reflected`, else zero outside the
// image.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ src,
                                      Strides st, int h, int w, int y0,
                                      int x0, bool reflected) {
  for (int e = threadIdx.x; e < kWinSize; e += kThreads) {
    const int row = e / kWinW;
    int y = y0 - kPad + row;
    int x = x0 - kPad + (e - row * kWinW);
    bool inside = y >= 0 && y < h && x >= 0 && x < w;
    if (reflected) {
      y = reflect(y, h);
      x = reflect(x, w);
      inside = true;
    }
    const float* p = src + y * st.y + x * st.x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s[c * kWinSize + e] = inside ? p[c * st.c] : 0.f;
  }
}

}  // namespace denoise
