// The alpha-floor cutoff and box that K1 and K2 (blend_seq_{fwd,bwd}.cu) and
// K4 and K5 (blend_pallas_{fwd,bwd}.cu) give each staged instance, evaluated
// by the same device code (blend_common.cuh's stage) for every column of
// a packed table.
// Not a kernel of the render: the card tests sweep these values against
// ops/blend.py's PyTorch versions and against the float32 alpha they
// must bound, and chip_smoke.py counts with them the pairs the blend needs.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

__global__ void blend_stage_kernel(const float* __restrict__ packed,
                                   long long k, float* __restrict__ out) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (col >= k) return;
  const Staged st = stage(packed, k, col, true);
  out[0 * k + col] = st.cut;
  out[1 * k + col] = st.box.x;
  out[2 * k + col] = st.box.y;
  out[3 * k + col] = st.box.z;
  out[4 * k + col] = st.box.w;
}

}  // namespace

extern "C" {

// packed: (9, k) float32 row-major; out: (5, k) float32, per column the
// cutoff and the box (x_lo, x_hi, y_lo, y_hi). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int blend_stage(const void* packed, long long k, void* out, void* stream) {
  if (k <= 0) return 0;
  const int threads = 256;
  const long long blocks = (k + threads - 1) / threads;
  blend_stage_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* blend_stage_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
