// Backward of the per-Gaussian preprocess (preprocess_fwd.cu), for Hopper
// (sm_90a): from the gradients of means2d, conic and rgb, the gradients of
// the means, scales, rotations, SH rows and the means2d offset.
//
// Replaces no TPU kernel: the JAX package differentiates this pass with
// jax.grad under XLA. Eagerly, autograd through the plain version
// (ops/preprocess.py::preprocess_gaussians_reference) ran ~680 kernels: a
// node per tensor op, zero fills for every column slice, and four sums into
// the means' gradient (the view transform, the projection, the EWA Jacobian,
// the SH direction). Here one thread a Gaussian recomputes the forward from
// the saved inputs, as the original 3DGS CUDA backward does, and walks it
// back. Each Gaussian's gradient is its own sum, so there are no atomics and
// two launches are bit-equal.
//
// At every clamp, clamp_min, where and ceil it takes the branch autograd
// takes through the tensor code: clamp and clamp_min pass the gradient where
// the input lies inside the bounds, ends included; the |z| >= 0.01 floor,
// the 1e-6 floor of w, the det != 0 select and the 1e-16 guards of the two
// normalisations pass it only where they left the value as it was; ceil
// (the radius, the tight extents) passes none, so the radius, the rects and
// the depth carry no gradient. The opacity's gradient does not pass here:
// the opacity output is the input tensor itself.
//
// What bounds it on an H100: bytes. Per Gaussian it reads xyz 3, scale 3,
// rotation 4 and 3 (deg + 1)^2 SH floats and the upstream gradients 2 + 3 +
// 3, and writes the gradients 3 + 3 + 4 + 3 (deg + 1)^2 + 2: ~126 x 4 B at
// degree 3, ~0.75 ms for 5M Gaussians at 3.35 TB/s. The staging is the
// forward's: the SH rows and the (N, 3) rows go through shared memory with
// float4 loads and stores (the SH gradient overwrites its own row there), the
// rest one float4, float2 or float a thread. With precomputed colours (DEG =
// kColors) no SH row or colour gradient is read and no SH gradient written:
// 25 floats a Gaussian, ~0.24 ms for 8M.

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

namespace {

using namespace preprocess;

struct BwdArgs {
  const float* means;
  const float* scales;
  const float* rots;
  const float* shs;
  long long sh_stride;
  const float* view;
  const float* full_proj;
  const float* campos;
  const float* g_means2d;  // (n, 2)
  const float* g_conic;    // (n, 3)
  const float* g_rgb;      // (n, 3)
  float* g_means;
  float* g_scales;
  float* g_rots;
  float* g_shs;
  float* g_offset;  // (n, 2) or null
};

// Six blocks an SM: on an H100 the register cap (80 at degree 3, a few
// bytes spilled) took the kernel from 1.23 to 1.10 ms at 5M Gaussians
// against 111 registers and four blocks; 96 (five blocks) read 1.12 ms and
// 64 (eight), with more spills, 1.27. The gradients are the same bits.
template <int DEG>
__global__ void __launch_bounds__(kRows, 6)
preprocess_bwd_kernel(const BwdArgs a, const Settings s) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  constexpr int NC = 3 * K;
  constexpr int PITCH = NC | 1;
  __shared__ __align__(16) float s_sh[kRows * PITCH];  // SH, then its grad
  __shared__ __align__(16) float s_m[kRows * 3];   // means, then their grad
  __shared__ __align__(16) float s_s[kRows * 3];   // scales, then their grad
  __shared__ __align__(16) float s_gc[kRows * 3];
  __shared__ __align__(16) float s_gr[kRows * 3];
  __shared__ float cam[kCam];

  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        s.n - base));
  const int t = threadIdx.x;
  load_camera(cam, a.view, a.full_proj, a.campos);
  stage_in<3, 3>(s_m, a.means, base, rows, 3);
  stage_in<3, 3>(s_s, a.scales, base, rows, 3);
  stage_in<3, 3>(s_gc, a.g_conic, base, rows, 3);
  if constexpr (DEG >= 0) {
    stage_in<3, 3>(s_gr, a.g_rgb, base, rows, 3);
    stage_in<NC, PITCH>(s_sh, a.shs, base, rows, a.sh_stride);
  }
  const long long i = base + t;
  float4 rot = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 gm = make_float2(0.f, 0.f);
  if (t < rows) {
    rot = load_row4(a.rots, i);
    gm = __ldg(reinterpret_cast<const float2*>(a.g_means2d) + i);
  }
  __syncthreads();

  if (t < rows) {
    float m[3], sc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = s_m[3 * t + k];
      sc[k] = s_s[3 * t + k];
    }
    RowGrad g;
    backward_row<DEG>(m, sc, rot, s_sh + t * PITCH, gm, s_gc + 3 * t,
                      s_gr + 3 * t, cam, s, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_m[3 * t + k] = g.mean[k];
      s_s[3 * t + k] = g.scale[k];
    }
    reinterpret_cast<float4*>(a.g_rots)[i] =
        make_float4(g.rot[0], g.rot[1], g.rot[2], g.rot[3]);
    if (a.g_offset) reinterpret_cast<float2*>(a.g_offset)[i] = g.offset;
  }
  __syncthreads();
  stage_out<3, 3>(a.g_means, s_m, base, rows, 3);
  stage_out<3, 3>(a.g_scales, s_s, base, rows, 3);
  if constexpr (DEG >= 0) {
    stage_out<NC, PITCH>(a.g_shs, s_sh, base, rows, a.sh_stride);
  }
}

template <int DEG>
int launch(const BwdArgs& a, const Settings& s, cudaStream_t stream) {
  const long long blocks = (s.n + kRows - 1) / kRows;
  preprocess_bwd_kernel<DEG>
      <<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

// The surfel variant (2D Gaussian Splatting): from the gradients of the
// box's centre (n, 2), the transform (n, 9), the normal (n, 3) and rgb, the
// gradients of the means, the two scales, the rotations, the SH rows and
// the offset.
struct SurfelBwdArgs {
  const float* means;
  const float* scales;  // (n, 2)
  const float* rots;
  const float* shs;
  long long sh_stride;
  const float* view;
  const float* full_proj;
  const float* campos;
  const float* g_means2d;   // (n, 2)
  const float* g_transmat;  // (n, 9)
  const float* g_normal;    // (n, 3)
  const float* g_rgb;       // (n, 3)
  float* g_means;
  float* g_scales;          // (n, 2)
  float* g_rots;
  float* g_shs;
  float* g_offset;  // (n, 2) or null
};

template <int DEG>
__global__ void __launch_bounds__(kRows, 4)
preprocess_surfel_bwd_kernel(const SurfelBwdArgs a, const Settings s) {
  constexpr int NC = DEG >= 0 ? 3 * (DEG + 1) * (DEG + 1) : 1;
  constexpr int PITCH = NC | 1;
  __shared__ __align__(16) float s_sh[kRows * PITCH];  // SH, then its grad
  __shared__ __align__(16) float s_m[kRows * 3];   // means, then their grad
  __shared__ __align__(16) float s_s[kRows * 2];   // scales, then their grad
  __shared__ __align__(16) float s_gt[kRows * 9];
  __shared__ __align__(16) float s_gn[kRows * 3];
  __shared__ __align__(16) float s_gr[kRows * 3];
  __shared__ float cam[kCam];

  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        s.n - base));
  const int t = threadIdx.x;
  load_camera(cam, a.view, a.full_proj, a.campos);
  stage_in<3, 3>(s_m, a.means, base, rows, 3);
  stage_in<2, 2>(s_s, a.scales, base, rows, 2);
  stage_in<9, 9>(s_gt, a.g_transmat, base, rows, 9);
  stage_in<3, 3>(s_gn, a.g_normal, base, rows, 3);
  if constexpr (DEG >= 0) {
    stage_in<3, 3>(s_gr, a.g_rgb, base, rows, 3);
    stage_in<NC, PITCH>(s_sh, a.shs, base, rows, a.sh_stride);
  }
  const long long i = base + t;
  float4 rot = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 gm = make_float2(0.f, 0.f);
  if (t < rows) {
    rot = load_row4(a.rots, i);
    gm = __ldg(reinterpret_cast<const float2*>(a.g_means2d) + i);
  }
  __syncthreads();

  if (t < rows) {
    float m[3], sc[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = s_m[3 * t + k];
    sc[0] = s_s[2 * t];
    sc[1] = s_s[2 * t + 1];
    SurfelGrad g;
    backward_surfel_row<DEG>(m, sc, rot, s_sh + t * PITCH, gm, s_gt + 9 * t,
                             s_gn + 3 * t, s_gr + 3 * t, cam, s, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) s_m[3 * t + k] = g.mean[k];
    s_s[2 * t] = g.scale[0];
    s_s[2 * t + 1] = g.scale[1];
    reinterpret_cast<float4*>(a.g_rots)[i] =
        make_float4(g.rot[0], g.rot[1], g.rot[2], g.rot[3]);
    if (a.g_offset) reinterpret_cast<float2*>(a.g_offset)[i] = g.offset;
  }
  __syncthreads();
  stage_out<3, 3>(a.g_means, s_m, base, rows, 3);
  stage_out<2, 2>(a.g_scales, s_s, base, rows, 2);
  if constexpr (DEG >= 0) {
    stage_out<NC, PITCH>(a.g_shs, s_sh, base, rows, a.sh_stride);
  }
}

template <int DEG>
int launch_surfel(const SurfelBwdArgs& a, const Settings& s,
                  cudaStream_t stream) {
  const long long blocks = (s.n + kRows - 1) / kRows;
  preprocess_surfel_bwd_kernel<DEG>
      <<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward's inputs (preprocess_fwd.cu; the opacity and offset values
// are not needed) and settings, the upstream gradients g_means2d (n, 2),
// g_conic (n, 3), g_rgb (n, 3); outputs g_means (n, 3), g_scales (n, 3),
// g_rots (n, 4), g_shs (n, sh_stride: the columns past 3 (sh_degree + 1)^2
// are zero) and g_offset (n, 2) or null. All float32, contiguous, on the
// device; the outputs 16-byte aligned. sh_degree -1 (kColors) is the
// variant for precomputed colours: shs, g_rgb and g_shs are not touched and
// may be null (the colours' gradient is g_rgb itself). Launches on `stream`
// and returns cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue)
// for a degree outside -1..3.
int preprocess_bwd(const void* means, const void* scales, const void* rots,
                   const void* shs, long long sh_stride, int sh_degree,
                   const void* view, const void* full_proj,
                   const void* campos, long long n, float focal_x,
                   float focal_y, float limit_x, float limit_y, int width,
                   int height, float scale_modifier, const void* g_means2d,
                   const void* g_conic, const void* g_rgb, void* g_means,
                   void* g_scales, void* g_rots, void* g_shs, void* g_offset,
                   void* stream) {
  if (n <= 0) return 0;
  const BwdArgs a{static_cast<const float*>(means),
                  static_cast<const float*>(scales),
                  static_cast<const float*>(rots),
                  static_cast<const float*>(shs),
                  sh_stride,
                  static_cast<const float*>(view),
                  static_cast<const float*>(full_proj),
                  static_cast<const float*>(campos),
                  static_cast<const float*>(g_means2d),
                  static_cast<const float*>(g_conic),
                  static_cast<const float*>(g_rgb),
                  static_cast<float*>(g_means),
                  static_cast<float*>(g_scales),
                  static_cast<float*>(g_rots),
                  static_cast<float*>(g_shs),
                  static_cast<float*>(g_offset)};
  Settings s{};
  s.n = n;
  s.focal_x = focal_x;
  s.focal_y = focal_y;
  s.limit_x = limit_x;
  s.limit_y = limit_y;
  s.width = static_cast<float>(width);
  s.height = static_cast<float>(height);
  s.half_w = static_cast<float>(width * 0.5);
  s.half_h = static_cast<float>(height * 0.5);
  s.scale_modifier = scale_modifier;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh_degree) {
    case 0: return launch<0>(a, s, st);
    case 1: return launch<1>(a, s, st);
    case 2: return launch<2>(a, s, st);
    case 3: return launch<3>(a, s, st);
    case kColors: return launch<kColors>(a, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The surfel variant: preprocess_surfel_fwd's inputs (the opacity and
// offset values are not needed), the upstream gradients g_means2d (n, 2),
// g_transmat (n, 9), g_normal (n, 3), g_rgb (n, 3); outputs g_means (n, 3),
// g_scales (n, 2), g_rots (n, 4), g_shs (n, sh_stride) and g_offset (n, 2)
// or null. sh_degree -1 (kColors) reads no SH or colour gradient and writes
// no SH gradient.
int preprocess_surfel_bwd(const void* means, const void* scales,
                          const void* rots, const void* shs,
                          long long sh_stride, int sh_degree,
                          const void* view, const void* full_proj,
                          const void* campos, long long n, int width,
                          int height, float scale_modifier,
                          const void* g_means2d, const void* g_transmat,
                          const void* g_normal, const void* g_rgb,
                          void* g_means, void* g_scales, void* g_rots,
                          void* g_shs, void* g_offset, void* stream) {
  if (n <= 0) return 0;
  const SurfelBwdArgs a{static_cast<const float*>(means),
                        static_cast<const float*>(scales),
                        static_cast<const float*>(rots),
                        static_cast<const float*>(shs),
                        sh_stride,
                        static_cast<const float*>(view),
                        static_cast<const float*>(full_proj),
                        static_cast<const float*>(campos),
                        static_cast<const float*>(g_means2d),
                        static_cast<const float*>(g_transmat),
                        static_cast<const float*>(g_normal),
                        static_cast<const float*>(g_rgb),
                        static_cast<float*>(g_means),
                        static_cast<float*>(g_scales),
                        static_cast<float*>(g_rots),
                        static_cast<float*>(g_shs),
                        static_cast<float*>(g_offset)};
  Settings s{};
  s.n = n;
  s.width = static_cast<float>(width);
  s.height = static_cast<float>(height);
  s.half_w = static_cast<float>(width * 0.5);
  s.half_h = static_cast<float>(height * 0.5);
  s.scale_modifier = scale_modifier;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh_degree) {
    case 0: return launch_surfel<0>(a, s, st);
    case 1: return launch_surfel<1>(a, s, st);
    case 2: return launch_surfel<2>(a, s, st);
    case 3: return launch_surfel<3>(a, s, st);
    case kColors: return launch_surfel<kColors>(a, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* preprocess_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
