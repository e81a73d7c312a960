// Forward of the per-Gaussian preprocess, for Hopper (sm_90a): project,
// EWA 2D covariance, conic and radius, tile rect, SH colour, for every
// Gaussian of one camera in one pass.
//
// Replaces no TPU kernel: the JAX package leaves this pass
// (neuralgaussiansplatting_tpu/ops/preprocess.py) to XLA, which fuses it.
// Eagerly PyTorch ran it as ~430 kernels that wrote and re-read dozens of
// (N,) intermediates (ops/preprocess.py::preprocess_gaussians_reference, the
// plain version, keeps that code op for op). Contract: every Preprocessed
// field but the opacity (the input itself), with the optional
// means2d_offset shift applied to means2d after the rects are taken from
// the unshifted centre, as ops/rasterize.py used to shift it.
//
// What bounds it on an H100: bytes. Per Gaussian it reads xyz 3, scale 3,
// rotation 4, opacity 1 and 3 (deg + 1)^2 SH floats (and the offset's 2), and
// writes means2d 2, depth 1, radius 1, conic 3, rgb 3, the rects 4 and tiles
// 1: 74 x 4 B at degree 3, ~0.44 ms for 5M Gaussians at 3.35 TB/s; its
// ~400 FP32 operations a Gaussian take ~0.03 ms. So the design keeps every
// load and store coalesced: one thread a Gaussian, 128 a block; the block's
// SH rows (128 x 192 B at degree 3, one contiguous span) and its (N, 3) rows
// are staged through shared memory with float4 loads, the SH rows at an odd
// pitch so that each thread's walk along its own row is free of bank
// conflicts; (N, 4) rotations are one float4 a thread, (N, 2) and (N,)
// outputs one float2 or float a thread, and conic and rgb go out through
// shared memory as float4 stores.
//
// With precomputed colours (Scaffold-GS hands the rasterizer its decoded
// colours) the kernel is instantiated at DEG = kColors: no SH rows are read
// and no colour is written, since the colour output is the input tensor
// itself, as the opacity is: 23 floats a Gaussian, ~0.22 ms for 8M at
// 3.35 TB/s.

#include <cuda_runtime.h>

#include "preprocess_common.cuh"

namespace {

using namespace preprocess;

struct FwdArgs {
  const float* means;
  const float* scales;
  const float* rots;
  const float* opac;
  const float* shs;
  long long sh_stride;
  const float* view;
  const float* full_proj;
  const float* campos;
  const float* offset;  // (n, 2) or null
  float* means2d;
  float* depths;
  int* radii;
  float* conic;
  float* rgb;
  int* rect_min;
  int* rect_max;
  int* tiles;
};

template <int DEG>
__global__ void __launch_bounds__(kRows)
preprocess_fwd_kernel(const FwdArgs a, const Settings s) {
  constexpr int NC = 3 * (DEG + 1) * (DEG + 1);
  constexpr int PITCH = NC | 1;
  __shared__ __align__(16) float s_sh[kRows * PITCH];
  __shared__ __align__(16) float s_m[kRows * 3];   // means, then conic
  __shared__ __align__(16) float s_s[kRows * 3];   // scales, then rgb
  __shared__ float cam[kCam];

  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        s.n - base));
  const int t = threadIdx.x;
  load_camera(cam, a.view, a.full_proj, a.campos);
  stage_in<3, 3>(s_m, a.means, base, rows, 3);
  stage_in<3, 3>(s_s, a.scales, base, rows, 3);
  if constexpr (DEG >= 0) {
    stage_in<NC, PITCH>(s_sh, a.shs, base, rows, a.sh_stride);
  }
  const long long i = base + t;
  float4 rot = make_float4(0.f, 0.f, 0.f, 0.f);
  float op = 0.f;
  float2 off = make_float2(0.f, 0.f);
  if (t < rows) {
    rot = load_row4(a.rots, i);
    op = __ldg(a.opac + i);
    if (a.offset) off = __ldg(reinterpret_cast<const float2*>(a.offset) + i);
  }
  __syncthreads();

  if (t < rows) {
    float m[3], sc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = s_m[3 * t + k];
      sc[k] = s_s[3 * t + k];
    }
    RowOut o;
    forward_row<DEG>(m, sc, rot, op, a.offset ? &off : nullptr,
                     s_sh + t * PITCH, cam, s, o);
    reinterpret_cast<float2*>(a.means2d)[i] = o.means2d;
    a.depths[i] = o.depth;
    a.radii[i] = o.radius;
    reinterpret_cast<int2*>(a.rect_min)[i] = o.lo;
    reinterpret_cast<int2*>(a.rect_max)[i] = o.hi;
    a.tiles[i] = o.tiles;
    // each thread overwrites only its own staged row
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_m[3 * t + k] = o.conic[k];
      if constexpr (DEG >= 0) s_s[3 * t + k] = o.rgb[k];
    }
  }
  __syncthreads();
  stage_out<3, 3>(a.conic, s_m, base, rows, 3);
  if constexpr (DEG >= 0) stage_out<3, 3>(a.rgb, s_s, base, rows, 3);
}

template <int DEG>
int launch(const FwdArgs& a, const Settings& s, cudaStream_t stream) {
  const long long blocks = (s.n + kRows - 1) / kRows;
  preprocess_fwd_kernel<DEG>
      <<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

// The surfel variant (2D Gaussian Splatting): two scales a row; out go the
// box's centre, the depth, the radius, the rects and tiles, the transform
// (9 floats), the view-space normal and rgb.
struct SurfelFwdArgs {
  const float* means;
  const float* scales;  // (n, 2)
  const float* rots;
  const float* opac;
  const float* shs;
  long long sh_stride;
  const float* view;
  const float* full_proj;
  const float* campos;
  const float* offset;  // (n, 2) or null
  float* means2d;
  float* depths;
  int* radii;
  float* transmat;  // (n, 9)
  float* normal;    // (n, 3)
  float* rgb;
  int* rect_min;
  int* rect_max;
  int* tiles;
};

template <int DEG>
__global__ void __launch_bounds__(kRows)
preprocess_surfel_fwd_kernel(const SurfelFwdArgs a, const Settings s) {
  constexpr int NC = DEG >= 0 ? 3 * (DEG + 1) * (DEG + 1) : 1;
  constexpr int PITCH = NC | 1;
  __shared__ __align__(16) float s_sh[kRows * PITCH];
  __shared__ __align__(16) float s_m[kRows * 3];   // means, then normal
  __shared__ __align__(16) float s_s[kRows * 3];   // scales, then rgb
  __shared__ __align__(16) float s_t[kRows * 9];   // the transforms
  __shared__ float cam[kCam];

  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        s.n - base));
  const int t = threadIdx.x;
  load_camera(cam, a.view, a.full_proj, a.campos);
  stage_in<3, 3>(s_m, a.means, base, rows, 3);
  stage_in<2, 2>(s_s, a.scales, base, rows, 2);
  if constexpr (DEG >= 0) {
    stage_in<NC, PITCH>(s_sh, a.shs, base, rows, a.sh_stride);
  }
  const long long i = base + t;
  float4 rot = make_float4(0.f, 0.f, 0.f, 0.f);
  float op = 0.f;
  float2 off = make_float2(0.f, 0.f);
  if (t < rows) {
    rot = load_row4(a.rots, i);
    op = __ldg(a.opac + i);
    if (a.offset) off = __ldg(reinterpret_cast<const float2*>(a.offset) + i);
  }
  __syncthreads();

  float m[3], sc[2];
  if (t < rows) {
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = s_m[3 * t + k];
    sc[0] = s_s[2 * t];
    sc[1] = s_s[2 * t + 1];
  }
  __syncthreads();  // s_m and s_s are rewritten below
  if (t < rows) {
    SurfelOut o;
    forward_surfel_row<DEG>(m, sc, rot, op, a.offset ? &off : nullptr,
                            s_sh + t * PITCH, cam, s, o);
    reinterpret_cast<float2*>(a.means2d)[i] = o.centre;
    a.depths[i] = o.depth;
    a.radii[i] = o.radius;
    reinterpret_cast<int2*>(a.rect_min)[i] = o.lo;
    reinterpret_cast<int2*>(a.rect_max)[i] = o.hi;
    a.tiles[i] = o.tiles;
#pragma unroll
    for (int k = 0; k < 9; ++k) s_t[9 * t + k] = o.T[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_m[3 * t + k] = o.normal[k];
      s_s[3 * t + k] = o.rgb[k];
    }
  }
  __syncthreads();
  stage_out<9, 9>(a.transmat, s_t, base, rows, 9);
  stage_out<3, 3>(a.normal, s_m, base, rows, 3);
  if constexpr (DEG >= 0) stage_out<3, 3>(a.rgb, s_s, base, rows, 3);
}

template <int DEG>
int launch_surfel(const SurfelFwdArgs& a, const Settings& s,
                  cudaStream_t stream) {
  const long long blocks = (s.n + kRows - 1) / kRows;
  preprocess_surfel_fwd_kernel<DEG>
      <<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// means, scales: (n, 3); rots: (n, 4); opac: (n,); shs: (n, sh_stride),
// coefficient-major, its first 3 (sh_degree + 1)^2 columns read; view,
// full_proj: (4, 4) applied as M @ p; campos: (3,); offset: (n, 2) or null.
// All float32, contiguous, on the device. Outputs (n, 2) means2d, (n,)
// depths, (n,) int32 radii, (n, 3) conic, (n, 3) rgb, (n, 2) int32 rect_min
// and rect_max, (n,) int32 tiles. sh_degree -1 (kColors) is the variant for
// precomputed colours: shs and rgb are not touched (null) and may be null.
// Launches on `stream` and returns cudaGetLastError() (0 on success); 1
// (cudaErrorInvalidValue) for a degree outside -1..3.
int preprocess_fwd(const void* means, const void* scales, const void* rots,
                   const void* opac, const void* shs, long long sh_stride,
                   int sh_degree, const void* view, const void* full_proj,
                   const void* campos, const void* offset, long long n,
                   float focal_x, float focal_y, float limit_x, float limit_y,
                   int width, int height, int tiles_x, int tiles_y,
                   int block_x, int block_y, float scale_modifier, int tight,
                   void* means2d, void* depths, void* radii, void* conic,
                   void* rgb, void* rect_min, void* rect_max, void* tiles,
                   void* stream) {
  if (n <= 0) return 0;
  const FwdArgs a{static_cast<const float*>(means),
                  static_cast<const float*>(scales),
                  static_cast<const float*>(rots),
                  static_cast<const float*>(opac),
                  static_cast<const float*>(shs),
                  sh_stride,
                  static_cast<const float*>(view),
                  static_cast<const float*>(full_proj),
                  static_cast<const float*>(campos),
                  static_cast<const float*>(offset),
                  static_cast<float*>(means2d),
                  static_cast<float*>(depths),
                  static_cast<int*>(radii),
                  static_cast<float*>(conic),
                  static_cast<float*>(rgb),
                  static_cast<int*>(rect_min),
                  static_cast<int*>(rect_max),
                  static_cast<int*>(tiles)};
  const float bx = static_cast<float>(block_x);
  const float by = static_cast<float>(block_y);
  const Settings s{n, focal_x, focal_y, limit_x, limit_y,
                   static_cast<float>(width), static_cast<float>(height),
                   static_cast<float>(width * 0.5),
                   static_cast<float>(height * 0.5),
                   tiles_x, tiles_y, bx, by, 1.f / bx, 1.f / by,
                   scale_modifier, tight};
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

// The surfel variant: means (n, 3), scales (n, 2), rots (n, 4), opac (n,),
// shs and the camera as preprocess_fwd's; out (n, 2) means2d (the box's
// centre), (n,) depths, (n,) int32 radii, (n, 9) transmat, (n, 3) normal,
// (n, 3) rgb, (n, 2) int32 rect_min and rect_max, (n,) int32 tiles. All
// float32 but the ints, contiguous, on the device, the outputs 16-byte
// aligned. sh_degree -1 (kColors) reads no SH and writes no rgb.
int preprocess_surfel_fwd(const void* means, const void* scales,
                          const void* rots, const void* opac,
                          const void* shs, long long sh_stride,
                          int sh_degree, const void* view,
                          const void* full_proj, const void* campos,
                          const void* offset, long long n, int width,
                          int height, int tiles_x, int tiles_y, int block_x,
                          int block_y, float scale_modifier, void* means2d,
                          void* depths, void* radii, void* transmat,
                          void* normal, void* rgb, void* rect_min,
                          void* rect_max, void* tiles, void* stream) {
  if (n <= 0) return 0;
  const SurfelFwdArgs a{static_cast<const float*>(means),
                        static_cast<const float*>(scales),
                        static_cast<const float*>(rots),
                        static_cast<const float*>(opac),
                        static_cast<const float*>(shs),
                        sh_stride,
                        static_cast<const float*>(view),
                        static_cast<const float*>(full_proj),
                        static_cast<const float*>(campos),
                        static_cast<const float*>(offset),
                        static_cast<float*>(means2d),
                        static_cast<float*>(depths),
                        static_cast<int*>(radii),
                        static_cast<float*>(transmat),
                        static_cast<float*>(normal),
                        static_cast<float*>(rgb),
                        static_cast<int*>(rect_min),
                        static_cast<int*>(rect_max),
                        static_cast<int*>(tiles)};
  const float bx = static_cast<float>(block_x);
  const float by = static_cast<float>(block_y);
  const Settings s{n, 0.f, 0.f, 0.f, 0.f,
                   static_cast<float>(width), static_cast<float>(height),
                   static_cast<float>(width * 0.5),
                   static_cast<float>(height * 0.5),
                   tiles_x, tiles_y, bx, by, 1.f / bx, 1.f / by,
                   scale_modifier, 0};
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

const char* preprocess_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
