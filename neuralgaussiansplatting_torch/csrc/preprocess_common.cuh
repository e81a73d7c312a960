// What the preprocess kernels share (preprocess_{fwd,bwd}.cu): the per-
// Gaussian arithmetic of ops/preprocess.py::preprocess_gaussians_reference
// in its operation order, the camera and settings every thread reads, and
// the staging of a block's rows through shared memory.
//
// Order and rounding. The library is built with --fmad=false, so each a*b+c
// rounds twice, as PyTorch's eager kernels round it (one operation each),
// but for the view transform and the projection, which repeat cuBLAS's
// fused multiply-adds (affine_row). Where the tensor code divides by a
// Python scalar (the tile pitch), PyTorch on the card multiplies by the
// scalar's float32 reciprocal, and so do these kernels. Reductions over a
// row (the squared norms) and autograd's sums run in orders of their own:
// those agree to rounding. clamp, clamp_min, maximum and minimum keep
// PyTorch's NaN rules (a NaN operand comes out NaN), and a float converts to
// int32 as PyTorch's .to(torch.int32) does on the card (static_cast).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace preprocess {

constexpr int kRows = 128;  // Gaussians per block, one per thread
constexpr int kCam = 35;    // view (16), full_proj (16), campos (3)
// The degree that instantiates the kernels for precomputed colours: no SH
// read, no colour written, no SH gradient (the colours are the rgb output
// itself, as the opacity is)
constexpr int kColors = -1;

// The float32 values of ops/sh.py's constants.
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f;
constexpr float kC2_1 = -1.0925484305920792f;
constexpr float kC2_2 = 0.31539156525252005f;
constexpr float kC2_3 = -1.0925484305920792f;
constexpr float kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f;
constexpr float kC3_1 = 2.890611442640554f;
constexpr float kC3_2 = -0.4570457994644658f;
constexpr float kC3_3 = 0.3731763325901154f;
constexpr float kC3_4 = -0.4570457994644658f;
constexpr float kC3_5 = 1.445305721320277f;
constexpr float kC3_6 = -0.5900435899266435f;

// The settings of one call, the same for every Gaussian.
struct Settings {
  long long n;
  float focal_x, focal_y, limit_x, limit_y;
  float width, height;  // as float32, as the tensor code's int scalars
  float half_w, half_h; // W * 0.5, H * 0.5: the offset's pixel scale
  int tiles_x, tiles_y;
  float block_x, block_y;
  float inv_bx, inv_by;  // 1 / block, as PyTorch divides by a scalar
  float scale_modifier;
  int tight;
};

// PyTorch's float rules on the card: a NaN operand comes out NaN.
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// projection.tile_rect's clip: clamp(floor(v), 0, hi).to(int32)
__device__ __forceinline__ int clip_tile(float v, int hi) {
  return static_cast<int>(t_clamp(floorf(v), 0.f, static_cast<float>(hi)));
}

// A row of M @ p + t as PyTorch computes points @ M[:, :3].T + M[:, 3] on
// the card: cuBLAS's product sums the three terms in order with fused
// multiply-adds, fma(a2, b2, fma(a1, b1, a0*b0)), and the translation is a
// separate add. The depth has to be these bits: binning sorts by it, and an
// ulp apart two overlapping Gaussians of equal depth would blend in the
// other order.
__device__ __forceinline__ float affine_row(const float* m, const float* row) {
  return fmaf(m[2], row[2], fmaf(m[1], row[1], m[0] * row[0])) + row[3];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The camera's 35 floats into shared memory (every thread reads them).
__device__ __forceinline__ void load_camera(float* cam, const float* view,
                                            const float* full_proj,
                                            const float* campos) {
  const int t = threadIdx.x;
  if (t < 16) cam[t] = view[t];
  else if (t < 32) cam[t] = full_proj[t - 16];
  else if (t < kCam) cam[t] = campos[t - 32];
}

// Rows [base, base + rows) of a row-major (n, stride) float32 array, their
// first NC columns, into shared memory at a pitch of PITCH floats. Where
// the rows are dense (stride == NC) the block's rows are one contiguous
// span, read as float4 where it is 16-byte aligned; else one float at a
// time, neighbouring threads on neighbouring columns.
template <int NC, int PITCH>
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         long long base, int rows,
                                         long long stride) {
  const int count = rows * NC;
  if (stride == NC) {
    const float* span = src + base * NC;
    int head = 0;
    if (aligned16(span)) {
      const int n4 = count >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(span);
      for (int i = threadIdx.x; i < n4; i += kRows) {
        const float4 v = __ldg(s4 + i);
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * i + k;
          dst[(j / NC) * PITCH + j % NC] = f[k];
        }
      }
      head = n4 << 2;
    }
    for (int j = head + threadIdx.x; j < count; j += kRows) {
      dst[(j / NC) * PITCH + j % NC] = __ldg(span + j);
    }
  } else {
    for (int j = threadIdx.x; j < count; j += kRows) {
      const int r = j / NC, c = j % NC;
      dst[r * PITCH + c] = __ldg(src + (base + r) * stride + c);
    }
  }
}

// The way back: rows [base, base + rows) of a row-major (n, stride) array
// from shared memory at a pitch of PITCH; columns NC and above are zero.
template <int NC, int PITCH>
__device__ __forceinline__ void stage_out(float* dst, const float* src,
                                          long long base, int rows,
                                          long long stride) {
  if (stride == NC) {
    const int count = rows * NC;
    float* span = dst + base * NC;
    int head = 0;
    if (aligned16(span)) {
      const int n4 = count >> 2;
      float4* d4 = reinterpret_cast<float4*>(span);
      for (int i = threadIdx.x; i < n4; i += kRows) {
        float f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * i + k;
          f[k] = src[(j / NC) * PITCH + j % NC];
        }
        d4[i] = make_float4(f[0], f[1], f[2], f[3]);
      }
      head = n4 << 2;
    }
    for (int j = head + threadIdx.x; j < count; j += kRows) {
      span[j] = src[(j / NC) * PITCH + j % NC];
    }
  } else {
    const long long count = rows * stride;
    for (long long j = threadIdx.x; j < count; j += kRows) {
      const long long r = j / stride, c = j % stride;
      dst[base * stride + j] = c < NC ? src[r * PITCH + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float4 load_row4(const float* p, long long i) {
  if (aligned16(p)) return __ldg(reinterpret_cast<const float4*>(p) + i);
  const float* r = p + 4 * i;
  return make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
}

// The projection of one mean (projection.transform_points_4x3,
// project_points and ndc2pix).
struct Projected {
  float tx, ty, tz;  // view-space point; tz is the depth
  float ph0, ph1, ph3;  // homogeneous x, y, w
  float denom;          // w + 1e-7, floored to +-1e-6 in magnitude
  bool floored;         // the floor replaced w + 1e-7
  float px, py;         // pixel centre (without the offset)
};

__device__ __forceinline__ Projected project(const float* m, const float* cam,
                                             const Settings& s) {
  const float* V = cam;
  const float* P = cam + 16;
  Projected p;
  p.tx = affine_row(m, V);
  p.ty = affine_row(m, V + 4);
  p.tz = affine_row(m, V + 8);
  p.ph0 = affine_row(m, P);
  p.ph1 = affine_row(m, P + 4);
  p.ph3 = affine_row(m, P + 12);
  const float d = p.ph3 + 1e-7f;
  p.floored = fabsf(d) < 1e-6f;
  p.denom = p.floored ? (d < 0.f ? -1e-6f : 1e-6f) : d;
  const float nx = p.ph0 / p.denom;
  const float ny = p.ph1 / p.denom;
  p.px = ((nx + 1.f) * s.width - 1.f) * 0.5f;
  p.py = ((ny + 1.f) * s.height - 1.f) * 0.5f;
  return p;
}

// preprocess._cov2d_components: the normalised quaternion, the rotation,
// Sigma3D, the clamped view-space point and the EWA 2D covariance, with the
// intermediates the backward needs.
struct Covariance {
  float qn[4];     // normalised quaternion (r, x, y, z)
  float qnorm;     // sqrt(clamp_min(|q|^2, 1e-16))
  bool qpass;      // |q|^2 >= 1e-16 (clamp_min passes the gradient)
  float R[9];
  float sm[3];     // scale * modifier
  float S[6];      // Sigma3D: xx xy xz yy yz zz
  float tz;        // depth with the |z| >= 0.01 floor
  bool tz_pass;    // the floor left the depth as it was
  float rx, ry;    // tx / tz, ty / tz before the clamp
  bool rx_pass, ry_pass;  // inside [-limit, limit] (inclusive)
  float cx, cy;    // the clamped ratios
  float txz, tyz;
  float inv_z, inv_z2;
  float a0, c0, b1, c1;
  float T[6];      // rows T0 = (T00, T01, T02), T1 = (T10, T11, T12)
  float u[3], v[3];
  float cxx, cxy, cyy;
};

__device__ __forceinline__ Covariance covariance(const float* scale,
                                                 const float4 rot,
                                                 const Projected& pr,
                                                 const float* cam,
                                                 const Settings& s) {
  const float* V = cam;
  Covariance c;
  const float q[4] = {rot.x, rot.y, rot.z, rot.w};
  const float sq = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3];
  c.qpass = sq >= 1e-16f;
  c.qnorm = sqrtf(t_clamp_min(sq, 1e-16f));
#pragma unroll
  for (int k = 0; k < 4; ++k) c.qn[k] = q[k] / c.qnorm;
  const float r = c.qn[0], x = c.qn[1], y = c.qn[2], z = c.qn[3];
  c.R[0] = 1.f - 2.f * (y * y + z * z);
  c.R[1] = 2.f * (x * y - r * z);
  c.R[2] = 2.f * (x * z + r * y);
  c.R[3] = 2.f * (x * y + r * z);
  c.R[4] = 1.f - 2.f * (x * x + z * z);
  c.R[5] = 2.f * (y * z - r * x);
  c.R[6] = 2.f * (x * z - r * y);
  c.R[7] = 2.f * (y * z + r * x);
  c.R[8] = 1.f - 2.f * (x * x + y * y);
  float s2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.sm[k] = scale[k] * s.scale_modifier;
    s2[k] = c.sm[k] * c.sm[k];
  }
  const float* R = c.R;
  // S_ab = R_a0 R_b0 s0 + R_a1 R_b1 s1 + R_a2 R_b2 s2, left to right
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float* A = R + 3 * ia[e];
    const float* B = R + 3 * ib[e];
    c.S[e] = (A[0] * B[0] * s2[0] + A[1] * B[1] * s2[1]) + A[2] * B[2] * s2[2];
  }

  c.tz_pass = !(fabsf(pr.tz) < 0.01f);
  c.tz = c.tz_pass ? pr.tz : (pr.tz < 0.f ? -0.01f : 0.01f);
  c.rx = pr.tx / c.tz;
  c.ry = pr.ty / c.tz;
  c.rx_pass = c.rx >= -s.limit_x && c.rx <= s.limit_x;
  c.ry_pass = c.ry >= -s.limit_y && c.ry <= s.limit_y;
  c.cx = t_clamp(c.rx, -s.limit_x, s.limit_x);
  c.cy = t_clamp(c.ry, -s.limit_y, s.limit_y);
  c.txz = c.cx * c.tz;
  c.tyz = c.cy * c.tz;
  c.inv_z = 1.f / c.tz;
  c.inv_z2 = c.inv_z * c.inv_z;
  c.a0 = s.focal_x * c.inv_z;
  c.c0 = -s.focal_x * c.txz * c.inv_z2;
  c.b1 = s.focal_y * c.inv_z;
  c.c1 = -s.focal_y * c.tyz * c.inv_z2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c.T[j] = c.a0 * V[j] + c.c0 * V[8 + j];
    c.T[3 + j] = c.b1 * V[4 + j] + c.c1 * V[8 + j];
  }
  const float* T = c.T;
  const float* S = c.S;  // xx xy xz yy yz zz
  c.u[0] = T[0] * S[0] + T[1] * S[1] + T[2] * S[2];
  c.u[1] = T[0] * S[1] + T[1] * S[3] + T[2] * S[4];
  c.u[2] = T[0] * S[2] + T[1] * S[4] + T[2] * S[5];
  c.v[0] = T[3] * S[0] + T[4] * S[1] + T[5] * S[2];
  c.v[1] = T[3] * S[1] + T[4] * S[3] + T[5] * S[4];
  c.v[2] = T[3] * S[2] + T[4] * S[4] + T[5] * S[5];
  c.cxx = c.u[0] * T[0] + c.u[1] * T[1] + c.u[2] * T[2] + 0.3f;
  c.cxy = c.u[0] * T[3] + c.u[1] * T[4] + c.u[2] * T[5];
  c.cyy = c.v[0] * T[3] + c.v[1] * T[4] + c.v[2] * T[5] + 0.3f;
  return c;
}

// projection.conic_and_radius
struct Conic {
  float det, det_inv;
  float A, B, C;
  float radius;
};

__device__ __forceinline__ Conic conic_of(const Covariance& c) {
  Conic k;
  k.det = c.cxx * c.cyy - c.cxy * c.cxy;
  k.det_inv = k.det != 0.f ? 1.f / k.det : 0.f;
  k.A = c.cyy * k.det_inv;
  k.B = -c.cxy * k.det_inv;
  k.C = c.cxx * k.det_inv;
  const float mid = 0.5f * (c.cxx + c.cyy);
  float d2 = mid * mid - k.det;
  d2 = isfinite(d2) ? d2 : 0.1f;
  const float disc = sqrtf(t_clamp_min(d2, 0.1f));
  const float lambda1 = mid + disc;
  k.radius = ceilf(3.f * sqrtf(t_maximum(lambda1, mid - disc)));
  return k;
}

// The view direction of sh.sh_to_rgb_color: (mean - campos) / |.|.
struct Direction {
  float d[3];    // mean - campos
  float norm;    // sqrt(clamp_min(|d|^2, 1e-16))
  bool pass;     // |d|^2 >= 1e-16
  float x, y, z; // d / norm
};

__device__ __forceinline__ Direction direction(const float* m,
                                               const float* cam) {
  const float* cp = cam + 32;
  Direction r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.d[k] = m[k] - cp[k];
  const float sq = (r.d[0] * r.d[0] + r.d[1] * r.d[1]) + r.d[2] * r.d[2];
  r.pass = sq >= 1e-16f;
  r.norm = sqrtf(t_clamp_min(sq, 1e-16f));
  r.x = r.d[0] / r.norm;
  r.y = r.d[1] / r.norm;
  r.z = r.d[2] / r.norm;
  return r;
}

// sh.eval_sh's per-coefficient factors b[0 .. (DEG + 1)^2), each rounded as
// the tensor code rounds it:
// result = C0 c0 - b1 c1 + b2 c2 - b3 c3 + b4 c4 + ... + b15 c15.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if (DEG > 0) {
    b[1] = kC1 * y;
    b[2] = kC1 * z;
    b[3] = kC1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2_0 * xy;
    b[5] = kC2_1 * yz;
    b[6] = kC2_2 * (2.f * zz - xx - yy);
    b[7] = kC2_3 * xz;
    b[8] = kC2_4 * (xx - yy);
    if (DEG > 2) {
      b[9] = kC3_0 * y * (3.f * xx - yy);
      b[10] = kC3_1 * xy * z;
      b[11] = kC3_2 * y * (4.f * zz - xx - yy);
      b[12] = kC3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      b[13] = kC3_4 * x * (4.f * zz - xx - yy);
      b[14] = kC3_5 * z * (xx - yy);
      b[15] = kC3_6 * x * (xx - 3.f * yy);
    }
  }
}

// eval_sh for one colour channel: `sh` holds the row's coefficients,
// coefficient-major (c l's channel ch at 3 l + ch).
template <int DEG>
__device__ __forceinline__ float sh_channel(const float* b, const float* sh,
                                            int ch) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  float r = b[0] * sh[ch];
#pragma unroll
  for (int l = 1; l < K; ++l) {
    const float t = b[l] * sh[3 * l + ch];
    r = (l == 1 || l == 3) ? r - t : r + t;
  }
  return r;
}

  
// One Gaussian's forward: every Preprocessed field but the opacity.
struct RowOut {
  float2 means2d;  // with the offset's shift
  float depth;
  int radius;      // 0 where culled
  int2 lo, hi;     // tile rect, exclusive hi
  int tiles;
  float conic[3];
  float rgb[3];
};

template <int DEG>
__device__ __forceinline__ void forward_row(const float* m, const float* sc,
                                            const float4 rot, float op,
                                            const float2* off,
                                            const float* sh, const float* cam,
                                            const Settings& s, RowOut& o) {
  const Projected pr = project(m, cam, s);
  const Covariance cv = covariance(sc, rot, pr, cam, s);
  const Conic cn = conic_of(cv);

  // projection.tile_rect on the unshifted centre, the square 3-sigma rect
  const float x = pr.px, y = pr.py, rad = cn.radius;
  const int rmin_x = clip_tile((x - rad) * s.inv_bx, s.tiles_x);
  const int rmin_y = clip_tile((y - rad) * s.inv_by, s.tiles_y);
  const int rmax_x = clip_tile((x + rad + s.block_x - 1.f) * s.inv_bx,
                               s.tiles_x);
  const int rmax_y = clip_tile((y + rad + s.block_y - 1.f) * s.inv_by,
                               s.tiles_y);
  const bool valid = pr.tz > 0.2f && cn.det != 0.f &&
                     (rmax_x - rmin_x) * (rmax_y - rmin_y) > 0 && op > 0.f;
  int2 lo = make_int2(rmin_x, rmin_y), hi = make_int2(rmax_x, rmax_y);
  int tiles;
  if (s.tight) {
    // the opacity-adaptive per-axis extents of the alpha = 1/255 level set
    float two_l = 2.f * logf(t_clamp_min(op, 1e-12f) * 255.f);
    const bool pos = two_l > 0.f;
    two_l = t_clamp_min(two_l, 0.f);
    const float ext_x =
        pos ? t_minimum(rad, ceilf(sqrtf(t_clamp_min(two_l * cv.cxx, 0.f))))
            : 0.f;
    const float ext_y =
        pos ? t_minimum(rad, ceilf(sqrtf(t_clamp_min(two_l * cv.cyy, 0.f))))
            : 0.f;
    lo.x = max(rmin_x, clip_tile((x - ext_x) * s.inv_bx, s.tiles_x));
    lo.y = max(rmin_y, clip_tile((y - ext_y) * s.inv_by, s.tiles_y));
    hi.x = min(rmax_x,
               clip_tile(floorf((x + ext_x) * s.inv_bx) + 1.f, s.tiles_x));
    hi.y = min(rmax_y,
               clip_tile(floorf((y + ext_y) * s.inv_by) + 1.f, s.tiles_y));
    tiles = (valid && pos) ? max(hi.x - lo.x, 0) * max(hi.y - lo.y, 0) : 0;
  } else {
    tiles = valid ? (rmax_x - rmin_x) * (rmax_y - rmin_y) : 0;
  }

  // sh.sh_to_rgb_color: eval_sh + 0.5, clamped at 0 (none with
  // precomputed colours, DEG = kColors: they pass through)
  float col[3] = {0.f, 0.f, 0.f};
  if constexpr (DEG >= 0) {
    const Direction dr = direction(m, cam);
    float b[16];  // the first (DEG + 1)^2 are used
    sh_basis<DEG>(dr.x, dr.y, dr.z, b);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      col[ch] = t_clamp_min(sh_channel<DEG>(b, sh, ch) + 0.5f, 0.f);
    }
  }

  o.means2d = make_float2(x, y);
  if (off) {
    o.means2d.x = x + off->x * s.half_w;
    o.means2d.y = y + off->y * s.half_h;
  }
  o.depth = pr.tz;
  o.radius = valid ? static_cast<int>(rad) : 0;
  o.lo = lo;
  o.hi = hi;
  o.tiles = tiles;
  o.conic[0] = cn.A;
  o.conic[1] = cn.B;
  o.conic[2] = cn.C;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o.rgb[ch] = col[ch];
}

// One Gaussian's backward from the gradients of means2d (gm), conic (gc)
// and rgb (gr): the gradients of the mean, scale, rotation and offset in
// `g`, and of the SH coefficients in place of `sh`'s.
struct RowGrad {
  float mean[3];
  float scale[3];
  float rot[4];
  float2 offset;
};

template <int DEG>
__device__ __forceinline__ void backward_row(const float* m, const float* sc,
                                             const float4 rot, float* sh,
                                             const float2 gm, const float* gc,
                                             const float* gr,
                                             const float* cam,
                                             const Settings& s, RowGrad& g) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  const float* V = cam;
  const float* P = cam + 16;
  const Projected pr = project(m, cam, s);
  const Covariance cv = covariance(sc, rot, pr, cam, s);
  const Conic cn = conic_of(cv);
  float g_m[3] = {0.f, 0.f, 0.f};

  // -- means2d: ndc2pix, the division by the guarded w
  {
    const float nx = pr.ph0 / pr.denom;
    const float ny = pr.ph1 / pr.denom;
    const float g_nx = gm.x * 0.5f * s.width;
    const float g_ny = gm.y * 0.5f * s.height;
    const float g_ph0 = g_nx / pr.denom;
    const float g_ph1 = g_ny / pr.denom;
    const float g_den = -g_nx * (nx / pr.denom) - g_ny * (ny / pr.denom);
    const float g_ph3 = pr.floored ? 0.f : g_den;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_m[k] += (P[k] * g_ph0 + P[4 + k] * g_ph1) + P[12 + k] * g_ph3;
    }
  }

  // -- conic = (cyy, -cxy, cxx) * det_inv
  const float g_dinv = gc[0] * cv.cyy + gc[1] * (-cv.cxy) + gc[2] * cv.cxx;
  // where(det != 0, 1 / det, 0): the branch's gradient is 0 where det is
  // 0, and the reciprocal's backward multiplies it by (1 / det)^2 all the
  // same (NaN there, as autograd gives)
  const float rdet = 1.f / cn.det;
  const float g_det = -(cn.det != 0.f ? g_dinv : 0.f) * (rdet * rdet);
  const float g_cxx = gc[2] * cn.det_inv + g_det * cv.cyy;
  const float g_cyy = gc[0] * cn.det_inv + g_det * cv.cxx;
  const float g_cxy = -(gc[1] * cn.det_inv) - 2.f * g_det * cv.cxy;

  // -- cov2d = (u . T0, u . T1, v . T1), u = T0 S, v = T1 S
  const float* T = cv.T;
  const float* S = cv.S;  // xx xy xz yy yz zz
  float g_u[3], g_v[3], g_T[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_u[j] = g_cxx * T[j] + g_cxy * T[3 + j];
    g_v[j] = g_cyy * T[3 + j];
  }
  // S as a full symmetric matrix, row j
  const int sidx[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float s0 = S[sidx[3 * j]], s1 = S[sidx[3 * j + 1]],
                s2 = S[sidx[3 * j + 2]];
    g_T[j] = g_cxx * cv.u[j] + ((g_u[0] * s0 + g_u[1] * s1) + g_u[2] * s2);
    g_T[3 + j] = (g_cxy * cv.u[j] + g_cyy * cv.v[j]) +
                 ((g_v[0] * s0 + g_v[1] * s1) + g_v[2] * s2);
  }
  float g_S[6];
  g_S[0] = g_u[0] * T[0] + g_v[0] * T[3];
  g_S[1] = (g_u[0] * T[1] + g_u[1] * T[0]) + (g_v[0] * T[4] + g_v[1] * T[3]);
  g_S[2] = (g_u[0] * T[2] + g_u[2] * T[0]) + (g_v[0] * T[5] + g_v[2] * T[3]);
  g_S[3] = g_u[1] * T[1] + g_v[1] * T[4];
  g_S[4] = (g_u[1] * T[2] + g_u[2] * T[1]) + (g_v[1] * T[5] + g_v[2] * T[4]);
  g_S[5] = g_u[2] * T[2] + g_v[2] * T[5];

  // -- T = (a0 W0 + c0 W2, b1 W1 + c1 W2): the Jacobian's terms
  float g_a0 = 0.f, g_c0 = 0.f, g_b1 = 0.f, g_c1 = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_a0 += g_T[j] * V[j];
    g_c0 += g_T[j] * V[8 + j];
    g_b1 += g_T[3 + j] * V[4 + j];
    g_c1 += g_T[3 + j] * V[8 + j];
  }
  const float g_inv_z2 = g_c0 * (-s.focal_x * cv.txz) +
                         g_c1 * (-s.focal_y * cv.tyz);
  const float g_inv_z = (g_a0 * s.focal_x + g_b1 * s.focal_y) +
                        2.f * g_inv_z2 * cv.inv_z;
  const float g_txz = g_c0 * cv.inv_z2 * -s.focal_x;
  const float g_tyz = g_c1 * cv.inv_z2 * -s.focal_y;
  // txz = clamp(tx / tz) * tz; inv_z = 1 / tz
  const float g_rx = cv.rx_pass ? g_txz * cv.tz : 0.f;
  const float g_ry = cv.ry_pass ? g_tyz * cv.tz : 0.f;
  const float g_tz = -g_inv_z * (cv.inv_z * cv.inv_z) + g_txz * cv.cx +
                     g_tyz * cv.cy - g_rx * (cv.rx / cv.tz) -
                     g_ry * (cv.ry / cv.tz);
  const float g_tx = g_rx / cv.tz;
  const float g_ty = g_ry / cv.tz;
  const float g_tz_raw = cv.tz_pass ? g_tz : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_m[k] += (V[k] * g_tx + V[4 + k] * g_ty) + V[8 + k] * g_tz_raw;
  }

  // -- Sigma3D = R diag(s^2) R^T
  const float* R = cv.R;
  const float H[9] = {2.f * g_S[0], g_S[1], g_S[2],
                      g_S[1], 2.f * g_S[3], g_S[4],
                      g_S[2], g_S[4], 2.f * g_S[5]};
  float g_R[9];
  float g_sc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s2k = cv.sm[k] * cv.sm[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      g_R[3 * r + k] = s2k * ((H[3 * r] * R[k] + H[3 * r + 1] * R[3 + k]) +
                              H[3 * r + 2] * R[6 + k]);
    }
    const float g_s2 =
        ((g_S[0] * R[k] * R[k] + g_S[1] * R[k] * R[3 + k]) +
         (g_S[2] * R[k] * R[6 + k] + g_S[3] * R[3 + k] * R[3 + k])) +
        (g_S[4] * R[3 + k] * R[6 + k] + g_S[5] * R[6 + k] * R[6 + k]);
    // (scale * modifier) ** 2
    g_sc[k] = g_s2 * (2.f * cv.sm[k]) * s.scale_modifier;
  }

  // -- R of the normalised quaternion (r, x, y, z)
  // (the gradients of R's nine entries, row-major, in gR)
  const float qr = cv.qn[0], qx = cv.qn[1], qy = cv.qn[2], qz = cv.qn[3];
  const float* gR = g_R;
  float g_q[4];
  g_q[0] = 2.f * (((-qz * gR[1] + qy * gR[2]) + (qz * gR[3] - qx * gR[5])) +
                  (-qy * gR[6] + qx * gR[7]));
  g_q[1] = 2.f * (((qy * gR[1] + qz * gR[2]) +
                   (qy * gR[3] - 2.f * qx * gR[4])) +
                  ((-qr * gR[5] + qz * gR[6]) +
                   (qr * gR[7] - 2.f * qx * gR[8])));
  g_q[2] = 2.f * (((-2.f * qy * gR[0] + qx * gR[1]) +
                   (qr * gR[2] + qx * gR[3])) +
                  ((qz * gR[5] - qr * gR[6]) +
                   (qz * gR[7] - 2.f * qy * gR[8])));
  g_q[3] = 2.f * (((-2.f * qz * gR[0] - qr * gR[1]) +
                   (qx * gR[2] + qr * gR[3])) +
                  ((-2.f * qz * gR[4] + qy * gR[5]) +
                   (qx * gR[6] + qy * gR[7])));
  // q / sqrt(clamp_min(|q|^2, 1e-16))
  const float q_in[4] = {rot.x, rot.y, rot.z, rot.w};
  float g_qn = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) g_qn -= g_q[k] * (cv.qn[k] / cv.qnorm);
  const float g_qsq = cv.qpass ? g_qn / (2.f * cv.qnorm) : 0.f;
  float g_rot[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    g_rot[k] = g_q[k] / cv.qnorm + g_qsq * (2.f * q_in[k]);
  }

  // -- rgb = clamp_min(eval_sh(dirs) + 0.5, 0); precomputed colours
  // (DEG = kColors) take the upstream gradient as it is, outside the kernel
  if constexpr (DEG >= 0) {
    const Direction dr = direction(m, cam);
    float b[16];
    sh_basis<DEG>(dr.x, dr.y, dr.z, b);
    float g_res[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float pre = sh_channel<DEG>(b, sh, ch) + 0.5f;
      g_res[ch] = pre >= 0.f ? gr[ch] : 0.f;
    }
    float G[K];  // d loss / d b_l
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float sg = (l == 1 || l == 3) ? -1.f : 1.f;
      G[l] = sg * ((g_res[0] * sh[3 * l] + g_res[1] * sh[3 * l + 1]) +
                   g_res[2] * sh[3 * l + 2]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        sh[3 * l + ch] = sg * (b[l] * g_res[ch]);  // its own row only
      }
    }
    if (DEG > 0) {
      const float x = dr.x, y = dr.y, z = dr.z;
      float gx = kC1 * G[3], gy = kC1 * G[1], gz = kC1 * G[2];
      if (DEG > 1) {
        const float xx = x * x, yy = y * y, zz = z * z;
        gx += kC2_0 * y * G[4] - 2.f * kC2_2 * x * G[6] + kC2_3 * z * G[7] +
              2.f * kC2_4 * x * G[8];
        gy += kC2_0 * x * G[4] + kC2_1 * z * G[5] - 2.f * kC2_2 * y * G[6] -
              2.f * kC2_4 * y * G[8];
        gz += kC2_1 * y * G[5] + 4.f * kC2_2 * z * G[6] + kC2_3 * x * G[7];
        if (DEG > 2) {
          gx += 6.f * kC3_0 * x * y * G[9] + kC3_1 * y * z * G[10] -
                2.f * kC3_2 * x * y * G[11] - 6.f * kC3_3 * x * z * G[12] +
                kC3_4 * (4.f * zz - 3.f * xx - yy) * G[13] +
                2.f * kC3_5 * x * z * G[14] + 3.f * kC3_6 * (xx - yy) * G[15];
          gy += 3.f * kC3_0 * (xx - yy) * G[9] + kC3_1 * x * z * G[10] +
                kC3_2 * (4.f * zz - xx - 3.f * yy) * G[11] -
                6.f * kC3_3 * y * z * G[12] - 2.f * kC3_4 * x * y * G[13] -
                2.f * kC3_5 * y * z * G[14] - 6.f * kC3_6 * x * y * G[15];
          gz += kC3_1 * x * y * G[10] + 8.f * kC3_2 * y * z * G[11] +
                kC3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * G[12] +
                8.f * kC3_4 * x * z * G[13] + kC3_5 * (xx - yy) * G[14];
        }
      }
      // dirs = d / sqrt(clamp_min(|d|^2, 1e-16))
      const float g_dir[3] = {gx, gy, gz};
      const float dirs[3] = {dr.x, dr.y, dr.z};
      float g_n = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) g_n -= g_dir[k] * (dirs[k] / dr.norm);
      const float g_sq = dr.pass ? g_n / (2.f * dr.norm) : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_m[k] += g_dir[k] / dr.norm + g_sq * (2.f * dr.d[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.mean[k] = g_m[k];
    g.scale[k] = g_sc[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) g.rot[k] = g_rot[k];
  g.offset = make_float2(gm.x * s.half_w, gm.y * s.half_h);
}

}  // namespace preprocess
