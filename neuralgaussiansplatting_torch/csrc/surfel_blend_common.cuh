// What the surfel blend kernels share (surfel_blend_{fwd,bwd}.cu): the
// staging of a batch of surfels of a tile, with its alpha-floor cutoff and a
// box outside which no pixel can blend, and the per-(surfel, pixel) ray-splat
// intersection of ops/surfel_blend.py in its operation order. Built on
// blend_common.cuh's tile, constants and alpha cutoff.
#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace surfel {

using namespace blend;

constexpr int kSRows = 18;     // cx cy T_u T_v T_w op r g b nx ny nz
constexpr int kChannels = 14;  // see ops/surfel_blend.py
constexpr float kNear = 0.2f;
constexpr float kFilterInvSquare = 2.f;
constexpr float kMedianT = 0.5f;
// m = kMScale * (1 - kNear * (1 / z)); dm/dz = kDMScale * (1 / z^2) (the
// float32 values of ops/surfel_blend.py's M_SCALE and DM_SCALE; PyTorch
// divides a scalar by a tensor as the tensor's reciprocal times it)
constexpr float kMScale = static_cast<float>(100.0 / (100.0 - 0.2));
constexpr float kDMScale = static_cast<float>(100.0 * 0.2 / (100.0 - 0.2));

// A staged surfel: its box, then its 18 attributes and its cutoff, 24
// floats read as float4 broadcasts.
struct alignas(16) SurfelStaged {
  float4 box;  // x_lo, x_hi, y_lo, y_hi
  float tu0, tu1, tu2, tv0;
  float tv1, tv2, tw0, tw1;
  float tw2, cx, cy, op;
  float cut, r, g, b;
  float n0, n1, n2, pad;
};

// The pixels on which a surfel can blend lie inside the returned box. A
// pair blends only where power = -rho / 2 >= cut (alpha_cutoff: below it
// alpha < 1/255), so rho <= L = -2 cut: either rho2d <= L, the disc of
// radius sqrt(L / 2) round the centre, or rho3d <= L, where the pixel's
// intersection (u, v) lies in the disc of radius sqrt(L) and so in its
// square. While the square's four corners lie in front of the camera (w >
// 0 at each, so on all of it) its image is the convex hull of their images.
// The box is the union of the two bounds, widened by 2 px and 1/256 of
// itself against the rounding of the corners' and the pairs' arithmetic;
// it is the whole plane where a corner is not clearly in front, a bound is
// not finite or past 2^20, and empty where cut >= 0 (no pair can blend).
__device__ __forceinline__ float4 surfel_box(const SurfelStaged& s) {
  const float kInf = __int_as_float(0x7f800000);
  if (s.cut >= 0.f) return make_float4(kInf, -kInf, kInf, -kInf);
  const float whole_lo = -kInf, whole_hi = kInf;
  const float lvl = -2.f * s.cut * (1.f + 0x1p-10f);
  const float r = sqrtf(lvl) * (1.f + 0x1p-10f);
  const float disc = sqrtf(0.5f * lvl) * (1.f + 0x1p-10f);
  float x0 = s.cx - disc, x1 = s.cx + disc;
  float y0 = s.cy - disc, y1 = s.cy + disc;
  const float wscale = fabsf(r * s.tw0) + fabsf(r * s.tw1) + fabsf(s.tw2);
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float su = (c & 1) ? r : -r;
    const float sv = (c & 2) ? r : -r;
    const float w = (su * s.tw0 + sv * s.tw1) + s.tw2;
    ok = ok && w > 1e-3f * wscale;
    const float x = ((su * s.tu0 + sv * s.tu1) + s.tu2) / w;
    const float y = ((su * s.tv0 + sv * s.tv1) + s.tv2) / w;
    x0 = fminf(x0, x);
    x1 = fmaxf(x1, x);
    y0 = fminf(y0, y);
    y1 = fmaxf(y1, y);
  }
  const float mx = 2.f + (x1 - x0) * 0x1p-8f;
  const float my = 2.f + (y1 - y0) * 0x1p-8f;
  x0 -= mx;
  x1 += mx;
  y0 -= my;
  y1 += my;
  ok = ok && fabsf(x0) < 0x1p20f && fabsf(x1) < 0x1p20f &&
       fabsf(y0) < 0x1p20f && fabsf(y1) < 0x1p20f;
  if (!ok) return make_float4(whole_lo, whole_hi, whole_lo, whole_hi);
  return make_float4(x0, x1, y0, y1);
}

// Column `col` of the (18, k) table with its cutoff and box (zeros past k
// or where `in` is false).
__device__ __forceinline__ SurfelStaged stage_surfel(
    const float* __restrict__ packed, long long k, long long col, bool in) {
  float v[kSRows];
#pragma unroll
  for (int row = 0; row < kSRows; ++row)
    v[row] = in && col < k ? packed[row * k + col] : 0.f;
  SurfelStaged st;
  st.cx = v[0], st.cy = v[1];
  st.tu0 = v[2], st.tu1 = v[3], st.tu2 = v[4];
  st.tv0 = v[5], st.tv1 = v[6], st.tv2 = v[7];
  st.tw0 = v[8], st.tw1 = v[9], st.tw2 = v[10];
  st.op = v[11], st.r = v[12], st.g = v[13], st.b = v[14];
  st.n0 = v[15], st.n1 = v[16], st.n2 = v[17];
  st.pad = 0.f;
  st.cut = alpha_cutoff(st.op);
  st.box = surfel_box(st);
  return st;
}

// Stage columns [col0, col0 + nb) of the table into `batch` (B entries),
// one thread per surfel.
template <int B>
__device__ __forceinline__ void stage_surfels(
    SurfelStaged (&batch)[B], const float* __restrict__ packed, long long k,
    long long col0, int nb) {
  for (int j = threadIdx.x; j < B; j += blockDim.x)
    batch[j] = stage_surfel(packed, k, col0 + j, j < nb);
}

template <int B>
__device__ __forceinline__ bool surfel_missed(
    const SurfelStaged (&batch)[B], int j, float x0, float x1, float y0,
    float y1) {
  const float4 box = batch[j].box;
  return box.x > x1 || box.y < x0 || box.z > y1 || box.w < y0;
}

// Surfel j of the batch past its box, as five 16-byte loads.
template <int B>
__device__ __forceinline__ SurfelStaged load_surfel(
    const SurfelStaged (&batch)[B], int j) {
  const float4* v = reinterpret_cast<const float4*>(&batch[j]);
  const float4 a = v[1], b = v[2], c = v[3], d = v[4], e = v[5];
  SurfelStaged st;
  st.tu0 = a.x, st.tu1 = a.y, st.tu2 = a.z, st.tv0 = a.w;
  st.tv1 = b.x, st.tv2 = b.y, st.tw0 = b.z, st.tw1 = b.w;
  st.tw2 = c.x, st.cx = c.y, st.cy = c.z, st.op = c.w;
  st.cut = d.x, st.r = d.y, st.g = d.z, st.b = d.w;
  st.n0 = e.x, st.n1 = e.y, st.n2 = e.z;
  return st;
}

// One (surfel, pixel) pair's intersection, in ops/surfel_blend.py's order.
struct Pair {
  float k[3], l[3];
  float c2;      // c.z; the pair is skipped where it is 0
  float u, v;
  float dx, dy;  // centre - pixel
  bool on3d;     // rho3d <= rho2d
  float z;
  float power;
};

__device__ __forceinline__ Pair pair_of(const SurfelStaged& s, float px,
                                        float py) {
  Pair p;
  p.k[0] = px * s.tw0 - s.tu0;
  p.k[1] = px * s.tw1 - s.tu1;
  p.k[2] = px * s.tw2 - s.tu2;
  p.l[0] = py * s.tw0 - s.tv0;
  p.l[1] = py * s.tw1 - s.tv1;
  p.l[2] = py * s.tw2 - s.tv2;
  const float c0 = p.k[1] * p.l[2] - p.k[2] * p.l[1];
  const float c1 = p.k[2] * p.l[0] - p.k[0] * p.l[2];
  p.c2 = p.k[0] * p.l[1] - p.k[1] * p.l[0];
  const float safe = p.c2 == 0.f ? 1.f : p.c2;
  p.u = c0 / safe;
  p.v = c1 / safe;
  const float rho3d = p.u * p.u + p.v * p.v;
  p.dx = s.cx - px;
  p.dy = s.cy - py;
  const float rho2d = kFilterInvSquare * (p.dx * p.dx + p.dy * p.dy);
  p.on3d = rho3d <= rho2d;
  const float rho = p.on3d ? rho3d : rho2d;
  p.z = p.on3d ? (p.u * s.tw0 + p.v * s.tw1) + s.tw2 : s.tw2;
  p.power = -0.5f * rho;
  return p;
}

}  // namespace surfel
