// What K1 (blend_seq_fwd.cu) and K2 (blend_seq_bwd.cu) share: the JAX
// package's constants and the batch staging with its alpha-floor cutoff and
// per-instance box (blend_seq_stage.cu evaluates both for the tests).
#pragma once

#include <cuda_runtime.h>

namespace blend_seq {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;  // 1024 pixels per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;          // instances staged per batch
constexpr int kRows = 9;             // x y A B C opacity r g b
constexpr unsigned kFull = 0xffffffffu;

// The float32 values of the JAX package's constants, bit for bit.
constexpr float kAlphaMax = 0x1.fae148p-1f;  // 0.99
constexpr float kAlphaMin = 0x1.010102p-8f;  // 1/255
constexpr float kStopT = 0x1.a36e2ep-14f;    // 1e-4

// The power below which an instance of opacity `op` cannot blend: for
// power < seq_cutoff(op), min(0.99, op*expf(power)) < 1/255 in float32, so
// the pair's a is 0. ops/blend_seq.py::alpha_floor_cutoff computes the same
// in PyTorch. The margin 2^-13*(1 + |l|) covers the rounding on both sides
// of the test: the division (0.5 ulp), logf (1 ulp), the subtraction (0.5
// ulp of the cutoff), expf (2 ulp) and the product op*expf (0.5 ulp) add up
// to ~1e-6*(1 + |l|) of power, 100x below it. op <= 0 or NaN gives NaN (or
// -inf): no pair is skipped.
__device__ __forceinline__ float seq_cutoff(float op) {
  const float l = logf(kAlphaMin / op);
  return l - (1.f + fabsf(l)) * 0x1p-13f;
}

// A box around the pixels on which an instance can blend: for a pixel
// outside [x_lo, x_hi] x [y_lo, y_hi], the power that K1 and K2 compute in
// float32 lies below seq_cutoff(op), so the pair is skipped anyway; a warp
// whose patch misses the box skips the instance without computing any
// power. ops/blend_seq.py::instance_box computes the same in PyTorch. With
// M = [[A, B], [B, C]] and q = d^T M d, power = -q/2 exactly; the pixels
// with q <= r^2 (r^2 = -2 cut (1 + 2^-10)) lie within |dx| <= r sqrt(C /
// det), |dy| <= r sqrt(A / det). The float32 power is within (2.5 / (1 -
// rho) + 1) * 2^-24 * q of -q/2, rho = |B| / sqrt(AC), so where B^2 <=
// 0.998 AC (rho < 0.9990) a pixel with q > r^2 computes a power below the
// cutoff; the half-widths are widened by 2^-10 of themselves (the rounding
// of det, ~2^-24 / (1 - rho^2), and of the rest) and by 1 px (the rounding
// of mx - px for |mx| < 2^20). Elsewhere (M not so, a mean past 2^20, a
// cutoff that is NaN) the box is the whole plane; a cutoff >= 0 (op below
// 1/255) gives an empty box, since then no pair blends.
__device__ __forceinline__ float4 seq_box(float mx, float my, float ca,
                                          float cbc, float cc, float cut) {
  const float kInf = __int_as_float(0x7f800000);
  if (cut >= 0.f) return make_float4(kInf, -kInf, kInf, -kInf);
  const float ac = ca * cc;
  const float det = ac - cbc * cbc;
  const bool ok = ca > 0.f && cc > 0.f && cbc * cbc <= 0.998f * ac &&
                  det > 0.f && fabsf(mx) < 0x1p20f && fabsf(my) < 0x1p20f &&
                  cut < 0.f;
  if (!ok) return make_float4(-kInf, kInf, -kInf, kInf);
  const float r2 = -2.f * cut * (1.f + 0x1p-10f);
  const float hx = sqrtf(r2 * cc / det) * (1.f + 0x1p-10f) + 1.f;
  const float hy = sqrtf(r2 * ca / det) * (1.f + 0x1p-10f) + 1.f;
  return make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// A staged instance: its box, its 9 attributes and its cutoff, 16 floats,
// read as float4 broadcasts: the box first, the rest if the box is met.
struct alignas(16) Staged {
  float4 box;             // x_lo, x_hi, y_lo, y_hi
  float mx, my, ca, cbc;  // mean2d x, y, conic A, B
  float cc, op, cut, r;   // conic C, opacity, seq_cutoff(op), red
  float g, b, pad0, pad1;
};

// Column `col` of the (9, k) table with its cutoff and box (zeros past k
// or where `in` is false).
__device__ __forceinline__ Staged stage(const float* __restrict__ packed,
                                        long long k, long long col, bool in) {
  float v[kRows];
#pragma unroll
  for (int row = 0; row < kRows; ++row)
    v[row] = in && col < k ? packed[row * k + col] : 0.f;
  Staged st;
  st.mx = v[0], st.my = v[1], st.ca = v[2], st.cbc = v[3], st.cc = v[4];
  st.op = v[5], st.r = v[6], st.g = v[7], st.b = v[8];
  st.pad0 = st.pad1 = 0.f;
  st.cut = seq_cutoff(st.op);
  st.box = seq_box(st.mx, st.my, st.ca, st.cbc, st.cc, st.cut);
  return st;
}

// Stage columns [col0, col0 + nb) of the (9, k) table, one thread per
// instance (coalesced row reads).
__device__ __forceinline__ void stage_batch(Staged (&batch)[kBatch],
                                            const float* __restrict__ packed,
                                            long long k, long long col0,
                                            int nb) {
  static_assert(kThreads >= kBatch, "a thread per staged instance");
  const int j = threadIdx.x;
  if (j < kBatch) batch[j] = stage(packed, k, col0 + j, j < nb);
}

// Whether instance j's box misses the pixels [x0, x1] x [y0, y1].
__device__ __forceinline__ bool box_missed(const Staged (&batch)[kBatch],
                                           int j, float x0, float x1,
                                           float y0, float y1) {
  const float4 box = batch[j].box;
  return box.x > x1 || box.y < x0 || box.z > y1 || box.w < y0;
}

// Instance j of the batch past its box, as three 16-byte loads.
__device__ __forceinline__ Staged load_staged(const Staged (&batch)[kBatch],
                                              int j) {
  const float4* v = reinterpret_cast<const float4*>(&batch[j]);
  const float4 a = v[1], c = v[2], e = v[3];
  Staged st;
  st.mx = a.x, st.my = a.y, st.ca = a.z, st.cbc = a.w;
  st.cc = c.x, st.op = c.y, st.cut = c.z, st.r = c.w;
  st.g = e.x, st.b = e.y;
  return st;
}

}  // namespace blend_seq
