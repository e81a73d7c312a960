// What the four blend kernels share: K1 and K2 (blend_seq_{fwd,bwd}.cu, 32x32
// tiles) and K4 and K5 (blend_pallas_{fwd,bwd}.cu, any tile shape). The JAX
// package's constants, the batch staging with its alpha-floor cutoff and
// per-instance box (blend_stage.cu evaluates both for the tests), and
// the warp sum of the backward kernels' 9 gradient rows.
#pragma once

#include <cuda_runtime.h>

namespace blend {

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
// power < alpha_cutoff(op), min(0.99, op*expf(power)) < 1/255 in float32, so
// the pair's a is 0. ops/blend.py::alpha_floor_cutoff computes the same
// in PyTorch. The margin 2^-13*(1 + |l|) covers the rounding on both sides
// of the test: the division (0.5 ulp), logf (1 ulp), the subtraction (0.5
// ulp of the cutoff), expf (2 ulp) and the product op*expf (0.5 ulp) add up
// to ~1e-6*(1 + |l|) of power, 100x below it. op <= 0 or NaN gives NaN (or
// -inf): no pair is skipped.
__device__ __forceinline__ float alpha_cutoff(float op) {
  const float l = logf(kAlphaMin / op);
  return l - (1.f + fabsf(l)) * 0x1p-13f;
}

// A box around the pixels on which an instance can blend: for a pixel
// outside [x_lo, x_hi] x [y_lo, y_hi], the power that K1, K2, K4 and K5
// compute in float32 lies below alpha_cutoff(op), so the pair is skipped
// anyway; a warp
// whose patch misses the box skips the instance without computing any
// power. ops/blend.py::instance_box computes the same in PyTorch. With
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
//
// The same box serves K4 and K5, which associate the power as the JAX
// pallas kernel does, -0.5*((A*dx)*dx + (C*dy)*dy) - (B*dx)*dy, where K1
// and K2 compute -0.5*(A*(dx*dx) + C*(dy*dy)) - B*(dx*dy). The bound above
// holds for both orders, term by term. dx and dy are the same float32
// values in both (one rounded subtraction each). Each of the three terms
// is a product of three float32 factors rounded twice, whichever pair is
// multiplied first: fl(fl(x*y)*z) and fl(x*fl(y*z)) both equal
// x*y*z*(1 + e1)*(1 + e2) with |e1|, |e2| <= 2^-24, so each term carries
// the same relative error bound, 2^-23 + 2^-48, in either order. The two
// additions, the exact scaling by -0.5 and the final subtraction are the
// same operations on terms of the same signs (A dx^2 and C dy^2 >= 0 where
// A, C > 0), so they add the same rounding. An underflow in a product adds
// at most 2^-149 absolute, and outside the box q > r^2 >= 11 (cut <=
// ln(1/255) for op <= 1), so it is 2^-100 below the margin. Hence the
// float32 power of either order lies within (2.5 / (1 - rho) + 1) *
// 2^-24 * q of -q/2, and the box, its widening and its guard carry over
// unchanged. The CPU and card sweeps (tests/test_torch_blend.py,
// tests/test_torch_cuda.py) hold the box in both orders.
__device__ __forceinline__ float4 instance_box(float mx, float my,
                                               float ca, float cbc, float cc,
                                               float cut) {
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
  float cc, op, cut, r;   // conic C, opacity, alpha_cutoff(op), red
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
  st.cut = alpha_cutoff(st.op);
  st.box = instance_box(st.mx, st.my, st.ca, st.cbc, st.cc, st.cut);
  return st;
}

// Stage columns [col0, col0 + nb) of the (9, k) table, one thread per
// instance (coalesced row reads); a block of fewer than kBatch threads
// stages several each.
__device__ __forceinline__ void stage_batch(Staged (&batch)[kBatch],
                                            const float* __restrict__ packed,
                                            long long k, long long col0,
                                            int nb) {
  for (int j = threadIdx.x; j < kBatch; j += blockDim.x)
    batch[j] = stage(packed, k, col0 + j, j < nb);
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

// The corner (cx, cy) in its tile of the kW x kH cell of thread slot s
// (slot = lane + 32 * warp), where each warp owns a patch of 8x4 cells and
// the patches run row-major over a tile block_x pixels wide (K4, K5).
template <int kW, int kH>
__device__ __forceinline__ void cell_corner(int s, int block_x, int& cx,
                                            int& cy) {
  const int w = s >> 5, lane = s & 31;
  const int across = block_x / (8 * kW);
  cx = ((w % across) * 8 + (lane & 7)) * kW;
  cy = ((w / across) * 4 + (lane >> 3)) * kH;
}

// Sum acc[0..8] over the warp by a fixed reduce-scatter: rows 0-7 by
// recursive halving (4 + 2 + 1 shuffles, then 2 butterfly steps), row 8 by
// a 5-step butterfly, 14 shuffles in all (a full butterfly per row takes
// 45). Returns the sum of row (lane >> 2) & 7 in every lane, and the sum of
// row 8 in `row8`; the order is fixed, so the sums repeat bit for bit.
__device__ __forceinline__ float warp_rows(const float (&acc)[kRows],
                                           int lane, float& row8) {
  float v[4], u[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // lanes 0-15 keep rows 0-3, 16-31 rows 4-7
    const float send = b4 ? acc[i] : acc[i + 4];
    const float keep = b4 ? acc[i + 4] : acc[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? v[i] : v[i + 2];
    const float keep = b3 ? v[i + 2] : v[i];
    u[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float s = (b2 ? u[1] : u[0]) + __shfl_xor_sync(kFull, b2 ? u[0] : u[1], 4);
  s = s + __shfl_xor_sync(kFull, s, 2);
  s = s + __shfl_xor_sync(kFull, s, 1);
  float r8 = acc[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    r8 = r8 + __shfl_xor_sync(kFull, r8, off);
  row8 = r8;
  return s;
}

// The launch of `kernel` (K4, K5) with `threads` threads, `smem` bytes of
// dynamic shared memory and `per_tile` CTAs per tile, and its residency on
// the current device: info[0] threads, [1] CTAs per tile, [2] registers per
// thread, [3] static and [4] dynamic shared memory bytes per CTA, [5]
// resident CTAs per SM. Returns a cudaError_t (0 on success).
inline int launch_info(const void* kernel, int threads, int per_tile,
                       size_t smem, int* info) {
  cudaFuncAttributes attr{};
  int ctas = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, smem);
  info[0] = threads;
  info[1] = per_tile;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.sharedSizeBytes);
  info[4] = static_cast<int>(smem);
  info[5] = ctas;
  return static_cast<int>(err);
}

}  // namespace blend
