// Adam over every parameter group of one optimizer step, for Hopper
// (sm_90a), with the dead-slot select folded in.
//
// Replaces no TPU kernel: the JAX package's optax update is fused by XLA.
// Eagerly PyTorch ran it as ~14 out-of-place passes a group
// (train/optim.py::Adam.update_reference, the plain version, keeps that code
// op for op), after a `torch.where` over every gradient that cleared the
// dead (padding) slots. Contract, for each group of the table, element i:
//
//   g   = alive[i / width] ? grad[i] : 0    (no mask: grad[i]; no grad: +0)
//   mu' = ((1 - b1) g) + (b1 mu)
//   nu' = ((1 - b2) (g g)) + (b2 nu)
//   p'  = p + (-rate) ((mu' * inv_bc1) / (sqrt(nu' * inv_bc2) + eps))
//
// each operation rounded to float32 on its own (--fmad=false), in the plain
// version's order, so that the outputs are its bits on the card. PyTorch's
// CUDA division by a host scalar multiplies by the scalar's float32
// reciprocal, so the caller passes inv_bc = 1 / bc rounded to float32, as
// PyTorch computes it. Every element is updated: a zero gradient still
// decays the moments and moves the parameter by the bias-corrected mu'.
//
// What bounds it on an H100: bytes. An element reads p, g, mu and nu and
// writes p', mu' and nu' once: 28 B (24 without a gradient), 15.9 GB over
// the 615M floats of a 5M-Gaussian step, ~4.8 ms at 3.35 TB/s, against ~20
// FP32 operations an element. So one launch covers every group of a call
// (kMaxGroups at most; the caller splits larger calls), the table passed by
// value as a __grid_constant__ parameter (no copy to the device, no read
// back). Blocks go to groups in proportion to their elements: group k owns
// the blocks [start[k], start[k + 1]), ceil(n / kTile) of them, so one grid
// serves a 320M-float group beside a 12-float one. A thread loads kUnroll
// 16-byte vectors of each input before it computes, so that a block has
// 64 KB of loads in flight; loads and stores carry the streaming hint
// (every byte is touched once). A group whose pointers are not all 16-byte aligned (a view
// at an odd offset) runs the scalar path, as does the tail of n % 4
// elements of an aligned one.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTile = kThreads * 4 * kUnroll;  // elements a block

struct Group {
  const float* p;
  const float* g;  // null: no gradient (+0)
  const float* mu;
  const float* nu;
  float* p_out;
  float* mu_out;
  float* nu_out;
  const unsigned char* alive;  // (n / width,) bool, or null
  long long n;
  int width;
  int vec;  // every pointer 16-byte aligned
  float neg_rate;
  float inv_bc1;
  float inv_bc2;
  float eps;
};

struct Table {
  Group group[kMaxGroups];
  int start[kMaxGroups + 1];  // block prefix
  int count;
  float c1, b1, c2, b2;  // 1 - b1, b1, 1 - b2, b2, as float32
};

struct Moments {
  float p, mu, nu;
};

__device__ __forceinline__ Moments adam(const Table& t, const Group& gr,
                                        float p, float g, float mu,
                                        float nu) {
  const float m = t.c1 * g + t.b1 * mu;
  const float v = t.c2 * (g * g) + t.b2 * nu;
  const float step = (m * gr.inv_bc1) / (sqrtf(v * gr.inv_bc2) + gr.eps);
  return {p + gr.neg_rate * step, m, v};
}

// the row of element e (width w), in 32 bits where the group allows
__device__ __forceinline__ unsigned long long row_of(unsigned long long e,
                                                     const Group& gr) {
  if (gr.n <= 0xffffffffll)
    return static_cast<unsigned>(e) / static_cast<unsigned>(gr.width);
  return e / static_cast<unsigned long long>(gr.width);
}

__device__ __forceinline__ float grad_at(const Group& gr,
                                         unsigned long long e) {
  if (gr.g == nullptr) return 0.f;
  if (gr.alive != nullptr && !__ldg(gr.alive + row_of(e, gr))) return 0.f;
  return __ldcs(gr.g + e);
}

__device__ __forceinline__ void scalar_step(const Table& t, const Group& gr,
                                            unsigned long long e) {
  const float g = grad_at(gr, e);
  const Moments r = adam(t, gr, __ldcs(gr.p + e), g, __ldcs(gr.mu + e),
                         __ldcs(gr.nu + e));
  __stcs(gr.p_out + e, r.p);
  __stcs(gr.mu_out + e, r.mu);
  __stcs(gr.nu_out + e, r.nu);
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ Table t) {
  int k = 0;
  while (static_cast<int>(blockIdx.x) >= t.start[k + 1]) ++k;
  const Group& gr = t.group[k];
  const unsigned long long base =
      static_cast<unsigned long long>(blockIdx.x - t.start[k]) * kTile;
  const unsigned long long n = static_cast<unsigned long long>(gr.n);
  const int tid = threadIdx.x;

  if (!gr.vec) {
#pragma unroll 4
    for (int u = 0; u < kTile / kThreads; ++u) {
      const unsigned long long e = base + u * kThreads + tid;
      if (e < n) scalar_step(t, gr, e);
    }
    return;
  }

  const unsigned long long nv = n / 4;  // whole vectors of the group
  const float4* p4 = reinterpret_cast<const float4*>(gr.p);
  const float4* g4 = reinterpret_cast<const float4*>(gr.g);
  const float4* mu4 = reinterpret_cast<const float4*>(gr.mu);
  const float4* nu4 = reinterpret_cast<const float4*>(gr.nu);
  float4 p[kUnroll], g[kUnroll], mu[kUnroll], nu[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned long long v = base / 4 + u * kThreads + tid;
    if (v < nv) {
      p[u] = __ldcs(p4 + v);
      mu[u] = __ldcs(mu4 + v);
      nu[u] = __ldcs(nu4 + v);
      g[u] = gr.g ? __ldcs(g4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned long long v = base / 4 + u * kThreads + tid;
    if (v >= nv) continue;
    float gs[4] = {g[u].x, g[u].y, g[u].z, g[u].w};
    if (gr.g != nullptr && gr.alive != nullptr) {
      // the rows of elements 4v .. 4v + 3: one division, then a walk
      unsigned long long row = row_of(4 * v, gr);
      int col = static_cast<int>(4 * v - row * gr.width);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!__ldg(gr.alive + row)) gs[j] = 0.f;
        if (++col == gr.width) {
          col = 0;
          ++row;
        }
      }
    }
    const Moments a = adam(t, gr, p[u].x, gs[0], mu[u].x, nu[u].x);
    const Moments b = adam(t, gr, p[u].y, gs[1], mu[u].y, nu[u].y);
    const Moments c = adam(t, gr, p[u].z, gs[2], mu[u].z, nu[u].z);
    const Moments d = adam(t, gr, p[u].w, gs[3], mu[u].w, nu[u].w);
    __stcs(reinterpret_cast<float4*>(gr.p_out) + v,
           make_float4(a.p, b.p, c.p, d.p));
    __stcs(reinterpret_cast<float4*>(gr.mu_out) + v,
           make_float4(a.mu, b.mu, c.mu, d.mu));
    __stcs(reinterpret_cast<float4*>(gr.nu_out) + v,
           make_float4(a.nu, b.nu, c.nu, d.nu));
  }
  // the tail of n % 4 elements, in the group's last block
  const unsigned long long tail = 4 * nv + tid;
  if (tail < n && base + kTile >= n) scalar_step(t, gr, tail);
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// One launch over `count` (1..32) groups. ptrs: count x 8 device addresses
// (p, g or 0, mu, nu, p_out, mu_out, nu_out, alive or 0); sizes: count x 2
// (elements, row width); scalars: count x 4 float32 (-rate, inv_bc1,
// inv_bc2, eps); coefs: 1 - b1, b1, 1 - b2, b2 as float32. All arrays on the
// host; tensors float32 (alive bool), contiguous, on the device, outputs
// apart from the inputs. Launches on `stream` and returns cudaGetLastError()
// (0 on success); cudaErrorInvalidValue for a count outside 1..32, a width
// below 1 or more blocks than a grid holds.
int adam_update(const long long* ptrs, const long long* sizes,
                const float* scalars, int count, const float* coefs,
                void* stream) {
  if (count < 1 || count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.count = count;
  t.c1 = coefs[0];
  t.b1 = coefs[1];
  t.c2 = coefs[2];
  t.b2 = coefs[3];
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const long long* a = ptrs + 8 * k;
    Group& g = t.group[k];
    g.p = reinterpret_cast<const float*>(a[0]);
    g.g = reinterpret_cast<const float*>(a[1]);
    g.mu = reinterpret_cast<const float*>(a[2]);
    g.nu = reinterpret_cast<const float*>(a[3]);
    g.p_out = reinterpret_cast<float*>(a[4]);
    g.mu_out = reinterpret_cast<float*>(a[5]);
    g.nu_out = reinterpret_cast<float*>(a[6]);
    g.alive = reinterpret_cast<const unsigned char*>(a[7]);
    g.n = sizes[2 * k];
    if (sizes[2 * k + 1] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g.width = static_cast<int>(sizes[2 * k + 1]);
    g.vec = aligned(g.p) && (g.g == nullptr || aligned(g.g)) &&
            aligned(g.mu) && aligned(g.nu) && aligned(g.p_out) &&
            aligned(g.mu_out) && aligned(g.nu_out);
    g.neg_rate = scalars[4 * k];
    g.inv_bc1 = scalars[4 * k + 1];
    g.inv_bc2 = scalars[4 * k + 2];
    g.eps = scalars[4 * k + 3];
    t.start[k] = static_cast<int>(blocks);
    blocks += g.n > 0 ? (g.n + kTile - 1) / kTile : 0;
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = count; k <= kMaxGroups; ++k)
    t.start[k] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  adam_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

const char* adam_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
