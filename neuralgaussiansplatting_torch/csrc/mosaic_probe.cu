// K7: probes of the Hopper idioms the port's kernels are built from, for
// Hopper (sm_90a).
//
// Replaces the seven probe kernels of tools/exp_mosaic_probe.py (k1, k1b,
// k2, k6, k3 at four buffer sizes, k4, k5: Pallas TPU kernels that checked
// which lowering idioms Mosaic accepts). Each probe here computes the same
// function of x (16, 128) float32 as its TPU probe and exercises the Hopper
// counterpart of the TPU idiom:
//   0 p1_roll_11_bcast  roll(x, 125, axis 1)[0, 0] (numpy's direction),
//                       broadcast to (8, 128): a lane rotation by
//                       __shfl_sync with a static amount, then a broadcast
//                       from one lane;
//   1 p1b_dynroll       i = int(x[0, 0]) mod 128 (truncation, then a floor
//                       mod); roll(x, 128 - i, axis 1)[0, 0] broadcast: the
//                       rotation amount read from the data;
//   2 p2_twostep        s = x^T (128, 16) in shared memory; s[0, 0] + s[1, 0]
//                       + s[2, 0] + s[3, 0] in that order from 0, broadcast:
//                       a shared-memory transpose and dynamic row reads;
//   3 p6_transpose      x^T (128, 16): a shared-memory transpose, padded
//                       against bank conflicts;
//   4 p3_smem_{2,4,8,16}kb  a bulk copy (cp.async.bulk, completing on an
//                       mbarrier) of x[0, 0:128] into a 2/4/8/16 KB dynamic
//                       shared buffer; buffer[5] broadcast;
//   5 p4_smem_loop      a bulk copy of x[0, :]; its 128 values added in order
//                       from 0 by scalar shared-memory reads, broadcast;
//   6 p5_smem_2d        x[0:9, :] bulk-copied row by row into a (9, 132)
//                       pitched shared buffer; sum of x[0, i] * x[1, i] over
//                       i = 0..127 in order from 0 (each product rounded,
//                       --fmad=false), broadcast.
// The (8, 128) broadcasts write 1024 floats; every sum is taken in the
// order of the JAX probe, so each result is exact against the plain version.
//
// What bounds them on an H100: nothing of the card's rates. Each probe moves
// at most 16 KB and one block does the work, so a launch costs little more
// than its launch latency (chip_smoke.py times each).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 16;
constexpr int kCols = 128;
constexpr int kBcast = 8 * 128;    // the (8, 128) broadcast outputs
constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kPitch = 132;        // p5's shared row pitch (528 bytes)
constexpr int kP5Rows = 9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void write_bcast(float* __restrict__ out, float v,
                                            int tid, int nthreads) {
  for (int i = tid; i < kBcast; i += nthreads) out[i] = v;
}

// --- mbarrier and bulk copy (PTX) ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of transactions on the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// global -> shared copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) whose completion counts against the barrier's transactions
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// --- probes ----------------------------------------------------------------

__device__ __forceinline__ float pick4(const float v[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// v[k] holds row[lane + 32 k] of a 128-wide row; afterwards v[k] holds
// row[(lane + 32 k + d) mod 128], d in [0, 128): numpy's roll by -d
__device__ __forceinline__ void roll_row(float v[4], int d) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int q = d / kLanes;
  const int r = d % kLanes;
  const int src = (lane + r) & (kLanes - 1);
  const bool wrapped = lane + r >= kLanes;
  float rolled[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float same = __shfl_sync(kFull, pick4(v, (k + q) & 3), src);
    const float next = __shfl_sync(kFull, pick4(v, (k + q + 1) & 3), src);
    rolled[k] = wrapped ? next : same;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = rolled[k];
}

// probes 0 and 1: one warp
template <bool kFromData>
__global__ void __launch_bounds__(kLanes)
roll_bcast_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int lane = threadIdx.x;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = x[lane + kLanes * k];
  int shift = kCols - 3;
  if (kFromData) {
    int i = static_cast<int>(x[0]) % kCols;  // truncates, then floor mod
    if (i < 0) i += kCols;
    shift = kCols - i;
  }
  roll_row(v, ((-shift) % kCols + kCols) % kCols);
  write_bcast(out, __shfl_sync(kFull, v[0], 0), lane, kLanes);
}

__global__ void __launch_bounds__(kThreads)
twostep_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float s[kCols][kRows + 1];  // x^T, rows padded
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    s[i % kCols][i / kCols] = x[i];
  }
  __syncthreads();
  float acc = 0.f;
  for (int i = 0; i < 4; ++i) acc = acc + s[i][0];
  write_bcast(out, acc, threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out) {
  // pitch 130: the row-major fill and the column reads of a warp (16
  // columns of two rows) each fall in 32 distinct banks
  __shared__ float s[kRows][kCols + 2];
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    s[i / kCols][i % kCols] = x[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    out[i] = s[i % kRows][i / kRows];
  }
}

// probe 4: `words` floats of dynamic shared memory
__global__ void __launch_bounds__(kThreads)
bulk_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int words) {
  extern __shared__ __align__(128) float s_buf[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  const uint32_t bytes = static_cast<uint32_t>(min(words, kCols)) * 4;
  if (threadIdx.x == 0) mbar_init(b, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, bytes);
    bulk_load(smem_addr(s_buf), x, bytes, b);
  }
  mbar_wait(b, 0);
  write_bcast(out, s_buf[5], threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads)
smem_loop_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float s_row[kCols];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) mbar_init(b, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, kCols * 4);
    bulk_load(smem_addr(s_row), x, kCols * 4, b);
  }
  mbar_wait(b, 0);
  float acc = 0.f;
  for (int i = 0; i < kCols; ++i) acc = acc + s_row[i];
  write_bcast(out, acc, threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads)
smem_2d_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float s[kP5Rows][kPitch];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) mbar_init(b, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, kP5Rows * kCols * 4);
    for (int row = 0; row < kP5Rows; ++row) {
      bulk_load(smem_addr(&s[row][0]), x + row * kCols, kCols * 4, b);
    }
  }
  mbar_wait(b, 0);
  float acc = 0.f;
  for (int i = 0; i < kCols; ++i) {
    const float mx = s[0][i];
    const float my = s[1][i];
    acc = acc + mx * my;
  }
  write_bcast(out, acc, threadIdx.x, kThreads);
}

}  // namespace

extern "C" {

// x: (16, 128) float32, 16-byte aligned; out: (8, 128) float32, or (128,
// 16) for probe 3. `param` is probe 4's buffer size in KB (2, 4, 8 or 16).
// Launches probe `probe` (numbered as above) on `stream` and returns
// cudaGetLastError() (0 on success).
int mosaic_probe(int probe, int param, const void* x, void* out,
                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  switch (probe) {
    case 0: roll_bcast_kernel<false><<<1, kLanes, 0, s>>>(in, o); break;
    case 1: roll_bcast_kernel<true><<<1, kLanes, 0, s>>>(in, o); break;
    case 2: twostep_kernel<<<1, kThreads, 0, s>>>(in, o); break;
    case 3: transpose_kernel<<<1, kThreads, 0, s>>>(in, o); break;
    case 4: {
      if (param != 2 && param != 4 && param != 8 && param != 16) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int words = param * 256;
      bulk_copy_kernel<<<1, kThreads, words * 4, s>>>(in, o, words);
      break;
    }
    case 5: smem_loop_kernel<<<1, kThreads, 0, s>>>(in, o); break;
    case 6: smem_2d_kernel<<<1, kThreads, 0, s>>>(in, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mosaic_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
