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
//   3 p6_transpose      x^T (128, 16): a register transpose of 4x4 blocks;
//   4 p3_smem_{2,4,8,16}kb  a bulk copy (cp.async.bulk, completing on an
//                       mbarrier) of x[0, 0:128] into a 2/4/8/16 KB dynamic
//                       shared buffer; buffer[5] broadcast;
//   5 p4_smem_loop      a bulk copy of x[0, :] (512 bytes); its 128 values
//                       added in order from 0 by scalar shared-memory reads,
//                       broadcast;
//   6 p5_smem_2d        x[0:9, :] bulk-copied into a (9, 128) shared buffer
//                       in two copies, rows 0-1 on a barrier of their own
//                       and rows 2-8 on another; sum of x[0, i] * x[1, i]
//                       over i = 0..127 in order from 0 (each product
//                       rounded), broadcast.
// The (8, 128) broadcasts write 1024 floats; every sum is taken in the
// order of the JAX probe with __fadd_rn / __fmul_rn (never contracted), so
// each result is exact against the plain version.
//
// What bounds them on an H100: nothing of the card's rates. Each probe
// moves at most 16 KB, ~3.7e-6 ms at 3.35 TB/s, some 300 times less than
// one launch, so each should cost what an empty launch costs (floor_kernel,
// which chip_smoke.py times beside them) plus one trip to memory. The design
// takes away what a launch adds on top of that. Loads and stores are 16
// bytes where the data allow, and a block has the threads its stores want:
// the (8, 128) broadcasts are 256 float4 stores, one per thread where the
// value is cheap to have in every warp (p1, p1b, p3: each warp rolls, or
// waits on the mbarrier, for itself; one warp storing all 256 took longer)
// and two per thread in p4 and p5, whose four warps, one per SM
// sub-partition, each run the serial sum (eight would contend for issue
// slots). The transposes run one thread per 4x4 block (128 threads), p5
// issues two copies instead of nine and starts its sum when rows 0-1 land.
// What remains above the floor is the load's round trip (a bulk copy's,
// through the mbarrier, is longer than a plain load's) and, in p4 and p5,
// the 128 dependent float adds that exactness requires (~512 cycles).

#include <cuda_runtime.h>

#include <cstdint>

// A named namespace, so that a profiler's kernel names (k7::...) tell the
// probes and the floor from other kernels.
namespace k7 {

constexpr int kRows = 16;
constexpr int kCols = 128;
constexpr int kBcast4 = 8 * 128 / 4;  // float4 stores of a (8, 128) output
constexpr int kLanes = 32;
constexpr int kBcastThreads = kBcast4;  // p1, p1b, p3: one float4 each
constexpr int kSumThreads = 4 * kLanes;  // p4, p5: four warps
constexpr int kTThreads = (kRows / 4) * (kCols / 4);  // one per 4x4 block
constexpr int kTPitch = 20;        // p2's x^T row pitch (80 bytes, 16-aligned)
constexpr int kP5Rows = 9;
constexpr unsigned kFull = 0xffffffffu;

// out: 16-byte aligned (the wrapper's allocation)
__device__ __forceinline__ void write_bcast(float* __restrict__ out, float v,
                                            int tid, int nthreads) {
  float4* o = reinterpret_cast<float4*>(out);
  const float4 q = make_float4(v, v, v, v);
  for (int i = tid; i < kBcast4; i += nthreads) o[i] = q;
}

// --- mbarrier and bulk copy (PTX) ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the bulk-copy unit
__device__ __forceinline__ void fence_mbar_init() {
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

// probes 0 and 1: every warp rolls row 0 for itself
template <bool kFromData>
__global__ void __launch_bounds__(kBcastThreads)
roll_bcast_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int lane = threadIdx.x & (kLanes - 1);
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
  write_bcast(out, __shfl_sync(kFull, v[0], 0), threadIdx.x, kBcastThreads);
}

// Thread t of kTThreads loads the 4x4 block of x at rows 4 (t % 4) + i and
// columns 4 (t / 4) + j as four float4 rows r[i], and returns its
// transpose: c[j] = (r[0].j, r[1].j, r[2].j, r[3].j), x^T's row 4 (t / 4) +
// j at columns 4 (t % 4) .. + 3. A warp reads four 128-byte runs of x and
// writes eight 64-byte runs of x^T.
__device__ __forceinline__ void load_block_t(const float* __restrict__ x,
                                             int t, float4 c[4]) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int rb = t & 3, cb = t >> 2;
  float4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = x4[(4 * rb + i) * (kCols / 4) + cb];
  c[0] = make_float4(r[0].x, r[1].x, r[2].x, r[3].x);
  c[1] = make_float4(r[0].y, r[1].y, r[2].y, r[3].y);
  c[2] = make_float4(r[0].z, r[1].z, r[2].z, r[3].z);
  c[3] = make_float4(r[0].w, r[1].w, r[2].w, r[3].w);
}

// probe 2: x^T into shared memory as float4 rows, then rows 0..3 of its
// column 0 read back
__global__ void __launch_bounds__(kTThreads)
twostep_kernel(const float* __restrict__ x, float* __restrict__ out) {
  // pitch 20: a quarter warp's eight float4 stores fall in distinct banks
  __shared__ __align__(16) float s[kCols][kTPitch];
  const int t = threadIdx.x;
  float4 c[4];
  load_block_t(x, t, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(&s[4 * (t >> 2) + j][4 * (t & 3)]) = c[j];
  }
  __syncthreads();
  float acc = 0.f;
  for (int i = 0; i < 4; ++i) acc = __fadd_rn(acc, s[i][0]);
  write_bcast(out, acc, t, kTThreads);
}

// probe 3: x^T straight from registers
__global__ void __launch_bounds__(kTThreads)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int t = threadIdx.x;
  float4 c[4];
  load_block_t(x, t, c);
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o4[(4 * (t >> 2) + j) * (kRows / 4) + (t & 3)] = c[j];
  }
}

// probe 4: `words` floats of dynamic shared memory; every warp waits
__global__ void __launch_bounds__(kBcastThreads)
bulk_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int words) {
  extern __shared__ __align__(128) float s_buf[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(min(words, kCols)) * 4;
    mbar_init(b, 1);
    fence_mbar_init();
    mbar_expect_tx(b, bytes);
    bulk_load(smem_addr(s_buf), x, bytes, b);
  }
  __syncthreads();
  mbar_wait(b, 0);
  write_bcast(out, s_buf[5], threadIdx.x, kBcastThreads);
}

// probe 5: every warp sums for itself
__global__ void __launch_bounds__(kSumThreads)
smem_loop_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float s_row[kCols];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    mbar_init(b, 1);
    fence_mbar_init();
    mbar_expect_tx(b, kCols * 4);
    bulk_load(smem_addr(s_row), x, kCols * 4, b);
  }
  __syncthreads();
  mbar_wait(b, 0);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc = __fadd_rn(acc, s_row[i]);
  write_bcast(out, acc, threadIdx.x, kSumThreads);
}

// probe 6: every warp sums for itself; rows 0-1 complete on bars[0], rows
// 2-8 on bars[1]
// (x's rows are contiguous, so each group is one copy: one thread issuing
// nine row copies held the warp ~0.0001 ms longer)
__global__ void __launch_bounds__(kSumThreads)
smem_2d_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float s[kP5Rows][kCols];
  __shared__ __align__(8) uint64_t bars[2];
  const uint32_t first = smem_addr(&bars[0]), rest = smem_addr(&bars[1]);
  if (threadIdx.x == 0) {
    constexpr uint32_t kFirst = 2 * kCols * 4;
    constexpr uint32_t kRest = (kP5Rows - 2) * kCols * 4;
    mbar_init(first, 1);
    mbar_init(rest, 1);
    fence_mbar_init();
    mbar_expect_tx(first, kFirst);
    bulk_load(smem_addr(&s[0][0]), x, kFirst, first);
    mbar_expect_tx(rest, kRest);
    bulk_load(smem_addr(&s[2][0]), x + 2 * kCols, kRest, rest);
  }
  __syncthreads();
  mbar_wait(first, 0);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    acc = __fadd_rn(acc, __fmul_rn(s[0][i], s[1][i]));
  }
  // the block may not end while a copy into its shared memory is in flight
  mbar_wait(rest, 0);
  write_bcast(out, acc, threadIdx.x, kSumThreads);
}

// the launch floor: one warp, no work
__global__ void __launch_bounds__(kLanes) floor_kernel() {}

}  // namespace k7

extern "C" {

// x: (16, 128) float32, 16-byte aligned; out: (8, 128) float32, or (128,
// 16) for probe 3, 16-byte aligned. `param` is probe 4's buffer size in KB
// (2, 4, 8 or 16). Launches probe `probe` (numbered as above) on `stream`
// and returns cudaGetLastError() (0 on success).
int mosaic_probe(int probe, int param, const void* x, void* out,
                 void* stream) {
  using namespace k7;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  switch (probe) {
    case 0: roll_bcast_kernel<false><<<1, kBcastThreads, 0, s>>>(in, o); break;
    case 1: roll_bcast_kernel<true><<<1, kBcastThreads, 0, s>>>(in, o); break;
    case 2: twostep_kernel<<<1, kTThreads, 0, s>>>(in, o); break;
    case 3: transpose_kernel<<<1, kTThreads, 0, s>>>(in, o); break;
    case 4: {
      if (param != 2 && param != 4 && param != 8 && param != 16) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int words = param * 256;
      bulk_copy_kernel<<<1, kBcastThreads, words * 4, s>>>(in, o, words);
      break;
    }
    case 5: smem_loop_kernel<<<1, kSumThreads, 0, s>>>(in, o); break;
    case 6: smem_2d_kernel<<<1, kSumThreads, 0, s>>>(in, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the empty floor_kernel (one block of one warp) on `stream` and
// returns cudaGetLastError(): the floor each probe is timed against. Not a
// probe.
int mosaic_probe_floor(void* stream) {
  k7::floor_kernel<<<1, k7::kLanes, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* mosaic_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
