// K6: run-length decode, per-run difference rows -> per-slot rows, for
// Hopper (sm_90a).
//
// Replaces tools/exp_decode_proto.py::_decode_kernel (the Pallas TPU kernel
// launched there by decode_runs). Same contract: given run starts (N,)
// int32, non-decreasing, and per-run difference rows diffs (N, stride)
// int32, slot s in [0, domain) of the (domain, f) int32 output holds the sum
// modulo 2^32 of diffs[r, 0:f] over every run r with 0 <= starts[r] <= s.
// Runs that start at or past the domain add nothing. With diffs the row
// differences of per-run fields, that telescopes to the fields of the run
// owning s (binning._expand_runs).
//
// The TPU kernel walks its grid in order, one block of 4096 slots per step,
// scatter-adds each run's 128-lane row into a VMEM buffer, scans it with a
// ladder of sublane rolls and carries the column sums to the next step. Here
// blocks run in no order, so nothing carries between them; three passes on
// one stream take its place, each over blocks of `slots` output slots:
//   (a) block_sums: one block per output block finds its window of runs
//       (starts in [b*slots, (b+1)*slots), two warp-wide searches of the
//       starts) and sums their diffs per column;
//   (b) block_prefix: one block scans those sums over the blocks (exclusive);
//   (c) expand: one block per output block zeroes a shared (slots, f)
//       buffer, adds each run's diffs into its start's row with shared-memory
//       atomics (zero-length runs share a row and all add), scans each
//       column from the carry of (b), and stores the rows coalesced.
// All sums are uint32: signed overflow is undefined in C++, unsigned
// wraparound is the contract. Integer addition modulo 2^32 is associative
// and commutative, so the atomics' order changes no bit: the output is exact
// and repeats bit for bit. The TPU's 128-lane padding of diffs, its DMA
// chunking and its spill row are layout devices and are not ported.
//
// What bounds it on an H100: bytes. It must read each run's start and f
// diffs once and write f words per slot (the bound is worked out from each
// run's data in chip_smoke.py); passes (a) and (c) both read the diffs, and
// (c)'s atomics serialise on rows where many runs start.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kLanes = 32;
constexpr int kMaxF = 128;
constexpr int kMaxSlots = 4096;
constexpr int kSmemBudget = 100 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x) {
  const int lane = threadIdx.x & (kLanes - 1);
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// First index i of the sorted starts[0, n) with starts[i] >= key (n if
// none), by one whole warp: each round probes 32 evenly spaced points of
// [lo, hi) and keeps the stretch between the last probe below the key and
// the first one not below it.
__device__ long long warp_lower_bound(const int* __restrict__ starts,
                                      long long n, long long key) {
  const int lane = threadIdx.x & (kLanes - 1);
  long long lo = 0;
  long long hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > kLanes) {
    const long long step = (hi - lo + kLanes - 1) / kLanes;
    const long long probe = lo + (lane + 1) * step - 1;
    const bool below = probe < hi && starts[probe] < key;
    const int k = __popc(__ballot_sync(kFull, below));
    const long long next = lo + (k + 1) * step - 1;  // first probe not below
    hi = next < hi ? next : hi;
    lo += k * step;
  }
  const long long probe = lo + lane;
  const bool below = probe < hi && starts[probe] < key;
  return lo + __popc(__ballot_sync(kFull, below));
}

// (a) r0[b] = first run of block b (and r0[nb], past the last block's);
// partial[b, c] = sum of diffs[r, c] over block b's runs.
__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const int* __restrict__ starts, const int* __restrict__ diffs,
                  long long n, long long stride, int f, int slots, int nb,
                  int* __restrict__ r0, unsigned* __restrict__ partial) {
  __shared__ long long s_window[2];
  __shared__ unsigned s_sum[kThreads];
  const int b = blockIdx.x;
  if (threadIdx.x < kLanes) {
    const long long base = static_cast<long long>(b) * slots;
    const long long lo = warp_lower_bound(starts, n, base);
    const long long hi = warp_lower_bound(starts, n, base + slots);
    if (threadIdx.x == 0) {
      s_window[0] = lo;
      s_window[1] = hi;
      r0[b] = static_cast<int>(lo);
      if (b == nb - 1) r0[nb] = static_cast<int>(hi);
    }
  }
  __syncthreads();
  const long long lo = s_window[0];
  const long long hi = s_window[1];

  // the first `span` threads keep one column each: thread t sums column
  // t % f over rows lo + t / f, stepping span / f rows (coalesced rows)
  const int span = (kThreads / f) * f;
  unsigned acc = 0;
  if (threadIdx.x < span) {
    const int c = threadIdx.x % f;
    for (long long r = lo + threadIdx.x / f; r < hi; r += span / f) {
      acc += static_cast<unsigned>(diffs[r * stride + c]);
    }
  }
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < f) {
    unsigned total = 0;
    for (int t = threadIdx.x; t < span; t += f) total += s_sum[t];
    partial[static_cast<size_t>(b) * f + threadIdx.x] = total;
  }
}

// (b) prefix[b, c] = sum of partial[b', c] over b' < b, one column at a
// time in chunks of 1024 blocks with a running carry.
__global__ void __launch_bounds__(kScanThreads)
block_prefix_kernel(const unsigned* __restrict__ partial, int nb, int f,
                    unsigned* __restrict__ prefix) {
  constexpr int kWarps = kScanThreads / kLanes;
  __shared__ unsigned s_warp[kWarps];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  for (int c = 0; c < f; ++c) {
    unsigned carry = 0;
    for (int first = 0; first < nb; first += kScanThreads) {
      const int i = first + threadIdx.x;
      const unsigned v =
          i < nb ? partial[static_cast<size_t>(i) * f + c] : 0u;
      const unsigned incl = warp_inclusive_scan(v);
      if (lane == kLanes - 1) s_warp[warp] = incl;
      __syncthreads();
      if (warp == 0) s_warp[lane] = warp_inclusive_scan(s_warp[lane]);
      __syncthreads();
      const unsigned before = warp ? s_warp[warp - 1] : 0u;
      if (i < nb) prefix[static_cast<size_t>(i) * f + c] =
          carry + before + incl - v;
      carry += s_warp[kWarps - 1];
      __syncthreads();  // s_warp is written again by the next chunk
    }
  }
}

// (c) the rows of output block b. Shared layout: column c at c * (slots +
// 32); lane l of a warp owns rows [l * rows, (l + 1) * rows) of a column,
// rows = slots / 32, stored at l * (rows + 1) + j, so the lanes' serial
// walks in the scan fall in distinct banks.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ starts, const int* __restrict__ diffs,
              long long stride, int f, int slots, const int* __restrict__ r0,
              const unsigned* __restrict__ prefix, int* __restrict__ out) {
  extern __shared__ unsigned s_buf[];
  const int b = blockIdx.x;
  const int rows = slots / kLanes;
  const int col_len = slots + kLanes;
  const long long base = static_cast<long long>(b) * slots;

  for (int i = threadIdx.x; i < f * col_len; i += kThreads) s_buf[i] = 0u;
  __syncthreads();

  const long long lo = r0[b];
  const long long hi = r0[b + 1];
  const int span = (kThreads / f) * f;
  if (threadIdx.x < span) {
    const int c = threadIdx.x % f;
    unsigned* col = s_buf + c * col_len;
    for (long long r = lo + threadIdx.x / f; r < hi; r += span / f) {
      const int rel = static_cast<int>(starts[r] - base);  // in [0, slots)
      atomicAdd(col + rel + rel / rows,
                static_cast<unsigned>(diffs[r * stride + c]));
    }
  }
  __syncthreads();

  // inclusive scan down each column, seeded with the earlier blocks' sum:
  // warp w takes columns w, w + 8, ...
  const int lane = threadIdx.x & (kLanes - 1);
  for (int c = threadIdx.x / kLanes; c < f; c += kThreads / kLanes) {
    unsigned* seg = s_buf + c * col_len + lane * (rows + 1);
    unsigned sum = 0;
    for (int j = 0; j < rows; ++j) sum += seg[j];
    unsigned run = warp_inclusive_scan(sum) - sum
                   + prefix[static_cast<size_t>(b) * f + c];
    for (int j = 0; j < rows; ++j) {
      run += seg[j];
      seg[j] = run;
    }
  }
  __syncthreads();

  int* dst = out + static_cast<size_t>(base) * f;
  for (int i = threadIdx.x; i < slots * f; i += kThreads) {
    const int row = i / f;
    const int c = i - row * f;
    dst[i] = static_cast<int>(s_buf[c * col_len + row + row / rows]);
  }
}

}  // namespace

extern "C" {

// starts: (n,) int32; diffs: (n, stride) int32, row-major, of which the
// first f columns are read; out: (domain, f) int32; scratch: nb + 1 + 2 *
// nb * f int32 words, nb = domain / slots. `slots` (a power of two in [32,
// 4096] dividing domain, with f * (slots + 32) * 4 bytes <= 100 KB) is the
// output slots of one block. Launches on `stream` and returns the first
// launch error, cudaGetLastError() (0 on success).
int decode_runs(const void* starts, const void* diffs, long long n,
                long long stride, long long domain, int f, int slots,
                void* out, void* scratch, void* stream) {
  if (f < 1 || f > kMaxF || stride < f || n < 0 || slots < kLanes
      || slots > kMaxSlots || (slots & (slots - 1)) != 0 || domain <= 0
      || domain % slots != 0 || domain / slots > 0x7fffffffLL
      || static_cast<long long>(f) * (slots + kLanes) * 4 > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = static_cast<int>(domain / slots);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* r0 = static_cast<int*>(scratch);
  auto* partial = reinterpret_cast<unsigned*>(r0 + nb + 1);
  unsigned* prefix = partial + static_cast<size_t>(nb) * f;
  const auto* st = static_cast<const int*>(starts);
  const auto* d = static_cast<const int*>(diffs);
  const size_t smem = static_cast<size_t>(f) * (slots + kLanes) * 4;

  cudaError_t err = cudaFuncSetAttribute(
      expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  block_sums_kernel<<<nb, kThreads, 0, s>>>(st, d, n, stride, f, slots, nb,
                                            r0, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  block_prefix_kernel<<<1, kScanThreads, 0, s>>>(partial, nb, f, prefix);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<nb, kThreads, smem, s>>>(st, d, stride, f, slots, r0,
                                           prefix, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* decode_runs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
