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
// blocks run in no order, so the carry becomes a single-pass scan with a
// decoupled look-back, in one launch. Each block of `slots` output slots:
//   - takes its block index from a ticket counter, so it waits only on
//     blocks that are already running (the last ticket of a launch puts the
//     counter back to 0 for the next launch on the stream);
//   - finds its window of runs (starts in [b*slots, (b+1)*slots), two
//     warp-wide searches of the starts, one warp each);
//   - reads the window's diffs once, adding each run's row into its start's
//     row of a shared (slots, f) buffer with shared-memory atomics
//     (zero-length runs share a row and all add) and summing each column;
//   - publishes its column sums, then looks back over the blocks before it
//     (a warp per column, 32 blocks per step) until it meets one whose
//     inclusive prefix is published, and publishes its own;
//   - scans each column of the buffer from that carry and stores the rows
//     coalesced.
// A status word is (tag << 32 | value), tag 2*seq for a block's sum and
// 2*seq + 1 for its inclusive prefix, seq the call's sequence number: words
// of earlier calls never match, so nothing is zeroed between calls. The
// caller keeps one status buffer per stream (zeroed once) and counts seq.
// All sums are uint32: signed overflow is undefined in C++, unsigned
// wraparound is the contract. Integer addition modulo 2^32 is associative
// and commutative, so neither the atomics' order nor the look-back's
// grouping changes a bit: the output is exact and repeats bit for bit. The
// TPU's 128-lane padding of diffs, its DMA chunking and its spill row are
// layout devices and are not ported.
//
// What bounds it on an H100: bytes. It must read each run's start and f
// diffs once and write f words per slot (the bound is worked out from each
// run's data in chip_smoke.py). It reads them once and stores 16 bytes a
// thread; the fill issues kUnroll independent loads per thread before its
// atomics so that enough bytes are in flight, and the atomics still
// serialise on rows where many runs start. The caller gives each block
// 2048 slots where f allows (ops/decode_runs.py: slots_per_block): at f =
// 6 a block's buffer is 50 KB and four blocks share an SM. What is left
// at small domains is latency: with every block resident at once, a block
// that looks back finds only sums before it and walks back a window of 32
// blocks per step to the first block (block stamps on an H100 80GB HBM3 at
// 700 W, 655,360 slots: the look-back ~5 us of a block's ~20 us, the
// stores ~6 us).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;
constexpr int kMaxF = 128;
constexpr int kMaxSlots = 4096;
constexpr int kSmemBudget = 100 * 1024;
constexpr int kUnroll = 8;
constexpr int kMaxDevices = 64;
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

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned tag, unsigned value) {
  const unsigned long long v =
      (static_cast<unsigned long long>(tag) << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
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

// Exclusive prefix of column c before block b: warp-wide windows of 32
// earlier blocks (lane l reads block b - 1 - l - 32 i), each waited on until
// every lane's word carries this call's tag, summed up to and including the
// nearest block whose inclusive prefix is published.
__device__ unsigned look_back(const unsigned long long* status, int b, int f,
                              int c, unsigned seq) {
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned tag_sum = 2u * seq;
  const unsigned tag_prefix = tag_sum + 1u;
  unsigned excl = 0;
  for (int top = b - 1; top >= 0; top -= kLanes) {
    const int j = top - lane;
    unsigned long long w = 0;
    bool ready = j < 0;
    while (!__all_sync(kFull, ready)) {
      if (!ready) {
        w = load_status(status + static_cast<size_t>(j) * f + c);
        const unsigned tag = static_cast<unsigned>(w >> 32);
        ready = tag == tag_sum || tag == tag_prefix;
      }
    }
    const bool prefix = j >= 0 && static_cast<unsigned>(w >> 32) == tag_prefix;
    const unsigned done = __ballot_sync(kFull, prefix);
    // lanes up to the nearest published prefix (all lanes if none)
    const int last = done ? __ffs(done) - 1 : kLanes - 1;
    const bool add = j >= 0 && lane <= last;
    excl += __reduce_add_sync(kFull, add ? static_cast<unsigned>(w) : 0u);
    if (done) break;
  }
  return excl;
}

// Block layout of the shared buffer: column c at c * (slots + 32); lane l
// of a warp owns rows [l * rows, (l + 1) * rows) of a column, rows = slots /
// 32, stored at l * (rows + 1) + j, so the lanes' serial walks in the scan
// fall in distinct banks.
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int* __restrict__ starts, const int* __restrict__ diffs,
              long long n, long long stride, int f, int slots, int nb,
              unsigned seq, unsigned* __restrict__ ticket,
              unsigned long long* __restrict__ status,
              int* __restrict__ out) {
  extern __shared__ unsigned s_buf[];
  __shared__ long long s_window[2];
  __shared__ unsigned s_part[kThreads];
  __shared__ unsigned s_carry[kMaxF];
  __shared__ int s_b;

  if (threadIdx.x == 0) {
    const unsigned tk = atomicAdd(ticket, 1u);
    if (tk == static_cast<unsigned>(nb) - 1u) atomicExch(ticket, 0u);
    s_b = static_cast<int>(tk);
  }
  const int rows = slots / kLanes;
  const int col_len = slots + kLanes;
  for (int i = threadIdx.x; i < f * col_len / 4; i += kThreads) {
    reinterpret_cast<uint4*>(s_buf)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int b = s_b;
  const long long base = static_cast<long long>(b) * slots;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  if (warp < 2) {
    const long long r = warp_lower_bound(starts, n, base + warp * slots);
    if (lane == 0) s_window[warp] = r;
  }
  __syncthreads();
  const long long lo = s_window[0];
  const long long hi = s_window[1];

  // the first `span` threads keep one column each: thread t adds column
  // t % f of rows lo + t / f, stepping span / f rows (coalesced rows)
  const int span = (kThreads / f) * f;
  const int step = span / f;
  unsigned acc = 0;
  if (threadIdx.x < span) {
    const int c = threadIdx.x % f;
    unsigned* col = s_buf + c * col_len;
    for (long long r0 = lo + threadIdx.x / f; r0 < hi;
         r0 += static_cast<long long>(kUnroll) * step) {
      int rel[kUnroll];
      unsigned v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * step;
        rel[u] = -1;
        v[u] = 0u;
        if (r < hi) {
          rel[u] = static_cast<int>(starts[r] - base);  // in [0, slots)
          v[u] = static_cast<unsigned>(diffs[r * stride + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rel[u] >= 0) {
          atomicAdd(col + rel[u] + rel[u] / rows, v[u]);
          acc += v[u];
        }
      }
    }
  }
  s_part[threadIdx.x] = acc;
  __syncthreads();

  // publish the block's column sums, look back, publish its prefix: warp w
  // takes columns w, w + 8, ...
  for (int c = warp; c < f; c += kWarps) {
    unsigned total = 0;
    for (int t = lane; t < span / f; t += kLanes) total += s_part[t * f + c];
    total = __reduce_add_sync(kFull, total);
    unsigned long long* mine = status + static_cast<size_t>(b) * f + c;
    unsigned excl = 0;
    if (b > 0) {
      if (lane == 0) store_status(mine, 2u * seq, total);
      excl = look_back(status, b, f, c, seq);
    }
    if (lane == 0) {
      store_status(mine, 2u * seq + 1u, excl + total);
      s_carry[c] = excl;
    }
  }
  __syncthreads();

  // inclusive scan down each column from the carry
  for (int c = warp; c < f; c += kWarps) {
    unsigned* seg = s_buf + c * col_len + lane * (rows + 1);
    unsigned sum = 0;
    for (int j = 0; j < rows; ++j) sum += seg[j];
    unsigned run = warp_inclusive_scan(sum) - sum + s_carry[c];
    for (int j = 0; j < rows; ++j) {
      run += seg[j];
      seg[j] = run;
    }
  }
  __syncthreads();

  // 16-byte stores: slots * f is a multiple of 4 and the block's first
  // word, base * f, a multiple of 32
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(base) * f);
  for (int i4 = threadIdx.x; i4 < slots * f / 4; i4 += kThreads) {
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * i4 + e;
      const int row = i / f;
      const int c = i - row * f;
      v[e] = s_buf[c * col_len + row + row / rows];
    }
    dst[i4] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

int configured[kMaxDevices];  // dynamic shared memory already allowed

}  // namespace

extern "C" {

// starts: (n,) int32; diffs: (n, stride) int32, row-major, of which the
// first f columns are read; out: (domain, f) int32. `slots` (a power of two
// in [32, 4096] dividing domain, with f * (slots + 32) * 4 bytes <= 100 KB)
// is the output slots of one block. state: the stream's status buffer, one
// uint32 ticket (0 between launches) then, 8-byte aligned, nb * f uint64
// status words, nb = domain / slots; zeroed when allocated, then left to the
// kernel. seq: this call's sequence number on that buffer, in [1, 2^31),
// larger than every earlier call's. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int decode_runs(const void* starts, const void* diffs, long long n,
                long long stride, long long domain, int f, int slots,
                void* out, void* state, unsigned seq, void* stream) {
  if (f < 1 || f > kMaxF || stride < f || n < 0 || slots < kLanes
      || slots > kMaxSlots || (slots & (slots - 1)) != 0 || domain <= 0
      || domain % slots != 0 || domain / slots > 0x7fffffffLL
      || static_cast<long long>(f) * (slots + kLanes) * 4 > kSmemBudget
      || seq == 0 || seq >= 0x80000000u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!configured[dev]) {  // once per device and process
    err = cudaFuncSetAttribute(decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = 1;
  }
  const int nb = static_cast<int>(domain / slots);
  auto* ticket = static_cast<unsigned*>(state);
  auto* status = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(state) + 8);
  const size_t smem = static_cast<size_t>(f) * (slots + kLanes) * 4;
  decode_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(diffs), n,
      stride, f, slots, nb, seq, ticket, status, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* decode_runs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
