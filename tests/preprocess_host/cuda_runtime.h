// Host stand-in for <cuda_runtime.h>: just enough for the per-Gaussian row
// functions of csrc/preprocess_common.cuh to build as plain C++ (the CPU
// test test_torch_preprocess_route.py runs them against the plain version).
#pragma once
#include <math.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#define __device__
#define __forceinline__ inline
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline int2 make_int2(int a, int b) { return {a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostDim3 { int x; };
static const HostDim3 threadIdx{0};
using std::isfinite;
using std::isnan;
using std::max;
using std::min;
