// The pieces of the SVF filter that every SVF kernel shares: the sample
// step (step), in the exact f32 order of Filter.zig:123-147
// (pallas_svf.py:48-59), and the affine map of a run of steps (Map) with its
// composition (compose). The windowed two-phase body of the table-cut and
// dense-cut kernels (svf_window.cuh: K1, K2) uses all three, the one-pass
// kernel (svf_onepass.cu, K3) the step alone.
//
// Build with --fmad=false: the step is held to the reference in exact f32
// order, and a contracted a*b+c would round differently.

#pragma once

#include <cuda_runtime.h>

namespace zt_svf {

constexpr float kOff = 3.814697265625e-6f;  // 2^-18, Filter.zig:8

// s -> M s + v with M = [[a, b], [c, d]], v = [e, f]
struct Map {
  float a, b, c, d, e, f;
};

// y after x (zang_tpu/ops/scan.py _affine2_combine)
__device__ __forceinline__ Map compose(const Map& x, const Map& y) {
  Map r;
  r.a = y.a * x.a + y.b * x.c;
  r.b = y.a * x.b + y.b * x.d;
  r.c = y.c * x.a + y.d * x.c;
  r.d = y.c * x.b + y.d * x.d;
  r.e = y.a * x.e + y.b * x.f + y.e;
  r.f = y.c * x.e + y.d * x.f + y.f;
  return r;
}

// One active sample from the state (l, b) before it: advances (l, b) and
// returns h, in the f32 order of Filter.zig:123-147.
__device__ __forceinline__ float step(float& l, float& b, float x, float cut, float res) {
  const float inv = x + kOff;
  l = l + cut * b - kOff;
  b = b + cut * (inv - b * res - l);
  l = l + cut * b;
  const float h = inv - b * res - l;
  b = b + cut * h;
  return h;
}

}  // namespace zt_svf
