// The SVF filter's block-scan body, shared by the table-cut kernel
// (svf_table.cu, K1) and the dense-cut kernel (svf_dense.cu, K2). Only the
// source of each sample's cutoff and activity differs between the two; it is
// the template parameter Src:
//
//   src.active(i)  is sample i of this voice's chunk active?
//   src.cut(i)     its cutoff, clipped to [0, 1] (read only when active)
//
// The one-pass kernel (svf_onepass.cu, K3) takes only the sample step from
// here (step).
//
// For one voice (one CUDA block of kThreads threads) it computes what
// zang_tpu/ops/filters.py svf_filter computes:
//
//   inactive : state untouched, output 0
//   active   : the SVF step of Filter.zig:123-147 (pallas_svf.py:48-59), in
//              that exact f32 order; out = l*lm + b*bm + h*hm, with h from the
//              pre-step state
//
// Build with --fmad=false: the step is held to the reference in exact f32
// order, and a contracted a*b+c would round differently.
//
// What bounds it on this card: the serial recurrence. Each sample depends on
// the previous one, so the design splits time, not the arithmetic. Each of
// the kThreads threads owns a contiguous run of T = ceil(n / kThreads)
// samples:
//   phase A  each thread steps the zero state and the two homogeneous basis
//            columns through its run -> its run's affine map (2x2 + offset)
//   scan     a Hillis-Steele scan of the kThreads maps in shared memory gives
//            each thread its start state (the XLA glue of the TPU version)
//   phase B  each thread replays the exact recurrence from its start state,
//            writes the output; the last thread writes the end state
// The dependent chain is ~2T steps a thread; kThreads trades chain length
// against the number of run seams. x (and a dense cutoff) are read with a
// stride of T between neighbouring threads (uncoalesced): a known cost, left
// for a later change. No TMA, no wgmma.

#pragma once

#include <cuda_runtime.h>

namespace zt_svf {

constexpr int kThreads = 256;
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

// One voice's chunk: xv, ov [n]; (l_in, b_in) the state before sample 0.
// Call from every thread of a block of kThreads threads.
template <class Src>
__device__ __forceinline__ void svf_voice(const Src& src, const float* __restrict__ xv,
                                          float* __restrict__ ov, int n, float l_in,
                                          float b_in, float res, float lm, float bm,
                                          float hm, float* l_end, float* b_end) {
  __shared__ float maps[2][6][kThreads];

  const int j = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(j * per, n);
  const int hi = min(lo + per, n);

  // phase A: this run's affine map. (l00, b00) is the zero state's
  // trajectory (full step); (l10, b10) and (l01, b01) are the basis columns
  // under the homogeneous part of the step (input and offsets dropped).
  float l00 = 0.f, b00 = 0.f, l10 = 1.f, b10 = 0.f, l01 = 0.f, b01 = 1.f;
  for (int i = lo; i < hi; ++i) {
    if (!src.active(i)) continue;
    const float cut = src.cut(i);
    step(l00, b00, xv[i], cut, res);

    float dl = l10 + cut * b10;
    float db = b10 - cut * (b10 * res + dl);
    l10 = dl + cut * db;
    b10 = db - cut * (db * res + l10);

    dl = l01 + cut * b01;
    db = b01 - cut * (b01 * res + dl);
    l01 = dl + cut * db;
    b01 = db - cut * (db * res + l01);
  }

  // inclusive scan of the run maps, run order = thread order
  Map m = {l10, l01, b10, b01, l00, b00};
  int p = 0;
  maps[p][0][j] = m.a; maps[p][1][j] = m.b; maps[p][2][j] = m.c;
  maps[p][3][j] = m.d; maps[p][4][j] = m.e; maps[p][5][j] = m.f;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    if (j >= off) {
      const int q = j - off;
      const Map prev = {maps[p][0][q], maps[p][1][q], maps[p][2][q],
                        maps[p][3][q], maps[p][4][q], maps[p][5][q]};
      m = compose(prev, m);
    }
    p ^= 1;
    maps[p][0][j] = m.a; maps[p][1][j] = m.b; maps[p][2][j] = m.c;
    maps[p][3][j] = m.d; maps[p][4][j] = m.e; maps[p][5][j] = m.f;
    __syncthreads();
  }

  // start state: the maps of all earlier runs applied to (l_in, b_in)
  float l = l_in;
  float b = b_in;
  if (j > 0) {
    const int q = j - 1;
    const float nl = maps[p][0][q] * l + maps[p][1][q] * b + maps[p][4][q];
    const float nb = maps[p][2][q] * l + maps[p][3][q] * b + maps[p][5][q];
    l = nl;
    b = nb;
  }

  // phase B: the exact recurrence from the start state
  for (int i = lo; i < hi; ++i) {
    float o = 0.f;
    if (src.active(i)) {
      const float h = step(l, b, xv[i], src.cut(i), res);
      o = l * lm + b * bm + h * hm;
    }
    ov[i] = o;
  }
  if (j == kThreads - 1) {
    *l_end = l;
    *b_end = b;
  }
}

}  // namespace zt_svf
