// Table-cut SVF filter for one render chunk, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in zang_tpu/ops/pallas_svf.py:
// _table_summary_kernel + _table_apply_kernel, driven by _svf_blocks_table
// (with the XLA glue scan between them). Computes what
// zang_tpu/ops/filters.py svf_filter_table computes:
//
//   cut(v, t)  = cv[v, k, j] for the last slot j (in slot order) whose
//                boundary tb[v, k, j] <= t, slot 0 always; k = (t - t0) / (n / nt)
//   t < af[v]  : inactive — state untouched, output 0
//   otherwise  : the SVF step of Filter.zig:123-147 (pallas_svf.py:48-59),
//                in that exact f32 order; out = l*lm + b*bm + h*hm
//
// Build with --fmad=false: the step is held to the reference in exact f32
// order, and a contracted a*b+c would round differently.
//
// What bounds it on this card: the serial recurrence. A chunk moves ~7 MB
// (the song's V=14, n=65536), but each sample depends on the previous one.
// Design: one block per voice, kThreads threads each owning a contiguous run
// of T = n / kThreads samples.
//   phase A  each thread steps the zero state and the two homogeneous basis
//            columns through its run -> its run's affine map (2x2 + offset)
//   scan     a Hillis-Steele scan of the kThreads maps in shared memory gives
//            each thread its start state (the XLA glue of the TPU version)
//   phase B  each thread replays the exact recurrence from its start state,
//            writes the output; the last thread writes the end state
// One launch per chunk. The dependent chain is ~2T steps a thread; kThreads
// trades chain length against the number of run seams. x is read with a
// stride of T between neighbouring threads (uncoalesced): a known cost, left
// for a later change. No TMA, no wgmma.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float cut_at(const int32_t* tb, const float* cv,
                                        int S, int t) {
  float c = cv[0];
  for (int j = 1; j < S; ++j) {
    if (t >= tb[j]) c = cv[j];
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
svf_table_kernel(const float* __restrict__ x, const int32_t* __restrict__ tb,
                 const float* __restrict__ cv, const int32_t* __restrict__ af,
                 const float* __restrict__ l0, const float* __restrict__ b0,
                 float* __restrict__ out, float* __restrict__ l_end,
                 float* __restrict__ b_end, int n, int nt, int S, int t0,
                 float res, float lm, float bm, float hm) {
  __shared__ float maps[2][6][kThreads];

  const int v = blockIdx.x;
  const int j = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(j * per, n);
  const int hi = min(lo + per, n);
  const int tile = n / nt;
  const float* xv = x + static_cast<size_t>(v) * n;
  float* ov = out + static_cast<size_t>(v) * n;
  const int32_t* tbv = tb + static_cast<size_t>(v) * nt * S;
  const float* cvv = cv + static_cast<size_t>(v) * nt * S;
  const int active_from = af[v];

  // phase A: this run's affine map. (l00, b00) is the zero state's
  // trajectory (full step); (l10, b10) and (l01, b01) are the basis columns
  // under the homogeneous part of the step (input and offsets dropped).
  float l00 = 0.f, b00 = 0.f, l10 = 1.f, b10 = 0.f, l01 = 0.f, b01 = 1.f;
  for (int i = lo; i < hi; ++i) {
    const int t = t0 + i;
    if (t < active_from) continue;
    const int k = i / tile;
    const float cut = cut_at(tbv + k * S, cvv + k * S, S, t);
    const float inv = xv[i] + kOff;
    float l = l00 + cut * b00 - kOff;
    float b = b00 + cut * (inv - b00 * res - l);
    l = l + cut * b;
    const float h = inv - b * res - l;
    b00 = b + cut * h;
    l00 = l;

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

  // start state: the maps of all earlier runs applied to (l0, b0)
  float l = l0[v];
  float b = b0[v];
  if (j > 0) {
    const int q = j - 1;
    const float nl = maps[p][0][q] * l + maps[p][1][q] * b + maps[p][4][q];
    const float nb = maps[p][2][q] * l + maps[p][3][q] * b + maps[p][5][q];
    l = nl;
    b = nb;
  }

  // phase B: the exact recurrence from the start state
  for (int i = lo; i < hi; ++i) {
    const int t = t0 + i;
    float o = 0.f;
    if (t >= active_from) {
      const int k = i / tile;
      const float cut = cut_at(tbv + k * S, cvv + k * S, S, t);
      const float inv = xv[i] + kOff;
      l = l + cut * b - kOff;
      b = b + cut * (inv - b * res - l);
      l = l + cut * b;
      const float h = inv - b * res - l;
      b = b + cut * h;
      o = l * lm + b * bm + h * hm;
    }
    ov[i] = o;
  }
  if (j == kThreads - 1) {
    l_end[v] = l;
    b_end[v] = b;
  }
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). All
// arrays are contiguous device memory: x, out [V, n]; tb, cv [V, nt, S];
// af, l0, b0, l_end, b_end [V]. n % nt == 0. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int zt_svf_table(const float* x, const int32_t* tb, const float* cv,
                            const int32_t* af, const float* l0, const float* b0,
                            float* out, float* l_end, float* b_end, int V,
                            int n, int nt, int S, int t0, float res, float lm,
                            float bm, float hm, void* stream) {
  svf_table_kernel<<<V, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, tb, cv, af, l0, b0, out, l_end, b_end, n, nt, S, t0, res, lm, bm, hm);
  return static_cast<int>(cudaGetLastError());
}
