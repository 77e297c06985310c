// Dense-cut SVF filter for one render chunk, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in zang_tpu/ops/pallas_svf.py: _summary_kernel
// + _apply_kernel, driven by _svf_blocks (with the XLA glue scan between
// them) and entered through svf_filter_pallas. Computes what
// zang_tpu/ops/filters.py svf_filter computes for x [V, n] and a scalar res:
//
//   cut(v, t)  = clip(cutoff[v, t], 0, 1): a scalar, or a tensor broadcast
//                to [V, n] by its strides (0 along a broadcast axis), so a
//                [V, 1] or scalar cutoff is never materialised
//   act(v, t)  = active[v, t] (bool, broadcast the same way), or always
//   inactive   : state untouched, output 0
//   active     : the SVF step (svf_scan.cuh)
//
// The TPU had two variants: a probing one with a separate activity array
// (padded V < 256) and a gated one that folded activity into cut's sign to
// save HBM traffic at large V (pallas_svf.py:556-569). Both compute the same
// function; here one kernel reads activity where it is given and serves both.
//
// What bounds it, and the design (one block per voice, phase A, a scan of
// the run maps in shared memory, phase B): svf_scan.cuh, shared with the
// table-cut kernel (svf_table.cu). With a dense cutoff and mask a chunk moves
// x in, out, the cutoff (4 B) and the mask (1 B) a sample; with a scalar
// cutoff (FilteredSawtooth) only x, out and the mask.

#include <cstdint>
#include <cuda_runtime.h>

#include "svf_scan.cuh"

namespace {

struct DenseCut {
  const float* c;    // this voice's cutoff row, or nullptr: the scalar c0
  long long cs;      // its stride along time (0 = constant over the chunk)
  float c0;          // the scalar cutoff, already clipped to [0, 1]
  const uint8_t* a;  // this voice's activity row (bool), or nullptr: always
  long long as;      // its stride along time

  __device__ __forceinline__ bool active(int i) const {
    return a == nullptr || a[i * as] != 0;
  }

  __device__ __forceinline__ float cut(int i) const {
    return c == nullptr ? c0 : fminf(fmaxf(c[i * cs], 0.f), 1.f);
  }
};

__global__ void __launch_bounds__(zt_svf::kThreads)
svf_dense_kernel(const float* __restrict__ x, const float* __restrict__ cut,
                 const uint8_t* __restrict__ act, const float* __restrict__ l0,
                 const float* __restrict__ b0, float* __restrict__ out,
                 float* __restrict__ l_end, float* __restrict__ b_end, int n,
                 long long c_sv, long long c_st, long long a_sv, long long a_st,
                 float c0, float res, float lm, float bm, float hm) {
  const int v = blockIdx.x;
  const DenseCut src = {cut == nullptr ? nullptr : cut + v * c_sv, c_st, c0,
                        act == nullptr ? nullptr : act + v * a_sv, a_st};
  zt_svf::svf_voice(src, x + static_cast<size_t>(v) * n,
                    out + static_cast<size_t>(v) * n, n, l0[v], b0[v], res, lm, bm,
                    hm, l_end + v, b_end + v);
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). x, out
// [V, n] and l0, b0, l_end, b_end [V] are contiguous device memory. cut is
// f32 device memory read at cut[v * c_sv + t * c_st], or null for the scalar
// c0 (clipped by the caller); act is bool device memory read at
// act[v * a_sv + t * a_st], or null for always active. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int zt_svf_dense(const float* x, const float* cut, const uint8_t* act,
                            const float* l0, const float* b0, float* out,
                            float* l_end, float* b_end, int V, int n,
                            long long c_sv, long long c_st, long long a_sv,
                            long long a_st, float c0, float res, float lm,
                            float bm, float hm, void* stream) {
  svf_dense_kernel<<<V, zt_svf::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cut, act, l0, b0, out, l_end, b_end, n, c_sv, c_st, a_sv, a_st, c0, res,
      lm, bm, hm);
  return static_cast<int>(cudaGetLastError());
}
