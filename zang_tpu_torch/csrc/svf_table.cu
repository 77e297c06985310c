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
//   otherwise  : the SVF step (svf_scan.cuh)
//
// What bounds it, and the design (one block per voice, phase A, a scan of
// the run maps in shared memory, phase B): svf_scan.cuh, shared with the
// dense-cut kernel (svf_dense.cu). Here the cutoff comes from the boundary
// tables (a few KB a voice) and activity from one compare, so a chunk moves
// x in and out only: ~7 MB at the song's V=14, n=65536. One launch per chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "svf_scan.cuh"
#include "svf_table_cut.cuh"

namespace {

using zt_svf::TableCut;  // svf_table_cut.cuh

__global__ void __launch_bounds__(zt_svf::kThreads)
svf_table_kernel(const float* __restrict__ x, const int32_t* __restrict__ tb,
                 const float* __restrict__ cv, const int32_t* __restrict__ af,
                 const float* __restrict__ l0, const float* __restrict__ b0,
                 float* __restrict__ out, float* __restrict__ l_end,
                 float* __restrict__ b_end, int n, int nt, int S, int t0,
                 float res, float lm, float bm, float hm) {
  const int v = blockIdx.x;
  const TableCut src = {tb + static_cast<size_t>(v) * nt * S,
                        cv + static_cast<size_t>(v) * nt * S, S, n / nt, t0, af[v]};
  zt_svf::svf_voice(src, x + static_cast<size_t>(v) * n,
                    out + static_cast<size_t>(v) * n, n, l0[v], b0[v], res, lm, bm,
                    hm, l_end + v, b_end + v);
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
  svf_table_kernel<<<V, zt_svf::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, tb, cv, af, l0, b0, out, l_end, b_end, n, nt, S, t0, res, lm, bm, hm);
  return static_cast<int>(cudaGetLastError());
}
