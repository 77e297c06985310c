// The cutoff of the one-pass table-cut SVF kernel (svf_onepass.cu, K3) from
// per-tile boundary tables, the tiled segment-program format of
// zang_tpu/ops/segprog.py chunkify_tiled: a chunk of n frames is nt time
// tiles; each tile has S slots (tb absolute boundary frame, cv cutoff), and
//
//   cut(t) = cv[j] for the last slot j (in slot order) with tb[j] <= t,
//            slot 0 always
//
// K3 keeps the current tile's slots in registers and selects with
// table_cut. The table-cut kernel (svf_table.cu, K1) computes the same rule
// with a slot pointer over tables staged in shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zt_svf {

// One tile's slots tb[j], cv[j], j < S; t absolute.
__device__ __forceinline__ float table_cut(const int32_t* tb, const float* cv, int S,
                                           int t) {
  float c = cv[0];
  for (int j = 1; j < S; ++j) {
    if (t >= tb[j]) c = cv[j];
  }
  return c;
}

}  // namespace zt_svf
