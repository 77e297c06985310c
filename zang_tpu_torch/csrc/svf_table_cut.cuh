// The cutoff of the table-cut SVF kernels (svf_table.cu, K1; svf_onepass.cu,
// K3) from per-tile boundary tables, the tiled segment-program format of
// zang_tpu/ops/segprog.py chunkify_tiled: a chunk of n frames is nt time
// tiles; each tile has S slots (tb absolute boundary frame, cv cutoff), and
//
//   cut(t) = cv[j] for the last slot j (in slot order) with tb[j] <= t,
//            slot 0 always
//
// Both kernels select with table_cut, so the rule is written once; they
// differ in where a tile's slots lie (K1 reads them in place, K3 keeps the
// current tile's slots in registers).

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

// cutoff and activity of one voice's chunk from its tables in device memory
struct TableCut {
  const int32_t* tb;  // [nt, S] absolute boundary frames, slot 0 always active
  const float* cv;    // [nt, S] cutoff per slot, clipped to [0, 1]
  int S, tile, t0, active_from;

  __device__ __forceinline__ bool active(int i) const { return t0 + i >= active_from; }

  __device__ __forceinline__ float cut(int i) const {
    const int k = i / tile;
    return table_cut(tb + k * S, cv + k * S, S, t0 + i);
  }
};

}  // namespace zt_svf
