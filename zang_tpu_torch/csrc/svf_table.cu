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
//   otherwise  : the SVF step (svf_scan.cuh step), out = l*lm + b*bm + h*hm
//
// What bounds it on this card, and the design (a cluster of blocks a
// voice, a window of x a block in shared memory, runs of 16 frames in
// registers, the run maps scanned by shuffles, across warps and across the
// cluster): svf_window.cuh, shared with the dense-cut kernel (svf_dense.cu).
// K1 takes a chunk that the windows cut whole (n = W * cluster * rounds, x
// on 16 bytes). What is its own is the source of a sample's cutoff, the
// TableSrc below:
//
//   - The window's tile tables (boundaries and cutoffs of its tiles, S slots
//     each) are staged in shared memory after the window of x, the
//     boundaries as suffix minima over the slots after slot 0: that makes
//     them nondecreasing and keeps "the last slot j with tb[j] <= t" the
//     same slot for every t, so a thread finds its run's starting slot once
//     and then only moves forward when t reaches the next boundary or a tile
//     edge (a run may straddle tiles: any tile n / nt, any S).
//   - Activity is t >= af[v]: a compare a frame.
//
// The run seams differ from the plain version's scan, so the output is held
// to it within -120 dBFS and the end state within 1e-5, not to the bit.
// Build with --fmad=false (svf_scan.cuh). ops/svf_cuda.py
// svf_table_emulated composes the same runs, scans and windows in torch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "svf_window.cuh"

namespace {

using namespace zt_svf;

// Tiles of the chunk that the window [lo, lo + W) touches.
__device__ __forceinline__ int window_tiles(int lo, int W, int tile) {
  return (lo + W - 1) / tile - lo / tile + 1;
}

// The cutoff and activity of voice v's frames from its tile tables.
struct TableSrc {
  const int32_t* tb;  // this voice's [nt, S] boundaries
  const float* cv;    // and raw cutoffs, clipped to [0, 1] by the caller
  int W, S, tile, t0, first;
  int k0, tiles;      // the window's first tile and its tile count, set by stage

  // the window's tables: boundaries as suffix minima over slots 1..S-1,
  // slot 0 always
  __device__ __forceinline__ void stage(unsigned char* rest, int lo, int, int tid,
                                        int nthr) {
    k0 = lo / tile;
    tiles = window_tiles(lo, W, tile);
    int32_t* tbs = reinterpret_cast<int32_t*>(rest);  // [tiles][S]
    float* cvs = reinterpret_cast<float*>(tbs + tiles * S);
    for (int row = tid; row < tiles; row += nthr) {
      const size_t at = static_cast<size_t>(k0 + row) * S;
      int32_t m = INT_MAX;
      for (int j = S - 1; j >= 1; --j) {
        m = min(m, tb[at + j]);
        tbs[row * S + j] = m;
        cvs[row * S + j] = cv[at + j];
      }
      tbs[row * S] = INT_MIN;
      cvs[row * S] = cv[at];
    }
  }

  // the cutoffs: the starting slot once, then forward at a boundary or a
  // tile edge
  __device__ __forceinline__ unsigned run(unsigned char* rest, int, int f0,
                                          float (&cr)[kRun]) const {
    const int32_t* tbs = reinterpret_cast<const int32_t*>(rest);
    const float* cvs = reinterpret_cast<const float*>(tbs + tiles * S);
    int base = (f0 / tile - k0) * S;
    int edge = (f0 / tile + 1) * tile;
    int j = 0;
    int next = S > 1 ? tbs[base + 1] : INT_MAX;
    float cut = cvs[base];
    unsigned act = 0;
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      const int f = f0 + u;
      if (f == edge) {
        base += S;
        edge += tile;
        j = 0;
        next = S > 1 ? tbs[base + 1] : INT_MAX;
        cut = cvs[base];
      }
      while (t0 + f >= next) {
        ++j;
        cut = cvs[base + j];
        next = j + 1 < S ? tbs[base + j + 1] : INT_MAX;
      }
      cr[u] = cut;
      act |= static_cast<unsigned>(t0 + f >= first) << u;
    }
    return act;
  }
};

// Grid: V x cluster blocks, clusters of `cluster` blocks along x (one voice
// each), blockDim.x = the runs of a window rounded up to whole warps. Each
// block takes `rounds` windows of W = n / (cluster * rounds) frames.
__global__ void __launch_bounds__(kMaxThreads)
svf_table_kernel(const float* __restrict__ x, const int32_t* __restrict__ tb,
                 const float* __restrict__ cv, const int32_t* __restrict__ af,
                 const float* __restrict__ l0, const float* __restrict__ b0,
                 float* __restrict__ out, float* __restrict__ l_end,
                 float* __restrict__ b_end, int n, int nt, int S, int rounds, int t0,
                 float res, float lm, float bm, float hm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int v = blockIdx.x / c;
  const int W = n / (c * rounds);
  const size_t row = static_cast<size_t>(v) * nt * S;
  TableSrc src = {tb + row, cv + row, W, S, n / nt, t0, af[v], 0, 0};
  svf_windows(src, x + static_cast<size_t>(v) * n, out + static_cast<size_t>(v) * n,
              l0[v], b0[v], l_end + v, b_end + v, n, W, rounds, true, res, lm, bm, hm,
              smem);
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). All
// arrays are contiguous device memory: x, out [V, n] (on 16 bytes); tb, cv
// [V, nt, S]; af, l0, b0, l_end, b_end [V]. The launch geometry is
// svf_table_geometry's: `cluster` blocks a voice, `rounds` windows a block,
// `threads` a block and `shared` bytes of dynamic shared memory; it is only
// checked here (whole runs and warps, the limits, room for the window and
// its tables). Returns the launch's cudaError_t (0 = launched); a geometry
// that does not fit is refused as an invalid value.
extern "C" int zt_svf_table(const float* x, const int32_t* tb, const float* cv,
                            const int32_t* af, const float* l0, const float* b0,
                            float* out, float* l_end, float* b_end, int V, int n,
                            int nt, int S, int t0, float res, float lm, float bm,
                            float hm, int cluster, int rounds, int threads, int shared,
                            void* stream) {
  if (V < 1 || nt < 1 || S < 1 || cluster < 1 || cluster > kMaxCluster || rounds < 1 ||
      n % nt || n % (cluster * rounds * kRun) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = n / (cluster * rounds);
  const int tile = n / nt;
  const int spans = (W - 1) / tile + 2;  // at least window_tiles of any window
  const int tiles = spans < nt ? spans : nt;
  const long long need = 4LL * (W / kRun) * kPitch + 8LL * tiles * S;
  if (threads % kWarp || threads * kRun < W || threads > kMaxThreads || shared < need ||
      shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int shared_set = 0;  // the dynamic shared memory allowed so far
  return static_cast<int>(launch_windows(svf_table_kernel, V, cluster, threads, shared,
                                         &shared_set, static_cast<cudaStream_t>(stream),
                                         x, tb, cv, af, l0, b0, out, l_end, b_end, n, nt,
                                         S, rounds, t0, res, lm, bm, hm));
}
