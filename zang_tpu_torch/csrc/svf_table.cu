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
// What bounds it on this card: each voice's serial recurrence, and then the
// bytes (x in, out out: 2.2 us at the song's V = 14 x 65,536, 161 us at
// V = 1024). The design splits time so that every voice spreads over the
// card, and moves x across device memory once:
//
//   - A voice's chunk is cut into windows of W frames (svf_table_geometry in
//     ops/svf_cuda.py: W = n up to 8192 frames, 8192 up to 65,536, n / 8 up
//     to 131,072, at most 16,384 beyond), a block a window. The blocks of a
//     voice form a thread block cluster (at most 8, launched with
//     cudaLaunchKernelEx): 112 blocks at the song's V = 14 where a block a
//     voice gave 14. A chunk of more windows than the cluster has blocks is
//     walked in rounds: block r of the cluster takes windows r, r + c, ...,
//     and the state after each round's last window carries to the next.
//   - The block copies its window into shared memory with 16-byte cp.async,
//     coalesced, and keeps it there for both phases; phase B writes its
//     outputs over it and the block stores the window with 16-byte stores.
//     Runs lie kPitch = 20 floats apart, so the 16-byte accesses of a
//     quarter warp, a run a lane, fall on all 32 banks.
//   - A thread a run of kRun = 16 frames, held in registers: phase A steps
//     the zero state and the two homogeneous basis columns through the run
//     (its affine map), the maps are scanned in three steps (warp shuffles,
//     the warps' totals in shared memory, the windows of the round, in
//     order, through distributed shared memory), and phase B replays the exact recurrence
//     from the run's start state. A thread's chain is 2 x 16 steps plus the
//     scan, where it was 2 x n / 256 steps.
//   - The window's tile tables (boundaries and cutoffs of its tiles, S slots
//     each) are staged in shared memory too, the boundaries as suffix minima
//     over the slots after slot 0: that makes them nondecreasing and keeps
//     "the last slot j with tb[j] <= t" the same slot for every t, so a
//     thread finds its run's starting slot once and then only moves forward
//     when t reaches the next boundary or a tile edge (a run may straddle
//     tiles: any tile n / nt, any S).
//
// The run seams differ from the plain version's scan, so the output is held
// to it within -120 dBFS and the end state within 1e-5, not to the bit.
// Build with --fmad=false (svf_scan.cuh). ops/svf_cuda.py
// svf_table_emulated composes the same runs, scans and windows in torch.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "svf_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using zt_svf::Map;

constexpr int kRun = 16;            // frames a thread steps, in registers
constexpr int kPitch = kRun + 4;    // floats from one run to the next in shared memory
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;   // W <= 16,384 frames
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxShared = 227 * 1024;

__device__ __forceinline__ float4& quad(float* p) { return *reinterpret_cast<float4*>(p); }

__device__ __forceinline__ Map identity() { return {1.f, 0.f, 0.f, 1.f, 0.f, 0.f}; }

__device__ __forceinline__ Map shfl_up(const Map& m, int off) {
  constexpr unsigned all = 0xffffffffu;
  return {__shfl_up_sync(all, m.a, off), __shfl_up_sync(all, m.b, off),
          __shfl_up_sync(all, m.c, off), __shfl_up_sync(all, m.d, off),
          __shfl_up_sync(all, m.e, off), __shfl_up_sync(all, m.f, off)};
}

// inclusive scan of the warp's maps in lane order (Kogge-Stone); every lane
// of the warp calls it
__device__ __forceinline__ Map warp_scan(Map m, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const Map p = shfl_up(m, off);
    if (lane >= off) m = zt_svf::compose(p, m);
  }
  return m;
}

// (l, b) -> M (l, b) + v
__device__ __forceinline__ void apply(const Map& m, float& l, float& b) {
  const float nl = m.a * l + m.b * b + m.e;
  const float nb = m.c * l + m.d * b + m.f;
  l = nl;
  b = nb;
}

// Tiles of the chunk that the window [lo, lo + W) touches.
__device__ __forceinline__ int window_tiles(int lo, int W, int tile) {
  return (lo + W - 1) / tile - lo / tile + 1;
}

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
  __shared__ Map warp_tot[kWarp];  // the warps' maps, then their inclusive scan
  __shared__ Map block_tot;        // this window's map, read by the later windows
  __shared__ float start[2];       // the state before this window

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  const int v = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int W = n / (c * rounds);
  const int runs = W / kRun;
  const int tile = n / nt;
  const int first = af[v];
  const bool has_run = tid < runs;

  float* xs = reinterpret_cast<float*>(smem);                       // [runs][kPitch]
  int32_t* tbs = reinterpret_cast<int32_t*>(xs + runs * kPitch);    // [tiles][S]
  // the state before the round's first window (thread 0's)
  float carry_l = tid == 0 ? l0[v] : 0.f, carry_b = tid == 0 ? b0[v] : 0.f;

  for (int q = 0; q < rounds; ++q) {
    const int lo = (q * c + rank) * W;  // the window's first frame in the chunk
    const int k0 = lo / tile;
    const int tiles = window_tiles(lo, W, tile);
    float* cvs = reinterpret_cast<float*>(tbs + tiles * S);  // [tiles][S]

    // stage x: 16 bytes a lane, along time
    const float* xv = x + static_cast<size_t>(v) * n + lo;
    for (int i = tid; i < W / 4; i += blockDim.x) {
      __pipeline_memcpy_async(xs + (i / 4) * kPitch + (i % 4) * 4, xv + 4 * i, sizeof(float4));
    }
    __pipeline_commit();
    // and the tables of the window's tiles while x is in flight: boundaries
    // as suffix minima over slots 1..S-1, slot 0 always
    for (int row = tid; row < tiles; row += blockDim.x) {
      const size_t at = (static_cast<size_t>(v) * nt + k0 + row) * S;
      int32_t m = INT_MAX;
      for (int j = S - 1; j >= 1; --j) {
        m = min(m, tb[at + j]);
        tbs[row * S + j] = m;
        cvs[row * S + j] = cv[at + j];
      }
      tbs[row * S] = INT_MIN;
      cvs[row * S] = cv[at];
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // phase A: this thread's run [f0, f0 + kRun) of the chunk -> its affine
    // map. (l00, b00) is the zero state's trajectory (full step); (l10, b10)
    // and (l01, b01) are the basis columns under the homogeneous part of the
    // step (input and offsets dropped).
    const int f0 = lo + tid * kRun;
    float xr[kRun], cr[kRun];
    Map m = identity();
    if (has_run) {
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        const float4 p = quad(xs + tid * kPitch + u);
        xr[u] = p.x, xr[u + 1] = p.y, xr[u + 2] = p.z, xr[u + 3] = p.w;
      }
      // the cutoffs: the starting slot once, then forward at a boundary or
      // a tile edge
      int base = (f0 / tile - k0) * S;
      int edge = (f0 / tile + 1) * tile;
      int j = 0;
      int next = S > 1 ? tbs[base + 1] : INT_MAX;
      float cut = cvs[base];
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
      }

      float l00 = 0.f, b00 = 0.f, l10 = 1.f, b10 = 0.f, l01 = 0.f, b01 = 1.f;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (t0 + f0 + u < first) continue;
        const float k = cr[u];
        zt_svf::step(l00, b00, xr[u], k, res);

        float dl = l10 + k * b10;
        float db = b10 - k * (b10 * res + dl);
        l10 = dl + k * db;
        b10 = db - k * (db * res + l10);

        dl = l01 + k * b01;
        db = b01 - k * (b01 * res + dl);
        l01 = dl + k * db;
        b01 = db - k * (db * res + l01);
      }
      m = {l10, l01, b10, b01, l00, b00};
    }

    // the scan, step 1: the runs of each warp
    m = warp_scan(m, lane);
    if (lane == kWarp - 1) warp_tot[warp] = m;
    __syncthreads();
    // step 2: the warps of the block
    if (warp == 0) {
      const int nwarps = blockDim.x / kWarp;
      Map w = lane < nwarps ? warp_tot[lane] : identity();
      w = warp_scan(w, lane);
      warp_tot[lane] = w;
      if (lane == nwarps - 1) block_tot = w;
    }
    // step 3: the windows of the round, through distributed shared memory;
    // before a later round, the state after all of them
    cluster.sync();
    if (tid == 0) {
      const int upto = q + 1 < rounds ? c : rank;
      float l = carry_l, b = carry_b;
      for (int r = 0; r <= upto; ++r) {
        if (r == rank) {
          start[0] = l;
          start[1] = b;
        }
        if (r < upto) apply(*cluster.map_shared_rank(&block_tot, r), l, b);
      }
      carry_l = l;
      carry_b = b;
    }
    cluster.sync();  // start is set, and no block leaves while another reads its map

    // this run's start state: the window's, then the earlier warps', then
    // the earlier runs' of this warp
    float l = start[0], b = start[1];
    if (warp > 0) apply(warp_tot[warp - 1], l, b);
    const Map before = shfl_up(m, 1);
    if (lane > 0) apply(before, l, b);

    // phase B: the exact recurrence from the start state, outputs over x
    if (has_run) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        float o = 0.f;
        if (t0 + f0 + u >= first) {
          const float h = zt_svf::step(l, b, xr[u], cr[u], res);
          o = l * lm + b * bm + h * hm;
        }
        xr[u] = o;
      }
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        quad(xs + tid * kPitch + u) = make_float4(xr[u], xr[u + 1], xr[u + 2], xr[u + 3]);
      }
      if (q == rounds - 1 && rank == c - 1 && tid == runs - 1) {
        l_end[v] = l;
        b_end[v] = b;
      }
    }
    __syncthreads();
    float* ov = out + static_cast<size_t>(v) * n + lo;
    for (int i = tid; i < W / 4; i += blockDim.x) {
      quad(ov + 4 * i) = quad(xs + (i / 4) * kPitch + (i % 4) * 4);
    }
    if (q + 1 < rounds) __syncthreads();  // x, the tables and warp_tot are free again
  }
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
  static int shared_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (shared > shared_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        svf_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    shared_set = shared;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(V) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, svf_table_kernel, x, tb, cv, af, l0, b0,
                                             out, l_end, b_end, n, nt, S, rounds, t0, res,
                                             lm, bm, hm);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, as a refused <<<>>> launch would be
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
