// The windowed two-phase SVF body of the table-cut kernel (svf_table.cu, K1)
// and the dense-cut kernel (svf_dense.cu, K2), hand-written for Hopper
// (sm_90a). Only the source of each sample's cutoff and activity differs
// between the two, and it is the template parameter Src of svf_windows:
//
//   src.stage(rest, lo, cnt, tid, nthr)  start staging what the window of
//       frames [lo, lo + cnt) needs into shared memory after the window of
//       x (rest); cp.async copies join x's commit group, plain stores are
//       seen after the block's barrier
//   src.run(rest, lo, f0, cr)  the clipped cutoffs cr[u] of the frames
//       f0 + u of a run (read only where active) and its activity bits, bit
//       u for frame f0 + u; 0 for frames at or past n
//
// For one voice (one thread block cluster) it computes what
// zang_tpu/ops/filters.py svf_filter computes:
//
//   inactive : state untouched, output 0
//   active   : the SVF step (svf_scan.cuh step), out = l*lm + b*bm + h*hm
//
// What bounds it on this card: each voice's serial recurrence, and then the
// bytes. The design splits time so that every voice spreads over the card,
// and moves x across device memory once:
//
//   - A voice's chunk is cut into windows of W frames, a block a window
//     (svf_table_geometry and svf_dense_geometry in ops/svf_cuda.py). The
//     blocks of a voice form a thread block cluster of at most 8, launched
//     with cudaLaunchKernelEx. A chunk of more windows than the cluster has
//     blocks is walked in rounds: block r of the cluster takes windows
//     r, r + c, ..., and the state after each round's last window carries to
//     the next. A window may end past n (K2's ragged chunks): its frames
//     from n on are inactive and neither read nor written.
//   - The block copies its window into shared memory with 16-byte cp.async
//     (4-byte copies where a row does not start on 16 bytes), coalesced,
//     and keeps it there for both phases; phase B writes its outputs over
//     it and the block stores the window back. Runs lie kPitch = 20 floats
//     apart, so the 16-byte accesses of a quarter warp, a run a lane, fall
//     on all 32 banks.
//   - A thread a run of kRun = 16 frames, held in registers: phase A steps
//     the zero state and the two homogeneous basis columns through the run
//     (its affine map), the maps are scanned in three steps (warp shuffles,
//     the warps' totals in shared memory, the windows of the round, in
//     order, through distributed shared memory), and phase B replays the
//     exact recurrence from the run's start state. A thread's chain is
//     2 x 16 steps plus the scan.
//
// The run seams differ from the plain version's scan, so the output is held
// to it within -120 dBFS and the end state within 1e-5, not to the bit.
// Build with --fmad=false (svf_scan.cuh). ops/svf_cuda.py svf_table_emulated
// and svf_dense_emulated compose the same runs, scans and windows in torch.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "svf_scan.cuh"

namespace zt_svf {

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
    if (lane >= off) m = compose(p, m);
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

// Start copying src[0, cnt) into a window buffer whose runs lie kPitch floats
// apart: 16 bytes a copy where `wide` (src on 16 bytes), the rest 4 bytes.
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int cnt, bool wide,
                                             int tid, int nthr) {
  const int full = wide ? cnt / 4 : 0;
  for (int i = tid; i < full; i += nthr) {
    __pipeline_memcpy_async(dst + (i / 4) * kPitch + (i % 4) * 4, src + 4 * i, sizeof(float4));
  }
  for (int i = 4 * full + tid; i < cnt; i += nthr) {
    __pipeline_memcpy_async(dst + (i / kRun) * kPitch + i % kRun, src + i, sizeof(float));
  }
}

// Write a window buffer's first cnt frames to dst, as stage_floats reads them.
__device__ __forceinline__ void store_floats(float* dst, float* src, int cnt, bool wide,
                                             int tid, int nthr) {
  const int full = wide ? cnt / 4 : 0;
  for (int i = tid; i < full; i += nthr) {
    quad(dst + 4 * i) = quad(src + (i / 4) * kPitch + (i % 4) * 4);
  }
  for (int i = 4 * full + tid; i < cnt; i += nthr) {
    dst[i] = src[(i / kRun) * kPitch + i % kRun];
  }
}

// One voice's chunk: x, out [n] (this voice's rows), (l_in, b_in) the state
// before frame 0. Called by every thread of every block of the voice's
// cluster; each block takes `rounds` windows of W frames (a multiple of
// kRun), blockDim.x >= W / kRun. wide: x and out start on 16 bytes. smem:
// the block's dynamic shared memory, the window of x first. The thread that
// steps frame n - 1 writes the end state to *l_end, *b_end.
template <class Src>
__device__ __forceinline__ void svf_windows(Src& src, const float* __restrict__ x,
                                            float* __restrict__ out, float l_in, float b_in,
                                            float* __restrict__ l_end,
                                            float* __restrict__ b_end, int n, int W,
                                            int rounds, bool wide, float res, float lm,
                                            float bm, float hm, unsigned char* smem) {
  __shared__ Map warp_tot[kWarp];  // the warps' maps, then their inclusive scan
  __shared__ Map block_tot;        // this window's map, read by the later windows
  __shared__ float start[2];       // the state before this window

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int runs = W / kRun;

  float* xs = reinterpret_cast<float*>(smem);  // [runs][kPitch]
  unsigned char* rest = reinterpret_cast<unsigned char*>(xs + runs * kPitch);
  // the state before the round's first window (thread 0's)
  float carry_l = tid == 0 ? l_in : 0.f, carry_b = tid == 0 ? b_in : 0.f;

  for (int q = 0; q < rounds; ++q) {
    const int lo = (q * c + rank) * W;  // the window's first frame in the chunk
    const int cnt = max(0, min(W, n - lo));

    // stage x, and what the source needs, while x is in flight
    stage_floats(xs, x + lo, cnt, wide, tid, nthr);
    src.stage(rest, lo, cnt, tid, nthr);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // phase A: this thread's run [f0, f0 + kRun) of the chunk -> its affine
    // map. (l00, b00) is the zero state's trajectory (full step); (l10, b10)
    // and (l01, b01) are the basis columns under the homogeneous part of the
    // step (input and offsets dropped).
    const int f0 = lo + tid * kRun;
    const bool has_run = tid * kRun < cnt;
    float cr[kRun];
    unsigned act = 0;
    Map m = identity();
    if (has_run) {
      float xr[kRun];  // read again in phase B: not held across the scan
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        const float4 p = quad(xs + tid * kPitch + u);
        xr[u] = p.x, xr[u + 1] = p.y, xr[u + 2] = p.z, xr[u + 3] = p.w;
      }
      act = src.run(rest, lo, f0, cr);

      float l00 = 0.f, b00 = 0.f, l10 = 1.f, b10 = 0.f, l01 = 0.f, b01 = 1.f;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (!((act >> u) & 1u)) continue;
        const float k = cr[u];
        step(l00, b00, xr[u], k, res);

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
      const int nwarps = nthr / kWarp;
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
      float xr[kRun];
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        const float4 p = quad(xs + tid * kPitch + u);
        xr[u] = p.x, xr[u + 1] = p.y, xr[u + 2] = p.z, xr[u + 3] = p.w;
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        float o = 0.f;
        if ((act >> u) & 1u) {
          const float h = step(l, b, xr[u], cr[u], res);
          o = l * lm + b * bm + h * hm;
        }
        xr[u] = o;
      }
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        quad(xs + tid * kPitch + u) = make_float4(xr[u], xr[u + 1], xr[u + 2], xr[u + 3]);
      }
      if (f0 <= n - 1 && n - 1 < f0 + kRun) {
        *l_end = l;
        *b_end = b;
      }
    }
    __syncthreads();
    store_floats(out + lo, xs, cnt, wide, tid, nthr);
    if (q + 1 < rounds) __syncthreads();  // the window and warp_tot are free again
  }
}

// The cluster launch of a windowed kernel: V clusters of `cluster` blocks of
// `threads` threads with `shared` bytes of dynamic shared memory, allowed
// first (*shared_set: what the kernel is allowed so far; the default limit
// counts the static shared memory too). Returns the launch's cudaError_t,
// cleared as a refused <<<>>> launch would be.
template <class Kernel, class... Args>
cudaError_t launch_windows(Kernel kernel, int V, int cluster, int threads, int shared,
                           int* shared_set, cudaStream_t stream, Args... args) {
  if (shared > *shared_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
    *shared_set = shared;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(V) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace zt_svf
