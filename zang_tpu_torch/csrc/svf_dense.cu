// Dense-cut SVF filter for one render chunk, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in zang_tpu/ops/pallas_svf.py: _summary_kernel
// + _apply_kernel, driven by _svf_blocks (with the XLA glue scan between
// them) and entered through svf_filter_pallas. Computes what
// zang_tpu/ops/filters.py svf_filter computes for x [V, n] and a scalar res:
//
//   cut(v, t)  = clip(cutoff[v, t], 0, 1) in one of three forms: a scalar
//                c0, a [V, 1] column (stride 0 along time) or a row a voice
//                (stride 1 along time); a broadcast is never materialised
//   act(v, t)  = active[v, t] (bool, a column or a row a voice), or always
//   inactive   : state untouched, output 0
//   active     : the SVF step (svf_scan.cuh)
//
// The TPU had two variants: a probing one with a separate activity array
// (padded V < 256) and a gated one that folded activity into cut's sign to
// save HBM traffic at large V (pallas_svf.py:556-569). Both compute the same
// function; here one kernel reads activity where it is given and serves both.
//
// What bounds it on this card, and the design (a cluster of blocks a voice,
// a window of x a block in shared memory, runs of 16 frames in registers,
// the run maps scanned by shuffles, across warps and across the cluster):
// svf_window.cuh, shared with the table-cut kernel (svf_table.cu). What is
// K2's own is the DenseSrc below: a row-form cutoff is staged beside the
// window of x in the same layout (16-byte cp.async where the row starts on
// 16 bytes, else 4 bytes), a row-form mask as 16 bytes a run (16-, 4- or
// 1-byte copies as the row's start allows), and a column or scalar is read
// once. Any V >= 1 and n >= 1: the windows are whole runs, and the frames of
// the last window from n on are inactive (svf_dense_geometry in
// ops/svf_cuda.py). With a dense cutoff and mask a chunk moves x in, out, the
// cutoff (4 B) and the mask (1 B) a sample; with a scalar cutoff only x, out
// and the mask.
//
// The run seams differ from the plain version's scan: within -120 dBFS and
// end states within 1e-5 of it. ops/svf_cuda.py svf_dense_emulated composes
// the same seams in torch, and the kernel is held to it bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "svf_window.cuh"

namespace {

using namespace zt_svf;

// Start copying the bytes src[0, cnt) to dst[0, cnt): `width` bytes a copy
// (16 or 4, src on that many bytes) and the rest a byte at a time.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int cnt,
                                            int width, int tid, int nthr) {
  int full = 0;
  if (width == 16) {
    full = cnt / 16;
    for (int i = tid; i < full; i += nthr) {
      __pipeline_memcpy_async(dst + 16 * i, src + 16 * i, 16);
    }
    full *= 16;
  } else if (width == 4) {
    full = cnt / 4;
    for (int i = tid; i < full; i += nthr) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 4);
    }
    full *= 4;
  }
  for (int i = full + tid; i < cnt; i += nthr) dst[i] = src[i];
}

// The cutoff and activity of one voice's frames, in K2's forms.
struct DenseSrc {
  const float* c;     // this voice's cutoff row (stride 1), or nullptr: c0
  const uint8_t* a;   // this voice's mask row (stride 1), or nullptr: a0
  float c0;           // the scalar or column cutoff, clipped to [0, 1]
  bool a0;            // the column activity (true without a mask)
  bool c_wide;        // the cutoff row starts on 16 bytes
  int a_width;        // bytes a copy of the mask row: 16, 4 or 1
  int runs;           // of a window
  int n;

  __device__ __forceinline__ float* cs(unsigned char* rest) const {
    return reinterpret_cast<float*>(rest);  // [runs][kPitch], with a cutoff row
  }
  __device__ __forceinline__ uint8_t* as(unsigned char* rest) const {
    return rest + (c != nullptr ? 4 * runs * kPitch : 0);  // [runs][kRun], with a mask row
  }

  __device__ __forceinline__ void stage(unsigned char* rest, int lo, int cnt, int tid,
                                        int nthr) const {
    if (c != nullptr) stage_floats(cs(rest), c + lo, cnt, c_wide, tid, nthr);
    if (a != nullptr) stage_bytes(as(rest), a + lo, cnt, a_width, tid, nthr);
  }

  __device__ __forceinline__ unsigned run(unsigned char* rest, int lo, int f0,
                                          float (&cr)[kRun]) const {
    const int r = (f0 - lo) / kRun;
    if (c != nullptr) {
      float* row = cs(rest) + r * kPitch;
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        const float4 p = quad(row + u);
        cr[u] = fminf(fmaxf(p.x, 0.f), 1.f);
        cr[u + 1] = fminf(fmaxf(p.y, 0.f), 1.f);
        cr[u + 2] = fminf(fmaxf(p.z, 0.f), 1.f);
        cr[u + 3] = fminf(fmaxf(p.w, 0.f), 1.f);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRun; ++u) cr[u] = c0;
    }
    unsigned act = 0;
    if (a != nullptr) {
      const uint4 p = *reinterpret_cast<const uint4*>(as(rest) + r * kRun);
      const unsigned w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        act |= static_cast<unsigned>(((w[u / 4] >> (8 * (u % 4))) & 0xffu) != 0) << u;
      }
    } else if (a0) {
      act = (1u << kRun) - 1;
    }
    const int left = n - f0;  // frames of the run before n
    return left >= kRun ? act : act & ((1u << left) - 1);
  }
};

// Grid: V x cluster blocks, clusters of `cluster` blocks along x (one voice
// each), blockDim.x = the runs of a window rounded up to whole warps. Each
// block takes `rounds` windows of W frames; cluster * rounds * W >= n.
__global__ void __launch_bounds__(kMaxThreads)
svf_dense_kernel(const float* __restrict__ x, const float* __restrict__ cut,
                 const uint8_t* __restrict__ act, const float* __restrict__ l0,
                 const float* __restrict__ b0, float* __restrict__ out,
                 float* __restrict__ l_end, float* __restrict__ b_end, int n, int W,
                 int rounds, long long c_sv, long long c_st, long long a_sv,
                 long long a_st, float c0, float res, float lm, float bm, float hm,
                 bool x_wide, bool c_wide, int a_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int v = blockIdx.x / c;
  DenseSrc src = {nullptr, nullptr, c0, true, c_wide, a_width, W / kRun, n};
  if (cut != nullptr) {
    if (c_st == 0) {
      src.c0 = fminf(fmaxf(cut[v * c_sv], 0.f), 1.f);
    } else {
      src.c = cut + v * c_sv;
    }
  }
  if (act != nullptr) {
    if (a_st == 0) {
      src.a0 = act[v * a_sv] != 0;
    } else {
      src.a = act + v * a_sv;
    }
  }
  svf_windows(src, x + static_cast<size_t>(v) * n, out + static_cast<size_t>(v) * n,
              l0[v], b0[v], l_end + v, b_end + v, n, W, rounds, x_wide, res, lm, bm, hm,
              smem);
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). x, out
// [V, n] and l0, b0, l_end, b_end [V] are contiguous device memory. cut is
// f32 device memory read at cut[v * c_sv + t * c_st] with c_st 0 or 1, or
// null for the scalar c0 (clipped by the caller); act is bool device memory
// read at act[v * a_sv + t * a_st] with a_st 0 or 1, or null for always
// active. The launch geometry is svf_dense_geometry's: windows of `window`
// frames, `cluster` blocks a voice, `rounds` windows a block, `threads` a
// block and `shared` bytes of dynamic shared memory; it is only checked
// here. Returns the launch's cudaError_t (0 = launched); a geometry or form
// the kernel does not take is refused as an invalid value.
extern "C" int zt_svf_dense(const float* x, const float* cut, const uint8_t* act,
                            const float* l0, const float* b0, float* out,
                            float* l_end, float* b_end, int V, int n,
                            long long c_sv, long long c_st, long long a_sv,
                            long long a_st, float c0, float res, float lm,
                            float bm, float hm, int window, int cluster, int rounds,
                            int threads, int shared, void* stream) {
  const long long span = static_cast<long long>(window) * cluster * rounds;
  if (V < 1 || n < 1 || window < kRun || window % kRun || cluster < 1 ||
      cluster > kMaxCluster || rounds < 1 || span < n ||
      (cut != nullptr && c_st != 0 && c_st != 1) || (act != nullptr && a_st != 0 && a_st != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool c_row = cut != nullptr && c_st == 1, a_row = act != nullptr && a_st == 1;
  const int runs = window / kRun;
  const long long need = 4LL * runs * kPitch * (c_row ? 2 : 1) + (a_row ? 16LL * runs : 0);
  if (threads % kWarp || threads < runs || threads > kMaxThreads || shared < need ||
      shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool x_wide = at16(x) && at16(out) && n % 4 == 0;
  const bool c_wide = c_row && at16(cut) && c_sv % 4 == 0;
  int a_width = 1;
  if (a_row && at16(act) && a_sv % 16 == 0) {
    a_width = 16;
  } else if (a_row && reinterpret_cast<uintptr_t>(act) % 4 == 0 && a_sv % 4 == 0) {
    a_width = 4;
  }
  static int shared_set = 0;  // the dynamic shared memory allowed so far
  return static_cast<int>(launch_windows(svf_dense_kernel, V, cluster, threads, shared,
                                         &shared_set, static_cast<cudaStream_t>(stream),
                                         x, cut, act, l0, b0, out, l_end, b_end, n, window,
                                         rounds, c_sv, c_st, a_sv, a_st, c0, res, lm, bm,
                                         hm, x_wide, c_wide, a_width));
}
