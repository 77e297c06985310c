// One-pass table-cut SVF filter for large voice counts, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _onepass_table_kernel in zang_tpu/ops/pallas_svf.py,
// driven by _svf_onepass_table (reached through svf_onepass_table). Computes
// the function of the table-cut kernel (svf_table.cu), with the same
// arguments:
//
//   cut(v, t)  = cv[v, k, j] for the last slot j (in slot order) whose
//                boundary tb[v, k, j] <= t, slot 0 always; k = (t - t0) / (n / nt)
//   t < af[v]  : inactive, state untouched, output 0
//   otherwise  : the SVF step (svf_scan.cuh step), out = l*lm + b*bm + h*hm
//
// but walks each voice's whole chunk in order from (l0, b0): no runs, no
// affine maps, no scan, so the output is the exact sequential recurrence,
// bit for bit with the plain loop (filters.svf_onepass_table_ref).
//
// What bounds it on this card: at V = 16384 the bytes (x in, out out: 8.6 GB
// a 65536-frame chunk, 2.57 ms at 3.35 TB/s), below that each voice's serial
// chain: a step is 11 dependent f32 operations from the state in to the
// state out (4 cycles each on this card), and nothing may reorder them.
// With thousands of voices the voices fill the card, so time need not be
// split: one thread a voice. A chain warp's time is then its chain's
// latency plus everything else it waits on, so the design takes the rest
// off it:
//
//   - A block takes 32 voices and is warp-specialised (as fm_feedback.cu).
//     Warp 0 runs the chains, a lane a voice, the state in registers; it
//     touches only shared memory and registers. Warp 1 is the copy warp:
//     x is [V, n] row-major, so it stages tiles of [32 voices x kTile
//     samples] along time with 16-byte cp.async (a lane 16 bytes, the warp
//     a voice's tile in one instruction), kStages tiles in flight, and
//     drains each finished tile, which the chain warp wrote over its input,
//     back to out along time. The handoff is two named barriers a stage
//     (bar.arrive / bar.sync: tile full, tile done), so neither warp spins,
//     and the copies issue from another scheduler than the chain's.
//     16-byte copies need every row to start on 16 bytes, so n % 4 == 0
//     (the renderer's chunks are multiples of 512); another n is refused.
//     Two stages of 32 x (kTile + 4) floats are 33,792 bytes of shared
//     memory; four blocks an SM (16384 voices in one wave) take 135 KB.
//     A third stage (203 KB an SM) and six stages of 64 samples read
//     slower on the card at 4096 and 16384 voices, not faster: with the
//     chain warp off the copies, one tile in flight while the chain steps
//     the other keeps up at 4096 voices, and at 16384 the bytes set the
//     pace however deep the ring.
//   - The chain lane takes its row kBatch = 32 samples at a time into
//     registers with 16-byte shared loads, steps them and writes them back.
//     Rows are kTile + 4 floats apart: the 16-byte accesses of a quarter
//     warp, a row a lane, fall on all 32 banks. What a batch costs besides
//     its steps (the loads and stores, the branches that pick its path) is
//     paid once a batch, so the batch is as long as the code stays small.
//   - A tile is walked in runs that end where it ends or a time tile does:
//     whole batches, and a sample at a time only where a run starts off 16
//     bytes or leaves less than a batch (a time tile that ends inside a
//     batch, a ragged last tile).
//   - Activity is decided a batch at a time for the whole warp (its lanes
//     must take one path), from two numbers the warp reduces once: the
//     latest and the earliest af of its voices. Frames only grow inside a
//     batch, so once its first sample is at or past every lane's af, all
//     its samples are: such a batch steps with no select (one operation
//     fewer on the chain); a batch that no lane reaches is zeros and leaves
//     the state alone; only a batch that holds some lane's af steps with
//     the selects of the plain loop. Selects only choose, so all three give
//     the same bits.
//   - The cutoff likewise: when no lane has a boundary of the current time
//     tile inside a batch (after its first sample), the batch's cutoff is
//     looked up once; otherwise per sample, by the plain rule, which holds
//     for any table, sorted or not. Which batches of a time tile are free
//     of boundaries is a bit each, OR-reduced over the warp when the tile
//     starts (when its batches start on multiples of kBatch from it, as
//     every power-of-two chunk and tile gives); otherwise every batch takes
//     the per-sample rule.
//   - The current time tile's slots (boundary frames and cutoffs) stay in
//     registers, the next tile's loaded a tile ahead, and change every
//     n / nt samples. A tile has at most kRegSlots of them (poly_echo has
//     2-3); more are refused (svf_table.cu takes any number).
//
// A tile is read whole before it is written and the tiles in flight are
// others, so out may be x itself (the TPU kernel aliases them too: the
// extra [V, n] buffer is what breaks memory at 16384 voices).
//
// None of the TPU version's relayouts is needed: no voice-major copy of x,
// no transposed tables, no padding of V, no gate-encoded activity slot; any
// V, any nt, any n that nt and 4 divide. No TMA: bulk copies (a row's tile
// a copy, completing on an mbarrier) moved the same bytes no faster than
// the copy warp's cp.async, whose instructions are off the chain's
// scheduler already. No wgmma: there is no product.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "svf_scan.cuh"
#include "svf_table_cut.cuh"

namespace {

constexpr int kWarp = 32;              // voices a block, a chain lane each
constexpr int kThreads = 2 * kWarp;    // the chain warp and the copy warp
constexpr int kTile = 4 * kWarp;       // samples of a voice a tile: 16 bytes a copy lane
constexpr int kPitch = kTile + 4;      // floats from one row to the next
constexpr int kStages = 2;             // tiles in flight
constexpr int kBatch = 32;             // samples a chain lane holds in registers
constexpr int kRegSlots = 4;           // most slots a time tile keeps in registers
constexpr int kStage = kWarp * kPitch;          // floats a stage
constexpr int kShared = 4 * kStages * kStage;   // bytes of dynamic shared memory
constexpr int kLastBatchFrame = INT_MAX - (kBatch - 1);  // frames do not wrap in a batch
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTile % kBatch == 0 && kBatch % 4 == 0, "whole batches of 16-byte loads a tile");

extern __shared__ __align__(16) float op_tiles[];  // [kStages][kWarp][kPitch]

__device__ __forceinline__ float4& quad(float* p) { return *reinterpret_cast<float4*>(p); }

// named barriers 1..kStages (tile s full) and kStages + 1.. (tile s done);
// 0 is __syncthreads'
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int done_bar(int s) { return 1 + kStages + s; }

// One time tile's slots: boundary frames and cutoffs.
template <int kS>
struct Slots {
  int32_t tb[kS];
  float cv[kS];
};

template <int kS>
__device__ __forceinline__ void load_slots(Slots<kS>& sl, const int32_t* __restrict__ tb,
                                           const float* __restrict__ cv, size_t at) {
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    sl.tb[j] = tb[at + j];
    sl.cv[j] = cv[at + j];
  }
}

// The SVF's parameters and one active step: advances (l, b), returns the
// output mix in the plain loop's order.
struct Svf {
  float res, lm, bm, hm;

  __device__ __forceinline__ float on(float& l, float& b, float xin, float cut) const {
    const float h = zt_svf::step(l, b, xin, cut, res);
    return l * lm + b * bm + h * hm;
  }
  // the plain loop's sample: the step and its output only when on
  __device__ __forceinline__ float sel(float& l, float& b, float xin, float cut,
                                      bool on_) const {
    float nl = l, nb = b;
    const float h = zt_svf::step(nl, nb, xin, cut, res);
    l = on_ ? nl : l;
    b = on_ ? nb : b;
    return on_ ? nl * lm + nb * bm + h * hm : 0.f;
  }
};

// The chain warp: every tile of its 32 voices, in order (lane = a voice;
// a lane without one steps zeros and writes nothing). A tile is walked in
// runs that end where it ends or a time tile does: whole batches, and a
// sample at a time where a run does not start on 16 bytes or leaves less
// than a batch.
template <int kS>
__device__ __forceinline__ void chain_warp(const int32_t* __restrict__ tb,
                                           const float* __restrict__ cv,
                                           const int32_t* __restrict__ af,
                                           const float* __restrict__ l0,
                                           const float* __restrict__ b0,
                                           float* __restrict__ l_end,
                                           float* __restrict__ b_end, int V, int n, int nt,
                                           int t0, Svf f) {
  const int lane = threadIdx.x;
  const int vb = blockIdx.x * kWarp;
  const int v = vb + lane;
  const bool mine = v < V;
  const int vt = mine ? v : vb;  // the voice whose tables a lane reads
  const int tile_len = n / nt;
  const int n_tiles = (n + kTile - 1) / kTile;
  // a time tile's batches are told apart by a bit each when they start on
  // multiples of kBatch from it and its frames do not wrap
  const bool batch_bits = tile_len % kBatch == 0 && tile_len <= 64 * kBatch;

  float l = mine ? l0[v] : 0.f;
  float b = mine ? b0[v] : 0.f;
  const int first = mine ? af[v] : INT_MIN;
  // from first_max on every lane is active, before first_min none is
  const int first_max = __reduce_max_sync(kAll, first);
  const int first_min = __reduce_min_sync(kAll, mine ? first : INT_MAX);
  Slots<kS> cur{}, next;  // the current time tile's slots, and the next one's
  load_slots(next, tb, cv, static_cast<size_t>(vt) * nt * kS);
  int k = -1;      // the current time tile
  int next_k = 0;  // the sample at which time tile k + 1 starts
  // bit q: no lane has a boundary of time tile k inside its batch q (after
  // the batch's first sample), so the batch takes one cutoff
  unsigned long long one_cut = 0;

  auto sample = [&](float* p, int tt) {
    *p = f.sel(l, b, *p, zt_svf::table_cut(cur.tb, cur.cv, kS, tt), tt >= first);
  };
  // kBatch samples at p from frame tt, batch q of the time tile
  auto batch = [&](float* p, int tt, int q) {
    float r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; u += 4) {
      const float4 x4 = quad(p + u);
      r[u] = x4.x, r[u + 1] = x4.y, r[u + 2] = x4.z, r[u + 3] = x4.w;
    }
    if (tt >= first_max) {  // every lane active throughout: no select
      if (q < 64 && (one_cut >> q & 1)) {
        const float cut = zt_svf::table_cut(cur.tb, cur.cv, kS, tt);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) r[u] = f.on(l, b, r[u], cut);
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          r[u] = f.on(l, b, r[u], zt_svf::table_cut(cur.tb, cur.cv, kS, tt + u));
        }
      }
    } else if (tt + (kBatch - 1) < first_min) {  // no lane active: zeros
#pragma unroll
      for (int u = 0; u < kBatch; ++u) r[u] = 0.f;
    } else {  // some lane's af inside the batch: the plain loop's selects
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int tu = tt + u;
        r[u] = f.sel(l, b, r[u], zt_svf::table_cut(cur.tb, cur.cv, kS, tu), tu >= first);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; u += 4) {
      quad(p + u) = make_float4(r[u], r[u + 1], r[u + 2], r[u + 3]);
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    float* row = op_tiles + st * kStage + lane * kPitch;
    const int i0 = t * kTile;
    const int len = min(kTile, n - i0);
    bar_sync(full_bar(st));
    int i = 0;
    while (i < len) {
      if (i0 + i == next_k) {  // time tile k + 1 starts: the same for every lane
        cur = next;
        if (++k + 1 < nt) load_slots(next, tb, cv, (static_cast<size_t>(vt) * nt + k + 1) * kS);
        next_k += tile_len;
        const int base = t0 + k * tile_len;  // the tile's first frame
        one_cut = 0;
        if (batch_bits && base <= INT_MAX - (tile_len - 1)) {
          unsigned long long inside = 0;
#pragma unroll
          for (int j = 1; j < kS; ++j) {
            // the boundary's place in the tile, where it has one after the first frame
            const unsigned d = static_cast<unsigned>(cur.tb[j]) - static_cast<unsigned>(base);
            if (cur.tb[j] > base && d < static_cast<unsigned>(tile_len) && d % kBatch) {
              inside |= 1ull << (d / kBatch);
            }
          }
          one_cut = ~(static_cast<unsigned long long>(
                          __reduce_or_sync(kAll, static_cast<unsigned>(inside >> 32))) << 32 |
                      __reduce_or_sync(kAll, static_cast<unsigned>(inside)));
        }
      }
      const int stop = min(len, next_k - i0);  // this run's end
      const int q0 = i0 - (next_k - tile_len);  // the time tile's sample at i = 0
      for (; i < stop && (i & 3); ++i) sample(row + i, t0 + i0 + i);
      for (; i + kBatch <= stop && t0 + i0 + i <= kLastBatchFrame; i += kBatch) {
        batch(row + i, t0 + i0 + i, (q0 + i) / kBatch);
      }
      for (; i < stop; ++i) sample(row + i, t0 + i0 + i);
    }
    bar_arrive(done_bar(st));
  }
  if (mine) {
    l_end[v] = l;
    b_end[v] = b;
  }
}

// The copy warp: tile t of the block's rows [vb, vb + rows) of x into
// stage t % kStages, or out of it into out, along time (a lane 16 bytes).
__device__ __forceinline__ void load_tile(const float* x, int vb, int rows, int n, int t,
                                          int lane) {
  float* buf = op_tiles + (t % kStages) * kStage;
  const int c = 4 * lane;
  if (t * kTile + c < n) {
    const float* src = x + static_cast<size_t>(vb) * n + t * kTile + c;
#pragma unroll 8
    for (int r = 0; r < rows; ++r, src += n) {
      __pipeline_memcpy_async(buf + r * kPitch + c, src, sizeof(float4));
    }
  }
}

__device__ __forceinline__ void store_tile(float* out, int vb, int rows, int n, int t,
                                           int lane) {
  const float* buf = op_tiles + (t % kStages) * kStage;
  const int c = 4 * lane;
  if (t * kTile + c < n) {
    float* dst = out + static_cast<size_t>(vb) * n + t * kTile + c;
#pragma unroll 8
    for (int r = 0; r < rows; ++r, dst += n) {
      quad(dst) = *reinterpret_cast<const float4*>(buf + r * kPitch + c);
    }
  }
}

// Grid: ceil(V / 32) blocks of kThreads threads, kShared bytes of dynamic
// shared memory. x and out are not __restrict__: they may be the same
// buffer. kS: the slots of a time tile, held in registers.
template <int kS>
__global__ void __launch_bounds__(kThreads)
svf_onepass_kernel(const float* x, const int32_t* __restrict__ tb,
                   const float* __restrict__ cv, const int32_t* __restrict__ af,
                   const float* __restrict__ l0, const float* __restrict__ b0,
                   float* out, float* __restrict__ l_end, float* __restrict__ b_end,
                   int V, int n, int nt, int t0, const int32_t* __restrict__ t0p, float res,
                   float lm, float bm, float hm) {
  if (threadIdx.x < kWarp) {
    chain_warp<kS>(tb, cv, af, l0, b0, l_end, b_end, V, n, nt,
                   t0p == nullptr ? t0 : *t0p, Svf{res, lm, bm, hm});
    return;
  }
  const int lane = threadIdx.x % kWarp;
  const int vb = blockIdx.x * kWarp;
  const int rows = min(kWarp, V - vb);
  const int n_tiles = (n + kTile - 1) / kTile;
  // rows without a voice are zeros (their chain lanes step them), then
  // tiles 0..kStages-1 in flight, a commit group each
  for (int i = rows * kPitch + lane; i < kWarp * kPitch; i += kWarp) {
    for (int s = 0; s < kStages; ++s) op_tiles[s * kStage + i] = 0.f;
  }
  for (int t = 0; t < kStages; ++t) {
    if (t < n_tiles) load_tile(x, vb, rows, n, t, lane);
    __pipeline_commit();
  }
  __pipeline_wait_prior(kStages - 1);  // tile 0 has landed
  bar_arrive(full_bar(0));
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      // kStages + t groups committed, tile t + 1 the (t + 2)th
      __pipeline_wait_prior(kStages - 2);
      bar_arrive(full_bar((t + 1) % kStages));
    }
    bar_sync(done_bar(t % kStages));
    store_tile(out, vb, rows, n, t, lane);
    __syncwarp();  // the tile is read before the copy over it starts
    if (t + kStages < n_tiles) load_tile(x, vb, rows, n, t + kStages, lane);
    __pipeline_commit();
  }
}

using Kernel = void (*)(const float*, const int32_t*, const float*, const int32_t*,
                        const float*, const float*, float*, float*, float*, int, int, int,
                        int, const int32_t*, float, float, float, float);
static_assert(kRegSlots == 4, "one instance a slot count");
const Kernel kKernels[kRegSlots] = {svf_onepass_kernel<1>, svf_onepass_kernel<2>,
                                        svf_onepass_kernel<3>, svf_onepass_kernel<4>};

// Each instance prefers shared memory to L1: at 16384 voices four blocks an
// SM hold 135 KB. Attributes are a device's: set once on each device a bit
// stands for, and on others at every call.
cudaError_t set_attributes() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit & done.load()) return cudaSuccess;
  for (Kernel k : kKernels) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). All
// arrays are contiguous device memory on 16 bytes: x, out [V, n] (out is x
// or apart from it); tb, cv [V, nt, S]; af, l0, b0, l_end, b_end [V].
// n % nt == 0, n % 4 == 0, 1 <= S <= kRegSlots. t0p: the chunk's first
// frame (int32 [1], read once a block, so that a captured CUDA graph
// launches each replay at that replay's frame), or null for t0. Returns
// the launch's cudaError_t (0 = launched), or that of setting the kernel's
// shared memory preference; another shape is refused as an invalid value.
extern "C" int zt_svf_onepass(const float* x, const int32_t* tb, const float* cv,
                              const int32_t* af, const float* l0, const float* b0,
                              float* out, float* l_end, float* b_end, int V, int n,
                              int nt, int S, int t0, const int32_t* t0p, float res,
                              float lm, float bm, float hm, void* stream) {
  if (n % 4 || S < 1 || S > kRegSlots ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (V + kWarp - 1) / kWarp;
  kKernels[S - 1]<<<blocks, kThreads, kShared, static_cast<cudaStream_t>(stream)>>>(
      x, tb, cv, af, l0, b0, out, l_end, b_end, V, n, nt, t0, t0p, res, lm, bm, hm);
  return static_cast<int>(cudaGetLastError());
}
