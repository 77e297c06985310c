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
// affine maps, no scan, so the output is the exact sequential recurrence.
//
// What bounds it on this card: at V = 16384 the bytes (x in, out out: 8.6 GB
// a 65536-frame chunk, 2.6 ms), below that each voice's serial chain (a
// step's dependent chain is about 11 f32 operations). With thousands of
// voices the voices fill the card, so time need not be split: one thread a
// voice, a warp of 32 voices a block. The design is about everything around
// the chain. 16384 voices are 3.9 warps an SM, so a warp runs alone on its
// scheduler and nothing hides an instruction's latency but its own
// neighbours: the kernel's time is its instruction count, and the copies
// cost more of it than the filter unless they are wide.
//
//   - x is [V, n] row-major, so the samples of neighbouring voices lie n
//     floats apart. The warp stages a tile of 32 voices x kTile samples in
//     shared memory with copies that run along time (cp.async, the next tile
//     in flight while this one is computed), each thread walks its own row
//     of the tile and writes its output over its input there, and the warp
//     stores the tile back along time.
//   - The copies are 16 bytes a lane: one instruction moves a voice's whole
//     tile (a float at a time they took 3.5x the filter's own time). That
//     needs every row to start on 16 bytes, so n % 4 == 0 (the renderer's
//     chunks are multiples of 512); another n is refused.
//   - The thread takes kBatch samples of its row into registers with 16-byte
//     loads, steps them, and writes them back, so the shared-memory traffic
//     and the cutoff selects of a batch overlap the chain of the one before.
//     Rows are kTile + 4 floats apart: the 16-byte accesses of a quarter
//     warp, a row a lane, then fall on all 32 banks.
//   - Activity is a select, not a branch (the lanes of a warp differ).
//   - The current time tile's slots (boundary frames and cutoffs) stay in
//     registers, re-read from the tables only when k changes, every n / nt
//     samples. A tile has at most kRegSlots of them (poly_echo has 2-3);
//     more are refused (svf_table.cu takes any number).
//
// A tile is read whole before it is written and the tile in flight is
// another one, so out may be x itself (the TPU kernel aliases them too: the
// extra [V, n] buffer is what breaks memory at 16384 voices).
//
// None of the TPU version's relayouts is needed: no voice-major copy of x,
// no transposed tables, no padding of V, no gate-encoded activity slot; any
// V, any nt, any n that nt and 4 divide. No TMA (a 2-D tensor copy with the 128-byte
// swizzle would take the copies off the warp altogether), no wgmma.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "svf_scan.cuh"
#include "svf_table_cut.cuh"

namespace {

constexpr int kWarp = 32;          // voices a block, a thread each
constexpr int kTile = 4 * kWarp;   // samples of each voice staged at a time: a lane
                                   // copies 16 bytes, a warp one voice's tile
constexpr int kPitch = kTile + 4;  // rows start on 16 bytes, and the 16-byte accesses
                                   // of a quarter warp, a row a lane, hit all banks
constexpr int kBatch = 16;         // samples a thread holds in registers; divides kTile
constexpr int kRegSlots = 4;       // most slots a time tile keeps in registers

__device__ __forceinline__ float4& quad(float* p) { return *reinterpret_cast<float4*>(p); }

// Start the copy of tile t (samples [t * kTile, ...) of `rows` voices from
// row vb) into buf, along time; one commit group a tile. Every row of x
// starts on 16 bytes (n % 4 == 0), so a lane copies 4 floats and a warp a
// voice's whole tile in one instruction.
__device__ __forceinline__ void load_tile(float (*buf)[kPitch], const float* x, int vb,
                                          int rows, int n, int t, int lane) {
  const int c = 4 * lane;
  if (t * kTile + c < n) {
    const float* src = x + static_cast<size_t>(vb) * n + t * kTile + c;
#pragma unroll 8
    for (int r = 0; r < rows; ++r, src += n) {
      __pipeline_memcpy_async(&buf[r][c], src, sizeof(float4));
    }
  }
  __pipeline_commit();
}

// Write the first len samples (a multiple of 4) of tile t back, along time.
__device__ __forceinline__ void store_tile(float (*buf)[kPitch], float* out, int vb,
                                           int rows, int n, int t, int len, int lane) {
  const int c = 4 * lane;
  if (c < len) {
    float* dst = out + static_cast<size_t>(vb) * n + t * kTile + c;
#pragma unroll 8
    for (int r = 0; r < rows; ++r, dst += n) quad(dst) = quad(&buf[r][c]);
  }
}

// x and out are not __restrict__: they may be the same buffer.
// kS: the slots of a time tile, held in registers.
template <int kS>
__global__ void __launch_bounds__(kWarp)
svf_onepass_kernel(const float* x, const int32_t* __restrict__ tb,
                   const float* __restrict__ cv, const int32_t* __restrict__ af,
                   const float* __restrict__ l0, const float* __restrict__ b0,
                   float* out, float* __restrict__ l_end, float* __restrict__ b_end,
                   int V, int n, int nt, int t0, float res, float lm, float bm, float hm) {
  __shared__ __align__(16) float xs[2][kWarp][kPitch];

  const int lane = threadIdx.x;
  const int vb = blockIdx.x * kWarp;
  const int rows = min(kWarp, V - vb);
  const int v = vb + lane;
  const bool mine = lane < rows;  // this thread has a voice
  const int tile_len = n / nt;
  const int n_tiles = (n + kTile - 1) / kTile;

  float l = mine ? l0[v] : 0.f;
  float b = mine ? b0[v] : 0.f;
  const int first = mine ? af[v] : 0;
  int32_t slot_tb[kS];  // the current time tile's boundary frames
  float slot_cv[kS];    // and cutoffs
  int next_k = 0;  // the sample at which the next time tile's slots are due

  // one sample at absolute frame t: advances (l, b), returns the output
  auto sample = [&](float xin, int t) {
    float nl = l, nb = b;
    const float cut = zt_svf::table_cut(slot_tb, slot_cv, kS, t);
    const float h = zt_svf::step(nl, nb, xin, cut, res);
    const bool on = t >= first;  // selects, not a branch: the warp's lanes differ
    l = on ? nl : l;
    b = on ? nb : b;
    return on ? nl * lm + nb * bm + h * hm : 0.f;
  };

  load_tile(xs[0], x, vb, rows, n, 0, lane);
  for (int t = 0; t < n_tiles; ++t) {
    float (*buf)[kPitch] = xs[t & 1];
    if (t + 1 < n_tiles) {
      load_tile(xs[(t + 1) & 1], x, vb, rows, n, t + 1, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();  // every lane's part of tile t has landed

    const int i0 = t * kTile;
    const int len = min(kTile, n - i0);
    if (mine) {
      float* row = buf[lane];
      int i = 0;
      while (i < len) {
        const int s = i0 + i;
        if (s == next_k) {  // the same for every lane
          const size_t at = (static_cast<size_t>(v) * nt + s / tile_len) * kS;
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            slot_tb[j] = tb[at + j];
            slot_cv[j] = cv[at + j];
          }
          next_k += tile_len;
        }
        if ((i & 3) == 0 && min(len - i, next_k - s) >= kBatch) {
          float r[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; u += 4) {
            const float4 q = quad(row + i + u);
            r[u] = q.x, r[u + 1] = q.y, r[u + 2] = q.z, r[u + 3] = q.w;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) r[u] = sample(r[u], t0 + s + u);
#pragma unroll
          for (int u = 0; u < kBatch; u += 4) {
            quad(row + i + u) = make_float4(r[u], r[u + 1], r[u + 2], r[u + 3]);
          }
          i += kBatch;
        } else {  // a ragged end, or a time tile that ends inside the batch: by samples
          row[i] = sample(row[i], t0 + s);
          ++i;
        }
      }
    }
    __syncwarp();  // the tile holds the output now

    store_tile(buf, out, vb, rows, n, t, len, lane);
    __syncwarp();  // read out before tile t + 2 is copied over it
  }
  if (mine) {
    l_end[v] = l;
    b_end[v] = b;
  }
}

}  // namespace

// C interface, loaded with ctypes (zang_tpu_torch/ops/svf_cuda.py). All
// arrays are contiguous device memory on 16 bytes: x, out [V, n] (out is x
// or apart from it); tb, cv [V, nt, S]; af, l0, b0, l_end, b_end [V].
// n % nt == 0, n % 4 == 0, 1 <= S <= kRegSlots. Returns the launch's
// cudaError_t (0 = launched); another shape is refused as an invalid value.
extern "C" int zt_svf_onepass(const float* x, const int32_t* tb, const float* cv,
                              const int32_t* af, const float* l0, const float* b0,
                              float* out, float* l_end, float* b_end, int V, int n,
                              int nt, int S, int t0, float res, float lm, float bm,
                              float hm, void* stream) {
  const int blocks = (V + kWarp - 1) / kWarp;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n % 4 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define ZT_LAUNCH(kS)                                          \
  svf_onepass_kernel<kS><<<blocks, kWarp, 0, st>>>(            \
      x, tb, cv, af, l0, b0, out, l_end, b_end, V, n, nt, t0, res, lm, bm, hm)
  static_assert(kRegSlots == 4, "one case a slot count");
  switch (S) {
    case 1: ZT_LAUNCH(1); break;
    case 2: ZT_LAUNCH(2); break;
    case 3: ZT_LAUNCH(3); break;
    case 4: ZT_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ZT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
