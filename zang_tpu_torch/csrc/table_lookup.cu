// Sample-table lookups for the sampler's taps, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zang_tpu/ops/pallas_lookup.py (_lookup_kernel,
// driven by _lookup_call) and, for the sampler, the index wrap its caller
// zang_tpu/ops/sampler.py _pallas_taps does around it. On the TPU a gather
// is slow, so that kernel kept the table in VMEM as a [128, Hp] matrix and
// selected each sample with a one-hot MXU matmul plus a lane reduce. Hopper
// gathers natively: the table is read through the read-only (texture) path.
// The sampler's table (35,280 f32, 141 KB) and a table of 262,144 f32
// (1 MiB) both stay in the 50 MB L2, so the loads that miss L1 still hit L2.
//
// Three entries:
//
//   zt_table_lookup  one tap, kSel: out[i] = sel[i] * table[idx[i]], and
//                    sel * 0 for an index outside [0, n_table) (the one-hot
//                    selects nothing for it on the TPU): the TPU kernel's
//                    own function
//   zt_sampler_taps  both of the sampler's taps of a chunk in one launch;
//                    the wrap is done here, as _pallas_taps does it:
//                      kLoop  table[idx mod N], the remainder taken with the
//                             divisor's sign (torch.remainder): in [0, N)
//                             for the negative indices of reverse play
//                      kClip  sel * table[clip(idx, 0, N - 1)] with
//                             sel = 1 inside [0, N), 0 outside
//   zt_sampler_play  the sampler's whole chunk: its caller folded in. The
//                    tiled chunk program is evaluated (ops/segprog.py
//                    eval_tiled_chunk), the playback position formed, both
//                    taps read with the wrap above and the reference's
//                    inverted lerp applied (ops/sampler.py eval_sampler):
//                    out [V, n] straight from the program's slots
//
// Bound on this card: bytes, and at the sampler's shape (a chunk of 65,536
// frames) far below a launch: the two taps move 0.6 MB (0.2 us at 3.35 TB/s)
// and the whole chunk's program, frames and output about as much. So the
// design puts work into each launch. zt_sampler_taps took the two taps into
// one launch; zt_sampler_play takes the chunk: about 30 eager torch ops a
// chunk (the slot selects, the position, the casts, the wrap, the lerp and
// the mode selects, each a launch of ~6 us of host) become one. The two
// gather entries take four indices a thread with 16-byte loads and stores
// (int4, float4); a thread of the last quad takes what is left a float at a
// time, and pointers that are not on 16 bytes take that scalar path
// throughout.
//
// zt_sampler_play's layout: a block of 128 threads takes one voice and a run
// of tiles (one tile unless there are many voices), puts the run's slots
// (tb, t0, mode, seg_start: 16 bytes a slot, S a tile) in shared memory and
// walks the run's frames four to a thread, the frames and the output moving
// as int4 / float4 where they lie on 16 bytes. A tile of 512 frames is one
// quad a thread, and the sampler's chunk of 128 tiles is 128 blocks on the
// 132 SMs. The table is not staged: a tile's playback indices are
// consecutive, so the reads through __ldg coalesce and hit L2, and a copy
// of 141 KB a block would cost more L2 traffic than the whole output.
//
// Exactness. The gather entries' only arithmetic is the product with sel (1
// for a looped tap), so they equal the plain versions in ops/lookup.py bit
// for bit. zt_sampler_play repeats eval_sampler's eager ops in their order,
// each rounded to f32 as torch rounds it: the int32 differences wrap, the
// f32 products and sums are the _rn intrinsics (never contracted into a
// fused multiply-add, whatever the flags), the casts truncate toward zero;
// a frame reads only the taps its mode needs, which gives the values of the
// plain version's selects (mode 1 lerps two taps, mode 2 copies one, any
// other mode is +0).
//
// Plain C interface, loaded with ctypes (ops/_build.py). The launch goes
// on the caller's stream of the caller's device (made current for the
// launch, the caller's current device restored after it); the return value
// is cudaGetLastError().

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // a few waves of the 132 SMs; the
                                           // loop is grid-strided

enum Mode { kSel, kLoop, kClip };

__host__ __device__ __forceinline__ bool on16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One index: the tap's value, times sel (kSel reads it, kClip computes it).
template <int kMode>
__device__ __forceinline__ float tap(int32_t k, float sel, const float* __restrict__ table,
                                     int32_t n) {
  if (kMode == kLoop) {
    int32_t r = k % n;  // C's remainder takes the dividend's sign
    if (r < 0) r += n;
    return __ldg(table + r);
  }
  if (kMode == kClip) {
    const float s = (k >= 0 && k < n) ? 1.0f : 0.0f;
    return s * __ldg(table + min(max(k, 0), n - 1));
  }
  return sel * ((k >= 0 && k < n) ? __ldg(table + k) : 0.0f);
}

// kTaps index arrays idx[t] -> out[t], count indices each; sel only for kSel.
// quads: count / 4 when every pointer is on 16 bytes, else 0.
template <int kTaps, int kMode>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int32_t* __restrict__ idx0, const int32_t* __restrict__ idx1,
              const float* __restrict__ sel, const float* __restrict__ table,
              float* __restrict__ out0, float* __restrict__ out1, long long count,
              long long quads, int32_t n) {
  const int32_t* idx[2] = {idx0, idx1};
  float* out[2] = {out0, out1};
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long q = first; q < quads; q += stride) {
    const float4 s = kMode == kSel ? __ldg(reinterpret_cast<const float4*>(sel) + q)
                                   : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(idx[t]) + q);
      reinterpret_cast<float4*>(out[t])[q] =
          make_float4(tap<kMode>(k.x, s.x, table, n), tap<kMode>(k.y, s.y, table, n),
                      tap<kMode>(k.z, s.z, table, n), tap<kMode>(k.w, s.w, table, n));
    }
  }
  for (long long i = 4 * quads + first; i < count; i += stride) {
    const float s = kMode == kSel ? sel[i] : 1.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) out[t][i] = tap<kMode>(idx[t][i], s, table, n);
  }
}

constexpr int kPlayThreads = 128;
constexpr int kPlaySmemBytes = 48 * 1024;  // the static limit a block can use
constexpr int kPlayBlocksPerSm = 8;         // runs get longer past this many blocks

// One frame of the sampler: the slot its tile's program gives frame t
// (s_* hold the tile's S slots), then eval_sampler's arithmetic.
template <int kMode>
__device__ __forceinline__ float play(int32_t t, const int32_t* __restrict__ s_tb,
                                      const float* __restrict__ s_t0,
                                      const int32_t* __restrict__ s_mode,
                                      const int32_t* __restrict__ s_ss, int S, float ratio,
                                      const float* __restrict__ table, int32_t n) {
  int j = 0;  // the last slot, in slot order, with t >= tb[slot]; slot 0 holds -2^31
  for (int k = 1; k < S; ++k)
    if (t >= s_tb[k]) j = k;
  const int32_t mode = s_mode[j];
  if (mode != 1 && mode != 2) return 0.0f;
  const float t0 = s_t0[j];
  // dt = float(t - seg_start), the difference wrapping as int32 does
  const float dt = __int2float_rn((int32_t)((uint32_t)t - (uint32_t)s_ss[j]));
  if (mode == 2) {  // the copy fast path: tap(int(t0) + int(dt))
    const int32_t ifast =
        (int32_t)((uint32_t)__float2int_rz(t0) + (uint32_t)__float2int_rz(dt));
    return tap<kMode>(ifast, 1.0f, table, n);
  }
  // resample: t = t0 + dt * ratio, two roundings, then the inverted lerp
  const float pos = __fadd_rn(t0, __fmul_rn(dt, ratio));
  const int32_t it0 = __float2int_rz(floorf(pos));
  const int32_t it1 = (int32_t)((uint32_t)it0 + 1u);
  const float tfrac = __fsub_rn(__int2float_rn(it1), pos);
  const float a = tap<kMode>(it0, 1.0f, table, n);
  const float b = tap<kMode>(it1, 1.0f, table, n);
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, tfrac)), __fmul_rn(b, tfrac));
}

// Block b: voice b / runs, tiles [r * tpb, r * tpb + tpb) of it (r = b % runs).
template <int kMode>
__global__ void __launch_bounds__(kPlayThreads)
sampler_play_kernel(const int32_t* __restrict__ tb, const float* __restrict__ t0,
                    const int32_t* __restrict__ mode, const int32_t* __restrict__ seg_start,
                    const int32_t* __restrict__ t_idx, const float* __restrict__ table,
                    float* __restrict__ out, int nt, int S, int tile, int runs, int tpb,
                    int32_t n_table, float ratio) {
  extern __shared__ int32_t slots[];  // tb, t0, mode, seg_start: tpb * S each
  int32_t* s_tb = slots;
  float* s_t0 = reinterpret_cast<float*>(slots + tpb * S);
  int32_t* s_mode = slots + 2 * tpb * S;
  int32_t* s_ss = slots + 3 * tpb * S;
  const long long v = blockIdx.x / runs;
  const int k0 = (blockIdx.x % runs) * tpb;
  const int k1 = min(nt, k0 + tpb);
  const long long base = (v * nt + k0) * (long long)S;
  for (int i = threadIdx.x; i < (k1 - k0) * S; i += kPlayThreads) {
    s_tb[i] = __ldg(tb + base + i);
    s_t0[i] = __ldg(t0 + base + i);
    s_mode[i] = __ldg(mode + base + i);
    s_ss[i] = __ldg(seg_start + base + i);
  }
  __syncthreads();
  const long long n = (long long)nt * tile;
  const int frames = (k1 - k0) * tile;  // the run's frames, from frame k0 * tile
  const int32_t* tr = t_idx + (long long)k0 * tile;
  float* row = out + v * n + (long long)k0 * tile;
  const bool vec = on16(tr) && on16(row);
  for (int i = 4 * threadIdx.x; i < frames; i += 4 * kPlayThreads) {
    if (vec && i + 4 <= frames) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(tr + i));
      const int ts[4] = {t.x, t.y, t.z, t.w};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = ((i + q) / tile) * S;
        o[q] = play<kMode>(ts[q], s_tb + s, s_t0 + s, s_mode + s, s_ss + s, S, ratio, table,
                           n_table);
      }
      *reinterpret_cast<float4*>(row + i) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int f = i; f < min(i + 4, frames); ++f) {
        const int s = (f / tile) * S;
        row[f] = play<kMode>(__ldg(tr + f), s_tb + s, s_t0 + s, s_mode + s, s_ss + s, S,
                             ratio, table, n_table);
      }
    }
  }
}

// Runs launch() with `device` current, then makes the caller's current again.
template <typename F>
int on_device(int device, F launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int r = launch();
  if (prev != device) cudaSetDevice(prev);
  return r;
}

template <int kTaps, int kMode>
int launch(const void* idx0, const void* idx1, const void* sel, const void* table,
           void* out0, void* out1, long long count, int n_table, bool vec, void* stream) {
  if (count <= 0) return 0;
  const long long quads = vec ? count / 4 : 0;
  long long blocks = ((vec ? quads : count) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lookup_kernel<kTaps, kMode><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx0, (const int32_t*)idx1, (const float*)sel, (const float*)table,
      (float*)out0, (float*)out1, count, quads, (int32_t)n_table);
  return (int)cudaGetLastError();
}

// Tiles a block: one, unless the voices' tiles outnumber kPlayBlocksPerSm
// blocks on each of the 132 SMs; never more than the shared memory holds.
template <int kMode>
int launch_play(const void* tb, const void* t0, const void* mode, const void* seg_start,
                const void* t_idx, const void* table, void* out, int V, int nt, int S,
                int tile, int n_table, float ratio, void* stream) {
  const long long tiles = (long long)V * nt;
  long long tpb = tiles / (132LL * kPlayBlocksPerSm);
  const long long fit = kPlaySmemBytes / (16LL * S);
  if (tpb > fit) tpb = fit;
  if (tpb > nt) tpb = nt;
  if (tpb < 1) tpb = 1;
  const long long runs = (nt + tpb - 1) / tpb;
  const long long blocks = V * runs;
  const size_t smem = (size_t)(16LL * S * tpb);
  if (blocks > 0x7fffffffLL || smem > (size_t)kPlaySmemBytes) return (int)cudaErrorInvalidValue;
  sampler_play_kernel<kMode><<<(unsigned)blocks, kPlayThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tb, (const float*)t0, (const int32_t*)mode, (const int32_t*)seg_start,
      (const int32_t*)t_idx, (const float*)table, (float*)out, nt, S, tile, (int)runs,
      (int)tpb, (int32_t)n_table, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// out = sel * table[idx], 0 * sel outside [0, n_table); idx int32, sel and
// out f32, count elements each; table f32 [n_table].
extern "C" int zt_table_lookup(const void* idx, const void* sel, const void* table,
                               void* out, long long count, int n_table, int device,
                               void* stream) {
  const bool vec = on16(idx) && on16(sel) && on16(out);
  return on_device(device, [&] {
    return launch<1, kSel>(idx, nullptr, sel, table, out, nullptr, count, n_table, vec,
                           stream);
  });
}

// The sampler's two taps of a chunk: out [2, count] gets tap a's values in
// its first row, tap b's in its second; loop != 0 wraps the indices, else
// they are clipped with sel (see the modes above). table f32 [n_table].
extern "C" int zt_sampler_taps(const void* idx_a, const void* idx_b, const void* table,
                               void* out, long long count, int n_table, int loop,
                               int device, void* stream) {
  float* out_b = (float*)out + count;
  const bool vec = on16(idx_a) && on16(idx_b) && on16(out) && on16(out_b);
  return on_device(device, [&] {
    return loop ? launch<2, kLoop>(idx_a, idx_b, nullptr, table, out, out_b, count,
                                   n_table, vec, stream)
                : launch<2, kClip>(idx_a, idx_b, nullptr, table, out, out_b, count,
                                   n_table, vec, stream);
  });
}

// The sampler's chunk: out [V, n] f32 from its tiled program (tb, mode,
// seg_start int32 and t0 f32, each [V, nt, S]), the chunk's frames t_idx
// int32 [n] (n = nt * tile), the table f32 [n_table] and the playback ratio;
// loop != 0 wraps the taps' indices, else they are clipped (see the modes).
extern "C" int zt_sampler_play(const void* tb, const void* t0, const void* mode,
                               const void* seg_start, const void* t_idx, const void* table,
                               void* out, int V, int nt, int S, long long n, int n_table,
                               float ratio, int loop, int device, void* stream) {
  if (V <= 0 || n <= 0) return 0;
  if (nt <= 0 || S <= 0 || n % nt != 0 || n / nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tile = (int)(n / nt);
  return on_device(device, [&] {
    return loop ? launch_play<kLoop>(tb, t0, mode, seg_start, t_idx, table, out, V, nt, S,
                                     tile, n_table, ratio, stream)
                : launch_play<kClip>(tb, t0, mode, seg_start, t_idx, table, out, V, nt, S,
                                     tile, n_table, ratio, stream);
  });
}
