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
// One kernel body, lookup_kernel<kTaps, kMode>, serves two entries:
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
//
// Bound on this card: bytes, and at the sampler's shape (2 x 65,536
// indices) the host: the device time is a couple of microseconds, under
// the wrapper's own cost, so one launch a chunk in place of two launches
// and ten small torch ops is the gain. Each thread takes four indices of
// each tap with 16-byte loads and stores (int4, float4); a thread of the
// last quad takes what is left a float at a time, and pointers that are not
// on 16 bytes take that scalar path throughout.
//
// Exactness: the only arithmetic is the product with sel (1 for a looped
// tap), so the result equals the plain versions in ops/lookup.py bit for bit.
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

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
