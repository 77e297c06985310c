// Sample-table lookup for the sampler's taps: out[i] = sel[i] * table[idx[i]].
//
// Replaces the TPU kernel zang_tpu/ops/pallas_lookup.py (_lookup_kernel,
// driven by _lookup_call). On the TPU a gather is slow, so that kernel kept
// the table in VMEM as a [128, Hp] matrix and selected each sample with a
// one-hot MXU matmul plus a lane reduce. Hopper gathers natively: one thread
// per index, the table read through the read-only (texture) path. The
// sampler's table (35,280 f32, 141 KB) and the largest one the sampler
// sends here (262,144 f32, 1 MiB) both stay in the 50 MB L2, so the loads
// that miss L1 still hit L2.
//
// Bound on this card: bytes. Per index it reads 4 B of idx, 4 B of sel and
// writes 4 B of out (the table is read once in the bound); there is one
// multiply per index, far below the f32 peak.
//
// Exactness: an index outside [0, n_table) reads nothing and gives
// sel * 0, as the one-hot selects no column for it on the TPU. The only
// arithmetic is the product with sel, so the result equals
// table_lookup_ref (ops/lookup.py) bit for bit.
//
// Plain C interface, loaded with ctypes (ops/_build.py). The launch goes
// on the caller's stream; the return value is cudaGetLastError().

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const int32_t* __restrict__ idx,
                    const float* __restrict__ sel,
                    const float* __restrict__ table,
                    float* __restrict__ out, int64_t count, int32_t n_table) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += stride) {
    const int32_t k = idx[i];
    const float v = (k >= 0 && k < n_table) ? __ldg(table + k) : 0.0f;
    out[i] = sel[i] * v;
  }
}

}  // namespace

extern "C" int zt_table_lookup(const void* idx, const void* sel,
                               const void* table, void* out, long long count,
                               int n_table, void* stream) {
  if (count <= 0) return 0;
  // enough blocks to fill the 132 SMs several times over; a grid-stride
  // loop covers any count
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  table_lookup_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)sel, (const float*)table, (float*)out,
      (int64_t)count, (int32_t)n_table);
  return (int)cudaGetLastError();
}
