// Tile windows: one chunk's tiled slice of a segment program, cut on the card
// from the program's [V, K] tables, hand-written for Hopper (sm_90a).
//
// No TPU kernel: the JAX package slices every chunk of the piece on the host
// before its scan (zang_tpu/ops/segprog.py chunkify_tiled), and the port did
// the same until the host's slicing became the largest cost in front of a
// chunk step replayed as one CUDA graph. A slice repeats S values of the
// segment covering each 512-frame tile, so the host built and copied tens of
// times the bytes of the tables it came from. Here the tables stay on the
// card and each chunk's step cuts its own slice (ops/tile_windows.py is the
// contract and the plain version it is held to bit for bit).
//
// A warp takes a voice and a run of up to 32 of the chunk's tiles (frames
// [a, b)), a lane a tile (ts = a + lane * tile). A search a thread in the
// voice's whole row of starts is a chain of log2(K) dependent loads (three
// such chains cost the Toccata's organ, K = 1,493, 9.2 us a launch), so the
// warp first finds, together, the segments that start at or before a, those
// that start before b and those that start before total (cap), each a
// 32-way search of a few rounds, the three in step; each lane then searches
// only the starts between the first two (a few, in L1) for its tile's first
// and last segment, and writes the S slots of "tb" and of every value as
// raw elements of 1, 2, 4 or 8 bytes (a u32 value rides an int64, an f32 is
// its bits): nothing is computed on a value, so the slice is the host's bit
// for bit.
//
// Bound on this card: the bytes written (the 4,096-voice texture's two
// programs about 65 MB a chunk, 19 us at 3.35 TB/s; the Toccata's four
// 0.27 MB, below a launch), against the host's numpy gathers of the same
// bytes for the whole piece and a copy of each chunk's share.
//
// c0 is an argument, or read from the card (c0p, an int32 [1]: a captured
// graph's chunk, whose packed upload carries it). Up to kMaxValues values
// ride a launch's parameters; more take further launches that write values
// alone.
//
// Plain C interface, loaded with ctypes (ops/_build.py). The launch goes on
// the caller's stream of the caller's device (made current for the launch,
// the caller's current device restored after it); the return value is
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxValues = 32;

struct Values {
  const void* src[kMaxValues];  // [V, K]
  void* dst[kMaxValues];        // [V, nt, S]
  int size[kMaxValues];         // bytes an element: 1, 2, 4 or 8
  int n;
};

constexpr unsigned kFull = 0xffffffffu;

// One search: the first k in [lo, hi) with row[k] >= x (> x when after),
// else hi.
struct Search {
  int lo, hi;
  long long x;
  bool after;
};

// kN searches, the warp's lanes probing 32 evenly spaced starts of each
// range a round, the kN rounds' loads in flight together; every lane gets
// every answer in q[n].lo. Called by whole warps.
template <int kN>
__device__ __forceinline__ void warp_search(const int32_t* __restrict__ row, Search (&q)[kN],
                                            int lane) {
  for (;;) {
    bool below[kN];
    int step[kN];
    bool open = false;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      step[n] = (q[n].hi - q[n].lo + 31) >> 5;
      const int p = q[n].lo + lane * step[n];
      below[n] = false;
      if (p < q[n].hi) {
        const long long s = row[p];
        below[n] = q[n].after ? s <= q[n].x : s < q[n].x;
      }
      open |= q[n].lo < q[n].hi;
    }
    if (!open) return;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      // the lanes below x are a prefix: the answer lies past the last of them
      const int c = __popc(__ballot_sync(kFull, below[n]));
      if (q[n].lo >= q[n].hi) continue;
      if (c == 0) {
        q[n].hi = q[n].lo;
      } else {
        const int lo = q[n].lo + (c - 1) * step[n] + 1;
        q[n].hi = min(q[n].lo + c * step[n], q[n].hi);
        q[n].lo = lo;
      }
    }
  }
}

// One lane's search: the first k in [lo, hi) with row[k] >= x (> x when
// kAfter), else hi.
template <bool kAfter>
__device__ __forceinline__ int lane_search(const int32_t* __restrict__ row, int lo, int hi,
                                           long long x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long s = row[mid];
    if (kAfter ? s <= x : s < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ void copy_slots(const void* src, void* dst, long long row,
                                           long long out, int first, int last, int K,
                                           int S) {
  const T* s = static_cast<const T*>(src) + row;
  T* d = static_cast<T*>(dst) + out;
  for (int j = 0; j < S; ++j) {
    const int k = min(max(min(first + j, last - 1), 0), K - 1);
    d[j] = s[k];
  }
}

__global__ void __launch_bounds__(kThreads)
windows_kernel(const int32_t* __restrict__ starts, int V, int K, int c0,
               const int32_t* __restrict__ c0p, int total, int nt, int tile, int S,
               int32_t* __restrict__ tb, Values vals) {
  const int runs = (nt + 31) >> 5;
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (w >= (long long)V * runs) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int v = (int)(w / runs);
  const int i0 = (int)(w % runs) << 5;
  const int32_t* row = starts + (long long)v * K;
  const long long a = (long long)(c0p != nullptr ? *c0p : c0) + (long long)i0 * tile;
  const long long b = a + (long long)min(32, nt - i0) * tile;
  Search q[3] = {{0, K, a, true}, {0, K, b, false}, {0, K, total, false}};
  warp_search(row, q, lane);
  const int u = q[0].lo, e = q[1].lo, cap = max(q[2].lo, 1);
  const int i = i0 + lane;
  if (i >= nt) return;
  const long long ts = a + (long long)lane * tile;
  // the starts at or before ts, and before ts + tile, both lie in [u, e]
  const int first = max(lane_search<true>(row, u, e, ts) - 1, 0);
  const int last = min(lane_search<false>(row, u, e, ts + tile), cap);
  const long long out = ((long long)v * nt + i) * S;
  if (tb != nullptr) {
    tb[out] = INT32_MIN;  // slot 0 covers the tile's start
    for (int j = 1; j < S; ++j) {
      const int k = first + j;
      tb[out + j] = k < last ? row[k] : total + 1;
    }
  }
  const long long r = (long long)v * K;
  for (int n = 0; n < vals.n; ++n) {
    switch (vals.size[n]) {
      case 1: copy_slots<uint8_t>(vals.src[n], vals.dst[n], r, out, first, last, K, S); break;
      case 2: copy_slots<uint16_t>(vals.src[n], vals.dst[n], r, out, first, last, K, S); break;
      case 4: copy_slots<uint32_t>(vals.src[n], vals.dst[n], r, out, first, last, K, S); break;
      default: copy_slots<uint64_t>(vals.src[n], vals.dst[n], r, out, first, last, K, S);
    }
  }
}

}  // namespace

// One chunk's slice: tb int32 [V, nt, S] and dsts[n] [V, nt, S] from starts
// int32 [V, K] and srcs[n] [V, K] (sizes[n] bytes an element), for the chunk
// whose first frame is c0, or *c0p when c0p is not null.
extern "C" int zt_tile_windows(const void* starts, int V, int K, int c0, const void* c0p,
                               int total, int nt, int tile, int S, void* tb, int n_values,
                               const void* const* srcs, void* const* dsts, const int* sizes,
                               int device, void* stream) {
  if (V <= 0 || nt <= 0) return 0;
  if (K <= 0 || tile <= 0 || S <= 0 || n_values < 0) return (int)cudaErrorInvalidValue;
  for (int n = 0; n < n_values; ++n) {
    if (sizes[n] != 1 && sizes[n] != 2 && sizes[n] != 4 && sizes[n] != 8)
      return (int)cudaErrorInvalidValue;
  }
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)V * ((nt + 31) / 32) * 32;  // a warp a run
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  int done = 0;
  do {  // a launch for tb and the first kMaxValues values, then the rest
    Values vals;
    vals.n = min(n_values - done, kMaxValues);
    for (int n = 0; n < vals.n; ++n) {
      vals.src[n] = srcs[done + n];
      vals.dst[n] = dsts[done + n];
      vals.size[n] = sizes[done + n];
    }
    windows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)starts, V, K, c0, (const int32_t*)c0p, total, nt, tile, S,
        done == 0 ? (int32_t*)tb : nullptr, vals);
    done += vals.n;
  } while (done < n_values);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
