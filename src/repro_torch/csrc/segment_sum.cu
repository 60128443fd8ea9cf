// K7 segment_sum: out[s, c] = sum of data[r, c] over the rows r with
// seg[r] == s, for sorted segment ids.
//
// Replaces the TPU kernel src/repro/kernels/segment/seg_matmul.py
// (segment_sum_pallas), a one-hot matrix product that streams every data
// block once per output tile. The port's caller is the grid repulsion's
// cell statistics (kernels/grid/ops.py cell_stats): E = n nodes, D = 3
// columns [m x, m y, m], N = G^2 cells, ids already in cell-sorted order.
//
// Why the sum is not a tree: the plain version (kernels/segment/ref.py) is
// an index_add_ that, on the CPU, adds each row into its segment in row
// order, one rounding per row. The kernel must give those bits, so every
// (segment, column) sum is the same chain of round-to-nearest adds, from
// +0, in row order. A tree, a warp shuffle reduction or float atomics
// would add in another order and round differently. Two launches on the
// same input give the same bits.
//
// Bound: bytes on paper (each row's D floats and its id read once, each
// output written once: E (4 D + 4) + 4 N D bytes), latency in practice:
// the largest segment's chain of dependent adds (1,225 rows in the full
// layout's densest cell) sets the kernel's time. The design keeps that
// chain fed from shared memory and spreads every other segment over the
// card:
//   - One warp per segment, WARPS segments a block: N / WARPS blocks, so
//     no segment waits behind another's chain.
//   - The warp finds its segment's bounds once, lanes 0-15 the lower bound
//     of s and lanes 16-31 that of s + 1, each a 16-way search over the
//     sorted ids (five steps of one load per lane at E = 685,230).
//     Negative ids sort first and ids >= N (the trash tail) last, so they
//     fall outside every segment and are dropped.
//   - A segment's rows are one contiguous span of (hi - lo) D floats. The
//     warp copies it into shared memory CHUNK floats at a time with
//     coalesced loads, the next chunk's loads in flight while lane c adds
//     column c (c + 32, ... in further passes when D > 32) over the staged
//     rows of the current one.
//   - The adds are the kernel's critical path: lane c reads its column
//     BATCH rows at a time, the next batch's loads issued before the
//     current batch's adds, so the chain waits only on itself. D = 3, the
//     cell statistics' width, is a compile-time stride (the loads take
//     immediate offsets); any other D takes the same code with a runtime
//     stride.
//   - Empty segments write 0. Unsorted ids are stably sorted by the
//     wrapper first, which keeps each segment's rows in their order.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;               // segments (warps) per block
constexpr int PER_LANE = 32;           // floats a lane stages per chunk
constexpr int BATCH = 16;              // staged floats a lane reads at once
constexpr int CHUNK = 32 * PER_LANE;   // floats staged per chunk and warp
constexpr unsigned ALL = 0xffffffffu;

// Lower bounds of s (returned in .x) and s + 1 (.y) in the sorted ids
// seg[0, e), e < 2^31: lanes 0-15 search for s, lanes 16-31 for s + 1.
// Each step probes lo + l * step (l = 0..15) in [lo, hi) and keeps the gap
// between the last probe below the key and the first at or above it.
__device__ int2 segment_bounds(const int* __restrict__ seg, unsigned e, int s,
                               int lane) {
  const int half = lane >> 4;
  const unsigned mine = half ? 0xffff0000u : 0x0000ffffu;
  const int key = s + half;
  const unsigned l = lane & 15;
  unsigned lo = 0, hi = e;  // lower bound in [lo, hi]
  while (__any_sync(ALL, lo < hi)) {
    const unsigned step = (hi - lo + 15) / 16;
    const unsigned p = lo + l * step;
    const bool probe = lo < hi && p < hi;
    const unsigned below = __ballot_sync(ALL, probe && seg[p] < key) & mine;
    const unsigned probes = __ballot_sync(ALL, probe) & mine;
    if (lo < hi) {
      const unsigned c = __popc(below);
      const unsigned nlo = c == 0 ? lo : lo + (c - 1) * step + 1;
      hi = c < (unsigned)__popc(probes) ? lo + c * step : hi;
      lo = nlo;
    }
  }
  return make_int2((int)__shfl_sync(ALL, lo, 0), (int)__shfl_sync(ALL, lo, 16));
}

// acc + sh[0] + sh[stride] + ... over the n staged elements of one
// column, in order, one round-to-nearest add each. The loads of the next
// BATCH elements are issued before the adds of the current ones, so the
// chain of adds waits on nothing but itself.
template <int D>
__device__ __forceinline__ float add_column(float acc, const float* sh, int n, int d) {
  const int stride = D ? D : d;
  int i = 0;
  if (n >= BATCH) {
    float cur[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) cur[u] = sh[u * stride];
    for (; i + 2 * BATCH <= n; i += BATCH) {
      float next[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) next[u] = sh[(i + BATCH + u) * stride];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        acc = __fadd_rn(acc, cur[u]);
        cur[u] = next[u];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) acc = __fadd_rn(acc, cur[u]);
    i += BATCH;
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, sh[i * stride]);
  return acc;
}

// D > 0: rows of D columns, a compile-time stride; D = 0: any d.
template <int D>
__global__ void __launch_bounds__(32 * WARPS)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                   unsigned e, int d, int n_segments, float* __restrict__ out) {
  __shared__ float staged[WARPS][CHUNK];
  if (D) d = D;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = blockIdx.x * WARPS + w;
  if (s >= n_segments) return;  // warp-uniform: no block barrier below
  const int2 b = segment_bounds(seg, e, s, lane);
  float* sh = staged[w];
  const long long len = (long long)(b.y - b.x) * d;  // floats in the span
  const float* span = data + (long long)b.x * d;
  for (int c0 = 0; c0 < d; c0 += 32) {  // one pass per 32 columns
    const int c = c0 + lane;
    float acc = 0.f;
    float v[PER_LANE];
#pragma unroll
    for (int m = 0; m < PER_LANE; ++m) {
      const long long f = lane + 32 * m;
      v[m] = f < len ? span[f] : 0.f;
    }
    for (long long f0 = 0; f0 < len; f0 += CHUNK) {
      __syncwarp();  // every lane is done with the previous chunk
#pragma unroll
      for (int m = 0; m < PER_LANE; ++m) sh[lane + 32 * m] = v[m];
      __syncwarp();
      const long long f1 = f0 + CHUNK;
      if (f1 < len) {  // the next chunk's loads fly during the adds
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          const long long f = f1 + lane + 32 * m;
          v[m] = f < len ? span[f] : 0.f;
        }
      }
      if (c < d) {
        // Column c's elements in this chunk: the first at or after f0,
        // then every d-th, below the chunk's end.
        const int first = (int)((c - f0 % d + d) % d);
        const int end = (int)(len - f0 < CHUNK ? len - f0 : CHUNK);
        const int count = first < end ? (int)(((long long)end - first + d - 1) / d) : 0;
        acc = add_column<D>(acc, sh + first, count, d);
      }
    }
    if (c < d) out[(long long)s * d + c] = acc;
  }
}

}  // namespace

extern "C" int segment_sum(const void* data, const void* seg, long long e, int d,
                           int n_segments, void* out, void* stream) {
  if (e < 0 || e >= (1LL << 31) || d < 0 || n_segments < 0)
    return (int)cudaErrorInvalidValue;
  if (n_segments > 0 && d > 0) {
    const int blocks = (n_segments + WARPS - 1) / WARPS;
    const auto x = static_cast<const float*>(data);
    const auto ids = static_cast<const int*>(seg);
    const auto o = static_cast<float*>(out);
    if (d == 3) {  // the grid repulsion's cell statistics [m x, m y, m]
      segment_sum_kernel<3><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
          x, ids, (unsigned)e, d, n_segments, o);
    } else {
      segment_sum_kernel<0><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
          x, ids, (unsigned)e, d, n_segments, o);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
