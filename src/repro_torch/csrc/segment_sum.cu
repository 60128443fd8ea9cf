// K7 segment_sum: out[s, c] = sum of data[r, c] over the rows r with
// seg[r] == s, for sorted segment ids.
//
// Replaces the TPU kernel src/repro/kernels/segment/seg_matmul.py
// (segment_sum_pallas), a one-hot matrix product that streams every data
// block once per output tile. The port's caller is the grid repulsion's
// cell statistics (kernels/grid/ops.py cell_stats): E = n nodes, D = 3
// columns [m x, m y, m], N = G^2 cells, ids already in cell-sorted order.
//
// Hopper design: deterministic, no float atomics. Sorted ids make each
// segment a contiguous row range, found by two binary searches (lower
// bounds of s and s + 1), so negative ids (which sort first) and ids
// >= N (the trash tail, which sorts last) fall outside every range and are
// dropped. One thread per (segment, column) adds its rows in row order,
// one round-to-nearest add per row: the order, and so the bits, of a
// sequential index_add_ into zeros. Two launches on the same input give
// the same bits. Unsorted ids are stably sorted by the wrapper first,
// which keeps each segment's rows in their original order.
//
// Bound: bytes. Each row's D floats and its id are read once and each
// output written once: E (4 D + 4) + 4 N D bytes. A segment far larger
// than the rest (one dense cell) serialises on its thread; that is the
// kernel's weak case and the first thing to split (a fixed-order warp
// reduction per segment) when it shows.
#include <cuda_runtime.h>

namespace {

__device__ long long lower_bound(const int* __restrict__ seg, long long e, int key) {
  long long lo = 0, hi = e;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (seg[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void segment_sum_kernel(const float* __restrict__ data,
                                   const int* __restrict__ seg, long long e,
                                   int d, int n_segments, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_segments * d) return;
  const int s = (int)(t / d);
  const int c = (int)(t % d);
  const long long lo = lower_bound(seg, e, s);
  const long long hi = lower_bound(seg, e, s + 1);
  float acc = 0.f;
  for (long long r = lo; r < hi; ++r) acc = __fadd_rn(acc, data[r * d + c]);
  out[t] = acc;
}

}  // namespace

extern "C" int segment_sum(const void* data, const void* seg, long long e, int d,
                           int n_segments, void* out, void* stream) {
  const long long total = (long long)n_segments * d;
  if (total > 0) {
    const int threads = 128;
    const long long blocks = (total + threads - 1) / threads;
    segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)seg, e, d, n_segments, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
