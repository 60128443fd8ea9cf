// K1 merge_scatter: the scatter-combine step of superedge aggregation.
//
// Replaces the TPU kernel src/repro/kernels/merge/sorted_merge.py
// (scatter_combine_pallas). Rows of the sorted superedge state and of the
// deduped chunk run arrive with their merge-path ranks `pos` (computed by
// torch searchsorted/cumsum in kernels/merge/ref.py). Each row with
// 0 <= pos < cap lands in output slot pos: keys combine by max, weights by +.
// The wrapper pre-fills keys with -1 and weights with 0, so unhit slots read
// back as padding.
//
// The TPU kernel band-skips output tiles because a TPU scatters poorly and
// so needs sorted inputs. Hopper has atomics: one thread per input row, one
// atomicMax per key and one atomicAdd per weight; sortedness is not used.
// Every slot is hit by at most one state row and one equal-key chunk row,
// and float addition of two values commutes, so the result is bitwise equal
// to the plain version whatever order the atomics land in.
//
// Bound: bytes. It reads 16 bytes per input row and writes 12 per output
// slot, with one add per row; memory bandwidth is the limit.
#include <cuda_runtime.h>

namespace {

__global__ void merge_scatter_kernel(const int* __restrict__ pos,
                                     const int* __restrict__ a,
                                     const int* __restrict__ b,
                                     const float* __restrict__ w,
                                     long long n, int cap,
                                     int* __restrict__ oa,
                                     int* __restrict__ ob,
                                     float* __restrict__ ow) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int p = pos[i];
  if (p < 0 || p >= cap) return;  // sentinel and overflow rows are dropped
  atomicMax(oa + p, a[i]);
  atomicMax(ob + p, b[i]);
  atomicAdd(ow + p, w[i]);
}

}  // namespace

extern "C" int merge_scatter(const void* pos, const void* a, const void* b,
                             const void* w, long long n, int cap, void* oa,
                             void* ob, void* ow, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    merge_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const int*)a, (const int*)b, (const float*)w, n, cap,
        (int*)oa, (int*)ob, (float*)ow);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* merge_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
