// K3 count_scatter: in-place int32 scatter-add into a flat accumulator.
//
// Replaces the TPU kernel src/repro/kernels/raster/splat.py
// (count_scatter_pallas), which the renderer calls for the small-disk node
// pass and for every chunk of the streamed edge splat. Rows with
// 0 <= pos < size add inc (or 1 when inc is null) to acc[pos]; negative
// and out-of-range positions (the INT32_MAX drop marker) are skipped.
//
// The TPU kernel argsorts the positions so each block touches one band of
// output tiles, because a TPU scatters poorly. Hopper has atomics: one
// thread per row, one atomicAdd, no sort. Integer adds are associative and
// commutative, so the result is bitwise equal to the plain version in any
// order.
//
// Bound: bytes. Each row reads 8 bytes (4 with unit increments) and the
// accumulator is read and written once; contention on hot pixels is the
// main cost beyond that.
#include <cuda_runtime.h>

namespace {

__global__ void count_scatter_kernel(const int* __restrict__ pos,
                                     const int* __restrict__ inc,
                                     long long n, long long size,
                                     int* __restrict__ acc) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int p = pos[i];
  if (p < 0 || (long long)p >= size) return;
  atomicAdd(acc + p, inc != nullptr ? inc[i] : 1);
}

}  // namespace

extern "C" int count_scatter(const void* pos, const void* inc, long long n,
                             long long size, void* acc, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    count_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const int*)inc, n, size, (int*)acc);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* count_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
