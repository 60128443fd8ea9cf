// K8 cms_update: count-min sketch update, sketch[r, h[r, e]] += w[e].
//
// Replaces the TPU kernel src/repro/kernels/cms/cms_update.py
// (cms_update_pallas), which turns each block of hashed keys into a
// one-hot [B, C] matrix per row and accumulates w^T @ onehot on the matrix
// unit, because a TPU scatters poorly. This is the paper's own GPU form:
// one thread per (row, key) and one atomicAdd into the sketch, which the
// wrapper has copied from its input. Buckets outside [0, cols), the
// padding mark -1 among them, are dropped, in every row on its own.
//
// Float atomics add in no fixed order. CMS counts are integer-valued
// float32 below 2^24, where every order of additions is exact, so for
// integer-valued weights the result is bitwise equal to the plain version
// (index_put_ with accumulate); for other weights it agrees to the
// rounding of each bucket's sum.
//
// Bound: bytes. Each (row, key) reads a 4-byte bucket and the key's 4-byte
// weight; the sketch is read and written once. Contention on hot buckets
// (the few large communities) is the cost beyond that.
#include <cuda_runtime.h>

namespace {

__global__ void cms_update_kernel(const int* __restrict__ h,
                                  const float* __restrict__ w, int rows,
                                  long long n, int cols, float* __restrict__ sketch) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * n) return;
  const int r = (int)(t / n);
  const long long e = t % n;
  const int b = h[t];
  if (b < 0 || b >= cols) return;
  atomicAdd(sketch + (long long)r * cols + b, w[e]);
}

}  // namespace

extern "C" int cms_update(const void* h, const void* w, int rows, long long n,
                          int cols, void* sketch, void* stream) {
  const long long total = (long long)rows * n;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    cms_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)h, (const float*)w, rows, n, cols, (float*)sketch);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cms_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
