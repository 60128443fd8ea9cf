// K3 count_scatter: int32 scatter-adds into the renderer's accumulator.
//
// Replaces the TPU kernel src/repro/kernels/raster/splat.py
// (count_scatter_pallas), which argsorts the positions so that each block
// touches one band of output tiles, because a TPU scatters poorly. Hopper
// has atomics, so there is no sort. Integer adds are associative and
// commutative (and wrap alike), so every result is bitwise equal to the
// plain version in any order. Two entries:
//
// - count_scatter: rows with 0 <= pos < size add inc (or 1 when inc is
//   null) to acc[pos]; other positions (the INT32_MAX drop marker) are
//   skipped. The streamed edge pass calls it once a chunk. One thread a
//   row, one atomicAdd. On both paths' edge chunks (524,288 samples, 76 %
//   and 90 % of them on distinct pixels) it runs at the card's rate of
//   scattered atomics, about 8 us a chunk on an H100. Three redesigns were
//   no faster there (PERF.md): 16-byte loads over a grid-stride loop,
//   merging a thread's runs of one pixel, and summing a warp whose lanes
//   all hold one pixel; grouping equal pixels with __match_any_sync took
//   twice as long.
//   Bound: bytes. Each row reads 8 bytes (4 with unit increments), each
//   distinct position is read and written once.
//
// - count_disks: the renderer's small-disk node pass. Disk k adds 1 to
//   acc[g, y, x] for each pixel of the BBOX x BBOX box around it, x = bx + j
//   and y = by + i (0 <= i, j < BBOX, b = to_pixel(c) - BBOX / 2), that lies
//   in the image and passes fl(fl(dy^2) + fl(dx^2)) <= fl(r^2) with
//   dx = fl((float)x - cx), dy = fl((float)y - cy); disks with !(r > 0) or
//   a group outside [0, n_groups) add nothing. This is the plain version's
//   mapping and predicate (kernels/raster/ref.py), written with the
//   round-to-nearest intrinsics because nvcc would contract a*b + c into a
//   fused multiply-add and move boundary pixels. The threads of a disk
//   read its 16 bytes and generate the box themselves, where the plain
//   version materialises BBOX^2 rows of indices a disk. A disk has `split`
//   threads, each taking every split-th box row: one where the disks alone
//   fill the card (685,230 disks of 1 px on the full path), up to BBOX where
//   they are few and large (7,284 disks up to 8 px on the main path, where
//   one thread a disk left most of the card idle). It skips a box row whose
//   fl(dy^2) > fl(r^2), and a column whose fl(dx^2) > fl(r^2): both squares
//   are >= 0, so fl(dy^2 + dx^2) >= max(dy^2, dx^2) (rounding is monotone)
//   and no pixel in that row or column can pass; a NaN square is skipped,
//   and a NaN predicate keeps nothing either.
//   Bound: bytes. 16 bytes a disk, and each covered pixel read and written.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int BBOX = 18;  // kernels/raster/ref.py BBOX

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

__device__ __forceinline__ int to_pixel(float x) {
  float f = floorf(x);
  if (f != f) f = 0.f;
  return (int)fminf(fmaxf(f, -0x1p30f), 0x1p30f);
}

__global__ void __launch_bounds__(THREADS)
count_disks_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ r, const int* __restrict__ grp,
                   int m, int split, int n_groups, int hs, int ws,
                   int* __restrict__ acc) {
  const long long total = (long long)m * split;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    const int k = (int)(t / split), part = (int)(t % split);
    const float rk = r[k];
    const int g = grp[k];
    if (!(rk > 0.f) || g < 0 || g >= n_groups) continue;
    const float cx = px[k], cy = py[k];
    const float r2 = __fmul_rn(rk, rk);
    const int bx = to_pixel(cx) - BBOX / 2;
    const int by = to_pixel(cy) - BBOX / 2;
    unsigned cols = 0;  // bit j: column bx + j is in the image and dx^2 <= r^2
#pragma unroll
    for (int j = 0; j < BBOX; ++j) {
      const int x = bx + j;
      const float dx = __fsub_rn((float)x, cx);
      if (x >= 0 && x < ws && __fmul_rn(dx, dx) <= r2) cols |= 1u << j;
    }
    if (cols == 0) continue;
    const int y0 = max(by, 0), y1 = min(by + BBOX, hs);
    for (int y = y0 + part; y < y1; y += split) {
      const float dy = __fsub_rn((float)y, cy);
      const float dy2 = __fmul_rn(dy, dy);
      if (!(dy2 <= r2)) continue;
      int* row = acc + ((long long)g * hs + y) * ws;
      for (unsigned c = cols; c != 0; c &= c - 1) {
        const int x = bx + __ffs(c) - 1;
        const float dx = __fsub_rn((float)x, cx);
        if (__fadd_rn(dy2, __fmul_rn(dx, dx)) <= r2) atomicAdd(row + x, 1);
      }
    }
  }
}

}  // namespace

extern "C" int count_scatter(const void* pos, const void* inc, long long n,
                             long long size, void* acc, void* stream) {
  if (n > 0) {
    long long blocks = (n + THREADS - 1) / THREADS;
    count_scatter_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const int*)inc, n, size, (int*)acc);
  }
  return (int)cudaGetLastError();
}

// acc [n_groups, hs, ws] int32 += the small disks' pixel counts.
extern "C" int count_disks(const void* px, const void* py, const void* r,
                           const void* grp, int m, int n_groups, int hs, int ws,
                           void* acc, void* stream) {
  if (m > 0 && n_groups > 0 && hs > 0 && ws > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long slots = (long long)sms * BLOCKS_PER_SM * THREADS;
    const int split = (int)std::min<long long>(BBOX, (slots + m - 1) / m);
    const long long blocks =
        std::min<long long>(sms * BLOCKS_PER_SM, ((long long)m * split + THREADS - 1) / THREADS);
    count_disks_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)px, (const float*)py, (const float*)r, (const int*)grp, m, split,
        n_groups, hs, ws, (int*)acc);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* count_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
