// K4 disk_accum: per-pixel disk coverage counts by color group, added into
// an int32 accumulator.
//
// Replaces the TPU kernel src/repro/kernels/raster/splat.py
// (disk_accum_pallas), which the renderer calls for node disks wider than
// 8 px. out[g, y, x] += the number of nodes of group g whose disk holds the
// pixel centre: (x - cx)^2 + (y - cy)^2 <= r^2, for r > 0 and
// 0 <= g < n_groups.
//
// The TPU kernel contracts a one-hot [groups, nodes] matrix with the dense
// [nodes, pixels] inside mask on its matrix unit, where dense work is cheap.
// On this card the dense form tests every (pixel, disk) pair, while the
// disks' bounding boxes hold a tiny fraction of the pairs. So the work is
// disk-major: each live disk's box, clipped to the image, is walked once.
//
// - disk_area_scan (one block): the clipped box of every disk and an
//   exclusive prefix sum of their areas, start[0..n] (int64).
// - disk_walk: the box pixels, in disk order and row-major within a box,
//   split evenly over all warps: warp w owns the rows whose first pixel lies
//   in its share [p0, p1) of the prefix, so a 257x257 box spreads over many
//   warps and a 19x19 box over a few rows of one. Lanes take consecutive x,
//   so a warp's atomicAdds (no return value) hit consecutive words of one
//   channel row. Integer adds commute: the result is bitwise whatever order
//   they land in.
//
// The box only culls; the predicate decides, and it must round exactly like
// the plain version: nvcc would contract a*b+c into one fused multiply-add
// and move boundary pixels, so every product and sum is written with the
// round-to-nearest intrinsics, which are never contracted. The box is wide
// enough that no pixel outside it can pass the rounded predicate:
// - fl(r*r) finite: a pixel that passes has |x - cx| <= r*(1 + 2.0001*2^-24)
//   (fl(dx^2) <= d2 <= fl(r^2), each one rounding), unless the squares
//   underflow, which needs |x - cx| < 1. The box is c -/+ (r*(1 + 2^-20) + 1),
//   computed in double.
// - fl(r*r) = +inf: every pixel passes (d2 <= +inf), even for |cx| = 1e30
//   where d2 overflows too, so the box is the whole image.
// - a NaN centre or radius, r <= 0 and an out-of-range group count nothing.
//
// Bound: bytes. The fresh [n_groups, h, w] output is written once, against
// about 6 operations per box pixel.
#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;  // disks a scan thread holds per round
constexpr int WALK_THREADS = 256;
constexpr int WALK_BLOCKS_PER_SM = 4;  // one wave at 51 registers
constexpr unsigned FULL = 0xffffffffu;
constexpr float F32_MAX = 3.40282347e38f;

struct Box {
  int x0, x1, y0, y1;  // inclusive, clipped to the image
};

// Pixels along one axis whose centre may pass the predicate.
__device__ bool axis_span(float c, float r, int size, int& lo, int& hi) {
  const double m = (double)r * (1.0 + 0x1p-20) + 1.0;
  const double a = ceil((double)c - m);
  const double b = floor((double)c + m);
  if (!(a <= (double)(size - 1)) || !(b >= 0.0)) return false;
  lo = (int)fmax(a, 0.0);
  hi = (int)fmin(b, (double)(size - 1));
  return true;
}

__device__ bool disk_box(float cx, float cy, float r, int g, int n_groups,
                         int h, int w, Box& b) {
  if (!(r > 0.f) || g < 0 || g >= n_groups || cx != cx || cy != cy)
    return false;  // dead, out of range, or a NaN centre
  if (__fmul_rn(r, r) > F32_MAX) {  // r*r = +inf: every pixel passes
    b = Box{0, w - 1, 0, h - 1};
    return true;
  }
  return axis_span(cx, r, w, b.x0, b.x1) && axis_span(cy, r, h, b.y0, b.y1);
}

__global__ void __launch_bounds__(SCAN_THREADS)
disk_area_scan(const float* __restrict__ cx, const float* __restrict__ cy,
               const float* __restrict__ r, const int* __restrict__ grp,
               int n, int n_groups, int h, int w,
               long long* __restrict__ start) {
  __shared__ long long warp_sum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < n; base += SCAN_THREADS * SCAN_ITEMS) {
    long long area[SCAN_ITEMS], own = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const long long k = base + (long long)threadIdx.x * SCAN_ITEMS + i;
      Box b;
      area[i] = 0;
      if (k < n && disk_box(cx[k], cy[k], r[k], grp[k], n_groups, h, w, b))
        area[i] = (long long)(b.x1 - b.x0 + 1) * (b.y1 - b.y0 + 1);
      own += area[i];
    }
    long long incl = own;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp sums
      long long s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long t = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += t;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    long long at = carry + (warp ? warp_sum[warp - 1] : 0) + incl - own;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const long long k = base + (long long)threadIdx.x * SCAN_ITEMS + i;
      if (k < n) start[k] = at;
      at += area[i];
    }
    carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();  // warp_sum is rewritten next round
  }
  if (threadIdx.x == 0) start[n] = carry;
}

__global__ void __launch_bounds__(WALK_THREADS)
disk_walk(const float* __restrict__ cx, const float* __restrict__ cy,
          const float* __restrict__ r, const int* __restrict__ grp, int n,
          int n_groups, int h, int w, const long long* __restrict__ start,
          int* __restrict__ out) {
  const long long total = start[n];
  const long long warps = (long long)gridDim.x * (WALK_THREADS / 32);
  const long long wid =
      (long long)blockIdx.x * (WALK_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long per = (total + warps - 1) / warps;
  const long long p0 = wid * per;
  const long long p1 = min(total, p0 + per);
  if (p0 >= p1) return;
  // The disk holding pixel p0, the last k with start[k] <= p0, by a 32-way
  // search: each round the lanes probe 32 evenly spaced entries.
  int k = 0, hi = n - 1;
  while (k < hi) {
    const int step = (hi - k + 31) / 32;
    const long long q = k + (long long)(lane + 1) * step;
    const unsigned le = __ballot_sync(FULL, q <= hi && start[q] <= p0);
    k += __popc(le) * step;  // the probes at or below p0 are a prefix
    hi = min(hi, k + step - 1);
  }
  // Walk the rows that start in [p0, p1): from the first row of disk k
  // that starts at or after p0, to the first row (of k or a later disk)
  // that starts at or after p1.
  Box b;
  while (true) {  // disk k holds pixels, and a row of it may start here
    const float rk = r[k], kx = cx[k], ky = cy[k];
    const float r2 = __fmul_rn(rk, rk);
    const int g = grp[k];
    disk_box(kx, ky, rk, g, n_groups, h, w, b);
    const long long base = start[k];
    const int bw = b.x1 - b.x0 + 1, bh = b.y1 - b.y0 + 1;
    const int row0 = base >= p0 ? 0 : (int)((p0 - base + bw - 1) / bw);
    const int row1 = (int)min((long long)bh, (p1 - base + bw - 1) / bw);
    int* dst = out + ((long long)g * h + b.y0 + row0) * w;
    for (int row = row0; row < row1; ++row, dst += w) {
      const float dy = __fsub_rn((float)(b.y0 + row), ky);
      const float dy2 = __fmul_rn(dy, dy);
      for (int x = b.x0 + lane; x <= b.x1; x += 32) {
        const float dx = __fsub_rn((float)x, kx);
        if (__fadd_rn(dy2, __fmul_rn(dx, dx)) <= r2) atomicAdd(dst + x, 1);
      }
    }
    if (row1 < bh) break;  // the rest of this box is the next warps'
    ++k;
    while (k < n && start[k + 1] == start[k]) ++k;  // boxes without pixels
    if (k >= n || start[k] >= p1) break;
  }
}

}  // namespace

// out [n_groups, h, w] int32 += coverage counts. start: [n + 1] int64
// scratch.
extern "C" int disk_accum(const void* cx, const void* cy, const void* r,
                          const void* grp, int n, int n_groups, int h, int w,
                          void* start, void* out, void* stream) {
  if (n > 0 && n_groups > 0 && h > 0 && w > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t s = (cudaStream_t)stream;
    disk_area_scan<<<1, SCAN_THREADS, 0, s>>>(
        (const float*)cx, (const float*)cy, (const float*)r, (const int*)grp,
        n, n_groups, h, w, (long long*)start);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    disk_walk<<<sms * WALK_BLOCKS_PER_SM, WALK_THREADS, 0, s>>>(
        (const float*)cx, (const float*)cy, (const float*)r, (const int*)grp,
        n, n_groups, h, w, (const long long*)start, (int*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* disk_accum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
