// K4 disk_accum: per-pixel disk coverage counts by color group.
//
// Replaces the TPU kernel src/repro/kernels/raster/splat.py
// (disk_accum_pallas), which the renderer calls for node disks wider than
// 8 px. out[g, y, x] counts the nodes of group g whose disk holds the pixel
// centre: (x - cx)^2 + (y - cy)^2 <= r^2, for r > 0 and 0 <= g < n_groups.
//
// The TPU kernel contracts a one-hot [groups, nodes] matrix with the
// [nodes, pixels] inside mask on its matrix unit. Here one thread owns one
// pixel, walks the (few) large nodes in tiles staged in shared memory, keeps
// its per-group counts in registers, and writes each count once.
//
// The predicate must round exactly like the plain version: nvcc would
// contract a*b+c into one fused multiply-add and move boundary pixels, so
// every product and sum is written with the round-to-nearest intrinsics,
// which are never contracted. The result is bitwise equal.
//
// Bound: bytes. The output is n_groups*H*W int32 written once, against
// about 7 operations per (node, pixel) pair for the few large nodes.
#include <cuda_runtime.h>

namespace {

constexpr int PIX = 256;        // pixels (threads) per block
constexpr int NODE_TILE = 256;  // nodes staged per shared-memory tile
constexpr int MAX_G = 16;       // register counters per thread

__global__ void __launch_bounds__(PIX)
disk_accum_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                  const float* __restrict__ r, const int* __restrict__ grp,
                  int n, int n_groups, int h, int w, int* __restrict__ out) {
  __shared__ float scx[NODE_TILE], scy[NODE_TILE], sr2[NODE_TILE];
  __shared__ int sg[NODE_TILE];
  const long long hw = (long long)h * w;
  const long long pix = (long long)blockIdx.x * PIX + threadIdx.x;
  const bool live = pix < hw;
  const float fx = live ? (float)(pix % w) : 0.f;
  const float fy = live ? (float)(pix / w) : 0.f;
  int cnt[MAX_G];
#pragma unroll
  for (int q = 0; q < MAX_G; ++q) cnt[q] = 0;
  for (int k0 = 0; k0 < n; k0 += NODE_TILE) {
    for (int t = threadIdx.x; t < NODE_TILE; t += PIX) {
      const int k = k0 + t;
      int g = -1;
      if (k < n) {
        const float rk = r[k];
        g = grp[k];
        if (!(rk > 0.f) || g < 0 || g >= n_groups) g = -1;  // dead node
        scx[t] = cx[k];
        scy[t] = cy[k];
        sr2[t] = __fmul_rn(rk, rk);
      }
      sg[t] = g;
    }
    __syncthreads();
    const int kn = min(NODE_TILE, n - k0);
    for (int k = 0; k < kn; ++k) {
      const int g = sg[k];
      const float dx = __fsub_rn(fx, scx[k]);
      const float dy = __fsub_rn(fy, scy[k]);
      const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
      const int inside = (g >= 0) & (d2 <= sr2[k]);
#pragma unroll
      for (int q = 0; q < MAX_G; ++q) cnt[q] += inside & (q == g);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < MAX_G; ++q)
      if (q < n_groups) out[q * hw + pix] = cnt[q];
  }
}

}  // namespace

extern "C" int disk_accum(const void* cx, const void* cy, const void* r,
                          const void* grp, int n, int n_groups, int h, int w,
                          void* out, void* stream) {
  if (n_groups < 0 || n_groups > MAX_G) return (int)cudaErrorInvalidValue;
  const long long hw = (long long)h * w;
  if (hw > 0 && n_groups > 0) {
    const long long blocks = (hw + PIX - 1) / PIX;
    disk_accum_kernel<<<(unsigned)blocks, PIX, 0, (cudaStream_t)stream>>>(
        (const float*)cx, (const float*)cy, (const float*)r, (const int*)grp, n,
        n_groups, h, w, (int*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* disk_accum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
