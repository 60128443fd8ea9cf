// K5 far_field: monopole far field of the uniform-grid FA2 repulsion.
//
// Replaces the TPU kernel src/repro/kernels/grid/tiled.py
// (far_field_pallas, _far_kernel). For every node i, over all cells j
// other than its own:
//   f_i = sum_j kr * m_i * M_j / max(|p_i - c_j|^2, EPS2) * (p_i - c_j)
// with c_j, M_j the cell's centroid and mass; empty cells have M_j = 0 and
// contribute 0, and a node with cell id -1 (padding) masks no cell.
//
// One thread per node. A block of TILE threads walks the C cells in tiles
// of TILE (cx, cy, M) staged in shared memory, so every cell is read from
// device memory once per block; each thread adds each tile's sum first and
// then the tile sums, which keeps its rounding error near
// (TILE + C/TILE) * 2^-24 of the row's sum of |f_ij|. The TPU's 2-D grid
// (node tile x cell tile) with the output carried across the cell axis
// becomes the cell loop inside the block.
//
// Each pair force rounds like the plain version (kernels/grid/ref.py
// far_field_ref): the products, d^2 and the divide are written with the
// round-to-nearest intrinsics, which nvcc never contracts into fused
// multiply-adds. Only the order of the sum over cells differs, so the two
// agree to a tolerance scaled by each row's sum of |f_ij|, not bitwise.
//
// Bound: operations. 13 float operations per (node, cell) pair (two
// differences, two squares and their sum, the clamp, m_i*M_j with kr*m_i
// hoisted, one divide, the own-cell select, two products and two adds)
// against n*C pairs; the inputs are 12 bytes per node and per cell. The
// IEEE divide per pair is the largest single cost.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr float EPS2 = 1e-4f;

__global__ void __launch_bounds__(TILE)
far_field_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const int* __restrict__ cell, const float* __restrict__ ccent,
                 const float* __restrict__ cmass, int n, int c, float kr,
                 float* __restrict__ out) {
  __shared__ float scx[TILE], scy[TILE], scm[TILE];
  const int t = threadIdx.x;
  const int i = blockIdx.x * TILE + t;
  const bool live = i < n;
  const float xi = live ? pos[2 * i] : 0.f;
  const float yi = live ? pos[2 * i + 1] : 0.f;
  const float kmi = live ? __fmul_rn(kr, mass[i]) : 0.f;
  const int ci = live ? cell[i] : -1;
  float fx = 0.f, fy = 0.f;
  for (int j0 = 0; j0 < c; j0 += TILE) {
    const int j = j0 + t;
    if (j < c) {
      scx[t] = ccent[2 * j];
      scy[t] = ccent[2 * j + 1];
      scm[t] = cmass[j];
    }
    __syncthreads();
    const int jn = min(TILE, c - j0);
    if (live) {
      float tx = 0.f, ty = 0.f;  // this tile's sum, added to fx, fy below
      for (int k = 0; k < jn; ++k) {
        const float dx = __fsub_rn(xi, scx[k]);
        const float dy = __fsub_rn(yi, scy[k]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float mag = (j0 + k == ci)
            ? 0.f : __fdiv_rn(__fmul_rn(kmi, scm[k]), fmaxf(d2, EPS2));
        tx = __fadd_rn(tx, __fmul_rn(mag, dx));
        ty = __fadd_rn(ty, __fmul_rn(mag, dy));
      }
      fx = __fadd_rn(fx, tx);
      fy = __fadd_rn(fy, ty);
    }
    __syncthreads();
  }
  if (live) {
    out[2 * i] = fx;
    out[2 * i + 1] = fy;
  }
}

}  // namespace

extern "C" int far_field(const void* pos, const void* mass, const void* cell,
                         const void* ccent, const void* cmass, int n, int c,
                         float kr, void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + TILE - 1) / TILE;
    far_field_kernel<<<blocks, TILE, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)mass, (const int*)cell,
        (const float*)ccent, (const float*)cmass, n, c, kr, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* far_field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
