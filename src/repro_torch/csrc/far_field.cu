// K5 far_field: monopole far field of the uniform-grid FA2 repulsion.
//
// Replaces the TPU kernel src/repro/kernels/grid/tiled.py
// (far_field_pallas, _far_kernel). For every node i, over all cells j
// other than its own:
//   f_i = sum_j kr * m_i * M_j / max(|p_i - c_j|^2, EPS2) * (p_i - c_j)
// with c_j, M_j the cell's centroid and mass; empty cells have M_j = 0 and
// contribute 0, and a node with cell id -1 (padding) masks no cell.
//
// Bound: operations. Every node meets every cell, n*C pairs (2.81 G on the
// full path), against 12 bytes per node and per cell. What limits the card
// is the instructions issued per pair (4 warp instructions per SM and
// clock) and the MUFU reciprocal (16 per SM and clock), so the design cuts
// both:
// - A pair is 9 instructions: two differences, d^2 as a multiply and an
//   FMA, the clamp, one approximate reciprocal (rcp.approx, one MUFU op),
//   M_j * (1/d^2), and two FMA accumulates. kr * m_i is taken out of the
//   sum and applied once per node at the end.
// - Each cell is staged in shared memory as one float4 (cx, cy, M, 0), so
//   a pair costs one broadcast load, and each thread holds R nodes in
//   registers: one staged cell feeds R independent accumulator chains.
// - The own-cell mask is a select, taken only in the tiles that hold some
//   node's own cell (a block-uniform branch from __syncthreads_or); the
//   other tiles run without it. Subtracting the own cell's clamped term
//   instead would cancel catastrophically.
// - Ragged tiles are padded with mass-0 cells, which add exactly 0.
//
// Error against the plain version (kernels/grid/ref.py far_field_ref):
// d^2 may differ by an ulp (fused), the reciprocal errs by at most 2^-23,
// and kr*m_i rounds at the end, so a pair force differs from the plain
// one by a few ulp of |f_ij|. Each thread adds a tile's TILE cells into a
// tile sum and then the C/TILE tile sums, so a row errs by at most about
// (12 + TILE + C/TILE) * 2^-24 of its sum of |f_ij| (1.7e-5 at C = 4,096);
// rounding errors of independent sign leave it far below that.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // threads per block
constexpr int R = 4;         // nodes per thread, i = block base + r*THREADS + t
constexpr int NODES = THREADS * R;
constexpr int TILE = 256;    // cells staged per tile
constexpr int U = 4;         // cells per unrolled step
constexpr float EPS2 = 1e-4f;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's sums of M_j / max(d^2, EPS2) * (p_i - c_j) for the R nodes;
// with MASK, the cell at tile index own[r] is left out for node r.
template <bool MASK>
__device__ __forceinline__ void tile_sum(const float4* cells, int kend,
                                         const float (&x)[R], const float (&y)[R],
                                         const int (&own)[R], float (&tx)[R],
                                         float (&ty)[R]) {
  for (int k0 = 0; k0 < kend; k0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 c = cells[k0 + u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = x[r] - c.x;
        const float dy = y[r] - c.y;
        float w = c.z * rcp_approx(fmaxf(dx * dx + dy * dy, EPS2));
        if (MASK) w = (k0 + u == own[r]) ? 0.f : w;
        tx[r] = fmaf(w, dx, tx[r]);
        ty[r] = fmaf(w, dy, ty[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
far_field_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const int* __restrict__ cell, const float* __restrict__ ccent,
                 const float* __restrict__ cmass, int n, int c, float kr,
                 float* __restrict__ out) {
  __shared__ float4 cells[TILE];
  const int t = threadIdx.x;
  const int base = blockIdx.x * NODES + t;
  float x[R], y[R], fx[R], fy[R];
  int ci[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r * THREADS;
    const bool live = i < n;
    x[r] = live ? pos[2 * i] : 0.f;
    y[r] = live ? pos[2 * i + 1] : 0.f;
    ci[r] = live ? cell[i] : -1;
    fx[r] = 0.f;
    fy[r] = 0.f;
  }
  for (int j0 = 0; j0 < c; j0 += TILE) {
    for (int k = t; k < TILE; k += THREADS) {
      const int j = j0 + k;
      cells[k] = j < c ? make_float4(ccent[2 * j], ccent[2 * j + 1], cmass[j], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int jn = min(TILE, c - j0);
    int own[R];
    bool hit = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      own[r] = ci[r] - j0;
      hit |= (unsigned)own[r] < (unsigned)jn;
    }
    const bool masked = __syncthreads_or(hit);  // also the staging barrier
    const int kend = (jn + U - 1) / U * U;
    float tx[R], ty[R];  // this tile's sums, added to fx, fy below
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = 0.f;
    if (masked)
      tile_sum<true>(cells, kend, x, y, own, tx, ty);
    else
      tile_sum<false>(cells, kend, x, y, own, tx, ty);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fx[r] += tx[r];
      fy[r] += ty[r];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r * THREADS;
    if (i < n) {
      const float kmi = kr * mass[i];
      out[2 * i] = kmi * fx[r];
      out[2 * i + 1] = kmi * fy[r];
    }
  }
}

}  // namespace

extern "C" int far_field(const void* pos, const void* mass, const void* cell,
                         const void* ccent, const void* cmass, int n, int c,
                         float kr, void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + NODES - 1) / NODES;
    far_field_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)mass, (const int*)cell,
        (const float*)ccent, (const float*)cmass, n, c, kr, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* far_field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
