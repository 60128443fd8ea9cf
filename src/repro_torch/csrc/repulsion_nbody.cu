// K2 repulsion_nbody: exact O(n^2) ForceAtlas2 repulsion on the supergraph.
//
// Replaces the TPU kernel src/repro/kernels/repulsion/nbody.py
// (repulsion_pallas). For every node i:
//   f_i = sum_{j != i} kr * m_i * m_j / (eff_ij * d_ij) * (p_i - p_j)
//   d_ij = sqrt(max(|p_i - p_j|^2, EPS^2))
//   eff_ij = max(d_ij - r_i - r_j, EPS)   (use_radii)   or max(d_ij, EPS)
// and the self pair is masked by index.
//
// Bound: operations, n^2 pairs against 16 bytes per node. At the main
// path's n = 16,384 one block per 256 nodes would give 64 blocks on 132
// SMs, each thread walking all n sources in one dependent chain. So:
// - The source axis is split into `slices` contiguous slices of whole
//   TILE-source tiles (slice s holds tiles [s*T/S, (s+1)*T/S) of the
//   T = ceil(n/TILE); kernels/repulsion/ops.py source_slices chooses S from
//   n and the SM count and spells out the same bounds). The grid is
//   node blocks x slices, 1,024 blocks at n = 16,384. Each block writes
//   its partial forces to scratch [S, n, 2]; sum_slices adds the S
//   partials of each node in the order s = 0 .. S-1. No float atomics, so
//   the result is the same bits from run to run.
// - Each source is staged in shared memory as one float4 (x, y, m, r), and
//   each thread holds R = 2 nodes, so one broadcast load feeds two
//   independent chains.
// - kr * m_i leaves the sum (one product per node and slice), and the
//   divide becomes m_j * rcp.approx(eff * d).
// - d and eff are NOT approximated: near contact eff = d - r_i - r_j
//   cancels (at d = 100 one ulp of d, 7.6e-6, moves eff = 1e-4 by 7.6 %),
//   so d^2 is written with the round-to-nearest intrinsics (no fused
//   multiply-add), d is the correctly rounded square root of
//   max(d^2, EPS^2), and eff subtracts r_i and then r_j, exactly as the
//   plain version (kernels/repulsion/ref.py) rounds them.
// - The self-pair select runs only in the tiles where the block's nodes
//   meet themselves (block-uniform); a ragged slice end is padded with
//   mass-0 sources, which add exactly 0.
//
// Row range (repulsion_nbody_rows): targets [row0, row0 + rows) against
// all n sources, for the sharded layout's owned rows. The node blocks
// start at row0, the scratch is [S, rows, 2] and the slices are those of
// the whole n (source_slices(n, ...) in kernels/repulsion/ops.py), so each
// row walks the same tiles in the same order and adds the same slices in
// the same order as in the full launch: its bits do not depend on which
// rows run beside it.
//
// Error against the plain version: eff and d are the plain version's bits,
// the reciprocal errs by at most 2^-23 and m_j / kr*m_i round once each, so
// a pair force differs by a few ulp of |f_ij|. Sums run over TILE sources,
// then over a slice's tiles, then over the S slices, so a row errs by at
// most about (8 + TILE + T/S + S) * 2^-24 of its sum of |f_ij|
// (1.9e-5 at n = 65,536, the largest s_layout).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // threads per block
constexpr int R = 2;          // nodes per thread, i = block base + r*THREADS + t
constexpr int NODES = THREADS * R;
constexpr int TILE = 256;     // sources staged per tile
constexpr int U = 4;          // sources per unrolled step
constexpr float EPS = 1e-4f;
constexpr float EPS2 = 1e-8f;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's sums of m_j / (eff * d) * (p_i - p_j) for the R nodes; with
// MASK, the source whose index is i[r] is left out for node r.
template <bool RADII, bool MASK>
__device__ __forceinline__ void tile_sum(const float4* src, int kend, int j0,
                                         const int (&i)[R], const float (&x)[R],
                                         const float (&y)[R], const float (&ri)[R],
                                         float (&tx)[R], float (&ty)[R]) {
  for (int k0 = 0; k0 < kend; k0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 s = src[k0 + u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = x[r] - s.x;
        const float dy = y[r] - s.y;
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float d = __fsqrt_rn(fmaxf(d2, EPS2));
        const float eff = RADII ? fmaxf(d - ri[r] - s.w, EPS) : fmaxf(d, EPS);
        float w = s.z * rcp_approx(eff * d);
        if (MASK) w = (j0 + k0 + u == i[r]) ? 0.f : w;
        tx[r] = fmaf(w, dx, tx[r]);
        ty[r] = fmaf(w, dy, ty[r]);
      }
    }
  }
}

template <bool RADII>
__global__ void __launch_bounds__(THREADS)
repulsion_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const float* __restrict__ radii, int n, int row0, int rows,
                 float kr, int slices, float* __restrict__ part) {
  __shared__ float4 src[TILE];
  const int t = threadIdx.x;
  const int b0 = row0 + blockIdx.x * NODES;  // this block's nodes: [b0, b0 + NODES)
  const int row_end = row0 + rows;
  const int s = blockIdx.y;
  const long long tiles = (n + TILE - 1) / TILE;
  const int j_begin = (int)(s * tiles / slices) * TILE;
  const int j_end = min(n, (int)((s + 1) * tiles / slices) * TILE);
  int i[R];
  float x[R], y[R], ri[R], fx[R], fy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    i[r] = b0 + r * THREADS + t;
    const bool live = i[r] < row_end;
    x[r] = live ? pos[2 * i[r]] : 0.f;
    y[r] = live ? pos[2 * i[r] + 1] : 0.f;
    ri[r] = (live && RADII) ? radii[i[r]] : 0.f;
    fx[r] = 0.f;
    fy[r] = 0.f;
  }
  for (int j0 = j_begin; j0 < j_end; j0 += TILE) {
    for (int k = t; k < TILE; k += THREADS) {
      const int j = j0 + k;
      src[k] = j < j_end
          ? make_float4(pos[2 * j], pos[2 * j + 1], mass[j], RADII ? radii[j] : 0.f)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int jn = min(TILE, j_end - j0);
    const int kend = (jn + U - 1) / U * U;
    float tx[R], ty[R];  // this tile's sums, added to fx, fy below
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = 0.f;
    if (j0 < b0 + NODES && b0 < j0 + jn)  // the block meets itself here
      tile_sum<RADII, true>(src, kend, j0, i, x, y, ri, tx, ty);
    else
      tile_sum<RADII, false>(src, kend, j0, i, x, y, ri, tx, ty);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fx[r] += tx[r];
      fy[r] += ty[r];
    }
    __syncthreads();
  }
  float* dst = part + (size_t)s * rows * 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i[r] < row_end) {
      const float kmi = kr * mass[i[r]];
      dst[2 * (i[r] - row0)] = kmi * fx[r];
      dst[2 * (i[r] - row0) + 1] = kmi * fy[r];
    }
  }
}

// out[k] = part[0][k] + part[1][k] + ... + part[S-1][k], in that order.
__global__ void sum_slices(const float* __restrict__ part, int slices, int len,
                           float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= len) return;
  float acc = part[k];
  for (int s = 1; s < slices; ++s) acc += part[(size_t)s * len + k];
  out[k] = acc;
}

}  // namespace

// Targets [row0, row0 + rows) of n, out [rows, 2]. scratch: [slices,
// rows, 2] float32, unused (may be null) when slices == 1, in which case
// the one slice is written to out directly.
extern "C" int repulsion_nbody_rows(const void* pos, const void* mass,
                                    const void* radii, int n, int row0, int rows,
                                    float kr, int use_radii, int slices,
                                    void* scratch, void* out, void* stream) {
  if (row0 < 0 || rows < 0 || row0 > n - rows) return (int)cudaErrorInvalidValue;
  if (rows > 0 && slices > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    float* part = slices == 1 ? (float*)out : (float*)scratch;
    const dim3 grid((rows + NODES - 1) / NODES, slices);
    if (use_radii)
      repulsion_kernel<true><<<grid, THREADS, 0, st>>>(
          (const float*)pos, (const float*)mass, (const float*)radii, n, row0,
          rows, kr, slices, part);
    else
      repulsion_kernel<false><<<grid, THREADS, 0, st>>>(
          (const float*)pos, (const float*)mass, (const float*)radii, n, row0,
          rows, kr, slices, part);
    if (slices > 1) {
      const int len = 2 * rows;
      sum_slices<<<(len + 255) / 256, 256, 0, st>>>(part, slices, len, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}

// All n targets: the row range [0, n).
extern "C" int repulsion_nbody(const void* pos, const void* mass,
                               const void* radii, int n, float kr,
                               int use_radii, int slices, void* scratch,
                               void* out, void* stream) {
  return repulsion_nbody_rows(pos, mass, radii, n, 0, n, kr, use_radii, slices,
                              scratch, out, stream);
}

extern "C" const char* repulsion_nbody_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
