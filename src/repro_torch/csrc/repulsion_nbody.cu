// K2 repulsion_nbody: exact O(n^2) ForceAtlas2 repulsion on the supergraph.
//
// Replaces the TPU kernel src/repro/kernels/repulsion/nbody.py
// (repulsion_pallas). For every node i:
//   f_i = sum_{j != i} kr * m_i * m_j / (eff_ij * d_ij) * (p_i - p_j)
//   d_ij = sqrt(max(|p_i - p_j|^2, EPS^2))
//   eff_ij = max(d_ij - r_i - r_j, EPS)   (use_radii)   or max(d_ij, EPS)
// and the self pair is masked by index.
//
// One thread per node i; a block of TILE threads walks all j in tiles of
// TILE nodes staged in shared memory (positions, masses, radii), and each
// thread accumulates its force in float32 registers: each tile's sum first,
// then the tile sums, so a rounding error is at most about
// (TILE + n/TILE) * 2^-24 of the row's sum of |f_ij| (one running sum would
// allow n * 2^-24: once a near pair has made it large, the far pairs' small
// terms round away). A ragged n is masked in
// the kernel, so nothing is padded. The TPU's 2-D (i, j) grid with a carried
// output block becomes the j loop inside the block.
//
// Bound: operations. 17 float operations per pair with radii, 15 without
// (one sqrt and one divide among them), against n^2 pairs; the inputs are
// 16 bytes per node.
//
// Each pair force rounds like the plain version: |p_i - p_j|^2 is written
// with the round-to-nearest intrinsics so nvcc cannot contract it into a
// fused multiply-add, which near d = r_i + r_j would move eff by far more
// than an ulp. Only the order of the sum over j differs, so the two agree
// to a tolerance scaled by each row's sum of |f_ij|, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr float EPS = 1e-4f;
constexpr float EPS2 = 1e-8f;

__global__ void __launch_bounds__(TILE)
repulsion_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 const float* __restrict__ radii, int n, float kr,
                 int use_radii, float* __restrict__ out) {
  __shared__ float sx[TILE], sy[TILE], sm[TILE], sr[TILE];
  const int t = threadIdx.x;
  const int i = blockIdx.x * TILE + t;
  const bool live = i < n;
  const float xi = live ? pos[2 * i] : 0.f;
  const float yi = live ? pos[2 * i + 1] : 0.f;
  const float kmi = live ? kr * mass[i] : 0.f;
  const float ri = (live && use_radii) ? radii[i] : 0.f;
  float fx = 0.f, fy = 0.f;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int j = j0 + t;
    if (j < n) {
      sx[t] = pos[2 * j];
      sy[t] = pos[2 * j + 1];
      sm[t] = mass[j];
      sr[t] = use_radii ? radii[j] : 0.f;
    }
    __syncthreads();
    const int jn = min(TILE, n - j0);
    if (live) {
      float tx = 0.f, ty = 0.f;  // this tile's sum, added to fx, fy below
      for (int k = 0; k < jn; ++k) {
        const float dx = xi - sx[k];
        const float dy = yi - sy[k];
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float d = sqrtf(fmaxf(d2, EPS2));
        const float eff = use_radii ? fmaxf(d - ri - sr[k], EPS) : fmaxf(d, EPS);
        const float mag = (j0 + k == i) ? 0.f : kmi * sm[k] / (eff * d);
        tx += mag * dx;
        ty += mag * dy;
      }
      fx += tx;
      fy += ty;
    }
    __syncthreads();
  }
  if (live) {
    out[2 * i] = fx;
    out[2 * i + 1] = fy;
  }
}

}  // namespace

extern "C" int repulsion_nbody(const void* pos, const void* mass,
                               const void* radii, int n, float kr,
                               int use_radii, void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + TILE - 1) / TILE;
    repulsion_kernel<<<blocks, TILE, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)mass, (const float*)radii, n, kr,
        use_radii, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repulsion_nbody_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
