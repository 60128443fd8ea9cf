// K8 cms_update: count-min sketch update, out = sketch + delta, where
// delta[r, c] sums w[e] over the keys e whose bucket in row r is c.
//
// Replaces the TPU kernel src/repro/kernels/cms/cms_update.py
// (cms_update_pallas), which turns each block of hashed keys into a
// one-hot [B, C] matrix per row, accumulates delta = w^T @ onehot on the
// matrix unit, because a TPU scatters poorly, and returns sketch + delta.
// Two entries:
// - cms_update: the TPU kernel's contract. Buckets h [rows, n] int32 are
//   given; a bucket outside [0, cols), the padding mark -1 among them,
//   drops that slot alone, in every row on its own.
// - cms_update_keys: int32 keys, hashed here with the family of
//   core/cms.py: ((a_r * k + b_r) mod 2^32 >> 5) mod cols, in uint32
//   arithmetic, bit for bit. A key below 0 adds nothing.
//
// The keys are community labels, so a few buckets (the large communities)
// take most of the adds, and one global atomicAdd per (row, key) serialises
// on them in L2. Instead:
// - Block (s, r, t) owns hash row r, column tile t (at most TILE_COLS
//   columns, so cols has no cap) and key slice s, and privatises the tile
//   in shared memory as int64 counts, each held as two 32-bit words so
//   that the shared atomics are 32-bit ones. An add of x carries into the
//   high word exactly when the low word wraps, so lo + 2^32 * hi is the
//   exact sum mod 2^64 in any order.
// - Integer-valued weights with |w| < 2^31 are counted exactly this way.
//   The keys arrive in node order, and a community's nodes are mostly
//   consecutive, so most warps hold 32 keys of one bucket: such a warp sums
//   its weights (__reduce_add_sync; each |w| < 2^26, so 32 of them fit in
//   int32) and one lane adds the sum. Every other lane adds its own weight.
//   (__match_any_sync, which groups any equal buckets, made the whole
//   update several times slower on the main path's input: PERF.md.)
// - Each thread loads UNROLL keys, THREADS apart, before adding any, so
//   that their loads are in flight together.
// - When the slice is done, each nonzero bucket of the tile is flushed with
//   one global 64-bit atomicAdd into delta_int.
// - Any other weight (fractional, |w| >= 2^31, inf, NaN) is added by a
//   float atomicAdd straight into delta_float in global memory.
// - cms_finalize: out = (sketch + (float)delta_int) + delta_float, each add
//   made only where that delta is nonzero (a NaN delta is nonzero), so a
//   bucket no weight reached keeps the sketch's bits.
//
// Determinism. Integer adds commute, so for integer-valued weights below
// 2^31 delta_int is the exact bucket sum in any order, and out is the same
// from run to run at any size. With an integer-valued sketch and every
// bucket sum below 2^24 each float add is exact, so out is bitwise equal to
// the plain version (index_put_ with accumulate), which adds one weight at
// a time in float32. Above 2^24 the exact sum is rounded to float32 once
// (to nearest) and added to the sketch once, where the plain version rounds
// at every add: the two then differ, within 2*gamma(k)*sum|x|, and this
// kernel is the nearer to the exact sum. Weights on the float path add in
// no fixed order and agree with the plain version to the rounding of each
// bucket's sum.
//
// Bound: bytes. Each input is read once (4 bytes a bucket or key, 4 a
// weight), the sketch is read and the result written once; the repeated
// reads of a slice by the tiles and (keys entry) the rows of its blocks
// come from L2.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 512;
constexpr int ROW_GROUP = 16;  // hash rows a launch takes, their (a, b) by value
constexpr int TILE_COLS = 8192;  // 64 KB of 2 x 32-bit counts a block
constexpr int BLOCKS_PER_SM = 2;
constexpr int MIN_SLICE = 2048;  // keys a block takes at least
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

// x into the 64-bit count (lo[c], hi[c]) in shared memory.
__device__ __forceinline__ void add_count(unsigned* lo, unsigned* hi, int c,
                                          long long x) {
  const unsigned xl = (unsigned)x;
  const unsigned old = atomicAdd(lo + c, xl);
  const unsigned xh = (unsigned)(x >> 32) + (old + xl < old ? 1u : 0u);
  if (xh != 0u) atomicAdd(hi + c, xh);
}

// One key's weight w into bucket b of this block's tile [c0, c0 + tc); b is
// -1 when the key adds nothing here. Called by all 32 lanes together.
__device__ __forceinline__ void add_weight(int b, float w, int c0, int tc,
                                           unsigned* lo, unsigned* hi,
                                           float* dflt_row) {
  const bool here = b >= c0 && b < c0 + tc;
  const bool integral = w == truncf(w);  // false for NaN
  const bool small = here && integral && fabsf(w) < 0x1p26f;
  const int b0 = __shfl_sync(FULL, b, 0);
  if (__all_sync(FULL, small && b == b0)) {
    const int s = __reduce_add_sync(FULL, (int)w);
    if ((threadIdx.x & 31) == 0) add_count(lo, hi, b0 - c0, s);
  } else if (here) {
    if (integral && fabsf(w) < 0x1p31f)
      add_count(lo, hi, b - c0, (long long)w);
    else
      atomicAdd(dflt_row + b, w);
  }
}

struct RowHashes {  // the (a, b) of hash rows r0 .. r0 + ROW_GROUP - 1
  unsigned a[ROW_GROUP], b[ROW_GROUP];
};

// grid.x: key slices; grid.y: (rows of this group) * tiles. HASHED reads
// h [rows, n]; otherwise keys [n] are hashed with hp.
template <bool HASHED>
__global__ void __launch_bounds__(THREADS)
cms_tile_kernel(const int* __restrict__ in, RowHashes hp,
                const float* __restrict__ w, int r0, long long n, int cols,
                int tiles, long long slice, unsigned long long* __restrict__ dint,
                float* __restrict__ dflt) {
  extern __shared__ unsigned tile[];
  const int rg = blockIdx.y / tiles;
  const int r = r0 + rg;
  const int t = blockIdx.y % tiles;
  const int c0 = (int)((long long)t * cols / tiles);
  const int tc = (int)((long long)(t + 1) * cols / tiles) - c0;
  unsigned* lo = tile;
  unsigned* hi = tile + tc;
  for (int c = threadIdx.x; c < 2 * tc; c += THREADS) tile[c] = 0u;
  __syncthreads();
  const long long e0 = (long long)blockIdx.x * slice;
  const long long e1 = min(n, e0 + slice);
  unsigned a = 0u, bb = 0u;  // a constant index keeps hp out of local memory
#pragma unroll
  for (int i = 0; i < ROW_GROUP; ++i)
    if (i == rg) a = hp.a[i], bb = hp.b[i];
  const int* hr = in + (HASHED ? (long long)r * n : 0ll);
  float* dflt_row = dflt + (long long)r * cols;
  for (long long base = e0; base < e1; base += UNROLL * THREADS) {
    int b[UNROLL];
    float we[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long e = base + j * THREADS + threadIdx.x;
      b[j] = -1;
      we[j] = 0.f;
      if (e < e1) {
        const int v = hr[e];
        if (HASHED) {
          b[j] = v >= 0 && v < cols ? v : -1;
        } else if (v >= 0) {
          b[j] = (int)(((a * (unsigned)v + bb) >> 5) % (unsigned)cols);
        }
        we[j] = w[e];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) add_weight(b[j], we[j], c0, tc, lo, hi, dflt_row);
  }
  __syncthreads();
  unsigned long long* drow = dint + (long long)r * cols + c0;
  for (int c = threadIdx.x; c < tc; c += THREADS) {
    const unsigned long long v = (unsigned long long)hi[c] << 32 | lo[c];
    if (v != 0ull) atomicAdd(drow + c, v);
  }
}

__global__ void cms_finalize(const float* __restrict__ sketch,
                             const long long* __restrict__ dint,
                             const float* __restrict__ dflt, long long total,
                             float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = sketch[i];
    const long long d = dint[i];
    if (d != 0) s = __fadd_rn(s, __ll2float_rn(d));
    const float f = dflt[i];
    if (f != 0.f) s = __fadd_rn(s, f);
    out[i] = s;
  }
}

// hash_ab: host array, every row's a, then every row's b (keys entry
// only). scratch: zeroed, rows * cols int64 (delta_int) then rows * cols
// float (delta_float).
template <bool HASHED>
int launch(const void* in, const unsigned* hash_ab, const void* w, int rows,
           long long n, int cols, const void* sketch, void* scratch, void* out,
           void* stream) {
  const long long total = (long long)rows * cols;
  if (total <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* dint = (unsigned long long*)scratch;
  float* dflt = (float*)(dint + total);
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int tiles = (cols + TILE_COLS - 1) / TILE_COLS;
    const int tile_bytes = (int)(((long long)cols + tiles - 1) / tiles) * 8;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cms_tile_kernel<HASHED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
    if (e != cudaSuccess) return (int)e;
    const long long jobs = (long long)std::min(rows, ROW_GROUP) * tiles;
    long long slices = (sms * BLOCKS_PER_SM + jobs - 1) / jobs;
    slices = std::max(1ll, std::min(slices, (n + MIN_SLICE - 1) / MIN_SLICE));
    const long long slice = (n + slices - 1) / slices;
    slices = (n + slice - 1) / slice;
    for (int r0 = 0; r0 < rows; r0 += ROW_GROUP) {
      const int group = std::min(ROW_GROUP, rows - r0);
      RowHashes hp = {};
      for (int i = 0; !HASHED && i < group; ++i) {
        hp.a[i] = hash_ab[r0 + i];
        hp.b[i] = hash_ab[rows + r0 + i];
      }
      cms_tile_kernel<HASHED><<<dim3((unsigned)slices, (unsigned)(group * tiles)),
                                THREADS, tile_bytes, s>>>(
          (const int*)in, hp, (const float*)w, r0, n, cols, tiles, slice, dint, dflt);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  const long long blocks = std::min((total + 255) / 256, 4096ll);
  cms_finalize<<<(unsigned)blocks, 256, 0, s>>>(
      (const float*)sketch, (const long long*)dint, dflt, total, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cms_update(const void* h, const void* w, int rows, long long n,
                          int cols, const void* sketch, void* scratch, void* out,
                          void* stream) {
  return launch<true>(h, nullptr, w, rows, n, cols, sketch, scratch, out, stream);
}

extern "C" int cms_update_keys(const void* keys, const void* hash_ab, const void* w,
                               int rows, long long n, int cols, const void* sketch,
                               void* scratch, void* out, void* stream) {
  return launch<false>(keys, (const unsigned*)hash_ab, w, rows, n, cols, sketch,
                       scratch, out, stream);
}

extern "C" const char* cms_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
