// K1 merge_scatter: the placement step of superedge aggregation.
//
// Replaces the TPU kernel src/repro/kernels/merge/sorted_merge.py
// (scatter_combine_pallas, as merge_combine_pallas calls it). The sorted
// superedge state run [ns] and the deduped chunk run [nc] arrive with their
// merge-path ranks (computed by torch searchsorted/cumsum in
// kernels/merge/ref.py). Each row with rank p < cap lands in output slot p:
// keys combine by max, weights by + in state-then-chunk order from +0.0.
// Unhit slots read back (-1, -1, +0.0).
//
// Two entries:
//
// - merge_place, on the main path. It takes the two runs where they lie and
//   relies on what merge_positions guarantees (and the TPU kernel's band
//   skip uses): within each run the ranks are nondecreasing, those below cap
//   strictly increasing (keys are unique), and every rank >= cap lies in
//   the run's tail. So each slot is hit by at most one row of each run, and
//   the rows that land in a tile of slots are a contiguous stretch of each
//   run. The design is output-stationary: a block owns TILE slots. It
//   brackets each run's first row of rank >= its first slot to within
//   SLACK rows by a 256-way search (two rounds at the main path's sizes;
//   the first round's probes are the same rows for every block), stages
//   the at most TILE + SLACK rows after the bracket's start in shared
//   memory by slot, and writes each of its slots exactly once. No atomics,
//   no fill of the outputs, and the tails' dropped rows are never read
//   beyond one tile's window.
// - merge_scatter, the generic scatter for arbitrary positions (the
//   function of scatter_combine_pallas; on no path). One thread per row, one
//   atomicMax per key and one atomicAdd per weight into outputs the wrapper
//   pre-fills. Every slot is hit by at most one state row and one equal-key
//   chunk row, and float addition of two values commutes, so the result is
//   bitwise equal to the plain version whatever order the atomics land in.
//
// Bound: bytes. Rows are read once (16 bytes) and the cap slots written once
// (12 bytes), with one add per slot.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 512;     // output slots a merge_place block owns
constexpr int THREADS = 256;  // each thread probes one row of each run a round
constexpr int SLACK = 256;    // the search stops at a stretch this short
constexpr int WINDOW = (TILE + SLACK + THREADS - 1) / THREADS;  // rows a thread stages per run
constexpr unsigned FULL = 0xffffffffu;

// The search in one run: the first row of rank >= t0 lies in [lo, hi]. A
// round probes THREADS evenly spaced rows and keeps the stretch between the
// last probe below t0 and the first at or above it.
struct Bracket {
  int lo, hi, step;
  // This thread's probe: 1 if it lies below t0 (the probes below t0 are a
  // prefix of the probes).
  __device__ unsigned probe(const int* __restrict__ pos, int t0) {
    step = (hi - lo + THREADS - 1) / THREADS;
    const long long q = lo + (long long)(threadIdx.x + 1) * step - 1;
    return step > 0 && q < hi && pos[q] < t0;
  }
  // Narrow to the stretch after the block's `below` probes below t0.
  __device__ void narrow(int below) {
    if (step > 0) {
      hi = (int)min((long long)hi, lo + (long long)(below + 1) * step - 1);
      lo += below * step;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
merge_place_kernel(const int* __restrict__ pos_s, const int* __restrict__ sa,
                   const int* __restrict__ sb, const float* __restrict__ sw,
                   int ns, const int* __restrict__ pos_c,
                   const int* __restrict__ ca, const int* __restrict__ cb,
                   const float* __restrict__ cw, int nc, int cap,
                   int* __restrict__ oa, int* __restrict__ ob,
                   float* __restrict__ ow) {
  __shared__ int key_a[2][TILE], key_b[2][TILE];
  __shared__ float wt[2][TILE];
  __shared__ unsigned below[THREADS / 32];
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, cap);
  for (int s = threadIdx.x; s < TILE; s += THREADS) {
    key_a[0][s] = key_a[1][s] = -1;
    key_b[0][s] = key_b[1][s] = -1;
    wt[0][s] = wt[1][s] = -0.0f;  // x + (-0.0) == x for every x
  }
  // Every thread keeps both brackets; the block-wide counts keep them equal.
  Bracket st{0, ns, 0}, ch{0, nc, 0};
  while (st.hi - st.lo > SLACK || ch.hi - ch.lo > SLACK) {
    const unsigned packed =
        __reduce_add_sync(FULL, st.probe(pos_s, t0) | ch.probe(pos_c, t0) << 16);
    if ((threadIdx.x & 31) == 0) below[threadIdx.x >> 5] = packed;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += below[i];
    __syncthreads();  // below is rewritten next round
    st.narrow(total & 0xffff);
    ch.narrow(total >> 16);
  }
  // The rows ranked in [t0, t1) lie in [lo, hi + TILE) of each run: stage
  // them by slot. Loads are unconditional, so they are all in flight at once.
#pragma unroll
  for (int r = 0; r < WINDOW; ++r) {
    const int j = threadIdx.x + r * THREADS;
    const int is = st.lo + j, ic = ch.lo + j;
    if (is < ns && j < st.hi - st.lo + TILE) {
      const int p = pos_s[is], a = sa[is], b = sb[is];
      const float w = sw[is];
      if (p >= t0 && p < t1) {
        key_a[0][p - t0] = max(a, -1);
        key_b[0][p - t0] = max(b, -1);
        wt[0][p - t0] = w;
      }
    }
    if (ic < nc && j < ch.hi - ch.lo + TILE) {
      const int p = pos_c[ic], a = ca[ic], b = cb[ic];
      const float w = cw[ic];
      if (p >= t0 && p < t1) {
        key_a[1][p - t0] = max(a, -1);
        key_b[1][p - t0] = max(b, -1);
        wt[1][p - t0] = w;
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; t0 + s < t1; s += THREADS) {
    oa[t0 + s] = max(key_a[0][s], key_a[1][s]);
    ob[t0 + s] = max(key_b[0][s], key_b[1][s]);
    ow[t0 + s] = __fadd_rn(__fadd_rn(0.0f, wt[0][s]), wt[1][s]);
  }
}

__global__ void merge_scatter_kernel(const int* __restrict__ pos,
                                     const int* __restrict__ a,
                                     const int* __restrict__ b,
                                     const float* __restrict__ w,
                                     long long n, int cap,
                                     int* __restrict__ oa,
                                     int* __restrict__ ob,
                                     float* __restrict__ ow) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int p = pos[i];
  if (p < 0 || p >= cap) return;  // sentinel and overflow rows are dropped
  atomicMax(oa + p, a[i]);
  atomicMax(ob + p, b[i]);
  atomicAdd(ow + p, w[i]);
}

}  // namespace

// Writes every slot of oa, ob, ow [cap]; needs no fill.
extern "C" int merge_place(const void* pos_s, const void* sa, const void* sb,
                           const void* sw, int ns, const void* pos_c,
                           const void* ca, const void* cb, const void* cw,
                           int nc, int cap, void* oa, void* ob, void* ow,
                           void* stream) {
  if (cap > 0) {
    merge_place_kernel<<<(cap + TILE - 1) / TILE, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int*)pos_s, (const int*)sa, (const int*)sb, (const float*)sw,
        ns, (const int*)pos_c, (const int*)ca, (const int*)cb,
        (const float*)cw, nc, cap, (int*)oa, (int*)ob, (float*)ow);
  }
  return (int)cudaGetLastError();
}

// Combines into oa, ob, ow [cap], which the caller fills with -1, -1, 0.
extern "C" int merge_scatter(const void* pos, const void* a, const void* b,
                             const void* w, long long n, int cap, void* oa,
                             void* ob, void* ow, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    merge_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const int*)a, (const int*)b, (const float*)w, n, cap,
        (int*)oa, (int*)ob, (float*)ow);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* merge_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
