// K7 segment_sum: out[s, c] = sum of data[r, c] over the rows r with
// seg[r] == s.
//
// Replaces the TPU kernel src/repro/kernels/segment/seg_matmul.py
// (segment_sum_pallas), a one-hot matrix product that streams every data
// block once per output tile. Two families of entries:
//   - segment_sum, a warp per segment with the segment's bounds searched
//     at every launch: the grid repulsion's cell statistics
//     (kernels/grid/ops.py cell_stats), E = n nodes, D = 3 columns
//     [m x, m y, m], N = G^2 = 4,096 long segments, ids already in
//     cell-sorted order. Described first, below.
//   - The layout entries, for many short segments whose ids stay fixed
//     across launches: segment_offsets builds a segment layout once,
//     segment_sum_layout (the per-edge sums and the GNN gathers'
//     gradients) and attraction_sum (FA2's attraction, fused) sum through
//     it. Described further down, above their kernels.
//
// Why the sum is not a tree: the plain version (kernels/segment/ref.py) is
// an index_add_ that, on the CPU, adds each row into its segment in row
// order, one rounding per row. The kernel must give those bits, so every
// (segment, column) sum is the same chain of round-to-nearest adds, from
// +0, in row order. A tree, a warp shuffle reduction or float atomics
// would add in another order and round differently. Two launches on the
// same input give the same bits.
//
// Bound: bytes on paper (each row's D floats and its id read once, each
// output written once: E (4 D + 4) + 4 N D bytes), latency in practice:
// the largest segment's chain of dependent adds (1,225 rows in the full
// layout's densest cell) sets the kernel's time. The design keeps that
// chain fed from shared memory and spreads every other segment over the
// card:
//   - One warp per segment, WARPS segments a block: N / WARPS blocks, so
//     no segment waits behind another's chain.
//   - The warp finds its segment's bounds once, lanes 0-15 the lower bound
//     of s and lanes 16-31 that of s + 1, each a 16-way search over the
//     sorted ids (five steps of one load per lane at E = 685,230).
//     Negative ids sort first and ids >= N (the trash tail) last, so they
//     fall outside every segment and are dropped.
//   - A segment's rows are one contiguous span of (hi - lo) D floats. The
//     warp copies it into shared memory CHUNK floats at a time with
//     coalesced loads, the next chunk's loads in flight while lane c adds
//     column c (c + 32, ... in further passes when D > 32) over the staged
//     rows of the current one.
//   - The adds are the kernel's critical path: lane c reads its column
//     BATCH rows at a time, the next batch's loads issued before the
//     current batch's adds, so the chain waits only on itself. D = 3, the
//     cell statistics' width, is a compile-time stride (the loads take
//     immediate offsets); any other D takes the same code with a runtime
//     stride.
//   - Empty segments write 0. Unsorted ids are stably sorted by the
//     wrapper first, which keeps each segment's rows in their order.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;               // segments (warps) per block
constexpr int PER_LANE = 32;           // floats a lane stages per chunk
constexpr int BATCH = 16;              // staged floats a lane reads at once
constexpr int CHUNK = 32 * PER_LANE;   // floats staged per chunk and warp
constexpr unsigned ALL = 0xffffffffu;

// Lower bounds of s (returned in .x) and s + 1 (.y) in the sorted ids
// seg[0, e), e < 2^31: lanes 0-15 search for s, lanes 16-31 for s + 1.
// Each step probes lo + l * step (l = 0..15) in [lo, hi) and keeps the gap
// between the last probe below the key and the first at or above it.
__device__ int2 segment_bounds(const int* __restrict__ seg, unsigned e, int s,
                               int lane) {
  const int half = lane >> 4;
  const unsigned mine = half ? 0xffff0000u : 0x0000ffffu;
  const int key = s + half;
  const unsigned l = lane & 15;
  unsigned lo = 0, hi = e;  // lower bound in [lo, hi]
  while (__any_sync(ALL, lo < hi)) {
    const unsigned step = (hi - lo + 15) / 16;
    const unsigned p = lo + l * step;
    const bool probe = lo < hi && p < hi;
    const unsigned below = __ballot_sync(ALL, probe && seg[p] < key) & mine;
    const unsigned probes = __ballot_sync(ALL, probe) & mine;
    if (lo < hi) {
      const unsigned c = __popc(below);
      const unsigned nlo = c == 0 ? lo : lo + (c - 1) * step + 1;
      hi = c < (unsigned)__popc(probes) ? lo + c * step : hi;
      lo = nlo;
    }
  }
  return make_int2((int)__shfl_sync(ALL, lo, 0), (int)__shfl_sync(ALL, lo, 16));
}

// acc + sh[0] + sh[stride] + ... over the n staged elements of one
// column, in order, one round-to-nearest add each. The loads of the next
// BATCH elements are issued before the adds of the current ones, so the
// chain of adds waits on nothing but itself.
template <int D>
__device__ __forceinline__ float add_column(float acc, const float* sh, int n, int d) {
  const int stride = D ? D : d;
  int i = 0;
  if (n >= BATCH) {
    float cur[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) cur[u] = sh[u * stride];
    for (; i + 2 * BATCH <= n; i += BATCH) {
      float next[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) next[u] = sh[(i + BATCH + u) * stride];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        acc = __fadd_rn(acc, cur[u]);
        cur[u] = next[u];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) acc = __fadd_rn(acc, cur[u]);
    i += BATCH;
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, sh[i * stride]);
  return acc;
}

// D > 0: rows of D columns, a compile-time stride; D = 0: any d.
template <int D>
__global__ void __launch_bounds__(32 * WARPS)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                   unsigned e, int d, int n_segments, float* __restrict__ out) {
  __shared__ float staged[WARPS][CHUNK];
  if (D) d = D;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = blockIdx.x * WARPS + w;
  if (s >= n_segments) return;  // warp-uniform: no block barrier below
  const int2 b = segment_bounds(seg, e, s, lane);
  float* sh = staged[w];
  const long long len = (long long)(b.y - b.x) * d;  // floats in the span
  const float* span = data + (long long)b.x * d;
  for (int c0 = 0; c0 < d; c0 += 32) {  // one pass per 32 columns
    const int c = c0 + lane;
    float acc = 0.f;
    float v[PER_LANE];
#pragma unroll
    for (int m = 0; m < PER_LANE; ++m) {
      const long long f = lane + 32 * m;
      v[m] = f < len ? span[f] : 0.f;
    }
    for (long long f0 = 0; f0 < len; f0 += CHUNK) {
      __syncwarp();  // every lane is done with the previous chunk
#pragma unroll
      for (int m = 0; m < PER_LANE; ++m) sh[lane + 32 * m] = v[m];
      __syncwarp();
      const long long f1 = f0 + CHUNK;
      if (f1 < len) {  // the next chunk's loads fly during the adds
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          const long long f = f1 + lane + 32 * m;
          v[m] = f < len ? span[f] : 0.f;
        }
      }
      if (c < d) {
        // Column c's elements in this chunk: the first at or after f0,
        // then every d-th, below the chunk's end.
        const int first = (int)((c - f0 % d + d) % d);
        const int end = (int)(len - f0 < CHUNK ? len - f0 : CHUNK);
        const int count = first < end ? (int)(((long long)end - first + d - 1) / d) : 0;
        acc = add_column<D>(acc, sh + first, count, d);
      }
    }
    if (c < d) out[(long long)s * d + c] = acc;
  }
}


// ---------------------------------------------------------------------------
// The layout entries: many short segments (FA2's attraction, 13.2 M rows
// into 685,230 segments of about 19; a GNN's message sums, 61.9 M rows of
// 64 floats into 2.45 M segments of about 25), ids fixed for many launches.
//
// A segment layout is built once for an id array: perm, the stable order
// of the rows by id (a library sort in the wrapper; absent when the ids
// are already sorted), and offsets [N + 1], offsets[s] the first sorted
// row whose id is >= s (segment_offsets: each sorted row writes every
// boundary between its id and its predecessor's). Ids < 0 sort
// first and ids >= N last, so they fall outside every
// [offsets[s], offsets[s + 1]) and are dropped. No launch searches, sorts
// or copies the data: segment s adds data[perm[r]] for r in
// [offsets[s], offsets[s + 1]), in that order, from +0, one __fadd_rn a
// row, which is the CPU index_add_'s order and rounding. Two launches on
// the same input give the same bits.
//
// Bound: bytes, E (4 D + 4) + 4 (N + 1) + 4 N D (each row, its perm entry,
// the offsets and the output once), 4.99 ms at the GNN's shape at
// 3.35 TB/s; the attraction E 8 + 20 N (dst and w a row; an offset, the
// segment's position and its output a segment; pos, 5.5 MB, stays in L2).
// Mappings:
//   - Wide rows (D = 1 or D > 4; the GNN's 64): a warp a segment, lane l
//     adding columns 2 l and 2 l + 1 of each 64-column pass: one float2
//     load a row where D is even and the rows 8-byte aligned (a row of 64
//     is one 256-byte load), two guarded loads otherwise. The warp reads 32
//     perm entries with one load and broadcasts them; UW rows' loads are in
//     flight before their adds.
//   - Narrow rows (D = 2 to 4; the attraction's 2): a thread a segment, a
//     warp one group of the layout (the wrapper's segment_groups): a block
//     of 32 consecutive segments, or, in a block of more than SPLIT_ROWS
//     rows, the segments whose first rows lie in one window of GROUP_ROWS
//     sorted rows. A warp adds its segments' chains side by side only
//     within a chunk of its span, so a block of long segments (a
//     supergraph's large communities) would add them one after another;
//     split, they go to warps of their own and run at once. The warp walks
//     its span SPAN rows at a time, its lanes reading a chunk's rows
//     lane-strided in two stages: the
//     indices (perm or dst) and w, coalesced, then the values they point
//     to, each lane's gathers independent of each other. The lanes form
//     each row's D staged floats and store them in shared memory; then
//     each lane adds its own segment's staged rows of the chunk, NB at a
//     time, the next NB rows' loads issued before the current ones' adds.
//     During those adds the next chunk's gathers and the chunk after it's
//     index loads are in flight, so the chain of dependent adds, the only
//     serial part, waits on a chunk's loads, never on a row's: a 2,073-row
//     segment (the main path's largest) costs about 9 chunks' round trips
//     and 2,073 add latencies, not 2,073 round trips.
//   - attraction_sum is the narrow mapping whose loaded row is
//     (pos[dst] x, pos[dst] y, w). The staging lane finds the row's segment
//     among the warp's (a 5-step search over the lanes' first rows, by
//     shuffles) and takes that segment's position from its lane, then forms
//     the term w (pos[dst] - pos[s]) with __fsub_rn and __fmul_rn, the
//     roundings of the CPU form w[:, None] * (pos_ext[d] - pos_ext[s]); the
//     [E, 2] tensor of terms is never written to device memory. dst >= N
//     reads the zero row, dst < 0 row 0, as clamp(0, N) does.
//   - attraction_sum takes the layout's type (FA2Config.dtype): pos, w and
//     out float32, bfloat16 or float16, all of one type. pos and w are
//     read in that type and widened in registers; the terms are formed and
//     summed in float32 exactly as for a float32 layout, and each node's
//     sum is rounded once to the type on its store. The plain version
//     widens, forms, sums and rounds the same way, so the two agree
//     bitwise in every type.
//   - Empty segments write 0.

// The layout's element types: a read-only load widened to float32, and a
// float32 rounded to nearest even on its store.
__device__ __forceinline__ float load_wide(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_wide(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float load_wide(const __half* p) {
  return __half2float(__ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store_narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_narrow(__half* p, float x) { *p = __float2half_rn(x); }

constexpr int LW = 8;                 // warps a block, wide layout entries
constexpr int NLW = 4;                // warps a block, narrow layout entries
constexpr int SPAN = 256;             // rows a warp stages at a time (narrow)
constexpr int SPAN_PER_LANE = SPAN / 32;
constexpr int NB = 8;                 // staged rows a lane reads at once (narrow)
constexpr int UW = 8;                 // rows whose loads fly at once (wide)
constexpr int OFF_ROWS = 4;           // sorted rows a thread of segment_offsets takes

// offsets[s] = the first row r of the sorted ids sid[0, e) with
// sid[r] >= s, for s in [0, n]. Row r (0 <= r <= e) owns every s in
// (sid[r - 1], sid[r]] clipped to [0, n], with sid[-1] read as -1 and
// sid[e] as n: each s has exactly one owner. A thread takes OFF_ROWS
// consecutive rows (one 16-byte load where sid is 16-byte aligned); a
// row's owned range is written by its thread when it is short, and by its
// whole warp when it spans 32 or more segments (a run of empty segments,
// such as a padded tail), so no thread writes a long run alone.
__global__ void segment_offsets_kernel(const int* __restrict__ sid, long long e, int n,
                                       int* __restrict__ offsets) {
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * OFF_ROWS;
  int v[OFF_ROWS];  // sid[r0 + k]; n at and past the end
  if (r0 + OFF_ROWS <= e && (reinterpret_cast<uintptr_t>(sid) & 15) == 0) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(sid + r0));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < OFF_ROWS; ++k) v[k] = r0 + k < e ? __ldg(sid + r0 + k) : n;
  }
  // Rows past e own nothing: their predecessor reads as n.
  long long prev = r0 == 0 ? -1 : (r0 <= e ? (long long)__ldg(sid + r0 - 1) : (long long)n);
#pragma unroll
  for (int k = 0; k < OFF_ROWS; ++k) {
    const long long cur = v[k];
    const long long lo = prev + 1 > 0 ? prev + 1 : 0;
    const long long hi = cur < n ? cur : n;
    prev = cur;
    const int r = (int)(r0 + k);
    const bool wide = hi - lo >= 32;
    if (!wide) {
      for (long long s = lo; s <= hi; ++s) offsets[s] = r;
    }
    for (unsigned m = __ballot_sync(ALL, wide); m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      const long long a = __shfl_sync(ALL, lo, l);
      const long long b = __shfl_sync(ALL, hi, l);
      const int owner = __shfl_sync(ALL, r, l);
      for (long long s = a + lane; s <= b; s += 32) offsets[s] = owner;
    }
  }
}

// A narrow row family, loaded in two stages a chunk ahead of each other:
// index() reads row r's index and one float beside it (coalesced: the
// rows are consecutive), gather() reads the W values it points to, and
// stage() (called by every lane of the warp together) turns them into the
// D floats that are added. begin() sets the lane's own segment.

// The per-edge sum: D floats of data[perm[r]] (data[r] when the ids were
// sorted, perm null), added as they are.
template <int D_>
struct EdgeRows {
  static constexpr int W = D_;
  static constexpr int D = D_;
  using Out = float;
  const float* data;
  const int* perm;
  __device__ __forceinline__ void begin(int, bool, int) {}
  __device__ __forceinline__ int index(long long r, float& aux) const {
    aux = 0.f;
    return perm ? __ldg(perm + r) : (int)r;
  }
  __device__ __forceinline__ void gather(int i, float, float* v) const {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = __ldg(data + (long long)i * D + k);
  }
  __device__ __forceinline__ void stage(long long, const float* v, float* t) const {
#pragma unroll
    for (int k = 0; k < D; ++k) t[k] = v[k];
  }
};

// FA2's attraction: the row (pos[dst] x, pos[dst] y, w) staged as the term
// w (pos[dst] - pos[s]); pos, w and the output in the layout's type T,
// widened on load.
template <class T>
struct AttractionRows {
  static constexpr int W = 3;
  static constexpr int D = 2;
  using Out = T;
  const T* pos;
  const int* dst;
  const T* w;
  int n;
  float px, py;  // this lane's segment's position
  int first;     // this lane's segment's first row
  __device__ __forceinline__ void begin(int s, bool live, int lo) {
    px = live ? load_wide(pos + 2LL * s) : 0.f;
    py = live ? load_wide(pos + 2LL * s + 1) : 0.f;
    first = lo;
  }
  __device__ __forceinline__ int index(long long r, float& aux) const {
    aux = load_wide(w + r);
    return __ldg(dst + r);
  }
  __device__ __forceinline__ void gather(int d, float aux, float* v) const {
    const long long i = d < 0 ? 0 : d;
    v[0] = d >= n ? 0.f : load_wide(pos + 2 * i);
    v[1] = d >= n ? 0.f : load_wide(pos + 2 * i + 1);
    v[2] = aux;
  }
  // Row r's segment is that of the last lane whose first row is <= r (the
  // lanes' first rows ascend; dead lanes hold the span's end).
  __device__ __forceinline__ void stage(long long r, const float* v, float* t) const {
    int k = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if ((long long)__shfl_sync(ALL, first, k + step) <= r) k += step;
    }
    const float sx = __shfl_sync(ALL, px, k);
    const float sy = __shfl_sync(ALL, py, k);
    t[0] = __fmul_rn(v[2], __fsub_rn(v[0], sx));
    t[1] = __fmul_rn(v[2], __fsub_rn(v[1], sy));
  }
};

// Lane `lane`'s SPAN_PER_LANE rows of the chunk starting at row c are
// rows c + lane + 32 m (each load instruction of the warp reads 32
// consecutive rows). Their indices and side floats:
template <class Rows>
__device__ __forceinline__ void index_chunk(const Rows& rows, long long c, long long end,
                                            int lane, int (&ix)[SPAN_PER_LANE],
                                            float (&ax)[SPAN_PER_LANE]) {
#pragma unroll
  for (int m = 0; m < SPAN_PER_LANE; ++m) {
    const long long r = c + lane + 32 * m;
    if (r < end) {
      ix[m] = rows.index(r, ax[m]);
    } else {
      ix[m] = 0;
      ax[m] = 0.f;
    }
  }
}

// ... and the values their indices point to (zeros past the span's end).
template <class Rows>
__device__ __forceinline__ void gather_chunk(const Rows& rows, long long c, long long end,
                                             int lane, const int (&ix)[SPAN_PER_LANE],
                                             const float (&ax)[SPAN_PER_LANE],
                                             float (&v)[SPAN_PER_LANE][Rows::W]) {
#pragma unroll
  for (int m = 0; m < SPAN_PER_LANE; ++m) {
    if (c + lane + 32 * m < end) {
      rows.gather(ix[m], ax[m], v[m]);
    } else {
#pragma unroll
      for (int k = 0; k < Rows::W; ++k) v[m][k] = 0.f;
    }
  }
}

// acc += sh[k][i] over the staged rows i in [i0, i1), in order, the next
// NB rows' loads issued before the current NB rows' adds.
template <int D>
__device__ __forceinline__ void add_staged(float (&acc)[D], float (*sh)[SPAN], int i0, int i1) {
  int i = i0;
  if (i1 - i0 >= NB) {
    float cur[NB][D];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
#pragma unroll
      for (int k = 0; k < D; ++k) cur[u][k] = sh[k][i + u];
    }
    for (; i + 2 * NB <= i1; i += NB) {
      float next[NB][D];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
#pragma unroll
        for (int k = 0; k < D; ++k) next[u][k] = sh[k][i + NB + u];
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          acc[k] = __fadd_rn(acc[k], cur[u][k]);
          cur[u][k] = next[u][k];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = __fadd_rn(acc[k], cur[u][k]);
    }
    i += NB;
  }
  for (; i < i1; ++i) {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = __fadd_rn(acc[k], sh[k][i]);
  }
}

// Narrow rows: a thread a segment, a warp the segments [s0, s1) of one
// group of the layout (groups[g], groups[g + 1]; at most 32 segments).
// While a chunk's staged rows are added, the next chunk's gathers and the
// chunk after it's index loads are in flight.
template <class Rows>
__global__ void __launch_bounds__(32 * NLW)
narrow_kernel(Rows rows, const int* __restrict__ offsets, const int* __restrict__ groups,
              int n_groups, typename Rows::Out* __restrict__ out) {
  constexpr int D = Rows::D;
  __shared__ float staged[NLW][D][SPAN];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * NLW + w;
  if (g >= n_groups) return;  // warp-uniform: no block barrier below
  const int s0 = groups[g];
  const int s1 = groups[g + 1];
  if (s0 >= s1) return;  // the bound's unused groups
  const int s = s0 + lane;
  const bool live = s < s1;
  const int span_hi = offsets[s1];
  const int lo = live ? offsets[s] : span_hi;
  const int hi = live ? offsets[s + 1] : span_hi;
  const int span_lo = __shfl_sync(ALL, lo, 0);
  rows.begin(s, live, lo);
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;
  float (*sh)[SPAN] = staged[w];
  int ix[SPAN_PER_LANE];
  float ax[SPAN_PER_LANE];
  float v[SPAN_PER_LANE][Rows::W];
  index_chunk(rows, span_lo, span_hi, lane, ix, ax);
  gather_chunk(rows, span_lo, span_hi, lane, ix, ax, v);
  index_chunk(rows, (long long)span_lo + SPAN, span_hi, lane, ix, ax);
  for (long long c = span_lo; c < span_hi; c += SPAN) {
    __syncwarp();  // every lane is done with the previous chunk
#pragma unroll
    for (int m = 0; m < SPAN_PER_LANE; ++m) {
      float t[D];
      rows.stage(c + lane + 32 * m, v[m], t);
#pragma unroll
      for (int k = 0; k < D; ++k) sh[k][lane + 32 * m] = t[k];
    }
    __syncwarp();
    if (c + SPAN < span_hi) {
      gather_chunk(rows, c + SPAN, span_hi, lane, ix, ax, v);
      if (c + 2 * SPAN < span_hi) index_chunk(rows, c + 2 * SPAN, span_hi, lane, ix, ax);
    }
    const int i0 = (int)((lo > c ? lo : c) - c);
    const int i1 = (int)((hi < c + SPAN ? hi : c + SPAN) - c);
    add_staged<D>(acc, sh, i0, i1);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < D; ++k) store_narrow(out + (long long)s * D + k, acc[k]);
  }
}

// Wide rows: a warp a segment, lane l adding columns c = 2 l + 64 p and
// c + 1 of pass p: one float2 load a row where `pair` (D even, rows 8-byte
// aligned), two guarded loads otherwise (odd D, a misaligned view, D = 1).
__global__ void __launch_bounds__(32 * LW)
wide_kernel(const float* __restrict__ data, const int* __restrict__ perm,
            const int* __restrict__ offsets, int d, int n, bool pair,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * LW + (threadIdx.x >> 5);
  if (s >= n) return;  // warp-uniform
  const int lo = offsets[s];
  const int hi = offsets[s + 1];
  for (int c0 = 0; c0 < d; c0 += 64) {
    const int c = c0 + 2 * lane;
    const bool on0 = c < d;
    const bool on1 = c + 1 < d;
    float acc0 = 0.f, acc1 = 0.f;
    for (int r = lo; r < hi; r += 32) {
      const int cnt = hi - r < 32 ? hi - r : 32;
      const int mine = lane < cnt ? (perm ? __ldg(perm + r + lane) : r + lane) : 0;
      for (int j = 0; j < cnt; j += UW) {  // j + u <= 31 below
        float v0[UW], v1[UW];
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          const int i = __shfl_sync(ALL, mine, j + u);
          const float* row = data + (long long)i * d + c;
          const bool live = j + u < cnt;
          if (pair) {
            const float2 x = live && on0 ? __ldg(reinterpret_cast<const float2*>(row))
                                         : make_float2(0.f, 0.f);
            v0[u] = x.x;
            v1[u] = x.y;
          } else {
            v0[u] = live && on0 ? __ldg(row) : 0.f;
            v1[u] = live && on1 ? __ldg(row + 1) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          if (j + u < cnt) {
            acc0 = __fadd_rn(acc0, v0[u]);
            acc1 = __fadd_rn(acc1, v1[u]);
          }
        }
      }
    }
    if (on0) out[s * d + c] = acc0;
    if (on1) out[s * d + c + 1] = acc1;
  }
}

template <int D>
void launch_narrow_edges(const float* data, const int* perm, const int* offsets,
                         const int* groups, int n_groups, float* out, cudaStream_t stream) {
  const long long blocks = ((long long)n_groups + NLW - 1) / NLW;
  narrow_kernel<EdgeRows<D>><<<(unsigned)blocks, 32 * NLW, 0, stream>>>(
      EdgeRows<D>{data, perm}, offsets, groups, n_groups, out);
}

template <class T>
void launch_attraction(const void* pos, const int* dst, const void* w, const int* offsets,
                       const int* groups, int n_groups, int n, void* out,
                       cudaStream_t stream) {
  const long long blocks = ((long long)n_groups + NLW - 1) / NLW;
  AttractionRows<T> rows{static_cast<const T*>(pos), dst, static_cast<const T*>(w), n,
                         0.f, 0.f, 0};
  narrow_kernel<AttractionRows<T>><<<(unsigned)blocks, 32 * NLW, 0, stream>>>(
      rows, offsets, groups, n_groups, static_cast<T*>(out));
}

}  // namespace

extern "C" int segment_sum(const void* data, const void* seg, long long e, int d,
                           int n_segments, void* out, void* stream) {
  if (e < 0 || e >= (1LL << 31) || d < 0 || n_segments < 0)
    return (int)cudaErrorInvalidValue;
  if (n_segments > 0 && d > 0) {
    const int blocks = (n_segments + WARPS - 1) / WARPS;
    const auto x = static_cast<const float*>(data);
    const auto ids = static_cast<const int*>(seg);
    const auto o = static_cast<float*>(out);
    if (d == 3) {  // the grid repulsion's cell statistics [m x, m y, m]
      segment_sum_kernel<3><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
          x, ids, (unsigned)e, d, n_segments, o);
    } else {
      segment_sum_kernel<0><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
          x, ids, (unsigned)e, d, n_segments, o);
    }
  }
  return (int)cudaGetLastError();
}

// The layout's offsets from the sorted ids sid[0, e): offsets[n + 1].
extern "C" int segment_offsets(const void* sid, long long e, int n, void* offsets,
                               void* stream) {
  if (e < 0 || e >= (1LL << 31) || n < 0 || n == 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const long long threads = e / OFF_ROWS + 1;  // rows 0 .. e, OFF_ROWS a thread
  segment_offsets_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(sid), e, n, static_cast<int*>(offsets));
  return (int)cudaGetLastError();
}

// out[s, :] = sum of data[perm[r], :] (data[r, :] with perm null) over r in
// [offsets[s], offsets[s + 1]), for data [e, d] and out [n, d]; groups
// [n_groups + 1] splits the segments into runs of at most 32 (unused
// trailing groups empty), the narrow rows' warps.
extern "C" int segment_sum_layout(const void* data, const void* perm, const void* offsets,
                                  const void* groups, int n_groups, long long e, int d, int n,
                                  void* out, void* stream) {
  if (e < 0 || e >= (1LL << 31) || d < 0 || n < 0 || n == 0x7fffffff || n_groups < 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && d > 0) {
    const auto x = static_cast<const float*>(data);
    const auto p = static_cast<const int*>(perm);
    const auto off = static_cast<const int*>(offsets);
    const auto gr = static_cast<const int*>(groups);
    const auto o = static_cast<float*>(out);
    const auto st = (cudaStream_t)stream;
    switch (d) {
      case 2: launch_narrow_edges<2>(x, p, off, gr, n_groups, o, st); break;
      case 3: launch_narrow_edges<3>(x, p, off, gr, n_groups, o, st); break;
      case 4: launch_narrow_edges<4>(x, p, off, gr, n_groups, o, st); break;
      default: {
        const long long blocks = ((long long)n + LW - 1) / LW;
        const bool pair = d % 2 == 0 && reinterpret_cast<uintptr_t>(data) % 8 == 0;
        wide_kernel<<<(unsigned)blocks, 32 * LW, 0, st>>>(x, p, off, d, n, pair, o);
      }
    }
  }
  return (int)cudaGetLastError();
}

// FA2's attraction: out[s] = sum over r in [offsets[s], offsets[s + 1]) of
// w[r] (pos_ext[dst[r]] - pos[s]), pos [n, 2], pos_ext pos with a zero row
// n and dst clamped into [0, n]; groups as for segment_sum_layout. pos, w
// and out of type `type` (0 float32, 1 bfloat16, 2 float16).
extern "C" int attraction_sum(const void* pos, const void* dst, const void* w,
                              const void* offsets, const void* groups, int n_groups, int n,
                              int type, void* out, void* stream) {
  if (n < 0 || n == 0x7fffffff || n_groups < 0 || type < 0 || type > 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && n_groups > 0) {
    const auto off = static_cast<const int*>(offsets);
    const auto gr = static_cast<const int*>(groups);
    const auto d = static_cast<const int*>(dst);
    const auto st = (cudaStream_t)stream;
    if (type == 0)
      launch_attraction<float>(pos, d, w, off, gr, n_groups, n, out, st);
    else if (type == 1)
      launch_attraction<__nv_bfloat16>(pos, d, w, off, gr, n_groups, n, out, st);
    else
      launch_attraction<__half>(pos, d, w, off, gr, n_groups, n, out, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
