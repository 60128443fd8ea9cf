// Exhaustive check of K6's inline divide, quotient() in
// src/repro_torch/csrc/near_field.cu, against the IEEE divide __fdiv_rn.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/quotient_check tools/quotient_check.cu && build/quotient_check
//
// near_field.cu takes quotient(a, b) in place of __fdiv_rn(a, b) only for
// a = +0 or 2^-60 <= a <= 2^60, and EPS2 <= b <= 2^60. On that range every
// step of quotient() (the estimate r0 of 1/b, e = 1 - b*r0, r1 = r0 + r0*e,
// q0 = a*r1, rem = a - b*q0, q = q0 + r1*rem) is a round-to-nearest
// operation on normal floats with a normal result, so scaling a by 2^i and
// b by 2^j scales every step exactly (r0 and r1 by 2^-j, q0 and q by
// 2^(i-j), rem by 2^i, e not at all), provided the estimate itself scales:
// rcp(b * 2^j) == rcp(b) * 2^-j. The correctly rounded quotient scales the
// same way. So quotient() is correctly rounded on the whole range if it is
// for every pair of significands a, b in [1, 2), and the estimate scales
// for every b in [1, 2) and every j with b * 2^j in [2^-14, 2^60]
// (EPS2 = 1e-4 > 2^-14). This program checks both, and the range's corners
// directly:
//   1. significands: all 2^46 pairs (a, b) in [1, 2)^2, quotient(a, b)
//      against __fdiv_rn(a, b), bitwise;
//   2. scaling: for all 2^23 b in [1, 2) and j = -14 .. 60, the estimate
//      of b * 2^j against the estimate of b times 2^-j, and quotient(a, b*2^j)
//      against __fdiv_rn for a = +0, 2^-60 and 2^60;
//   3. corners: a with exponent -60 or 59 against b with exponent -14
//      (b >= EPS2) or 59, 2^32 pairs of hashed significands each.
// It prints one line per check and exits 0 only if no pair differs.
#include <chrono>
#include <cstdio>

#include "../src/repro_torch/csrc/near_field.cu"

namespace {

constexpr unsigned ONE = 0x3f800000u;  // the bits of 1.0f
constexpr unsigned long long NONE = ~0ull;

__device__ float pow2(int e) { return __uint_as_float((unsigned)(127 + e) << 23); }

__device__ float estimate(float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}

__device__ void note(unsigned long long* bad, unsigned long long* first, unsigned long long n,
                     unsigned long long where) {
  if (n == 0) return;
  atomicAdd(bad, n);
  atomicCAS(first, NONE, where);
}

// Thread: one significand of b; a's significands [a_lo, a_lo + a_count).
__global__ void significands(unsigned a_lo, unsigned a_count, unsigned long long* bad,
                             unsigned long long* first) {
  const unsigned bm = blockIdx.x * blockDim.x + threadIdx.x;
  const float b = __uint_as_float(ONE | bm);
  unsigned long long miss = 0, where = NONE;
  for (unsigned k = 0; k < a_count; ++k) {
    const float a = __uint_as_float(ONE | (a_lo + k));
    if (__float_as_uint(quotient(a, b)) != __float_as_uint(__fdiv_rn(a, b))) {
      ++miss;
      where = (unsigned long long)(a_lo + k) << 32 | bm;
    }
  }
  note(bad, first, miss, where);
}

// Thread: one significand of b, every exponent j.
__global__ void scaling(unsigned long long* bad, unsigned long long* first,
                        unsigned long long* tested) {
  const unsigned bm = blockIdx.x * blockDim.x + threadIdx.x;
  const float b1 = __uint_as_float(ONE | bm);
  const float r1 = estimate(b1);
  const float as[3] = {0.f, 0x1p-60f, 0x1p60f};
  unsigned long long miss = 0, n = 0, where = NONE;
  for (int j = -14; j <= 60; ++j) {
    const float b = __fmul_rn(b1, pow2(j));
    if (b > 0x1p60f) continue;
    ++n;
    bool ok = __float_as_uint(estimate(b)) == __float_as_uint(__fmul_rn(r1, pow2(-j)));
    for (float a : as) {
      ok &= __float_as_uint(quotient(a, b)) == __float_as_uint(__fdiv_rn(a, b));
    }
    if (!ok) {
      ++miss;
      where = (unsigned long long)(unsigned)(j + 64) << 32 | bm;
    }
  }
  atomicAdd(tested, n);
  note(bad, first, miss, where);
}

__device__ unsigned mix(unsigned x) {  // a 32-bit integer hash
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// Thread t: `per` pairs of hashed significands at exponents (ea, eb).
__global__ void corners(int ea, int eb, unsigned per, unsigned long long* bad,
                        unsigned long long* first, unsigned long long* tested) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long miss = 0, n = 0, where = NONE;
  for (unsigned k = 0; k < per; ++k) {
    const unsigned h = mix(t * per + k + (unsigned)(ea * 977 + eb));
    const float a = __fmul_rn(__uint_as_float(ONE | (h & 0x7fffffu)), pow2(ea));
    const float b = __fmul_rn(__uint_as_float(ONE | (mix(h) & 0x7fffffu)), pow2(eb));
    if (b < EPS2) continue;
    ++n;
    if (__float_as_uint(quotient(a, b)) != __float_as_uint(__fdiv_rn(a, b))) {
      ++miss;
      where = (unsigned long long)__float_as_uint(a) << 32 | __float_as_uint(b);
    }
  }
  atomicAdd(tested, n);
  note(bad, first, miss, where);
}

bool ok(cudaError_t e) {
  if (e != cudaSuccess) std::printf("CUDA error: %s\n", cudaGetErrorString(e));
  return e == cudaSuccess;
}

}  // namespace

int main() {
  using clock = std::chrono::steady_clock;
  constexpr unsigned SIGNIFICANDS = 1u << 23, THREADS_PER_BLOCK = 256;
  constexpr unsigned BLOCKS = SIGNIFICANDS / THREADS_PER_BLOCK, A_STEP = 1u << 16;
  unsigned long long* d;  // mismatches, first mismatch, pairs tested
  if (!ok(cudaMalloc(&d, 3 * sizeof(unsigned long long)))) return 2;
  bool clean = true;
  const auto finish = [&](const char* name, unsigned long long pairs, clock::time_point t0) {
    unsigned long long h[3];
    if (!ok(cudaDeviceSynchronize()) || !ok(cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost)))
      return false;
    if (pairs == 0) pairs = h[2];
    const double s = std::chrono::duration<double>(clock::now() - t0).count();
    std::printf("{\"check\": \"%s\", \"tested\": %llu, \"mismatches\": %llu, "
                "\"first_mismatch\": \"0x%016llx\", \"seconds\": %.3f}\n",
                name, pairs, h[0], h[0] ? h[1] : 0ull, s);
    std::fflush(stdout);
    return h[0] == 0;
  };
  const auto reset = [&] {
    const unsigned long long h[3] = {0, NONE, 0};
    return ok(cudaMemcpy(d, h, sizeof h, cudaMemcpyHostToDevice));
  };

  if (!reset()) return 2;
  auto t0 = clock::now();
  for (unsigned a_lo = 0; a_lo < SIGNIFICANDS; a_lo += A_STEP) {
    significands<<<BLOCKS, THREADS_PER_BLOCK>>>(a_lo, A_STEP, d, d + 1);
  }
  clean &= finish("significands", (unsigned long long)SIGNIFICANDS * SIGNIFICANDS, t0);

  if (!reset()) return 2;
  t0 = clock::now();
  scaling<<<BLOCKS, THREADS_PER_BLOCK>>>(d, d + 1, d + 2);
  clean &= finish("scaling", 0, t0);

  const int eas[2] = {-60, 59}, ebs[2] = {-14, 59};
  for (int ea : eas) {
    for (int eb : ebs) {
      if (!reset()) return 2;
      t0 = clock::now();
      corners<<<BLOCKS, THREADS_PER_BLOCK>>>(ea, eb, 512, d, d + 1, d + 2);
      char name[64];
      std::snprintf(name, sizeof name, "corner a 2^%d b 2^%d", ea, eb);
      clean &= finish(name, 0, t0);
    }
  }
  cudaDeviceProp prop;
  if (!ok(cudaGetDeviceProperties(&prop, 0))) return 2;
  std::printf("%s: %s\n", prop.name, clean ? "quotient() == __fdiv_rn on every pair" : "MISMATCH");
  cudaFree(d);
  return clean ? 0 : 1;
}
