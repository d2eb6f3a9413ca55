// Staging of contiguous rows in shared memory, for the kernels that give one
// thread to a row (lp_gain.cu, contract_edges.cu).
//
// A block's rows [row0, row0 + nrow) of a row-major [*, D] array are one
// contiguous run of nrow * D elements. The block copies that run with
// coalesced asynchronous copies (consecutive threads on consecutive
// elements, all of a thread's copies in flight together) to r * P + j in
// shared memory for element (r, j). With an odd pitch P, a walk in which
// every thread reads slot j of its own row touches 32 distinct banks.
#pragma once
#include <cuda_runtime.h>

namespace rows {

// The odd pitch of a staged row of D elements.
__host__ __device__ inline int pitch(int D) { return D | 1; }

// e / d by one multiply and shift, exact for 0 <= e < n * d whenever
// n * d * d <= 2^20 and n <= 2^11: with m = ceil(2^20 / d) = 2^20 / d + x,
// 0 <= x < 1, e * m / 2^20 = e / d + e * x / 2^20, and e * x / 2^20 <
// n * d / 2^20 <= 1 / d, which cannot carry e / d past the next integer;
// e * m <= n * 2^20 + n * d stays below 2^32.
struct Div {
  unsigned m;
  __device__ explicit Div(int d) : m(((1u << 20) + (unsigned)d - 1u) / (unsigned)d) {}
  __device__ int operator()(int e) const { return (int)(((unsigned)e * m) >> 20); }
};

// One 4-byte asynchronous copy from device memory to shared memory
// (cp.async, sm_80+): the data does not pass through registers, so a thread
// has all of its copies in flight at once.
__device__ inline void copy_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Stage total = nrow * D elements of a and b (4-byte types), starting at
// element base, at pitch P: thread tid of the nthreads that take part copies
// elements tid, tid + nthreads, ..., and has every copy in flight before it
// waits for the first. Requires nrow * D * D <= 2^20 (see Div). The caller
// synchronises the threads that took part before they read.
template <typename A, typename B>
__device__ inline void stage(const A* __restrict__ a, const B* __restrict__ b,
                             A* sa, B* sb, long long base, int total, int D,
                             int P, int tid, int nthreads) {
  static_assert(sizeof(A) == 4 && sizeof(B) == 4, "4-byte elements");
  const Div div(D);
  for (int e = tid; e < total; e += nthreads) {
    const int s = e + div(e) * (P - D);
    copy_async4(sa + s, a + base + e);
    copy_async4(sb + s, b + base + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace rows
