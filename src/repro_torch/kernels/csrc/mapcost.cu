// mapcost: J(C, D, Pi) = 1/2 * sum over the directed edge arrays of
// w_e * d(pe_u, pe_v), in one launch. The level of an edge is the number of
// group sizes g_below[i] at which pe_u / g and pe_v / g differ, and d =
// dvec[level - 1] (0 when the two PEs are equal). Padded edge slots carry
// weight 0.
//
// Replaces the TPU kernel src/repro/kernels/mapcost.py:mapcost_pallas
// (body _mapcost_kernel), which wrote one partial per edge tile for its
// wrapper to add.
//
// Rounding: the sum runs in another order than the reference's reduction,
// so the result agrees within a relative tolerance, not bitwise (exactly,
// when every partial sum is an integer below 2^24, as with unit weights).
// Its order is fixed by M alone: each thread adds its edges in grid-stride
// order, each block adds its threads by a fixed shuffle tree, and the last
// block to finish adds the blocks' partials in block order. So one input
// gives one J, run after run.
//
// Bound on the H100: bytes. Each edge reads rows, cols and ewgt (12 bytes)
// and two PE ids (random, but pe_of is 4 bytes per vertex and stays in L2 at
// the sizes the path uses; each id gathered costs its own sector). Design:
// - One edge a thread a step, consecutive threads on consecutive edges, so a
//   warp's PE-id gathers fall on few lines (the rows of consecutive edges are
//   equal or adjacent). Four edges a thread as 16-byte vectors, or four
//   coalesced edges a lane, did not pay on the main path's mapping on an H100.
// - A group index pe / g takes no integer division: q = the high 64 bits of
//   pe * floor(2^64 / g), then one correction step (exact for every 32-bit
//   pe and g >= 2; see Div64). An edge whose two PEs are equal skips the
//   levels (d = 0), which on a good mapping is most edges.
// - The blocks' partials meet in the same launch: a block writes its
//   partial, and the last block to arrive (a counter) adds them all and
//   halves the total into J.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

// floor(e / g) for 0 <= e < 2^32 and g >= 1, without a division: with
// m = floor(2^64 / g) for g >= 2, e * m / 2^64 > e / g - 2^-32, and a
// non-integer e / g lies at least 1/g > 2^-32 above floor(e / g), so
// q = floor(e * m / 2^64) is floor(e / g) or, when g divides e, one less;
// e - q * g >= g tells the two apart.
struct Div64 {
  unsigned long long m;
  unsigned g;
};

__device__ __forceinline__ unsigned div64(unsigned e, Div64 d) {
  if (d.g == 1u) return e;
  unsigned q = (unsigned)__umul64hi((unsigned long long)e, d.m);
  return q + (e - q * d.g >= d.g ? 1u : 0u);
}

__global__ void __launch_bounds__(kThreads)
mapcost_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
               const float* __restrict__ ewgt, const int* __restrict__ pe,
               const int* __restrict__ g_below, const float* __restrict__ dvec,
               float* __restrict__ scratch, unsigned* __restrict__ arrived,
               int M, int N, int l) {
  __shared__ Div64 s_div[kMaxLevels];
  __shared__ float s_d[kMaxLevels];
  __shared__ float s_sum[kThreads / 32];
  __shared__ bool s_last;
  if (threadIdx.x < l) {
    const unsigned g = (unsigned)max(g_below[threadIdx.x], 1);
    s_div[threadIdx.x] = Div64{g > 1u ? ~0ull / g + (~0ull % g == g - 1u ? 1ull : 0ull) : 0ull, g};
    s_d[threadIdx.x] = dvec[threadIdx.x];
  }
  __syncthreads();

  auto dist = [&](int r, int c) {
    r = r < 0 ? 0 : (r >= N ? N - 1 : r);
    c = c < 0 ? 0 : (c >= N ? N - 1 : c);
    return make_int2(__ldg(pe + r), __ldg(pe + c));
  };
  auto level_d = [&](int2 p) {
    if (p.x == p.y) return 0.0f;
    int lvl = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i)
      if (i < l) lvl += div64((unsigned)p.x, s_div[i]) != div64((unsigned)p.y, s_div[i]) ? 1 : 0;
    return lvl > 0 ? s_d[lvl - 1] : 0.0f;
  };

  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < M; e += stride)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(ewgt + e), level_d(dist(__ldg(rows + e), __ldg(cols + e)))));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) v = __fadd_rn(v, s_sum[w]);
    scratch[blockIdx.x] = v;
    __threadfence();   // the partial is visible before the block is counted
    s_last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: the partials in block order, thread t taking t, t + 256, ...
  __threadfence();
  float v = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) v = __fadd_rn(v, __ldcg(scratch + b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, s_sum[w]);
    scratch[gridDim.x] = __fmul_rn(total, 0.5f);
  }
}

}  // namespace

// scratch: blocks + 1 floats (the partials, then J); arrived: one unsigned
// counter, zero before the launch.
extern "C" int mapcost_f32(const void* rows, const void* cols, const void* ewgt,
                           const void* pe, const void* g_below, const void* dvec,
                           void* scratch, void* arrived, int M, int N, int l, int blocks,
                           cudaStream_t stream) {
  if (l < 1 || l > kMaxLevels || blocks < 1 || N < 1 || M < 0) return (int)cudaErrorInvalidValue;
  mapcost_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(ewgt), static_cast<const int*>(pe),
      static_cast<const int*>(g_below), static_cast<const float*>(dvec),
      static_cast<float*>(scratch), static_cast<unsigned*>(arrived), M, N, l);
  return (int)cudaGetLastError();
}

