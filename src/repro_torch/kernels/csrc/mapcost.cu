// mapcost: per-block partial sums of w_e * d(pe_u, pe_v) over the directed
// edge arrays; the caller adds the partials and halves the total, giving
// J(C, D, Pi). The level of an edge is the number of group sizes g_below[i]
// at which pe_u / g and pe_v / g differ, and d = dvec[level - 1] (0 when the
// two PEs are equal). Padded edge slots carry weight 0.
//
// Replaces the TPU kernel src/repro/kernels/mapcost.py:mapcost_pallas
// (body _mapcost_kernel), which also wrote one partial per edge tile.
//
// Rounding: the sum runs in another order than the reference's reduction,
// so the result agrees within a relative tolerance, not bitwise (exactly,
// when every partial sum is an integer below 2^24, as with unit weights).
//
// Bound on the H100: bytes. Each edge reads rows, cols and ewgt (12 bytes,
// coalesced) and two PE ids (random, but pe_of is 4 bytes per vertex and
// stays in L2 at the sizes the path uses); the arithmetic is a few integer
// divisions per edge. Design: a grid-stride loop of one thread per edge
// with a register accumulator, then warp shuffles and one shared-memory
// pass reduce each block to one partial written to partial[blockIdx.x].
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

__global__ void mapcost_kernel(const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const float* __restrict__ ewgt,
                               const int* __restrict__ pe,
                               const int* __restrict__ g_below,
                               const float* __restrict__ dvec,
                               float* __restrict__ partial,
                               int M, int N, int l) {
  __shared__ int s_g[kMaxLevels];
  __shared__ float s_d[kMaxLevels];
  __shared__ float s_sum[kThreads / 32];
  if (threadIdx.x < l) {
    s_g[threadIdx.x] = g_below[threadIdx.x];
    s_d[threadIdx.x] = dvec[threadIdx.x];
  }
  __syncthreads();

  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < M;
       e += stride) {
    int r = rows[e];
    int c = cols[e];
    r = r < 0 ? 0 : (r >= N ? N - 1 : r);
    c = c < 0 ? 0 : (c >= N ? N - 1 : c);
    const int pu = pe[r];
    const int pv = pe[c];
    int lvl = 0;
    for (int i = 0; i < l; ++i) lvl += (pu / s_g[i]) != (pv / s_g[i]) ? 1 : 0;
    const float d = lvl > 0 ? s_d[lvl - 1] : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(ewgt[e], d));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? s_sum[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) partial[blockIdx.x] = v;
  }
}

}  // namespace

extern "C" int mapcost_f32(const void* rows, const void* cols, const void* ewgt,
                           const void* pe, const void* g_below, const void* dvec,
                           void* partial, int M, int N, int l, int blocks,
                           cudaStream_t stream) {
  if (l < 1 || l > kMaxLevels || blocks < 1 || N < 1) return (int)cudaErrorInvalidValue;
  mapcost_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(ewgt), static_cast<const int*>(pe),
      static_cast<const int*>(g_below), static_cast<const float*>(dvec),
      static_cast<float*>(partial), M, N, l);
  return (int)cudaGetLastError();
}
