// hem_propose: one heavy-edge-matching proposal per row of the padded ELL
// adjacency [N, DEG] (DEG <= 64). A slot j of row u is valid when its
// neighbour a = adj[u, j] is real (a < N), not u itself, and both u and a
// are unmatched. Its score is adw * (1 + jj) + jj with jj = jit * 1e-3;
// the row proposes the smallest neighbour id among its best-scoring valid
// slots, or N when it has none.
//
// Replaces the TPU kernel src/repro/kernels/coarsen_kernels.py:
// hem_propose_pallas (body _hem_propose_kernel -> kernels/ref.py:
// hem_row_scan).
//
// Rounding: the reference runs under XLA's jit on the CPU, which fuses the
// score into ONE fused multiply-add. The kernel writes exactly that:
// jj = __fmul_rn(jit, 1e-3f), score = __fmaf_rn(adw, __fadd_rn(1, jj), jj),
// and the library is built with -fmad=false so nvcc contracts nothing else.
// The reductions (max, then min of ids among ties) are order-free, so the
// result is bitwise the reference's.
//
// Bound on the H100: bytes. Per row it reads DEG ids, weights and jitters
// (12 * DEG bytes), one matched flag per slot (random, but the [N] i32
// vector of 4 MB at N = 2^20 stays in L2) and writes 4 bytes. Design: one
// warp per row, lane t owning slots t and t + 32, so each row's three
// streams are read as coalesced 128-byte lines; warp shuffles do the two
// reductions with no shared memory.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void hem_propose_kernel(const int* __restrict__ adj,
                                   const float* __restrict__ adw,
                                   const float* __restrict__ jit,
                                   const int* __restrict__ matched,
                                   int* __restrict__ prop, int N, int DEG) {
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= N) return;  // uniform per warp: the whole warp leaves together
  const long long base = (long long)u * DEG;
  const bool own_free = matched[u] == 0;

  float score[2];
  int id[2];
  bool valid[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    valid[t] = false;
    score[t] = -CUDART_INF_F;
    id[t] = N;
    if (j < DEG) {
      const int a = adj[base + j];
      const int ac = a < 0 ? 0 : (a >= N ? N - 1 : a);
      if (a < N && a != u && own_free && matched[ac] == 0) {
        const float jj = __fmul_rn(jit[base + j], 1e-3f);
        score[t] = __fmaf_rn(adw[base + j], __fadd_rn(1.0f, jj), jj);
        valid[t] = true;
        id[t] = a;
      }
    }
  }
  float best = fmaxf(score[0], score[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  int cand = N;
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (valid[t] && score[t] == best && id[t] < cand) cand = id[t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, off));
  if (lane == 0) prop[u] = best > -CUDART_INF_F ? cand : N;
}

}  // namespace

extern "C" int hem_propose_f32(const void* adj, const void* adw, const void* jit,
                               const void* matched, void* prop, int N, int DEG,
                               cudaStream_t stream) {
  if (N <= 0) return 0;
  if (DEG < 1 || DEG > 64) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hem_propose_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const int*>(adj), static_cast<const float*>(adw),
      static_cast<const float*>(jit), static_cast<const int*>(matched),
      static_cast<int*>(prop), N, DEG);
  return (int)cudaGetLastError();
}
