// contract_edges: row-local merge, dedup and weight sum for contraction.
// Each row of cand [N, D2] (D2 = 2 * DEG <= 128) holds the coarse ids of a
// coarse vertex's candidate neighbours (sentinel `sent` = empty slot, weight
// 0). Per row: nbr keeps each distinct id at its FIRST slot (sent
// elsewhere), w holds that id's weight total, cnt the number of distinct
// ids.
//
// Replaces the TPU kernel src/repro/kernels/coarsen_kernels.py:
// contract_edges_pallas (body _contract_edges_kernel -> kernels/ref.py:
// merge_dedup_rows).
//
// Rounding: the reference sums each slot's total as a fixed chain of D2
// adds in slot order, acc += (cand[s] == cand[i]) ? candw[i] : 0.0f for
// i = 0 .. D2-1. The kernel runs the same chain with __fadd_rn in the same
// order, so the totals are bitwise the reference's; the first-occurrence
// and count passes are integer-only.
//
// Bound on the H100: bytes (2 * 4 * D2 in, 2 * 4 * D2 + 4 out per row); the
// D2-long chain per slot is O(D2^2) compares per row, which at D2 = 64 is
// still below the memory time. Design: one warp per row; the row is staged
// in shared memory with coalesced loads, and every lane walks the chain
// reading slot i as a shared-memory broadcast, owning slots lane,
// lane + 32, lane + 64 and lane + 96.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxD2 = 128;

__global__ void contract_edges_kernel(const int* __restrict__ cand,
                                      const float* __restrict__ candw,
                                      int* __restrict__ nbr,
                                      float* __restrict__ wout,
                                      int* __restrict__ cnt,
                                      int N, int D2, int sent) {
  __shared__ int s_id[kWarpsPerBlock][kMaxD2];
  __shared__ float s_w[kWarpsPerBlock][kMaxD2];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= N) return;  // uniform per warp
  const long long base = (long long)row * D2;
  for (int s = lane; s < D2; s += 32) {
    s_id[wib][s] = cand[base + s];
    s_w[wib][s] = candw[base + s];
  }
  __syncwarp();

  int mine[4];
  float acc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int s = lane + 32 * t;
    mine[t] = s < D2 ? s_id[wib][s] : sent;
    acc[t] = 0.0f;
  }
  for (int i = 0; i < D2; ++i) {
    const int ci = s_id[wib][i];
    const float wi = s_w[wib][i];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc[t] = __fadd_rn(acc[t], mine[t] == ci ? wi : 0.0f);
  }

  int count = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int s = lane + 32 * t;
    if (s < D2) {
      bool first = mine[t] != sent;
      for (int i = 0; i < s && first; ++i)
        if (s_id[wib][i] == mine[t]) first = false;
      nbr[base + s] = first ? mine[t] : sent;
      wout[base + s] = first ? acc[t] : 0.0f;
      count += first ? 1 : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) cnt[row] = count;
}

}  // namespace

extern "C" int contract_edges_f32(const void* cand, const void* candw, void* nbr,
                                  void* w, void* cnt, int N, int D2, int sent,
                                  cudaStream_t stream) {
  if (N <= 0) return 0;
  if (D2 < 1 || D2 > kMaxD2) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  contract_edges_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const int*>(cand), static_cast<const float*>(candw),
      static_cast<int*>(nbr), static_cast<float*>(w), static_cast<int*>(cnt),
      N, D2, sent);
  return (int)cudaGetLastError();
}
