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
// The result is the maximum score and the smallest id among the slots that
// reach it, which a walk in any order finds, so it is bitwise the
// reference's.
//
// Bound on the H100: bytes. An unmatched row needs its DEG ids, weights and
// jitters (12 * DEG bytes); every row reads its flag and writes its
// proposal (8 bytes). A matched row needs nothing else: all its slots are
// invalid, so it proposes N. Most rows of a call are matched: the padding
// rows of a level are marked matched, and every level of a call keeps the
// root's padded N, so at the coarse levels most rows are padding; rounds 2
// and 3 see the rows matched in the rounds before. Besides, every valid
// candidate slot gathers one random matched[a] flag (the [N] vector stays
// in L2, but each costs its own 32-byte sector). Design:
// - Each warp works alone on 32 consecutive rows, one thread a row (no
//   block barrier). It reads the rows' flags (one coalesced line) and a row
//   whose flag is set writes N at once. The warp then stages only its live
//   rows' slots in shared memory with asynchronous copies (rows.cuh),
//   compacted in row order at an odd pitch, all lanes copying.
// - Each thread walks its row in slot order, eight slots at a time: the
//   matched[a] gathers of the candidate slots among the eight (a real id,
//   not u) are issued together, then the valid slots update the best score
//   and its smallest id in registers. Padding slots may lie anywhere in the
//   row; they gather nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "rows.cuh"

namespace {

constexpr int kWarps = 4;     // warps of a block, each alone on 32 rows
constexpr int kMaxDeg = 64;
constexpr int kBatch = 8;     // slots whose matched[a] gathers are in flight together

// shared memory of one warp: ids, weights and jitters [32][P], live row list [32]
__host__ __device__ inline int warp_words(int DEG) { return 3 * 32 * rows::pitch(DEG) + 32; }

__global__ void __launch_bounds__(32 * kWarps)
hem_propose_kernel(const int* __restrict__ adj, const float* __restrict__ adw,
                   const float* __restrict__ jit, const int* __restrict__ matched,
                   int* __restrict__ prop, int N, int DEG) {
  extern __shared__ __align__(16) int smem[];
  const int P = rows::pitch(DEG);
  const int lane = threadIdx.x & 31;
  int* s_adj = smem + (threadIdx.x >> 5) * warp_words(DEG);   // [32][P], by live rank
  float* s_w = reinterpret_cast<float*>(s_adj + 32 * P);
  float* s_j = s_w + 32 * P;
  int* s_row = reinterpret_cast<int*>(s_j + 32 * P);          // lane of each live rank

  const long long u0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (u0 >= N) return;   // uniform per warp; the warp never meets the others
  const long long u = u0 + lane;
  const bool live = u < N && __ldg(matched + u) == 0;
  if (u < N && !live) prop[u] = N;   // a matched row: every slot is invalid
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (mask == 0) return;
  const int nlive = __popc(mask);
  const int rank = __popc(mask & ((1u << lane) - 1u));
  if (live) s_row[rank] = lane;
  __syncwarp();
  // the live rows' slots, compacted: element e is slot e % DEG of the
  // (e / DEG)-th live row; consecutive lanes copy consecutive slots
  const rows::Div div(DEG);
  for (int e = lane; e < nlive * DEG; e += 32) {
    const int r = div(e);
    const int j = e - r * DEG;
    const long long src = (u0 + s_row[r]) * DEG + j;
    const int dst = r * P + j;
    rows::copy_async4(s_adj + dst, adj + src);
    rows::copy_async4(s_w + dst, adw + src);
    rows::copy_async4(s_j + dst, jit + src);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  if (!live) return;

  const int* ra = s_adj + rank * P;
  const float* rw = s_w + rank * P;
  const float* rj = s_j + rank * P;
  const int self = (int)u;
  float best = -CUDART_INF_F;
  int cand = N;
  for (int j0 = 0; j0 < DEG; j0 += kBatch) {   // slot order
    int a[kBatch];
    int m[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) a[t] = j0 + t < DEG ? ra[j0 + t] : N;
#pragma unroll
    for (int t = 0; t < kBatch; ++t)   // a negative id reads vertex 0's flag, as the reference clamps
      m[t] = (a[t] < N && a[t] != self) ? __ldg(matched + max(a[t], 0)) : 1;
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (m[t] == 0) {
        const float jj = __fmul_rn(rj[j0 + t], 1e-3f);
        const float s = __fmaf_rn(rw[j0 + t], __fadd_rn(1.0f, jj), jj);
        if (s > best || (s == best && a[t] < cand)) {
          best = s;
          cand = a[t];
        }
      }
    }
  }
  prop[u] = best > -CUDART_INF_F ? cand : N;
}

}  // namespace

extern "C" int hem_propose_f32(const void* adj, const void* adw, const void* jit,
                               const void* matched, void* prop, int N, int DEG,
                               cudaStream_t stream) {
  if (N <= 0) return 0;
  if (DEG < 1 || DEG > kMaxDeg) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * warp_words(DEG) * sizeof(int);
  if (smem > 48 * 1024) {   // DEG above 40; the main path's DEG 24 takes 38,912 B
    const cudaError_t err = cudaFuncSetAttribute(
        hem_propose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)N + 32 * kWarps - 1) / (32 * kWarps);
  hem_propose_kernel<<<(unsigned)blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const int*>(adj), static_cast<const float*>(adw),
      static_cast<const float*>(jit), static_cast<const int*>(matched),
      static_cast<int*>(prop), N, DEG);
  return (int)cudaGetLastError();
}
