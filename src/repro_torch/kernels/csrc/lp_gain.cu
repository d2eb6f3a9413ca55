// lp_gain: per-vertex block connectivity for label-propagation refinement,
// batched over R restarts. For each row u of the padded ELL adjacency
// adj/adw [N, DEG] (DEG <= 64; neighbour id >= N = padding) and each
// restart r with labels part [R, N] (2 <= k <= 64 blocks):
//   conn[r, u, b] = sum of adw[u, j] over the slots j whose neighbour is in
//                   block b, added in slot order j = 0 .. DEG-1;
//   best[r, u]    = first block of largest conn other than part[r, u];
//   gain[r, u]    = conn[r, u, best] - conn[r, u, part[r, u]].
// Padding slots are skipped, as the TPU kernel's body skips them.
//
// Replaces the TPU kernel src/repro/kernels/lp_gain.py: lp_gain_pallas
// (body _lp_gain_kernel).
//
// Rounding: every sum is a chain of __fadd_rn in slot order, so the result
// does not depend on scheduling and equals the plain version
// (kernels/ref.py: lp_gain_ref, which adds in the same order); the argmax
// and the one subtraction are exact or single-rounded.
//
// Bound on the H100: bytes. Each row's DEG ids and weights (8 * DEG bytes)
// are read once for all R restarts; per restart the kernel gathers DEG
// labels (the [N] i32 label row, 4 MB at N = 2^20, stays in L2) and writes
// 4 * k + 8 bytes. The ordered sums cost DEG steps per (row, block), so the
// design spends one lane per (row, block) and packs rows into a warp: a
// group of G = next_pow2(k) lanes (at most 32) serves one row, 32 / G rows
// share a warp, and a lane with k > 32 owns blocks b and b + 32. The warp's
// rows are contiguous in memory: their ids and weights are staged once in
// shared memory with coalesced loads, the labels of their neighbours once
// per restart, and every lane walks its row's slots in order, reading each
// slot as a broadcast within its group. The argmax is a shuffle reduction
// within the group on (value, block), the smaller block winning ties.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxDeg = 64;
constexpr int kMaxK = 64;

__global__ void lp_gain_kernel(const int* __restrict__ adj,
                               const float* __restrict__ adw,
                               const int* __restrict__ part,
                               float* __restrict__ conn,
                               int* __restrict__ best,
                               float* __restrict__ gain,
                               int N, int DEG, int k, int R, int G) {
  extern __shared__ int smem[];
  const int rpw = 32 / G;                  // rows per warp
  const int S = rpw * DEG;                 // slots per warp
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* s_adj = smem + wib * 3 * S;
  float* s_w = reinterpret_cast<float*>(s_adj + S);
  int* s_blk = s_adj + 2 * S;

  const long long u0 = ((long long)blockIdx.x * kWarpsPerBlock + wib) * rpw;
  if (u0 >= N) return;  // uniform per warp: the whole warp leaves together
  const long long slot0 = u0 * DEG;
  const long long slots = (long long)N * DEG;
  for (int s = lane; s < S; s += 32) {
    const bool in = slot0 + s < slots;
    s_adj[s] = in ? adj[slot0 + s] : N;
    s_w[s] = in ? adw[slot0 + s] : 0.0f;
  }

  const int q = lane / G;                  // this lane's row in the warp
  const int bl = lane % G;                 // this lane's first block
  const long long u = u0 + q;
  const bool row_ok = u < N;
  const int* row_blk = s_blk + q * DEG;
  const float* row_w = s_w + q * DEG;

  for (int r = 0; r < R; ++r) {
    const int* pr = part + (long long)r * N;
    __syncwarp();  // the staging, or the previous restart's reads, are done
    for (int s = lane; s < S; s += 32) {
      const int a = s_adj[s];
      s_blk[s] = a < N ? pr[a < 0 ? 0 : a] : -1;
    }
    __syncwarp();

    float acc0 = 0.0f, acc1 = 0.0f;
    for (int j = 0; j < DEG; ++j) {
      const int bj = row_blk[j];
      const float wj = row_w[j];
      if (bj == bl) acc0 = __fadd_rn(acc0, wj);
      if (bj == bl + 32) acc1 = __fadd_rn(acc1, wj);
    }

    int own = row_ok ? pr[u] : 0;
    own = own < 0 ? 0 : (own >= k ? k - 1 : own);
    float bv = -CUDART_INF_F;
    int bi = kMaxK;
    if (bl < k) {
      bv = bl == own ? -CUDART_INF_F : acc0;
      bi = bl;
    }
    if (bl + 32 < k) {
      const float v = bl + 32 == own ? -CUDART_INF_F : acc1;
      if (v > bv) {
        bv = v;
        bi = bl + 32;
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off, G);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off, G);
      if (oi != kMaxK && (bi == kMaxK || ov > bv || (ov == bv && oi < bi))) {
        bv = ov;
        bi = oi;
      }
    }
    const float c0 = __shfl_sync(0xffffffffu, acc0, own % G, G);
    const float c1 = __shfl_sync(0xffffffffu, acc1, own % G, G);
    if (row_ok) {
      const long long row = (long long)r * N + u;
      if (bl < k) conn[row * k + bl] = acc0;
      if (bl + 32 < k) conn[row * k + bl + 32] = acc1;
      if (bl == 0) {
        best[row] = bi;
        gain[row] = __fsub_rn(bv, own < 32 ? c0 : c1);
      }
    }
  }
}

}  // namespace

extern "C" int lp_gain_f32(const void* adj, const void* adw, const void* part,
                           void* conn, void* best, void* gain, int N, int DEG,
                           int k, int R, cudaStream_t stream) {
  if (N <= 0 || R <= 0) return 0;
  if (DEG < 1 || DEG > kMaxDeg || k < 2 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  int G = 2;
  while (G < k && G < 32) G <<= 1;
  const int rpw = 32 / G;
  const long long warps = ((long long)N + rpw - 1) / rpw;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // 3 words per slot: <= 4 warps * 16 rows * 64 slots * 12 B = 48 KB
  const size_t smem = (size_t)kWarpsPerBlock * 3 * rpw * DEG * sizeof(int);
  lp_gain_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const int*>(adj), static_cast<const float*>(adw),
      static_cast<const int*>(part), static_cast<float*>(conn),
      static_cast<int*>(best), static_cast<float*>(gain), N, DEG, k, R, G);
  return (int)cudaGetLastError();
}
