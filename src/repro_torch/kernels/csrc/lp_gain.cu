// lp_gain: per-vertex block connectivity for label-propagation refinement,
// batched over the B graphs of a dispatch (its lanes) and their R restarts.
// For each graph, row u of its padded ELL adjacency adj/adw [B, N, DEG]
// (DEG <= 64; neighbour id >= N = padding; ids are local to the graph, so a
// row gathers only its own graph's labels) and each restart r with labels
// part [B, R, N] (2 <= k <= 64 blocks), outputs [B, R, ...] (the graph
// index is left out below):
//   conn[r, u, b] = sum of adw[u, j] over the slots j whose neighbour is in
//                   block b, added in slot order j = 0 .. DEG-1;
//   best[r, u]    = first block of largest conn other than part[r, u];
//   gain[r, u]    = conn[r, u, best] - conn[r, u, part[r, u]].
// Padding slots are skipped, as the TPU kernel's body skips them.
//
// Replaces the TPU kernel src/repro/kernels/lp_gain.py: lp_gain_pallas
// (body _lp_gain_kernel), which the reference's batched partition vmaps
// over the graphs of a dispatch (an axis of its grid). Here the graph is
// the grid's y index: a block's rows all lie in one graph, every pointer is
// offset to that graph, and a batch of one is the launch of one graph.
//
// Rounding: every sum starts at +0.0f and is a chain of __fadd_rn over the
// row's live slots in slot order, so the result does not depend on
// scheduling and equals the plain version (kernels/ref.py: lp_gain_ref,
// which adds in the same order); the argmax and the one subtraction are
// exact or single-rounded. Where the sums live in registers, a slot also
// adds +0.0f to the sum of every other block. That changes nothing: a sum
// starts at +0.0, a round-to-nearest sum is -0.0 only when both operands
// are -0.0, so no sum is ever -0.0, and x + 0.0f == x for every other x.
//
// Bound on the H100: bytes. Each row's DEG ids and weights (8 * DEG bytes)
// are read once for all R restarts, its own labels once, and per restart
// the kernel writes 4 * k + 8 bytes (277 MB at N = 2^20, DEG 24, k 6, R 2).
// Besides, every live slot gathers one label per restart at a random
// neighbour (the [R, N] labels stay in L2, but each 4-byte label costs its
// own 32-byte sector). The work that matters is one gather and one add per
// (live slot, restart), and most slots are padding: an rgg row holds 8.6
// live slots of 24 at the finest level, and at the coarse levels of a call
// most rows hold none. Most launches are small (N = 2^15 on the main path),
// where the length of one warp's chain of dependent steps sets the time.
// Design:
// - Each warp works alone on 16 consecutive rows (no block barrier), two
//   lanes a row, each lane taking one restart a pass (restarts sub, sub +
//   2, ...), which halves the chain of a lane on the main path (R = 2).
//   The warp stages its rows' contiguous ids and weights in shared memory
//   with asynchronous copies (rows.cuh) at an odd pitch; each lane builds
//   its row's live-slot mask (one 64-bit word), then walks the row in slot
//   order up to its last live slot, eight slots at a time, wherever the
//   padding lies. A row with no live slot does no work: its sums stay 0,
//   best is the first block other than its own, gain 0.
// - A lane issues the label gathers of the live slots among eight
//   together, then adds in slot order. For k <= 8 the sums live in
//   registers, and each slot adds its weight to its block and +0.0f to
//   every other block, which leaves them bitwise unchanged (Rounding); for
//   larger k they live in shared memory, [b][lane], so whatever blocks the
//   lanes hit, they hit 32 distinct banks.
// - The labels are gathered as they are, one per (live slot, restart).
//   Packing a vertex's labels under all restarts into one word first, so
//   the two lanes of a row share one sector a slot, took 11% off the
//   finest level on an H100 but cost more than it saved over the mapping
//   main path there: the pass
//   runs over all N rows, and at most levels of a call few of them live.
// - conn [R, N, k] leaves through shared memory: a warp's nrow * k values
//   of a restart are one contiguous run, written by consecutive lanes;
//   best and gain are written by each row's lane.
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kWarps = 4;       // warps of a block, each on its own rows
constexpr int kRowsPerWarp = 16;   // two lanes a row
constexpr int kMaxDeg = 64;
constexpr int kMaxK = 64;
constexpr int kBatch = 8;       // slots walked at a time, their gathers in flight together
typedef unsigned long long u64;

// Each warp of a block works alone on kRowsPerWarp consecutive rows, two
// lanes a row: lane share sub (0 or 1) takes the restarts sub, sub + 2, ...,
// one a pass. KR > 0 keeps the sums of k <= KR blocks in registers, KR == 0
// in shared memory (any k).
template <int KR>
__global__ void __launch_bounds__(32 * kWarps)
lp_gain_kernel(const int* __restrict__ adj, const float* __restrict__ adw,
               const int* __restrict__ part, float* __restrict__ conn, int* __restrict__ best,
               float* __restrict__ gain, int N, int DEG, int k, int R) {
  extern __shared__ __align__(16) int smem[];
  constexpr int nw = kRowsPerWarp;
  {   // this block's graph of the batch (the grid's y index)
    const long long gi = blockIdx.y;
    adj += gi * N * DEG;
    adw += gi * N * DEG;
    part += gi * R * N;
    conn += gi * R * N * k;
    best += gi * R * N;
    gain += gi * R * N;
  }
  const int P = rows::pitch(DEG);
  const int lane = threadIdx.x & 31;
  int* s_adj = smem + (threadIdx.x >> 5) * (2 * nw * P + k * 32);  // [nw][P]
  float* s_w = reinterpret_cast<float*>(s_adj + nw * P);          // [nw][P]
  float* s_sum = s_w + nw * P;                                    // [k][32 lanes]

  const long long u0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * nw;
  if (u0 >= N) return;   // uniform per warp; the warp never meets the others
  const int nrow = (int)min((long long)nw, (long long)N - u0);
  const int tr = lane % nw;   // this lane's row in the warp
  const int sub = lane / nw;  // and its share of the restarts
  const bool row_ok = tr < nrow;
  const long long u = u0 + tr;
  rows::stage(adj, adw, s_adj, s_w, u0 * DEG, nrow * DEG, DEG, P, lane, 32);
  __syncwarp();

  const int* my_adj = s_adj + tr * P;
  const float* my_w = s_w + tr * P;
  u64 live = 0;
  if (row_ok) {
#pragma unroll 8
    for (int j = 0; j < DEG; ++j) live |= (u64)(my_adj[j] < N) << j;
  }
  const int last = live ? 63 - __clzll((long long)live) : -1;   // last live slot

  const rows::Div div(k);
  float* my_sum = s_sum + lane;
  for (int r0 = 0; r0 < R; r0 += 2) {   // restarts r0 and r0 + 1, one a lane
    const int r = r0 + sub < R ? r0 + sub : -1;
    int own = (row_ok && r >= 0) ? __ldg(part + (long long)r * N + u) : 0;
    own = own < 0 ? 0 : (own >= k ? k - 1 : own);   // loaded while the slots are walked
    float acc[KR > 0 ? KR : 1];
    if constexpr (KR > 0) {
#pragma unroll
      for (int c = 0; c < KR; ++c) acc[c] = 0.0f;
    } else {
      for (int b = 0; b < k; ++b) my_sum[b * 32] = 0.0f;
    }

    for (int j0 = 0; j0 <= last && r >= 0; j0 += kBatch) {   // slot order
      int a[kBatch];
      float w[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q;
        const bool on = j <= last && ((live >> j) & 1ull);
        a[q] = on ? max(my_adj[j], 0) : -1;   // a negative id reads vertex 0's label
        w[q] = on ? my_w[j] : 0.0f;
      }
      int lab[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        lab[q] = a[q] >= 0 ? __ldg(part + (long long)r * N + a[q]) : -1;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if constexpr (KR > 0) {   // +0.0f elsewhere changes nothing (Rounding)
#pragma unroll
          for (int c = 0; c < KR; ++c) acc[c] = __fadd_rn(acc[c], lab[q] == c ? w[q] : 0.0f);
        } else if ((unsigned)lab[q] < (unsigned)k) {
          float* p = my_sum + lab[q] * 32;
          *p = __fadd_rn(*p, w[q]);
        }
      }
    }
    if constexpr (KR > 0) {
#pragma unroll
      for (int c = 0; c < KR; ++c)
        if (c < k) my_sum[c * 32] = acc[c];
    }

    if (row_ok && r >= 0) {
      const long long row = (long long)r * N + u;
      int bi = own == 0 ? 1 : 0;
      float bv = my_sum[bi * 32];
      for (int b = bi + 1; b < k; ++b) {
        const float v = my_sum[b * 32];
        if (b != own && v > bv) {
          bv = v;
          bi = b;
        }
      }
      best[row] = bi;
      gain[row] = __fsub_rn(bv, my_sum[own * 32]);
    }
    __syncwarp();   // every row's sums are final

    // conn of the warp's rows under restarts r0 and r0 + 1: each a
    // contiguous run of nrow * k values, written by consecutive lanes
    for (int h = 0; h < 2 && r0 + h < R; ++h) {
      float* out = conn + ((long long)(r0 + h) * N + u0) * k;
      const float* sums = s_sum + h * nw;
      for (int e = lane; e < nrow * k; e += 32) {
        const int tt = div(e);
        out[e] = sums[(e - tt * k) * 32 + tt];
      }
    }
    __syncwarp();   // the next pass's sums wait for these reads
  }
}

template <int KR>
int launch(const int* adj, const float* adw, const int* part, float* conn, int* best, float* gain, int N, int DEG, int k, int R,
           int B, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (2 * kRowsPerWarp * rows::pitch(DEG) + k * 32) *
                      sizeof(float);
  if (smem > 48 * 1024) {  // e.g. DEG 32 with k 64; the main path needs 17 KB
    const cudaError_t err = cudaFuncSetAttribute(
        lp_gain_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)N + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
  lp_gain_kernel<KR><<<dim3((unsigned)blocks, (unsigned)B), 32 * kWarps, smem, stream>>>(
      adj, adw, part, conn, best, gain, N, DEG, k, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lp_gain_f32(const void* adj, const void* adw, const void* part,
                           void* conn, void* best, void* gain,
                           int N, int DEG, int k, int R, int B, cudaStream_t stream) {
  if (N <= 0 || R <= 0 || B <= 0) return 0;
  if (DEG < 1 || DEG > kMaxDeg || k < 2 || k > kMaxK || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int* a = static_cast<const int*>(adj);
  const float* w = static_cast<const float*>(adw);
  const int* p = static_cast<const int*>(part);
  float* c = static_cast<float*>(conn);
  int* b = static_cast<int*>(best);
  float* g = static_cast<float*>(gain);
  if (k <= 4) return launch<4>(a, w, p, c, b, g, N, DEG, k, R, B, stream);
  if (k <= 8) return launch<8>(a, w, p, c, b, g, N, DEG, k, R, B, stream);
  return launch<0>(a, w, p, c, b, g, N, DEG, k, R, B, stream);
}
