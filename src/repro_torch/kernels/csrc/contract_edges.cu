// contract_edges: row-local merge, dedup and weight sum for contraction.
// Each row of cand [N, D2] (D2 = 2 * DEG <= 128) holds the coarse ids of a
// coarse vertex's candidate neighbours (sentinel `sent` = empty slot). Per
// row: nbr keeps each distinct id at its FIRST slot (sent elsewhere), w
// holds that id's weight total (0 elsewhere), cnt the number of distinct
// ids.
//
// Replaces the TPU kernel src/repro/kernels/coarsen_kernels.py:
// contract_edges_pallas (body _contract_edges_kernel -> kernels/ref.py:
// merge_dedup_rows).
//
// Rounding: the reference sums each slot's total as a fixed chain of D2
// adds in slot order, acc = 0 + t_0 + t_1 + ... with t_i = candw[i] where
// cand[i] equals the slot's id and t_i = +0.0f elsewhere. The kernel adds
// only the matching slots, in increasing slot order, starting from +0.0f.
// The two are bitwise equal: the chain starts at +0.0, and a round-to-
// nearest sum gives -0.0 only from two -0.0 operands, so acc is never -0.0;
// then acc + (+0.0) == acc exactly, and every skipped add changes nothing.
// The first matching slot is the id's first occurrence, so the chain up to
// it is +0.0 and the kernel begins with __fadd_rn(0.0f, w) (which turns a
// -0.0 weight into +0.0, as the chain does). First occurrences and counts
// are integer-only.
//
// Bound on the H100: bytes (2 * 4 * D2 in, 2 * 4 * D2 + 4 out per row; 809
// MB at [2^20, 48]). The reference's chain costs D2 * D2 compare-adds per
// row whatever the row holds; most rows hold few live slots (an rgg row
// about a third of 48) and at the coarse levels of a call most rows are
// empty (every row at or above the level's vertex count). So the design
// makes the work follow the live slots:
// - One thread per row, kRows rows per block. The block stages its rows'
//   contiguous ids and weights in shared memory with asynchronous copies
//   (rows.cuh), at an odd pitch, so a walk over one slot of every row is
//   free of bank conflicts.
// - Each thread walks its row once in slot order, reading eight ids at a
//   time, and looks each live id up in the row's own hash table in shared
//   memory (one byte an entry: 1 + the id's first slot; the smallest power
//   of two above D2 entries, so it never fills; linear probing). An id not
//   yet there is a first occurrence: its slot enters the table and the
//   row's keep mask, and its total starts as 0 + w. A later slot of the id
//   adds its weight to that total, in place, in slot order. Cost per row:
//   one probe or two per live slot; an empty row takes the write-only
//   path. (Scanning the remaining live slots for each first occurrence
//   instead costs L^2 / 2 steps a row: at the coarse levels rows hold up
//   to 48 live slots, and one thread's chain then sets the time.)
// - The block writes nbr and w back with coalesced stores: a slot in the
//   keep mask writes its id and total, every other slot sent and +0.0f.
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kRows = 64;   // one thread per row
constexpr int kMaxD2 = 128;
constexpr int kChunk = 8;   // slots whose ids are read together
typedef unsigned long long u64;

// log2 of a row's hash table: the smallest power of two above D2 (>= 4), so
// a table of one-byte entries never fills.
int table_bits(int D2) {
  int b = 2;
  while ((1 << b) <= D2) ++b;
  return b;
}

__global__ void __launch_bounds__(kRows)
contract_edges_kernel(const int* __restrict__ cand,
                      const float* __restrict__ candw,
                      int* __restrict__ nbr, float* __restrict__ wout,
                      int* __restrict__ cnt, int N, int D2, int sent, int tb) {
  extern __shared__ __align__(16) int smem[];
  const int P = rows::pitch(D2);
  const int TS = 1 << tb;
  u64* s_keep = reinterpret_cast<u64*>(smem);          // [kRows][2]
  int* s_id = smem + 4 * kRows;                        // [kRows][P]
  float* s_w = reinterpret_cast<float*>(s_id + kRows * P);
  unsigned char* s_tab = reinterpret_cast<unsigned char*>(s_w + kRows * P);

  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int nrow = (int)min((long long)kRows, (long long)N - row0);
  const long long base = row0 * D2;
  const int total = nrow * D2;
  rows::stage(cand, candw, s_id, s_w, base, total, D2, P, t, kRows);
  __syncthreads();

  if (t < nrow) {
    const int* id = s_id + t * P;
    float* w = s_w + t * P;
    // the row's table: entry = 1 + the first slot of an id, 0 = empty
    unsigned char* tab = s_tab + t * TS;
    for (int i = 0; i < TS; i += 4) *reinterpret_cast<unsigned*>(tab + i) = 0u;
    u64 k0 = 0, k1 = 0;   // first occurrences, slots 0..63 and 64..127
    for (int j0 = 0; j0 < D2; j0 += kChunk) {
      int xs[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) xs[q] = j0 + q < D2 ? id[j0 + q] : sent;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int x = xs[q];
        if (x == sent) continue;
        const int j = j0 + q;
        unsigned h = ((unsigned)x * 0x9E3779B1u) >> (32 - tb);
        for (;;) {
          const int e = tab[h];
          if (e == 0) {           // x's first slot: its total starts here
            tab[h] = (unsigned char)(j + 1);
            w[j] = __fadd_rn(0.0f, w[j]);
            if (j < 64) k0 |= 1ull << j;
            else k1 |= 1ull << (j - 64);
            break;
          }
          if (id[e - 1] == x) {   // a later slot of x: add in slot order
            w[e - 1] = __fadd_rn(w[e - 1], w[j]);
            break;
          }
          h = (h + 1) & (TS - 1);
        }
      }
    }
    s_keep[2 * t] = k0;
    s_keep[2 * t + 1] = k1;
    cnt[row0 + t] = __popcll((long long)k0) + __popcll((long long)k1);
  }
  __syncthreads();

  const rows::Div div(D2);
  for (int e = t; e < total; e += kRows) {
    const int r = div(e);
    const int j = e - r * D2;
    const bool keep = (s_keep[2 * r + (j >> 6)] >> (j & 63)) & 1ull;
    const int s = r * P + j;
    nbr[base + e] = keep ? s_id[s] : sent;
    wout[base + e] = keep ? s_w[s] : 0.0f;
  }
}

size_t smem_bytes(int D2) {
  return (size_t)kRows * ((4 + 2 * rows::pitch(D2)) * sizeof(int) + (1u << table_bits(D2)));
}

}  // namespace

extern "C" int contract_edges_f32(const void* cand, const void* candw, void* nbr,
                                  void* w, void* cnt, int N, int D2, int sent,
                                  cudaStream_t stream) {
  if (N <= 0) return 0;
  if (D2 < 1 || D2 > kMaxD2) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D2);
  if (smem > 48 * 1024) {  // D2 > 77 only; the main path's 48 needs 30 KB
    const cudaError_t err = cudaFuncSetAttribute(
        contract_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)(((long long)N + kRows - 1) / kRows);
  contract_edges_kernel<<<blocks, kRows, smem, stream>>>(
      static_cast<const int*>(cand), static_cast<const float*>(candw),
      static_cast<int*>(nbr), static_cast<float*>(w), static_cast<int*>(cnt),
      N, D2, sent, table_bits(D2));
  return (int)cudaGetLastError();
}
