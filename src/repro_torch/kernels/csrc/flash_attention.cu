// flash_attention: o = softmax(mask(q k^T * D^-1/2)) v for every (batch,
// head) of q [B, S, H, D] against k, v [B, S, Hkv, D], all contiguous, read
// in place: query head h reads KV head h / (H / Hkv), as the reference's
// jnp.repeat expands them. f32 softmax statistics and accumulation; the
// output o [B, S, H, D] in the input type. Masks: key columns past S,
// `causal` (col <= row) and `window > 0` (row - col < window), with or
// without `causal`.
//
// Replaces the TPU kernel src/repro/kernels/flashattn.py:flash_attention_pallas
// (body _flash_kernel): tiled online-softmax SDPA whose running max,
// normaliser and accumulator never leave fast memory, so no [S, S] logits
// reach device memory.
//
// Bound on the H100: operations. Each (query, key) pair that the masks keep
// costs 4 D operations (2 D for q k^T, 2 D for p v), S (S + 1) / 2 pairs per
// (batch, head) when causal, against 989 TFLOP/s in bf16 on the tensor
// cores; its bytes (q, k, v read once, o written once) take far less.
//
// Two routes, by dtype:
//
// bf16 (flash_kernel_wgmma): Hopper's tensor cores, fed by TMA.
//   One block of three warpgroups owns 128 query rows of one (batch, head):
//   two consumer warpgroups of 64 rows each (wgmma's M) and a producer
//   warpgroup, of which one thread issues every copy. The producer loads
//   the Q tile once and each K/V tile into a two-stage ring in shared
//   memory by TMA (128-byte swizzle, 64-column boxes; rows past S arrive as
//   zeros); each load completes on an mbarrier, and the consumers release
//   K and V through mbarriers of their own (K as soon as S is computed).
//   The TPU's sequential k-tile grid axis is the loop of the block; each
//   warpgroup runs its tile in order (S, softmax, O), and the two
//   warpgroups overlap each other. S = Q K^T is wgmma m64nBKk16 with both
//   operands in shared memory, K-major. The softmax runs in the
//   accumulator's registers: a row lives in the 4 threads of a quad (two
//   shuffles for its max; its sum stays split until the end), log2(e) is
//   folded into the scale and ex2.approx used. O += P V takes P from registers
//   and V from shared memory as the MN-major operand (the transpose bit),
//   64 output columns per instruction. P keeps f32 accuracy: it is split as
//   P_hi + P_lo, both bf16 (P_lo = bf16(P - P_hi)), and both products go
//   into the f32 accumulator, which leaves about 2^-17 relative error on
//   each weight where one bf16 rounding of P would leave 2^-9 (the check at
//   the prefill's shape, rtol 2^-7, fails with the latter where the
//   weighted values cancel); the row sum l is taken from the f32 P. The
//   split costs one more product: 1.5x the tensor-core work of the usual
//   design. setmaxnreg moves registers from the producer to the consumers.
//   Tiles wholly outside the causal / window band are skipped; only tiles
//   that the band (or S) cuts are masked elementwise; a row that has seen
//   only masked entries keeps m = -inf with p = 0. Blocks take the q-tiles
//   longest first, and the query heads of one KV head in adjacent blocks,
//   so they read their K/V through L2. Template widths DP: 64, 128 (BK 128)
//   and 256 (BK 64, to fit shared memory); the tensor maps zero-fill the
//   columns between D and DP. D must be a multiple of 8 (the TMA row
//   stride is a multiple of 16 bytes): the wrapper pads it otherwise.
//
// f32 (flash_kernel_f32): the CUDA cores. The tensor cores take f32 only as
//   TF32 (a 10-bit mantissa), which cannot hold the f32 check's atol 2e-5.
//   One block of 256 threads owns 64 query rows and stages each K/V tile
//   in shared memory as f32 (rows padded to DP + 4 so the strided reads
//   hit distinct banks); thread (ty, tx) of the 16 x 16 grid owns rows
//   4*ty .. 4*ty+3, so a row's m, l and acc live in one half-warp (shuffle
//   reductions); the probabilities pass through shared memory.
//
// The library is built with -fmad=false (hem_propose's bitwise contract),
// which would split every multiply-add in two: both kernels write theirs
// as fmaf.
#include <cuda.h>          // CUtensorMap and its enums; the driver is reached
                           // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32 route
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kThreads = 256;

// rows [r0, r0 + rows) of one (batch, head) slice, row stride `ld` elements,
// into f32 shared memory [rows][LDS]; zero past S and past D
template <int DP, int LDS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long ld, int r0, int rows, int S, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = src[(long long)(r0 + r) * ld + d];
    dst[r * LDS + d] = x;
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H,
                 int Hkv, int D, float scale, int causal, int window) {
  constexpr int LD = DP + 4;      // float4-aligned, conflict-free strided rows
  constexpr int CPT = BK / 16;    // score columns per thread
  constexpr int OPT = DP / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;       // [kBQ][BK] probabilities of the tile

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const long long ldq = (long long)H * D, ldk = (long long)Hkv * D;
  const float* qb = q + (long long)b * S * ldq + (long long)h * D;
  const float* kb = k + (long long)b * S * ldk + (long long)hk * D;
  const float* vb = v + (long long)b * S * ldk + (long long)hk * D;
  float* ob = o + (long long)b * S * ldq + (long long)h * D;

  load_tile<DP, LD>(Qs, qb, ldq, q0, kBQ, S, D);

  float m[4], l[4], acc[4][OPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OPT; ++c) acc[i][c] = 0.0f;
  }

  // k-tiles that hold an unmasked entry for some row of this q-tile
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_beg = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_beg / BK; t * BK < k_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<DP, LD>(Ks, kb, ldk, k0, BK, S, D);
    load_tile<DP, LD>(Vs, vb, ldk, k0, BK, S, D);
    __syncthreads();

    float s[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < S && (!causal || col <= row) &&
                          (window <= 0 || row - col < window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // nothing kept yet
      const float alpha = expf(m[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        Ps[(4 * ty + i) * BK + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int c = 0; c < OPT; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * BK + kk]);
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float v0 = Vs[(kk + 0) * LD + tx + 16 * c];
        const float v1 = Vs[(kk + 1) * LD + tx + 16 * c];
        const float v2 = Vs[(kk + 2) * LD + tx + 16 * c];
        const float v3 = Vs[(kk + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(p4[i].x, v0, a);
          a = fmaf(p4[i].y, v1, a);
          a = fmaf(p4[i].z, v2, a);
          a = fmaf(p4[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[(long long)row * ldq + col] = acc[i][c] * inv_l;
    }
  }
}

template <int DP>
int launch_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
               int H, int Hkv, int D, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int BK = DP >= 128 ? 32 : 64;   // keeps the f32 tiles near 64-140 KB
  constexpr int LD = DP + 4;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * BK) * LD + kBQ * BK);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_f32<DP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_kernel_f32<DP, BK><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, H, Hkv, D,
                                                             scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kRows = 128;                     // query rows per block
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kStages = 2;                     // K/V ring
constexpr int kThreadsW = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma operand descriptor of a tile of 128-byte rows in shared memory,
// 128-byte swizzled as TMA writes it (base 1024-aligned). The stride byte
// offset is 1024, that of 8-row groups: K-major Q and K step their rows by
// it, and the MN-major V steps its keys by it. The leading byte offset (for
// an MN-major operand, the stride between 64-column blocks) is not read:
// V is read 64 columns, one swizzle row, an instruction.
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>   // wait until at most N committed groups are in flight
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                        int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs in the
// accumulator's row layout), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// shared memory of one block, in bytes from a 1024-aligned base: the Q tile,
// the K and V rings (each tile DP / 64 boxes of [rows][64] bf16), barriers
template <int DP, int BK>
struct Layout {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kQBytes = kRows * DP * 2;
  static constexpr int kTileBytes = BK * DP * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;   // + alignment slack
};

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// S = Q K^T for the warpgroup's 64 rows: DP / 16 steps of 16 columns
template <int DP, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const uint8_t* qs,
                                         const uint8_t* ks) {
  wg_fence();
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd)
    wgmma_ss<BK>(sc, desc_b128(qs + (kd / 4) * kRows * 128 + (kd % 4) * 32),
                 desc_b128(ks + (kd / 4) * BK * 128 + (kd % 4) * 32), kd > 0);
  wg_commit();
}

// O += P_hi V + P_lo V: BK / 16 key steps, 64 output columns an instruction
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 64][32],
                                         const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4],
                                         const uint8_t* vs) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) fence_regs(acc[c]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      const uint64_t dv = desc_b128(vs + c * BK * 128 + kk * 16 * 128);
      wgmma_rs64(acc[c], p_hi[kk], dv);
      wgmma_rs64(acc[c], p_lo[kk], dv);
    }
  wg_commit();
}

// One tile's softmax update for this thread's rows r_lo and r_lo + 8:
// sc[4j + 2hh + e] is S at (r_lo + 8hh, k0 + 8j + c_th + e). Masks the tile
// if S or the band cuts it, updates m and l (l stays a per-thread partial
// sum until the end), leaves p = exp2((s - m) log2(e) / sqrt(D)) in sc and
// the factor for the accumulator in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int row0, int r_lo,
                                             int c_th, int S, int causal, int window,
                                             float scale_log2) {
  const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row0) ||
                    (window > 0 && row0 + 63 - k0 >= window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r_lo + 8 * hh, col = k0 + 8 * j + c_th + e;
          const bool keep = col < S && (!causal || col <= row) &&
                            (window <= 0 || row - col < window);
          if (!keep) sc[4 * j + 2 * hh + e] = -INFINITY;
        }
  }
  float mb[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));   // the row's quad
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // nothing kept yet
    alpha[hh] = ex2((m[hh] - m_use) * scale_log2);
    mb[hh] = m_use * scale_log2;
    m[hh] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hh + e];
        x = ex2(fmaf(x, scale_log2, -mb[hh]));
        rs[hh] += x;
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(alpha[hh], l[hh], rs[hh]);
}

template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 64][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) % 2];
}

// P = P_hi + P_lo as bf16 pairs in wgmma's A layout: register r of key step
// kk holds sc[8kk + 2r], sc[8kk + 2r + 1]
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2], uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int B, int S, int H, int Hkv, int DO, float scale_log2, int causal,
                   int window) {
  using L = Layout<DP, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // block -> (q-tile, batch, head): the longest causal rows first; the
  // query heads of one KV head in adjacent blocks
  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - blockIdx.x / (B * H)) * kRows;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  // k-tiles that hold an unmasked entry for some row of the block
  const int k_end = causal ? min(S, q0 + kRows) : S;
  const int k_beg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_beg / BK;
  const int n_t = (k_end + BK - 1) / BK - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers * 4);   // one arrival per consumer warp
      mbar_init(&v_empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(smem + c * kRows * 128, &tq, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kStages;
        const int k0 = (t0 + i) * BK;
        if (i >= kStages) mbar_wait(&k_empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&k_full[s], L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(smem + L::kK + s * L::kTileBytes + c * BK * 128, &tk, &k_full[s],
                   64 * c, hk, k0, b);
        if (i >= kStages) mbar_wait(&v_empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&v_full[s], L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(smem + L::kV + s * L::kTileBytes + c * BK * 128, &tv, &v_full[s],
                   64 * c, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg;                       // the warpgroup's first row
    const int r_lo = row0 + 16 * warp + lane / 4;        // this thread's rows: r_lo, r_lo + 8
    const int c_th = 2 * (lane % 4);                     // its first column in each 8
    const uint8_t* qs = smem + 64 * wg * 128;
    auto ks = [&](int i) { return smem + L::kK + (i % kStages) * L::kTileBytes; };
    auto vs = [&](int i) { return smem + L::kV + (i % kStages) * L::kTileBytes; };
    auto par = [](int i) { return (uint32_t)(i / kStages) & 1; };
    // a tile none of whose keys this warpgroup's rows keep is released
    // unread, after its copies have landed (the ring stays in step)
    auto dead = [&](int i) {
      const int k0 = (t0 + i) * BK;
      return row0 >= S || (causal && k0 > row0 + 63) ||
             (window > 0 && row0 - (k0 + BK - 1) >= window);
    };
    auto release = [&](uint64_t* bars, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[i % kStages]);
    };
    auto skip = [&](int i) {
      mbar_wait(&k_full[i % kStages], par(i));
      release(k_empty, i);
      mbar_wait(&v_full[i % kStages], par(i));
      release(v_empty, i);
    };

    float acc[DP / 64][32];                              // O [64 x DP], 64 columns a block
    float sc[BK / 2];                                    // S, then P, of one tile
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_t; ++i) {
      if (dead(i)) {
        skip(i);
        continue;
      }
      mbar_wait(&k_full[i % kStages], par(i));
      issue_qk<DP, BK>(sc, qs, ks(i));
      wg_wait<0>();
      fence_regs(sc);
      release(k_empty, i);
      softmax_tile<BK>(sc, m, l, alpha, (t0 + i) * BK, row0, r_lo, c_th, S, causal, window,
                       scale_log2);
      rescale<DP>(acc, alpha);
      split_p<BK>(sc, p_hi, p_lo);
      mbar_wait(&v_full[i % kStages], par(i));
      issue_pv<DP, BK>(acc, p_hi, p_lo, vs(i));
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) fence_regs(acc[c]);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(v_empty, i);
    }

    // epilogue: the row sums over the quad, then o = acc / l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = 1.0f / fmaxf(l[hh], 1e-30f);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= S) continue;
      __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * DO;
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + c_th;
          if (col < DO)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[c][4 * j + 2 * hh] * l[hh], acc[c][4 * j + 2 * hh + 1] * l[hh]);
        }
    }
  }
}


// cuTensorMapEncodeTiled, reached through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// tensor map of a contiguous bf16 [B, S, Hx, D] tensor, boxes of `rows`
// rows of one (batch, head) by 64 columns, 128-byte swizzled
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int Hx,
              int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hx * D * 2,
                                 (cuuint64_t)S * Hx * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  using L = Layout<DP, BK>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, H, D, kRows) ||
      !make_map(encode, &tk, k, B, S, Hkv, D, BK) ||
      !make_map(encode, &tv, v, B, S, Hkv, D, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_wgmma<DP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + kRows - 1) / kRows) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_kernel_wgmma<DP, BK><<<(unsigned)blocks, kThreadsW, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, Hkv, D, scale * kLog2e, causal,
      window);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int Hkv, int D) {
  return B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > 256;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int Hkv, int D, float scale,
                                   int causal, int window, cudaStream_t stream) {
  if (bad_shape(B, S, H, Hkv, D) || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
#define FLASH_F32(DP)                                                                   \
  return launch_f32<DP>(qt, kt, vt, ot, B, S, H, Hkv, D, scale, causal, window, stream)
  if (D <= 16) FLASH_F32(16);
  if (D <= 32) FLASH_F32(32);
  if (D <= 64) FLASH_F32(64);
  if (D <= 128) FLASH_F32(128);
  FLASH_F32(256);
#undef FLASH_F32
}

// D must be a multiple of 8 (the tensor maps' row stride is a multiple of
// 16 bytes) and every pointer 16-byte aligned
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int Hkv, int D, float scale,
                                    int causal, int window, cudaStream_t stream) {
  if (bad_shape(B, S, H, Hkv, D) || D % 8 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_wgmma<64, 128>(q, k, v, o, B, S, H, Hkv, D, scale, causal, window, stream);
  if (D <= 128)
    return launch_wgmma<128, 128>(q, k, v, o, B, S, H, Hkv, D, scale, causal, window, stream);
  return launch_wgmma<256, 64>(q, k, v, o, B, S, H, Hkv, D, scale, causal, window, stream);
}

// bytes of dynamic shared memory a block of the bf16 kernel takes at width D
extern "C" int flash_attention_bf16_smem(int D) {
  if (D <= 64) return Layout<64, 128>::kBytes;
  if (D <= 128) return Layout<128, 128>::kBytes;
  return Layout<256, 64>::kBytes;
}
