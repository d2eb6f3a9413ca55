// flash_attention: o = softmax(mask(q k^T * D^-1/2)) v for each of the BH
// slices of q, k, v [BH, S, D] (heads flattened, GQA already expanded by the
// caller), with f32 accumulation and the output in the input type (bf16 or
// f32). Masks: key columns past S, `causal` (col <= row) and `window > 0`
// (row - col < window), with or without `causal`.
//
// Replaces the TPU kernel src/repro/kernels/flashattn.py:flash_attention_pallas
// (body _flash_kernel): tiled online-softmax SDPA whose running max,
// normaliser and accumulator never leave fast memory, so no [S, S] logits
// reach device memory.
//
// Bound on the H100: operations. A causal call does about 2 * BH * S^2 * D
// multiply-adds (QK^T and PV over the lower triangle), against 989 TFLOP/s
// in bf16 on the tensor cores; its bytes (q, k, v read once, o written once)
// are 4 * BH * S * D elements. This first design runs on the CUDA cores in
// f32 (67 TFLOP/s at best), with explicit fmaf: the library is built with
// -fmad=false for hem_propose's bitwise contract, which would otherwise split
// every multiply-add in two. Tensor cores (mma.sync / wgmma with TMA) are the
// next step.
//
// Design. The TPU kernel walks the k-tiles as the sequential last axis of its
// grid, carrying m, l and acc in VMEM scratch. Here one block of 256 threads
// owns a tile of BQ = 64 query rows and walks the k-tiles itself in a loop,
// staging each K/V tile in shared memory (as f32, rows padded to DP + 4 so
// the strided reads hit distinct banks). Thread (ty, tx) of the 16 x 16 grid
// owns query rows 4*ty .. 4*ty+3: columns tx + 16*j of the score tile and
// columns tx + 16*c of the output, so m, l and acc of a row stay in the
// registers of the 16 threads of one half-warp, reduced by shuffles. The
// probabilities go through shared memory between the two products.
// Tiles wholly outside the causal / window band are skipped; inside a tile,
// masked entries are -inf and a row that has seen only masked entries keeps
// m = -inf with p = 0 (the TPU body instead lets p = 1 stand on such entries
// until a later tile's alpha = exp(NEG - m) = 0 wipes them: the same
// function). D is padded with zeros to DP in {16, 32, 64, 128, 256} (a
// template parameter), S is ragged: the block masks its own edge.
// Blocks take the q-tiles from the last (the longest causal rows) down.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// rows [r0, r0 + rows) of one [S, D] slice into f32 shared memory [rows][LD],
// zero past S and past D
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int S, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = to_f32(src[(long long)(r0 + r) * D + d]);
    dst[r * LD + d] = x;
  }
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int D,
             float scale, int causal, int window) {
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
  const long long base = (long long)blockIdx.x * S * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  load_tile<T, DP, LD>(Qs, qb, q0, kBQ, S, D);

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
    load_tile<T, DP, LD>(Ks, kb, k0, BK, S, D);
    load_tile<T, DP, LD>(Vs, vb, k0, BK, S, D);
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
      if (col < D) store(&o[base + (long long)row * D + col], acc[i][c] * inv_l);
    }
  }
}

template <typename T, int DP>
int launch_dp(const T* q, const T* k, const T* v, T* o, int BH, int S, int D,
              float scale, int causal, int window, cudaStream_t stream) {
  constexpr int BK = DP >= 128 ? 32 : 64;   // keeps the f32 tiles near 64-140 KB
  constexpr int LD = DP + 4;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * BK) * LD + kBQ * BK);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_kernel<T, DP, BK><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, D, scale,
                                                            causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int D, float scale, int causal, int window, cudaStream_t stream) {
  if (BH < 1 || S < 1 || D < 1 || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (D <= 16) return launch_dp<T, 16>(qt, kt, vt, ot, BH, S, D, scale, causal, window, stream);
  if (D <= 32) return launch_dp<T, 32>(qt, kt, vt, ot, BH, S, D, scale, causal, window, stream);
  if (D <= 64) return launch_dp<T, 64>(qt, kt, vt, ot, BH, S, D, scale, causal, window, stream);
  if (D <= 128) return launch_dp<T, 128>(qt, kt, vt, ot, BH, S, D, scale, causal, window, stream);
  if (D <= 256) return launch_dp<T, 256>(qt, kt, vt, ot, BH, S, D, scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int BH, int S, int D, float scale,
                                   int causal, int window, cudaStream_t stream) {
  return launch<float>(q, k, v, o, BH, S, D, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int BH, int S, int D, float scale,
                                    int causal, int window, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, S, D, scale, causal, window, stream);
}
