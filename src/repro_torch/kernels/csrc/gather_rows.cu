// gather_rows: out[b, j] = src[clip(idx[b, j], 0, S - 1)] for a 1-D src of
// 32-bit words (f32 and i32 share the kernel: no arithmetic touches them,
// so the result is bitwise the plain version's).
//
// Replaces the TPU kernel src/repro/kernels/split.py:gather_rows_pallas
// (body _gather_rows_kernel), which kept src resident in VMEM while index
// tiles streamed through.
//
// Bound on the H100: bytes. Each output word costs one 4-byte index read,
// one 4-byte store and one random 4-byte read of src. The split op hands it
// [k, L] index arrays with L up to 2^24, so src (up to 64 MB) does not fit
// the 50 MB L2 and the random reads are the cost. Design: one thread per
// output element in a grid-stride loop, so index reads and output stores
// are fully coalesced; src goes through the read-only path (__restrict__
// const). A faster version would sort or tile by src locality; the split's
// indices are mostly increasing (stable compaction), which already keeps
// neighbouring threads on neighbouring src lines.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void gather_rows_kernel(const uint32_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out,
                                   int S, long long total) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < total; i += stride) {
    int j = idx[i];
    j = j < 0 ? 0 : (j >= S ? S - 1 : j);
    out[i] = src[j];
  }
}

}  // namespace

extern "C" int gather_rows_u32(const void* src, const void* idx, void* out,
                               int S, long long total, cudaStream_t stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // 16 blocks of 256 per SM, grid-stride beyond
  const int blocks = (int)(want < cap ? want : cap);
  gather_rows_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(src), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), S, total);
  return (int)cudaGetLastError();
}
