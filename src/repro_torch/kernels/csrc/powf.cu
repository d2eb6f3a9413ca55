// powf: the C library's powf(x, y) (glibc 2.28 and later, x86_64 with FMA)
// bit for bit, elementwise, for 0 < y < 1: the exponent 1/d of the adaptive
// imbalance (core/hierarchy.py: _powf). Not a TPU kernel: the reference's
// XLA program on the CPU calls the C library's powf, which is not correctly
// rounded, so the card reproduces its algorithm step by step.
//
// log2(x) = log1p(z/c - 1)/ln2 + log2(c) + k, with x = 2^k z, from a
// 16-entry table and a degree-5 polynomial; then 2^(y log2 x) = 2^(k/32) *
// 2^r from a 32-entry table and a degree-3 polynomial; all in float64,
// rounded once to float32. Every multiply-add that glibc's FMA build fuses is
// one __fma_rn here, every other product and sum a __dmul_rn or __dadd_rn
// (the library is built with -fmad=false). The tables come in from
// kernels/powf.py, whose numpy plain version (powf_ref) is held against the
// C library on every float32 in [1, 8) at d = 3, 4 and 5.
//
// Bound: a few hundred values a call (one per subgraph of a level); the
// launch is the cost. One thread an element.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kOff = 0x3f330000u;

// tb: 16 x (1/c, log2 c), 5 log2 coefficients, 32 exp2 table words (as the
// bits of doubles), 3 exp2 coefficients
__device__ float powf_glibc(float x, float y, const double* __restrict__ tb) {
  unsigned ix = __float_as_uint(x);
  if (ix - 0x00800000u >= 0x7f800000u - 0x00800000u) {
    if (2u * ix - 1u >= 2u * 0x7f800000u - 1u) return __fmul_rn(x, x);  // +-0, +-inf, NaN
    if (ix & 0x80000000u) return CUDART_NAN_F;   // finite x < 0, y not an integer
    ix = __float_as_uint(__fmul_rn(x, 8388608.0f)) & 0x7fffffffu;   // subnormal
    ix -= 23u << 23;
  }
  const unsigned tmp = ix - kOff;
  const int i = (tmp >> 19) % 16;
  const unsigned top = tmp & 0xff800000u;
  const double z = (double)__uint_as_float(ix - top);
  const double k = (double)((int)top >> 23);
  const double* A = tb + 32;
  const double r = __fma_rn(z, tb[2 * i], -1.0);
  const double y0 = __dadd_rn(tb[2 * i + 1], k);
  const double r2 = __dmul_rn(r, r);
  const double p1 = __fma_rn(A[0], r, A[1]);
  const double p2 = __fma_rn(A[2], r, A[3]);
  const double r4 = __dmul_rn(r2, r2);
  double q = __fma_rn(A[4], r, y0);
  q = __fma_rn(p2, r2, q);
  const double logx = __fma_rn(p1, r4, q);

  const double xd = __dmul_rn((double)y, logx);
  const double shift = 0x1.8p47;   // xd + shift rounds xd to a multiple of 1/32
  const double kd = __dadd_rn(xd, shift);
  const unsigned long long ki = (unsigned long long)__double_as_longlong(kd);
  const double rr = __dadd_rn(xd, -__dadd_rn(kd, -shift));
  const unsigned long long t =
      (unsigned long long)__double_as_longlong(tb[37 + (ki % 32)]) + (ki << 47);
  const double s = __longlong_as_double((long long)t);
  const double* C = tb + 69;
  const double zc = __fma_rn(C[0], rr, C[1]);
  const double rr2 = __dmul_rn(rr, rr);
  double out = __fma_rn(C[2], rr, 1.0);
  out = __fma_rn(zc, rr2, out);
  return __double2float_rn(__dmul_rn(out, s));
}

__global__ void powf_kernel(const float* __restrict__ x, float* __restrict__ out,
                            const double* __restrict__ tb, int n, float y) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = powf_glibc(x[e], y, tb);
}

}  // namespace

extern "C" int powf_f32(const void* x, void* out, const void* tables, int n, float y,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!(y > 0.0f && y < 1.0f)) return (int)cudaErrorInvalidValue;
  powf_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const double*>(tables), n, y);
  return (int)cudaGetLastError();
}
