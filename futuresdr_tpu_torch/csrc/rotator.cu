// Phase-ramp rotator: y[t] = x[t] * exp(i * (ph0 + inc * t)).
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_rotator_kernel
// (wrapper pallas_rotator).
//
// Bound on an H100: memory. 16 bytes per sample (8 in, 8 out) against about 40
// FLOP (a range reduction, a sincosf and one complex multiply): a 512,000-sample
// frame moves 8.2 MB, about 2.4 us at 3.35 TB/s.
//
// Design: one thread per sample (kPerThread samples a thread, a block's loads
// coalesced as float2), the absolute sample index t rebuilt from the block
// position, as the TPU kernel rebuilt it from its grid step. ph0 and inc are
// read through device pointers from the stage's carry, so a retune reaches the
// kernel with no host read and the launch stays capturable in a CUDA graph.
//
// Numerics: the phase is float32 ph0 + inc * t with the product and the sum each
// rounded (__fmul_rn / __fadd_rn). nvcc would otherwise contract them into one
// FMA, and at t = 5e5 the phase is ~3e5 rad, where one float32 ulp is 0.03 rad:
// a contracted phase differs from the reference's by a visible fraction of the
// output. The sine and cosine are those of that float32 phase, never of a
// fast approximation (__sincosf is wrong by far more at such arguments). Above
// |ph| ~ 1e5 sincosf would take its slow range reduction, which made it the
// kernel's cost; instead the phase, exact in double, is reduced by 2*pi in
// double (error ~1e-10 rad at |ph| = 2.6e6) and the remainder, |r| <= pi, goes
// to the fast path of sincosf: the result is within ~2e-7 of sincosf(ph). The
// complex multiply keeps its products and sums separately rounded.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;

__global__ void __launch_bounds__(kThreads)
rotator_kernel(const float2* __restrict__ x, const float* __restrict__ ph0p,
               const float* __restrict__ incp, float2* __restrict__ y,
               long long n) {
  const float ph0 = *ph0p;
  const float inc = *incp;
  const long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long t = base + j * kThreads;
    if (t < n) {
      const float ph = __fadd_rn(ph0, __fmul_rn(inc, static_cast<float>(t)));
      const double k = rint(static_cast<double>(ph) * kInvTwoPi);
      const float r = static_cast<float>(fma(-k, kTwoPi, static_cast<double>(ph)));
      float s, c;
      sincosf(r, &s, &c);
      const float2 v = x[t];
      y[t] = make_float2(__fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s)),
                         __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c)));
    }
  }
}

}  // namespace

// x, y: n complex64 samples; ph0, inc: one float32 each, on the device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fsdr_rotator(const void* x, const void* ph0, const void* inc, void* y,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  rotator_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(ph0),
      static_cast<const float*>(inc), static_cast<float2*>(y), n);
  return cudaGetLastError();
}
