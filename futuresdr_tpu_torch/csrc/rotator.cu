// Phase-ramp rotator: y[t] = x[t] * exp(i * (ph0 + inc * t)), and the stage's
// next phase remainder(ph0 + inc * n, 2*pi).
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_rotator_kernel
// (wrapper pallas_rotator).
//
// Bound on an H100: memory. 16 bytes per sample (8 in, 8 out) against about 40
// FLOP (a range reduction, a sincosf and one complex multiply): a 512,000-sample
// frame moves 8.2 MB, about 2.4 us at 3.35 TB/s.
//
// Design: a stream of 16-byte words, each two samples, one word a thread,
// kThreads threads and one tile a block (so a warp's load is 512 contiguous
// bytes, and its one load goes out before any phase math). Several words a
// thread, other block sizes and a grid-stride walk measured no faster
// (port_plans.py, PERF.md). A complex64 tensor may start at an odd sample (a
// view x[1:]): the wrapper hands the kernel a head of 0 or 1 scalar samples
// before the first 16-byte boundary and allocates the output at the same
// offset; a last odd sample is the scalar tail. Thread 0 of block 0 computes
// the head, the tail and the carry, writing the next phase to its own output
// (never over ph0, which the other blocks are still reading); it loads the
// head and tail samples before its word, so that block 0 does not end one
// DRAM latency after the others. ph0 and inc are read through device pointers
// from the stage's carry, so a retune reaches the kernel with no host read and
// the launch stays capturable in a CUDA graph.
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
// complex multiply keeps its products and sums separately rounded. The carry
// repeats PyTorch's float32 torch.remainder(ph0 + inc * n, 2*pi) on CUDA:
// the rounded product and sum, fmodf by float32(2*pi), and the divisor added
// where the remainder's sign differs from it.
//
// Lanes (fsdr_rotator_lanes, the serving plane's [L, n] batch): the lane is the
// grid's y dimension. Lane l reads and writes its row of x and y (rows `stride`
// samples apart, the same in both) and its own ph0[l], inc[l] and ph_next[l];
// its head is (head + l * stride) & 1, so an odd row length is taken as it
// comes. A lane runs exactly the one-stream kernel's arithmetic on its row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;

__device__ __forceinline__ float2 rotate(float2 v, float ph0, float inc, long long t) {
  const float ph = __fadd_rn(ph0, __fmul_rn(inc, static_cast<float>(t)));
  const double k = rint(static_cast<double>(ph) * kInvTwoPi);
  const float r = static_cast<float>(fma(-k, kTwoPi, static_cast<double>(ph)));
  float s, c;
  sincosf(r, &s, &c);
  return make_float2(__fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s)),
                     __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c)));
}

__global__ void __launch_bounds__(kThreads)
rotator_kernel(const float2* __restrict__ x, const float* __restrict__ ph0p,
               const float* __restrict__ incp, float2* __restrict__ y,
               float* __restrict__ ph_next, long long n, int head, long long stride) {
  // this block's lane: its rows of x and y, its phase and increment
  const long long lane_id = blockIdx.y;
  x += lane_id * stride;
  y += lane_id * stride;
  ph_next += lane_id;
  if (n > 0) head = static_cast<int>((head + lane_id * stride) & 1);
  const float ph0 = ph0p[lane_id];
  const float inc = incp[lane_id];
  const long long words = (n - head) >> 1;
  const long long tail = head + 2 * words;
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // thread 0 of block 0 also takes the head and the tail: their loads go out
  // with its word's, their math comes after it
  const bool edges = blockIdx.x == 0 && threadIdx.x == 0;
  float2 xh = make_float2(0.f, 0.f), xt = make_float2(0.f, 0.f);
  if (edges && head) xh = __ldg(x);
  if (edges && tail < n) xt = __ldg(x + tail);
  if (w < words) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + head) + w);
    const long long t = head + 2 * w;
    const float2 a = rotate(make_float2(v.x, v.y), ph0, inc, t);
    const float2 b = rotate(make_float2(v.z, v.w), ph0, inc, t + 1);
    reinterpret_cast<float4*>(y + head)[w] = make_float4(a.x, a.y, b.x, b.y);
  }
  if (edges) {
    if (head) y[0] = rotate(xh, ph0, inc, 0);
    if (tail < n) y[tail] = rotate(xt, ph0, inc, tail);
    const float a = __fadd_rn(ph0, __fmul_rn(inc, static_cast<float>(n)));
    const float b = static_cast<float>(kTwoPi);
    float mod = fmodf(a, b);
    if (mod != 0.f && ((b < 0.f) != (mod < 0.f))) mod = __fadd_rn(mod, b);
    *ph_next = mod;
  }
}

int run(const void* x, const void* ph0, const void* inc, void* y, void* ph_next,
        long long n, int head, int lanes, long long stride, void* stream) {
  const auto* xs = static_cast<const float2*>(x);
  auto* ys = static_cast<float2*>(y);
  if (lanes == 0) return 0;
  if (n < 0 || (head != 0 && head != 1) || head > n || lanes < 0 || lanes > 65535 ||
      (lanes > 1 && stride < n) || reinterpret_cast<uintptr_t>(xs + head) % 16 ||
      reinterpret_cast<uintptr_t>(ys + head) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = n / 2;               // the most any lane's head leaves
  const unsigned blocks =
      words ? static_cast<unsigned>((words + kThreads - 1) / kThreads) : 1u;
  const dim3 grid(blocks, static_cast<unsigned>(lanes));
  rotator_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, static_cast<const float*>(ph0), static_cast<const float*>(inc), ys,
      static_cast<float*>(ph_next), n, head, stride);
  return cudaGetLastError();
}

}  // namespace

// x, y: n complex64 samples, x + head and y + head 16-byte aligned; ph0, inc:
// one float32 each, on the device; ph_next: one float32, receives
// remainder(ph0 + inc * n, 2*pi); head: 0 or 1 scalar samples before the
// 16-byte words. n may be 0: the kernel then writes the carry alone. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head or
// an alignment the kernel does not take.
extern "C" int fsdr_rotator(const void* x, const void* ph0, const void* inc, void* y,
                            void* ph_next, long long n, int head, void* stream) {
  return run(x, ph0, inc, y, ph_next, n, head, 1, 0, stream);
}

// The lane form: `lanes` rows of n samples `stride` samples apart in x and in y
// (head: lane 0's), ph0, inc and ph_next `lanes` float32 each.
extern "C" int fsdr_rotator_lanes(const void* x, const void* ph0, const void* inc,
                                  void* y, void* ph_next, long long n, int head,
                                  int lanes, long long stride, void* stream) {
  return run(x, ph0, inc, y, ph_next, n, head, lanes, stride, stream);
}
