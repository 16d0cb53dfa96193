// Quadrature (FM) demodulator: y[t] = gain * atan2(Im z, Re z), z = x[t] * conj(x[t-1]).
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_quad_demod_kernel
// (wrapper pallas_quad_demod).
//
// Bound on an H100: memory. 12 bytes per sample (8 in, 4 out) against about 30
// FLOP (one complex product and an atan2f): a 128,000-sample frame moves 1.5 MB,
// about 0.46 us at 3.35 TB/s.
//
// Design: one thread per sample; thread t reads x[t] and x[t-1] (the second
// load hits the cache line its neighbour loaded), x[-1] through a pointer to
// the stage's carry sample. The thread that reads the frame's last sample also
// writes it to `last`, the stage's next carry, so the carry is a buffer of its
// own (never a view of an input frame) at no extra launch. The TPU kernel's
// shift of one lane across 128-lane tiles has no counterpart: a thread reads
// its neighbour directly.
//
// Lanes (fsdr_quad_demod_lanes, the serving plane's [L, n] batch, the
// counterpart of jax.vmap over pallas_quad_demod): the lane is the grid's y
// dimension, as in rotator.cu. Lane l reads its row of x and writes its row of
// y (rows xs and ys elements apart), its own prev[l], and its last thread
// writes last[l]; gain is shared. A lane runs exactly the one-stream kernel's
// arithmetic on its row, so each lane is bit-equal to a one-stream launch.
// 64 lanes of 8,000 samples (the FM front end served at 32,000 input samples
// a session) move 6.1 MB, about 1.8 us at 3.35 TB/s: one launch where one a
// lane paid 64 launch latencies. The grid is 2,048 blocks there, about two
// waves, and runs in a copy's time of its bytes in 16-byte words; its loads
// alone read at 0.87 of the card's rate beyond an empty launch on that grid
// (port_lanes.py --breakdown, PERF.md). Walks of the batch as one run of
// samples, 2 or 4 a thread in 16-byte words (one wave), and this grid in
// blocks of 512 or 1,024 threads all launched faster and ran slower: fewer
// threads hid less of each sample's load and atan2f latency.
//
// Numerics: Re z = xr*pr + xi*pi and Im z = xi*pr - xr*pi as the TPU kernel
// forms them, each product and sum rounded on its own (__fmul_rn / __fadd_rn,
// no contraction into FMAs), then the full-precision atan2f and one rounded
// multiply by gain.

#include <cuda_runtime.h>

// The breakdown's cuts (port_lanes.py --breakdown): a build with
// -DFSDR_CUT_LOAD runs each sample's loads alone (x[t] and its neighbour, kept
// alive by a store that fires only where their bits hash to n), one with
// -DFSDR_CUT_MATH the arithmetic alone (its operands made in registers from
// t, the result kept alive the same way) and one with -DFSDR_CUT_STORE the
// stores alone (gain to y, the operands to last). With none defined a sample
// is loaded, demodulated and stored as below, and the kernel compiles as it
// would without these lines.
#if defined(FSDR_CUT_MATH) || defined(FSDR_CUT_STORE)
#define QD_LOADS 0
#else
#define QD_LOADS 1
#endif

namespace {

constexpr int kThreads = 256;

// operands in registers, for the cuts without loads: distinct a sample,
// unknown to the compiler
__device__ __forceinline__ float2 cut_operand(long long t, float gain) {
  return make_float2(__ll2float_rn(t), gain);
}

// a store the compiler cannot prove dead: `v` written where `bits` equals n
__device__ __forceinline__ void cut_keep(float* y, unsigned bits, long long n, float v) {
  if (bits == static_cast<unsigned>(n)) *y = v;
}

__device__ __forceinline__ unsigned cut_bits(float2 a, float2 b) {
  return __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(b.x) ^
         __float_as_uint(b.y);
}

__global__ void __launch_bounds__(kThreads)
quad_demod_kernel(const float2* __restrict__ x, const float2* __restrict__ prev,
                  float* __restrict__ y, float2* __restrict__ last, long long n,
                  float gain, long long xs, long long ys) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const unsigned lane = blockIdx.y;
  x += lane * xs;
  y += lane * ys;
  prev += lane;
  last += lane;
#if QD_LOADS
  const float2 v = x[t];
  const float2 p = t == 0 ? *prev : x[t - 1];
#else
  const float2 v = cut_operand(t, gain), p = cut_operand(t + 1, gain);
#endif
#if defined(FSDR_CUT_LOAD)
  cut_keep(y + t, cut_bits(v, p), n, gain);
#elif defined(FSDR_CUT_STORE)
  y[t] = gain;
#else
  const float zr = __fadd_rn(__fmul_rn(v.x, p.x), __fmul_rn(v.y, p.y));
  const float zi = __fsub_rn(__fmul_rn(v.y, p.x), __fmul_rn(v.x, p.y));
#if defined(FSDR_CUT_MATH)
  const float out = __fmul_rn(gain, atan2f(zi, zr));
  cut_keep(y + t, __float_as_uint(out), n, out);
#else
  y[t] = __fmul_rn(gain, atan2f(zi, zr));
#endif
#endif
  if (t == n - 1) *last = v;
}

int run(const void* x, const void* prev, void* y, void* last, long long n, float gain,
        int lanes, long long xs, long long ys, void* stream) {
  if (n <= 0 || lanes == 0) return 0;
  if (lanes < 0 || lanes > 65535 || (lanes > 1 && (xs < n || ys < n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(lanes));
  quad_demod_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(prev),
      static_cast<float*>(y), static_cast<float2*>(last), n, gain, xs, ys);
  return cudaGetLastError();
}

}  // namespace

// x: n complex64 samples; prev: the sample before x; y: n float32 outputs;
// last: receives x[n - 1]. Returns cudaGetLastError() after the launch.
extern "C" int fsdr_quad_demod(const void* x, const void* prev, void* y, void* last,
                               long long n, float gain, void* stream) {
  return run(x, prev, y, last, n, gain, 1, 0, 0, stream);
}

// The lane form: `lanes` rows of n samples, lane l's at x + l * xs and
// y + l * ys (elements), its carry sample prev[l] and its next carry last[l]
// (`lanes` complex64 each, contiguous). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for rows that overlap.
extern "C" int fsdr_quad_demod_lanes(const void* x, const void* prev, void* y, void* last,
                                     long long n, float gain, int lanes, long long xs,
                                     long long ys, void* stream) {
  return run(x, prev, y, last, n, gain, lanes, xs, ys, stream);
}
