// Fused FIR -> forward FFT: Y[r, :] = fft(filtered[r * N : (r + 1) * N]) with
// filtered[i] = sum_k taps[k] * x[i - k], without the filtered stream ever
// reaching device memory.
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_fir_fft_kernel
// (wrapper pallas_fir_fft).
//
// Bound on an H100: memory. A complex64 stream moves 16 bytes per sample (8 in,
// 8 out) against 4 * n_taps + 5 * log2(N) FLOP per sample (311 at 64 taps and
// N = 2048): 4 MB and 82 MFLOP per 2^18-sample frame, about 1.25 us at
// 3.35 TB/s against about 1.2 us at 67 TFLOP/s FP32.
//
// Design: one thread block per N-sample row. The block stages the row and the
// n_taps - 1 samples before it (from the row above, or from `hist` for row 0)
// in shared memory, runs the FIR MAC in FP32 into a second shared buffer, and
// transforms that buffer in place:
//  * N a power of two: the MAC writes in bit-reversed order and an iterative
//    radix-2 decimation-in-time FFT runs over log2(N) stages;
//  * any other N: a direct DFT, each output a sum over the row.
// Twiddles come from a table the host builds in float64: entry k holds
// (cos, sin)(2 pi k / N), and the phase index (c * j) mod N is reduced in
// integers before the lookup, the accuracy rule of the TPU kernel's twiddles.
// The TPU kernel's dense DFT matmul (8 * N FLOP per sample, about 64 us per
// 2^18 frame at FP32) is not carried over.
//
// bf16 mode: samples and taps are rounded to bf16 when they are staged (their
// products are exact in FP32 and accumulate in FP32), and the filtered row is
// rounded to bf16 before the transform, which then runs in FP32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float prep(float v) {
  return BF16 ? bf16_round(v) : v;
}

__device__ __forceinline__ float2 load(const float* p, long long i) {
  return make_float2(p[i], 0.f);
}
__device__ __forceinline__ float2 load(const float2* p, long long i) { return p[i]; }

template <typename T, bool BF16>
__global__ void __launch_bounds__(kThreads)
fir_fft_kernel(const T* __restrict__ hist, const T* __restrict__ x,
               const float* __restrict__ taps, const float2* __restrict__ tw,
               float2* __restrict__ y, int n_fft, int log2n, int nt) {
  extern __shared__ float2 smem[];
  float2* s_in = smem;                           // n_fft + nt - 1 samples
  float2* s_v = s_in + (n_fft + nt - 1);         // n_fft filtered samples
  float* s_taps = reinterpret_cast<float*>(s_v + n_fft);
  const long long row0 = static_cast<long long>(blockIdx.x) * n_fft;
  const int span = n_fft + nt - 1;

  for (int i = threadIdx.x; i < nt; i += kThreads) s_taps[i] = prep<BF16>(taps[i]);
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = row0 - (nt - 1) + i;     // stream index, >= -(nt - 1)
    float2 v = g >= 0 ? load(x, g) : load(hist, nt - 1 + g);
    s_in[i] = make_float2(prep<BF16>(v.x), prep<BF16>(v.y));
  }
  __syncthreads();

  // FIR MAC: v[c] = sum_k taps[k] * s_in[c + nt - 1 - k]
  for (int c = threadIdx.x; c < n_fft; c += kThreads) {
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < nt; ++k) {
      const float t = s_taps[k];
      const float2 v = s_in[c + nt - 1 - k];
      ar = fmaf(t, v.x, ar);
      ai = fmaf(t, v.y, ai);
    }
    const int dst = log2n >= 0 ? static_cast<int>(__brev(c) >> (32 - log2n)) : c;
    s_v[dst] = make_float2(prep<BF16>(ar), prep<BF16>(ai));
  }
  __syncthreads();

  if (log2n >= 0) {
    // radix-2 DIT over bit-reversed input; forward twiddle exp(-i theta)
    const int half_n = n_fft >> 1;
    for (int s = 1; s <= log2n; ++s) {
      const int half = 1 << (s - 1);
      const int shift = log2n - s;               // twiddle index = pos * N / len
      for (int b = threadIdx.x; b < half_n; b += kThreads) {
        const int pos = b & (half - 1);
        const int i = ((b >> (s - 1)) << s) + pos;
        const int j = i + half;
        const float2 w = tw[pos << shift];
        const float2 u = s_v[i];
        const float2 v = s_v[j];
        const float tr = v.x * w.x + v.y * w.y;
        const float ti = v.y * w.x - v.x * w.y;
        s_v[i] = make_float2(u.x + tr, u.y + ti);
        s_v[j] = make_float2(u.x - tr, u.y - ti);
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < n_fft; c += kThreads) y[row0 + c] = s_v[c];
  } else {
    // direct DFT: Y[c] = sum_j v[j] * exp(-2 pi i ((c * j) mod N) / N)
    for (int c = threadIdx.x; c < n_fft; c += kThreads) {
      float ar = 0.f, ai = 0.f;
      int idx = 0;
      for (int j = 0; j < n_fft; ++j) {
        const float2 w = tw[idx];
        const float2 v = s_v[j];
        ar = fmaf(v.x, w.x, fmaf(v.y, w.y, ar));
        ai = fmaf(v.y, w.x, fmaf(-v.x, w.y, ai));
        idx += c;
        if (idx >= n_fft) idx -= n_fft;
      }
      y[row0 + c] = make_float2(ar, ai);
    }
  }
}

template <typename T, bool BF16>
cudaError_t launch(const void* hist, const void* x, const void* taps,
                   const void* tw, void* y, long long rows, int n_fft, int log2n,
                   int nt, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(n_fft) + nt - 1) * sizeof(float2) +
                      nt * sizeof(float);
  auto kern = fir_fft_kernel<T, BF16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(x),
      static_cast<const float*>(taps), static_cast<const float2*>(tw),
      static_cast<float2*>(y), n_fft, log2n, nt);
  return cudaGetLastError();
}

}  // namespace

// x: rows * n_fft samples; hist: the nt - 1 samples before x (never null);
// tw: n_fft (cos, sin) pairs; y: rows * n_fft complex64. log2n is log2(n_fft)
// for a power of two, else -1. Returns cudaGetLastError() after the launch.
extern "C" int fsdr_fir_fft(const void* hist, const void* x, const void* taps,
                            const void* tw, void* y, long long rows, int n_fft,
                            int log2n, int nt, int is_complex, int bf16,
                            void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return bf16 ? launch<float2, true>(hist, x, taps, tw, y, rows, n_fft, log2n, nt, s)
                : launch<float2, false>(hist, x, taps, tw, y, rows, n_fft, log2n, nt, s);
  }
  return bf16 ? launch<float, true>(hist, x, taps, tw, y, rows, n_fft, log2n, nt, s)
              : launch<float, false>(hist, x, taps, tw, y, rows, n_fft, log2n, nt, s);
}
