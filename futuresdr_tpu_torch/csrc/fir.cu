// Streaming causal FIR with real taps: y[i] = sum_k taps[k] * x[i - k].
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_fir_kernel
// (wrappers pallas_fir / pallas_fir_continue).
//
// Bound on an H100: memory. A complex64 stream moves 16 bytes per sample (8 in,
// 8 out) against 4 * n_taps FLOP per sample, i.e. 256 FLOP at 64 taps: 4 MB and
// 67 MFLOP per 2^18-sample frame, about 1.25 us at 3.35 TB/s against about 1 us
// at 67 TFLOP/s FP32.
//
// Design: one thread block per tile of kTile outputs. The block stages its tile
// plus the n_taps - 1 samples before it in shared memory (read once from device
// memory; the samples before the frame come from the separate `hist` pointer, so
// a streaming continuation needs no concatenation in device memory) and the taps
// in shared memory. Each thread accumulates kPerThread outputs in FP32
// registers. A complex stream is read as float2 and filtered in ONE pass with
// the real taps; the TPU kernel's two real passes were only its lane layout.
//
// bf16 mode (precision="bf16"): samples and taps are rounded to bf16 when they
// are staged; products of two bf16 values are exact in FP32 and accumulate in
// FP32, as the reference's bf16 mode computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float prep(float v) {
  return BF16 ? bf16_round(v) : v;
}

template <bool BF16>
__device__ __forceinline__ float2 prep(float2 v) {
  return BF16 ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

__device__ __forceinline__ void mac(float& acc, float t, float v) { acc = fmaf(t, v, acc); }

__device__ __forceinline__ void mac(float2& acc, float t, float2 v) {
  acc.x = fmaf(t, v.x, acc.x);
  acc.y = fmaf(t, v.y, acc.y);
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const T* __restrict__ hist, const T* __restrict__ x,
           const float* __restrict__ taps, T* __restrict__ y,
           long long n, int nt) {
  extern __shared__ float2 smem[];
  T* s_x = reinterpret_cast<T*>(smem);                 // kTile + nt - 1 samples
  float* s_taps = reinterpret_cast<float*>(s_x + kTile + nt - 1);
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int span = kTile + nt - 1;

  for (int i = threadIdx.x; i < nt; i += kThreads) s_taps[i] = prep<BF16>(taps[i]);
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = base - (nt - 1) + i;            // stream index
    T v = zero<T>();
    if (g >= 0) {
      if (g < n) v = x[g];
    } else if (hist != nullptr) {
      v = hist[nt - 1 + g];                             // g in [-(nt-1), -1]
    }
    s_x[i] = prep<BF16>(v);
  }
  __syncthreads();

  T acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = zero<T>();
  // y[base + i] = sum_k taps[k] * s_x[i + nt - 1 - k]
  for (int k = 0; k < nt; ++k) {
    const float t = s_taps[k];
    const int off = nt - 1 - k;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      mac(acc[j], t, s_x[threadIdx.x + j * kThreads + off]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long o = base + threadIdx.x + j * kThreads;
    if (o < n) y[o] = acc[j];
  }
}

template <typename T, bool BF16>
cudaError_t launch(const void* hist, const void* x, const void* taps, void* y,
                   long long n, int nt, cudaStream_t stream) {
  const size_t smem = (kTile + nt - 1) * sizeof(T) + nt * sizeof(float);
  auto kern = fir_kernel<T, BF16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(x),
      static_cast<const float*>(taps), static_cast<T*>(y), n, nt);
  return cudaGetLastError();
}

}  // namespace

// hist: nt - 1 samples before x, or null for a zero initial state.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fsdr_fir(const void* hist, const void* x, const void* taps, void* y,
                        long long n, int nt, int is_complex, int bf16,
                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return bf16 ? launch<float2, true>(hist, x, taps, y, n, nt, s)
                : launch<float2, false>(hist, x, taps, y, n, nt, s);
  }
  return bf16 ? launch<float, true>(hist, x, taps, y, n, nt, s)
              : launch<float, false>(hist, x, taps, y, n, nt, s);
}

// Outputs per thread block; the wrapper sizes the shared-memory request from it.
extern "C" int fsdr_fir_tile() { return kTile; }
