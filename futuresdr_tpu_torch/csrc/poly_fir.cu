// Polyphase decimating FIR at the decimated rate, over the stride-D row matrix:
//   y[q, i] = sum_{a=0..m} sum_{s<D} rows[q + m - a, s] * W[a, s, i],
// rows = (hist ++ x).reshape(-1, D), hist = the previous m * D samples.
// A 2-D W [m+1, D] is the decimating channel filter (I = 1, one output per
// row); a 3-D W [m+1, D, I] is the rational resampler's phase-tap tensor
// (I outputs per row).
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_poly_fir_kernel
// (wrapper pallas_poly_fir).
//
// Bound on an H100: memory for the channel filter, operations for the resampler.
// The FM channel filter (D = 4, m = 32, complex64) reads 8 bytes and writes 2 per
// input sample: 5.1 MB per 512,000-sample frame, about 1.5 us at 3.35 TB/s,
// against 66 MFLOP (about 1.0 us at 67 TFLOP/s FP32). The audio resampler
// (D = 125, I = 24, m = 2, float32) does 2 * 375 * 24 FLOP per 125 inputs:
// 18.4 MFLOP per 128,000 inputs, about 0.27 us, against 0.6 MB (0.18 us).
//
// Design: one block per tile of `tq` output rows (tq * I ~ kOutputs outputs, one
// per thread), so even the resampler's 1,024 rows a frame fill ~100 blocks. The
// block stages W (as float32, 36 KB for the resampler) and the tq + m input rows
// its outputs read in shared memory, each input sample read once from device
// memory; rows before the frame come from the separate `hist` pointer, so the
// stage needs no concatenation in device memory. A staged row takes an odd
// number of samples (D, or D + 1 when D is even): threads on neighbouring rows
// then read different banks (D = 4 rows 32 bytes apart would otherwise collide
// 4 ways). Each thread accumulates its output (q, i) in FP32 registers;
// neighbouring threads take neighbouring phases i, so their W reads are
// conflict-free and their row reads broadcast. A complex stream is read as
// float2 and filtered in ONE pass with the real W; the TPU kernel's two real
// passes were only its lane layout.
//
// bf16 mode (precision="bf16"): samples and weights are rounded to bf16 when they
// are staged; their products are exact in FP32 and accumulate in FP32. W may
// arrive as bf16 (the stage's carried weights): it is widened exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutputs = kThreads;  // outputs (rows x phases) per block

__host__ __device__ inline int tile_rows(int I) {
  const int r = kOutputs / I;
  return r < 1 ? 1 : r;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ void mac(float& acc, float v, float w) { acc = fmaf(v, w, acc); }

__device__ __forceinline__ void mac(float2& acc, float2 v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
}

// Staged samples per row: odd, so rows of neighbouring threads fall in
// different shared-memory banks.
__host__ __device__ inline int row_stride(int D) { return D | 1; }

// Floats of W in shared memory, rounded up so the sample tile after it stays
// 8-byte aligned for float2.
__host__ __device__ inline int w_slots(int m, int D, int I) {
  const int n = (m + 1) * D * I;
  return (n + 1) & ~1;
}

template <typename T, bool BF16, typename WT>
__global__ void __launch_bounds__(kThreads)
poly_fir_kernel(const T* __restrict__ hist, const T* __restrict__ x,
                const WT* __restrict__ W, T* __restrict__ y, long long nq, int m,
                int D, int I) {
  extern __shared__ float2 smem[];
  float* s_w = reinterpret_cast<float*>(smem);                 // [(m+1) * D * I]
  T* s_x = reinterpret_cast<T*>(s_w + w_slots(m, D, I));       // [(tq + m) * ld]
  const int tq = tile_rows(I);
  const long long q0 = static_cast<long long>(blockIdx.x) * tq;
  const long long H = static_cast<long long>(m) * D;          // history samples
  const long long n = nq * D;                                  // frame samples
  const int ld = row_stride(D);

  const int nw = (m + 1) * D * I;
  for (int k = threadIdx.x; k < nw; k += kThreads) s_w[k] = prep<BF16>(widen(W[k]));
  const int span = (tq + m) * D;
  for (int k = threadIdx.x; k < span; k += kThreads) {
    const long long e = q0 * D + k;                            // index into hist ++ x
    T v = zero<T>();
    if (e < H) {
      v = hist[e];
    } else if (e - H < n) {
      v = x[e - H];
    }
    const int row = k / D;
    s_x[row * ld + (k - row * D)] = prep<BF16>(v);
  }
  __syncthreads();

  const int outs = tq * I;
  for (int o = threadIdx.x; o < outs; o += kThreads) {
    const int ql = o / I;
    const int i = o - ql * I;
    const long long q = q0 + ql;
    if (q >= nq) break;                                        // o only grows
    T acc = zero<T>();
    for (int a = 0; a <= m; ++a) {
      const T* row = s_x + (ql + m - a) * ld;
      const float* w = s_w + a * D * I + i;
      for (int s = 0; s < D; ++s) mac(acc, row[s], w[s * I]);
    }
    y[q * I + i] = acc;
  }
}

template <typename T, bool BF16, typename WT>
cudaError_t launch(const void* hist, const void* x, const void* W, void* y,
                   long long nq, int m, int D, int I, cudaStream_t stream) {
  const int tq = tile_rows(I);
  const size_t smem = static_cast<size_t>(w_slots(m, D, I)) * sizeof(float) +
                      static_cast<size_t>(tq + m) * row_stride(D) * sizeof(T);
  auto kern = poly_fir_kernel<T, BF16, WT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((nq + tq - 1) / tq);
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(x), static_cast<const WT*>(W),
      static_cast<T*>(y), nq, m, D, I);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* hist, const void* x, const void* W, void* y,
                     long long nq, int m, int D, int I, int bf16, int w_bf16,
                     cudaStream_t s) {
  if (w_bf16) {
    return bf16 ? launch<T, true, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, s)
                : launch<T, false, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, s);
  }
  return bf16 ? launch<T, true, float>(hist, x, W, y, nq, m, D, I, s)
              : launch<T, false, float>(hist, x, W, y, nq, m, D, I, s);
}

}  // namespace

// hist: m * D samples before x; x: nq * D samples; W: (m + 1) * D * I weights,
// float32 or (w_bf16) bfloat16; y: nq * I outputs of the stream's type.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fsdr_poly_fir(const void* hist, const void* x, const void* W, void* y,
                             long long nq, int m, int D, int I, int is_complex,
                             int bf16, int w_bf16, void* stream) {
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) return dispatch<float2>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, s);
  return dispatch<float>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, s);
}

// Shared memory per block, in bytes, of one launch.
extern "C" long long fsdr_poly_fir_smem(int m, int D, int I, int is_complex) {
  return static_cast<long long>(w_slots(m, D, I)) * 4 +
         static_cast<long long>(tile_rows(I) + m) * row_stride(D) * (is_complex ? 8 : 4);
}
