// Critically sampled polyphase analysis bank (PFB channelizer) over a flat
// complex64 stream: with ext = hist ++ x and the commutated rows
// rows[s, c] = ext[s * N + N - 1 - c],
//   v[s, c]  = sum_k taps[k, c] * rows[s + K - 1 - k, c]      (branch MAC)
//   y[s, c'] = sum_c v[s, c] * exp(+2 pi i c c' / N)            (IDFT, no 1/N)
// for s in [0, t), t = len(x) / N; y is [t, N] complex64, channel-interleaved.
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_pfb_kernel
// (wrapper pallas_pfb).
//
// Bound on an H100: memory. A complex64 stream moves 16 bytes per sample (8 in,
// 8 out) against 4 * K + 5 * log2(N) FLOP per sample (78 at PFB-64, K = 12):
// 4.2 MB and 20 MFLOP per 2^18-sample frame, about 1.25 us at 3.35 TB/s against
// 0.3 us at 67 TFLOP/s FP32.
//
// Design: one thread block per tile of `tr` output rows (tr * N ~ 1024 outputs,
// 4 a thread). The block stages the tile's tr + K - 1 commutated rows in shared
// memory, reading the flat stream in order (coalesced) and storing each sample
// at its reversed column, so no reversed or concatenated copy of the stream
// ever reaches device memory; rows before the frame come from the separate
// `hist` pointer. The [K, N] taps are staged too, read through two strides, so
// the stage's [N, K] carry passes as its transposed view without a copy. Where
// the rows and taps do not fit beside the `v` tile (N >= 2048 at K = 12; the
// caller passes staged = 0), the MAC reads them from device memory instead,
// through the same reversed index, and only `v` is staged. One
// thread per (row, channel) runs the K-tap MAC in FP32 into a shared `v` tile,
// so the branch bank never reaches device memory. Then the IDFT of each row in
// shared memory:
//  * N a power of two: the MAC writes v in bit-reversed order and an iterative
//    radix-2 decimation-in-time transform runs over log2(N) stages, all rows of
//    the tile at once;
//  * any other N: a direct DFT, each output a sum over its row.
// Twiddles come from a table the host builds in float64: entry k holds
// (cos, sin)(2 pi k / N), and the phase index (c * c') mod N is reduced in
// integers before the lookup, the accuracy rule of the TPU kernel's twiddles.
// The TPU kernel's dense IDFT matmul (8 * N FLOP per sample) is not carried over.
//
// bf16 mode (precision="bf16"): samples and taps are rounded to bf16 when they
// are staged (their products are exact in FP32 and accumulate in FP32) and v is
// rounded to bf16 before the transform, which keeps FP32 twiddles (the TPU
// kernel also rounds its cos/sin matrices to bf16). Taps may arrive as bf16
// (the stage's carried taps): they are widened exactly.

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TapT, bool BF16, bool STAGED>
__global__ void __launch_bounds__(kThreads)
pfb_kernel(const float2* __restrict__ hist, const float2* __restrict__ x,
           const TapT* __restrict__ taps, long long tap_sk, long long tap_sn,
           const float2* __restrict__ tw, float2* __restrict__ y, long long t,
           int n, int log2n, int k, int tr) {
  extern __shared__ float2 smem[];
  // STAGED: rows (tr + k - 1) x n, then v tr x n, then taps k x n (floats);
  // otherwise v alone
  float2* s_rows = smem;
  float2* s_v = STAGED ? s_rows + static_cast<size_t>(tr + k - 1) * n : smem;
  float* s_taps = reinterpret_cast<float*>(s_v + static_cast<size_t>(tr) * n);
  const long long s0 = static_cast<long long>(blockIdx.x) * tr;
  const int nr = static_cast<int>(min(static_cast<long long>(tr), t - s0));
  const long long hist_len = static_cast<long long>(k - 1) * n;
  const long long e0 = s0 * n;                             // first ext index of the tile

  if (STAGED) {
    for (int i = threadIdx.x; i < k * n; i += kThreads) {
      const int kk = i / n;
      const int c = i - kk * n;
      s_taps[i] = prep<BF16>(widen(taps[kk * tap_sk + c * tap_sn]));
    }
    const int span = (nr + k - 1) * n;                     // staged samples
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const long long e = e0 + i;
      const float2 v = e < hist_len ? hist[e] : x[e - hist_len];
      const int r = i / n;
      const int j = i - r * n;                             // column n - 1 - j
      s_rows[r * n + (n - 1 - j)] = make_float2(prep<BF16>(v.x), prep<BF16>(v.y));
    }
    __syncthreads();
  }

  // branch MAC: v[s, c] = sum_k taps[k, c] * rows[s + k - 1 - kk, c]
  for (int i = threadIdx.x; i < nr * n; i += kThreads) {
    const int s = i / n;
    const int c = i - s * n;
    float ar = 0.f, ai = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      float tp;
      float2 v;
      if (STAGED) {
        tp = s_taps[kk * n + c];
        v = s_rows[(s + k - 1 - kk) * n + c];
      } else {
        tp = prep<BF16>(widen(taps[kk * tap_sk + c * tap_sn]));
        const long long e = e0 + static_cast<long long>(s + k - 1 - kk) * n + (n - 1 - c);
        v = e < hist_len ? hist[e] : x[e - hist_len];
        v = make_float2(prep<BF16>(v.x), prep<BF16>(v.y));
      }
      ar = fmaf(tp, v.x, ar);
      ai = fmaf(tp, v.y, ai);
    }
    const int dst = log2n > 0 ? static_cast<int>(__brev(c) >> (32 - log2n)) : c;
    s_v[s * n + dst] = make_float2(prep<BF16>(ar), prep<BF16>(ai));
  }
  __syncthreads();

  if (log2n >= 0) {
    // radix-2 DIT over bit-reversed rows; inverse twiddle exp(+i theta)
    const int half_n = n >> 1;
    for (int st = 1; st <= log2n; ++st) {
      const int half = 1 << (st - 1);
      const int shift = log2n - st;                        // twiddle index = pos * N / len
      for (int b = threadIdx.x; b < nr * half_n; b += kThreads) {
        const int row = b >> (log2n - 1);
        const int bb = b & (half_n - 1);
        const int pos = bb & (half - 1);
        const int i = row * n + ((bb >> (st - 1)) << st) + pos;
        const int j = i + half;
        const float2 w = tw[pos << shift];
        const float2 u = s_v[i];
        const float2 v = s_v[j];
        const float pr = v.x * w.x - v.y * w.y;
        const float pi = v.x * w.y + v.y * w.x;
        s_v[i] = make_float2(u.x + pr, u.y + pi);
        s_v[j] = make_float2(u.x - pr, u.y - pi);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nr * n; i += kThreads) y[e0 + i] = s_v[i];
  } else {
    // direct IDFT: y[c'] = sum_c v[c] * exp(+2 pi i ((c * c') mod N) / N)
    for (int i = threadIdx.x; i < nr * n; i += kThreads) {
      const int s = i / n;
      const int c2 = i - s * n;
      const float2* row = s_v + s * n;
      float ar = 0.f, ai = 0.f;
      int idx = 0;
      for (int c = 0; c < n; ++c) {
        const float2 w = tw[idx];
        const float2 v = row[c];
        ar = fmaf(v.x, w.x, fmaf(-v.y, w.y, ar));
        ai = fmaf(v.x, w.y, fmaf(v.y, w.x, ai));
        idx += c2;
        if (idx >= n) idx -= n;
      }
      y[e0 + i] = make_float2(ar, ai);
    }
  }
}

template <typename TapT, bool BF16>
cudaError_t launch(const void* hist, const void* x, const void* taps,
                   long long tap_sk, long long tap_sn, const void* tw, void* y,
                   long long t, int n, int log2n, int k, int tr, long long smem,
                   int staged, cudaStream_t stream) {
  auto kern = staged ? pfb_kernel<TapT, BF16, true> : pfb_kernel<TapT, BF16, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (t + tr - 1) / tr;
  kern<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float2*>(hist), static_cast<const float2*>(x),
      static_cast<const TapT*>(taps), tap_sk, tap_sn, static_cast<const float2*>(tw),
      static_cast<float2*>(y), t, n, log2n, k, tr);
  return cudaGetLastError();
}

}  // namespace

// hist: the (k - 1) * n samples before x (unread when k == 1); x: t * n
// complex64 samples; taps: [k, n] float32 (taps_bf16 == 0) or bfloat16, element
// (kk, c) at taps + kk * tap_sk + c * tap_sn; tw: n (cos, sin) pairs; y: [t, n]
// complex64. log2n is log2(n) for a power of two, else -1. tr output rows per
// block, staged (rows and taps in shared memory, else read from device memory)
// and smem bytes, (2 * tr + k - 1) * n * 8 + k * n * 4 staged and tr * n * 8
// not, come from the caller. Returns cudaGetLastError() after the launch.
extern "C" int fsdr_pfb(const void* hist, const void* x, const void* taps,
                        long long tap_sk, long long tap_sn, int taps_bf16,
                        const void* tw, void* y, long long t, int n, int log2n,
                        int k, int tr, long long smem, int staged, int bf16,
                        void* stream) {
  if (t <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16) {
    return bf16 ? launch<__nv_bfloat16, true>(hist, x, taps, tap_sk, tap_sn, tw, y, t,
                                              n, log2n, k, tr, smem, staged, s)
                : launch<__nv_bfloat16, false>(hist, x, taps, tap_sk, tap_sn, tw, y, t,
                                               n, log2n, k, tr, smem, staged, s);
  }
  return bf16 ? launch<float, true>(hist, x, taps, tap_sk, tap_sn, tw, y, t, n, log2n,
                                    k, tr, smem, staged, s)
              : launch<float, false>(hist, x, taps, tap_sk, tap_sn, tw, y, t, n, log2n,
                                     k, tr, smem, staged, s);
}
