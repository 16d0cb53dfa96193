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
// 3.35 TB/s against about 1.2 us at 67 TFLOP/s FP32. One row per block puts a
// floor under a 2^18 frame (128 rows on 132 SMs): 131,072 complex MACs per row
// on one SM's 128 FP32 lanes are about 2,048 cycles before any load.
//
// What the first design (one 256-thread block per row, one output a thread)
// lost time to, and what this design does about each:
//  * the MAC read one float2 from shared memory per FMA pair (64 taps x 8 B per
//    output): each window now computes R = 8 consecutive outputs with a
//    sliding register window over the staged span, so a step loads one new
//    sample and one tap (broadcast) for R FMA pairs, whole chunks of R steps
//    unguarded so that their loads issue ahead of the FMAs. The span is
//    staged with one pad slot every R samples, so the windows, R samples
//    apart, fall in different banks. A 2048-point row runs on 256 threads;
//    512 threads of 4 outputs each are slower (PERF.md);
//  * the MAC scattered its results bit-reversed, with bank conflicts: it now
//    writes them in natural order into a buffer padded one slot every 16
//    points, which the FFT reads as it is;
//  * the radix-2 FFT made log2(N) passes over shared memory, 11 barriers at
//    N = 2048, and gathered tw[pos << shift] from device memory at every
//    butterfly: a Stockham (self-sorting) FFT now holds 16 points a thread in
//    registers and runs a radix-16 butterfly there (3 passes at N = 2048,
//    8 x 16 x 16, 2 barriers), exchanging points through the padded buffers
//    only between passes. Each pass reads its own slice of a twiddle table
//    laid out so that neighbouring threads read neighbouring entries (the
//    first table, indexed by k * q * stride, put up to 16 threads on one
//    bank), staged once per block in shared memory. The last pass writes the
//    spectrum in natural order straight to device memory, neighbouring
//    threads on neighbouring bins (8-byte stores, coalesced: a thread's
//    points are N / radix apart, so 16-byte stores would need one more pass
//    through shared memory);
//  * staging waited on one device-memory load at a time per thread: the span,
//    the table and the taps are now copied with cp.async, every copy of a
//    thread in flight at once.
//
// Twiddles come from a table the host builds in float64 (cuda_kernels.
// _fft_table): pass p's entry (q - 1) * Ns + k holds (cos, sin)(2 pi ((k q
// stride) mod N) / N), the phase index reduced mod N in integers before the
// lookup, the accuracy rule of the TPU kernel's twiddles. The constants
// inside a radix-2/4/8/16 butterfly are float literals of cos(2 pi t / 16).
// The plan (threads, R, the radices, the padding, whether the
// table fits in shared memory) comes from the wrapper, cuda_kernels.
// fir_fft_plan; where the padded layout does not fit, the table is read from
// device memory, then the padding goes.
//
// Any other N (not a power of two) keeps a direct DFT, each output a sum over
// the row: Y[c] = sum_j v[j] * exp(-2 pi i ((c * j) mod N) / N). The TPU
// kernel's dense DFT matmul (8 * N FLOP per sample) is not carried over.
//
// bf16 mode: samples and taps are rounded to bf16 when they are staged (their
// products are exact in FP32 and accumulate in FP32), and the filtered row is
// rounded to bf16 before the transform, which then runs in FP32.
//
// Lanes (fsdr_fir_fft_lanes, the serving plane's [L, rows * N] batch): the lane
// is the grid's y dimension, and each block offsets hist, x, taps and y by its
// lane's strides first, so a lane runs exactly the one-stream kernel on its
// row (bit for bit the one-stream launch's output).

#include "common.cuh"

namespace {

using fsdr::bf16_round;
using fsdr::cp_async;
using fsdr::cp_async_wait_all;
using fsdr::skew;

constexpr int kMaxThreads = 512;
constexpr int kMaxPasses = 16;

__host__ __device__ inline int buf_b(int n, int psh) { return skew(n - 1, psh) + 1; }

__host__ __device__ inline int buf_a(int n, int nt, int ssh, int psh) {
  const int a = skew(n + nt - 2, ssh) + 1;
  const int b = buf_b(n, psh);
  return a > b ? a : b;
}

// buffer A (the skewed span, later an FFT buffer), buffer B (the padded
// filtered row), the staged twiddle table, the taps
__host__ inline size_t smem_bytes(int n, int nt, int ssh, int psh, int tw_len) {
  return 8 * (static_cast<size_t>(buf_a(n, nt, ssh, psh)) + buf_b(n, psh) + tw_len) +
         4 * static_cast<size_t>(nt);
}

template <bool BF16>
__device__ __forceinline__ float prep(float v) {
  return BF16 ? bf16_round(v) : v;
}

// one span sample into its float2 slot: a complex sample as it is, a real one
// into .x with .y = 0
__device__ __forceinline__ void stage_sample(float2* dst, const float2* src) {
  cp_async(dst, src);
}
__device__ __forceinline__ void stage_sample(float2* dst, const float* src) {
  cp_async(&dst->x, src);
  dst->y = 0.f;
}

// One forward Stockham pass of radix RX over the row (fsdr::stockham_bfly):
// from the shared buffer at in_off into the one at out_off, or, in the LAST
// pass, straight to the row of y.
template <int RX, bool LAST>
__device__ __forceinline__ void stockham(float2* sm, int in_off, int out_off,
                                         float2* __restrict__ yr, int psh,
                                         const float2* tw, int n, int ns) {
  const int nb = n / RX;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    fsdr::stockham_bfly<RX, false, !LAST>(sm + in_off, LAST ? yr : sm + out_off, psh, tw,
                                          j, nb, ns);
  }
}

template <typename T, bool BF16, int R>
__global__ void __launch_bounds__(kMaxThreads)
fir_fft_kernel(const T* __restrict__ hist, const T* __restrict__ x,
               const float* __restrict__ taps, const float2* __restrict__ tw_g,
               float2* __restrict__ y, int n, int nt, int n_pass, unsigned radix_codes,
               int ssh, int psh, int tw_staged_len, long long hs, long long xs,
               long long ts, long long ys) {
  extern __shared__ float2 smem[];
  // this block's lane: its rows of hist, x, taps and y
  const long long lane_id = blockIdx.y;
  hist += lane_id * hs;
  x += lane_id * xs;
  taps += lane_id * ts;
  y += lane_id * ys;
  const int a_len = buf_a(n, nt, ssh, psh), b_len = buf_b(n, psh);
  float2* s_a = smem;                              // skewed span, then an FFT buffer
  float2* s_b = s_a + a_len;                       // the padded filtered row
  float2* s_tw = s_b + b_len;
  float* s_taps = reinterpret_cast<float*>(s_tw + tw_staged_len);
  const long long row0 = static_cast<long long>(blockIdx.x) * n;
  const int span = n + nt - 1;
  const int nthr = blockDim.x;

  // Stage with cp.async, every copy of a thread in flight at once: the span
  // (the row and the nt - 1 samples before it, from hist for row 0), the
  // twiddle table, the taps. bf16 mode then rounds what each thread copied.
  const long long g0 = row0 - (nt - 1);
  for (int i = threadIdx.x; i < span; i += nthr) {
    const long long g = g0 + i;
    stage_sample(s_a + skew(i, ssh), g >= 0 ? x + g : hist + (nt - 1 + g));
  }
  for (int i = threadIdx.x; i < tw_staged_len; i += nthr) cp_async(s_tw + i, tw_g + i);
  for (int i = threadIdx.x; i < nt; i += nthr) cp_async(s_taps + i, taps + i);
  cp_async_wait_all();
  if (BF16) {
    for (int i = threadIdx.x; i < span; i += nthr) {
      float2* d = s_a + skew(i, ssh);
      *d = make_float2(bf16_round(d->x), bf16_round(d->y));
    }
    for (int i = threadIdx.x; i < nt; i += nthr) s_taps[i] = bf16_round(s_taps[i]);
  }
  const float2* tw = tw_staged_len ? s_tw : tw_g;
  __syncthreads();

  // FIR MAC on sliding register windows (fsdr::window_mac):
  // v[c0 + r] = sum_k taps[k] * span[c0 + r + nt - 1 - k]. Outputs past n (a
  // ragged last window) are computed from clamped loads and not stored.
  for (int c0 = threadIdx.x * R; c0 < n; c0 += nthr * R) {
    float2 acc[R];
    fsdr::window_mac<float2, R, false>(s_a, s_taps, c0, nt, span, ssh, 0, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (c0 + r < n) {
        s_b[skew(c0 + r, psh)] = make_float2(prep<BF16>(acc[r].x), prep<BF16>(acc[r].y));
      }
    }
  }
  __syncthreads();

  if (n_pass > 0) {
    // pass p has radix 2 << ((radix_codes >> 2p) & 3); Ns is the product of
    // the radices before it; its table holds (radix - 1) * Ns entries
    float2* yr = y + row0;
    int in_off = a_len, out_off = 0, ns = 1, tw_off = 0;
    for (int p = 0; p < n_pass; ++p) {
      const int code = (radix_codes >> (2 * p)) & 3;
      const float2* twp = tw + tw_off;
      if (p == n_pass - 1) {
        switch (code) {
          case 0: stockham<2, true>(smem, in_off, 0, yr, psh, twp, n, ns); break;
          case 1: stockham<4, true>(smem, in_off, 0, yr, psh, twp, n, ns); break;
          case 2: stockham<8, true>(smem, in_off, 0, yr, psh, twp, n, ns); break;
          default: stockham<16, true>(smem, in_off, 0, yr, psh, twp, n, ns); break;
        }
      } else {
        switch (code) {
          case 0: stockham<2, false>(smem, in_off, out_off, yr, psh, twp, n, ns); break;
          case 1: stockham<4, false>(smem, in_off, out_off, yr, psh, twp, n, ns); break;
          case 2: stockham<8, false>(smem, in_off, out_off, yr, psh, twp, n, ns); break;
          default: stockham<16, false>(smem, in_off, out_off, yr, psh, twp, n, ns); break;
        }
        __syncthreads();
        const int t = in_off;
        in_off = out_off;
        out_off = t;
      }
      const int r = 2 << code;
      tw_off += (r - 1) * ns;
      ns *= r;
    }
  } else {
    for (int c = threadIdx.x; c < n; c += nthr) {
      float ar = 0.f, ai = 0.f;
      int idx = 0;
      for (int j = 0; j < n; ++j) {
        const float2 w = tw[idx];
        const float2 v = s_b[skew(j, psh)];
        ar = fmaf(v.x, w.x, fmaf(v.y, w.y, ar));
        ai = fmaf(v.y, w.x, fmaf(-v.x, w.y, ai));
        idx += c;
        if (idx >= n) idx -= n;
      }
      y[row0 + c] = make_float2(ar, ai);
    }
  }
}

// lanes: the grid's y dimension; strides (hs, xs, ts, ys) in elements a lane
struct Lanes {
  int lanes;
  long long hs, xs, ts, ys;
};

template <typename T, bool BF16, int R>
cudaError_t launch(const void* hist, const void* x, const void* taps, const void* tw,
                   void* y, long long rows, int n, int nt, int threads, int n_pass,
                   unsigned codes, int ssh, int psh, int tw_len, size_t smem,
                   const Lanes& ln, cudaStream_t stream) {
  auto kern = fir_fft_kernel<T, BF16, R>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(ln.lanes));
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(x),
      static_cast<const float*>(taps), static_cast<const float2*>(tw),
      static_cast<float2*>(y), n, nt, n_pass, codes, ssh, psh, tw_len, ln.hs, ln.xs, ln.ts,
      ln.ys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* hist, const void* x, const void* taps, const void* tw,
                     void* y, long long rows, int n, int nt, int bf16, int threads,
                     int outs, int n_pass, unsigned codes, int ssh, int psh, int tw_len,
                     size_t smem, const Lanes& ln, cudaStream_t s) {
  if (outs == 8) {
    return bf16 ? launch<T, true, 8>(hist, x, taps, tw, y, rows, n, nt, threads, n_pass,
                                     codes, ssh, psh, tw_len, smem, ln, s)
                : launch<T, false, 8>(hist, x, taps, tw, y, rows, n, nt, threads, n_pass,
                                      codes, ssh, psh, tw_len, smem, ln, s);
  }
  return bf16 ? launch<T, true, 4>(hist, x, taps, tw, y, rows, n, nt, threads, n_pass,
                                   codes, ssh, psh, tw_len, smem, ln, s)
              : launch<T, false, 4>(hist, x, taps, tw, y, rows, n, nt, threads, n_pass,
                                    codes, ssh, psh, tw_len, smem, ln, s);
}

int run(const void* hist, const void* x, const void* taps, const void* tw, int tw_len,
        void* y, long long rows, int n, int nt, int is_complex, int bf16, int threads,
        int outs, int n_pass, const int* radices, int ssh, int psh, int tw_staged,
        long long smem, const Lanes& ln, void* stream) {
  if (rows <= 0 || ln.lanes == 0) return 0;
  if (n_pass < 0 || n_pass > kMaxPasses || threads < 1 || threads > kMaxThreads ||
      (outs != 4 && outs != 8) || ln.lanes < 0 || ln.lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned codes = 0;
  int prod = 1, want_len = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int r = radices[p];
    const int code = r == 2 ? 0 : r == 4 ? 1 : r == 8 ? 2 : r == 16 ? 3 : -1;
    if (code < 0) return static_cast<int>(cudaErrorInvalidValue);
    codes |= static_cast<unsigned>(code) << (2 * p);
    want_len += (r - 1) * prod;
    prod *= r;
  }
  if (n_pass == 0) want_len = n;
  if ((n_pass > 0 && prod != n) || tw_len != want_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int staged = tw_staged ? tw_len : 0;
  const size_t want = smem_bytes(n, nt, ssh, psh, staged);
  if (static_cast<size_t>(smem) != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return dispatch<float2>(hist, x, taps, tw, y, rows, n, nt, bf16, threads, outs, n_pass,
                            codes, ssh, psh, staged, want, ln, s);
  }
  return dispatch<float>(hist, x, taps, tw, y, rows, n, nt, bf16, threads, outs, n_pass,
                         codes, ssh, psh, staged, want, ln, s);
}

}  // namespace

// x: rows * n samples; hist: the nt - 1 samples before x (never null); y:
// rows * n complex64. tw: the twiddle table of the plan, tw_len entries of
// (cos, sin) pairs: for a power-of-two n the passes' tables one after the
// other, pass p's entry (q - 1) * Ns + k holding (cos, sin)(2 pi ((k q
// stride) mod n) / n); else the n entries of (cos, sin)(2 pi k / n). The plan
// (cuda_kernels.fir_fft_plan): threads per block, outs (R: 4 or 8), n_pass
// Stockham passes with their radices in order (2, 4, 8 or 16; 0 passes: the
// direct DFT), the span and FFT-buffer pad shifts, whether the table is staged
// in shared memory, and its shared memory, which must equal this layout's.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// plan the kernel does not take.
extern "C" int fsdr_fir_fft(const void* hist, const void* x, const void* taps,
                            const void* tw, int tw_len, void* y, long long rows, int n,
                            int nt, int is_complex, int bf16, int threads, int outs,
                            int n_pass, const int* radices, int ssh, int psh,
                            int tw_staged, long long smem, void* stream) {
  return run(hist, x, taps, tw, tw_len, y, rows, n, nt, is_complex, bf16, threads, outs,
             n_pass, radices, ssh, psh, tw_staged, smem, Lanes{1, 0, 0, 0, 0}, stream);
}

// The lane form: `lanes` streams of rows * n samples, lane l at hist + l * hs,
// x + l * xs, taps + l * ts (ts = 0: shared taps) and y + l * ys, strides in
// elements; the plan and table are the one-stream call's.
extern "C" int fsdr_fir_fft_lanes(const void* hist, const void* x, const void* taps,
                                  const void* tw, int tw_len, void* y, long long rows,
                                  int n, int nt, int is_complex, int bf16, int threads,
                                  int outs, int n_pass, const int* radices, int ssh,
                                  int psh, int tw_staged, long long smem, int lanes,
                                  long long hs, long long xs, long long ts, long long ys,
                                  void* stream) {
  return run(hist, x, taps, tw, tw_len, y, rows, n, nt, is_complex, bf16, threads, outs,
             n_pass, radices, ssh, psh, tw_staged, smem, Lanes{lanes, hs, xs, ts, ys},
             stream);
}
