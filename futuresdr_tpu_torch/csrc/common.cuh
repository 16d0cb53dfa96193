// Device helpers shared by the port's kernels (fir.cu, fir_fft.cu, pfb.cu):
// padded shared-memory indexing, bf16 rounding, cp.async staging, the
// sliding register window of a FIR MAC, and one butterfly of a Stockham
// (self-sorting) FFT pass, forward or inverse, on registers.
//
// ops/_build.py hashes this header with every source, so an edit rebuilds
// each library that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fsdr {

// Index i of a shared buffer with one slot of padding every 2^sh slots
// (cuda_kernels._skew).
__host__ __device__ inline int skew(int i, int sh) { return i + (i >> sh); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 bf16_round(float2 v) {
  return make_float2(bf16_round(v.x), bf16_round(v.y));
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mac(float& acc, float t, float v) { acc = fmaf(t, v, acc); }

__device__ __forceinline__ void mac(float2& acc, float t, float2 v) {
  acc.x = fmaf(t, v.x, acc.x);
  acc.y = fmaf(t, v.y, acc.y);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

// ---------------------------------------------------------------------------
// The FIR MAC on a sliding register window
// ---------------------------------------------------------------------------

// One MAC step k = k0 + kk of a window: load span[top - k] (at slot `at`)
// into slot kk and add taps[k] times each of the R samples to the R sums.
template <typename T, int R>
__device__ __forceinline__ void window_step(T (&win)[R], T (&acc)[R], const T* at,
                                            const float* s_taps, int k0, int kk) {
  win[kk] = *at;
  const float t = s_taps[k0 + kk];
#pragma unroll
  for (int r = 0; r < R; ++r) mac(acc[r], t, win[(kk - r + R) % R]);
}

// acc[r] = sum_k taps[k] * span[c0 + r + nt - 1 - k], k ascending, over a
// span whose index i is staged at slot skew(i + off, ssh). At step k the
// window holds span[c0 + nt - 1 - k + r] for r < R, element g in slot
// (nt - 1 - g) mod R relative to c0: each step loads the one new sample
// span[c0 + nt - 1 - k] into slot k mod R and the tap (a broadcast) for R FMA
// pairs. ALIGNED: the caller stages the span so that c0 + nt - 1 + off is
// R - 1 mod R and pads every R samples or not at all (ssh = log2 R, or 31);
// then the R loads of a chunk of R steps lie at consecutive slots below one
// slot computed per chunk, constant offsets from one address. Loads past the
// span (a ragged last window) are clamped; the caller does not store those
// outputs.
template <typename T, int R, bool ALIGNED>
__device__ __forceinline__ void window_mac(const T* s_a, const float* s_taps, int c0, int nt,
                                           int span, int ssh, int off, T (&acc)[R]) {
  T win[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = zero<T>();
#pragma unroll
  for (int r = 1; r < R; ++r) {
    win[(R - r) % R] = s_a[skew(min(c0 + nt - 1 + r, span - 1) + off, ssh)];
  }
  // whole chunks of R steps without a guard, so that their loads can be
  // issued ahead of the FMAs, then the last steps
  const int top = c0 + nt - 1 + off;
  int k0 = 0;
  for (; k0 + R <= nt; k0 += R) {
    const T* p = s_a + skew(top - k0, ssh);
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      window_step<T, R>(win, acc, ALIGNED ? p - kk : s_a + skew(top - k0 - kk, ssh), s_taps,
                        k0, kk);
    }
  }
  const T* p = s_a + skew(top - k0, ssh);
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    if (k0 + kk < nt) {
      window_step<T, R>(win, acc, ALIGNED ? p - kk : s_a + skew(top - k0 - kk, ssh),
                        s_taps, k0, kk);
    }
  }
}

// ---------------------------------------------------------------------------
// Stockham FFT passes on registers
// ---------------------------------------------------------------------------

// cos(2 pi t / 16) for t in [0, 16), as float literals
__device__ __forceinline__ float cos16(int t) {
  switch (t & 15) {
    case 0: return 1.f;
    case 1: case 15: return 0.92387953251128674f;
    case 2: case 14: return 0.70710678118654752f;
    case 3: case 13: return 0.38268343236508977f;
    case 4: case 12: return 0.f;
    case 5: case 11: return -0.38268343236508977f;
    case 6: case 10: return -0.70710678118654752f;
    case 7: case 9: return -0.92387953251128674f;
    default: return -1.f;
  }
}

// b * exp(-2 pi i t / 16); t is a constant once the butterfly is unrolled
__device__ __forceinline__ float2 rot16(float2 b, int t) {
  if (t == 0) return b;
  if (t == 4) return make_float2(b.y, -b.x);
  if (t == 12) return make_float2(-b.y, b.x);
  const float c = cos16(t), s = cos16(t - 4);    // sin(x) = cos(x - pi / 2)
  return make_float2(b.x * c + b.y * s, b.y * c - b.x * s);
}

__host__ __device__ constexpr int log2c(int r) { return r <= 1 ? 0 : 1 + log2c(r >> 1); }

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// The in-register transform: radix-2 decimation in time over registers that
// hold the points in bit-reversed order, level LEN combining pairs LEN / 2
// apart with exp(-+2 pi i kk / LEN) (INV: the inverse's +). Written as
// templates so that every register index is a constant.
template <int RX, int LEN, bool INV, bool DONE = (LEN > RX)>
struct Dit {
  static __device__ __forceinline__ void run(float2 (&u)[RX]) {
#pragma unroll
    for (int i = 0; i < RX; i += LEN) {
#pragma unroll
      for (int kk = 0; kk < LEN / 2; ++kk) {
        const int t = kk * (16 / LEN);
        const float2 a = u[i + kk];
        const float2 b = rot16(u[i + kk + LEN / 2], INV ? (16 - t) & 15 : t);
        u[i + kk] = make_float2(a.x + b.x, a.y + b.y);
        u[i + kk + LEN / 2] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
    Dit<RX, LEN * 2, INV>::run(u);
  }
};
template <int RX, int LEN, bool INV>
struct Dit<RX, LEN, INV, true> {
  static __device__ __forceinline__ void run(float2 (&)[RX]) {}
};

// Butterfly j of one Stockham pass of radix RX over a row of n = nb * RX
// points: it takes the points j + q * nb of src (padded one slot every 2^psh),
// twiddles them by exp(-+2 pi i k q / (Ns RX)) with k = j mod Ns (entry
// (q - 1) * Ns + k of the pass's table of (cos, sin) pairs, so neighbouring
// threads read neighbouring entries), transforms them in registers (Dit:
// register i holds point q = brev(i), so the loads, not the registers, are
// permuted; the outputs come out in natural order) and stores them at
// (j - k) * RX + k + q * Ns of dst, padded (PAD_OUT) or not (a row of the
// output in device memory).
template <int RX, bool INV, bool PAD_OUT>
__device__ __forceinline__ void stockham_bfly(const float2* src, float2* dst, int psh,
                                              const float2* tw, int j, int nb, int ns) {
  constexpr int bits = log2c(RX);
  const int k = j & (ns - 1);
  float2 u[RX];
#pragma unroll
  for (int i = 0; i < RX; ++i) {
    const int q = brev(i, bits);
    float2 v = src[skew(j + q * nb, psh)];
    if (q > 0 && ns > 1) {
      const float2 w = tw[(q - 1) * ns + k];
      v = INV ? make_float2(v.x * w.x - v.y * w.y, v.y * w.x + v.x * w.y)
              : make_float2(v.x * w.x + v.y * w.y, v.y * w.x - v.x * w.y);
    }
    u[i] = v;
  }
  Dit<RX, 2, INV>::run(u);
  const int base = (j - k) * RX + k;
#pragma unroll
  for (int q = 0; q < RX; ++q) dst[PAD_OUT ? skew(base + q * ns, psh) : base + q * ns] = u[q];
}

}  // namespace fsdr
