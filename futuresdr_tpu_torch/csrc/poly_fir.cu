// Polyphase decimating FIR at the decimated rate, over the stride-D row matrix:
//   y[q, i] = sum_{a=0..m} sum_{s<D} rows[q + m - a, s] * W[a, s, i],
// rows = (hist ++ x).reshape(-1, D), hist = the previous m * D samples.
// A 2-D W [m+1, D] is the decimating channel filter (I = 1, one output per
// row); a 3-D W [m+1, D, I] is the rational resampler's phase-tap tensor
// (I outputs per row). With ext = hist ++ x, j = (m - a) * D + s and
// J = (m + 1) * D this is one product of a strided Hankel matrix with W':
//   y[q, i] = sum_{j<J} ext[q * D + j] * W'[j, i],  W'[j, i] = W[m - j / D, j % D, i],
// consecutive rows of the Hankel matrix overlapping by J - D samples.
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
// What the first design (one output a thread, a tile of 256 outputs a block)
// lost time to, and what this design does about each:
//  * a channel output was a chain of 132 MAC steps, each with a shared-memory
//    load of the sample and one of W: the "rows" tiling (I = 1) gives a group
//    of C = 4 lanes R = 8 consecutive outputs, each lane the part of their
//    sums over its columns s (a K split, summed with shuffles). The outputs
//    read one span of (R - 1) * D + J samples, so for its column a lane
//    slides a window of R stride-D rows along the tap rows: a step loads one
//    new sample for R independent MACs, and the weights of R steps come in
//    two 16-byte loads from W transposed in shared memory;
//  * the odd row stride ruled out vector loads and still left conflicts: the
//    span is staged in order with pad slots after every R rows, as many as
//    put the 32 lanes' window loads on distinct banks (cuda_kernels.
//    _rows_pad: 4 at D = 4);
//  * the resampler's block took 10 rows (256 / 24) and staged the whole 36 KB
//    W for 240 outputs, each a serial chain of 375 FMAs: the "gemm" tiling
//    gives each thread a register tile of RM = 4 rows x RN phases (RN = 3 at
//    I = 24), an outer-product accumulation over its part of J from shared
//    memory (RM + RN loads for RM * RN independent MACs). A block takes the
//    most rows (4 to 64) that still give 7/8 of a block per SM (8 at the
//    512,000 frame), and splits J over the threads its tiles leave idle; the
//    parts are summed in shared memory in a fixed order and stored coalesced;
//  * staging waited on one device-memory load at a time per thread: samples
//    and W are now copied with cp.async (W in 16-byte copies where aligned),
//    every copy of a thread in flight at once.
// The plan (tiling, threads, rows per block, tile, K split, pad, shared
// memory) comes from the wrapper, cuda_kernels.poly_fir_plan; where a layout
// does not fit, the K split and then the rows shrink, to one row a block:
// every W that ran on the first design still runs.
//
// Both tilings stage each input sample once from device memory; rows before
// the frame come from the separate `hist` pointer, so the stage needs no
// concatenation in device memory; rows past the frame are zero and outputs
// past nq (a ragged last tile) are not stored. A complex stream is read as
// float2 and filtered in ONE pass with the real W; the TPU kernel's two real
// passes were only its lane layout. f32 mode stays on the CUDA cores (FP32
// FMAs, no TF32), as the JAX kernel's dots run at Precision.HIGHEST.
//
// bf16 mode (precision="bf16"): samples and weights are rounded to bf16 when they
// are staged; their products are exact in FP32 and accumulate in FP32. W may
// arrive as bf16 (the stage's carried weights): it is widened exactly.
//
// Lanes (fsdr_poly_fir_lanes, the serving plane's [L, nq * D] batch, the
// counterpart of jax.vmap over pallas_poly_fir): the lane is the grid's y
// dimension. Each block first moves its hist, x, W and y pointers to its lane's
// rows (strides in elements; W's stride 0 is one W shared by every lane, read
// from the same addresses, so L2 serves it once), then runs the one-stream
// kernel's code. A lane's order of summation is set by the tiling and its K
// split alone (the rows a block takes only cut the outputs among blocks), and
// the lane plan (cuda_kernels.poly_fir_lanes_plan) keeps both from the
// one-stream plan of a lane's shape, so each lane is bit-equal to a one-stream
// launch; what it chooses over the whole batch is the rows a block. Served FM
// at 64 sessions of 32,000 input samples: the channel filter moves 20.5 MB
// (6.1 us at 3.35 TB/s), the resampler does 74 MFLOP (1.1 us at 67 TFLOP/s),
// where one launch a lane paid 64 launch latencies and the resampler's
// one-stream plan for 64 rows (4 rows a block, so that one stream fills the
// card) staged its 36 KB W 1,024 times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage samples k < count of hist ++ x from sample e0 on into s[slot(k)] with
// cp.async, every copy of a thread in flight at once; zero past the frame.
// Waits for all of the thread's copies (those it started before too), then
// bf16 mode rounds the samples it copied. The caller synchronises.
template <typename T, bool BF16, typename Slot>
__device__ __forceinline__ void stage_span(T* s, const T* __restrict__ hist,
                                           const T* __restrict__ x, long long e0,
                                           int count, long long H, long long n, Slot slot) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const long long e = e0 + k;
    T* d = s + slot(k);
    if (e < H) {
      cp_async(d, hist + e);
    } else if (e - H < n) {
      cp_async(d, x + (e - H));
    } else {
      *d = zero<T>();
    }
  }
  cp_async_wait_all();
  if (BF16) {
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      T* d = s + slot(k);
      *d = prep<BF16>(*d);
    }
  }
}

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m),
                     __shfl_xor_sync(0xffffffffu, v.y, m));
}

// Floats of W in shared memory, rounded up so the sample tile after it stays
// 8-byte aligned for float2.
__host__ __device__ inline int w_slots(int n) { return (n + 1) & ~1; }

// "rows": W transposed, row s = W[m - b, s] for b < pitch (zero past m); the
// pitch is a multiple of 8, so R = 8 weights are two 16-byte loads, and not a
// multiple of 32, so the C rows a warp reads fall in different banks
__host__ __device__ inline int w_pitch(int m) {
  const int p = (m + 8) / 8 * 8;
  return p % 32 == 0 ? p + 8 : p;
}

// "rows": sample s of span row `row` in slot row * D + s + pad * (row / R):
// pad slots after every R rows of D samples
template <int R>
__host__ __device__ inline int rows_slot(int row, int s, int D, int pad) {
  return row * D + s + pad * (row / R);
}

__host__ inline size_t smem_bytes(int gemm, int m, int D, int I, int rows, int tile_rows,
                                  int ksplit, int pad, int elt) {
  if (!gemm) {
    const int last = rows + m - 1;                         // the span's last row
    return 4 * static_cast<size_t>(D) * w_pitch(m) +
           static_cast<size_t>(elt) * (last * D + D + pad * (last / tile_rows));
  }
  const size_t red = ksplit > 1 ? static_cast<size_t>(ksplit) * rows * I : 0;
  return 4 * static_cast<size_t>(w_slots(static_cast<int>(m + 1) * D * I)) +
         static_cast<size_t>(elt) * (static_cast<size_t>(rows + m) * D + red);
}

// "rows": the R weights W[m - b, s], b = b0 .. b0 + R - 1, in R / 4 16-byte loads
template <int R>
__device__ __forceinline__ void load_w(float (&w)[R], const float* wrow) {
#pragma unroll
  for (int u = 0; u < R / 4; ++u) {
    const float4 v = reinterpret_cast<const float4*>(wrow)[u];
    w[4 * u] = v.x;
    w[4 * u + 1] = v.y;
    w[4 * u + 2] = v.z;
    w[4 * u + 3] = v.w;
  }
}

// "rows": step b = b0 + bb of column s: load row rb + bb + R - 1 (rb = the
// group's first row + b0) into slot (bb + R - 1) mod R, then the R MACs
template <int R, typename T>
__device__ __forceinline__ void rows_step(T (&win)[R], T (&acc)[R], const T* s_x,
                                          const float (&w)[R], int rb, int bb, int s, int D,
                                          int pad) {
  win[(bb + R - 1) % R] = s_x[rows_slot<R>(rb + bb + R - 1, s, D, pad)];
#pragma unroll
  for (int r = 0; r < R; ++r) mac(acc[r], win[(bb + r) % R], w[bb]);
}

// I = 1: a group of C neighbouring lanes computes R consecutive rows, group g
// of the block rows q0 + g * R + r (r < R), lane c of the group the part of
// their sums over the columns s = c, c + C, ... (a K split, summed across the
// group with shuffles). For each column s, the window holds the samples of
// rows g * R + b + r (r < R) at column s, row g * R + b + r in slot (b + r)
// mod R: step b loads row g * R + b + R - 1 into slot (b + R - 1) mod R; the
// weights W[m - b, s] of R steps come in R / 4 16-byte loads.
template <typename T, bool BF16, typename WT, int R, int C>
__global__ void __launch_bounds__(kMaxThreads)
poly_fir_rows(const T* __restrict__ hist, const T* __restrict__ x,
              const WT* __restrict__ W, T* __restrict__ y, long long nq, int m, int D,
              int pad, long long hs, long long xs, long long ws, long long ys) {
  static_assert(R % 4 == 0, "weights load 4 at a time");
  const long long batch_lane = blockIdx.y;       // the lane form's stream
  hist += batch_lane * hs;
  x += batch_lane * xs;
  W += batch_lane * ws;
  y += batch_lane * ys;
  extern __shared__ float4 smem4[];
  const int pw = w_pitch(m);
  float* s_w = reinterpret_cast<float*>(smem4);                 // [D][pw]
  T* s_x = reinterpret_cast<T*>(s_w + D * pw);                  // the padded span
  const int tq = blockDim.x / C * R;
  const long long q0 = static_cast<long long>(blockIdx.x) * tq;
  const long long H = static_cast<long long>(m) * D, n = nq * D;
  const int RD = R * D;

  stage_span<T, BF16>(s_x, hist, x, q0 * D, (tq + m) * D, H, n,
                      [&](int k) { return k + pad * (k / RD); });
  for (int k = threadIdx.x; k < D * pw; k += blockDim.x) {
    const int s = k / pw, b = k - s * pw;
    s_w[k] = b <= m ? prep<BF16>(widen(W[(m - b) * D + s])) : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x % C;
  const int r0 = threadIdx.x / C * R;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = zero<T>();
  for (int s = lane; s < D; s += C) {
    const float* wrow = s_w + s * pw;
    T win[R];
#pragma unroll
    for (int r = 0; r < R - 1; ++r) win[r] = s_x[rows_slot<R>(r0 + r, s, D, pad)];
    // whole chunks of R steps without a guard, so that their loads can be
    // issued ahead of the MACs, then the last steps
    int b0 = 0;
    for (; b0 + R - 1 <= m; b0 += R) {
      float w[R];
      load_w<R>(w, wrow + b0);
#pragma unroll
      for (int bb = 0; bb < R; ++bb) rows_step<R>(win, acc, s_x, w, r0 + b0, bb, s, D, pad);
    }
    if (b0 <= m) {
      float w[R];
      load_w<R>(w, wrow + b0);
#pragma unroll
      for (int bb = 0; bb < R; ++bb) {
        if (b0 + bb <= m) rows_step<R>(win, acc, s_x, w, r0 + b0, bb, s, D, pad);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < C; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = add(acc[r], shfl_xor(acc[r], off));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long q = q0 + r0 + r;
    if (r % C == lane && q < nq) y[q] = acc[r];
  }
}

// Start staging the n weights of W into s_w as float32: a float32 W with
// cp.async (16-byte copies where aligned), in flight with the span's copies
// that follow; a bf16 W widened exactly. bf16 mode rounds s_w once every
// copy has landed (the caller, after a barrier).
__device__ __forceinline__ void stage_w(float* s_w, const float* __restrict__ W, int n) {
  int k0 = 0;
  if ((reinterpret_cast<unsigned long long>(W) & 15) == 0 &&
      (reinterpret_cast<unsigned long long>(s_w) & 15) == 0) {
    k0 = n & ~3;                                   // 16-byte copies, then the tail
    for (int k = 4 * threadIdx.x; k < k0; k += 4 * blockDim.x) cp_async16(s_w + k, W + k);
  }
  for (int k = k0 + threadIdx.x; k < n; k += blockDim.x) cp_async(s_w + k, W + k);
}
__device__ __forceinline__ void stage_w(float* s_w, const __nv_bfloat16* __restrict__ W,
                                        int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) s_w[k] = __bfloat162float(W[k]);
}

// Any I: a block computes rows q0 .. q0 + tm - 1, all I phases. Unit u =
// (row group gm, phase group gn) is an RM x RN register tile; thread tid takes
// K part p = tid / U (U = blockDim.x / ks) and units u = tid % U, u + U, ...
// Part p walks t = a * D + s over its range of [0, J) in W's own order: the
// sample of output row r is s_x[r * D + (m - a) * D + s], the weights are
// W[t, i], staged as given. Loads past the tile's last row or phase are
// clamped, their outputs dropped.
template <typename T, bool BF16, typename WT, int RM, int RN>
__global__ void __launch_bounds__(kMaxThreads)
poly_fir_gemm(const T* __restrict__ hist, const T* __restrict__ x,
              const WT* __restrict__ W, T* __restrict__ y, long long nq, int m, int D,
              int I, int tm, int ks, long long hs, long long xs, long long ws,
              long long ys) {
  const long long batch_lane = blockIdx.y;       // the lane form's stream
  hist += batch_lane * hs;
  x += batch_lane * xs;
  W += batch_lane * ws;
  y += batch_lane * ys;
  extern __shared__ float2 smem[];
  const int J = (m + 1) * D;
  float* s_w = reinterpret_cast<float*>(smem);                  // W as given, [J][I]
  T* s_x = reinterpret_cast<T*>(s_w + w_slots(J * I));          // (tm + m) * D samples
  T* s_red = s_x + (tm + m) * D;                                // ks x tm x I partials
  const long long q0 = static_cast<long long>(blockIdx.x) * tm;
  const long long H = static_cast<long long>(m) * D, n = nq * D;

  stage_w(s_w, W, J * I);
  stage_span<T, BF16>(s_x, hist, x, q0 * D, (tm + m) * D, H, n, [](int k) { return k; });
  __syncthreads();
  if (BF16) {
    for (int k = threadIdx.x; k < J * I; k += blockDim.x) s_w[k] = bf16_round(s_w[k]);
    __syncthreads();
  }

  const int gn_count = (I + RN - 1) / RN;
  const int units = ((tm + RM - 1) / RM) * gn_count;
  const int U = blockDim.x / ks;
  const int p = threadIdx.x / U;
  const int jc = (J + ks - 1) / ks;
  const int j0 = p * jc, j1 = min(J, j0 + jc);
  if (p < ks) {
    for (int u = threadIdx.x - p * U; u < units; u += U) {
      const int gm = u / gn_count, gn = u - gm * gn_count;
      int rl[RM], il[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) rl[r] = min(gm * RM + r, tm - 1) * D;
#pragma unroll
      for (int c = 0; c < RN; ++c) il[c] = min(gn * RN + c, I - 1);
      T acc[RM][RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = zero<T>();
      }
      int a = j0 / D, s = j0 - a * D;
      for (int t = j0; t < j1; ++t) {
        const int off = (m - a) * D + s;
        T v[RM];
        float w[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) v[r] = s_x[rl[r] + off];
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          w[c] = s_w[t * I + il[c]];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
#pragma unroll
          for (int c = 0; c < RN; ++c) mac(acc[r][c], v[r], w[c]);
        }
        if (++s == D) {
          s = 0;
          ++a;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int row = gm * RM + r;
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int i = gn * RN + c;
          if (row < tm && i < I && q0 + row < nq) {
            if (ks > 1) {
              s_red[(p * tm + row) * I + i] = acc[r][c];
            } else {
              y[(q0 + row) * I + i] = acc[r][c];
            }
          }
        }
      }
    }
  }
  if (ks > 1) {
    __syncthreads();
    const int outs = tm * I;
    for (int o = threadIdx.x; o < outs; o += blockDim.x) {
      if (q0 + o / I >= nq) break;                              // o only grows
      T sum = s_red[o];
      for (int pp = 1; pp < ks; ++pp) sum = add(sum, s_red[pp * outs + o]);
      y[q0 * I + o] = sum;
    }
  }
}

// The lanes and their strides in elements (one stream: 1 lane, strides 0).
struct Lanes {
  int lanes;
  long long hs, xs, ws, ys;
};

template <typename T, bool BF16, typename WT>
cudaError_t launch(const void* hist, const void* x, const void* W, void* y, long long nq,
                   int m, int D, int I, int gemm, int threads, int rows, int tile_rows,
                   int tile_phases, int ks, int pad, size_t smem, const Lanes& ln,
                   cudaStream_t stream) {
  const dim3 blocks(static_cast<unsigned>((nq + rows - 1) / rows),
                    static_cast<unsigned>(ln.lanes));
  auto h = static_cast<const T*>(hist);
  auto xx = static_cast<const T*>(x);
  auto w = static_cast<const WT*>(W);
  auto yy = static_cast<T*>(y);
  if (gemm) {
    void (*kern)(const T*, const T*, const WT*, T*, long long, int, int, int, int, int,
                 long long, long long, long long, long long) =
        tile_rows != 4        ? nullptr
        : tile_phases == 3    ? poly_fir_gemm<T, BF16, WT, 4, 3>
        : tile_phases == 4    ? poly_fir_gemm<T, BF16, WT, 4, 4>
        : tile_phases == 1    ? poly_fir_gemm<T, BF16, WT, 4, 1>
                              : nullptr;
    if (kern == nullptr || ks < 1 || threads % ks != 0) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<blocks, threads, smem, stream>>>(h, xx, w, yy, nq, m, D, I, rows, ks, ln.hs,
                                            ln.xs, ln.ws, ln.ys);
    return cudaGetLastError();
  }
  // "rows": R = 8 rows a group; C = ks lanes a group (a power of two, <= 4)
  void (*kern)(const T*, const T*, const WT*, T*, long long, int, int, int, long long,
               long long, long long, long long) =
      tile_rows != 8 ? nullptr
      : ks == 1      ? poly_fir_rows<T, BF16, WT, 8, 1>
      : ks == 2      ? poly_fir_rows<T, BF16, WT, 8, 2>
      : ks == 4      ? poly_fir_rows<T, BF16, WT, 8, 4>
                     : nullptr;
  if (kern == nullptr || I != 1 || threads % 32 != 0 || rows != threads / ks * tile_rows) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks, threads, smem, stream>>>(h, xx, w, yy, nq, m, D, pad, ln.hs, ln.xs, ln.ws,
                                          ln.ys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* hist, const void* x, const void* W, void* y, long long nq,
                     int m, int D, int I, int bf16, int w_bf16, int gemm, int threads,
                     int rows, int tr, int tp, int ks, int pad, size_t smem, const Lanes& ln,
                     cudaStream_t s) {
  if (w_bf16) {
    return bf16 ? launch<T, true, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, gemm, threads,
                                                 rows, tr, tp, ks, pad, smem, ln, s)
                : launch<T, false, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, gemm, threads,
                                                  rows, tr, tp, ks, pad, smem, ln, s);
  }
  return bf16 ? launch<T, true, float>(hist, x, W, y, nq, m, D, I, gemm, threads, rows, tr,
                                       tp, ks, pad, smem, ln, s)
              : launch<T, false, float>(hist, x, W, y, nq, m, D, I, gemm, threads, rows, tr,
                                        tp, ks, pad, smem, ln, s);
}

int run(const void* hist, const void* x, const void* W, void* y, long long nq, int m, int D,
        int I, int is_complex, int bf16, int w_bf16, int gemm, int threads, int rows,
        int tile_rows, int tile_phases, int ksplit, int pad, long long smem, const Lanes& ln,
        void* stream) {
  if (nq <= 0 || ln.lanes == 0) return 0;
  const size_t want =
      smem_bytes(gemm, m, D, I, rows, tile_rows, ksplit, pad, is_complex ? 8 : 4);
  if (static_cast<size_t>(smem) != want || threads < 1 || threads > kMaxThreads ||
      rows < 1 || ln.lanes < 0 || ln.lanes > 65535 || (ln.lanes > 1 && ln.ys < nq * I)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return dispatch<float2>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, gemm, threads, rows,
                            tile_rows, tile_phases, ksplit, pad, want, ln, s);
  }
  return dispatch<float>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, gemm, threads, rows,
                         tile_rows, tile_phases, ksplit, pad, want, ln, s);
}

}  // namespace

// hist: m * D samples before x; x: nq * D samples; W: (m + 1) * D * I weights,
// float32 or (w_bf16) bfloat16; y: nq * I outputs of the stream's type. The
// plan (cuda_kernels.poly_fir_plan): gemm (0: "rows", 1: "gemm"), threads,
// rows per block, rows and phases per thread, K split (the lanes of a group
// for "rows"), the pad slots of the "rows" span, and its shared memory, which
// must equal this layout's (smem_bytes). Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a plan the
// kernel does not take.
extern "C" int fsdr_poly_fir(const void* hist, const void* x, const void* W, void* y,
                             long long nq, int m, int D, int I, int is_complex, int bf16,
                             int w_bf16, int gemm, int threads, int rows, int tile_rows,
                             int tile_phases, int ksplit, int pad, long long smem,
                             void* stream) {
  return run(hist, x, W, y, nq, m, D, I, is_complex, bf16, w_bf16, gemm, threads, rows,
             tile_rows, tile_phases, ksplit, pad, smem, Lanes{1, 0, 0, 0, 0}, stream);
}

// The lane form: `lanes` streams, lane l's history at hist + l * hs, its frame
// at x + l * xs, its W at W + l * ws (ws = 0: one W for every lane) and its
// nq * I outputs at y + l * ys (strides in elements; the output rows must not
// overlap). The plan is the one-stream plan's layout with rows a block chosen
// for the batch (cuda_kernels.poly_fir_lanes_plan). Returns as fsdr_poly_fir.
extern "C" int fsdr_poly_fir_lanes(const void* hist, const void* x, const void* W, void* y,
                                   long long nq, int m, int D, int I, int is_complex,
                                   int bf16, int w_bf16, int gemm, int threads, int rows,
                                   int tile_rows, int tile_phases, int ksplit, int pad,
                                   long long smem, int lanes, long long hs, long long xs,
                                   long long ws, long long ys, void* stream) {
  return run(hist, x, W, y, nq, m, D, I, is_complex, bf16, w_bf16, gemm, threads, rows,
             tile_rows, tile_phases, ksplit, pad, smem, Lanes{lanes, hs, xs, ws, ys},
             stream);
}
