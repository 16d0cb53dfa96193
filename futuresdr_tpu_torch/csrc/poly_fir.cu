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
// Served FM at 64 sessions of 32,000 input samples: the channel filter moves
// 20.5 MB (6.1 us) beside 270 MFLOP (4.0 us), the resampler does 74 MFLOP
// (1.1 us).
//
// Each output's order of summation is fixed by the tiling and its K split
// alone, so that a served lane equals a bare one-stream launch bit for bit
// (cuda_kernels._same_order): "rows" sums column chain c (the columns s = c,
// c + C, ... in turn, each over the taps b = 0 .. m, one FMA chain from zero)
// and adds the C chains as (c0 + c1) + (c2 + c3); "gemm" sums part p (t in
// [p * jc, (p + 1) * jc), t = a * D + s, W's own order, from zero) and folds
// the parts left to right. How outputs map to threads, blocks and tiles is
// free, and is what the plan (cuda_kernels.poly_fir_plan) chooses; the order
// is the first design's at every shape (cuda_kernels._first_order).
//
// "rows" (I = 1; the channel filter). What the first design lost time to,
// measured at 64 sessions (PERF.md): its staging alone took 8.5 us and its
// MAC alone 12.2 us of its 19.0, so they did not overlap (a block staged its
// span, waited, then ran its MAC, and the blocks of a wave did so in step),
// and the MAC spent, beside its 264 FMAs an output, a shared-memory load for
// each sample of each column, 32 shuffles a lane to add the chains and a
// scattered 8-byte store per output. This design:
//  * gives each thread R consecutive outputs and all C chains: a step of the
//    sliding window loads one span row's C samples (two 16-byte loads at
//    D = 4 on complex64) and C weights (one 16-byte load) for R * C MACs,
//    the chains are added in registers in their fixed order, and the R
//    outputs are stored as 16-byte words;
//  * walks (lane, tile) pairs with a grid of resident blocks (the plan's
//    `blocks`, a static stride: no counter to reset between CUDA graph
//    replays) and two buffers, staging the next tile's span and W with
//    cp.async (16-byte copies where aligned) while the MAC runs on this one;
//  * pads the span after every R rows so that the rows a warp loads at one
//    step, R rows apart, fall on distinct banks (cuda_kernels._rows_pad).
//
// "gemm" (any I; the resampler): each thread a register tile of RM = 4 rows x
// RN phases (RN = 3 at I = 24), an outer-product accumulation over its part
// of J from shared memory (RM + RN loads for RM * RN independent MACs); a
// block takes the most rows (4 to 64) that still give 7/8 of a block per SM
// (a lane batch: 4 blocks a SM where it has them), splits J over the threads
// its tiles leave idle, sums the parts in shared memory in a fixed order and
// stores them coalesced. Its MAC alone took 11.7 of its 11.9 us at 64
// sessions (PERF.md), with 3.25 instructions an FMA in its loop: the sample's
// index was worked out anew at every step. The span is now staged with its
// rows reversed, so a step of t moves each row's sample pointer by one and
// W's by one row. Four other designs were built and measured slower at 16
// sessions, so none is kept (PERF.md): every part of a unit in one thread,
// folded in registers, one part at a time with W staged, four at a time with
// W read through L1 or staged; and the parts over threads with W read through
// L1.
//
// Rows before the frame come from the separate `hist` pointer, so the stage
// needs no concatenation in device memory; rows past the frame are zero and
// outputs past nq are not stored. A complex stream is read as float2 and
// filtered in ONE pass with the real W; the TPU kernel's two real passes were
// only its lane layout. f32 mode stays on the CUDA cores (FP32 FMAs, no
// TF32), as the JAX kernel's dots run at Precision.HIGHEST.
//
// bf16 mode (precision="bf16"): samples and weights are rounded to bf16 ("rows":
// where the MAC loads them; "gemm": when they are staged); their products are
// exact in FP32 and accumulate in FP32. W may arrive as bf16 (the stage's
// carried weights): it is widened exactly.
//
// Lanes (fsdr_poly_fir_lanes, the serving plane's [L, nq * D] batch, the
// counterpart of jax.vmap over pallas_poly_fir): each lane's hist, x, W and y
// sit at its strides (in elements; W's stride 0 is one W shared by every
// lane). "rows" walks the lanes' tiles as one sequence; "gemm" takes the lane
// as the grid's y dimension. The lane plan (cuda_kernels.poly_fir_lanes_plan)
// keeps the one-stream plan's order and picks the layout for the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The breakdown's cuts (port_lanes.py --breakdown): a build with
// -DFSDR_CUT_STAGE runs the staging alone (the copies and barriers stay, the
// MAC never runs), one with -DFSDR_CUT_MAC the MAC alone (no copy is made,
// the MAC runs on whatever shared memory holds). A part left out hangs on
// m < 0 or m >= 0, which the compiler cannot fold (the gemm's staging alone
// keeps one store of what it staged). With neither defined the kernels
// compile as they would without these lines.

namespace {

constexpr int kMaxThreads = 256;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// k / d for k * d < 2^32 (and d < 2^31): the high word of k * magic, magic =
// ceil(2^32 / d); d = 1 has no 32-bit magic and is k itself
__host__ inline unsigned div_magic(unsigned d) {
  return d > 1 ? static_cast<unsigned>((0x100000000ull + d - 1) / d) : 0u;
}
__device__ __forceinline__ int udiv(int k, unsigned magic) {
  return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(k), magic)) : k;
}

// Floats of a W staged ahead of samples: "rows", a multiple of 4, so the
// samples after it start 16-byte aligned; "gemm", even, for float2 samples
__host__ __device__ inline int w_slots(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int w_even(int n) { return (n + 1) & ~1; }

// "rows": the slots of a tile's span, tq + m rows of D samples, `pad` slots
// after every R rows (row j at slot j * D + pad * (j / R))
__host__ __device__ inline int rows_span(int tq, int m, int D, int R, int pad) {
  const int last = tq + m - 1;
  return last * D + D + pad * (last / R);
}

// "rows": floats of one tile's buffer, W then its span, a multiple of 4
__host__ __device__ inline int rows_buf_floats(int tq, int m, int D, int R, int pad, int elt) {
  return w_slots((m + 1) * D) + w_slots(rows_span(tq, m, D, R, pad) * elt / 4);
}

__host__ inline size_t smem_bytes(int gemm, int m, int D, int I, int rows, int tile_rows,
                                  int ks, int pad, int bufs, int elt) {
  if (!gemm) return 4 * static_cast<size_t>(bufs) *
                    rows_buf_floats(rows, m, D, tile_rows, pad, elt);
  const size_t red = ks > 1 ? static_cast<size_t>(ks) * rows * I : 0;
  return 4 * static_cast<size_t>(w_even((m + 1) * D * I)) +
         static_cast<size_t>(elt) * (static_cast<size_t>(rows + m) * D + red);
}

// Start staging the n weights of W into s_w as float32: a float32 W with
// cp.async (16-byte copies where aligned); a bf16 W widened exactly, with
// plain loads.
__device__ __forceinline__ void stage_w(float* s_w, const float* __restrict__ W, int n) {
  int k0 = 0;
  if (aligned16(W) && aligned16(s_w)) {
    k0 = n & ~3;                                   // 16-byte copies, then the tail
    for (int k = 4 * threadIdx.x; k < k0; k += 4 * blockDim.x) cp_async16(s_w + k, W + k);
  }
  for (int k = k0 + threadIdx.x; k < n; k += blockDim.x) cp_async(s_w + k, W + k);
}
__device__ __forceinline__ void stage_w(float* s_w, const __nv_bfloat16* __restrict__ W,
                                        int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) s_w[k] = __bfloat162float(W[k]);
}

// The sample e of hist ++ x (H = m * D history samples, n frame samples; zero
// past the frame) into *d with cp.async.
template <typename T>
__device__ __forceinline__ void stage_one(T* d, const T* __restrict__ hist,
                                          const T* __restrict__ x, long long e, long long H,
                                          long long n) {
  if (e < H) {
    cp_async(d, hist + e);
  } else if (e - H < n) {
    cp_async(d, x + (e - H));
  } else {
    *d = zero<T>();
  }
}

// "rows": start staging a tile's span, samples k < count of hist ++ x from
// sample e0 on, sample k at slot k + pad * (k / RD) (RD = R * D). `wide`:
// 16-byte copies, none of which straddles a pad, the end of hist or the end
// of the frame (the caller checks the alignments).
template <typename T>
__device__ __forceinline__ void stage_rows_span(T* s, const T* __restrict__ hist,
                                                const T* __restrict__ x, long long e0,
                                                int count, long long H, long long n, int pad,
                                                unsigned rd_magic, bool wide) {
  if (wide) {
    constexpr int E = 16 / sizeof(T);
    for (int u = threadIdx.x; u < count / E; u += blockDim.x) {
      const int k = u * E;
      T* d = s + k + pad * udiv(k, rd_magic);
      const long long e = e0 + k;
      if (e < H) {
        cp_async16(d, hist + e);
      } else if (e - H < n) {
        cp_async16(d, x + (e - H));
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      stage_one(s + k + pad * udiv(k, rd_magic), hist, x, e0 + k, H, n);
    }
  }
}

// N consecutive values from p: 16-byte loads where VEC (the caller keeps p
// aligned to the load), else the first nc of them one by one and zeros after
template <int N, bool VEC, typename T>
__device__ __forceinline__ void load_run(T (&v)[N], const T* p, int nc) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if (VEC && bytes % 16 == 0) {
#pragma unroll
    for (int u = 0; u < bytes / 16; ++u) {
      const float4 f = reinterpret_cast<const float4*>(p)[u];
      float* o = reinterpret_cast<float*>(v) + 4 * u;
      o[0] = f.x;
      o[1] = f.y;
      o[2] = f.z;
      o[3] = f.w;
    }
  } else if (VEC && bytes == 8) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    float* o = reinterpret_cast<float*>(v);
    o[0] = f.x;
    o[1] = f.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = (VEC || c < nc) ? p[c] : zero<T>();
  }
}

// "rows", step bb of a chunk: row r of the R outputs takes window slot
// (bb + r) mod R, column chain c its column's weight (columns past nc skipped)
template <bool BF16, int R, int C, bool VEC, typename T>
__device__ __forceinline__ void rows_macs(T (&acc)[R][C], const T (&win)[R][C],
                                          const float (&w)[C], int bb, int nc) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (VEC || c < nc) mac(acc[r][c], prep<BF16>(win[(bb + r) % R][c]), prep<BF16>(w[c]));
    }
  }
}

// "rows", one column group of C columns: adds to acc[r][c] the taps b = 0 ..
// m of column c of the group for the thread's R rows, b ascending. xg: the
// group's first column in the thread's first span row; wg: W[m, the group's
// first column] (W[m - b] lies b * D floats before it). At step b the window
// holds span rows b .. b + R - 1 (relative to the thread's first), row i in
// slot i mod R: step b loads row b + R - 1, row r of the R outputs MACs slot
// (b + r) mod R. nc: the group's columns (C unless the last of a D that C
// does not divide).
template <typename T, bool BF16, int R, int C, bool VEC>
__device__ __forceinline__ void rows_group(T (&acc)[R][C], const T* xg, const float* wg,
                                           int m, int D, int pad, int nc) {
  T win[R][C];
#pragma unroll
  for (int r = 0; r < R - 1; ++r) load_run<C, VEC>(win[r], xg + r * D, nc);
  const int step = R * D + pad;                 // slots from one chunk of R rows to the next
  int b0 = 0;
  const T* pc = xg;
  // whole chunks of R steps without a guard, so that their loads can be issued
  // ahead of the MACs, then the last steps
  for (; b0 + R - 1 <= m; b0 += R, pc += step) {
#pragma unroll
    for (int bb = 0; bb < R; ++bb) {
      const int i = bb + R - 1;
      load_run<C, VEC>(win[i % R], pc + i * D + (i >= R ? pad : 0), nc);
      float w[C];
      load_run<C, VEC>(w, wg - (b0 + bb) * D, nc);
      rows_macs<BF16, R, C, VEC>(acc, win, w, bb, nc);
    }
  }
#pragma unroll
  for (int bb = 0; bb < R; ++bb) {
    if (b0 + bb <= m) {
      const int i = bb + R - 1;
      load_run<C, VEC>(win[i % R], pc + i * D + (i >= R ? pad : 0), nc);
      float w[C];
      load_run<C, VEC>(w, wg - (b0 + bb) * D, nc);
      rows_macs<BF16, R, C, VEC>(acc, win, w, bb, nc);
    }
  }
}

// the C chains of an output added in their fixed order: (c0 + c1) + (c2 + c3)
template <int C, typename T>
__device__ __forceinline__ T chains(const T (&a)[C]) {
  if (C == 4) return add(add(a[0], a[1]), add(a[2], a[3]));
  if (C == 2) return add(a[0], a[1]);
  return a[0];
}

// N outputs from p on, the first `valid` of them: 16-byte stores where all are
// valid and p is aligned
template <int N, typename T>
__device__ __forceinline__ void store_run(T* p, const T (&v)[N], long long valid) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0 && valid >= N && aligned16(p)) {
#pragma unroll
    for (int u = 0; u < bytes / 16; ++u) {
      const float* o = reinterpret_cast<const float*>(v) + 4 * u;
      reinterpret_cast<float4*>(p)[u] = make_float4(o[0], o[1], o[2], o[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r < valid) p[r] = v[r];
    }
  }
}

// "rows" (I = 1). The block walks tiles blockIdx.x, + gridDim.x, ... of the
// lanes' tiles (tile t: lane t / tiles, rows (t mod tiles) * tq on, tq =
// blockDim.x * R), staging each into one of `bufs` buffers ([W as given, a
// multiple of 4 floats][the padded span]); with two, the next tile's copies
// fly while the MAC runs on this one. Thread t computes the tile's rows
// t * R .. t * R + R - 1, all C chains of each (rows_group over the column
// groups), then adds the chains and stores its R outputs.
template <typename T, bool BF16, typename WT, int R, int C, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
poly_fir_rows(const T* __restrict__ hist, const T* __restrict__ x,
              const WT* __restrict__ W, T* __restrict__ y, long long nq, int m, int D,
              int pad, int lanes, int bufs, unsigned rd_magic, long long hs, long long xs,
              long long ws, long long ys) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tq = blockDim.x * R;
  const int wn = (m + 1) * D;
  const int buf_floats = rows_buf_floats(tq, m, D, R, pad, sizeof(T));
  const long long tiles = (nq + tq - 1) / tq;
  const long long total = tiles * lanes;
  const long long H = static_cast<long long>(m) * D, n = nq * D;
  const int count = (tq + m) * D;
  constexpr int E = 16 / sizeof(T);

  auto stage = [&](long long t, float* buf) {
#if defined(FSDR_CUT_MAC)
    if (m >= 0) return;
#endif
    const long long lane = t / tiles;
    const long long q0 = (t - lane * tiles) * tq;
    const T* h = hist + lane * hs;
    const T* xx = x + lane * xs;
    stage_w(buf, W + lane * ws, wn);
    const bool wide = aligned16(h) && aligned16(xx) && (R * D) % E == 0 && pad % E == 0 &&
                      H % E == 0 && n % E == 0;
    stage_rows_span(reinterpret_cast<T*>(buf + w_slots(wn)), h, xx, q0 * D, count, H, n, pad,
                    rd_magic, wide);
  };

  long long t = blockIdx.x;
  stage(t, smem);
  cp_async_commit();
  for (int it = 0;; ++it) {
    float* buf = smem + (it & 1) * (bufs - 1) * buf_floats;
    const long long next = t + gridDim.x;
    if (next < total) stage(next, smem + ((it + 1) & 1) * buf_floats);
    cp_async_commit();
    cp_async_wait<1>();                              // this tile's copies
    __syncthreads();

    const long long lane = t / tiles;
    const long long q = (t - lane * tiles) * tq + threadIdx.x * R;
#if defined(FSDR_CUT_STAGE)
    if (q < nq && m < 0) {
#else
    if (q < nq) {
#endif
      const T* xt = reinterpret_cast<const T*>(buf + w_slots(wn)) + threadIdx.x * (R * D + pad);
      const float* wt = buf + m * D;
      T acc[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = zero<T>();
      }
      for (int g = 0; g * C < D; ++g) {
        rows_group<T, BF16, R, C, VEC>(acc, xt + g * C, wt + g * C, m, D, pad,
                                       VEC ? C : min(C, D - g * C));
      }
      T out[R];
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] = chains<C>(acc[r]);
      store_run<R>(y + lane * ys + q, out, nq - q);
    }
    if (next >= total) break;
    __syncthreads();                                 // this buffer is free to restage
    t = next;
  }
}

// Any I: a block computes rows q0 .. q0 + tm - 1 of its lane (the grid's y),
// all I phases. Unit u = (row group gm, phase group gn) is an RM x RN
// register tile; thread tid takes K part p = tid / U (U = blockDim.x / ks) and
// units u = tid % U, u + U, ... Part p walks t over its range of [0, J) in W's
// own order (t = a * D + s). The span is staged with its rows reversed (span
// row j at slot (tm + m - 1 - j) * D), so the sample of output row r for step
// t sits at (tm - 1 - r) * D + t and a step moves every row's pointer by one
// sample and W's by one row. Loads past the tile's last row or phase are
// clamped, their outputs dropped. The parts are summed through shared memory
// in a fixed order and stored coalesced.
template <typename T, bool BF16, typename WT, int RM, int RN>
__global__ void __launch_bounds__(kMaxThreads)
poly_fir_gemm(const T* __restrict__ hist, const T* __restrict__ x,
              const WT* __restrict__ W, T* __restrict__ y, long long nq, int m, int D,
              int I, int tm, int ks, unsigned d_magic, long long hs, long long xs,
              long long ws, long long ys) {
  const long long batch_lane = blockIdx.y;       // the lane form's stream
  hist += batch_lane * hs;
  x += batch_lane * xs;
  W += batch_lane * ws;
  y += batch_lane * ys;
  extern __shared__ float4 smem4[];
  const int J = (m + 1) * D;
  float* s_w = reinterpret_cast<float*>(smem4);                 // W as given, [J][I]
  T* s_x = reinterpret_cast<T*>(s_w + w_even(J * I));           // (tm + m) * D samples
  T* s_red = s_x + (tm + m) * D;                                // ks x tm x I partials
  const long long q0 = static_cast<long long>(blockIdx.x) * tm;
  const long long H = static_cast<long long>(m) * D, n = nq * D;
  const int rows = tm + m;

#if !defined(FSDR_CUT_MAC)
  stage_w(s_w, W, J * I);
  for (int k = threadIdx.x; k < rows * D; k += blockDim.x) {
    const int j = udiv(k, d_magic);
    stage_one(s_x + (rows - 1 - j) * D + (k - j * D), hist, x, q0 * D + k, H, n);
  }
#endif
  cp_async_commit();
  cp_async_wait<0>();
  if (BF16) {                                    // what this thread staged
    for (int k = threadIdx.x; k < rows * D; k += blockDim.x) {
      const int j = udiv(k, d_magic);
      T* d = s_x + (rows - 1 - j) * D + (k - j * D);
      *d = prep<BF16>(*d);
    }
  }
  __syncthreads();
  if (BF16) {
    for (int k = threadIdx.x; k < J * I; k += blockDim.x) s_w[k] = bf16_round(s_w[k]);
    __syncthreads();
  }

#if defined(FSDR_CUT_STAGE)
  if (m >= 0) {
    if (threadIdx.x == 0) {
      T v = s_x[1];
      mac(v, v, s_w[1]);
      y[q0 * I] = v;
    }
    return;
  }
#endif
  const int gn_count = (I + RN - 1) / RN;
  const int units = ((tm + RM - 1) / RM) * gn_count;
  const int U = blockDim.x / ks;
  const int p = threadIdx.x / U;
  const int jc = (J + ks - 1) / ks;
  const int j0 = p * jc, j1 = min(J, j0 + jc);
  if (p < ks) {
    for (int u = threadIdx.x - p * U; u < units; u += U) {
      const int gm = u / gn_count, gn = u - gm * gn_count;
      const T* xr[RM];
      int il[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) xr[r] = s_x + (tm - 1 - min(gm * RM + r, tm - 1)) * D;
#pragma unroll
      for (int c = 0; c < RN; ++c) il[c] = min(gn * RN + c, I - 1);
      T acc[RM][RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = zero<T>();
      }
      const float* wr = s_w + j0 * I;
#pragma unroll 4
      for (int t = j0; t < j1; ++t, wr += I) {
        T v[RM];
        float w[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) v[r] = xr[r][t];
#pragma unroll
        for (int c = 0; c < RN; ++c) w[c] = wr[il[c]];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
#pragma unroll
          for (int c = 0; c < RN; ++c) mac(acc[r][c], v[r], w[c]);
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

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool BF16, typename WT, int R, int C, bool VEC>
cudaError_t launch_rows(const T* h, const T* x, const WT* w, T* y, long long nq, int m, int D,
                        int threads, int pad, int blocks, size_t smem, const Lanes& ln,
                        cudaStream_t stream) {
  const int tq = threads * R;
  const long long total = (nq + tq - 1) / tq * ln.lanes;
  const long long grid = blocks > 0 && blocks < total ? blocks : total;
  auto kern = poly_fir_rows<T, BF16, WT, R, C, VEC>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      h, x, w, y, nq, m, D, pad, ln.lanes, blocks > 0 ? 2 : 1, div_magic(R * D), ln.hs,
      ln.xs, ln.ws, ln.ys);
  return cudaGetLastError();
}

template <typename T, bool BF16, typename WT>
cudaError_t launch(const void* hist, const void* x, const void* W, void* y, long long nq,
                   int m, int D, int I, int gemm, int threads, int rows, int tile_rows,
                   int tile_phases, int ks, int pad, int blocks, size_t smem, const Lanes& ln,
                   cudaStream_t stream) {
  auto h = static_cast<const T*>(hist);
  auto xx = static_cast<const T*>(x);
  auto w = static_cast<const WT*>(W);
  auto yy = static_cast<T*>(y);
  if (gemm) {
    void (*kern)(const T*, const T*, const WT*, T*, long long, int, int, int, int, int,
                 unsigned, long long, long long, long long, long long) =
        tile_rows != 4        ? nullptr
        : tile_phases == 3    ? poly_fir_gemm<T, BF16, WT, 4, 3>
        : tile_phases == 4    ? poly_fir_gemm<T, BF16, WT, 4, 4>
        : tile_phases == 1    ? poly_fir_gemm<T, BF16, WT, 4, 1>
                              : nullptr;
    if (kern == nullptr || ks < 1 || threads % ks != 0) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(static_cast<unsigned>((nq + rows - 1) / rows),
                    static_cast<unsigned>(ln.lanes));
    kern<<<grid, threads, smem, stream>>>(h, xx, w, yy, nq, m, D, I, rows, ks, div_magic(D),
                                          ln.hs, ln.xs, ln.ws, ln.ys);
    return cudaGetLastError();
  }
  // "rows": R = 4 rows a thread; C = ks chains (1, 2 or 4); 16-byte window
  // loads where C divides D and the pad keeps the rows aligned
  if (I != 1 || tile_rows != 4 || threads % 32 != 0 || rows != threads * tile_rows ||
      blocks < 0 || pad < 0 || (ks != 1 && ks != 2 && ks != 4)) {
    return cudaErrorInvalidValue;
  }
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const bool vec = D % ks == 0 && pad % (E < ks ? E : ks) == 0;
  switch (ks * 2 + vec) {
    case 3: return launch_rows<T, BF16, WT, 4, 1, true>(h, xx, w, yy, nq, m, D, threads, pad,
                                                        blocks, smem, ln, stream);
    case 4: return launch_rows<T, BF16, WT, 4, 2, false>(h, xx, w, yy, nq, m, D, threads, pad,
                                                         blocks, smem, ln, stream);
    case 5: return launch_rows<T, BF16, WT, 4, 2, true>(h, xx, w, yy, nq, m, D, threads, pad,
                                                        blocks, smem, ln, stream);
    case 8: return launch_rows<T, BF16, WT, 4, 4, false>(h, xx, w, yy, nq, m, D, threads, pad,
                                                         blocks, smem, ln, stream);
    case 9: return launch_rows<T, BF16, WT, 4, 4, true>(h, xx, w, yy, nq, m, D, threads, pad,
                                                        blocks, smem, ln, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* hist, const void* x, const void* W, void* y, long long nq,
                     int m, int D, int I, int bf16, int w_bf16, int gemm, int threads,
                     int rows, int tr, int tp, int ks, int pad, int blocks, size_t smem,
                     const Lanes& ln, cudaStream_t s) {
  if (w_bf16) {
    return bf16 ? launch<T, true, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, gemm, threads,
                                                 rows, tr, tp, ks, pad, blocks, smem, ln, s)
                : launch<T, false, __nv_bfloat16>(hist, x, W, y, nq, m, D, I, gemm, threads,
                                                  rows, tr, tp, ks, pad, blocks, smem, ln, s);
  }
  return bf16 ? launch<T, true, float>(hist, x, W, y, nq, m, D, I, gemm, threads, rows, tr,
                                       tp, ks, pad, blocks, smem, ln, s)
              : launch<T, false, float>(hist, x, W, y, nq, m, D, I, gemm, threads, rows, tr,
                                        tp, ks, pad, blocks, smem, ln, s);
}

int run(const void* hist, const void* x, const void* W, void* y, long long nq, int m, int D,
        int I, int is_complex, int bf16, int w_bf16, int gemm, int threads, int rows,
        int tile_rows, int tile_phases, int ksplit, int pad, int blocks, long long smem,
        const Lanes& ln, void* stream) {
  if (nq <= 0 || ln.lanes == 0) return 0;
  const int elt = is_complex ? 8 : 4;
  const int bufs = !gemm && blocks > 0 ? 2 : 1;
  const size_t want = smem_bytes(gemm, m, D, I, rows, tile_rows, ksplit, pad, bufs, elt);
  // the stage's index division holds for k * d < 2^32 (k < the span's samples)
  const unsigned long long span = static_cast<unsigned long long>(rows + m) * D;
  const unsigned long long d = gemm ? D : static_cast<unsigned long long>(tile_rows) * D;
  if (static_cast<size_t>(smem) != want || threads < 1 || threads > kMaxThreads ||
      rows < 1 || ln.lanes < 0 || ln.lanes > 65535 || (ln.lanes > 1 && ln.ys < nq * I) ||
      span * d >= (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return dispatch<float2>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, gemm, threads, rows,
                            tile_rows, tile_phases, ksplit, pad, blocks, want, ln, s);
  }
  return dispatch<float>(hist, x, W, y, nq, m, D, I, bf16, w_bf16, gemm, threads, rows,
                         tile_rows, tile_phases, ksplit, pad, blocks, want, ln, s);
}

}  // namespace

// hist: m * D samples before x; x: nq * D samples; W: (m + 1) * D * I weights,
// float32 or (w_bf16) bfloat16; y: nq * I outputs of the stream's type. The
// plan (cuda_kernels.poly_fir_plan): gemm (0: "rows", 1: "gemm"), threads,
// rows per block (a tile), rows and phases per thread, K split (the column
// chains of "rows", the parts of J of "gemm"), the pad slots of the "rows"
// span, the resident blocks of the "rows" walk, and its shared memory, which
// must equal this layout's (smem_bytes). Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a plan the kernel does
// not take.
extern "C" int fsdr_poly_fir(const void* hist, const void* x, const void* W, void* y,
                             long long nq, int m, int D, int I, int is_complex, int bf16,
                             int w_bf16, int gemm, int threads, int rows, int tile_rows,
                             int tile_phases, int ksplit, int pad, int blocks, long long smem,
                             void* stream) {
  return run(hist, x, W, y, nq, m, D, I, is_complex, bf16, w_bf16, gemm, threads, rows,
             tile_rows, tile_phases, ksplit, pad, blocks, smem, Lanes{1, 0, 0, 0, 0}, stream);
}

// The lane form: `lanes` streams, lane l's history at hist + l * hs, its frame
// at x + l * xs, its W at W + l * ws (ws = 0: one W for every lane) and its
// nq * I outputs at y + l * ys (strides in elements; the output rows must not
// overlap). The plan is the one-stream plan's order with a layout chosen for
// the batch (cuda_kernels.poly_fir_lanes_plan). Returns as fsdr_poly_fir.
extern "C" int fsdr_poly_fir_lanes(const void* hist, const void* x, const void* W, void* y,
                                   long long nq, int m, int D, int I, int is_complex,
                                   int bf16, int w_bf16, int gemm, int threads, int rows,
                                   int tile_rows, int tile_phases, int ksplit, int pad,
                                   int blocks, long long smem, int lanes, long long hs,
                                   long long xs, long long ws, long long ys, void* stream) {
  return run(hist, x, W, y, nq, m, D, I, is_complex, bf16, w_bf16, gemm, threads, rows,
             tile_rows, tile_phases, ksplit, pad, blocks, smem, Lanes{lanes, hs, xs, ws, ys},
             stream);
}
