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
// Design ("window" layout; the plan, cuda_kernels.pfb_plan, picks every size):
// one thread block per tile of `tr` output rows. The block walks the channels
// in chunks of C (all N at once up to N = 256, 512 at a time above), and for
// each chunk stages the chunk's columns of the tile's tr + K - 1 commutated
// rows in shared memory with cp.async, double-buffered where there are
// several chunks: the next chunk's copies fly while the MAC runs on this one. Each staged sample is read from
// the flat stream in order and lands at its reversed column, so no reversed
// or concatenated copy of the stream ever reaches device memory; rows before
// the frame come from the separate `hist` pointer. The MAC is a sliding
// register window down the rows: each thread owns one channel for R
// consecutive output rows, so each staged row sample feeds up to R FMA pairs
// (R + K - 1 loads for R outputs, where the first design loaded K per
// output), and at K = 12 (a template constant, so the registers are indexed
// by constants) the channel's K taps stay in registers; any other K reads them
// from shared memory, staged with the chunk. The taps are read through two
// strides, so the stage's [N, K] carry passes as its transposed view. The MAC
// writes v in natural order into a padded shared buffer (one pad slot every
// 16 points), so the branch bank never reaches device memory. Then the IDFT of
// each row:
//  * N a power of two: Stockham (self-sorting) passes of radix 16 with one
//    smaller pass first (4 x 16 at N = 64, 8 x 16 x 16 at N = 2048), 16 points
//    a thread in registers (fsdr::stockham_bfly, inverse), exchanging points
//    through the padded buffers only between passes; each pass reads its own
//    slice of a twiddle table staged in shared memory, and the last pass
//    stores y in natural order, neighbouring threads on neighbouring bins;
//  * any other N: a direct DFT, each output a sum over its row.
// Twiddles come from a table the host builds in float64 (cuda_kernels.
// _fft_table): for Stockham pass p, entry (q - 1) * Ns + k holds (cos, sin)
// (2 pi ((k q stride) mod N) / N); for the direct DFT entry k holds
// (cos, sin)(2 pi k / N), and the phase index (c * c') mod N is reduced in
// integers: the accuracy rule of the TPU kernel's twiddles. The TPU kernel's
// dense IDFT matmul (8 * N FLOP per sample) is not carried over.
//
// Where a row of v does not fit beside the staging buffers (N >= 16,384 as a
// power of two, any N above about 16,000), the plan takes the first design's
// "v" layout instead: one row a block, the MAC reading rows and taps from
// device memory, v alone in shared memory (bit-reversed), an in-place radix-2
// transform or the direct DFT. Every N up to 29,056 runs.
//
// bf16 mode (precision="bf16"): samples and taps are rounded to bf16 when they
// are staged (their products are exact in FP32 and accumulate in FP32) and v is
// rounded to bf16 before the transform, which keeps FP32 twiddles (the TPU
// kernel also rounds its cos/sin matrices to bf16). Taps may arrive as bf16
// (the stage's carried taps): they are widened exactly.
//
// Lanes (fsdr_pfb_lanes, the serving plane's [L, t * N] batch, the counterpart
// of jax.vmap over pallas_pfb): the lane is the grid's y dimension in both
// layouts. Each block first moves its hist, x, taps and y pointers to its
// lane's rows (strides in elements; the taps' lane stride 0 is one prototype
// shared by every lane, read from the same addresses, so L2 serves it once),
// then runs the one-stream kernel's code; the twiddle table is one for every
// lane, staged once a block as in one stream. A lane's values are set by the
// layout (window or v) and the radices alone: each output sums its taps in
// ascending kk whatever R, and the pad, the tile and the staging of the
// twiddles move no value. The lane plan (cuda_kernels.pfb_lanes_plan) keeps
// the one-stream plan's layout and radices, so each lane is bit-equal to a
// one-stream launch, and chooses R and the tile over the whole batch (PFB-64
// at 64 sessions of 2^15: R = 8, 32 rows a tile, where one stream's plan at
// 512 rows takes R = 1 so that one stream fills the card). Where that window
// plan has PFB-64's shape (one chunk, K = 12, R = 8, two passes) and every
// lane's rows are 16-byte aligned, the plan takes the "walk" instead of a
// block a tile: resident blocks walking runs of tiles over a ring of bulk
// copies that stages each row once, the last pass beside the next tile's MAC
// (pfb_walk_kernel below; PERF.md has the breakdown that chose it).

#include <cstdint>

#include "common.cuh"

// The breakdown's cuts (port_lanes.py --breakdown): a build with
// -DFSDR_CUT_<PHASE> runs one phase of a tile alone. STAGE: the copies and
// their wait, then the block moves on; MAC: no copy is made, the taps' loads
// and the MAC run on whatever shared memory holds, no IDFT; IDFT: no copy, no
// MAC, the passes run with the last one writing shared memory; STORE: no copy,
// no MAC, no arithmetic pass, the last pass's stores of shared memory to y. A
// part left out hangs on a test that never holds at run time (k < 0, n < 0)
// but that the compiler cannot fold, so the phase kept runs as it does whole.
// With none defined the kernels compile as they would without these lines.
#if defined(FSDR_CUT_MAC) || defined(FSDR_CUT_IDFT) || defined(FSDR_CUT_STORE)
#define PFB_CUT_COPY 1
#endif
#if defined(FSDR_CUT_IDFT) || defined(FSDR_CUT_STORE)
#define PFB_CUT_MAC 1
#endif

namespace {

using fsdr::skew;

constexpr int kMaxThreads = 512;
constexpr int kMaxPasses = 16;
constexpr int kRegTaps = 12;             // K with its taps in registers
constexpr int kWalkR = 8;                // the walk's rows a thread
constexpr int kWalkStages = 3;           // its ring: the tile read, the one before, one ahead

__device__ __forceinline__ float tap_at(const void* taps, int taps_bf16, long long i) {
  return taps_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(taps)[i])
                   : static_cast<const float*>(taps)[i];
}

__device__ __forceinline__ float round_if(float v, int bf16) {
  return bf16 ? fsdr::bf16_round(v) : v;
}

__device__ __forceinline__ float2 round_if(float2 v, int bf16) {
  return bf16 ? fsdr::bf16_round(v) : v;
}

// Hopper's 1-D bulk copy (TMA without a tensor map) into shared memory,
// completing on an mbarrier that counts the bytes, and the barrier's calls
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the barrier's inits visible to the async proxy (the bulk copies) too
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's phase `parity` to complete; a copy that never lands
// (about 10 s of the SM's clock) traps, failing the launch, never hangs it.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// staging buffers: two (double-buffered) where the channels take several
// chunks, else one
__host__ inline int stage_bufs(int n, int chunk) { return n > chunk ? 2 : 1; }

// float2 slots of the second buffer: the staging buffers of (tr + k - 1) x
// chunk samples, and a Stockham buffer where the transform makes two passes
// or more
__host__ inline long long w_slots(int n, int k, int tr, int chunk, int pitch, int n_pass) {
  const long long stage = static_cast<long long>(stage_bufs(n, chunk)) * (tr + k - 1) * chunk;
  const long long fft = n_pass >= 2 ? static_cast<long long>(tr) * pitch : 0;
  return stage > fft ? stage : fft;
}

// v rows (tr x pitch), the second buffer, the staged twiddle table, and with
// the taps out of registers their staging buffers (k x chunk floats each)
__host__ inline long long window_smem(int n, int k, int tr, int chunk, int pitch,
                                      int n_pass, int tw_staged_len, int k_regs) {
  return 8 * (static_cast<long long>(tr) * pitch +
              w_slots(n, k, tr, chunk, pitch, n_pass) + tw_staged_len) +
         (k_regs ? 0 : 4LL * stage_bufs(n, chunk) * k * chunk);
}

// The "walk" layout's bytes: the ring's mbarriers (16-byte aligned),
// kWalkStages slots of k - 1 + tr rows of n samples, the v rows, the Stockham
// buffer and the staged twiddle table
constexpr int kWalkBarBytes = 16 * ((kWalkStages + 1) / 2);
__host__ inline long long walk_smem(int n, int k, int tr, int pitch, int tw_staged_len) {
  return kWalkBarBytes +
         8 * (static_cast<long long>(kWalkStages) * (k - 1 + tr) * n + 2LL * tr * pitch +
              tw_staged_len);
}

// One Stockham pass of radix RX (inverse) over the tile's rows: butterfly b
// of the pass is butterfly j = b mod nb of row b / nb. The LAST pass stores
// the rows of y that lie in the frame.
template <int RX, bool LAST>
__device__ __forceinline__ void idft_pass(const float2* src, float2* dst, float2* y,
                                          long long s0, long long t, int tr, int n,
                                          int pitch, int psh, const float2* tw, int ns) {
  const int nb = n / RX;
  const int nb_sh = __ffs(nb) - 1;
  for (int b = threadIdx.x; b < tr * nb; b += blockDim.x) {
    const int row = b >> nb_sh;
    const int j = b & (nb - 1);
    if (LAST) {
      if (s0 + row < t) {
#ifdef FSDR_CUT_STORE
        const int kq = j & (ns - 1);
#pragma unroll
        for (int q = 0; q < RX; ++q) {
          y[(s0 + row) * n + (j - kq) * RX + kq + q * ns] =
              src[row * pitch + skew(j + q * nb, psh)];
        }
#else
        fsdr::stockham_bfly<RX, true, false>(src + row * pitch, y + (s0 + row) * n, psh,
                                             tw, j, nb, ns);
#endif
      }
    } else {
      fsdr::stockham_bfly<RX, true, true>(src + row * pitch, dst + row * pitch, psh, tw,
                                          j, nb, ns);
    }
  }
}

template <bool LAST>
__device__ __forceinline__ void idft_pass_radix(int code, const float2* src, float2* dst,
                                                float2* y, long long s0, long long t,
                                                int tr, int n, int pitch, int psh,
                                                const float2* tw, int ns) {
  switch (code) {
    case 0: idft_pass<2, LAST>(src, dst, y, s0, t, tr, n, pitch, psh, tw, ns); break;
    case 1: idft_pass<4, LAST>(src, dst, y, s0, t, tr, n, pitch, psh, tw, ns); break;
    case 2: idft_pass<8, LAST>(src, dst, y, s0, t, tr, n, pitch, psh, tw, ns); break;
    default: idft_pass<16, LAST>(src, dst, y, s0, t, tr, n, pitch, psh, tw, ns); break;
  }
}

// The "window" layout. Thread (g, cc) = (tid / chunk, tid mod chunk), g <
// groups: channel ch * chunk + cc of chunk ch, output rows g * R ... g * R +
// R - 1 of the tile. KT = K with the taps in registers, 0 with them in shared
// memory.
template <int KT, int R>
__global__ void __launch_bounds__(kMaxThreads)
pfb_window_kernel(const float2* __restrict__ hist, const float2* __restrict__ x,
                  const void* __restrict__ taps, long long tap_sk, long long tap_sn,
                  int taps_bf16, const float2* __restrict__ tw_g, float2* __restrict__ y,
                  long long t, int n, int k, int chunk, int groups, int n_pass,
                  unsigned radix_codes, int pitch, int psh, int w_len, int tw_staged_len,
                  int bf16, long long hs, long long xs, long long tls, long long ys) {
  const long long batch_lane = blockIdx.y;       // the lane form's stream
  hist += batch_lane * hs;
  x += batch_lane * xs;
  y += batch_lane * ys;
  taps = static_cast<const char*>(taps) + batch_lane * tls * (taps_bf16 ? 2 : 4);
  extern __shared__ float2 smem[];
  const int tr = groups * R;
  const int span = tr + k - 1;                     // staged rows of a chunk
  float2* s_v = smem;                              // tr rows of v, pitch apart
  float2* s_w = s_v + tr * pitch;                  // staging buffers, then a Stockham buffer
  float2* s_tw = s_w + w_len;
  float* s_taps = reinterpret_cast<float*>(s_tw + tw_staged_len);   // KT == 0 only
  const long long s0 = static_cast<long long>(blockIdx.x) * tr;
  const long long hist_len = static_cast<long long>(k - 1) * n;
  const long long ext_len = hist_len + t * n;
  const int g = threadIdx.x / chunk;
  const int cc = threadIdx.x - g * chunk;
  const bool active = g < groups;
  const int n_chunks = (n + chunk - 1) / chunk;

  // Chunk ch into staging buffer ch & 1: rows r of the tile's span (thread
  // (g, cc) takes r = g, g + groups, ...), the sample of channel c at
  // ext[(s0 + r) * N + N - 1 - c], zero past the frame; with KT == 0 the
  // chunk's taps too (plain loads). One cp.async group per chunk.
  auto stage = [&](int ch) {
    float2* buf = s_w + (ch & 1) * span * chunk;
    const int c = ch * chunk + cc;
#ifdef PFB_CUT_COPY
    if (active && k < 0) {
#else
    if (active) {
#endif
      for (int r = g; r < span; r += groups) {
        float2* d = buf + r * chunk + cc;
        const long long e = (s0 + r) * n + (n - 1 - c);
        if (c < n && e < ext_len) {
          fsdr::cp_async(d, e < hist_len ? hist + e : x + (e - hist_len));
        } else {
          *d = make_float2(0.f, 0.f);
        }
      }
      if (KT == 0) {
        float* tb = s_taps + (ch & 1) * k * chunk;
        for (int kk = g; kk < k; kk += groups) {
          tb[kk * chunk + cc] =
              c < n ? round_if(tap_at(taps, taps_bf16, kk * tap_sk + c * tap_sn), bf16) : 0.f;
        }
      }
    }
    fsdr::cp_async_commit();
  };

  for (int i = threadIdx.x; i < tw_staged_len; i += blockDim.x) {
    fsdr::cp_async(s_tw + i, tw_g + i);
  }
  stage(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c = ch * chunk + cc;
    // KT > 0: this chunk's taps of the thread's channel into registers, their
    // loads in flight with the staging where R < 8 (at R = 8 the hoist takes
    // 82 registers against 64, and four blocks no longer fit on a SM)
    constexpr bool kHoist = KT > 0 && R < 8;
    float tp[KT > 0 ? KT : 1];
    if constexpr (kHoist) {
      if (active && c < n) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          tp[kk] = round_if(tap_at(taps, taps_bf16, kk * tap_sk + c * tap_sn), bf16);
        }
      }
    }
    if (ch + 1 < n_chunks) {
      stage(ch + 1);
      fsdr::cp_async_wait<1>();
    } else {
      fsdr::cp_async_wait<0>();
    }
    const float2* buf = s_w + (ch & 1) * span * chunk;
    if (bf16 && active) {                          // what this thread staged
      for (int r = g; r < span; r += groups) {
        float2* d = s_w + (ch & 1) * span * chunk + r * chunk + cc;
        *d = fsdr::bf16_round(*d);
      }
    }
    __syncthreads();
#if defined(FSDR_CUT_STAGE)
    if (k > 0) return;
#endif
#ifdef PFB_CUT_MAC
    if (active && c < n && k < 0) {
#else
    if (active && c < n) {
#endif
      // v[g R + r, c] = sum_kk taps[kk, c] * rows[g R + r + K - 1 - kk, c]: row
      // g R + jj of the window feeds output r through tap kk = r + K - 1 - jj;
      // jj descends, so each output sums its taps in ascending kk (the plain
      // version's order)
      const float2* col = buf + (g * R) * chunk + cc;
      float2 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
      if constexpr (KT > 0) {
        if constexpr (!kHoist) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            tp[kk] = round_if(tap_at(taps, taps_bf16, kk * tap_sk + c * tap_sn), bf16);
          }
        }
#pragma unroll
        for (int jj = R + KT - 2; jj >= 0; --jj) {
          const float2 v = col[jj * chunk];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int kk = r + KT - 1 - jj;
            if (kk >= 0 && kk < KT) fsdr::mac(acc[r], tp[kk], v);
          }
        }
      } else {
        const float* tb = s_taps + (ch & 1) * k * chunk + cc;
        for (int jj = R + k - 2; jj >= 0; --jj) {
          const float2 v = col[jj * chunk];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int kk = r + k - 1 - jj;
            if (kk >= 0 && kk < k) fsdr::mac(acc[r], tb[kk * chunk], v);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s_v[(g * R + r) * pitch + skew(c, psh)] = round_if(acc[r], bf16);
    }
    __syncthreads();                               // before buffer ch & 1 is staged again
  }
#if defined(FSDR_CUT_MAC)
  if (k > 0) return;
#endif

  const float2* tw = tw_staged_len ? s_tw : tw_g;
  if (n_pass > 0) {
    // pass p has radix 2 << ((radix_codes >> 2p) & 3); Ns is the product of
    // the radices before it; its table holds (radix - 1) * Ns entries
    float2* src = s_v;
    float2* dst = s_w;
    int ns = 1, tw_off = 0;
    for (int p = 0; p < n_pass; ++p) {
      const int code = (radix_codes >> (2 * p)) & 3;
      if (p == n_pass - 1) {
#if defined(FSDR_CUT_IDFT)
        idft_pass_radix<false>(code, src, dst, y, s0, t, tr, n, pitch, psh, tw + tw_off, ns);
#else
        idft_pass_radix<true>(code, src, dst, y, s0, t, tr, n, pitch, psh, tw + tw_off, ns);
#endif
      } else {
#if !defined(FSDR_CUT_STORE)
        idft_pass_radix<false>(code, src, dst, y, s0, t, tr, n, pitch, psh, tw + tw_off, ns);
#endif
        __syncthreads();
        float2* tmp = src;
        src = dst;
        dst = tmp;
      }
      const int rx = 2 << code;
      tw_off += (rx - 1) * ns;
      ns *= rx;
    }
  } else {
    // direct IDFT: y[c'] = sum_c v[c] * exp(+2 pi i ((c * c') mod N) / N)
    for (int i = threadIdx.x; i < tr * n; i += blockDim.x) {
      const int row = i / n;
      const int c2 = i - row * n;
      if (s0 + row >= t) break;
      const float2* vr = s_v + row * pitch;
      float ar = 0.f, ai = 0.f;
      int idx = 0;
      for (int c = 0; c < n; ++c) {
        const float2 w = tw[idx];
        const float2 v = vr[skew(c, psh)];
        ar = fmaf(v.x, w.x, fmaf(-v.y, w.y, ar));
        ai = fmaf(v.x, w.y, fmaf(v.y, w.x, ai));
        idx += c2;
        if (idx >= n) idx -= n;
      }
      y[(s0 + row) * n + c2] = make_float2(ar, ai);
    }
  }
}

// The "walk" layout, for PFB-64's shape of plan (one chunk of an even N, K =
// 12 taps in registers, R = 8, two Stockham passes, the last one's
// butterflies within half the block, K - 1 <= tr): the grid's blocks stay
// resident (the plan's `blocks`, 2 an SM) and block b walks the run of
// (lane, tile) pairs from total * b / blocks to total * (b + 1) / blocks in
// order, where total is the lanes times a lane's tiles, so a lane's tiles
// follow one another inside a block. A tile's tr rows of x are one contiguous
// span, brought by one 1-D bulk copy into a ring of kWalkStages = 3 slots,
// two tiles ahead, completing on the slot's mbarrier (one arrive.expect_tx a
// tile for all its bytes); thread 0 issues the copies. A slot is k - 1 halo rows and tr tile rows, in the stream's order (the
// commutator's reversal moves to the read: channel c is column n - 1 - c of
// the staged row). A tile's halo is the previous tile's last k - 1 rows, read
// from the previous slot, so every row of x is staged once; a lane's first
// tile takes hist into its own halo rows, and a run's first tile starting
// inside a lane stages its halo rows with its span in one copy. The
// twiddles are staged once a block.
//
// The schedule: the block's first half runs a tile's last pass (PFB-64: 128
// radix-16 butterflies, where the window layout leaves the other half idle)
// while its second half runs the next tile's MAC, 2R rows of one channel a
// thread, its taps in registers, loaded once a lane; then every thread runs
// the following first pass; two barriers a tile. The slot of tile j - 1 is
// refilled (tile j + 2) once tile j's MAC, the last read of it, is done.
//
// The bits are the window layout's: each output sums its taps in ascending
// kk, bf16 rounds each sample as it is read (the window layout as it is
// staged: the same value), v is rounded where it is, the passes are the same
// code on the same table; only the threads that run them differ.
template <int RM, bool BF16>
__device__ __forceinline__ void walk_mac(const float2* cur, const float2* prev, int top, int w0,
                                         int n, const float (&tp)[kRegTaps], float2* s_v,
                                         int pitch, int psh, int c) {
  float2 acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = make_float2(0.f, 0.f);
  // window row w of the tile (ext row s0 + w): the slot's own row w, or below
  // `top` (a halo row) the previous slot's row tr + w (prev points there)
#pragma unroll
  for (int jj = RM + kRegTaps - 2; jj >= 0; --jj) {
    const int w = w0 + jj;
    float2 v = w < top ? prev[w * n] : cur[w * n];
    if constexpr (BF16) v = fsdr::bf16_round(v);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int kk = r + kRegTaps - 1 - jj;
      if (kk >= 0 && kk < kRegTaps) fsdr::mac(acc[r], tp[kk], v);
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    s_v[(w0 + r) * pitch + skew(c, psh)] = BF16 ? fsdr::bf16_round(acc[r]) : acc[r];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(256, 2)
pfb_walk_kernel(const float2* __restrict__ hist, const float2* __restrict__ x,
                const void* __restrict__ taps, long long tap_sk, long long tap_sn,
                int taps_bf16, const float2* __restrict__ tw_g, float2* __restrict__ y,
                long long t, int n, int groups, unsigned radix_codes, int pitch, int psh,
                int tw_staged_len, int lanes, long long hs, long long xs, long long tls,
                long long ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int k = kRegTaps;
  const int tr = groups * kWalkR;
  const int span = tr + k - 1;                     // rows of a slot
  const long long tiles = (t + tr - 1) / tr;       // a lane's
  const long long total = tiles * lanes;
  const long long q0 = total * blockIdx.x / gridDim.x;
  const long long q1 = total * (blockIdx.x + 1) / gridDim.x;
  auto* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float2* ring = reinterpret_cast<float2*>(smem_raw + kWalkBarBytes);
  float2* s_v = ring + kWalkStages * span * n;
  float2* s_w = s_v + tr * pitch;
  float2* s_tw = s_w + tr * pitch;
  const float2* tw = tw_staged_len ? s_tw : tw_g;
  // the MAC's threads: the block's second half, 2R rows of channel c each
  const int half = blockDim.x / 2;
  const int mt = static_cast<int>(threadIdx.x) - half;
  const int g = mt / n;
  const int c = mt - g * n;
  const bool mac_thread = mt >= 0 && g < groups / 2;
  const int tb = taps_bf16 ? 2 : 4;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWalkStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < tw_staged_len; i += blockDim.x) {
    fsdr::cp_async(s_tw + i, tw_g + i);
  }
  fsdr::cp_async_commit();
  fsdr::cp_async_wait<0>();
  __syncthreads();

  // tile q of the run into its slot (thread 0): its rows of x, and its halo
  // rows where the ring does not hold them (hist at a lane's first tile, x's
  // rows before it at the run's first tile), the bytes counted on the slot's
  // barrier before the copies go out
  auto issue = [&](long long q) {
#ifdef PFB_CUT_COPY
    if (n > 0) return;
#endif
    const long long j = q - q0;
    const long long lane = q / tiles;
    const long long s0 = (q - lane * tiles) * tr;
    const long long rows = t - s0 < tr ? t - s0 : tr;
    float2* slot = ring + (j % kWalkStages) * span * n;
    unsigned long long* bar = bars + j % kWalkStages;
    const float2* xl = x + lane * xs;
    const unsigned row_bytes = 8u * static_cast<unsigned>(n);
    const unsigned halo = static_cast<unsigned>(k - 1) * row_bytes;
    const unsigned body = static_cast<unsigned>(rows) * row_bytes;
    if (s0 == 0) {
      mbar_expect_tx(bar, halo + body);
      bulk_load(slot, hist + lane * hs, halo, bar);
      bulk_load(slot + (k - 1) * n, xl, body, bar);
    } else if (q == q0) {
      mbar_expect_tx(bar, halo + body);
      bulk_load(slot, xl + (s0 - (k - 1)) * n, halo + body, bar);
    } else {
      mbar_expect_tx(bar, body);
      bulk_load(slot + (k - 1) * n, xl + s0 * n, body, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (long long q = q0; q < q1 && q < q0 + kWalkStages - 1; ++q) issue(q);
  }

  // tile q's MAC by this thread (its lane's taps loaded once), after the
  // tile's copy lands
  float tp[kRegTaps];
  long long taps_lane = -1;
  auto mac = [&](long long q) {
    const long long j = q - q0;
    const long long lane = q / tiles;
    const long long s0 = (q - lane * tiles) * tr;
    if (lane != taps_lane) {
      taps_lane = lane;
      const void* tl = static_cast<const char*>(taps) + lane * tls * tb;
#pragma unroll
      for (int kk = 0; kk < kRegTaps; ++kk) {
        tp[kk] = round_if(tap_at(tl, taps_bf16, kk * tap_sk + c * tap_sn), BF16);
      }
    }
#ifdef PFB_CUT_COPY
    if (n < 0)
#endif
    mbar_wait(bars + j % kWalkStages, static_cast<unsigned>((j / kWalkStages) & 1));
#if defined(FSDR_CUT_STAGE)
    if (n > 0) return;
#endif
    const float2* cur = ring + (j % kWalkStages) * span * n + (n - 1 - c);
    const float2* prev =
        ring + ((j + kWalkStages - 1) % kWalkStages) * span * n + tr * n + (n - 1 - c);
    const int top = s0 == 0 || q == q0 ? 0 : k - 1;    // rows below `top` from prev
#ifdef PFB_CUT_MAC
    if (n > 0) return;
#endif
    walk_mac<2 * kWalkR, BF16>(cur, prev, top, g * 2 * kWalkR, n, tp, s_v, pitch, psh, c);
  };

  const int code0 = radix_codes & 3, code1 = (radix_codes >> 2) & 3;
  const int r0 = 2 << code0;
  if (mac_thread && q0 < q1) mac(q0);
  __syncthreads();
  for (long long q = q0; q < q1; ++q) {
    const long long lane = q / tiles;
    const long long s0 = (q - lane * tiles) * tr;
    if (threadIdx.x == 0 && q + kWalkStages - 1 < q1) issue(q + kWalkStages - 1);
#if defined(FSDR_CUT_STAGE) || defined(FSDR_CUT_MAC) || defined(FSDR_CUT_STORE)
    if (n < 0)
#endif
    idft_pass_radix<false>(code0, s_v, s_w, y, s0, t, tr, n, pitch, psh, tw, 1);
    __syncthreads();
#if defined(FSDR_CUT_STAGE) || defined(FSDR_CUT_MAC)
    if (static_cast<int>(threadIdx.x) < half && n < 0) {
#else
    if (static_cast<int>(threadIdx.x) < half) {
#endif
#if defined(FSDR_CUT_IDFT)
      idft_pass_radix<false>(code1, s_w, s_v, y + lane * ys, s0, t, tr, n, pitch, psh,
                             tw + (r0 - 1), r0);
#else
      idft_pass_radix<true>(code1, s_w, s_v, y + lane * ys, s0, t, tr, n, pitch, psh,
                            tw + (r0 - 1), r0);
#endif
    } else if (mac_thread && q + 1 < q1) {
      mac(q + 1);
    }
    __syncthreads();
  }
}

// The "v" layout, for rows of v too wide to stage beside their rows: one row
// a block, the MAC reading rows and taps from device memory through the
// reversed index, v alone in shared memory, bit-reversed for an in-place
// radix-2 transform (log2n >= 0) or in order for the direct DFT.
__global__ void __launch_bounds__(256)
pfb_v_kernel(const float2* __restrict__ hist, const float2* __restrict__ x,
             const void* __restrict__ taps, long long tap_sk, long long tap_sn,
             int taps_bf16, const float2* __restrict__ tw, float2* __restrict__ y, int n,
             int log2n, int k, int bf16, long long hs, long long xs, long long tls,
             long long ys) {
  const long long batch_lane = blockIdx.y;       // the lane form's stream
  hist += batch_lane * hs;
  x += batch_lane * xs;
  y += batch_lane * ys;
  taps = static_cast<const char*>(taps) + batch_lane * tls * (taps_bf16 ? 2 : 4);
  extern __shared__ float2 s_v[];
  const long long hist_len = static_cast<long long>(k - 1) * n;
  const long long e0 = static_cast<long long>(blockIdx.x) * n;   // row s's first ext index

  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float tp = round_if(tap_at(taps, taps_bf16, kk * tap_sk + c * tap_sn), bf16);
      const long long e = e0 + static_cast<long long>(k - 1 - kk) * n + (n - 1 - c);
      const float2 v = round_if(e < hist_len ? hist[e] : x[e - hist_len], bf16);
      ar = fmaf(tp, v.x, ar);
      ai = fmaf(tp, v.y, ai);
    }
    const int dst = log2n > 0 ? static_cast<int>(__brev(c) >> (32 - log2n)) : c;
    s_v[dst] = round_if(make_float2(ar, ai), bf16);
  }
  __syncthreads();

  if (log2n >= 0) {
    // radix-2 DIT over the bit-reversed row; inverse twiddle exp(+i theta)
    const int half_n = n >> 1;
    for (int st = 1; st <= log2n; ++st) {
      const int half = 1 << (st - 1);
      const int shift = log2n - st;                        // twiddle index = pos * N / len
      for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
        const int pos = b & (half - 1);
        const int i = ((b >> (st - 1)) << st) + pos;
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
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[e0 + i] = s_v[i];
  } else {
    for (int c2 = threadIdx.x; c2 < n; c2 += blockDim.x) {
      float ar = 0.f, ai = 0.f;
      int idx = 0;
      for (int c = 0; c < n; ++c) {
        const float2 w = tw[idx];
        const float2 v = s_v[c];
        ar = fmaf(v.x, w.x, fmaf(-v.y, w.y, ar));
        ai = fmaf(v.x, w.y, fmaf(v.y, w.x, ai));
        idx += c2;
        if (idx >= n) idx -= n;
      }
      y[e0 + c2] = make_float2(ar, ai);
    }
  }
}

// The lanes and their strides in elements (one stream: 1 lane, strides 0):
// hist, x, the taps (0: one prototype for every lane) and y.
struct Lanes {
  int lanes;
  long long hs, xs, tls, ys;
};

template <int KT, int R>
cudaError_t launch_window(const void* hist, const void* x, const void* taps, long long tap_sk,
                          long long tap_sn, int taps_bf16, const void* tw, void* y,
                          long long t, int n, int k, int threads, int chunk, int groups,
                          int n_pass, unsigned codes, int pitch, int psh, int w_len,
                          int tw_staged_len, int bf16, size_t smem, const Lanes& ln,
                          cudaStream_t stream) {
  auto kern = pfb_window_kernel<KT, R>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tr = static_cast<long long>(groups) * R;
  const dim3 grid(static_cast<unsigned>((t + tr - 1) / tr), static_cast<unsigned>(ln.lanes));
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const float2*>(hist), static_cast<const float2*>(x), taps, tap_sk, tap_sn,
      taps_bf16, static_cast<const float2*>(tw), static_cast<float2*>(y), t, n, k, chunk,
      groups, n_pass, codes, pitch, psh, w_len, tw_staged_len, bf16, ln.hs, ln.xs, ln.tls,
      ln.ys);
  return cudaGetLastError();
}

template <int KT>
cudaError_t dispatch_outs(int outs, const void* hist, const void* x, const void* taps,
                          long long tap_sk, long long tap_sn, int taps_bf16, const void* tw,
                          void* y, long long t, int n, int k, int threads, int chunk,
                          int groups, int n_pass, unsigned codes, int pitch, int psh,
                          int w_len, int tw_staged_len, int bf16, size_t smem,
                          const Lanes& ln, cudaStream_t s) {
  switch (outs) {
    case 8:
      return launch_window<KT, 8>(hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, k,
                                  threads, chunk, groups, n_pass, codes, pitch, psh, w_len,
                                  tw_staged_len, bf16, smem, ln, s);
    case 4:
      return launch_window<KT, 4>(hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, k,
                                  threads, chunk, groups, n_pass, codes, pitch, psh, w_len,
                                  tw_staged_len, bf16, smem, ln, s);
    default:
      return launch_window<KT, 1>(hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, k,
                                  threads, chunk, groups, n_pass, codes, pitch, psh, w_len,
                                  tw_staged_len, bf16, smem, ln, s);
  }
}

template <bool BF16>
cudaError_t launch_walk(const void* hist, const void* x, const void* taps, long long tap_sk,
                        long long tap_sn, int taps_bf16, const void* tw, void* y, long long t,
                        int n, int groups, unsigned codes, int pitch, int psh,
                        int tw_staged_len, int blocks, size_t smem, const Lanes& ln,
                        cudaStream_t stream) {
  auto kern = pfb_walk_kernel<BF16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tr = static_cast<long long>(groups) * kWalkR;
  const long long total = (t + tr - 1) / tr * ln.lanes;
  const unsigned grid = static_cast<unsigned>(total < blocks ? total : blocks);
  kern<<<grid, 256, smem, stream>>>(
      static_cast<const float2*>(hist), static_cast<const float2*>(x), taps, tap_sk, tap_sn,
      taps_bf16, static_cast<const float2*>(tw), static_cast<float2*>(y), t, n, groups, codes,
      pitch, psh, tw_staged_len, ln.lanes, ln.hs, ln.xs, ln.tls, ln.ys);
  return cudaGetLastError();
}

// The plan's checks and the launch, for one stream or for the lanes.
int run(const void* hist, const void* x, const void* taps, long long tap_sk, long long tap_sn,
        const void* tw, void* y, long long t, int n, int k, int modes, const int* plan,
        long long smem, const Lanes& ln, void* stream) {
  if (t <= 0 || ln.lanes == 0) return 0;
  const int window = plan[0], threads = plan[1], chunk = plan[2], groups = plan[3],
            outs = plan[4], k_regs = plan[5], pitch = plan[6], psh = plan[7],
            tw_staged = plan[8], tw_len = plan[9], n_pass = plan[10], blocks = plan[11];
  const int* radices = plan + 12;
  const int taps_bf16 = modes & 1, bf16 = (modes >> 1) & 1;
  if (n < 1 || k < 1 || ln.lanes < 0 || ln.lanes > 65535 ||
      (ln.lanes > 1 && ln.ys < t * n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pow2 = (n & (n - 1)) == 0;
  if (!window) {
    if (tw_len != n || smem != 8LL * n || t > 2147483647LL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int log2n = pow2 ? fsdr::log2c(n) : -1;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          pfb_v_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const dim3 grid(static_cast<unsigned>(t), static_cast<unsigned>(ln.lanes));
    pfb_v_kernel<<<grid, 256, static_cast<size_t>(smem), s>>>(
        static_cast<const float2*>(hist), static_cast<const float2*>(x), taps, tap_sk,
        tap_sn, taps_bf16, static_cast<const float2*>(tw), static_cast<float2*>(y), n, log2n,
        k, bf16, ln.hs, ln.xs, ln.tls, ln.ys);
    return cudaGetLastError();
  }
  if (threads < 1 || threads > kMaxThreads || chunk < 1 || groups < 1 ||
      chunk * groups > threads || (outs != 1 && outs != 4 && outs != 8) ||
      (k_regs != 0 && (k_regs != kRegTaps || k != kRegTaps)) || n_pass < 0 ||
      n_pass > kMaxPasses || psh < 0 || psh > 31 || pitch < skew(n - 1, psh) + 1) {
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
  const int tr = groups * outs;
  const int staged = tw_staged ? tw_len : 0;
  if (blocks) {
    // the walk: one chunk of an even n, 256 threads, R = 8, K = 12 taps in
    // registers, its halo inside one tile, two passes whose last one's
    // butterflies fit half the block, every lane's rows of hist and x 16-byte
    // aligned
    const auto* h8 = static_cast<const char*>(hist);
    const auto* x8 = static_cast<const char*>(x);
    if (blocks < 0 || chunk != n || threads != 256 || n % 2 || outs != kWalkR || !k_regs ||
        k - 1 > tr || n_pass != 2 || groups % 2 || tr * (n / radices[1]) > threads / 2 ||
        reinterpret_cast<uintptr_t>(x8) % 16 || reinterpret_cast<uintptr_t>(h8) % 16 ||
        (ln.lanes > 1 && (ln.xs % 2 || ln.hs % 2))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long want = walk_smem(n, k, tr, pitch, staged);
    if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16) {
      return launch_walk<true>(hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, groups,
                               codes, pitch, psh, staged, blocks,
                               static_cast<size_t>(want), ln, s);
    }
    return launch_walk<false>(hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, groups,
                              codes, pitch, psh, staged, blocks,
                              static_cast<size_t>(want), ln, s);
  }
  const long long want = window_smem(n, k, tr, chunk, pitch, n_pass, staged, k_regs);
  if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
  const int w_len = static_cast<int>(w_slots(n, k, tr, chunk, pitch, n_pass));
  if (k_regs) {
    return dispatch_outs<kRegTaps>(outs, hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t,
                                   n, k, threads, chunk, groups, n_pass, codes, pitch, psh,
                                   w_len, staged, bf16, static_cast<size_t>(want), ln, s);
  }
  return dispatch_outs<0>(outs, hist, x, taps, tap_sk, tap_sn, taps_bf16, tw, y, t, n, k,
                          threads, chunk, groups, n_pass, codes, pitch, psh, w_len, staged,
                          bf16, static_cast<size_t>(want), ln, s);
}

}  // namespace

// hist: the (k - 1) * n samples before x (unread when k == 1); x: t * n
// complex64 samples; taps: [k, n] float32 or bfloat16 (modes & 1), element
// (kk, c) at taps + kk * tap_sk + c * tap_sn; bf16 mode: modes & 2; tw: the
// plan's twiddle table of (cos, sin) pairs; y: [t, n] complex64. The plan
// (cuda_kernels.pfb_plan) as ints: window (1) or the v layout (0); the
// threads per block, the channels staged a step (chunk), the row groups, the
// rows a thread (outs: 1, 4 or 8), the taps in registers (k_regs = k = 12) or
// in shared memory (0), the float2 pitch of a v row and its pad shift,
// whether the table is staged, the table's length, n_pass Stockham passes,
// the walk's resident blocks (0: a block a tile), then the passes'
// radices (2, 4, 8 or 16; 0 passes: the direct DFT); and its shared memory,
// which must equal the layout's. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int fsdr_pfb(const void* hist, const void* x, const void* taps,
                        long long tap_sk, long long tap_sn, const void* tw, void* y,
                        long long t, int n, int k, int modes, const int* plan,
                        long long smem, void* stream) {
  return run(hist, x, taps, tap_sk, tap_sn, tw, y, t, n, k, modes, plan, smem,
             Lanes{1, 0, 0, 0, 0}, stream);
}

// The lane form: `lanes` (at most 65,535) streams, lane l's history at hist +
// l * hs, its frame at x + l * xs, its taps at taps + l * tls (tls = 0: one
// prototype for every lane; within a lane the strides tap_sk and tap_sn, as
// fsdr_pfb) and its [t, n] outputs at y + l * ys (strides in elements; the
// output rows must not overlap). The plan is the one-stream plan's layout and
// radices with R and the tile chosen for the batch (cuda_kernels.
// pfb_lanes_plan), held to the same checks. Returns as fsdr_pfb.
extern "C" int fsdr_pfb_lanes(const void* hist, const void* x, const void* taps,
                              long long tap_sk, long long tap_sn, const void* tw, void* y,
                              long long t, int n, int k, int modes, const int* plan,
                              long long smem, int lanes, long long hs, long long xs,
                              long long tls, long long ys, void* stream) {
  return run(hist, x, taps, tap_sk, tap_sn, tw, y, t, n, k, modes, plan, smem,
             Lanes{lanes, hs, xs, tls, ys}, stream);
}
