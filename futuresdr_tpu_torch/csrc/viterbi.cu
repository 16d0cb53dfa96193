// Batched Viterbi decoding of a rate-1/2 trellis of 2 to 64 states: the
// add-compare-select recursion, the survivors packed one bit a state, and the
// traceback to decoded bits, in one launch.
//
// Replaces no Pallas kernel: it replaces the lax.scan of
// futuresdr_tpu/ops/viterbi.py:31-81 (_compiled / _compiled_batch, the ACS
// recursion) and that module's host traceback (:105-116, :136-143), which
// scan_viterbi_batch runs over every frame of a WLAN window and M17's
// viterbi_decode_m17 over each frame of 512 steps or more.
//
// What it computes, for frame b and step t < steps[b] (the JAX scan's arithmetic):
//   cand[s, k] = (m[prev_s[s, k]] + bm0[s, k] * lam[b, t, 0]) + bm1[s, k] * lam[b, t, 1]
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, never an
// FMA; the four branch sums +-l0 +-l1 are never formed first, which would
// round as m + (a + b)), then
//   pick = cand[s, 1] > cand[s, 0]   (ties go to candidate 0, as jnp.argmax)
//   m[s] = cand[s, pick]
// from metrics of -1e18 with state 0 at 0. Survivor word (b, t, w) holds the
// picks of states 32w .. 32w + 31, bit s % 32 for state s. The traceback starts
// at state 0 at steps[b] - 1 and walks down: bit[b, t] = prev_b[s, pick],
// s = prev_s[s, pick]. bits[b, t] is 0 for t >= steps[b]. A frame runs to its
// own length; frames past the batch get no warp.
//
// Bound on an H100. Roofline: the LLRs in (8 B a frame a step), the tables and
// the decoded bits out (1 B a frame a step) against 9 operations a state a step
// (two products, two sums for each of two candidates, the compare): 256 frames
// x 4,096 steps is 9.0 us of float32 operations and 2.8 us of bytes. The real
// floor is sequential: T dependent steps a frame, each one shuffle, two adds
// and a max long, then T dependent traceback steps; the frames run side by
// side, a warp each, so the batch takes about one frame's time. What the design
// does about it:
//   - Off the step chain: the LLRs come from shared memory a step ahead (one
//     broadcast 8-byte read a step, no shuffle; each 32-step chunk is copied
//     in by cp.async, coalesced, into a second buffer while the previous one
//     runs, never through a register); the picks become two ballots a
//     step, which lane i keeps for step i of the chunk, and the warp stores 32
//     steps of words at once, coalesced (8 B a step a frame at 64 states, not
//     64); the pick compares are not on the chain either: the new metric is
//     the max of the two candidates (equal candidates give the same value).
//   - Fewer shuffles: for trellises with the shift-register butterfly (the
//     predecessors of states t and t + S/2 are 2(t mod S/2) and 2(t mod S/2)+1,
//     the input bit is the state's top bit: 802.11's K = 7 and M17's K = 5
//     codes), lane j holds states j and j + S/2, which share one predecessor
//     pair. Even lanes keep state j in register x and odd lanes state j + S/2,
//     so round one reads x from lane 2j (2j + 1 - S/2 in the upper half) and
//     round two reads y from lane 2j + 1 (2j - S/2): two shuffles a step,
//     where the first design took eight for metrics and two for the LLRs.
//     The kernel checks the tables for the butterfly itself, so every entry
//     point takes that route without a copy of the tables to the host. Any
//     other table takes the generic route: the same lanes and layout, each
//     candidate's metric by two shuffles and a select (eight a step).
//   - Small trellises share a warp: a frame takes S/2 lanes (rounded up to a
//     power of two), shuffles run at that width, so 16 states put 4 frames in
//     a warp and no lane idles.
//   - The traceback runs in the warp that ran the frame, while its survivors
//     (16.8 MB at 256 x 8,192) are still in the 50 MB L2: 32 steps of words
//     are loaded at once, one chunk ahead, and walked by shuffles whose index
//     is a constant, so no step waits on a load; on the butterfly route a
//     step is a shift, a mask and an or. The decoded bits go home, not the
//     picks.
// Four warps share a block (two at one lane a frame); frames never wait for
// one another.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// warps a block: 4, or 2 at one lane a frame, whose 32 frames a warp double
// the LLR buffers (shared memory stays under the 48 KB of a static array)
__host__ __device__ constexpr int warps_for(int half) { return half == 1 ? 2 : 4; }
constexpr unsigned kFull = 0xffffffffu;
constexpr float kStart = -1e18f;          // the reference's metric of every state but 0

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

__device__ __forceinline__ float cand(float m, float w0, float l0, float w1, float l1) {
  return __fadd_rn(__fadd_rn(m, __fmul_rn(w0, l0)), __fmul_rn(w1, l1));
}

// The butterfly route: lane j of a frame's HALF lanes holds next states j and
// j + HALF. Register x is state j on even lanes and j + HALF on odd ones, y
// the other. Round one delivers candidate 0 to the lower half of the lanes
// and candidate 1 to the upper half (A), round two the other (B).
template <int HALF>
struct Butterfly {
  float x, y;
  int src1, src2;
  bool upper, odd;
  float a0[2], a1[2], b0[2], b1[2];      // [0]: x's state, [1]: y's

  __device__ void init(int j, const float2* bm0, const float2* bm1) {
    upper = HALF > 1 && j >= HALF / 2;
    odd = j & 1;
    src1 = upper ? 2 * j + 1 - HALF : 2 * j;
    src2 = upper ? 2 * j - HALF : 2 * j + 1;
    const int n[2] = {odd ? j + HALF : j, odd ? j : j + HALF};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float2 u = bm0[n[o]], v = bm1[n[o]];
      a0[o] = upper ? u.y : u.x;
      a1[o] = upper ? v.y : v.x;
      b0[o] = upper ? u.x : u.y;
      b1[o] = upper ? v.x : v.y;
    }
    x = j == 0 ? 0.0f : kStart;           // lane 0 is even: x is state 0
    y = kStart;
  }

  __device__ __forceinline__ void step(float l0, float l1, bool& p_lo, bool& p_hi) {
    const float ra = __shfl_sync(kFull, x, src1, HALF);
    const float rb = __shfl_sync(kFull, y, src2, HALF);
    float ca[2], cb[2];
    bool p[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      ca[o] = cand(ra, a0[o], l0, a1[o], l1);
      cb[o] = cand(rb, b0[o], l0, b1[o], l1);
      p[o] = upper ? ca[o] > cb[o] : cb[o] > ca[o];   // candidate 1 beats 0
    }
    x = fmaxf(ca[0], cb[0]);
    y = fmaxf(ca[1], cb[1]);
    p_lo = odd ? p[1] : p[0];             // state j
    p_hi = odd ? p[0] : p[1];             // state j + HALF
  }
};

// The generic route: lane j holds states j (m[0]) and j + HALF (m[1]); a
// candidate's metric comes from its predecessor's lane by two shuffles (both
// slots) and a select. States past S keep their metric and pick 0.
template <int HALF>
struct Generic {
  float m[2];
  int src[2][2];
  bool hi[2][2];
  float w0[2][2], w1[2][2];

  __device__ void init(int j, int n_states, const int2* prev_s, const float2* bm0,
                       const float2* bm1) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int n = j + o * HALF;
      const bool real = n < n_states;
      const int2 p = real ? prev_s[n] : make_int2(n, n);
      const float2 u = real ? bm0[n] : make_float2(0.0f, 0.0f);
      const float2 v = real ? bm1[n] : make_float2(0.0f, 0.0f);
      src[o][0] = p.x & (HALF - 1);
      src[o][1] = p.y & (HALF - 1);
      hi[o][0] = p.x >= HALF;
      hi[o][1] = p.y >= HALF;
      w0[o][0] = u.x;
      w0[o][1] = u.y;
      w1[o][0] = v.x;
      w1[o][1] = v.y;
    }
    m[0] = j == 0 ? 0.0f : kStart;
    m[1] = kStart;
  }

  __device__ __forceinline__ void step(float l0, float l1, bool& p_lo, bool& p_hi) {
    float c[2][2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float lo = __shfl_sync(kFull, m[0], src[o][k], HALF);
        const float up = __shfl_sync(kFull, m[1], src[o][k], HALF);
        c[o][k] = cand(hi[o][k] ? up : lo, w0[o][k], l0, w1[o][k], l1);
      }
    }
    p_lo = c[0][1] > c[0][0];
    p_hi = c[1][1] > c[1][0];
    m[0] = p_lo ? c[0][1] : c[0][0];
    m[1] = p_hi ? c[1][1] : c[1][0];
  }
};

// lams[i] to shared memory without a register (cp.async), or zeros where
// `real` is false (then nothing is read).
__device__ __forceinline__ void stage(float2* dst, const float2* lams, long long i, bool real) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(d), "l"(real ? lams + i : lams), "r"(real ? 8 : 0) : "memory");
}

// The recursion over the warp's G frames, 32 steps a chunk. buf: the warp's
// two [G][33] LLR buffers; chunk c reads buf[c & 1] while the next chunk's
// LLRs are staged into the other one. n_of[g]: frame b0 + g's steps (0 for a
// frame past the batch).
template <int HALF, class Step>
__device__ __forceinline__ void acs_frames(Step& st, float2 (*buf)[32 / HALF][33],
                                           const float2* __restrict__ lams, uint32_t* surv,
                                           const int (&n_of)[32 / HALF], long long b0,
                                           long long T, int n_warp, int lane) {
  constexpr int G = 32 / HALF;
  const int seg = lane / HALF;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    stage(&buf[0][g][lane], lams, (b0 + g) * T + lane, lane < n_of[g]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  for (long long t0 = 0; t0 < n_warp; t0 += 32) {
    const int cur = static_cast<int>(t0 >> 5) & 1;
    const long long ahead = t0 + 32 + lane;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      stage(&buf[cur ^ 1][g][lane], lams, (b0 + g) * T + ahead, ahead < n_of[g]);
    }
    const float2* row = buf[cur][seg];
    uint32_t r_lo = 0, r_hi = 0;
    float2 l = row[0];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 next = row[i < 31 ? i + 1 : 31];  // a step ahead, off the chain
      bool p_lo, p_hi;
      st.step(l.x, l.y, p_lo, p_hi);
      l = next;
      const uint32_t lo = __ballot_sync(kFull, p_lo);
      const uint32_t hi = __ballot_sync(kFull, p_hi);
      if (lane == i) {
        r_lo = lo;
        r_hi = hi;
      }
    }
    const long long t = t0 + lane;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (t < n_of[g]) {
        if constexpr (HALF == 32) {
          reinterpret_cast<uint2*>(surv)[(b0 + g) * T + t] = make_uint2(r_lo, r_hi);
        } else {
          constexpr uint32_t kMask = (1u << HALF) - 1u;
          surv[(b0 + g) * T + t] = ((r_lo >> (g * HALF)) & kMask)
                                   | (((r_hi >> (g * HALF)) & kMask) << HALF);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }
}

// The traceback of the segment's own frame b (n steps): lane j holds the
// words of steps t_hi - (k * HALF + j), k < 32 / HALF, of the 32-step chunk
// ending at t_hi, and the next chunk's are loaded while this one is walked.
// tb[s]: prev_s[s, 0] | prev_s[s, 1] << 8 | prev_b[s, 0] << 16 | prev_b[s, 1] << 24.
template <int HALF, bool BUTTERFLY>
__device__ __forceinline__ void traceback(const uint32_t* surv, uint8_t* bits,
                                          const uint32_t* tb, long long b, int n,
                                          long long T, int n_warp, int lane) {
  constexpr int R = 32 / HALF;
  constexpr bool kTwo = HALF == 32;       // two words a step (more than 32 states)
  const int j = lane % HALF;
  uint32_t cur_lo[R], cur_hi[R], nxt_lo[R], nxt_hi[R];
  auto load = [&](int c, uint32_t (&lo)[R], uint32_t (&hi)[R]) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long t = static_cast<long long>(n) - 1 - 32LL * c - (k * HALF + j);
      if constexpr (kTwo) {
        const uint2 w = t >= 0 ? reinterpret_cast<const uint2*>(surv)[b * T + t]
                               : make_uint2(0u, 0u);
        lo[k] = w.x;
        hi[k] = w.y;
      } else {
        lo[k] = t >= 0 ? surv[b * T + t] : 0u;
        hi[k] = 0u;
      }
    }
  };
  load(0, cur_lo, cur_hi);
  uint32_t s = 0;
  for (int c = 0; 32 * c < n_warp; ++c) {
    load(c + 1, nxt_lo, nxt_hi);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t w_lo = __shfl_sync(kFull, cur_lo[i / HALF], i % HALF, HALF);
      uint32_t p;
      if constexpr (kTwo) {
        const uint32_t w_hi = __shfl_sync(kFull, cur_hi[i / HALF], i % HALF, HALF);
        p = (((s & 32u) ? w_hi : w_lo) >> (s & 31u)) & 1u;
      } else {
        p = (w_lo >> s) & 1u;
      }
      if constexpr (BUTTERFLY) {
        acc |= (s >> log2i(HALF)) << i;             // the input bit: the top bit
        s = ((s << 1) & (2u * HALF - 1u)) | p;
      } else {
        const uint32_t v = tb[s];
        acc |= ((v >> (16u + 8u * p)) & 1u) << i;
        s = (v >> (8u * p)) & 63u;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = k * HALF + j;
      const long long t = static_cast<long long>(n) - 1 - 32LL * c - i;
      if (t >= 0) bits[b * T + t] = static_cast<uint8_t>((acc >> i) & 1u);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      cur_lo[k] = nxt_lo[k];
      cur_hi[k] = nxt_hi[k];
    }
  }
  for (long long t = n + j; t < T; t += HALF) bits[b * T + t] = 0;
}

template <int HALF>
__global__ void __launch_bounds__(warps_for(HALF) * 32)
viterbi_kernel(const float2* __restrict__ lams, const int* __restrict__ steps,
               const int2* __restrict__ prev_s, const int2* __restrict__ prev_b,
               const float2* __restrict__ bm0, const float2* __restrict__ bm1,
               uint32_t* surv, uint8_t* bits, int n_frames, long long T, int n_states) {
  constexpr int G = 32 / HALF;
  constexpr int kWarps = warps_for(HALF);
  __shared__ float2 lam_s[kWarps][2][G][33];  // a row of 33: the G rows on distinct banks
  __shared__ uint32_t tb[64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (bits != nullptr && threadIdx.x < n_states) {
    const int2 p = prev_s[threadIdx.x], q = prev_b[threadIdx.x];
    tb[threadIdx.x] = static_cast<uint32_t>((p.x & 63) | (p.y & 63) << 8 | (q.x & 1) << 16
                                            | (q.y & 1) << 24);
  }
  __syncthreads();
  const long long b0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * G;
  if (b0 >= n_frames) return;               // warp-uniform: the whole warp leaves

  int n_of[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long b = b0 + g;
    const int n = b < n_frames ? steps[b] : 0;
    n_of[g] = n < 0 ? 0 : (n > T ? static_cast<int>(T) : n);
  }
  const int j = lane % HALF;
  const long long b = b0 + lane / HALF;
  int n = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) n = lane / HALF == g ? n_of[g] : n;
  const int n_warp = __reduce_max_sync(kFull, n);

  // the butterfly, checked on the tables themselves (every warp alike)
  bool fly = n_states == 2 * HALF, fly_b = fly;
  for (int s = lane; s < n_states; s += 32) {
    const int2 p = prev_s[s];
    fly = fly && p.x == 2 * (s & (HALF - 1)) && p.y == p.x + 1;
    if (bits != nullptr) {
      const int2 q = prev_b[s];
      const int top = s >= HALF;
      fly_b = fly_b && q.x == top && q.y == top;
    }
  }
  fly = __all_sync(kFull, fly);
  fly_b = fly && __all_sync(kFull, fly_b);

  float2 (*buf)[G][33] = lam_s[warp];
  if (fly) {
    Butterfly<HALF> st;
    st.init(j, bm0, bm1);
    acs_frames<HALF>(st, buf, lams, surv, n_of, b0, T, n_warp, lane);
  } else {
    Generic<HALF> st;
    st.init(j, n_states, prev_s, bm0, bm1);
    acs_frames<HALF>(st, buf, lams, surv, n_of, b0, T, n_warp, lane);
  }
  if (bits == nullptr) return;
  __syncwarp();                             // the warp's survivor stores, seen by its loads
  if (b >= n_frames) n = 0;                 // a segment past the batch: no reads, no writes
  if (fly_b) {
    traceback<HALF, true>(surv, bits, tb, b < n_frames ? b : 0, n, b < n_frames ? T : 0,
                          n_warp, lane);
  } else {
    traceback<HALF, false>(surv, bits, tb, b < n_frames ? b : 0, n, b < n_frames ? T : 0,
                           n_warp, lane);
  }
}

template <int HALF>
int launch(const void* lams, const void* steps, const void* prev_s, const void* prev_b,
           const void* bm0, const void* bm1, void* surv, void* bits, int n_frames,
           long long n_steps, int n_states, cudaStream_t stream) {
  constexpr int G = 32 / HALF;
  constexpr int kWarps = warps_for(HALF);
  const long long warps = (n_frames + G - 1) / G;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  viterbi_kernel<HALF><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float2*>(lams), static_cast<const int*>(steps),
      static_cast<const int2*>(prev_s), static_cast<const int2*>(prev_b),
      static_cast<const float2*>(bm0), static_cast<const float2*>(bm1),
      static_cast<uint32_t*>(surv), static_cast<uint8_t*>(bits), n_frames, n_steps,
      n_states);
  return cudaGetLastError();
}

}  // namespace

// lams: [n_frames, n_steps, 2] float32; steps: [n_frames] int32 (clamped to
// [0, n_steps]); prev_s, prev_b: [n_states, 2] int32 (prev_s in [0, n_states),
// prev_b bits; prev_b may be null when bits is); bm0, bm1: [n_states, 2]
// float32; surv: [n_frames, n_steps, n_states > 32 ? 2 : 1] uint32, written for
// t < steps[b]; bits: [n_frames, n_steps] uint8, or null for the survivors
// alone. 2 <= n_states <= 64. Returns cudaGetLastError() after the launch.
extern "C" int fsdr_viterbi(const void* lams, const void* steps, const void* prev_s,
                            const void* prev_b, const void* bm0, const void* bm1, void* surv,
                            void* bits, int n_frames, long long n_steps, int n_states,
                            void* stream) {
  if (n_states < 2 || n_states > 64 || (bits != nullptr && prev_b == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n_frames <= 0 || n_steps <= 0) return 0;
  int half = 1;
  while (2 * half < n_states) half *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (half) {
    case 1: return launch<1>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                             n_steps, n_states, s);
    case 2: return launch<2>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                             n_steps, n_states, s);
    case 4: return launch<4>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                             n_steps, n_states, s);
    case 8: return launch<8>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                             n_steps, n_states, s);
    case 16: return launch<16>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                               n_steps, n_states, s);
    default: return launch<32>(lams, steps, prev_s, prev_b, bm0, bm1, surv, bits, n_frames,
                               n_steps, n_states, s);
  }
}
