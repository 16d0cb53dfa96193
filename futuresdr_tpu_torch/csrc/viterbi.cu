// Batched add-compare-select of a 64-state Viterbi trellis: the recursion of the
// WLAN receiver's soft decoder, one frame a warp.
//
// Replaces no Pallas kernel: it replaces the lax.scan of
// futuresdr_tpu/ops/viterbi.py:31-81 (_compiled / _compiled_batch), the ACS
// recursion that decode_stream_batch runs over every frame of a window. A loop
// of PyTorch ops would launch about four kernels a trellis step (16,000 for a
// 4,096-step bucket), so the scan becomes one kernel.
//
// What it computes, for frame b and step t (the JAX scan's arithmetic):
//   cand[s, j] = m[prev_s[s, j]] + bm0[s, j] * lam[b, t, 0] + bm1[s, j] * lam[b, t, 1]
// summed left to right in float32, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA), then
//   pick = cand[s, 1] > cand[s, 0]   (ties go to candidate 0, as jnp.argmax)
//   m[s] = cand[s, pick],  picks[t, b, s] = pick (one byte).
// Metrics start at -1e18 with state 0 at 0. The traceback stays on the host.
//
// Bound on an H100: not bytes. The steps are sequential, so the floor is T
// times one step's dependent latency (the predecessor metrics' shuffles, two
// adds, a compare and a select), whatever the batch. The bytes (8 in and 64
// out a frame a step) and operations (about 576 a frame a step) of a 256-frame,
// 4,096-step batch take 22.5 us and 9 us at the card's peaks.
//
// Design: a warp holds a frame's 64 metrics in registers, two a lane (state
// `lane` and state `lane + 32`); a predecessor's metric comes from its lane by
// __shfl_sync, so a step needs no shared memory and no barrier. Each lane keeps
// its states' four predecessors and branch weights in registers, read once from
// the tables (any 64-state table, not only 802.11's butterfly). The LLRs are
// read 32 steps at a time, one float2 a lane, coalesced, the next 32 loaded
// while the current ones are used, and handed to the steps by shuffles. Each
// step writes the frame's 64 pick bytes as one contiguous row. kWarps frames
// share a block; frames never wait for one another.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kStates = 64;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
viterbi_acs_kernel(const float2* __restrict__ lams, const int* __restrict__ prev_s,
                   const float* __restrict__ bm0, const float* __restrict__ bm1,
                   uint8_t* __restrict__ picks, int n_frames, long long n_steps) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_frames) return;              // warp-uniform: the whole warp leaves

  int src[2][2];
  bool high[2][2];
  float w0[2][2], w1[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = (lane + 32 * k) * 2 + j;
      const int p = prev_s[e];
      src[k][j] = p & 31;
      high[k][j] = p >= 32;
      w0[k][j] = bm0[e];
      w1[k][j] = bm1[e];
    }
  }
  float m_lo = lane == 0 ? 0.0f : -1e18f;   // state lane
  float m_hi = -1e18f;                      // state lane + 32

  const float2* lam = lams + static_cast<long long>(b) * n_steps;
  uint8_t* row = picks + static_cast<long long>(b) * kStates;
  const long long stride = static_cast<long long>(n_frames) * kStates;
  float2 cur = lane < n_steps ? lam[lane] : make_float2(0.0f, 0.0f);

  for (long long t0 = 0; t0 < n_steps; t0 += 32) {
    const long long ahead = t0 + 32 + lane;
    const float2 next = ahead < n_steps ? lam[ahead] : make_float2(0.0f, 0.0f);
    const int n = n_steps - t0 < 32 ? static_cast<int>(n_steps - t0) : 32;
    for (int i = 0; i < n; ++i) {
      const float l0 = __shfl_sync(kFull, cur.x, i);
      const float l1 = __shfl_sync(kFull, cur.y, i);
      float c[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float lo = __shfl_sync(kFull, m_lo, src[k][j]);
          const float hi = __shfl_sync(kFull, m_hi, src[k][j]);
          const float m = high[k][j] ? hi : lo;
          c[k][j] = __fadd_rn(__fadd_rn(m, __fmul_rn(w0[k][j], l0)),
                              __fmul_rn(w1[k][j], l1));
        }
      }
      const bool p_lo = c[0][1] > c[0][0];
      const bool p_hi = c[1][1] > c[1][0];
      m_lo = p_lo ? c[0][1] : c[0][0];
      m_hi = p_hi ? c[1][1] : c[1][0];
      uint8_t* out = row + (t0 + i) * stride;
      out[lane] = static_cast<uint8_t>(p_lo);
      out[lane + 32] = static_cast<uint8_t>(p_hi);
    }
    cur = next;
  }
}

}  // namespace

// lams: [n_frames, n_steps, 2] float32; prev_s: [64, 2] int32 (each < 64);
// bm0, bm1: [64, 2] float32; picks: [n_steps, n_frames, 64] uint8.
// Returns cudaGetLastError() after the launch.
extern "C" int fsdr_viterbi_acs(const void* lams, const void* prev_s, const void* bm0,
                                const void* bm1, void* picks, int n_frames,
                                long long n_steps, void* stream) {
  if (n_frames <= 0 || n_steps <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_frames + kWarps - 1) / kWarps);
  viterbi_acs_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(lams), static_cast<const int*>(prev_s),
      static_cast<const float*>(bm0), static_cast<const float*>(bm1),
      static_cast<uint8_t*>(picks), n_frames, n_steps);
  return cudaGetLastError();
}
