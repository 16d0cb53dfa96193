// Streaming causal FIR with real taps: y[i] = sum_k taps[k] * x[i - k].
//
// Replaces the TPU kernel futuresdr_tpu/ops/pallas_kernels.py::_fir_kernel
// (wrappers pallas_fir / pallas_fir_continue).
//
// Bound on an H100: memory, with the FP32 FMAs close behind. A complex64
// stream moves 16 bytes per sample (8 in, 8 out) against 4 * n_taps FLOP per
// sample, i.e. 256 FLOP at 64 taps: 4 MB and 67 MFLOP per 2^18-sample frame,
// about 1.25 us at 3.35 TB/s against about 1 us at 67 TFLOP/s FP32.
//
// Design: the stream is cut into tiles of 256 outputs, one a warp at a time,
// and each warp runs on its own: it stages its tile's span (plus the
// n_taps - 1 samples before it, from the separate `hist` pointer or zero
// before the frame, so a streaming continuation needs no concatenation in
// device memory) into its own region of shared memory with cp.async, every
// copy of a lane in flight at once, waits for its own copies only
// (cp.async.wait_group, __syncwarp), and runs the MAC: each lane computes
// R = 8 consecutive outputs on a sliding register window over the staged
// span (fsdr::window_mac, the fir_fft MAC): a step loads one new sample and
// one tap (a broadcast) for R FMAs (FMA pairs on a complex stream), where the
// first design loaded one staged sample per FMA. Where a frame has more tiles
// than 16 warps a SM (2^20 and up), each warp walks several tiles with two
// span buffers, staging the next while the MAC runs on this one: with one
// tile a block, every block of a frame loaded, computed and stored in lock
// step. The block (up to 8 warps, cuda_kernels.fir_plan) shares the taps,
// staged once behind one barrier. Each span has one pad slot every R
// samples, so the windows of a warp, R samples apart, fall on distinct banks,
// and starts at a shift that puts every window's top sample last in its group
// of R, so the R loads of a chunk of MAC steps sit at constant offsets from
// one address (no index arithmetic per step).
// A complex stream is read as float2 and filtered in ONE pass with the real
// taps; the TPU kernel's two real passes were only its lane layout. Each lane
// stores its R outputs as 16-byte vectors. Where the padded spans do not fit
// in shared memory, the plan takes fewer warps a block, one buffer, and at
// last one unpadded warp, which needs less than the first design's
// 1,024-output tile.
//
// bf16 mode (precision="bf16"): samples and taps are rounded to bf16 when they
// are staged; products of two bf16 values are exact in FP32 and accumulate in
// FP32, as the reference's bf16 mode computes them.
//
// Lanes (fsdr_fir_lanes, the serving plane's [L, n] batch): the lane is the
// grid's y dimension, and each lane offsets x, hist, taps and y by its own
// strides before anything else, so a lane runs exactly the one-stream
// kernel's arithmetic on its row (its output equals a one-stream launch on
// that row bit for bit). Each lane's y row must start 16-byte aligned.

#include <cstdint>

#include "common.cuh"

namespace {

using fsdr::skew;

constexpr int kMaxThreads = 256;
constexpr int kOuts = 8;                 // consecutive outputs a thread (R)

constexpr int kWarpOuts = 32 * kOuts;    // outputs a warp

// Span index i sits at slot skew(i + span_off(nt), ssh): the shift puts each
// window's top sample on the last slot of a group of R (fsdr::window_mac's
// ALIGNED), so a chunk of R MAC steps loads at constant offsets.
__host__ __device__ inline int span_off(int nt) { return (kOuts - nt % kOuts) % kOuts; }

// the taps (an even number of float slots), then `bufs` skewed spans of
// kWarpOuts + nt - 1 samples a warp, elt bytes each
__host__ __device__ inline int span_slots(int nt, int ssh) {
  return skew(span_off(nt) + kWarpOuts + nt - 2, ssh) + 1;
}
__host__ inline size_t smem_bytes(int warps, int bufs, int nt, int ssh, size_t elt) {
  return 4 * static_cast<size_t>((nt + 1) & ~1) +
         elt * static_cast<size_t>(bufs) * warps * span_slots(nt, ssh);
}

__device__ __forceinline__ float round_if(float v, bool bf16) {
  return bf16 ? fsdr::bf16_round(v) : v;
}
__device__ __forceinline__ float2 round_if(float2 v, bool bf16) {
  return bf16 ? fsdr::bf16_round(v) : v;
}

// R consecutive outputs from o on: 16-byte stores (o is a multiple of R and y
// is 16-byte aligned)
__device__ __forceinline__ void store_run(float* y, const float (&acc)[kOuts]) {
  float4* d = reinterpret_cast<float4*>(y);
#pragma unroll
  for (int i = 0; i < kOuts / 4; ++i) {
    d[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}
__device__ __forceinline__ void store_run(float2* y, const float2 (&acc)[kOuts]) {
  float4* d = reinterpret_cast<float4*>(y);
#pragma unroll
  for (int i = 0; i < kOuts / 2; ++i) {
    d[i] = make_float4(acc[2 * i].x, acc[2 * i].y, acc[2 * i + 1].x, acc[2 * i + 1].y);
  }
}

// One warp's tile (warp tile index w, kWarpOuts outputs from w * kWarpOuts
// on) into its span buffer `buf`: span index i holds stream sample
// w * kWarpOuts - (nt - 1) + i, from hist or zero before the frame, zero
// past it.
template <typename T>
__device__ __forceinline__ void stage_tile(T* buf, const T* __restrict__ hist,
                                           const T* __restrict__ x, long long n, int nt,
                                           int ssh, long long w, int lane) {
  const long long g0 = w * kWarpOuts - (nt - 1);
  const int off = span_off(nt);
  for (int i = lane; i < kWarpOuts + nt - 1; i += 32) {
    const long long g = g0 + i;
    T* d = buf + skew(i + off, ssh);
    if (g >= 0 && g < n) {
      fsdr::cp_async(d, x + g);
    } else if (g < 0 && hist != nullptr) {
      fsdr::cp_async(d, hist + (nt - 1 + g));          // g in [-(nt-1), -1]
    } else {
      *d = fsdr::zero<T>();
    }
  }
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
fir_kernel(const T* __restrict__ hist, const T* __restrict__ x,
           const float* __restrict__ taps, T* __restrict__ y, long long n, int nt,
           int ssh, int bufs, long long hs, long long xs, long long ts, long long ys) {
  extern __shared__ float2 smem[];
  // this block's lane: its rows of hist, x, taps and y
  const long long lane_id = blockIdx.y;
  if (hist != nullptr) hist += lane_id * hs;
  x += lane_id * xs;
  taps += lane_id * ts;
  y += lane_id * ys;
  const int lane = threadIdx.x & 31;
  const int span = kWarpOuts + nt - 1;
  const int slots = span_slots(nt, ssh);
  float* s_taps = reinterpret_cast<float*>(smem);
  T* s_x = reinterpret_cast<T*>(s_taps + ((nt + 1) & ~1)) +
           bufs * (threadIdx.x >> 5) * slots;           // this warp's span buffers
  // warp tiles w, w + stride, ... of kWarpOuts outputs each
  const long long n_tiles = (n + kWarpOuts - 1) / kWarpOuts;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  long long w = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);

  // the taps (group 0), then the warp's first tile (group 1)
  for (int i = threadIdx.x; i < nt; i += blockDim.x) fsdr::cp_async(s_taps + i, taps + i);
  fsdr::cp_async_commit();
  if (w < n_tiles) stage_tile(s_x, hist, x, n, nt, ssh, w, lane);
  fsdr::cp_async_commit();
  fsdr::cp_async_wait<1>();
  if (BF16) {
    for (int i = threadIdx.x; i < nt; i += blockDim.x) s_taps[i] = round_if(s_taps[i], true);
  }
  __syncthreads();                                     // the taps, block-wide

  // Each warp on its own (no block-wide barrier): with two buffers the next
  // tile's copies fly while the MAC runs on this one.
  for (int it = 0; w < n_tiles; ++it, w += stride) {
    T* buf = s_x + (bufs == 2 ? (it & 1) * slots : 0);
    if (bufs == 2) {
      if (w + stride < n_tiles) {
        stage_tile(s_x + ((it + 1) & 1) * slots, hist, x, n, nt, ssh, w + stride, lane);
      }
      fsdr::cp_async_commit();
      fsdr::cp_async_wait<1>();                        // this tile's copies
    } else {
      if (it > 0) {
        stage_tile(buf, hist, x, n, nt, ssh, w, lane);
        fsdr::cp_async_commit();
      }
      fsdr::cp_async_wait<0>();
    }
    if (BF16) {                                        // what this lane staged
      for (int i = lane; i < span; i += 32) {
        T* d = buf + skew(i + span_off(nt), ssh);
        *d = round_if(*d, true);
      }
    }
    __syncwarp();
    // y[base + c0 + r] = sum_k taps[k] * span[c0 + r + nt - 1 - k]
    const int c0 = lane * kOuts;
    const long long o = w * kWarpOuts + c0;
    T acc[kOuts];
    fsdr::window_mac<T, kOuts, true>(buf, s_taps, c0, nt, span, ssh, span_off(nt), acc);
    if (o + kOuts <= n) {
      store_run(y + o, acc);
    } else {
#pragma unroll
      for (int r = 0; r < kOuts; ++r) {
        if (o + r < n) y[o + r] = acc[r];
      }
    }
    __syncwarp();                                      // before buf is staged again
  }
}

// lanes: the grid's y dimension; strides (hs, xs, ts, ys) in elements a lane
struct Lanes {
  int lanes;
  long long hs, xs, ts, ys;
};

template <typename T, bool BF16>
cudaError_t launch(const void* hist, const void* x, const void* taps, void* y,
                   long long n, int nt, int threads, int blocks, int ssh, int bufs,
                   size_t smem, const Lanes& ln, cudaStream_t stream) {
  auto kern = fir_kernel<T, BF16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ln.lanes));
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(hist), static_cast<const T*>(x),
      static_cast<const float*>(taps), static_cast<T*>(y), n, nt, ssh, bufs, ln.hs, ln.xs,
      ln.ts, ln.ys);
  return cudaGetLastError();
}

int run(const void* hist, const void* x, const void* taps, void* y, long long n, int nt,
        int modes, const int* plan, long long smem, const Lanes& ln, void* stream) {
  if (n <= 0 || ln.lanes == 0) return 0;
  const int threads = plan[0], blocks = plan[1], ssh = plan[2], bufs = plan[3];
  const bool is_complex = modes & 1, bf16 = modes & 2;
  const size_t elt = is_complex ? 8 : 4;
  if (nt < 1 || threads < 32 || threads > kMaxThreads || threads % 32 || blocks < 1 ||
      ssh < 0 || ssh > 31 || (bufs != 1 && bufs != 2) || ln.lanes < 0 ||
      ln.lanes > 65535 || reinterpret_cast<uintptr_t>(y) % 16 ||
      (ln.lanes > 1 && (ln.ys * elt) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t want = smem_bytes(threads / 32, bufs, nt, ssh, elt);
  if (static_cast<size_t>(smem) != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    return bf16 ? launch<float2, true>(hist, x, taps, y, n, nt, threads, blocks, ssh, bufs,
                                       want, ln, s)
                : launch<float2, false>(hist, x, taps, y, n, nt, threads, blocks, ssh, bufs,
                                        want, ln, s);
  }
  return bf16 ? launch<float, true>(hist, x, taps, y, n, nt, threads, blocks, ssh, bufs,
                                    want, ln, s)
              : launch<float, false>(hist, x, taps, y, n, nt, threads, blocks, ssh, bufs,
                                     want, ln, s);
}

}  // namespace

// hist: nt - 1 samples before x, or null for a zero initial state; y: n
// outputs, 16-byte aligned; modes: 1 a complex stream, 2 bf16 mode. The plan
// (cuda_kernels.fir_plan), four ints: threads per block (whole warps),
// blocks (each warp walks the tiles of 256 outputs blocks x warps apart), the
// spans' pad shift, span buffers a warp (2: the next tile staged during the
// MAC); and its shared memory, which must equal this layout's. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int fsdr_fir(const void* hist, const void* x, const void* taps, void* y,
                        long long n, int nt, int modes, const int* plan, long long smem,
                        void* stream) {
  return run(hist, x, taps, y, n, nt, modes, plan, smem, Lanes{1, 0, 0, 0, 0}, stream);
}

// The lane form: `lanes` streams of n samples, lane l at hist + l * hs (null:
// zero initial states), x + l * xs, taps + l * ts (ts = 0: shared taps) and
// y + l * ys, strides in elements; every y row 16-byte aligned. The plan is
// the one-stream plan for n, run once a lane.
extern "C" int fsdr_fir_lanes(const void* hist, const void* x, const void* taps, void* y,
                              long long n, int nt, int modes, const int* plan,
                              long long smem, int lanes, long long hs, long long xs,
                              long long ts, long long ys, void* stream) {
  return run(hist, x, taps, y, n, nt, modes, plan, smem, Lanes{lanes, hs, xs, ts, ys},
             stream);
}
