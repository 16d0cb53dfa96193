// fastchain: single-threaded round-robin executor for source-rooted TREES of
// stream blocks (linear chains as the degenerate case) — the native work-loop
// driver for the small-chunk regime, with real DSP stages (FIR with carried
// history + decimation, quadrature demod, and the rotate→FIR→decimate
// xlating stage — which Python only fuses behind an explicit fastchain_static
// opt-in, since a fused chain cannot service the block's live freq retune
// handler). v3 protocol: an in_ring[] topology array; a ring consumed by
// several stages BROADCASTS (per-consumer read indices, finished consumers
// released) — the actor runtime's 1-writer→N-reader port groups.
//
// Reference role: src/runtime/scheduler/flow.rs:265-442 — the reference's
// FlowScheduler runs pinned workers with LOCAL run queues precisely because
// per-work-call executor overhead dominates when blocks forward tiny chunks
// (perf/null_rand: 512-item CopyRand chains) — and its north-star perf grid
// (perf/fir/fir.rs:49-95) interleaves those CopyRands with 64-tap FIRs.
// Python's asyncio actor loop costs ~10 us per work() call in that regime;
// this driver runs a WHOLE pipe (source → head → copyrands/firs/demod → sink)
// inside one C++ thread with plain ring buffers between stages
// (single-threaded: no atomics, no wakeups — the round-robin IS the schedule,
// like one pinned flow.rs worker that owns every block of the pipe).
//
// v2 protocol: stages carry their OWN output item size (isz_out), so
// rate/dtype-changing stages (complex FIR → f32 demod) fuse too. Stateful
// stages carry their state across chunks exactly like the Python cores
// (dsp/kernels.py FirFilter/DecimatingFirFilter, blocks/dsp.py
// QuadratureDemod): FIR history is nt-1 zero-initialized items, decimation
// phase is chunk-invariant, demod seeds last=1+0j. Numeric note: FIR
// accumulation order differs from numpy's np.convolve (BLAS dot), so outputs
// match to float32 rounding (~1e-6 relative), not bit-exactly — the A/B
// tests use allclose for FIR/demod chains and exact equality for copy chains.
//
// The port's copy of native/fastchain.cpp, built with g++ -O3 -march=native
// on first use by ops/_build.py (load_host) and bound with ctypes; it adds
// fsdr_fastchain_avx512(), which reports whether the AVX-512 FIR path was
// compiled in. The Python runtime substitutes eligible chains at launch
// (futuresdr_tpu_torch/runtime/fastchain.py). Opt out with FSDR_NO_NATIVE=1 or
// FSDR_NO_FASTCHAIN=1.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

extern "C" {

// Stage kinds (keep in sync with futuresdr_tpu_torch/runtime/fastchain.py)
enum {
    FC_NULL_SOURCE = 0,   // produce zeros forever
    FC_HEAD = 1,          // p0 = max items to forward, then EOS downstream
    FC_COPY = 2,          // forward everything
    FC_COPY_RAND = 3,     // p0 = max_copy (forward 1..=max_copy per pass), p1 = seed
    FC_NULL_SINK = 4,     // consume; p0 = count to finish after (-1 = until EOS)
    FC_VEC_SOURCE = 5,    // emit data cyclically: p0 = total items, p1 = period
    FC_VEC_SINK = 6,      // collect into data: p0 = capacity (exact bound)
    FC_FIR_FF = 7,        // f32 FIR, f32 taps: p0 = ntaps, p1 = decim, data = taps
    FC_FIR_CF = 8,        // c64 FIR, f32 taps: p0 = ntaps, p1 = decim, data = taps
    FC_FIR_CC = 9,        // c64 FIR, c64 taps: p0 = ntaps, p1 = decim, data = taps
    FC_QUAD_DEMOD = 10,   // c64 → f32: f0 = gain; y = gain*arg(x[n]*conj(x[n-1]))
    FC_XLATING = 11,      // c64 rotate(f0=phase_inc) → f32-tap FIR → decim
    FC_AGC = 12,          // per-sample AGC: p0 = 1 if complex items,
                          // data = double[4]{reference, rate, max_gain, gain0}
    FC_RESAMPLE = 13,     // rational polyphase resampler: p0 = K (sub-filter
                          // len), p1 = interp | decim<<32, data = poly[I][K]
                          // f32 row-major (dsp/kernels.py:88 layout)
    // FC_VEC_SOURCE with p0 < 0 = INFINITE cyclic emission (FileSource
    // repeat=true over a memmap; bounded downstream by Head/sink count)
    FC_SIG = 14,          // fxpt NCO source: p0 = waveform (0 sin, 1 cos,
                          // 2 complex, 3 square), p1 = inc_u32 | start<<32,
                          // data = double[2]{amplitude, offset}. The phase is
                          // a wrapping u32 (dsp/fxpt.py) — integer, so the
                          // native ramp is BIT-exact vs the Python block.
    FC_DELAY = 15,        // p0 = pad (leading zero items), p1 = skip
                          // (leading input items dropped); then 1:1 copy
    FC_THROTTLE = 16,     // wall-clock rate limit: f0 = items/s. Python fuses
                          // it only behind the fastchain_static opt-in (the
                          // block has a live rate retune handler, like
                          // FC_XLATING/FC_AGC).
};

struct FcStage {
    int32_t kind;
    int32_t isz_out;      // bytes per item on this stage's OUTPUT (sink: on input)
    int64_t p0;
    int64_t p1;
    double f0;            // float parameter (FC_QUAD_DEMOD: gain)
    uint8_t* data;        // vec data / taps / sink out buf
};

}  // extern "C"

namespace {

struct Ring {
    char* buf = nullptr;
    int64_t cap = 0;       // items
    int64_t isz = 0;       // bytes per item
    int64_t head = 0;      // write index (items, not wrapped)
    bool eos = false;
    // v3 topology: one read index per consumer (broadcast ring — every
    // consumer sees every item, like the actor runtime's 1-writer→N-reader
    // port groups, `runtime/buffer/circular.py:108`). Linear chains have
    // exactly one entry.
    std::vector<int64_t> tails;
    // A finished consumer's slot is RELEASED so its frozen tail no longer
    // constrains the writer — the actor runtime likewise drops a finished
    // block's reader from the port group (an early-finishing Head branch
    // must not wedge its broadcast siblings).
    std::vector<char> released;

    int64_t min_tail() const {
        int64_t m = head;
        for (size_t c = 0; c < tails.size(); ++c)
            if (!released[c] && tails[c] < m) m = tails[c];
        return m;
    }
    int64_t count(int c) const { return head - tails[static_cast<size_t>(c)]; }
    int64_t space() const { return cap - (head - min_tail()); }
    void release(int c) { released[static_cast<size_t>(c)] = 1; }
};

// xorshift64* — per-stage chunk-size RNG for FC_COPY_RAND
inline uint64_t xs(uint64_t& s) {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
}

// copy k items between buffers; a cap of 0 means LINEAR (no wrap), nonzero
// means ring with that capacity. The single audited wrap-splitting loop for
// ring->ring (inter-stage), vec->ring (source), ring->linear (FIR gather) and
// linear->ring (FIR scatter) paths.
inline void span_copy(const uint8_t* sb, int64_t scap, int64_t& si,
                      uint8_t* db, int64_t dcap, int64_t& di,
                      int64_t k, int64_t isz) {
    while (k > 0) {
        int64_t s_off = scap ? si % scap : si;
        int64_t d_off = dcap ? di % dcap : di;
        int64_t c = k;
        if (scap && scap - s_off < c) c = scap - s_off;
        if (dcap && dcap - d_off < c) c = dcap - d_off;
        std::memcpy(db + d_off * isz, sb + s_off * isz,
                    static_cast<size_t>(c * isz));
        si += c;
        di += c;
        k -= c;
    }
}

inline void ring_copy(Ring& src, int ci, Ring& dst, int64_t k) {
    span_copy(reinterpret_cast<const uint8_t*>(src.buf), src.cap,
              src.tails[static_cast<size_t>(ci)],
              reinterpret_cast<uint8_t*>(dst.buf), dst.cap, dst.head, k,
              src.isz);
}

// ---- FIR compute kernels ----------------------------------------------------
//
// Layout trick that makes every variant a pure float saxpy the compiler
// auto-vectorizes WITHOUT -ffast-math: outer loop over taps, inner loop over
// outputs (independent accumulations — no float reduction reordering needed),
// blocked so the accumulator tile and its input window stay in L1. A
// complex64 stream with real taps is the SAME kernel on the interleaved float
// view with the tap offset doubled.

constexpr int64_t FIR_BLK = 1024;   // floats per accumulator tile (4 KiB)

// y[j] = sum_t taps[t] * x[j - t*stride], j in [0, n) — x may be read back to
// x[-(nt-1)*stride] (history prefix guaranteed by the caller).
//
// Tap-unrolled 8-wide: one accumulator load/store services 8 FMAs instead of
// 1, lifting the loop from load/store-bound (~3 memory ops per FMA) to
// FMA-bound. The per-output accumulation ORDER stays ascending-t — the 8 adds
// are sequential on the same lane — so results are bit-identical to the
// straight loop.
inline void fir_real_taps(const float* x, const float* taps, int64_t nt,
                          int64_t stride, float* y, int64_t n) {
    float acc[FIR_BLK];
    for (int64_t j0 = 0; j0 < n; j0 += FIR_BLK) {
        int64_t jb = n - j0 < FIR_BLK ? n - j0 : FIR_BLK;
        std::memset(acc, 0, static_cast<size_t>(jb) * sizeof(float));
        int64_t t = 0;
        for (; t + 8 <= nt; t += 8) {
            const float c0 = taps[t], c1 = taps[t + 1], c2 = taps[t + 2],
                        c3 = taps[t + 3], c4 = taps[t + 4], c5 = taps[t + 5],
                        c6 = taps[t + 6], c7 = taps[t + 7];
            const float* xs = x + j0 - t * stride;
            for (int64_t j = 0; j < jb; ++j) {
                float a = acc[j];
                a += c0 * xs[j];
                a += c1 * xs[j - stride];
                a += c2 * xs[j - 2 * stride];
                a += c3 * xs[j - 3 * stride];
                a += c4 * xs[j - 4 * stride];
                a += c5 * xs[j - 5 * stride];
                a += c6 * xs[j - 6 * stride];
                a += c7 * xs[j - 7 * stride];
                acc[j] = a;
            }
        }
        for (; t < nt; ++t) {
            const float c = taps[t];
            const float* xs = x + j0 - t * stride;
            for (int64_t j = 0; j < jb; ++j) acc[j] += c * xs[j];
        }
        std::memcpy(y + j0, acc, static_cast<size_t>(jb) * sizeof(float));
    }
}

// Folded symmetric FIR (taps palindromic, nt even): y[f] = Σ_{k<nt/2}
// taps[k] · (x[f−k·stride] + x[f−(nt−1−k)·stride]) on the float view —
// halves the multiplies, and the ADD issues on a different port than the FMA,
// which matters on parts with a single 512-bit FMA unit (this box: folded
// ~480 Msps vs ~375 straight at 64 taps). Accumulation order: ascending k
// with the mirror pair pre-added — a third numeric order besides numpy's and
// the straight kernel's, all within float32 rounding of each other.
inline void fir_sym(const float* x, const float* taps, int64_t nt,
                    int64_t stride, float* y, int64_t nf) {
    const int64_t h = nt / 2;
    const int64_t Ls = (nt - 1) * stride;
    int64_t j0 = 0;
#ifdef __AVX512F__
    for (; j0 + 64 <= nf; j0 += 64) {
        __m512 a0 = _mm512_setzero_ps(), a1 = a0, a2 = a0, a3 = a0;
        for (int64_t k = 0; k < h; ++k) {
            const float* xa = x + j0 - k * stride;
            const float* xb = x + j0 - Ls + k * stride;
            const __m512 c = _mm512_set1_ps(taps[k]);
            a0 = _mm512_fmadd_ps(
                c, _mm512_add_ps(_mm512_loadu_ps(xa), _mm512_loadu_ps(xb)), a0);
            a1 = _mm512_fmadd_ps(
                c, _mm512_add_ps(_mm512_loadu_ps(xa + 16),
                                 _mm512_loadu_ps(xb + 16)), a1);
            a2 = _mm512_fmadd_ps(
                c, _mm512_add_ps(_mm512_loadu_ps(xa + 32),
                                 _mm512_loadu_ps(xb + 32)), a2);
            a3 = _mm512_fmadd_ps(
                c, _mm512_add_ps(_mm512_loadu_ps(xa + 48),
                                 _mm512_loadu_ps(xb + 48)), a3);
        }
        _mm512_storeu_ps(y + j0, a0);
        _mm512_storeu_ps(y + j0 + 16, a1);
        _mm512_storeu_ps(y + j0 + 32, a2);
        _mm512_storeu_ps(y + j0 + 48, a3);
    }
#endif
    for (; j0 < nf; ++j0) {
        float s = 0;
        for (int64_t k = 0; k < h; ++k)
            s += taps[k] * (x[j0 - k * stride] + x[j0 - Ls + k * stride]);
        y[j0] = s;
    }
}

#ifdef __AVX512F__
// The valignd folded-symmetric kernel is shared with the design-space
// microbench so the benchmarked kernel IS the production kernel.
#include "fir_valign.h"
#endif  // __AVX512F__

// Symmetric-tap dispatch: valignd kernel where it wins, plain folded
// otherwise (bit-identical either way).
inline void fir_sym_best(const float* x, const float* taps, int64_t nt,
                         int64_t stride, float* y, int64_t nf) {
#ifdef __AVX512F__
    if (stride == 1) return fir_sym_valign<1>(x, taps, nt, y, nf);
    if (stride == 2) return fir_sym_valign<2>(x, taps, nt, y, nf);
#endif
    fir_sym(x, taps, nt, stride, y, nf);
}

// complex64 stream, complex64 taps: yr = Σ tr·xr − ti·xi ; yi = Σ tr·xi + ti·xr
// on the interleaved float view (x/y are float pointers, n complex items).
inline void fir_cc(const float* x, const float* taps, int64_t nt,
                   float* y, int64_t n) {
    float acc[FIR_BLK];                      // interleaved re/im tile
    const int64_t n2 = 2 * n;
    for (int64_t j0 = 0; j0 < n2; j0 += FIR_BLK) {
        int64_t jb = n2 - j0 < FIR_BLK ? n2 - j0 : FIR_BLK;
        std::memset(acc, 0, static_cast<size_t>(jb) * sizeof(float));
        for (int64_t t = 0; t < nt; ++t) {
            const float tr = taps[2 * t], ti = taps[2 * t + 1];
            const float* xs = x + j0 - 2 * t;
            // even lanes (re): tr·xr − ti·xi ; odd lanes (im): tr·xi + ti·xr
            for (int64_t j = 0; j + 1 < jb; j += 2) {
                acc[j] += tr * xs[j] - ti * xs[j + 1];
                acc[j + 1] += tr * xs[j + 1] + ti * xs[j];
            }
        }
        std::memcpy(y + j0, acc, static_cast<size_t>(jb) * sizeof(float));
    }
}

// Per-stage mutable state for compute stages.
struct StageState {
    std::vector<uint8_t> hist;   // FIR: nt-1 items (zero-init = virtual history)
    std::vector<uint8_t> xbuf;   // FIR: linear gather buffer (hist ++ chunk)
    std::vector<uint8_t> ybuf;   // FIR/demod: linear output before ring scatter
    int64_t phase = 0;           // decimation phase (dsp/kernels.py:64 contract)
    float last_re = 1.0f;        // quad demod x[n-1] seed (blocks/dsp.py:407)
    float last_im = 0.0f;
    double rot_phase = 0.0;      // FC_XLATING rotator phase (dsp Rotator carry)
    double agc_gain = 1.0;       // FC_AGC feedback state (blocks/dsp.py Agc)
    int64_t rs_m = 0;            // FC_RESAMPLE absolute output index
    int64_t rs_total = 0;        // FC_RESAMPLE absolute inputs seen
    double thr_t0 = -1.0;        // FC_THROTTLE clock anchor (monotonic s; <0 unset)
    int64_t thr_sent = 0;        // FC_THROTTLE items forwarded since anchor
};

inline double mono_seconds() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<double>(ts.tv_sec) + 1e-9 * static_cast<double>(ts.tv_nsec);
}

inline int64_t mono_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// Per-stage busy-time attribution (the tracing/profiling plane reaching into
// the native driver): times every scheduling pass of a stage — including its
// cheap no-work polls, so the round-robin's bookkeeping is attributed where
// it is spent — via a scope guard that fires on every `continue`. One vDSO
// clock pair (~50 ns) per stage pass against passes that move hundreds to
// thousands of items; per_ns == nullptr disables entirely.
struct ProfGuard {
    int64_t* slot;
    int64_t t0;
    explicit ProfGuard(int64_t* s) : slot(s), t0(s ? mono_ns() : 0) {}
    ~ProfGuard() {
        if (slot) *slot += mono_ns() - t0;
    }
};

// Outputs producible once `total` absolute inputs are visible: the largest m
// with (m·D)//I ≤ total−1 is (I·total−1)//D, plus one — the closed form of
// PolyphaseResamplingFir.process's m_hi (dsp/kernels.py; the core's former
// decrement-loop undershot it for some I>D alignments, which the fast-chain
// A/B exposed as chunk-dependent results — fixed together).
inline int64_t resample_m_hi(int64_t total, int64_t I, int64_t D) {
    if (total <= 0) return 0;
    return (I * total - 1) / D + 1;
}

// Run a chain/tree to completion (every sink finished) or until *stop becomes
// nonzero. ``inr[i]`` is the index of the stage whose output ring stage i
// consumes (-1 for the source at index 0); stages listed in topological order.
// A ring read by several stages is a BROADCAST ring: every consumer sees every
// item, own read index each (the actor runtime's 1-writer→N-reader port
// groups). per_in[i]/per_out[i] accumulate items consumed/produced by stage i
// (sources consume 0, sinks produce 0); per_calls[i] counts chunks moved (the
// work-call analog). All arrays are updated DURING the run, so the Python side
// reads them live for metrics. Returns total items consumed across sinks, or
// -1 on malformed input / stall (-2: sink capacity bound violated).
int64_t fc_run_core(const FcStage* st, int32_t n, const int32_t* inr,
                    int64_t ring_items, volatile int32_t* stop,
                    int64_t* per_in, int64_t* per_out, int64_t* per_calls,
                    int64_t* per_ns) {
    if (n < 2 || ring_items <= 0) return -1;
    // ---- topology: consumer counts + per-stage consumer slot ---------------
    std::vector<int> n_cons(n, 0), slot(n, 0);
    if (inr[0] != -1) return -1;
    for (int i = 1; i < n; ++i) {
        if (inr[i] < 0 || inr[i] >= i) return -1;   // topo order, single root
        slot[i] = n_cons[inr[i]]++;
    }
    for (int i = 0; i < n; ++i) {
        if (st[i].isz_out <= 0) return -1;
        if (st[i].kind == FC_COPY_RAND && st[i].p0 <= 0)
            return -1;                   // modulo-by-zero guard (max_copy >= 1)
        if (st[i].kind == FC_VEC_SOURCE &&
            (st[i].p1 <= 0 || st[i].data == nullptr))
            return -1;                   // empty/unbacked source
        if (st[i].kind == FC_VEC_SINK && st[i].data == nullptr)
            return -1;
        if (st[i].kind >= FC_FIR_FF && st[i].kind <= FC_XLATING &&
            st[i].kind != FC_QUAD_DEMOD &&
            (st[i].p0 < 1 || (st[i].p1 & 0xFFFFFFFFLL) < 1 ||
             st[i].data == nullptr))
            return -1;                   // ntaps/decim/taps sanity
        if (st[i].kind == FC_THROTTLE &&
            !(st[i].f0 > 0.0 && std::isfinite(st[i].f0)))
            return -1;    // rate must be positive finite (inf·elapsed → NaN
                          // budget → int64 min → permanent 0-item passes: the
                          // loop would sleep forever instead of erroring)
    }
    if (st[0].kind != FC_NULL_SOURCE && st[0].kind != FC_VEC_SOURCE &&
        st[0].kind != FC_SIG)
        return -1;
    if (st[0].kind == FC_SIG && st[0].data == nullptr) return -1;
    int n_sinks = 0;
    for (int i = 1; i < n; ++i) {
        if (n_cons[i] == 0) {            // leaf: must be a sink kind
            if (st[i].kind != FC_NULL_SINK && st[i].kind != FC_VEC_SINK)
                return -1;
            ++n_sinks;
            continue;
        }
        // middle stage (has both an input ring and consumers)
        if (st[i].kind < FC_HEAD || st[i].kind > FC_THROTTLE ||
            st[i].kind == FC_SIG ||
            st[i].kind == FC_NULL_SINK || st[i].kind == FC_VEC_SOURCE ||
            st[i].kind == FC_VEC_SINK)
            return -1;
        if (st[i].kind == FC_AGC && st[i].data == nullptr)
            return -1;                  // params block required
        if (st[i].kind == FC_RESAMPLE &&
            (st[i].p0 < 1 || (st[i].p1 & 0xFFFFFFFFLL) < 1 ||
             (st[i].p1 >> 32) < 1 || st[i].data == nullptr))
            return -1;                  // K / interp / decim / poly sanity
        // width conservation: every middle stage except the dtype-changing
        // demod must see equal in/out item sizes, or ring_copy would write
        // src-width items into a dst-width ring (defense in depth — the
        // Python chain finder enforces the same rule)
        if (st[i].kind != FC_QUAD_DEMOD &&
            st[inr[i]].isz_out != st[i].isz_out)
            return -1;
    }
    if (n_sinks == 0) return -1;

    // one output ring per stage with consumers (ring index = producer index)
    std::vector<Ring> rings(n);
    for (int i = 0; i < n; ++i) {
        if (n_cons[i] == 0) continue;
        Ring& r = rings[i];
        r.isz = st[i].isz_out;
        // calloc: rings start zeroed, so the zero-producing source can advance
        // indices without writing (same fast path as the Python NullSource)
        r.buf = static_cast<char*>(
            std::calloc(static_cast<size_t>(ring_items),
                        static_cast<size_t>(r.isz)));
        if (!r.buf) {
            for (auto& q : rings) std::free(q.buf);
            return -1;
        }
        r.cap = ring_items;
        r.tails.assign(static_cast<size_t>(n_cons[i]), 0);
        r.released.assign(static_cast<size_t>(n_cons[i]), 0);
    }

    std::vector<int64_t> head_left(n, -1);   // FC_HEAD remaining budget
    std::vector<uint64_t> rng(n, 0);
    std::vector<bool> done(n, false);
    std::vector<StageState> ss(n);
    int64_t src_emitted = 0;                 // FC_VEC_SOURCE progress (stage 0)
    for (int i = 0; i < n; ++i) {
        if (st[i].kind == FC_HEAD) head_left[i] = st[i].p0;
        if (st[i].kind == FC_COPY_RAND)
            rng[i] = static_cast<uint64_t>(st[i].p1) * 0x9E3779B97F4A7C15ULL + 1;
        if ((st[i].kind >= FC_FIR_FF && st[i].kind <= FC_FIR_CC) ||
            st[i].kind == FC_XLATING) {
            const int64_t in_isz = st[inr[i]].isz_out;
            ss[i].hist.assign(
                static_cast<size_t>((st[i].p0 - 1) * in_isz), 0);
            ss[i].xbuf.resize(
                static_cast<size_t>((st[i].p0 - 1 + ring_items) * in_isz));
            std::memset(ss[i].xbuf.data(), 0,
                        static_cast<size_t>((st[i].p0 - 1) * in_isz));
            ss[i].ybuf.resize(static_cast<size_t>(ring_items * st[i].isz_out));
        }
        if (st[i].kind == FC_QUAD_DEMOD || st[i].kind == FC_AGC ||
            st[i].kind == FC_SIG)
            ss[i].ybuf.resize(static_cast<size_t>(ring_items * st[i].isz_out));
        if (st[i].kind == FC_AGC)
            ss[i].agc_gain =
                reinterpret_cast<const double*>(st[i].data)[3];   // gain0
        if (st[i].kind == FC_DELAY) {
            ss[i].rs_m = st[i].p0;       // pad remaining
            ss[i].rs_total = st[i].p1;   // skip remaining
        }
        if (st[i].kind == FC_RESAMPLE) {
            const int64_t in_isz = st[inr[i]].isz_out;
            const int64_t K = st[i].p0;
            ss[i].hist.assign(static_cast<size_t>((K - 1) * in_isz), 0);
            ss[i].xbuf.resize(
                static_cast<size_t>((K - 1 + ring_items) * in_isz));
            std::memset(ss[i].xbuf.data(), 0,
                        static_cast<size_t>((K - 1) * in_isz));
            // per-chunk outputs are limited by out.space() ≤ ring_items
            ss[i].ybuf.resize(static_cast<size_t>(ring_items * st[i].isz_out));
        }
    }
    // per-sink finish bounds (-1 = until EOS) and consumed counters
    std::vector<int64_t> snk_count(n, -1), snk_items(n, 0);
    for (int i = 1; i < n; ++i)
        if (n_cons[i] == 0 && st[i].kind == FC_NULL_SINK)
            snk_count[i] = st[i].p0;
    int sinks_left = n_sinks;

    // relaxed atomic load: the flag is written from a Python thread; plain
    // volatile is a data race under the C++ memory model
    while (!__atomic_load_n(stop, __ATOMIC_RELAXED) && sinks_left > 0) {
        bool progress = false;
        bool throttled = false;    // a throttle is pacing (not a stall)
        for (int i = 0; i < n; ++i) {
            if (done[i]) continue;
            ProfGuard prof_(per_ns ? &per_ns[i] : nullptr);
            if (i == 0) {
                Ring& out = rings[0];
                if (st[0].kind == FC_VEC_SOURCE) {
                    int64_t k = out.space();
                    const bool finite = st[0].p0 >= 0;
                    if (finite && st[0].p0 - src_emitted < k)
                        k = st[0].p0 - src_emitted;
                    if (k > 0) {
                        // source data is a RING of period p1 (cyclic repeat)
                        span_copy(st[0].data, st[0].p1, src_emitted,
                                  reinterpret_cast<uint8_t*>(out.buf), out.cap,
                                  out.head, k, out.isz);
                        progress = true;
                        if (per_out) per_out[0] += k;
                        if (per_calls) per_calls[0] += 1;
                    }
                    if (finite && src_emitted >= st[0].p0) {
                        out.eos = true;
                        done[0] = true;
                    }
                    continue;
                }
                if (st[0].kind == FC_SIG) {
                    int64_t k = out.space();
                    if (k > 0) {
                        const double* pr =
                            reinterpret_cast<const double*>(st[0].data);
                        const double amp = pr[0], off = pr[1];
                        const uint32_t inc =
                            static_cast<uint32_t>(st[0].p1 & 0xFFFFFFFFLL);
                        const uint32_t ph0 =
                            static_cast<uint32_t>(st[0].p1 >> 32);
                        const int64_t wf = st[0].p0;
                        float* yb = reinterpret_cast<float*>(ss[0].ybuf.data());
                        const double scale = M_PI / 2147483648.0;
                        // square: the sign of sin(ph) is exactly the sign of
                        // the int32 phase (ph in [-pi, pi); sin(-pi) in f64 is
                        // a tiny negative, matching numpy) — no trig at all
                        if (wf == 3) {
                            for (int64_t j = 0; j < k; ++j) {
                                const uint32_t pu = ph0 + inc *
                                    static_cast<uint32_t>(
                                        (src_emitted + j) & 0xFFFFFFFFLL);
                                const int32_t pi_ = static_cast<int32_t>(pu);
                                const double y = (pi_ > 0) - (pi_ < 0);
                                yb[j] = static_cast<float>(amp * y + off);
                            }
                        } else {
                            // chunk-anchored rotation: one exact sincos per
                            // 256 samples (re-anchored on the INTEGER phase,
                            // so error never exceeds ~256 rotations of f64
                            // eps ≈ 1e-13 — far inside the f32 cast), then a
                            // complex recurrence — ~10x over per-sample libm
                            // trig, which lost to numpy's SIMD sin otherwise
                            const double inc_rad =
                                static_cast<double>(static_cast<int32_t>(inc))
                                * scale;
                            double rs, rc;
                            ::sincos(inc_rad, &rs, &rc);
                            for (int64_t j0 = 0; j0 < k; j0 += 256) {
                                const int64_t jb =
                                    (k - j0 < 256) ? k - j0 : 256;
                                const uint32_t pu = ph0 + inc *
                                    static_cast<uint32_t>(
                                        (src_emitted + j0) & 0xFFFFFFFFLL);
                                double cs, cc;
                                ::sincos(static_cast<double>(
                                             static_cast<int32_t>(pu)) * scale,
                                         &cs, &cc);
                                for (int64_t j = 0; j < jb; ++j) {
                                    if (wf == 2) {
                                        yb[2 * (j0 + j)] = static_cast<float>(
                                            amp * cc + off);
                                        yb[2 * (j0 + j) + 1] =
                                            static_cast<float>(amp * cs);
                                    } else if (wf == 1) {
                                        yb[j0 + j] = static_cast<float>(
                                            amp * cc + off);
                                    } else {
                                        yb[j0 + j] = static_cast<float>(
                                            amp * cs + off);
                                    }
                                    const double nc = cc * rc - cs * rs;
                                    cs = cc * rs + cs * rc;
                                    cc = nc;
                                }
                            }
                        }
                        int64_t yi = 0;
                        span_copy(ss[0].ybuf.data(), 0, yi,
                                  reinterpret_cast<uint8_t*>(out.buf), out.cap,
                                  out.head, k, out.isz);
                        src_emitted += k;
                        progress = true;
                        if (per_out) per_out[0] += k;
                        if (per_calls) per_calls[0] += 1;
                    }
                    continue;                         // never EOS on its own
                }
                int64_t k = out.space();
                if (k > 0) {
                    out.head += k;                    // zeros pre-filled
                    progress = true;
                    if (per_out) per_out[0] += k;
                    if (per_calls) per_calls[0] += 1;
                }
                continue;
            }
            Ring& in = rings[inr[i]];
            const int ci = slot[i];
            if (n_cons[i] == 0) {                      // sink leaf
                int64_t k = in.count(ci);
                if (st[i].kind == FC_VEC_SINK) {
                    if (snk_items[i] + k > st[i].p0) {
                        for (auto& r : rings) std::free(r.buf);
                        return -2;        // capacity bound violated (bug)
                    }
                    span_copy(reinterpret_cast<const uint8_t*>(in.buf),
                              in.cap, in.tails[ci], st[i].data, 0,
                              snk_items[i], k, in.isz);
                    if (k > 0) {
                        progress = true;
                        if (per_in) per_in[i] += k;
                        if (per_calls) per_calls[i] += 1;
                    }
                    if (in.eos && in.count(ci) == 0) {
                        done[i] = true;
                        in.release(ci);
                        --sinks_left;
                    }
                    continue;
                }
                if (snk_count[i] >= 0 && snk_items[i] + k > snk_count[i])
                    k = snk_count[i] - snk_items[i];
                if (k > 0) {
                    in.tails[ci] += k;
                    snk_items[i] += k;
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_calls) per_calls[i] += 1;
                }
                if ((in.eos && in.count(ci) == 0) ||
                    (snk_count[i] >= 0 && snk_items[i] >= snk_count[i])) {
                    done[i] = true;
                    in.release(ci);
                    --sinks_left;
                }
                continue;
            }
            Ring& out = rings[i];

            // ---- compute middle stages -------------------------------------
            if ((st[i].kind >= FC_FIR_FF && st[i].kind <= FC_FIR_CC) ||
                st[i].kind == FC_XLATING) {
                const int64_t nt = st[i].p0;
                const int64_t decim = st[i].p1 & 0xFFFFFFFFLL;
                const bool sym = ((st[i].p1 >> 32) & 1) != 0;
                const int64_t isz_in = in.isz;
                StageState& s = ss[i];
                // inputs we may consume so outputs fit: with phase p, n inputs
                // yield (n > p) ? (n-1-p)/decim + 1 : 0 outputs → n ≤ p + space·decim
                int64_t k = in.count(ci);
                int64_t lim = s.phase + out.space() * decim;
                if (lim < k) k = lim;
                // keep chunks tile-aligned while upstream is live: the
                // vector kernels fall back to a ~10x-slower scalar loop for
                // the k%tile tail, and CopyRand-sized chunks (~2k items)
                // would pay that on EVERY pass; the remainder just waits in
                // the ring until EOS drains it. Rings smaller than one tile
                // could never satisfy the gate (review: livelock), so they
                // skip alignment entirely.
                const int64_t tile =
                    (ring_items < 64) ? 1
                    : (st[i].kind == FC_FIR_CF || st[i].kind == FC_XLATING)
                        ? 32 : 64;
                if (!in.eos && k > tile) k -= k % tile;
                else if (!in.eos && k < tile) k = 0;
                if (k > 0) {
                    uint8_t* xb = s.xbuf.data();
                    // linear gather: [hist | chunk]
                    std::memcpy(xb, s.hist.data(), s.hist.size());
                    int64_t xi = nt - 1;
                    span_copy(reinterpret_cast<const uint8_t*>(in.buf), in.cap,
                              in.tails[ci], xb, 0, xi, k, isz_in);
                    if (st[i].kind == FC_XLATING) {
                        // rotate the fresh chunk in place BEFORE the filter:
                        // downstream (kernel, history carry) then sees the
                        // rotated stream, exactly like blocks.XlatingFir
                        // feeding Rotator output into its DecimatingFirFilter
                        float* xc = reinterpret_cast<float*>(
                            xb + (nt - 1) * isz_in);
                        const double inc = st[i].f0;
                        for (int64_t j = 0; j < k; ++j) {
                            // phase0 + inc*j, like the numpy Rotator's ramp
                            // (NOT sequential accumulation — same rounding);
                            // one fused sincos per sample instead of two
                            // libm calls (glibc extension, present under
                            // g++'s default _GNU_SOURCE)
                            const double ph =
                                s.rot_phase + inc * static_cast<double>(j);
                            double sd, cd;
                            ::sincos(ph, &sd, &cd);
                            const float cr = static_cast<float>(cd);
                            const float ci = static_cast<float>(sd);
                            const float xr = xc[2 * j], xi_ = xc[2 * j + 1];
                            xc[2 * j] = xr * cr - xi_ * ci;
                            xc[2 * j + 1] = xr * ci + xi_ * cr;
                        }
                        s.rot_phase = std::fmod(s.rot_phase + inc * k,
                                                2.0 * M_PI);
                    }
                    const float* x0 = reinterpret_cast<const float*>(
                        xb + (nt - 1) * isz_in);
                    float* yb = reinterpret_cast<float*>(s.ybuf.data());
                    const float* taps =
                        reinterpret_cast<const float*>(st[i].data);
                    if (st[i].kind == FC_FIR_FF)
                        sym ? fir_sym_best(x0, taps, nt, 1, yb, k)
                            : fir_real_taps(x0, taps, nt, 1, yb, k);
                    else if (st[i].kind == FC_FIR_CF ||
                             st[i].kind == FC_XLATING)
                        // interleaved float view: same saxpy, tap offset ×2
                        sym ? fir_sym_best(x0, taps, nt, 2, yb, 2 * k)
                            : fir_real_taps(x0, taps, nt, 2, yb, 2 * k);
                    else
                        fir_cc(x0, taps, nt, yb, k);
                    // decimate y[phase::decim] (dsp/kernels.py:70-81 contract)
                    int64_t m = (k > s.phase)
                                    ? (k - 1 - s.phase) / decim + 1 : 0;
                    if (decim > 1 && m > 0) {
                        const int64_t osz = st[i].isz_out;
                        for (int64_t j = 0; j < m; ++j)
                            std::memmove(s.ybuf.data() + j * osz,
                                         s.ybuf.data() +
                                             (s.phase + j * decim) * osz,
                                         static_cast<size_t>(osz));
                    }
                    if (decim > 1) {
                        if (m > 0) {
                            int64_t last = s.phase + (m - 1) * decim;
                            s.phase = last + decim - k;
                        } else {
                            s.phase -= k;
                        }
                    }
                    // carry history: last nt-1 items of [hist | chunk]
                    std::memcpy(s.hist.data(),
                                xb + (k) * isz_in,   // = (nt-1+k)-(nt-1) items in
                                s.hist.size());
                    int64_t yi = 0;
                    span_copy(s.ybuf.data(), 0, yi,
                              reinterpret_cast<uint8_t*>(out.buf), out.cap,
                              out.head, m, st[i].isz_out);
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += m;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0) {
                    out.eos = true;      // history tail dropped, like the actor
                    done[i] = true;
                    in.release(ci);
                }
                continue;
            }
            if (st[i].kind == FC_QUAD_DEMOD) {
                StageState& s = ss[i];
                int64_t k = in.count(ci);
                if (out.space() < k) k = out.space();
                if (k > 0) {
                    const float gain = static_cast<float>(st[i].f0);
                    float* yb = reinterpret_cast<float*>(s.ybuf.data());
                    const float* rb = reinterpret_cast<const float*>(in.buf);
                    float pr = s.last_re, pi = s.last_im;
                    for (int64_t j = 0; j < k; ++j) {
                        int64_t off = (in.tails[ci] + j) % in.cap;
                        const float xr = rb[2 * off], xi_ = rb[2 * off + 1];
                        // x·conj(prev) = (xr·pr + xi·pi) + j(xi·pr − xr·pi)
                        yb[j] = gain * std::atan2(xi_ * pr - xr * pi,
                                                  xr * pr + xi_ * pi);
                        pr = xr;
                        pi = xi_;
                    }
                    s.last_re = pr;
                    s.last_im = pi;
                    in.tails[ci] += k;
                    int64_t yi = 0;
                    span_copy(s.ybuf.data(), 0, yi,
                              reinterpret_cast<uint8_t*>(out.buf), out.cap,
                              out.head, k, out.isz);
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += k;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0) {
                    out.eos = true;
                    done[i] = true;
                    in.release(ci);
                }
                continue;
            }
            if (st[i].kind == FC_RESAMPLE) {
                StageState& s = ss[i];
                const int64_t K = st[i].p0;
                const int64_t I = st[i].p1 & 0xFFFFFFFFLL;
                const int64_t D = st[i].p1 >> 32;
                const int64_t isz_in = in.isz;
                const bool cx = isz_in == 8;
                // max inputs consumable so producible outputs fit out.space():
                // binary search the monotone m_hi(total_in + n') − m ≤ space
                int64_t n_av = in.count(ci), space = out.space();
                int64_t lo = 0, hi = n_av;
                while (lo < hi) {
                    const int64_t mid = (lo + hi + 1) / 2;
                    if (resample_m_hi(s.rs_total + mid, I, D) - s.rs_m <= space)
                        lo = mid;
                    else
                        hi = mid - 1;
                }
                const int64_t k = lo;
                if (k > 0) {
                    uint8_t* xb = s.xbuf.data();
                    std::memcpy(xb, s.hist.data(), s.hist.size());
                    int64_t xi = K - 1;
                    span_copy(reinterpret_cast<const uint8_t*>(in.buf), in.cap,
                              in.tails[ci], xb, 0, xi, k, isz_in);
                    const int64_t total = s.rs_total + k;
                    const int64_t m_hi = resample_m_hi(total, I, D);
                    const int64_t mcount = m_hi - s.rs_m;
                    const float* poly =
                        reinterpret_cast<const float*>(st[i].data);
                    const float* xf = reinterpret_cast<const float*>(xb);
                    float* yb = reinterpret_cast<float*>(s.ybuf.data());
                    // abs index of xbuf[0] is rs_total − (K−1); windows never
                    // reach below it (n_m ≥ rs_total for the first pending
                    // output by m_hi's construction — the virtual-zero region
                    // is the zeroed history prefix)
                    const int64_t base = s.rs_total - (K - 1);
                    for (int64_t j = 0; j < mcount; ++j) {
                        const int64_t mj = s.rs_m + j;
                        const int64_t pos = (mj * D) / I - base;
                        const float* row = poly + ((mj * D) % I) * K;
                        if (cx) {
                            float ar = 0.0f, ai = 0.0f;
                            for (int64_t t = 0; t < K; ++t) {
                                ar += row[t] * xf[2 * (pos - t)];
                                ai += row[t] * xf[2 * (pos - t) + 1];
                            }
                            yb[2 * j] = ar;
                            yb[2 * j + 1] = ai;
                        } else {
                            float a = 0.0f;
                            for (int64_t t = 0; t < K; ++t)
                                a += row[t] * xf[pos - t];
                            yb[j] = a;
                        }
                    }
                    s.rs_m = m_hi;
                    s.rs_total = total;
                    std::memcpy(s.hist.data(), xb + k * isz_in, s.hist.size());
                    int64_t yi = 0;
                    span_copy(s.ybuf.data(), 0, yi,
                              reinterpret_cast<uint8_t*>(out.buf), out.cap,
                              out.head, mcount, st[i].isz_out);
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += mcount;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0) {
                    out.eos = true;
                    done[i] = true;
                    in.release(ci);
                }
                continue;
            }
            if (st[i].kind == FC_DELAY) {
                StageState& s = ss[i];
                // 1. flush leading zero padding (delay.rs Pad state)
                if (s.rs_m > 0) {
                    int64_t k = out.space() < s.rs_m ? out.space() : s.rs_m;
                    if (k > 0 && per_calls) per_calls[i] += 1;
                    while (k > 0) {
                        const int64_t off = out.head % out.cap;
                        int64_t c = out.cap - off < k ? out.cap - off : k;
                        std::memset(out.buf + off * out.isz, 0,
                                    static_cast<size_t>(c * out.isz));
                        out.head += c;
                        s.rs_m -= c;
                        k -= c;
                        progress = true;
                        if (per_out) per_out[i] += c;
                    }
                }
                // 2. drop leading inputs (negative delay)
                if (s.rs_total > 0 && in.count(ci) > 0) {
                    int64_t k = in.count(ci) < s.rs_total ? in.count(ci)
                                                        : s.rs_total;
                    in.tails[ci] += k;
                    s.rs_total -= k;
                    progress = true;
                    if (per_in) per_in[i] += k;
                }
                // 3. 1:1 copy
                int64_t k = in.count(ci);
                if (out.space() < k) k = out.space();
                if (k > 0) {
                    ring_copy(in, ci, out, k);
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += k;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0 && s.rs_m == 0) {
                    out.eos = true;   // pad must flush before EOS, like the
                    done[i] = true;   // actor's `_pad == 0` finish condition
                    in.release(ci);
                }
                continue;
            }
            if (st[i].kind == FC_AGC) {
                StageState& s = ss[i];
                int64_t k = in.count(ci);
                if (out.space() < k) k = out.space();
                if (k > 0) {
                    double* pr = reinterpret_cast<double*>(st[i].data);
                    // FLOAT32 feedback, exactly like the actor loop under
                    // NumPy 2 weak promotion: mag(f32)*g makes every update
                    // f32 there, so the sequential gain trajectory is f32 —
                    // double here would drift from the actor path's values
                    const float ref = static_cast<float>(pr[0]);
                    const float rate = static_cast<float>(pr[1]);
                    const float mg = static_cast<float>(pr[2]);
                    const bool cx = st[i].p0 != 0;
                    const float* rb = reinterpret_cast<const float*>(in.buf);
                    float* yb = reinterpret_cast<float*>(s.ybuf.data());
                    float g = static_cast<float>(s.agc_gain);
                    for (int64_t j = 0; j < k; ++j) {
                        const int64_t off = (in.tails[ci] + j) % in.cap;
                        // |x| like np.abs: hypotf for complex64, fabsf real
                        float mag;
                        if (cx) {
                            const float xr = rb[2 * off], xi = rb[2 * off + 1];
                            mag = hypotf(xr, xi);
                            // output multiply in f64 like numpy's
                            // gains(f64-array) * complex64 → complex128 → f32
                            yb[2 * j] = static_cast<float>(
                                static_cast<double>(g) * xr);
                            yb[2 * j + 1] = static_cast<float>(
                                static_cast<double>(g) * xi);
                        } else {
                            const float xr = rb[off];
                            mag = fabsf(xr);
                            yb[j] = static_cast<float>(
                                static_cast<double>(g) * xr);
                        }
                        g += rate * (ref - mag * g);
                        if (g < 0.0f) g = 0.0f;
                        if (g > mg) g = mg;
                    }
                    s.agc_gain = g;
                    pr[3] = g;          // live gain, read back by Python
                    in.tails[ci] += k;
                    int64_t yi = 0;
                    span_copy(s.ybuf.data(), 0, yi,
                              reinterpret_cast<uint8_t*>(out.buf), out.cap,
                              out.head, k, out.isz);
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += k;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0) {
                    out.eos = true;
                    done[i] = true;
                    in.release(ci);
                }
                continue;
            }

            if (st[i].kind == FC_THROTTLE) {
                // wall-clock pacing, the actor Throttle's exact budget math
                // (blocks/stream.py:94-106): budget = elapsed·rate − sent.
                // The anchor starts at the first pass, like the actor's
                // first work() call.
                StageState& s = ss[i];
                const double now = mono_seconds();
                if (s.thr_t0 < 0.0) {
                    s.thr_t0 = now;
                    s.thr_sent = 0;
                }
                // the elapsed·rate draw in double first: a finite-but-huge
                // rate (1e19) would overflow the int64 cast (UB → INT64_MIN
                // on x86) and freeze the loop in a permanent throttled sleep;
                // clamp far above any real budget instead
                const double draw = (now - s.thr_t0) * st[i].f0;
                int64_t budget =
                    (draw >= 4.0e18 ? (int64_t)4000000000000000000LL
                                    : static_cast<int64_t>(draw)) -
                    s.thr_sent;
                if (budget < 0) budget = 0;
                int64_t k = in.count(ci);
                if (out.space() < k) k = out.space();
                const bool starved_by_rate = k > budget;
                if (k > budget) k = budget;
                if (k > 0) {
                    ring_copy(in, ci, out, k);
                    s.thr_sent += k;
                    progress = true;
                    if (per_in) per_in[i] += k;
                    if (per_out) per_out[i] += k;
                    if (per_calls) per_calls[i] += 1;
                }
                if (in.eos && in.count(ci) == 0) {
                    out.eos = true;
                    done[i] = true;
                    in.release(ci);
                } else if (starved_by_rate) {
                    throttled = true;   // pacing, not a stall
                }
                continue;
            }

            // ---- copy-class middle stages ----------------------------------
            int64_t k = in.count(ci);
            if (out.space() < k) k = out.space();
            if (st[i].kind == FC_HEAD) {
                if (head_left[i] < k) k = head_left[i];
            } else if (st[i].kind == FC_COPY_RAND && k > 0) {
                int64_t cap = 1 + static_cast<int64_t>(
                    xs(rng[i]) % static_cast<uint64_t>(st[i].p0));
                if (cap < k) k = cap;
            }
            if (k > 0) {
                ring_copy(in, ci, out, k);
                progress = true;
                if (per_in) per_in[i] += k;
                if (per_out) per_out[i] += k;
                if (per_calls) per_calls[i] += 1;
                if (st[i].kind == FC_HEAD) head_left[i] -= k;
            }
            bool upstream_over = in.eos && in.count(ci) == 0;
            if (upstream_over || (st[i].kind == FC_HEAD && head_left[i] == 0)) {
                out.eos = true;
                done[i] = true;
                in.release(ci);
            }
        }
        if (!progress && sinks_left > 0) {
            if (throttled) {
                // every idle stage is waiting on a throttle's clock: sleep a
                // beat instead of spinning the core or mis-reporting a stall
                struct timespec ts = {0, 200 * 1000};   // 200 µs
                nanosleep(&ts, nullptr);
                continue;
            }
            // single-threaded chains always progress unless malformed; never spin
            for (auto& r : rings) std::free(r.buf);
            return -1;
        }
    }

    for (auto& r : rings) std::free(r.buf);
    int64_t total = 0;
    for (int i = 0; i < n; ++i) total += snk_items[i];
    return total;
}

}  // namespace

extern "C" {

// ABI version, checked by fastchain.py's _load(): bump on ANY FcStage layout
// or protocol change so a stale .so can never be driven with a newer struct.
int64_t fsdr_fastchain_abi(void) { return 9; }

// 1 where the AVX-512 FIR kernels were compiled in (__AVX512F__), else 0:
// the scalar and auto-vectorized paths then run every FIR stage.
int64_t fsdr_fastchain_avx512(void) {
#ifdef __AVX512F__
    return 1;
#else
    return 0;
#endif
}

// v2 entry: a linear chain (stage i consumes stage i-1's ring).
int64_t fsdr_fastchain_run_v2(const FcStage* st, int32_t n, int64_t ring_items,
                              volatile int32_t* stop, int64_t* per_in,
                              int64_t* per_out, int64_t* per_calls) {
    if (n < 2) return -1;
    std::vector<int32_t> inr(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) inr[static_cast<size_t>(i)] = i - 1;
    return fc_run_core(st, n, inr.data(), ring_items, stop, per_in, per_out,
                       per_calls, nullptr);
}

// v3 entry: a tree — in_ring[i] names the stage whose output ring stage i
// consumes (-1 for the single source at index 0; stages in topological
// order). Rings with several consumers broadcast: every consumer sees every
// item (the 1-writer→N-reader semantics of the actor runtime's port groups).
// per_ns (nullable): per-stage busy-time accumulation in nanoseconds — every
// scheduling pass of a live stage is attributed, productive or not, so the
// sum across stages approaches the driver thread's wall time.
int64_t fsdr_fastchain_run_v3(const FcStage* st, int32_t n,
                              const int32_t* in_ring, int64_t ring_items,
                              volatile int32_t* stop, int64_t* per_in,
                              int64_t* per_out, int64_t* per_calls,
                              int64_t* per_ns) {
    return fc_run_core(st, n, in_ring, ring_items, stop, per_in, per_out,
                       per_calls, per_ns);
}

}  // extern "C"
