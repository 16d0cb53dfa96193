// Folded symmetric FIR with valignd tap groups — the port's copy of
// native/fir_valign.h, included by fastchain.cpp (the reference shares it
// with its microbench, native/bench_fir.cpp).
//
// The plain folded kernel walks its two loadu windows one float per tap, so
// 15 of every 16 issues split a cache line and the load ports replay — port
// math says ~2 cycles/output but it measures ~4.2. Here each side's 32-float
// window is loaded ONCE per 16-float tap group and the 16 shifted views are
// synthesized with register alignment (valignd) ops; the FMA unit becomes
// the binding port. Measured +14-21% on a quiet machine across 32-256 taps,
// both strides (bench_fir sweep). Remainder taps (h % group) take the loadu
// step in the SAME ascending-k per-lane order, so output is bit-identical to
// the plain folded kernel for every tap count.
//
// Contract: textual include under __AVX512F__ only, AFTER <immintrin.h> and
// <cstdint> — the includer controls the enclosing namespace (fastchain.cpp
// pulls it into its anonymous namespace), so this header includes nothing.
#ifndef FSDR_FIR_VALIGN_H
#define FSDR_FIR_VALIGN_H

// concat[lo:hi][IMM + i] for i in [0,16). gcc12's _mm512_alignr_epi32 passes
// _mm512_undefined_epi32() as the masked-blend fallback operand, which
// -Wmaybe-uninitialized flags at every inlined instantiation — a known
// header false positive, suppressed here.
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
template <int IMM>
static inline __m512 fc_pair_view(__m512 lo, __m512 hi) {
    return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(hi), _mm512_castps_si512(lo), IMM));
}
#pragma GCC diagnostic pop

// One tap inside a group: the xa side descends S floats per tap from ha's
// base (la:ha covers [base-16, base+16)); the xb side ascends S floats per
// tap from lb's base (lb:hb covers [base2, base2+32)). IMM must be a
// compile-time constant, so the group is unrolled by template recursion.
template <int K, int G, int S>
struct FcTapG {
    static inline void run(const float* tp, __m512 la, __m512 ha, __m512 lb,
                           __m512 hb, __m512& acc) {
        const __m512 c = _mm512_set1_ps(tp[K]);
        __m512 va, vb;
        if constexpr (K == 0) {        // if constexpr: the alignr expansion in
            va = ha;                   // the dead branch trips gcc12's
            vb = lb;                   // -Wmaybe-uninitialized
        } else {
            va = fc_pair_view<(16 - K * S) & 15>(la, ha);
            vb = fc_pair_view<(K * S) & 15>(lb, hb);
        }
        acc = _mm512_fmadd_ps(c, _mm512_add_ps(va, vb), acc);
        FcTapG<K + 1, G, S>::run(tp, la, ha, lb, hb, acc);
    }
};
template <int G, int S>
struct FcTapG<G, G, S> {
    static inline void run(const float*, __m512, __m512, __m512, __m512,
                           __m512&) {}
};

// S = float stride (1 = f32 stream, 2 = interleaved c64 with real taps);
// group size G = 16/S taps spans exactly one register width per side.
template <int S>
inline void fir_sym_valign(const float* x, const float* taps, int64_t nt,
                           float* y, int64_t nf) {
    constexpr int G = 16 / S;
    const int64_t h = nt / 2;
    const int64_t Ls = (nt - 1) * S;
    const int64_t hg = (h / G) * G;
    int64_t j0 = 0;
    for (; j0 + 64 <= nf; j0 += 64) {
        __m512 acc[4] = {_mm512_setzero_ps(), _mm512_setzero_ps(),
                         _mm512_setzero_ps(), _mm512_setzero_ps()};
        for (int64_t g = 0; g < hg; g += G) {
            const float* pa = x + j0 - g * S;
            const float* pb = x + j0 - Ls + g * S;
            for (int r = 0; r < 4; ++r) {
                const __m512 la = _mm512_loadu_ps(pa + 16 * r - 16);
                const __m512 ha = _mm512_loadu_ps(pa + 16 * r);
                const __m512 lb = _mm512_loadu_ps(pb + 16 * r);
                const __m512 hb = _mm512_loadu_ps(pb + 16 * r + 16);
                FcTapG<0, G, S>::run(taps + g, la, ha, lb, hb, acc[r]);
            }
        }
        for (int64_t k = hg; k < h; ++k) {            // remainder taps
            const float* xa = x + j0 - k * S;
            const float* xb = x + j0 - Ls + k * S;
            const __m512 c = _mm512_set1_ps(taps[k]);
            for (int r = 0; r < 4; ++r)
                acc[r] = _mm512_fmadd_ps(
                    c,
                    _mm512_add_ps(_mm512_loadu_ps(xa + 16 * r),
                                  _mm512_loadu_ps(xb + 16 * r)),
                    acc[r]);
        }
        for (int r = 0; r < 4; ++r) _mm512_storeu_ps(y + j0 + 16 * r, acc[r]);
    }
    for (; j0 < nf; ++j0) {
        float s = 0;
        for (int64_t k = 0; k < h; ++k)
            s += taps[k] * (x[j0 - k * S] + x[j0 - Ls + k * S]);
        y[j0] = s;
    }
}

#endif  // FSDR_FIR_VALIGN_H
