// Soft-decision Viterbi for the IEEE 802.11 rate-1/2 mother code (K=7,
// g0=0133, g1=0171): the host route of models/wlan/coding.py viterbi_decode.
//
// The port's copy of native/viterbi.cpp, built with g++ on first use by
// ops/_build.py (load_host) and bound with ctypes. Branch metrics from two
// LLRs, add-compare-select over the 64 states a step, per-step decision
// bytes, traceback from state 0 (terminated trellis). Bit-matches the numpy
// trellis: ties go to candidate 0 (numpy argmax keeps the FIRST maximum).

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kNStates = 64;
constexpr uint32_t kG0 = 0133;   // octal, per 802.11 Clause 17.3.5.6
constexpr uint32_t kG1 = 0171;

struct Tables {
    // prev_s[s][j]: predecessor state for new state s via candidate j
    // prev_b[s][j]: the INPUT BIT that caused that transition
    // bm0/bm1[s][j]: +-1 weights multiplying llr0/llr1 for that branch
    int8_t prev_b[kNStates][2];
    uint8_t prev_s[kNStates][2];
    float bm0[kNStates][2];
    float bm1[kNStates][2];
};

int parity(uint32_t v) {
    return __builtin_parity(v);
}

// Mirrors models/wlan/coding.py exactly: shift register reg = (bit << 6) |
// state with the NEWEST input at the MSB, next_state = reg >> 1 = (bit << 5) |
// (state >> 1). Hence next-state t has TWO predecessors 2*(t & 31) and
// 2*(t & 31) + 1, both reached by the SAME input bit t >> 5; coding.py's
// _build_prev_tables appends them in increasing state order, so candidate
// j == 0 is the even predecessor (numpy argmax breaks ties toward it).
Tables build_tables() {
    Tables t{};
    for (int next = 0; next < kNStates; ++next) {
        const int bit = next >> 5;
        for (int j = 0; j < 2; ++j) {
            const int state = 2 * (next & 0x1f) + j;
            const uint32_t reg =
                (static_cast<uint32_t>(bit) << 6) | static_cast<uint32_t>(state);
            t.prev_s[next][j] = static_cast<uint8_t>(state);
            t.prev_b[next][j] = static_cast<int8_t>(bit);
            // LLR convention: positive => bit 1, so a branch emitting output
            // bit o adds +llr when o==1 and -llr when o==0
            t.bm0[next][j] = parity(reg & kG0) ? 1.0f : -1.0f;
            t.bm1[next][j] = parity(reg & kG1) ? 1.0f : -1.0f;
        }
    }
    return t;
}

const Tables &tables() {
    static const Tables t = build_tables();
    return t;
}

}  // namespace

extern "C" {

// Decode n_steps trellis steps from llrs[2*n_steps] (double, matching the
// numpy path's float64 metrics); writes n_steps bits to out. Traceback starts
// at state 0 (tail-flushed). Returns 0 on success.
int fsdr_viterbi_k7(const double *llrs, int64_t n_steps, uint8_t *out) {
    if (n_steps <= 0) return -1;
    const Tables &t = tables();

    std::vector<double> metrics(kNStates, -1e18);
    std::vector<double> next(kNStates);
    metrics[0] = 0.0;
    std::vector<uint8_t> decisions(static_cast<size_t>(n_steps) * kNStates);
    std::vector<uint8_t> src(static_cast<size_t>(n_steps) * kNStates);

    for (int64_t step = 0; step < n_steps; ++step) {
        const double l0 = llrs[2 * step];
        const double l1 = llrs[2 * step + 1];
        uint8_t *dec = &decisions[static_cast<size_t>(step) * kNStates];
        uint8_t *sr = &src[static_cast<size_t>(step) * kNStates];
        for (int s = 0; s < kNStates; ++s) {
            const double c0 = metrics[t.prev_s[s][0]]
                + t.bm0[s][0] * l0 + t.bm1[s][0] * l1;
            const double c1 = metrics[t.prev_s[s][1]]
                + t.bm0[s][1] * l0 + t.bm1[s][1] * l1;
            // numpy argmax keeps the FIRST max on ties — use strict > for c1
            const int j = (c1 > c0) ? 1 : 0;
            next[s] = j ? c1 : c0;
            sr[s] = t.prev_s[s][j];
            dec[s] = static_cast<uint8_t>(t.prev_b[s][j]);
        }
        metrics.swap(next);
    }

    int state = 0;
    for (int64_t step = n_steps - 1; step >= 0; --step) {
        out[step] = decisions[static_cast<size_t>(step) * kNStates + state];
        state = src[static_cast<size_t>(step) * kNStates + state];
    }
    return 0;
}

}  // extern "C"
