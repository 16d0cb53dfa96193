// Mueller-Müller symbol timing recovery — the per-symbol adaptation loop.
//
// The MM control loop is inherently sequential (each recovered symbol updates the
// timing phase/rate used for the next), so it cannot vectorize; the reference runs
// it as compiled Rust (examples/zigbee/src/clock_recovery_mm.rs). This is the same
// loop as blocks/dsp.py::ClockRecoveryMm's Python fallback, bit-matched (double
// state, float32 stream), exported with a C ABI for the ctypes binding.
//
// The port's copy of native/mm.cpp, built with g++ -ffp-contract=off on first
// use by ops/_build.py (load_host): contracting a*b+c into an FMA would break
// the bit-equality with the Python loop by an ulp.

#include <cmath>
#include <cstdint>

extern "C" {

struct fsdr_mm_state {
    double omega;      // current samples/symbol estimate
    double omega0;     // nominal samples/symbol
    double mu;         // fractional sample phase in [0, 1)
    double last;       // previous interpolant s[k-1]
    double last_d;     // previous decision d[k-1]
    double gain_omega;
    double gain_mu;
    double limit;      // omega adaptation bound (fraction of omega0)
};

// Consume from in[0..n_in), producing at most max_out symbols. Returns the number
// of symbols produced; *consumed receives the number of input samples consumed.
// State is updated in place so successive calls continue the stream seamlessly.
//
// Arithmetic is float32 throughout, mirroring the Python loop under NEP 50: numpy
// weak promotion keeps every intermediate (interpolant, error, omega, mu) at the
// stream's float32 precision, and bit-matching the fallback is what makes the
// native path a drop-in (the golden tests pin these exact trajectories).
int64_t fsdr_mm_work(const float *in, int64_t n_in, float *out, int64_t max_out,
                     fsdr_mm_state *st, int64_t *consumed) {
    const int64_t need =
        static_cast<int64_t>(std::ceil(st->omega * (1.0 + st->limit))) + 2;
    int64_t i = 0, n_out = 0;
    float mu = static_cast<float>(st->mu);
    float omega = static_cast<float>(st->omega);
    float last = static_cast<float>(st->last);
    float last_d = static_cast<float>(st->last_d);
    const float gain_omega = static_cast<float>(st->gain_omega);
    const float gain_mu = static_cast<float>(st->gain_mu);
    const float lo = static_cast<float>(st->omega0 * (1.0 - st->limit));
    const float hi = static_cast<float>(st->omega0 * (1.0 + st->limit));
    while (i + need < n_in && n_out < max_out) {
        const float s = in[i] * (1.0f - mu) + in[i + 1] * mu;
        const float d = s > 0.0f ? 1.0f : -1.0f;
        const float err = last_d * s - d * last;
        last = s;
        last_d = d;
        out[n_out++] = s;
        omega += gain_omega * err;
        omega = omega < lo ? lo : (omega > hi ? hi : omega);
        const float step = omega + gain_mu * err;
        const float pos = (static_cast<float>(i) + mu) + step;
        i = static_cast<int64_t>(pos);
        mu = pos - static_cast<float>(i);
    }
    st->mu = mu;
    st->omega = omega;
    st->last = last;
    st->last_d = last_d;
    *consumed = i;
    return n_out;
}

}  // extern "C"
