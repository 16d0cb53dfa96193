"""IEEE 802.15.4 (ZigBee) O-QPSK PHY, 2.4 GHz DSSS.

Re-design of the reference ZigBee example (``examples/zigbee/src/``: O-QPSK ``modulator``,
``ClockRecoveryMm``, ``Demodulator``, ``Mac``): 4-bit symbols spread to 32-chip PN
sequences, O-QPSK with half-sine shaping (MSK-equivalent), demodulated by quadrature
discriminator → clock recovery → chip correlation. Frame-level and vectorized.
The port's copy of ``futuresdr_tpu/models/zigbee/phy.py``, its arithmetic unchanged.
Where it departs: the demodulators return the PSDUs in time order, where the
reference returns its search's order (the sample phases, or the two
Mueller-Müller starts, one after the other); and a PSDU equal to another is
another frame where it lies apart from it (:func:`same_frame_span`), where the
reference keeps one of equal PSDUs (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["CHIP_SEQUENCES", "modulate_frame", "demodulate_stream", "demodulate_stream_at",
           "same_frame_span", "mac_frame", "mac_deframe", "crc16_802154",
           "SAMPLES_PER_CHIP"]

SAMPLES_PER_CHIP = 4

# base PN sequence for symbol 0 (Clause 12.2.4, 2.4 GHz band)
_BASE = np.array([1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1,
                  0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0], dtype=np.uint8)


def _chip_table() -> np.ndarray:
    table = np.zeros((16, 32), dtype=np.uint8)
    for s in range(8):
        table[s] = np.roll(_BASE, 4 * s)
    # symbols 8..15: invert the odd-indexed (Q) chips of symbols 0..7
    for s in range(8):
        t = table[s].copy()
        t[1::2] ^= 1
        table[s + 8] = t
    return table


CHIP_SEQUENCES = _chip_table()


def _oqpsk_modulate(chips: np.ndarray, sps_chip: int = SAMPLES_PER_CHIP) -> np.ndarray:
    """Chips → O-QPSK baseband with half-sine shaping; even chips on I, odd on Q,
    Q delayed by half a chip-pair (MSK-style)."""
    bits = chips.astype(np.float64) * 2 - 1
    i_bits = bits[0::2]
    q_bits = bits[1::2]
    T = 2 * sps_chip                      # one I (or Q) bit spans 2 chip periods
    n = len(chips) * sps_chip + T // 2
    t = np.arange(T) / T
    pulse = np.sin(np.pi * t)             # half-sine over the bit duration
    i_wave = np.zeros(n)
    q_wave = np.zeros(n)
    for k, b in enumerate(i_bits):
        i_wave[k * T:(k + 1) * T] += b * pulse
    for k, b in enumerate(q_bits):
        q_wave[k * T + T // 2:(k + 1) * T + T // 2] += b * pulse
    return (i_wave + 1j * q_wave).astype(np.complex64)


def crc16_802154(data: bytes) -> int:
    """CRC-16/CCITT with bit-reversed (LSB-first) processing (Clause 7.2.10)."""
    crc = 0x0000
    for byte in data:
        for bit in range(8):
            b = (byte >> bit) & 1
            c = (crc ^ b) & 1
            crc >>= 1
            if c:
                crc ^= 0x8408
    return crc


def mac_frame(payload: bytes, seq: int = 0) -> bytes:
    """Minimal data MPDU: FC(2) seq(1) payload FCS(2)."""
    hdr = bytes([0x41, 0x88, seq & 0xFF])
    body = hdr + payload
    fcs = crc16_802154(body)
    return body + bytes([fcs & 0xFF, fcs >> 8])


def mac_deframe(mpdu: bytes) -> Optional[bytes]:
    if len(mpdu) < 5:
        return None
    body, fcs = mpdu[:-2], mpdu[-2:]
    if crc16_802154(body) != (fcs[0] | (fcs[1] << 8)):
        return None
    return body[3:]


def modulate_frame(psdu: bytes, sps_chip: int = SAMPLES_PER_CHIP) -> np.ndarray:
    """PPDU = preamble (4×0x00) + SFD (0xA7) + length + PSDU, spread and modulated."""
    ppdu = bytes(4) + bytes([0xA7, len(psdu)]) + psdu
    nibbles = []
    for byte in ppdu:
        nibbles += [byte & 0xF, byte >> 4]
    chips = np.concatenate([CHIP_SEQUENCES[nb] for nb in nibbles])
    return _oqpsk_modulate(chips, sps_chip)


def mm_energy_gate(energy: np.ndarray) -> float:
    """Burst/noise decision level for the MM loop, robust to ANY burst duty
    cycle. The low tail estimates the noise floor: for Rayleigh noise
    q10 ≈ 0.459σ, so 1.6·(q10/0.459) sits ABOVE the noise-block mean
    (≈1.25σ) with margin, and far below any usable-SNR burst. Two failure
    regimes bound it: an (almost-)all-signal capture inflates the
    q10-derived floor toward the signal level — the 0.5·q99.9 cap keeps the
    gate under the burst so adaptation still runs; a capture that is pure
    noise has q99.9 = σ·√(2·ln 1000) ≈ 3.72σ, cap ≈1.86σ > the 1.6σ floor,
    so the floor term wins and (most) noise blocks freeze. (The first cut
    used gmean(q10, q90), which collapses onto ≈σ — BELOW the noise-block
    mean — whenever the burst covers <10% of the capture; a direct
    simulation showed it.)"""
    q10, q999 = np.quantile(energy, (0.1, 0.999))
    return float(min(1.6 * max(q10, 1e-12) / 0.459,
                     0.5 * max(q999, 1e-12)))


def _mm_clock_recovery(x: np.ndarray, sps: float, mu0: float = 0.5,
                       gain_step: float = 0.002, gain_phase: float = 0.15,
                       block: int = 32,
                       energy: Optional[np.ndarray] = None,
                       e_gate: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Mueller-Müller timing recovery, block-vectorized
    (`ClockRecoveryMm` block, `examples/zigbee/src/clock_recovery_mm.rs` role).

    The reference's per-sample loop adapts timing every symbol — inherently
    sequential and ~50× too slow in Python for the 4 Mchip/s real-time rate. Like the
    block-floating AGC (`ops/stages.py agc_stage`), the control loop here runs at
    ``block``-symbol granularity: within a block the timing step is frozen, so all
    ``block`` interpolants are one vectorized gather+lerp; the MM error aggregated
    over the block then updates the step (clock-rate estimate) and nudges the phase
    once. Converges like the per-sample loop with a ``block``-symbol control delay —
    drift within one block is ≪ a sample for any realistic clock (±100 ppm × 32
    symbols × 4 sps ≈ 0.01 samples).

    ``energy`` (optional, aligned with ``x``): per-sample signal magnitude.
    When given, blocks whose mean magnitude sits below the capture's
    burst/noise decision level FREEZE the loop (no step/phase adaptation):
    on a noise-only prefix the discriminator angles are random, and letting
    them drag the clock estimate before the burst arrives occasionally
    wrecked acquisition entirely — the r5 campaign's fourth finding (batch
    12, offset 2112168: one σ=0.05 draw where the MM path returned zero
    candidates while phase/coherent both recovered the frame).

    Returns the interpolants and the position in ``x`` of each.
    """
    n = len(x)
    if energy is not None and e_gate is None:
        e_gate = mm_energy_gate(energy)
    out_parts, at_parts = [], []
    pos = mu0
    step = float(sps)
    prev_s = 0.0
    prev_d = 0.0
    lo, hi = sps * 0.9, sps * 1.1
    while True:
        # final partial block: shrink so the stream tail is still despread (the
        # per-sample loop only lost ~sps samples; losing a whole block would drop
        # the last chips of a frame ending at the capture edge)
        blk = block
        while blk > 0 and pos + step * blk + 2 >= n:
            blk = int((n - 2 - pos) / step)
        if blk <= 0:
            break
        t = pos + step * np.arange(blk)
        i = t.astype(np.int64)
        frac = t - i
        s = x[i] * (1.0 - frac) + x[i + 1] * frac          # vectorized lerp
        d = np.sign(s)
        if energy is not None and float(np.mean(energy[i])) < e_gate:
            err = 0.0                     # noise-only block: hold the clock
        else:
            # MM error over the block incl. the boundary pair with the
            # previous block
            sl = np.concatenate(([prev_s], s))
            dl = np.concatenate(([prev_d], d))
            err = float(np.mean(dl[:-1] * sl[1:] - dl[1:] * sl[:-1]))
        out_parts.append(s)
        at_parts.append(t)
        prev_s, prev_d = float(s[-1]), float(d[-1])
        step = min(max(sps + gain_step * err * sps, lo), hi)
        pos = t[-1] + step + gain_phase * err              # phase nudge
    if not out_parts:
        return np.zeros(0, dtype=x.dtype), np.zeros(0)
    return np.concatenate(out_parts), np.concatenate(at_parts)


def _freq_templates(sps_chip: int = SAMPLES_PER_CHIP) -> np.ndarray:
    """Per-symbol discriminator templates: the O-QPSK half-sine chips pass through the
    quadrature discriminator as an MSK frequency sequence with one-chip memory, so we
    derive each symbol's expected per-chip frequency signature by running the modulator
    + discriminator once at init (the reference's demodulator bakes the equivalent
    lookup into its chip correlator)."""
    templates = np.zeros((16, 32), dtype=np.float64)
    for s in range(16):
        # surround with itself to give stable boundary context, take the middle copy
        chips = np.tile(CHIP_SEQUENCES[s], 3)
        sig = _oqpsk_modulate(chips, sps_chip)
        freq = np.angle(sig[1:] * np.conj(sig[:-1]))
        per_chip = freq[:len(chips) * sps_chip - 1]
        pc = np.add.reduceat(per_chip, np.arange(0, len(per_chip), sps_chip)) / sps_chip
        templates[s] = np.sign(pc[32:64])
    return templates


_FREQ_TEMPLATES = _freq_templates()


def same_frame_span(psdu: bytes, sps_chip: int = SAMPLES_PER_CHIP) -> int:
    """Samples within which two findings of ``psdu`` are one frame: half its
    burst (SHR, PHR and PSDU). Two transmissions of the same PSDU lie a whole
    burst apart at least, while the sample phases and Mueller-Müller starts
    of one search find a frame within a few chips of each other."""
    return (10 + 2 + 2 * len(psdu)) * 32 * sps_chip // 2


def _is_new(frames: List[Tuple[float, bytes]], at: float, psdu: bytes,
            sps_chip: int = SAMPLES_PER_CHIP) -> bool:
    """Whether ``psdu`` found at sample ``at`` is not a frame ``frames`` has.

    Where the port departs from the reference: the reference drops a PSDU
    equal to one found anywhere in the window, so a frame sent again (a MAC
    retransmission carries the same bytes) that lands in the same window is
    lost; here an equal PSDU counts as the same frame only near the same
    place (ROADMAP Queue 3)."""
    span = same_frame_span(psdu, sps_chip)
    return all(psdu != f or abs(at - p) >= span for p, f in frames)


def _scan_soft_chips(soft: np.ndarray, frames: List[Tuple[float, bytes]],
                     at: np.ndarray, sps_chip: int = SAMPLES_PER_CHIP) -> None:
    """Sliding SFD correlation + despread over one chip-rate soft stream;
    appends each new PSDU with the sample position of its SFD (``at``: each
    soft chip's sample position)."""
    if len(soft) < 96:
        return
    # SFD = nibbles 7 then A (0xA7 LSB-nibble first)
    sfd_t = np.concatenate([_FREQ_TEMPLATES[0x7], _FREQ_TEMPLATES[0xA]])
    corr = np.correlate(soft.astype(np.float32), sfd_t.astype(np.float32), mode="valid")
    thresh = 0.72 * len(sfd_t)
    cand = np.flatnonzero(corr >= thresh)
    next_free = -1
    for i in cand:
        if i < next_free:
            continue
        start = i + len(sfd_t)
        psdu = _despread_from(soft, start)
        if psdu is not None and _is_new(frames, float(at[i]), psdu, sps_chip):
            frames.append((float(at[i]), psdu))
            next_free = start + 64
    return


_PM_CHIPS = (CHIP_SEQUENCES.astype(np.float64) * 2 - 1)      # ±1 chip tables


def _shr_template(sps_chip: int = SAMPLES_PER_CHIP) -> np.ndarray:
    """Complex baseband of the SHR (8 zero preamble nibbles + SFD 0xA7)."""
    nibs = [0] * 8 + [0x7, 0xA]
    chips = np.concatenate([CHIP_SEQUENCES[n] for n in nibs])
    return _oqpsk_modulate(chips, sps_chip)[:len(chips) * sps_chip]


def demodulate_coherent(samples: np.ndarray,
                        sps_chip: int = SAMPLES_PER_CHIP) -> List[bytes]:
    """The PSDUs of :func:`demodulate_coherent_at`, in the order of their
    place in ``samples``."""
    return [psdu for _, psdu in demodulate_coherent_at(samples, sps_chip)]


def demodulate_coherent_at(samples: np.ndarray,
                           sps_chip: int = SAMPLES_PER_CHIP) -> List[Tuple[float, bytes]]:
    """Coherent O-QPSK RX — beyond the reference's discriminator architecture.

    Burst-synchronized matched reception: complex cross-correlation against the
    known SHR gives sample timing; the correlation split in halves gives CFO
    (phase slope) and absolute carrier phase, so chips are COHERENT I/Q decisions
    at the half-sine pulse peaks (no ISI there by construction) despread against
    the ±1 PN tables — worth ~2-3 dB of sensitivity over the discriminator path,
    which squares the noise.
    """
    tmpl = _shr_template(sps_chip)
    L = len(tmpl)
    if len(samples) < L + 64 * sps_chip:
        return []
    # CFO decoheres a full-length complex correlation (5 rad across the SHR at
    # 0.004 rad/sample), so DETECTION combines four template segments
    # non-coherently; the segment phase slope then estimates CFO with a pull-in
    # range of ±pi/(L/4) rad/sample. Beyond that range use the discriminator
    # paths, which are CFO-insensitive by construction.
    n_seg = 4
    seg = L // n_seg
    segs = [tmpl[k * seg:(k + 1) * seg].astype(np.complex64) for k in range(n_seg)]
    n_lag = len(samples) - L + 1
    m_lag = (n_lag + 1) // 2
    # FFT overlap-add correlation at complex64, EVEN lags only via the polyphase
    # split (corr[2m] = conv(x_even, t_even) + conv(x_odd, t_odd)) — the
    # time-domain form is O(N·L) and falls below the 8 Msps stream rate
    # (2 Mchip/s × 4 sps) with four 320-tap segments, and a one-sample timing
    # offset from stride-2 detection costs <2% at the half-sine peak
    from scipy.signal import oaconvolve

    def corr_even(k):
        y = samples[k * seg:k * seg + n_lag + seg - 1]
        t = segs[k]
        ye, yo = y[0::2], y[1::2]
        te, to = np.conj(t[0::2][::-1]), np.conj(t[1::2][::-1])
        a = oaconvolve(ye[:m_lag + len(te) - 1], te, mode="valid")[:m_lag]
        b = oaconvolve(yo[:m_lag + len(to) - 1], to, mode="valid")[:m_lag]
        n = min(len(a), len(b), m_lag)
        return a[:n] + b[:n]

    cs0 = [corr_even(k) for k in range(n_seg)]
    m_lag = min(len(c) for c in cs0)
    seg_corr = np.stack([c[:m_lag] for c in cs0])             # [n_seg, m_lag]
    e_t = float(np.sum(np.abs(tmpl) ** 2))
    p = np.concatenate([[0.0], np.cumsum(np.abs(samples) ** 2)])
    e_x = (p[L:] - p[:-L])[0::2][:m_lag]
    metric = np.abs(seg_corr).sum(axis=0) / np.sqrt(np.maximum(e_x * e_t, 1e-12))
    # energy gate (as in detect_packets): windows with ~no power can't host a
    # burst — without it, FFT numerical noise over silent spans divided by the
    # tiny denominator floor reads as ~10^6 false candidates
    floor = 1e-4 * float(e_x.max()) if len(e_x) else 0.0
    metric = np.where(e_x > floor, metric, 0.0)
    cand = np.flatnonzero(metric > 0.5)
    frames: List[Tuple[float, bytes]] = []
    T = 2 * sps_chip
    next_free = -1
    sym_len_e = 16 * sps_chip           # one symbol in even-lag units

    def chips_at(i: int, cfo: float, n_win: int):
        """Derotate ``n_win`` samples from lag ``i`` and slice the coherent chip
        decisions at the half-sine pulse peaks (I at kT+T/2, the half-chip-
        delayed Q at kT+T — abutting half-sines make the peak sample ISI-free)."""
        k = np.arange(n_win)
        x = samples[i:i + n_win] * np.exp(-1j * cfo * k)
        ph = np.angle(np.vdot(tmpl, x[:L]))      # residual carrier phase
        x = x * np.exp(-1j * ph)
        # pair k needs samples kT+T/2 (I) and kT+T (Q): max k with kT+T <= n_win-1
        n_pairs = (n_win - 1) // T
        soft = np.empty(2 * n_pairs)
        soft[0::2] = np.sign(x.real[(np.arange(n_pairs) * T) + T // 2])
        soft[1::2] = np.sign(x.imag[(np.arange(n_pairs) * T) + T])
        return soft

    for m in cand:
        if m < next_free:
            continue
        # refine across 5 symbols: the 8x-repeated zero-symbol preamble puts
        # correlation sidelobes above threshold up to ~4 symbols BEFORE the true
        # peak, and a symbol-aligned mislock despreads VALID PN nibbles into
        # consistent garbage — the (strictly larger) main peak must win
        hi = min(len(metric), m + 5 * sym_len_e)
        m = int(m + np.argmax(metric[m:hi]))
        # collapse the sidelobe cluster: every candidate before this refined peak
        # lands on the same window — one check, not hundreds of expensive ones
        next_free = max(next_free, m + 1)
        i = 2 * m                       # sample-domain lag of the refined peak
        cs = seg_corr[:, m]
        if np.min(np.abs(cs)) < 1e-9:
            continue
        # phase advances cfo·seg between successive segments
        cfo = float(np.angle(np.sum(cs[1:] * np.conj(cs[:-1])))) / seg
        if len(samples) - i < L + T:
            continue
        # Where the port departs from the reference: the even-lag detection
        # places a burst that starts on an odd sample one sample off, and with
        # no carrier tracking over the burst that costs a long frame its last
        # nibbles (a 108-byte PSDU at noise 0.1, ROADMAP Queue 3); the lag
        # beside it whose derotated SHR correlation is larger is taken instead
        rot = np.exp(-1j * cfo * np.arange(L))
        i = max((j for j in (i - 1, i, i + 1) if j >= 0 and len(samples) - j >= L + T),
                key=lambda j: abs(np.vdot(tmpl, samples[j:j + L] * rot)))
        # cheap structural lock check FIRST, on the SHR span only: the despread
        # SFD (chips 256..320) must read the nibbles 0x7, 0xA — a symbol-aligned
        # mislock reads preamble zeros there and is rejected before paying for
        # the full-burst derotation
        head = chips_at(i, cfo, L + T)
        sfd = [int(np.argmax(_PM_CHIPS @ head[p:p + 32]))
               for p in (256, 288) if len(head) >= p + 32]
        if sfd != [0x7, 0xA]:
            continue
        # burst window: SHR + length byte + max PSDU (127 B = 254 nibbles)
        n_win = min(len(samples) - i, (10 + 2 + 254) * 32 * sps_chip + T)
        soft = chips_at(i, cfo, n_win)
        # chip 0 of the burst is at sample 0; SHR spans 10 nibbles = 320 chips
        psdu = _despread_from(soft, 320, tables=_PM_CHIPS, skip_boundary=False)
        if psdu is not None:
            # advance past the burst even for a duplicate payload — otherwise
            # every above-threshold lag inside it re-refines and re-despreads
            next_free = (i + (10 + 2 + 2 * len(psdu)) * 32 * sps_chip) // 2
            if _is_new(frames, float(i), psdu, sps_chip):
                frames.append((float(i), psdu))
    return sorted(frames, key=lambda f: f[0])


def demodulate_stream(samples: np.ndarray, sps_chip: int = SAMPLES_PER_CHIP,
                      timing: str = "phase") -> List[bytes]:
    """The PSDUs of :func:`demodulate_stream_at`, in the order of their place
    in ``samples``."""
    return [psdu for _, psdu in demodulate_stream_at(samples, sps_chip, timing)]


def demodulate_stream_at(samples: np.ndarray, sps_chip: int = SAMPLES_PER_CHIP,
                         timing: str = "phase") -> List[Tuple[float, bytes]]:
    """Full RX (`demodulator.rs` role): quadrature discriminator → chip timing →
    sliding frequency-template correlation for the SFD → despread PSDUs.

    ``timing``: "phase" (default) — fully vectorized: boxcar matched filter, then try
    every integer sample phase at chip rate (sps small) and dedup; "mm" — the adaptive
    Mueller-Müller loop (`clock_recovery_mm.rs`), for drifting clocks; "coherent" —
    burst-synchronized coherent matched reception (:func:`demodulate_coherent`),
    ~2-3 dB more sensitive than the discriminator paths. Returns ``(sample
    position, psdu)`` pairs in the order of their place in ``samples``,
    whatever the mode: the SFD's position, or the burst's start in the
    coherent mode. A PSDU equal to another counts as another frame where it
    lies at least :func:`same_frame_span` samples away.
    """
    if timing == "coherent":
        return demodulate_coherent_at(samples, sps_chip)
    if len(samples) < 64 * sps_chip:
        return []
    d = samples[1:] * np.conj(samples[:-1])
    freq = np.angle(d)
    frames: List[Tuple[float, bytes]] = []
    if timing == "mm":
        # two starting phases a half chip apart: with the loop frozen during
        # the noise prefix (energy gate), the INITIAL phase persists to the
        # burst — and the MM pull-in range is about a quarter chip, so one
        # unlucky mu0 occasionally produced chips too poor for the SFD scan
        # (r5 campaign batch 13, offset 5528176: the default start failed
        # while every start ≥1.5 samples recovered the frame). One of two
        # half-chip-spaced starts is always within pull-in;
        # _scan_soft_chips dedups the PSDUs when both converge.
        en = np.abs(samples[1:])
        gate = mm_energy_gate(en)        # one quantile pass for both starts
        for mu0 in (0.5, 0.5 + sps_chip / 2.0):
            soft, at = _mm_clock_recovery(freq, sps_chip, mu0=mu0, energy=en,
                                          e_gate=gate)
            _scan_soft_chips(np.sign(soft), frames, at, sps_chip)
        return sorted(frames, key=lambda f: f[0])
    # phase search: chip-rate matched filter (boxcar over one chip) at each phase
    kernel = np.ones(sps_chip, dtype=np.float32) / sps_chip
    mf = np.convolve(freq, kernel, mode="valid")
    for phase in range(sps_chip):
        soft = np.sign(mf[phase::sps_chip])
        _scan_soft_chips(soft, frames, np.arange(phase, len(mf), sps_chip), sps_chip)
    return sorted(frames, key=lambda f: f[0])


def _despread_from(soft: np.ndarray, start: int, tables: Optional[np.ndarray] = None,
                   skip_boundary: bool = True) -> Optional[bytes]:
    if tables is None:
        tables = _FREQ_TEMPLATES

    def nibble_at(pos: int) -> Optional[int]:
        seg = soft[pos:pos + 32]
        if len(seg) < 32:
            return None
        if skip_boundary:
            # skip the boundary chip (depends on the previous symbol's last chip —
            # a discriminator-domain artifact; coherent chips have no such memory)
            scores = tables[:, 1:] @ seg[1:]
            full = 31
        else:
            scores = tables @ seg
            full = 32
        best = int(np.argmax(scores))
        if scores[best] < full - 2 * 6:      # ≤6 chip errors tolerated
            return None
        return best

    lo = nibble_at(start)
    hi = nibble_at(start + 32)
    if lo is None or hi is None:
        return None
    length = lo | (hi << 4)
    if not 0 < length <= 127:
        return None
    out = []
    pos = start + 64
    for _ in range(length):
        lo = nibble_at(pos)
        hi = nibble_at(pos + 32)
        if lo is None or hi is None:
            return None
        out.append(lo | (hi << 4))
        pos += 64
    return bytes(out)
