"""LoRa CSS PHY: frame-level modulation and demodulation.

Re-design of the reference LoRa example's signal path (``examples/lora/src/``:
``Modulator``, ``FrameSync`` — dechirp + preamble tracking, ``FftDemod`` — the dechirp+FFT
+argmax demodulator; port of gr-lora_sdr). All symbols of a frame are dechirped and
FFT'd as one batched [n_sym, 2^sf] computation. The port's copy of
``futuresdr_tpu/models/lora/phy.py``, its arithmetic unchanged.

Frame layout: ``n_pre`` upchirps, 2 sync-word chirps, 2.25 downchirps, then header block
(CR 4/8 at sf-2 bits/symbol, reduced rate) and payload blocks (CR 4/cr at sf bits/
symbol). SF5/SF6 (SX126x, the reference's default range start): the header block runs
FULL rate (sf rows, no ×4 bins), two null upchirps sit between the downchirps and the
first data symbol, and LDRO never applies to the header (`deinterleaver.rs:202-208`,
`fft_demod.rs:72-75`, `modulator.rs:118-130`, `encoder.rs:195-215`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from . import coding

__all__ = ["LoraParams", "modulate_frame", "demodulate_frame", "detect_frames",
           "encode_payload_symbols", "decode_symbols"]


@dataclass(frozen=True)
class LoraParams:
    sf: int = 7                 # spreading factor: 2^sf chips/symbol
    cr: int = 1                 # coding rate 4/(4+cr)
    n_preamble: int = 8
    sync_word: Union[int, Tuple[int, ...]] = 0x12   # RX may accept several ids;
    #   TX modulates the first (`frame_sync.rs:1098` initial_sync_words)
    has_crc: bool = True
    ldro: Optional[bool] = False    # low-data-rate optimize: payload at sf-2 too;
    #   None = auto — on iff the symbol exceeds 16 ms at ``bw_hz``
    #   (`default_values.rs:15` LDRO_MAX_DURATION_MS), e.g. SF11+ at 125 kHz
    bw_hz: int = 125_000        # only used by the LDRO auto rule
    implicit_header: bool = False   # no in-band header: RX must know length/cr/crc
    #   a priori (`decoder.rs:36` — the reference's implicit_header mode); the
    #   first block is still the reduced-rate CR4/8 sf-2 block, all payload
    soft_decoding: bool = True      # LLR demod + soft Hamming (`fft_demod.rs` soft
    #   buffers): adds max-correlation candidates to the CRC arbitration.
    #   Default-ON to match the reference's receiver binaries, which hardwire
    #   `build_lora_rx_soft_decoding` (`examples/lora/src/bin/rx.rs:65`,
    #   `rx_meshtastic.rs:76`, `rx_all_channels_eu.rs:156`); set False for the
    #   ~10%-faster hard path (documented opt-out, perf/RESULTS_r4.md)

    def __post_init__(self):
        if not 5 <= self.sf <= 12:
            raise ValueError(f"sf must be in 5..12 (SX126x range), got {self.sf}")
        # sync chirps ride bins nibble*8: a nibble with 8*nib >= 2^sf cannot be
        # encoded (`utils.rs:465-489` SynchWord::verify "symbol space too small"
        # — bites at SF5/6 where n is 32/64)
        for w in self.sync_words:
            for nib in ((w >> 4) & 0xF, w & 0xF):
                if nib * 8 >= self.n:
                    raise ValueError(
                        f"sync word {w:#04x}: symbol {nib * 8} does not fit the "
                        f"sf{self.sf} symbol space [0, {self.n})")

    @property
    def n(self) -> int:
        return 1 << self.sf

    @property
    def ldro_on(self) -> bool:
        if self.ldro is not None:
            return self.ldro
        return 1000.0 * self.n / self.bw_hz > 16.0

    @property
    def sync_words(self) -> Tuple[int, ...]:
        """Accepted network ids as a tuple (``sync_word`` may be a single int)."""
        return self.sync_word if isinstance(self.sync_word, tuple) \
            else (self.sync_word,)

    @property
    def hdr_reduced(self) -> bool:
        """SF≥7 header blocks ride reduced rate (sf−2 rows, bins ×4); SF5/6 have
        no headroom — their header block runs FULL rate (`deinterleaver.rs:202-208`,
        `fft_demod.rs:72-75`: ``reduced_rate = is_header && sf >= SF7``)."""
        return self.sf >= 7

    @property
    def sf_app_hdr(self) -> int:
        """Nibble rows in the first (header) interleave block: sf−2 at SF≥7,
        sf at SF5/6 (`encoder.rs:195-215` first-block special case)."""
        return self.sf - 2 if self.sf >= 7 else self.sf

    @property
    def n_null(self) -> int:
        """SF5/6 frames carry two null upchirps between the 2.25 downchirps and
        the first data symbol (`modulator.rs:118-130`; `frame_sync.rs:695-699`
        "Semtech adds two null symbols in the beginning")."""
        return 2 if self.sf < 7 else 0


def _upchirp(n: int, shift: int = 0) -> np.ndarray:
    k = np.arange(n)
    ph = 2 * np.pi * ((k * k) / (2 * n) + k * (shift / n - 0.5))
    return np.exp(1j * ph)


def _downchirp(n: int) -> np.ndarray:
    return np.conj(_upchirp(n))


def encode_payload_symbols(payload: bytes, p: LoraParams) -> np.ndarray:
    """Payload bytes → symbol values (header block + payload blocks)."""
    body = coding.whiten(payload)
    if p.has_crc:
        c = coding.crc16(payload)
        body = body + bytes([c & 0xFF, (c >> 8) & 0xFF])
    nibbles = []
    for byte in body:
        nibbles += [byte & 0xF, byte >> 4]
    nibbles = np.array(nibbles, dtype=np.uint8)

    sf_app_hdr = p.sf_app_hdr
    if p.implicit_header:
        # no header nibbles: the reduced-rate first block carries payload only
        hdr_nibbles = nibbles[:sf_app_hdr]
        used = min(len(nibbles), sf_app_hdr)
    else:
        header = coding.build_header(len(payload), p.cr, p.has_crc)
        hdr_nibbles = np.concatenate([header, nibbles[:max(0, sf_app_hdr - 5)]])
        used = max(0, sf_app_hdr - 5)
    if len(hdr_nibbles) < sf_app_hdr:
        hdr_nibbles = np.concatenate(
            [hdr_nibbles, np.zeros(sf_app_hdr - len(hdr_nibbles), np.uint8)])
    rest = nibbles[used:]

    symbols: List[int] = []
    # header block: CR 4/8. At SF≥7: sf-2 bits per symbol, reduced rate — the
    # inverse Gray map runs over the sf-2-bit field and the result rides on bins
    # ×4 (degray(s) << 2, NOT degray(s << 2): multiples of 4 on the wire are what
    # give the reduced-rate mode its ±2-bin drift immunity, `gray_demap`/
    # `fft_demod` of gr-lora_sdr). At SF5/6: FULL rate, sf bits per symbol, no
    # bin scaling (`fft_demod.rs:72-75` reduced_rate requires sf >= SF7).
    hdr_shift = 2 if p.hdr_reduced else 0
    cw = coding.hamming_encode(hdr_nibbles, 4)
    sym = coding.interleave_block(cw, sf_app_hdr, 4)
    symbols += [int(g) << hdr_shift for g in coding.degray(sym)]
    # payload blocks
    sf_app = p.sf - 2 if p.ldro_on else p.sf
    shift_bits = 2 if p.ldro_on else 0
    i = 0
    while i < len(rest):
        blk = rest[i:i + sf_app]
        if len(blk) < sf_app:
            blk = np.concatenate([blk, np.zeros(sf_app - len(blk), np.uint8)])
        cw = coding.hamming_encode(blk, p.cr)
        sym = coding.interleave_block(cw, sf_app, p.cr)
        symbols += [int(g) << shift_bits for g in coding.degray(sym)]
        i += sf_app
    return np.array(symbols, dtype=np.int64) % p.n


def modulate_frame(payload: bytes, p: LoraParams) -> np.ndarray:
    """Payload → complex64 baseband frame at 1 sample/chip."""
    n = p.n
    up = _upchirp(n)
    down = _downchirp(n)
    parts = [np.tile(up, p.n_preamble)]
    # sync word as two shifted chirps (gr-lora_sdr: nibbles ×8); a multi-id RX
    # params object transmits its first id
    w = p.sync_words[0]
    parts.append(_upchirp(n, ((w >> 4) & 0xF) * 8))
    parts.append(_upchirp(n, (w & 0xF) * 8))
    parts.append(np.concatenate([down, down, down[:n // 4]]))
    # SF5/6: two null (symbol-0) upchirps before the data (`modulator.rs:118-130`)
    for _ in range(p.n_null):
        parts.append(up)
    for s in encode_payload_symbols(payload, p):
        parts.append(_upchirp(n, int(s)))
    return np.concatenate(parts).astype(np.complex64)


def _dechirp_bins(samples: np.ndarray, p: LoraParams) -> np.ndarray:
    """[k·N] samples → [k, N] dechirped FFT magnitudes' argmax-ready spectra."""
    n = p.n
    k = len(samples) // n
    blocks = samples[:k * n].reshape(k, n) * _downchirp(n)[None, :]
    return np.fft.fft(blocks, axis=1)


def _block_cw(bins: np.ndarray, o, sf_app: int, cr: int, shift_bits: int,
              n: int) -> np.ndarray:
    """Offset-corrected bins → deinterleaved codewords. ``o`` may be a scalar or a
    per-symbol integer array (drift correction)."""
    g = coding.gray((bins - o) % n)
    sym = (g >> shift_bits) & ((1 << sf_app) - 1)
    return coding.deinterleave_block(sym, sf_app, cr)


def _soft_nibbles(mags: np.ndarray, o: int, sf_app: int, cr: int,
                  reduced: bool, n: int) -> np.ndarray:
    """Soft-decision decode of one interleave block (`fft_demod.rs` soft buffers +
    `hamming_dec.rs:170-173` soft path).

    Per symbol and bit, the LLR is max |X_k| over wire bins whose demapped value has
    the bit set minus max over bins where it's clear; the diagonal deinterleaver is
    applied to LLRs in closed form (cwLLR[r, j] = LLR[j, (r - j) mod sf_app]); each
    codeword row picks the nibble whose Hamming codeword best correlates.
    """
    k = np.arange(n)
    if reduced:
        nq = n >> 2
        v = coding.gray(((((k + 2) >> 2) % nq) - o) % nq)
    else:
        v = coding.gray((k - o) % n)
    v &= (1 << sf_app) - 1
    bits = ((v[None, :] >> np.arange(sf_app)[:, None]) & 1).astype(bool)  # [sf,n]
    blk = len(mags)
    llr = np.empty((blk, sf_app), dtype=np.float64)
    for i in range(sf_app):
        llr[:, i] = mags[:, bits[i]].max(axis=1) - mags[:, ~bits[i]].max(axis=1)
    r_idx = np.arange(sf_app)[:, None]                       # codeword row
    j_idx = np.arange(blk)[None, :]                          # bit position
    cw_llr = llr[j_idx, (r_idx - j_idx) % sf_app]            # [sf_app, blk]
    cb = coding.hamming_encode(np.arange(16, dtype=np.uint8), cr)
    cb_sign = (2.0 * ((cb[:, None] >> np.arange(blk)[None, :]) & 1) - 1.0)  # [16,blk]
    return np.argmax(cw_llr @ cb_sign.T, axis=1).astype(np.uint8)


def _best_profile(bins: np.ndarray, starts, sf_app: int, cr: int, shift_bits: int,
                  n: int):
    """Arbitrate the per-symbol integer bin offset over one interleave block.

    Candidate profiles: for each start offset, constant or one ±1 step at any
    position (clock drift below ~1 bin per block ⇒ at most one step). The profile
    with the fewest Hamming parity violations wins; candidates are ordered so ties
    prefer no step, then the latest step (fewest changed symbols).
    Returns (codewords, end_offset, violations).
    """
    blk = len(bins)
    cands = []                                    # (v, cw, o_end) in preference order
    for o0 in starts:
        profiles = [np.full(blk, o0, dtype=np.int64)]
        for t in (o0 + 1, o0 - 1):
            for s in range(blk - 1, -1, -1):     # step at s: bins[s:] use t (s=0 ⇒
                #                                  the drift crossed at the boundary)
                prof = np.full(blk, o0, dtype=np.int64)
                prof[s:] = t
                profiles.append(prof)
        for prof in profiles:
            cw = _block_cw(bins, prof, sf_app, cr, shift_bits, n)
            v = int(coding.hamming_violations(cw, cr).sum())
            cands.append((v, cw, int(prof[-1])))
    vmin = min(c[0] for c in cands)
    # all minimal-violation candidates, deduped by codewords: at low coding rates a
    # straddle bit can land on a parity-uncovered data bit (cr1: p0 misses d3), so
    # ties are real — the payload CRC arbitrates among them later
    out, seen = [], set()
    for v, cw, o_end in cands:
        if v == vmin and cw.tobytes() not in seen:
            seen.add(cw.tobytes())
            out.append((cw, o_end, v))
        if len(out) >= 4:
            break
    return out


def decode_symbols(symbols: np.ndarray, p: LoraParams, n_payload: Optional[int] = None,
                   mags: Optional[np.ndarray] = None):
    """Demodulated symbol bins → (payload, crc_ok, header) or None.

    Tracks residual symbol-timing drift (SFO, `frame_sync.rs` sfo_cum role): a clock
    offset walks the dechirped bins by ±1 every ~1/(ppm·2^sf) symbols, and the sync
    epoch leaves a constant integer bias. Per interleave block, the decoder arbitrates
    an offset profile (constant, or one ±1 step at any intra-block position) with the
    Hamming parity checks — a wrong offset scrambles codewords and lights up the
    parities, so the step lands on the exact symbol where the drift crossed a bin
    boundary. Offsets chain block to block; the header block searches a wide constant
    bias (±3) on top.
    """
    bins = np.asarray(symbols, dtype=np.int64)
    n = p.n
    nq = n >> 2
    sf_app_hdr = p.sf_app_hdr
    n_hdr_sym = 8                                  # CR 4/8 header block
    if len(bins) < n_hdr_sym:
        return None
    # reduced-rate blocks ride on bins ×4 (see encode_payload_symbols): rounding to
    # the nearest group absorbs ±2 bins of drift/noise, and drift tracking runs in
    # the uniform group domain
    qbins = (((bins + 2) >> 2) % nq).astype(np.int64)
    if p.hdr_reduced:
        hdr_cands = _best_profile(qbins[:n_hdr_sym], (0, 1, -1), sf_app_hdr, 4,
                                  0, nq)
    else:
        # SF5/6: the header block is FULL rate — arbitrate the sync bias directly
        # in the bin domain (no ×4 group absorption, so search a bin wider)
        hdr_cands = _best_profile(bins[:n_hdr_sym], (0, 1, -1, 2, -2), sf_app_hdr,
                                  4, 0, n)
    o_hdr_q = hdr_cands[0][1]
    if p.implicit_header:
        # no in-band header (`decoder.rs:36`): length comes from the caller,
        # cr/crc from params; the whole first block is payload nibbles — so its
        # tied candidates join the CRC arbitration like any other payload block
        if n_payload is None or int(n_payload) < 0:
            raise ValueError("implicit_header decode needs n_payload >= 0")
        length, cr, has_crc = int(n_payload), p.cr, p.has_crc
        hdr_alts = [list(coding.hamming_decode(cw_, 4)[:sf_app_hdr])
                    for cw_, _, _ in hdr_cands]
        if p.soft_decoding and mags is not None:
            soft = list(_soft_nibbles(mags[:n_hdr_sym], o_hdr_q, sf_app_hdr, 4,
                                      p.hdr_reduced, n)[:sf_app_hdr])
            if soft not in hdr_alts:
                hdr_alts.insert(0, soft)
    else:
        hdr_nibbles = coding.hamming_decode(hdr_cands[0][0], 4)
        parsed = coding.parse_header(hdr_nibbles[:5])
        if parsed is None:
            return None
        length, cr, has_crc = parsed
        # parse_header's checksum already vouches for this block: single candidate
        hdr_alts = [list(hdr_nibbles[5:])]

    sf_app = p.sf - 2 if p.ldro_on else p.sf
    n_crc = 2 if has_crc else 0
    n_nibbles_needed = 2 * (length + n_crc)
    n_from_hdr = len(hdr_alts[0])
    blk_len = 4 + cr
    n_blocks = max(0, -(-(n_nibbles_needed - n_from_hdr) // sf_app))
    if n_hdr_sym + n_blocks * blk_len > len(bins):
        return None

    if p.ldro_on:
        p_n = nq
        pbins = qbins
        # SF≥7: the header offset is already in the group domain; SF5/6's
        # full-rate header offset maps to groups by rounding (|o_hdr| ≤ 2 ⇒ ~0)
        o_run = o_hdr_q if p.hdr_reduced else int(np.round(o_hdr_q / 4.0))
        first_starts = (o_run, o_run + 1, o_run - 1)
    elif not p.hdr_reduced:
        # SF5/6 non-ldro: header and payload share the bin domain — the header
        # arbitration already pinned the bias exactly, chain it directly
        p_n = n
        pbins = bins
        o_run = o_hdr_q
        first_starts = (o_run, o_run + 1, o_run - 1)
    else:
        p_n = n
        pbins = bins
        # the header's group offset pins the bin offset only to ±2 within a group —
        # and under noise o_hdr_q itself can be off by one group (±4 bins): the
        # first payload block re-searches the residual wide enough to cover both
        o_run = 4 * o_hdr_q
        first_starts = tuple(o_run + r for r in (0, 1, -1, 2, -2, 3, -3, 4, -4, 5, -5))

    # per-block candidate nibble lists; the header block leads with its own alts
    block_alts: List[List[np.ndarray]] = [hdr_alts]
    cached = None                                 # lookahead reuse: (start, cands)
    for b in range(n_blocks):
        i = n_hdr_sym + b * blk_len
        starts = first_starts if b == 0 else (o_run,)
        if cached is not None and cached[0] == starts:
            cands = cached[1]
        else:
            cands = _best_profile(pbins[i:i + blk_len], starts, sf_app, cr, 0, p_n)
        cached = None
        # end offsets in candidate-preference order (constant profile first):
        # ties below MUST fall back to this order, not a numeric sort — at cr1
        # in a small group domain (SF5/6 ldro: nq=8) every chain can show zero
        # violations, and picking the numerically smallest offset follows a
        # wrong chain straight through the whole payload
        ends = list(dict.fromkeys(c[1] for c in cands))
        if len(ends) > 1 and b + 1 < n_blocks:
            # tied candidates disagree on the end offset (a low-rate block can hide a
            # ±1 error entirely on parity-uncovered bits): let the NEXT block's
            # violations arbitrate which chain to follow
            j = i + blk_len
            nxt = {e: _best_profile(pbins[j:j + blk_len], (e,), sf_app, cr, 0, p_n)
                   for e in ends}
            o_run = min(ends, key=lambda e: nxt[e][0][2])  # stable: pref order
            cached = ((o_run,), nxt[o_run])       # next iteration reuses this sweep
        else:
            o_run = cands[0][1]
        alts = [coding.hamming_decode(cw_, cr) for cw_, _, _ in cands]
        if p.soft_decoding and mags is not None:
            # soft decode at each candidate end-offset, in candidate-preference
            # order: the PREFERRED offset's soft leads (it equals the hard decode on
            # clean signals, so no-CRC frames stay correct), hard profiles follow,
            # and speculative other-offset softs trail as CRC-arbitrated fallbacks
            offs = list(dict.fromkeys(o_end for _, o_end, _ in cands))
            softs = [_soft_nibbles(mags[i:i + blk_len], o, sf_app, cr, p.ldro_on, n)
                     for o in offs]
            lead = [softs[0]] if not any(np.array_equal(softs[0], a)
                                         for a in alts) else []
            trail = [s for s in softs[1:]
                     if not any(np.array_equal(s, a) for a in alts + lead)]
            alts = lead + alts + trail
        block_alts.append(alts)

    def assemble(choice) -> tuple:
        nibbles = []
        for alt in choice:
            nibbles += list(alt)
        if len(nibbles) < n_nibbles_needed:
            return None
        data = bytes([(nibbles[2 * j] & 0xF) | ((nibbles[2 * j + 1] & 0xF) << 4)
                      for j in range(length + n_crc)])
        payload = coding.dewhiten(data[:length])
        crc_ok = True
        if has_crc:
            rx_crc = data[length] | (data[length + 1] << 8)
            crc_ok = coding.crc16(payload) == rx_crc
        return payload, crc_ok, (length, cr, has_crc)

    # CRC arbitrates among the per-block ambiguities (bounded search; the soft
    # candidates enlarge the per-block alternative sets, so the budget grows too)
    import itertools
    cap = 4096 if (p.soft_decoding and mags is not None) else 1024
    first = None
    for combo in itertools.islice(itertools.product(*block_alts), cap):
        r = assemble(combo)
        if r is None:
            return None
        if first is None:
            first = r
        if r[1]:
            return r
    return first


def detect_frames(samples: np.ndarray, p: LoraParams) -> List[int]:
    """Preamble scan (`frame_sync.rs` role): dechirp ALL N/4-hop windows as one batched
    FFT, then look for adjacent windows with matching strong bins (constant dechirped
    symbol = upchirp train); refine timing from the bin index."""
    n = p.n
    hop = n // 4
    limit = len(samples) - (p.n_preamble + 5 + p.n_null) * n
    if limit <= 0:
        return []
    n_probe = (limit + hop - 1) // hop + 4
    n_probe = min(n_probe, (len(samples) - n) // hop + 1)
    idx = np.arange(n_probe)[:, None] * hop + np.arange(n)[None, :]
    windows = samples[idx] * _downchirp(n)[None, :]
    spec = np.abs(np.fft.fft(windows, axis=1))                  # [n_probe, N]
    kmax = np.argmax(spec, axis=1)
    peak_pow = spec[np.arange(n_probe), kmax] ** 2
    tot_pow = np.maximum((spec ** 2).sum(axis=1), 1e-12)
    conc = peak_pow / tot_pow

    starts = []
    i = 0
    while i * hop < limit and i + 4 < n_probe:
        j = i + 4                                    # window one symbol (4 hops) later
        ka, kb = int(kmax[i]), int(kmax[j])
        pa, pb = conc[i], conc[j]
        if ka == kb and pa > 0.3 and pb > 0.3:
            # inside the preamble: dechirped bin = (f_cfo − misalignment) mod n; use it
            # as a timing estimate (exact when CFO≈0, refined later by the downchirps)
            start = i * hop - ka
            if start < 0:
                start += n
            # validate: two data symbols can match by chance; a real preamble shows a
            # CONSTANT bin over aligned consecutive chirps from `start`. Small
            # symbol spaces (SF5/6: n=32/64) collide far more often — equal data
            # symbols mimic a short preamble — so they must confirm a longer run
            n_confirm = 3 if n >= 128 else max(3, min(5, p.n_preamble))
            bins = []
            for s in range(n_confirm):
                q = start + s * n
                if q + n > len(samples):
                    break
                bins.append(int(np.argmax(np.abs(np.fft.fft(
                    samples[q:q + n] * _downchirp(n))))))
            if len(bins) == n_confirm and all((b - bins[0]) % n in (0, 1, n - 1)
                                              for b in bins):
                starts.append(start)
                i = (start + (p.n_preamble + 5 + p.n_null) * n + hop - 1) // hop  # skip the frame head
            else:
                i += 1
        else:
            i += 1
    return starts


def demodulate_frame(samples: np.ndarray, start: int, p: LoraParams,
                     n_payload: Optional[int] = None):
    """Demodulate from a symbol-aligned position anywhere inside the preamble.

    CFO-aware sync (`frame_sync.rs` state machine): under a carrier offset of ``f``
    bins and a timing error of ``d`` samples, preamble UPchirps dechirp to bin
    ``(f − d) mod n`` while the 2.25 DOWNchirps dechirp (against an upchirp) to
    ``(f + d) mod n`` — measuring both separates frequency from timing:
    ``f = (c_up + c_dn)/2``, ``d = (c_dn − c_up)/2``. Data symbols are demodulated at
    the corrected timing and de-rotated by the integer CFO bin.
    """
    n = p.n
    down = _downchirp(n)
    up = _upchirp(n)

    def half(x: int) -> int:                      # signed mod-n representative
        return ((x + n // 2) % n) - n // 2

    def bin_conc(q: int, ref):
        spec = np.abs(np.fft.fft(samples[q:q + n] * ref))
        k = int(np.argmax(spec))
        conc = spec[k] ** 2 / max(np.sum(spec ** 2), 1e-12)
        return k, conc

    # find a consistent-bin run start (the preamble): any constant bin c (CFO shifts
    # it away from 0), confirmed on two consecutive chirps — noise windows rarely agree
    pos = None
    c_up = None
    for skip in range(3):
        q = start + skip * n
        if q + 2 * n > len(samples):
            break
        k1, c1 = bin_conc(q, down)
        k2, c2 = bin_conc(q + n, down)
        if c1 > 0.15 and c2 > 0.15 and (k1 - k2) % n in (0, 1, n - 1):
            pos, c_up = q, k1
            break
    if pos is None:
        return None
    # walk the constant-bin upchirp train; bounded by the max preamble length
    hops = 0
    while pos + n <= len(samples) and hops <= p.n_preamble + 2:
        k, conc = bin_conc(pos, down)
        if conc < 0.10 or (k - c_up) % n not in (0, 1, n - 1):
            break
        pos += n
        hops += 1
    if hops == 0:
        return None                 # not on a preamble
    # sync-word gate (`frame_sync.rs:1098-1101` known_valid_net_ids): the two sync
    # chirps carry the network id as bins nibble*8, riding the same (f-d) offset as
    # the preamble bin c_up — so (k - c_up) mod n is 8*nibble exactly, independent
    # of CFO/timing. An unknown id is another network's frame: reject, like the
    # reference. ``sync_word`` may be an int or a tuple of accepted ids.
    valid = p.sync_words

    def sync_nibble(q: int):
        k, conc = bin_conc(q, down)
        r = (k - c_up) % n
        s = int(round(r / 8.0)) % (n // 8)
        err = min((r - 8 * s) % n, (8 * s - r) % n)
        return s, err, conc

    matched_q = None
    noisy = False
    # the preamble walk can undershoot ≤2 chirps — or OVERSHOOT one when the
    # sync word's high nibble is 0 (its first chirp dechirps like preamble), so
    # the scan starts one chirp back. A match at the -n slot is TENTATIVE: the
    # boundary pair (preamble, sync_hi) there can alias a 0x0X id in the
    # accepted set, so a later aligned match overrides it.
    for off in (-n, 0, n, 2 * n):
        q = pos + off
        if q < 0 or q + 2 * n > len(samples):
            continue
        s1, e1, c1 = sync_nibble(q)
        s2, e2, c2 = sync_nibble(q + n)
        if c1 < 0.10 or c2 < 0.10:
            noisy = True            # too weak to judge the id: stay permissive
            break
        if any(s1 == ((w >> 4) & 0xF) and s2 == (w & 0xF) and e1 <= 2 and e2 <= 2
               for w in valid):
            matched_q = q
            if off >= 0:
                break               # aligned match: authoritative
            continue                # -n match: keep scanning for an aligned one
        if off >= 0 and s1 != 0:
            break                   # confident foreign id (a tentative -n match,
            #                         if any, still stands — overshoot case)
        # s1 == 0: first window still preamble-shaped (walk undershot — the pair
        # may be (preamble, preamble) or the boundary (preamble, nib_hi)): slide
    if matched_q is not None:
        pos = matched_q             # re-anchor on the true sync position
    elif not noisy:
        return None
    pos += 2 * n                    # sync word chirps
    # downchirp section: dechirp against an upchirp to split CFO from timing
    f_bin = 0
    d_shift = 0
    if pos + n <= len(samples):
        c_dn, conc_dn = bin_conc(pos, up)
        if conc_dn > 0.10:
            f_bin = int(round(half(c_up + c_dn) / 2.0))
            d_shift = int(round(half(c_dn - c_up) / 2.0))
    pos += 2 * n + n // 4 + d_shift # 2.25 downchirps + timing correction
    pos += p.n_null * n             # SF5/6: skip the two null symbols
    #                                 (`frame_sync.rs:695-699` consumes them)
    if pos < 0 or pos + n > len(samples):
        return None
    spec = _dechirp_bins(samples[pos:], p)
    if len(spec) == 0:
        return None
    # raw argmax bins; decode_symbols absorbs the constant sync bias AND the per-symbol
    # clock drift (SFO) via parity-arbitrated offset tracking — see its docstring
    amags = np.abs(spec)
    bins = (np.argmax(amags, axis=1) - f_bin) % n
    # soft path wants the spectra in the same de-rotated domain as the bins
    mags = np.roll(amags, -f_bin, axis=1) if p.soft_decoding else None
    return decode_symbols(bins, p, n_payload=n_payload, mags=mags)
