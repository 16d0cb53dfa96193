"""Audio OFDM data modem — the rattlegram-role application.

Re-design of the reference's ``examples/rattlegram`` (port of the aicodix modem: MLS
synchronization, OFDM PSK payload, BCH/polar FEC + OSD): same architecture — an MLS-keyed
OFDM sync symbol located by cross-correlation, pilot-based channel equalization, QPSK
payload carriers, FEC + CRC32 — with the FEC realized by this framework's K=7
convolutional code + soft Viterbi (``models.wlan.coding``) instead of BCH/polar+OSD.

Runs over plain audio: 8 kHz mono, carriers ≈ 1.1–3.3 kHz. The port's copy of
``futuresdr_tpu/models/rattlegram/modem.py`` on the port's runtime and its
``models/wlan/coding.py``, its arithmetic (float32 FFTs) unchanged.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt
from ..wlan import coding as wcoding
from . import fec as rfec
from . import polar

__all__ = ["mls", "ModemParams", "modulate", "demodulate", "demodulate_all",
           "demodulate_auto", "demodulate_all_auto", "Modem", "ModemTransmitter",
           "ModemReceiver"]


def mls(poly: int = 0b1000011, state: int = 1) -> np.ndarray:
    """Maximal-length sequence from an LFSR given a primitive polynomial (the
    reference's MLS utility; default x^6+x+1 → length 63)."""
    deg = poly.bit_length() - 1
    n = (1 << deg) - 1
    out = np.empty(n, dtype=np.uint8)
    s = state
    for i in range(n):
        out[i] = s & 1
        fb = 0
        t = s & poly
        while t:
            fb ^= t & 1
            t >>= 1
        s = (s >> 1) | (fb << (deg - 1))
    return out


@dataclass(frozen=True)
class ModemParams:
    fs: int = 8000
    fft: int = 256
    cp: int = 32
    first_carrier: int = 36        # ≈1.1 kHz
    n_carriers: int = 64           # → up to ≈3.2 kHz
    fec: str = "conv"              # "conv" (K=7 + CRC32) or "polar" — the
    #   reference's actual pipeline: xorshift scramble → systematic polar
    #   (CRC32-aided SCL-32) over the mode's frozen set (`encoder.rs:162-180`)

    def __post_init__(self):
        if self.fec not in ("conv", "polar"):
            raise ValueError(f"unknown fec {self.fec!r}: use 'conv' or 'polar'")

    @property
    def sym_len(self) -> int:
        return self.fft + self.cp

    @property
    def carriers(self) -> np.ndarray:
        return np.arange(self.first_carrier, self.first_carrier + self.n_carriers)


def _polar_mode_bits(n_payload: int) -> int:
    """Operation mode by payload size (`encoder.rs:136-141`): Mode16/15/14."""
    if n_payload <= 0 or n_payload > 170:
        raise ValueError(f"polar fec carries 1..170 bytes, got {n_payload}")
    return 680 if n_payload <= 85 else 1024 if n_payload <= 128 else 1360


def _coded_len(n_payload: int, p: ModemParams) -> int:
    """Transmitted coded bits for a payload of ``n_payload`` bytes."""
    if p.fec == "polar":
        _polar_mode_bits(n_payload)            # size must fit an operation mode
        return polar.CODE_LEN
    return 2 * (8 * (n_payload + 4) + 6)


_QPSK = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2)


def _sync_spectrum(p: ModemParams) -> np.ndarray:
    seq = mls()                                    # 63 chips
    vals = np.where(np.resize(seq, p.n_carriers) > 0, 1.0, -1.0)
    spec = np.zeros(p.fft, dtype=np.complex128)
    spec[p.carriers] = vals
    return spec


def _sym_to_audio(spec: np.ndarray, p: ModemParams) -> np.ndarray:
    """Hermitian-symmetric IFFT → real audio symbol with CP."""
    full = spec.copy()
    full[-np.arange(1, p.fft // 2)] = np.conj(full[np.arange(1, p.fft // 2)])
    full[0] = full[p.fft // 2] = 0
    t = np.fft.ifft(full).real * p.fft / np.sqrt(p.n_carriers * 2)
    return np.concatenate([t[-p.cp:], t])


# ---- in-band metadata (`encoder.rs:144-145` meta_data + preamble symbol role):
# 55 bits = base37(callsign) << 8 | operation mode, + CRC16 → 71 data bits,
# BCH(255,71)-protected, BPSK over ceil(255/n_carriers) symbols after the sync

_MODE_BY_BITS = {680: 16, 1024: 15, 1360: 14}
_BITS_BY_MODE = {m: b for b, m in _MODE_BY_BITS.items()}


def _base37(callsign: str) -> int:
    """aicodix base-37 callsign packing (' ' 0, digits 1-10, letters 11-36)."""
    if len(callsign) > 9:
        raise ValueError(f"callsign {callsign!r} exceeds 9 characters")
    v = 0
    for c in callsign.upper()[::-1]:
        d = (0 if c == " " else ord(c) - ord("0") + 1 if "0" <= c <= "9"
             else ord(c) - ord("A") + 11 if "A" <= c <= "Z" else None)
        if d is None:
            raise ValueError(f"callsign char {c!r} not in base-37 alphabet")
        v = v * 37 + d
    return v


def _base37_str(v: int) -> str:
    out = []
    while v:
        v, d = divmod(v, 37)
        out.append(" " if d == 0 else chr(d - 1 + ord("0")) if d <= 10
                   else chr(d - 11 + ord("A")))
    return "".join(out).rstrip()


def _meta_symbols(p: ModemParams) -> int:
    return -(-rfec.BCH_N // p.n_carriers)          # BPSK: 1 bit per carrier


def _meta_encode(callsign: str, mode: int) -> np.ndarray:
    """(callsign, mode) → 255 hard bits (systematic BCH codeword)."""
    meta = (_base37(callsign) << 8) | mode
    if meta >> 55:
        raise ValueError("callsign packs beyond 55 bits")
    bits55 = ((meta >> np.arange(55)) & 1).astype(np.uint8)
    crc = rfec.crc16_rattlegram(np.packbits(bits55, bitorder="little").tobytes())
    data71 = np.concatenate([bits55, ((crc >> np.arange(16)) & 1).astype(np.uint8)])
    return np.concatenate([data71, rfec.bch_parity(data71)])


def _meta_decode(soft255: np.ndarray):
    """Soft codeword → (callsign, mode) or None (OSD + CRC16 gate)."""
    hard, _conf = rfec.osd_decode(
        np.clip(soft255, -127, 127).astype(np.int8), _META_GEN())
    data71 = hard[:rfec.BCH_K]
    crc = rfec.crc16_rattlegram(
        np.packbits(data71[:55], bitorder="little").tobytes())
    if not np.array_equal(data71[55:71],
                          ((crc >> np.arange(16)) & 1).astype(np.uint8)):
        return None
    meta = int(sum(int(b) << i for i, b in enumerate(data71[:55])))
    mode = meta & 0xFF
    if mode not in _BITS_BY_MODE:
        return None
    return _base37_str(meta >> 8), mode


_META_GEN_CACHE = None


def _META_GEN():
    global _META_GEN_CACHE
    if _META_GEN_CACHE is None:
        _META_GEN_CACHE = rfec.bch_generator_matrix(systematic=True)
    return _META_GEN_CACHE


def modulate(payload: bytes, p: ModemParams = ModemParams(),
             callsign: Optional[str] = None,
             noise_symbols: int = 0) -> np.ndarray:
    """Payload bytes → audio samples (sync symbol + QPSK payload symbols).

    With ``callsign`` (polar fec only), BPSK metadata symbols carrying
    callsign+mode follow the sync — the receiver then needs no a-priori
    payload size (:func:`demodulate_auto`). ``noise_symbols`` prepends
    MLS-seeded random-QPSK symbols before the sync (`encoder.rs:308-319`
    noise_symbol role: opens squelch/AGC before the data arrives)."""
    if p.fec == "polar":
        data_bits = _polar_mode_bits(len(payload))
        mesg = np.frombuffer(payload.ljust(data_bits // 8, b"\x00"), np.uint8)
        mesg = (mesg ^ rfec.Xorshift32().bytes(len(mesg))).tobytes()
        coded = (polar.polar_encode(mesg, data_bits) < 0).astype(np.uint8)  # −1 ⇒ 1
    else:
        body = payload + zlib.crc32(payload).to_bytes(4, "little")
        bits = np.unpackbits(np.frombuffer(body, np.uint8))
        bits = np.concatenate([bits, np.zeros(6, np.uint8)])    # flush the trellis
        coded = wcoding.conv_encode(bits)
    bits_per_sym = 2 * p.n_carriers
    n_sym = -(-len(coded) // bits_per_sym)
    padded = np.zeros(n_sym * bits_per_sym, dtype=np.uint8)
    padded[:len(coded)] = coded
    sync = _sync_spectrum(p)
    parts = []
    if noise_symbols:
        seq = rfec.Mls(0b100101010001)     # long-period MLS bit source (ref's
        #                                    noise_seq role)
        for _ in range(noise_symbols):
            spec = np.zeros(p.fft, dtype=np.complex128)
            vals = np.array([(2.0 * seq.next() - 1) + 1j * (2.0 * seq.next() - 1)
                             for _ in range(p.n_carriers)]) / np.sqrt(2)
            spec[p.carriers] = vals
            parts.append(_sym_to_audio(spec, p))
    parts.append(_sym_to_audio(sync, p))
    if callsign is not None:
        if p.fec != "polar":
            raise ValueError("in-band metadata needs fec='polar' (mode field)")
        mbits = _meta_encode(callsign, _MODE_BY_BITS[data_bits])
        mpad = np.zeros(_meta_symbols(p) * p.n_carriers, np.uint8)
        mpad[:len(mbits)] = mbits
        for s in range(_meta_symbols(p)):
            spec = np.zeros(p.fft, dtype=np.complex128)
            spec[p.carriers] = np.where(
                mpad[s * p.n_carriers:(s + 1) * p.n_carriers] > 0, -1.0, 1.0)
            parts.append(_sym_to_audio(spec, p))
    for s in range(n_sym):
        seg = padded[s * bits_per_sym:(s + 1) * bits_per_sym].reshape(-1, 2)
        idx = seg[:, 0] + 2 * seg[:, 1]
        spec = np.zeros(p.fft, dtype=np.complex128)
        spec[p.carriers] = _QPSK[idx]
        parts.append(_sym_to_audio(spec, p))
    burst = np.concatenate(parts)
    return (burst / np.abs(burst).max() * 0.8).astype(np.float32)


def _sync_norm(audio: np.ndarray, p: ModemParams) -> np.ndarray:
    """Normalized MLS sync correlation metric over every start position —
    the single source of the detection normalization for both demodulators."""
    ref = _sym_to_audio(_sync_spectrum(p), p)[p.cp:]
    corr = np.correlate(audio.astype(np.float64), ref, mode="valid")
    energy = np.convolve(audio.astype(np.float64) ** 2, np.ones(len(ref)), "full")
    energy = energy[len(ref) - 1:len(ref) - 1 + len(corr)]
    return np.abs(corr) / np.maximum(np.sqrt(energy * np.sum(ref ** 2)), 1e-12)


def demodulate_all(audio: np.ndarray, n_payload: int,
                   p: ModemParams = ModemParams(), skip_symbols: int = 0):
    """Every decodable burst in ``audio``, in time order: ``[(sync_start,
    payload), …]``. Sync peaks above threshold are tried oldest-first and a
    successful decode claims its burst span, so a long recording with many
    bursts yields them all (``demodulate`` is the single-burst view).
    ``skip_symbols``: in-band metadata symbols between sync and payload."""
    n_sym = -(-_coded_len(n_payload, p) // (2 * p.n_carriers))
    burst_span = (1 + skip_symbols + n_sym) * p.sym_len

    def decode(peak):
        payload = _decode_at(audio, peak, n_payload, p, skip_symbols)
        return None if payload is None else ((peak, payload), burst_span)

    return _scan_bursts(audio, p, decode)


def _scan_bursts(audio: np.ndarray, p: ModemParams, decode_at_peak):
    """Shared burst scanner: try every above-threshold sync candidate oldest-
    first; a successful decode claims its burst span; a failed one skips the
    rest of its correlation lobe (retrying the same corrupted burst once per
    above-threshold sample would run the decoder tens of times for nothing).
    ``decode_at_peak(peak) -> (result, span) | None``."""
    norm = _sync_norm(audio, p)
    out = []
    next_free = -1
    for i in np.flatnonzero(norm > 0.5):
        if i < next_free:
            continue
        # refine to the local peak within one symbol
        hi = min(len(norm), i + p.sym_len)
        peak = int(i + np.argmax(norm[i:hi]))
        r = decode_at_peak(peak)
        if r is not None:
            out.append(r[0])
            next_free = peak + r[1]
        else:
            next_free = max(next_free, peak + p.sym_len)
    return out


def demodulate(audio: np.ndarray, n_payload: int,
               p: ModemParams = ModemParams(),
               skip_symbols: int = 0) -> Optional[bytes]:
    """Locate the strongest MLS sync symbol, equalize, demap, Viterbi-decode,
    CRC-check — the single-burst window API (streams: :func:`demodulate_all`)."""
    norm = _sync_norm(audio, p)
    peak = int(np.argmax(norm))
    if norm[peak] < 0.5:
        return None
    return _decode_at(audio, peak, n_payload, p, skip_symbols)


def _decode_auto_at(audio: np.ndarray, peak: int, p: ModemParams):
    """Metadata burst at a known sync peak → (callsign, payload, span) or None."""
    sync_spec = np.fft.fft(audio[peak:peak + p.fft])
    H = sync_spec[p.carriers] / _sync_spectrum(p)[p.carriers]
    soft = []
    pos = peak + p.sym_len
    for _ in range(_meta_symbols(p)):
        if pos + p.fft > len(audio):
            return None
        eq = np.fft.fft(audio[pos:pos + p.fft])[p.carriers] / H
        soft.append(eq.real)                 # carrier −1 ⇔ bit 1; OSD: +1 ⇔ bit 0
        pos += p.sym_len
    meta = _meta_decode(np.concatenate(soft)[:rfec.BCH_N] * 48.0)
    if meta is None:
        return None
    callsign, mode = meta
    n_payload = _BITS_BY_MODE[mode] // 8
    payload = _decode_at(audio, peak, n_payload, p,
                         skip_symbols=_meta_symbols(p), H=H)
    if payload is None:
        return None
    n_sym = -(-_coded_len(n_payload, p) // (2 * p.n_carriers))
    span = (1 + _meta_symbols(p) + n_sym) * p.sym_len
    return callsign, payload, span


def demodulate_auto(audio: np.ndarray, p: ModemParams = ModemParams()):
    """Single burst with in-band metadata: → (callsign, payload) or None.

    No a-priori payload size: the BPSK metadata symbols after the sync carry
    callsign + operation mode (BCH(255,71), OSD-decoded, CRC16-gated); the mode
    then sizes the polar payload decode."""
    if p.fec != "polar":
        raise ValueError("demodulate_auto needs fec='polar' (mode metadata)")
    norm = _sync_norm(audio, p)
    peak = int(np.argmax(norm))
    if norm[peak] < 0.5:
        return None
    r = _decode_auto_at(audio, peak, p)
    return None if r is None else (r[0], r[1])


def demodulate_all_auto(audio: np.ndarray, p: ModemParams = ModemParams()):
    """Every metadata burst in ``audio``, in time order:
    ``[(sync_start, callsign, payload), …]`` — senders may use different
    operation modes; each burst's own metadata sizes its decode and span."""
    if p.fec != "polar":
        raise ValueError("demodulate_all_auto needs fec='polar' (mode metadata)")

    def decode(peak):
        r = _decode_auto_at(audio, peak, p)
        return None if r is None else ((peak, r[0], r[1]), r[2])

    return _scan_bursts(audio, p, decode)


def _decode_at(audio: np.ndarray, sync_start: int, n_payload: int,
               p: ModemParams, skip_symbols: int = 0,
               H: Optional[np.ndarray] = None) -> Optional[bytes]:
    if H is None:
        # channel estimate from the sync symbol
        sync_spec = np.fft.fft(audio[sync_start:sync_start + p.fft])
        H = sync_spec[p.carriers] / _sync_spectrum(p)[p.carriers]

    n_coded = _coded_len(n_payload, p)
    bits_per_sym = 2 * p.n_carriers
    n_sym = -(-n_coded // bits_per_sym)
    llrs = np.zeros(n_sym * bits_per_sym)
    pos = sync_start + (1 + skip_symbols) * p.sym_len
    for s in range(n_sym):
        if pos + p.fft > len(audio):
            return None
        spec = np.fft.fft(audio[pos:pos + p.fft])
        eq = spec[p.carriers] / H
        d = -np.abs(eq[:, None] - _QPSK[None, :]) ** 2
        b0 = np.maximum(d[:, 1], d[:, 3]) - np.maximum(d[:, 0], d[:, 2])
        b1 = np.maximum(d[:, 2], d[:, 3]) - np.maximum(d[:, 0], d[:, 1])
        seg = np.empty(bits_per_sym)
        seg[0::2] = b0
        seg[1::2] = b1
        llrs[s * bits_per_sym:(s + 1) * bits_per_sym] = seg
        pos += p.sym_len
    if p.fec == "polar":
        data_bits = _polar_mode_bits(n_payload)
        # polar soft convention: negative ⇒ bit 1; our llrs: positive ⇒ bit 1
        soft = np.clip(-llrs[:n_coded] * 32.0, -127, 127).astype(np.int8)
        decoded, _flips = polar.polar_decode(soft, data_bits)
        if decoded is None:
            return None                      # no surviving path passed CRC32
        ks = rfec.Xorshift32().bytes(data_bits // 8)
        return (np.frombuffer(decoded, np.uint8) ^ ks).tobytes()[:n_payload]
    n_bits = n_coded // 2
    bits = wcoding.viterbi_decode(llrs[:n_coded], n_bits)
    body = np.packbits(bits[:8 * (n_payload + 4)]).tobytes()
    payload, crc = body[:n_payload], body[n_payload:n_payload + 4]
    if zlib.crc32(payload).to_bytes(4, "little") != crc:
        return None
    return payload


class Modem:
    """Convenience TX/RX pairing over a fixed payload size (rattlegram bursts carry a
    fixed 170-byte payload; configurable here)."""

    def __init__(self, payload_size: int = 170, params: ModemParams = ModemParams(),
                 callsign: Optional[str] = None):
        _coded_len(payload_size, params)   # polar: size must fit a mode — fail
        self.size = payload_size           # at build time, not mid-rx
        self.params = params
        self.callsign = callsign           # set → tx embeds in-band metadata
        if callsign is not None and params.fec != "polar":
            raise ValueError("in-band metadata (callsign) needs fec='polar'")

    def tx(self, payload: bytes) -> np.ndarray:
        if len(payload) > self.size:
            raise ValueError(
                f"payload is {len(payload)} bytes but the modem was built for "
                f"payload_size={self.size}; rebuild with a larger size")
        return modulate(payload.ljust(self.size, b"\x00"), self.params,
                        callsign=self.callsign)

    def rx_auto(self, audio: np.ndarray):
        """Metadata-signalled burst → (callsign, payload) or None — the RX
        needs no payload size; see :func:`demodulate_auto`."""
        r = demodulate_auto(audio, self.params)
        return None if r is None else (r[0], r[1].rstrip(b"\x00"))

    def _skip(self) -> int:
        return _meta_symbols(self.params) if self.callsign is not None else 0

    def rx(self, audio: np.ndarray) -> Optional[bytes]:
        r = demodulate(audio, self.size, self.params, skip_symbols=self._skip())
        return None if r is None else r.rstrip(b"\x00")

    def rx_all(self, audio: np.ndarray):
        """All bursts in a recording, time-ordered: ``[(position, payload), …]``."""
        return [(pos, r.rstrip(b"\x00"))
                for pos, r in demodulate_all(audio, self.size, self.params,
                                             skip_symbols=self._skip())]

    def burst_samples(self) -> int:
        """Length of one TX burst in samples (for RX windowing)."""
        return len(self.tx(b""))


class ModemTransmitter(Kernel):
    """Message port ``tx`` (Blob) → audio sample stream (float32 @ params.fs)."""

    def __init__(self, payload_size: int = 64, params: ModemParams = ModemParams(),
                 gap_samples: int = 2000, callsign: Optional[str] = None):
        super().__init__()
        self.modem = Modem(payload_size, params, callsign=callsign)
        self.gap = gap_samples
        self._pending = []
        self._current: Optional[np.ndarray] = None
        self._eos = False
        self.output = self.add_stream_output("out", np.float32)

    @message_handler(name="tx")
    async def tx_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            self._eos = True
            io.call_again = True
            return Pmt.ok()
        try:
            payload = p.to_blob()
            tx = self.modem.tx(payload)     # ValueError on oversize: bad input,
        except Exception:                   # not a flowgraph-killing fault
            return Pmt.invalid_value()
        burst = np.concatenate([tx, np.zeros(self.gap, np.float32)])
        self._pending.append(burst)
        io.call_again = True
        return Pmt.ok()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        produced = 0
        while produced < len(out):
            if self._current is None:
                if not self._pending:
                    break
                self._current = self._pending.pop(0)
            k = min(len(out) - produced, len(self._current))
            out[produced:produced + k] = self._current[:k]
            produced += k
            self._current = self._current[k:] if k < len(self._current) else None
        if produced:
            self.output.produce(produced)
        if self._eos and self._current is None and not self._pending:
            io.finished = True
        elif produced and (self._current is not None or self._pending):
            io.call_again = True


class ModemReceiver(Kernel):
    """Audio stream → decoded payload messages on ``rx``.

    ``auto=True`` (polar fec): size-free metadata reception — bursts carry
    callsign + mode in-band, ``frames`` holds (callsign, payload) tuples and
    ``rx`` posts maps; senders of different modes coexist on one receiver."""

    def __init__(self, payload_size: int = 64, params: ModemParams = ModemParams(),
                 auto: bool = False):
        super().__init__()
        if auto and params.fec != "polar":
            raise ValueError("auto metadata reception needs fec='polar'")
        self.auto = auto
        # auto: size the window for the LARGEST mode (170 B) + metadata symbols
        self.modem = Modem(170 if auto else payload_size, params,
                           callsign="X" if auto else None)
        self._span = self.modem.burst_samples()
        self.OVERLAP = self._span + 4 * params.sym_len
        self.frames = []
        self._tail = np.zeros(0, np.float32)
        self._recent = []                  # (absolute_position, payload)
        self._buf_abs = 0                  # absolute stream index of buf[0]
        self.input = self.add_stream_input("in", np.float32,
                                           min_items=4 * params.sym_len)
        self.add_message_output("rx")

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n == 0:
            if self.input.finished():
                io.finished = True
            return
        buf = np.concatenate([self._tail, inp[:n]])
        # ALL bursts in the window, time-ordered — one rx() per work() call
        # used to drop every burst but one when big chunks arrived. Dedup is by
        # absolute POSITION (tail overlap re-decodes the same burst), so a
        # genuinely retransmitted identical payload still comes through.
        span = self._span
        if self.auto:
            decoded = [(pos, (cs, pl.rstrip(b"\x00")))
                       for pos, cs, pl in demodulate_all_auto(buf, self.modem.params)]
        else:
            decoded = self.modem.rx_all(buf)
        for pos, payload in decoded:
            abs_pos = self._buf_abs + pos
            if any(pay == payload and abs(abs_pos - p) < span
                   for p, pay in self._recent):
                continue
            self._recent = (self._recent + [(abs_pos, payload)])[-8:]
            self.frames.append(payload)
            if self.auto:
                mio.post("rx", Pmt.map({"callsign": payload[0],
                                        "payload": Pmt.blob(payload[1])}))
            else:
                mio.post("rx", Pmt.blob(payload))
        keep = min(len(buf), self.OVERLAP)
        self._buf_abs += len(buf) - keep
        self._tail = buf[len(buf) - keep:].copy()
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
