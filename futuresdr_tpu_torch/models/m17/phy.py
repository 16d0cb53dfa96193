"""M17 4FSK PHY: LSF framing, RRC-shaped modulation, symbol sync, demodulation.

Re-design of the reference M17 example's PHY (``examples/m17/src/``: LSF codec,
``SymbolSync``, encoder/decoder blocks). 4FSK at ±1/±3 symbol levels, 10 samples/symbol
with root-raised-cosine shaping; frames start with a known 16-bit sync word.

The port's copy of ``futuresdr_tpu/models/m17/phy.py``, its arithmetic
unchanged. The LSF (244 trellis steps) and stream frames (148) stay below
``codec.viterbi_decode_m17``'s device threshold, so the demodulators decode
on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ...dsp import firdes
from . import codec

__all__ = ["Lsf", "build_lsf_frame", "build_stream_frames", "modulate",
           "demodulate_stream", "demodulate_payload_stream", "SPS",
           "SYNC_LSF", "SYNC_STR"]

SPS = 10                      # samples per symbol
SYNC_LSF = 0x55F7             # LSF sync word (M17 spec §3.2)
SYNC_STR = 0xFF5D             # stream-frame sync word

_DIBIT_TO_SYM = {0b01: 3.0, 0b00: 1.0, 0b10: -1.0, 0b11: -3.0}
_SYM_LEVELS = np.array([3.0, 1.0, -1.0, -3.0])
_SYM_TO_DIBIT = {3.0: 0b01, 1.0: 0b00, -1.0: 0b10, -3.0: 0b11}


@dataclass
class Lsf:
    """Link Setup Frame: dst/src callsigns + type + meta (240 bits with CRC)."""

    dst: str
    src: str
    type_field: int = 0x0002    # data mode
    meta: bytes = bytes(14)

    def to_bytes(self) -> bytes:
        d = codec.encode_callsign(self.dst).to_bytes(6, "big")
        s = codec.encode_callsign(self.src).to_bytes(6, "big")
        t = self.type_field.to_bytes(2, "big")
        body = d + s + t + self.meta[:14].ljust(14, b"\x00")
        crc = codec.crc16_m17(body)
        return body + crc.to_bytes(2, "big")

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["Lsf"]:
        if len(raw) != 30:
            return None
        if codec.crc16_m17(raw[:28]) != int.from_bytes(raw[28:30], "big"):
            return None
        return cls(
            dst=codec.decode_callsign(int.from_bytes(raw[0:6], "big")),
            src=codec.decode_callsign(int.from_bytes(raw[6:12], "big")),
            type_field=int.from_bytes(raw[12:14], "big"),
            meta=raw[14:28],
        )


def _bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8)).astype(np.uint8)


def _sync_symbols(word: int) -> np.ndarray:
    bits = [(word >> (15 - i)) & 1 for i in range(16)]
    return np.array([_DIBIT_TO_SYM[(bits[2 * i] << 1) | bits[2 * i + 1]]
                     for i in range(8)])


def build_lsf_frame(lsf: Lsf) -> np.ndarray:
    """LSF → symbol sequence: sync (8 sym) + conv-coded punctured LSF (184 sym)."""
    bits = _bits(lsf.to_bytes())                       # 240
    flushed = np.concatenate([bits, np.zeros(4, np.uint8)])
    coded = codec.conv_encode_m17(flushed)             # 488
    punct = codec.puncture_p1(coded)                   # 368
    dibits = punct.reshape(-1, 2)
    syms = np.array([_DIBIT_TO_SYM[(a << 1) | b] for a, b in dibits])
    return np.concatenate([_sync_symbols(SYNC_LSF), syms])


def _dibits_to_syms(bits: np.ndarray) -> np.ndarray:
    dib = bits.reshape(-1, 2)
    return np.array([_DIBIT_TO_SYM[(a << 1) | b] for a, b in dib])


def build_stream_frames(lsf: Lsf, payload: bytes) -> np.ndarray:
    """Stream mode (`encoder.rs:226-289`): LSF frame, then one 192-symbol frame
    per 16-byte payload chunk — sync + Golay-coded LICH (1/6 of the LSF, cycling)
    + conv-coded P2-punctured (frame-number ‖ chunk); the last frame sets the
    EOS bit (0x8000) in its frame number."""
    lsf_bytes = lsf.to_bytes()
    chunks = [payload[i:i + 16] for i in range(0, max(len(payload), 1), 16)]
    parts = [build_lsf_frame(lsf)]
    for fn, chunk in enumerate(chunks):
        lich_bits = codec.lich_encode(lsf_bytes, fn % 6)
        # frame numbers wrap below the EOS bit (real M17 wraps at 0x8000; a
        # >512 KiB transmission will mis-sort on reassembly, but never crash)
        fn_field = (fn % 0x8000) | (0x8000 if fn == len(chunks) - 1 else 0)
        body = fn_field.to_bytes(2, "big") + chunk.ljust(16, b"\x00")
        bits = np.concatenate([_bits(body), np.zeros(4, np.uint8)])   # 148
        punct = codec.puncture_p2(codec.conv_encode_m17(bits))        # 272
        parts.append(np.concatenate([_sync_symbols(SYNC_STR),
                                     _dibits_to_syms(lich_bits),
                                     _dibits_to_syms(punct)]))
    return np.concatenate(parts)


def _rrc(sps: int = SPS, span: int = 8, rolloff: float = 0.5) -> np.ndarray:
    return firdes.root_raised_cosine(span, sps, rolloff)


def modulate(symbols: np.ndarray, sps: int = SPS) -> np.ndarray:
    """Symbols → RRC-shaped baseband (real float32, frequency-deviation units)."""
    up = np.zeros(len(symbols) * sps)
    up[::sps] = symbols
    h = _rrc(sps)
    return np.convolve(up, h, mode="full").astype(np.float32)


def demodulate_stream(samples: np.ndarray, sps: int = SPS) -> List[Lsf]:
    """Matched filter → sync correlation → symbol slicing → depuncture/Viterbi/CRC;
    LSF frames in time order (see ``_lsf_positions`` for the scan itself)."""
    return [lsf for _, lsf, _agree in _lsf_positions(samples, sps)]


def _hard_bits(syms: np.ndarray) -> np.ndarray:
    """Symbols → hard dibits (level map: 3→01, 1→00, −1→10, −3→11)."""
    out = np.empty(2 * len(syms), dtype=np.uint8)
    out[0::2] = (syms < 0).astype(np.uint8)
    out[1::2] = (np.abs(syms) > 2).astype(np.uint8)
    return out


def demodulate_payload_stream(samples: np.ndarray, sps: int = SPS):
    """Stream-mode receiver (`decoder.rs` role): returns [(lsf, payload)] per
    transmission. Frames are gated by their LICH Golay decode; the LSF comes from
    the link-setup frame when decodable, else reassembled from the six cycling
    LICH chunks (CRC-checked either way)."""
    return [t[1:] for t in _transmissions(samples, sps)]


def _transmissions(samples: np.ndarray, sps: int = SPS) -> List[tuple]:
    """:func:`demodulate_payload_stream`'s transmissions, each with the sample
    position of its first stream frame: ``[(pos, lsf, payload, complete)]``."""
    h = _rrc(sps)
    mf = np.convolve(samples.astype(np.float64), h, mode="full")
    gain = np.sum(h * h) if len(h) else 1.0
    delay = len(h) - 1
    sync = _sync_symbols(SYNC_STR)
    n_frame_syms = 8 + 48 + 136
    hits: List[tuple] = []         # (norm, pos, fn, eos, chunk, lich, agree)
    for phase in range(sps):
        sym_stream = mf[delay + phase::sps] / gain
        if len(sym_stream) < n_frame_syms:
            continue
        c = np.correlate(sym_stream, sync, mode="valid")
        e = np.convolve(sym_stream ** 2, np.ones(8), mode="full")[7:7 + len(c)]
        norm = c / np.maximum(np.sqrt(e * np.sum(sync ** 2)), 1e-9)
        for idx in np.nonzero(norm > 0.9)[0]:
            # absolute energy gate: the NORMALIZED correlation passes on pure
            # noise windows by chance, and the un-CRC'd Golay gate accepts
            # ~57% of random words — require the sync window to carry real
            # symbol energy (levels are ±1/±3; noise-only windows sit orders
            # of magnitude below). Found by the r4 seeded fuzz campaign: a
            # ghost frame in the leading pad broke fn contiguity under noise.
            if e[idx] < 8 * 0.25:
                continue
            syms = sym_stream[idx + 8: idx + n_frame_syms]
            if len(syms) < 48 + 136:
                continue
            lich = codec.lich_decode(_hard_bits(syms[:48]))
            if lich is None:
                continue                    # Golay gate: not a real stream frame
            d = -np.abs(syms[48:, None] - _SYM_LEVELS[None, :]) ** 2
            msb = np.maximum(d[:, 2], d[:, 3]) - np.maximum(d[:, 0], d[:, 1])
            lsb = np.maximum(d[:, 0], d[:, 3]) - np.maximum(d[:, 1], d[:, 2])
            llrs = np.empty(2 * 136)
            llrs[0::2] = msb
            llrs[1::2] = lsb
            bits = codec.viterbi_decode_m17(codec.depuncture_p2(llrs, 296), 148)
            # codeword validity score: re-encode the decoded bits and measure
            # sign-agreement with the received LLRs. A correctly-framed hit
            # re-encodes to ~100%; outright garbage sits near 50% (hard gate
            # below). A MISFRAMED ghost is subtler — conv codes are
            # time-invariant, so a shifted window still decodes to a mostly
            # consistent codeword (~0.95) — but it never beats the true
            # frame's exact agreement, so the score is the primary NMS rank
            # (r5 fuzz campaign, offset 62682: a saturated-correlation ghost
            # 330 samples early out-ranked the real EOS frame under noise
            # when the rank was correlation alone, suppressing it).
            agree = _codeword_agreement(llrs, bits, codec.puncture_p2)
            if agree < 0.8:
                continue                    # not a codeword at all
            body = np.packbits(bits[:144]).tobytes()
            fn_field = int.from_bytes(body[:2], "big")
            hits.append((float(norm[idx]), idx * sps + phase, fn_field & 0x7FFF,
                         bool(fn_field & 0x8000), body[2:18], lich, agree))
    # a correlation sidelobe or off-phase hit can pass the Golay gate while
    # garbling the un-CRC'd payload: non-maximum suppression in time keeps only
    # the best hit within each frame-length window, ranked by codeword
    # agreement FIRST (the sync correlation saturates at high SNR and cannot
    # separate a misframed ghost from the true frame), correlation second
    hits.sort(key=lambda t: (-t[6], -t[0]))
    # Where the port departs from the reference: two stream frames never
    # overlap, so the window is a whole frame less the guard below. The
    # reference's three quarters of a frame let a misframed ghost 1,517
    # samples into an EOS frame (its window reaching into the gap and the
    # next transmission's LSF, fn 0, agreement 0.84) open a group of its own
    # that broke the next transmission's contiguity (ROADMAP Queue 3).
    min_gap = n_frame_syms * sps - 8 * sps
    accepted: List[tuple] = []
    lsf_cands = _lsf_positions(samples, sps, content_dedup=False)
    lsfs = {pos: lsf for pos, lsf, _a in lsf_cands}
    lsf_agree = {pos: a for pos, _l, a in lsf_cands}
    # a stream frame cannot START inside a decoded link-setup frame: the LSF
    # body can correlate > 0.9 against the stream sync AND pass the (un-CRC'd)
    # Golay gate by chance, injecting a ghost frame whose fn breaks the
    # contiguity check (found by the r4 seeded fuzz campaign, clean signal).
    # Guard margin: under noise the LSF position lands a few samples late, and
    # the FIRST stream frame starts exactly at lsf+span — only reject hits
    # clearly interior to the LSF span, never the adjacent legitimate frame.
    lsf_span = (8 + 184) * sps
    guard = 8 * sps
    for hit in hits:
        # comparative guard (r5 campaign offset 166156, the eighth finding):
        # CRC16 alone admits one chance ghost LSF in ~65k candidate windows,
        # and a hard rejection inside ANY LSF span let that ghost suppress a
        # REAL stream frame (its whole span was quarantined). An LSF only
        # suppresses the stream hits it OUT-SCORES on codeword agreement —
        # the true-LSF case still rejects misframed stream ghosts (LSF ~1.0
        # vs ghost ≤0.95), while a weak chance ghost (0.905) cannot veto a
        # perfect frame (1.0)
        if any(p + guard <= hit[1] < p + lsf_span - guard
               and lsf_agree[p] > hit[6]
               for p in lsfs):
            continue
        if all(abs(hit[1] - a[1]) >= min_gap for a in accepted):
            accepted.append(hit)
    frames = {a[1]: a[1:] for a in accepted}
    # group frames into transmissions (EOS closes a group)
    out = []
    group: List[tuple] = []
    for key in sorted(frames):
        group.append(frames[key])
        if group[-1][2]:                   # EOS
            out.append((group[0][0], *_finish_group(group, lsfs)))
            group = []
    if group:
        out.append((group[0][0], *_finish_group(group, lsfs)))
    return out


def _lsf_positions(samples: np.ndarray, sps: int, content_dedup: bool = True):
    """LSF frames with their sample positions, in time order.

    ``content_dedup=True`` is the ``demodulate_stream`` semantic: each distinct
    LSF once per buffer. ``False`` keeps every occurrence (deduped only across
    sample phases of the same frame) — stream-mode attribution needs the
    repeated link-setup frame before EACH transmission, even when identical.
    """
    h = _rrc(sps)
    mf = np.convolve(samples.astype(np.float64), h, mode="full")
    gain = np.sum(h * h) if len(h) else 1.0
    delay = len(h) - 1
    sync = _sync_symbols(SYNC_LSF)
    n_frame_syms = 8 + 184
    # per dedup key keep the MAX-agreement candidate (first-found kept an
    # off-center phase's weaker decode); the floor mirrors the stream path's
    # not-a-codeword gate — plausibility RANKING between an LSF and the
    # stream hits inside its span happens in demodulate_payload_stream
    best: dict = {}
    for phase in range(sps):
        sym_stream = mf[delay + phase::sps] / gain
        if len(sym_stream) < n_frame_syms:
            continue
        c = np.correlate(sym_stream, sync, mode="valid")
        e = np.convolve(sym_stream ** 2, np.ones(8), mode="full")[7:7 + len(c)]
        norm = c / np.maximum(np.sqrt(e * np.sum(sync ** 2)), 1e-9)
        for idx in np.nonzero(norm > 0.9)[0]:
            syms = sym_stream[idx + 8: idx + n_frame_syms]
            if len(syms) < 184:
                continue
            dec = _decode_lsf_symbols(syms)
            if dec is None:
                continue
            lsf, agree = dec
            pos = idx * sps + phase
            key = (lsf.to_bytes() if content_dedup
                   else pos // (n_frame_syms * sps // 2))
            if key not in best or agree > best[key][2]:
                best[key] = (pos, lsf, agree)
    return sorted((pos, lsf, agree) for pos, lsf, agree in best.values()
                  if agree >= 0.8)


def _finish_group(group, lsfs) -> tuple:
    """Frames of one transmission → (Lsf | None, payload in FN order, complete).

    ``complete`` is True iff the group closed with an EOS frame AND its frame
    numbers form the contiguous run 0..k — a truncated or gapped group must not
    masquerade as a whole transmission (a window that catches only the tail of
    one would otherwise emit a silently corrupted payload)."""
    start = group[0][0]
    lsf = None
    # the link-setup frame immediately precedes frame 0: only attribute an LSF
    # that is adjacent to this group, never an unrelated earlier beacon
    max_lsf_gap = (8 + 184 + 40) * SPS
    for pos, cand in sorted(lsfs.items()):
        if pos <= start and start - pos <= max_lsf_gap:
            lsf = cand
    if lsf is None:
        # reassemble from the cycling Golay-protected LICH chunks; the LSF CRC
        # (checked in Lsf.from_bytes) arbitrates
        chunks = {}
        for _, _, _, _, (li, five), _agree in group:
            chunks.setdefault(li, five)
        if set(chunks) == set(range(6)):
            lsf = Lsf.from_bytes(b"".join(chunks[i] for i in range(6)))
    ordered = sorted(group, key=lambda f: f[1])
    payload = b"".join(c for _, _, _, c, _, _ in ordered)
    fns = [f[1] for f in ordered]
    complete = group[-1][2] and fns == list(range(len(fns)))
    return lsf, payload, complete


def _codeword_agreement(llrs: np.ndarray, bits: np.ndarray, puncture_fn) -> float:
    """Re-encode ``bits`` and measure the fraction of received LLR signs the
    codeword matches — the plausibility score shared by the stream-frame and
    LSF candidate paths. A correctly-framed decode reads ~1.0; a MISFRAMED
    window's Viterbi output is still a self-consistent codeword but only
    ~0.85–0.95 against the received signs; outright garbage is ~0.5."""
    recoded = puncture_fn(codec.conv_encode_m17(bits))
    k = min(len(recoded), len(llrs))
    return float(np.mean((llrs[:k] > 0) == recoded[:k]))


def _decode_lsf_symbols(syms: np.ndarray) -> Optional[Tuple[Lsf, float]]:
    """Decode one LSF candidate window → (lsf, codeword agreement), or None.

    The agreement score (re-encode the decoded bits, fraction of received
    LLR signs matched) is the same plausibility measure the stream-frame
    path ranks by. It exists because CRC16 alone is NOT a sufficient gate at
    campaign scale: one in ~65k random decodes passes by chance, and the
    r5 fuzz campaign (offset 166156, its eighth real finding) drew exactly
    that — a stream-frame body decoding as a CRC-valid ghost LSF with
    garbage callsigns, whose interior guard then suppressed the REAL frame
    fn=2 sitting inside its span. A true LSF re-encodes at ~1.0 (0.95 at
    off-center sample phases); the chance-CRC ghost measured 0.905."""
    # soft dibit LLRs from symbol amplitude: sym > 0 ⇒ msb 0; |sym| > 2 ⇒ lsb... use
    # per-bit distances to the four levels
    d = -np.abs(syms[:, None] - _SYM_LEVELS[None, :]) ** 2    # [n, 4]
    # level order [3, 1, -1, -3] ↔ dibits [01, 00, 10, 11]
    msb = np.maximum(d[:, 2], d[:, 3]) - np.maximum(d[:, 0], d[:, 1])
    lsb = np.maximum(d[:, 0], d[:, 3]) - np.maximum(d[:, 1], d[:, 2])
    llrs = np.empty(2 * len(syms))
    llrs[0::2] = msb
    llrs[1::2] = lsb
    dep = codec.depuncture_p1(llrs, 488)
    bits244 = codec.viterbi_decode_m17(dep, 244)
    lsf = Lsf.from_bytes(np.packbits(bits244[:240]).tobytes())
    if lsf is None:
        return None
    return lsf, _codeword_agreement(llrs, bits244, codec.puncture_p1)
