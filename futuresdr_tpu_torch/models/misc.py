"""Small example transceivers: CW (Morse), SSB demodulation, keyfob OOK.

Reference: ``examples/cw`` (Morse keying), ``examples/ssb`` (SSB receiver from IQ
recording), ``examples/keyfob`` (rolling-code OOK transmitter).

The port's copy of ``futuresdr_tpu/models/misc.py``, over the port's
``dsp.firdes`` and ``dsp.kernels``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..dsp import firdes
from ..dsp.kernels import FirFilter, Rotator

__all__ = ["MORSE_TABLE", "text_to_morse_keying", "decode_morse_keying", "cw_modulate",
           "cw_demodulate", "ssb_demodulate", "ook_modulate", "ook_demodulate"]

MORSE_TABLE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..", "0": "-----", "1": ".----", "2": "..---",
    "3": "...--", "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.", ".": ".-.-.-", ",": "--..--", "?": "..--..",
    "/": "-..-.", "=": "-...-",
}
_REVERSE = {v: k for k, v in MORSE_TABLE.items()}


def text_to_morse_keying(text: str, dot_samples: int) -> np.ndarray:
    """Text → on/off keying vector (1 dot = ``dot_samples``; dash = 3 dots;
    intra-char gap 1, inter-char 3, word gap 7 — `examples/cw` timing)."""
    out: List[np.ndarray] = []
    on, off = np.ones(dot_samples, np.float32), np.zeros(dot_samples, np.float32)
    for wi, word in enumerate(text.upper().split()):
        if wi:
            out.extend([off] * 7)
        for ci, ch in enumerate(word):
            if ch not in MORSE_TABLE:
                continue
            if ci:
                out.extend([off] * 3)
            for si, sym in enumerate(MORSE_TABLE[ch]):
                if si:
                    out.append(off)
                out.extend([on] * (1 if sym == "." else 3))
    out.extend([off] * 7)
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def decode_morse_keying(keying: np.ndarray, dot_samples: int) -> str:
    """On/off vector → text, by run-length classification."""
    k = keying > 0.5
    edges = np.flatnonzero(np.diff(k.astype(np.int8)))
    runs = np.diff(np.concatenate([[0], edges + 1, [len(k)]]))
    states = []
    val = bool(k[0]) if len(k) else False
    for r in runs:
        states.append((val, r / dot_samples))
        val = not val
    text, sym = [], []
    for on, dots in states:
        if on:
            sym.append("." if dots < 2 else "-")
        else:
            if dots >= 5:
                if sym:
                    text.append(_REVERSE.get("".join(sym), "?"))
                    sym = []
                text.append(" ")
            elif dots >= 2:
                if sym:
                    text.append(_REVERSE.get("".join(sym), "?"))
                    sym = []
    if sym:
        text.append(_REVERSE.get("".join(sym), "?"))
    return "".join(text).strip()


def cw_modulate(text: str, tone_hz: float, fs: float, wpm: float = 20.0) -> np.ndarray:
    dot = int(fs * 1.2 / wpm)
    keying = text_to_morse_keying(text, dot)
    n = np.arange(len(keying))
    return (keying * np.sin(2 * np.pi * tone_hz / fs * n)).astype(np.float32)


def cw_demodulate(audio: np.ndarray, fs: float, wpm: float = 20.0) -> str:
    dot = int(fs * 1.2 / wpm)
    env = np.abs(audio)
    lp = FirFilter(firdes.lowpass(min(0.4, 5.0 / dot), 101))
    smooth = lp.process(env)
    thresh = 0.5 * smooth.max()
    return decode_morse_keying((smooth > thresh).astype(np.float32)[50:], dot)


def ssb_demodulate(iq: np.ndarray, fs: float, bfo_offset: float,
                   sideband: str = "usb", audio_bw: float = 3000.0) -> np.ndarray:
    """SSB product detector (`examples/ssb` chain): shift the carrier to DC, select the
    sideband with a complex bandpass, take the real part."""
    rot = Rotator(-2 * np.pi * bfo_offset / fs)
    base = rot.process(iq.astype(np.complex64))
    lo, hi = (300.0 / fs, audio_bw / fs) if sideband == "usb" else \
             (-audio_bw / fs, -300.0 / fs)
    n_taps = 257
    k = np.arange(n_taps) - (n_taps - 1) / 2
    f1, f2 = sorted((lo, hi))
    h = (np.exp(2j * np.pi * f2 * k) - np.exp(2j * np.pi * f1 * k)) / \
        (2j * np.pi * k + 1e-30)
    h[(n_taps - 1) // 2] = 2 * np.pi * (f2 - f1) / (2 * np.pi)
    h *= np.hamming(n_taps)
    filt = FirFilter(h.astype(np.complex64))
    return filt.process(base).real.astype(np.float32)


def ook_modulate(bits: np.ndarray, fs: float, bit_rate: float,
                 preamble: int = 8) -> np.ndarray:
    """Keyfob-style OOK burst: preamble alternation + Manchester-coded payload
    (`examples/keyfob` role)."""
    spb = int(fs / bit_rate)
    chips = []
    for _ in range(preamble):
        chips += [1.0] * spb + [0.0] * spb
    chips += [0.0] * (4 * spb)          # sync gap
    for b in bits:
        chips += ([1.0] * spb + [0.0] * spb) if b else ([0.0] * spb + [1.0] * spb)
    return np.asarray(chips, dtype=np.float32)


def ook_demodulate(env: np.ndarray, fs: float, bit_rate: float,
                   n_bits: int) -> Optional[np.ndarray]:
    """Envelope → bits: find the sync gap after the preamble, then Manchester-slice."""
    spb = int(fs / bit_rate)
    k = (env > 0.5 * env.max()).astype(np.int8)
    # find a low run of ≥3 bit periods (the sync gap), after activity
    low_run = 0
    start = None
    seen_activity = False
    for i, v in enumerate(k):
        if v:
            if seen_activity and low_run >= 3 * spb:
                # anchor on the run START + its fixed length (the preamble's
                # trailing low half + the 4-half-bit sync gap): a payload
                # beginning with a 0-bit (low-first Manchester) extends the low
                # run, so the first HIGH after it is NOT the payload edge
                start = i - low_run + 5 * spb
                break
            low_run = 0
            seen_activity = True
        else:
            low_run += 1
    if start is None:
        return None
    bits = []
    pos = start
    for _ in range(n_bits):
        first = k[pos:pos + spb].mean()
        second = k[pos + spb:pos + 2 * spb].mean()
        if first < 0.5 and second < 0.5:
            return None
        bits.append(1 if first > second else 0)
        pos += 2 * spb
    return np.asarray(bits, dtype=np.uint8)
