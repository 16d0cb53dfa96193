"""Morse beacon: text → CW audio in a WAV file and back; the port's
counterpart of ``examples/cw_beacon.py`` (reference: ``examples/cw``).

``VectorSource -> WavSink`` writes the keyed 600 Hz tone at 8 kHz as 16-bit
PCM; the text is then decoded from what the file holds. Host numpy, as in the
reference.

Run: ``python -m futuresdr_tpu_torch.apps.cw_beacon ["TEXT"] [--wav cw.wav]
[--wpm 20] [--tone 600]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import wave
from typing import Optional

import numpy as np

from ..blocks import VectorSource, WavSink
from ..models.misc import cw_demodulate, cw_modulate
from ..runtime import Flowgraph, Runtime

__all__ = ["run", "read_wav", "main", "FS"]

FS = 8000.0


def read_wav(path: str) -> np.ndarray:
    """A mono 16-bit PCM WAV file's samples as float32, on ``WavSink``'s
    scale (full scale 32767)."""
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0


def run(text: str = "CQ CQ DE FUTURESDR TPU K", wav: Optional[str] = None,
        wpm: float = 20.0, tone: float = 600.0) -> tuple:
    """Key ``text``, write it through the flowgraph into ``wav`` (default:
    ``cw.wav`` in the temporary directory) and decode it from the file;
    returns ``(path, decoded)``."""
    path = wav or os.path.join(tempfile.gettempdir(), "cw.wav")
    audio = cw_modulate(text, tone, FS, wpm)
    fg = Flowgraph()
    fg.connect(VectorSource(audio), WavSink(path, int(FS)))
    Runtime().run(fg)
    return path, cw_demodulate(read_wav(path), FS, wpm)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("text", nargs="?", default="CQ CQ DE FUTURESDR TPU K")
    p.add_argument("--wav", default=None, help="output WAV (default: cw.wav in the "
                                               "temporary directory)")
    p.add_argument("--wpm", type=float, default=20.0)
    p.add_argument("--tone", type=float, default=600.0)
    a = p.parse_args(argv)
    path, decoded = run(a.text, a.wav, a.wpm, a.tone)
    print(f"wrote {path}; decoding back:")
    print(" ", decoded)
    return 0 if decoded == " ".join(a.text.upper().split()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
