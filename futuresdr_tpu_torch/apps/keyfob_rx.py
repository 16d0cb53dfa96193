"""Keyfob OOK transceiver; the port's counterpart of ``examples/keyfob_rx.py``
(reference: ``examples/keyfob``: capture replay, envelope, Manchester slicer;
tx: bits to an OOK burst).

rx, as blocks on the Seify file-replay driver (``hw/__init__.py``)::

    SeifySource(driver=file) -> Apply(|x|) [envelope] -> Fir(lowpass) ->
    VectorSink -> host Manchester slicer (models/misc.ook_demodulate)

tx::

    ook_modulate(bits) x carrier -> VectorSource -> FileSink (a cf32 burst)

With no ``--input`` the app first runs its own tx to a temporary capture
(key code 0xA53C96, 24 bits), then decodes it and checks the bits: a
loopback that checks itself. Host numpy, as in the reference.

Run: ``python -m futuresdr_tpu_torch.apps.keyfob_rx``               (loopback)
     ``python -m futuresdr_tpu_torch.apps.keyfob_rx --input burst.cf32``
     ``python -m futuresdr_tpu_torch.apps.keyfob_rx tx --out burst.cf32``
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np

from ..blocks import Apply, FileSink, Fir, SeifyBuilder, VectorSink, VectorSource
from ..dsp import firdes
from ..models.misc import ook_demodulate, ook_modulate
from ..runtime import Flowgraph, Runtime

__all__ = ["key_bits", "run_tx", "run_rx", "main"]


def key_bits(code: int, n_bits: int) -> np.ndarray:
    return np.array([(code >> (n_bits - 1 - i)) & 1 for i in range(n_bits)],
                    dtype=np.uint8)


def run_tx(out_path: str, code: int, n_bits: int, fs: float, bit_rate: float,
           carrier: float) -> None:
    """bits -> Manchester OOK envelope -> carrier burst -> cf32 file."""
    env = ook_modulate(key_bits(code, n_bits), fs, bit_rate)
    t = np.arange(len(env)) / fs
    iq = (env * np.exp(2j * np.pi * carrier * t)).astype(np.complex64)
    pad = np.zeros(int(fs * 0.002), np.complex64)          # leading silence
    fg = Flowgraph()
    fg.connect(VectorSource(np.concatenate([pad, iq, pad])),
               FileSink(out_path, np.complex64))
    Runtime().run(fg)
    print(f"# tx: {n_bits}-bit code 0x{code:X} -> {out_path}")


def run_rx(in_path: str, n_bits: int, fs: float, bit_rate: float) -> Optional[np.ndarray]:
    """Replay the capture through the envelope chain; slice on the host."""
    fg = Flowgraph()
    src = (SeifyBuilder()
           .args(f"driver=file,path={in_path},repeat=false,throttle=false")
           .sample_rate(fs).build_source())
    envelope = Apply(lambda x: np.abs(x).astype(np.float32), np.complex64, np.float32)
    # smooth over a quarter bit period: the carrier ripple goes, the edges stay
    n_taps = max(8, int(fs / bit_rate) // 4) | 1
    lp = Fir(firdes.lowpass(1.5 * bit_rate / fs, n_taps).astype(np.float32), np.float32)
    vs = VectorSink(np.float32)
    fg.connect(src, envelope, lp, vs)
    Runtime().run(fg)
    env = vs.items()
    print(f"# rx: {len(env)} envelope samples")
    return ook_demodulate(env, fs, bit_rate, n_bits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="keyfob OOK tx/rx on the file-replay driver")
    p.add_argument("mode", nargs="?", choices=("rx", "tx"), default="rx")
    p.add_argument("--input", default=None, help="cf32 capture to decode "
                   "(default: synthesize one through the tx path first)")
    p.add_argument("--out", default=None, help="tx: write the burst here")
    p.add_argument("--code", type=lambda s: int(s, 0), default=0xA53C96)
    p.add_argument("--bits", type=int, default=24)
    p.add_argument("--rate", type=float, default=250e3)
    p.add_argument("--bit-rate", type=float, default=1000.0)
    p.add_argument("--carrier", type=float, default=20e3,
                   help="carrier offset inside the capture")
    a = p.parse_args(argv)

    if a.mode == "tx":
        run_tx(a.out or "keyfob_burst.cf32", a.code, a.bits, a.rate, a.bit_rate,
               a.carrier)
        return 0

    loopback = a.input is None
    tmp_path = None
    try:
        if loopback:
            fd, tmp_path = tempfile.mkstemp(suffix=".cf32")
            os.close(fd)
            run_tx(tmp_path, a.code, a.bits, a.rate, a.bit_rate, a.carrier)
            a.input = tmp_path
        bits = run_rx(a.input, a.bits, a.rate, a.bit_rate)
        if bits is None:
            print("# no keyfob burst found")
            return 1
        code = int("".join(map(str, bits)), 2)
        print(f"# decoded {a.bits}-bit code: 0x{code:X}")
        if loopback:
            if code != a.code:
                print(f"# loopback mismatch: 0x{code:X} != 0x{a.code:X}")
                return 1
            print("# loopback OK: code round-tripped")
        return 0
    finally:
        if tmp_path is not None:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass


if __name__ == "__main__":
    raise SystemExit(main())
