"""File record and playback; the port's counterpart of ``examples/file_trx.py``
(reference: ``examples/file-trx/{tx,rx}.rs``).

The IQ file format comes from the extension (``cs8``: interleaved complex
int8, ``cf32``: complex float32), or from ``--format-in``/``--format-out``; a
power meter taps the stream and warns of clipping (|x| > 0.95) while printing
the running average and peak magnitudes; ``--samples`` bounds a recording
with ``Head``::

    rx:  [Seify source | --input FILE] -> power meter -> FILE (converted)
    tx:  FILE -> (format conversion) -> Seify sink

Run: ``python -m futuresdr_tpu_torch.apps.file_trx rx --out capture.cf32
--samples 100000``; ``python -m futuresdr_tpu_torch.apps.file_trx tx --input
capture.cf32``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..blocks import Apply, FileSink, FileSource, Head, SeifyBuilder
from ..runtime import Flowgraph, Runtime

__all__ = ["FORMATS", "sniff", "cs8_to_cf32", "cf32_to_cs8", "file_iq_source",
           "power_meter", "main"]

FORMATS = ("cs8", "cf32")


def sniff(path: str, override) -> str:
    fmt = override or path.rsplit(".", 1)[-1]
    if fmt not in FORMATS:
        raise SystemExit(f"Unrecognized format {fmt!r} (known: {FORMATS})")
    return fmt


def cs8_to_cf32() -> Apply:
    """Interleaved int8 pairs (the stream's int16 items) to complex64."""
    def cvt(x):
        pairs = x.view(np.int8).astype(np.float32).reshape(-1, 2) / 127.0
        return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)
    return Apply(cvt, np.int16, np.complex64)


def cf32_to_cs8() -> Apply:
    def cvt(x):
        out = np.empty((len(x), 2), np.int8)
        out[:, 0] = np.clip(x.real * 127.0, -127, 127)
        out[:, 1] = np.clip(x.imag * 127.0, -127, 127)
        return out.view(np.int16).reshape(-1)
    return Apply(cvt, np.complex64, np.int16)


def file_iq_source(fg: Flowgraph, path: str, fmt: str, repeat: bool):
    """``FileSource`` (and the cs8 conversion) wired into ``fg``; returns the
    block whose output is the cf32 stream."""
    if fmt == "cs8":
        src = FileSource(path, np.int16, repeat=repeat)
        cvt = cs8_to_cf32()
        fg.connect(src, cvt)
        return cvt
    return FileSource(path, np.complex64, repeat=repeat)


def power_meter() -> Apply:
    state = {"avg": 0.0, "max": 0.0, "t_clip": 0.0, "t_print": time.monotonic()}

    def meter(x):
        mags = np.abs(x)
        now = time.monotonic()
        if mags.size:
            if float(mags.max()) > 0.95 and now - state["t_clip"] > 0.1:
                state["t_clip"] = now
                print("Possible clipping!", file=sys.stderr)
            # the exponential average the reference keeps per sample
            state["avg"] = float(state["avg"] * (0.9999 ** mags.size)
                                 + mags.mean() * (1 - 0.9999 ** mags.size))
            state["max"] = max(state["max"], float(mags.max()))
        if now - state["t_print"] > 2.0:
            print(f"Average/max signal magnitudes: {state['avg']:.4f}/{state['max']:.4f}")
            state["max"] = 0.0
            state["t_print"] = now
        return x
    return Apply(meter, np.complex64, np.complex64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="file record/playback (file-trx)")
    p.add_argument("mode", choices=("tx", "rx"))
    p.add_argument("--args", default="driver=dummy,throttle=false")
    p.add_argument("-f", "--frequency", type=float, default=100e6)
    p.add_argument("-s", "--sample-rate", type=float, default=1e6)
    p.add_argument("-g", "--gain", type=float, default=0.0)
    p.add_argument("--input", default=None)
    p.add_argument("--format-in", default=None, choices=FORMATS)
    p.add_argument("--out", default=None)
    p.add_argument("--format-out", default=None, choices=FORMATS)
    p.add_argument("--samples", type=int, default=None,
                   help="bound the recording (continuous if omitted)")
    p.add_argument("--repeat", action="store_true")
    a = p.parse_args(argv)

    fg = Flowgraph()
    if a.mode == "tx":
        if not a.input:
            raise SystemExit("tx needs --input")
        last = file_iq_source(fg, a.input, sniff(a.input, a.format_in), a.repeat)
        snk = (SeifyBuilder().args(a.args).frequency(a.frequency)
               .sample_rate(a.sample_rate).gain(a.gain).build_sink())
        fg.connect(last, snk)
        Runtime().run(fg)
        return 0

    # rx: record from a Seify source (or convert --input)
    if not a.out:
        raise SystemExit("rx needs --out")
    if a.input:
        last = file_iq_source(fg, a.input, sniff(a.input, a.format_in), a.repeat)
    else:
        last = (SeifyBuilder().args(a.args).frequency(a.frequency)
                .sample_rate(a.sample_rate).gain(a.gain).build_source())
    if a.samples is not None:
        head = Head(np.complex64, a.samples)
        fg.connect(last, head)
        last = head
    meter = power_meter()
    fg.connect(last, meter)
    fmt_out = sniff(a.out, a.format_out)
    if fmt_out == "cs8":
        snk = FileSink(a.out, np.int16)
        fg.connect(meter, cf32_to_cs8(), snk)
    else:
        snk = FileSink(a.out, np.complex64)
        fg.connect(meter, snk)
    Runtime().run(fg)
    print(f"wrote {snk.n_written} items to {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
