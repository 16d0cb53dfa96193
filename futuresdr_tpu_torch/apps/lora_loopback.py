"""LoRa loopback: chirp TX → noisy channel → RX inside one flowgraph; the
port's counterpart of ``examples/lora_loopback.py`` (reference:
``examples/lora``).

``LoraTransmitter`` → ``Apply`` (white noise) → ``LoraReceiver`` on the port's
runtime; the transceiver is host numpy, as in the reference. Each decoded
payload is printed, then the count.

Run: ``python -m futuresdr_tpu_torch.apps.lora_loopback [--frames 8] [--sf 7]
[--cr 2] [--noise 0.2]``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..blocks import Apply
from ..models.lora import LoraParams, LoraReceiver, LoraTransmitter
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["run", "main"]


def run(frames: int = 8, sf: int = 7, cr: int = 2, noise: float = 0.2,
        seed: int = 0) -> tuple:
    """Send ``frames`` payloads through the loopback; returns ``(sent,
    received, crc_flags, seconds)``, ``seconds`` from the flowgraph's start to
    its end."""
    params = LoraParams(sf=sf, cr=cr)
    rng = np.random.default_rng(seed)
    fg = Flowgraph()
    tx = LoraTransmitter(params)
    chan = Apply(lambda x: (x + noise * (rng.standard_normal(len(x))
                                         + 1j * rng.standard_normal(len(x)))
                            ).astype(np.complex64), np.complex64)
    rx = LoraReceiver(params)
    fg.connect(tx, chan, rx)

    t0 = time.perf_counter()
    rt = Runtime()
    running = rt.start(fg)
    sent = [f"lora sf{sf} payload {i}".encode() for i in range(frames)]
    for s in sent:
        rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.blob(s)))
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    return sent, list(rx.frames), list(rx.crc_flags), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--sf", type=int, default=7)
    p.add_argument("--cr", type=int, default=2)
    p.add_argument("--noise", type=float, default=0.2)
    a = p.parse_args(argv)
    sent, got, crc, _seconds = run(a.frames, a.sf, a.cr, a.noise)
    for payload, ok in zip(got, crc):
        print(f"rx: {payload!r} crc {'ok' if ok else 'BAD'}")
    ok = len(set(sent) & set(got))
    print(f"{ok}/{a.frames} frames decoded (SF{a.sf} CR4/{4 + a.cr}, noise={a.noise}); "
          f"CRC ok: {sum(crc)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
