"""Rattlegram acoustic modem loopback: OFDM PSK over an "audio" channel; the
port's counterpart of ``examples/rattlegram_loopback.py`` (reference:
``examples/rattlegram``).

Text payloads ride the OFDM audio waveform at 8 kHz (the default
``ModemParams``) with its FEC; the channel halves the gain and adds noise.
Host numpy, as in the reference.

Run: ``python -m futuresdr_tpu_torch.apps.rattlegram_loopback [--messages 3]
[--payload-size 48] [--noise 0.01]``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..blocks import Apply
from ..models.rattlegram import ModemReceiver, ModemTransmitter
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["run", "main"]


def run(messages: int = 3, payload_size: int = 48, noise: float = 0.01,
        seed: int = 3) -> tuple:
    """Send ``messages`` payloads through the loopback; returns ``(sent,
    received, seconds)``, ``seconds`` from the flowgraph's start to its end."""
    rng = np.random.default_rng(seed)
    fg = Flowgraph()
    tx = ModemTransmitter(payload_size=payload_size)
    chan = Apply(lambda x: (0.5 * x + noise * rng.standard_normal(len(x))
                            ).astype(np.float32), np.float32)
    rx = ModemReceiver(payload_size=payload_size)
    fg.connect(tx, chan, rx)

    sent = [f"over-the-air text {i}".encode() for i in range(messages)]
    t0 = time.perf_counter()
    rt = Runtime()
    running = rt.start(fg)
    for pl in sent:
        r = rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.blob(pl)))
        if r != Pmt.ok():
            raise RuntimeError(f"the transmitter refused a payload: {r}")
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    return sent, list(rx.frames), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--messages", type=int, default=3)
    p.add_argument("--payload-size", type=int, default=48)
    p.add_argument("--noise", type=float, default=0.01)
    a = p.parse_args(argv)
    sent, got, _seconds = run(a.messages, a.payload_size, a.noise)
    print(f"decoded {len(got)}/{a.messages} payloads:")
    for f in got:
        print(f"  {f!r}")
    return 0 if got == sent else 1


if __name__ == "__main__":
    raise SystemExit(main())
