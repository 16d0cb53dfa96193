"""ZigBee (802.15.4 O-QPSK, 2.4 GHz DSSS) loopback over a noisy channel; the
port's counterpart of ``examples/zigbee_loopback.py`` (reference:
``examples/zigbee``).

Payload blobs go in on the transmitter's ``tx`` message port, travel as
O-QPSK baseband at 4 samples a chip through an AWGN channel, and the MAC
payloads whose FCS checks print on the way out. Host numpy, as in the
reference.

Run: ``python -m futuresdr_tpu_torch.apps.zigbee_loopback [--frames 4]
[--noise 0.1]``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..blocks import Apply
from ..models.zigbee import ZigbeeReceiver, ZigbeeTransmitter
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["run", "main"]


def run(frames: int = 4, noise: float = 0.1, seed: int = 11) -> tuple:
    """Send ``frames`` payloads through the loopback; returns ``(sent,
    received, seconds)``: ``received`` holds the MAC payloads whose FCS
    checked, ``seconds`` runs from the flowgraph's start to its end."""
    rng = np.random.default_rng(seed)
    fg = Flowgraph()
    tx = ZigbeeTransmitter()
    chan = Apply(lambda x: (x + noise * (rng.standard_normal(len(x))
                                         + 1j * rng.standard_normal(len(x)))
                            ).astype(np.complex64), np.complex64)
    rx = ZigbeeReceiver()
    fg.connect(tx, chan, rx)

    t0 = time.perf_counter()
    rt = Runtime()
    running = rt.start(fg)
    sent = [f"zigbee frame {i}".encode() for i in range(frames)]
    for pl in sent:
        r = rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.blob(pl)))
        if r != Pmt.ok():
            raise RuntimeError(f"the transmitter refused a payload: {r}")
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    return sent, list(rx.frames), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--noise", type=float, default=0.1)
    a = p.parse_args(argv)
    sent, got, _seconds = run(a.frames, a.noise)
    print(f"decoded {len(got)}/{a.frames} MPDUs:")
    for f in got:
        print(f"  {f!r}")
    return 0 if got == sent else 1


if __name__ == "__main__":
    raise SystemExit(main())
