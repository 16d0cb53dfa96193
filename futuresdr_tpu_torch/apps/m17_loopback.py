"""M17 loopback: LSF beacons and a stream transmission → 4FSK baseband → noisy
channel → RX inside one flowgraph; the port's counterpart of
``examples/m17_loopback.py`` (reference: ``examples/m17``).

Messages go in on the transmitter's ``tx`` message port; decoded link-setup
frames and the stream transmission come back on the receiver's ``rx`` port
and are printed. The transceiver is host numpy, as in the reference: M17's
frames (244 and 148 trellis steps) stay below the 512 at which
``viterbi_decode_m17`` goes to the card.

Run: ``python -m futuresdr_tpu_torch.apps.m17_loopback [--frames 3]
[--snr-noise 0.05] [--src N0CALL]``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..blocks import Apply
from ..models.m17 import M17Receiver, M17Transmitter
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["run", "main", "PAYLOAD"]

#: the reference app's stream-mode payload (36 bytes: 3 stream frames)
PAYLOAD = b"M17 stream-mode payload over the air"


def run(frames: int = 3, noise: float = 0.05, src: str = "N0CALL",
        payload: bytes = PAYLOAD, seed: int = 7) -> tuple:
    """Send ``frames`` LSF beacons, then ``payload`` in stream mode, through
    the loopback; returns ``(metas, lsfs, transmissions, seconds)``: the
    beacons' meta fields as sent, the LSFs decoded (the stream
    transmission's own link-setup frame among them), the decoded ``(lsf,
    payload)`` transmissions, and the seconds from the flowgraph's start to
    its end."""
    rng = np.random.default_rng(seed)
    fg = Flowgraph()
    tx = M17Transmitter(src_callsign=src)
    chan = Apply(lambda x: (x + noise * rng.standard_normal(len(x))).astype(np.float32),
                 np.float32)
    rx = M17Receiver()
    fg.connect(tx, chan, rx)

    t0 = time.perf_counter()
    rt = Runtime()
    running = rt.start(fg)
    metas = [f"beacon {i}".ljust(14).encode() for i in range(frames)]
    for meta in metas:
        r = rt.scheduler.run_coro_sync(running.handle.call(
            tx, "tx", Pmt.map({"dst": "@ALL", "src": src, "meta": Pmt.blob(meta)})))
        if r != Pmt.ok():
            raise RuntimeError(f"the transmitter refused a beacon: {r}")
    # stream mode: a payload blob rides LICH-chunked frames after the LSF
    r = rt.scheduler.run_coro_sync(running.handle.call(
        tx, "tx", Pmt.map({"dst": "SP5WWP", "payload": Pmt.blob(payload)})))
    if r != Pmt.ok():
        raise RuntimeError(f"the transmitter refused the payload: {r}")
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    return metas, list(rx.frames), list(rx.transmissions), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--snr-noise", type=float, default=0.05,
                   help="additive noise sigma on the 4FSK baseband")
    p.add_argument("--src", default="N0CALL")
    a = p.parse_args(argv)
    metas, lsfs, transmissions, _seconds = run(a.frames, a.snr_noise, a.src)
    print(f"decoded {len(lsfs)}/{a.frames + 1} LSFs:")
    for f in lsfs:
        print(f"  {f.src} -> {f.dst}  meta={f.meta!r}")
    print(f"stream transmissions: {len(transmissions)}")
    for lsf, pl in transmissions:
        print(f"  {lsf.src if lsf else '?'} -> {lsf.dst if lsf else '?'}: {pl!r}")
    beacons = [f.meta for f in lsfs if f.meta in metas]
    if beacons != metas or len(transmissions) != 1 \
            or transmissions[0][1][:len(PAYLOAD)] != PAYLOAD:
        print("not every frame was decoded")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
