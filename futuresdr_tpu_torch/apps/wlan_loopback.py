"""WLAN loopback: TX → noisy channel → RX inside one flowgraph; the port's
counterpart of ``examples/wlan_loopback.py`` (reference:
``examples/wlan/src/bin/loopback.rs``).

``WlanEncoder`` (host) → ``Apply`` (white noise) → ``WlanDecoder``, whose
demod and batched Viterbi run on ``--device`` (default: the card; ``cpu``
runs the plain versions).

Run: ``python -m futuresdr_tpu_torch.apps.wlan_loopback [--frames 10]
[--mcs qpsk_1_2] [--noise 0.02] [--device cuda:0|cpu]``.
"""

from __future__ import annotations

import numpy as np

from ..blocks import Apply
from ..models.wlan import WlanDecoder, WlanEncoder
from ..runtime import Flowgraph, Runtime
from ..types import Pmt

__all__ = ["run", "main"]


def run(frames: int = 10, mcs: str = "qpsk_1_2", noise: float = 0.02,
        device=None, seed: int = 0) -> tuple:
    """Send ``frames`` payloads through the loopback; returns ``(sent,
    received)`` payload lists."""
    rng = np.random.default_rng(seed)
    fg = Flowgraph()
    enc = WlanEncoder(mcs)
    chan = Apply(lambda x: (x + noise * (rng.standard_normal(len(x))
                                         + 1j * rng.standard_normal(len(x)))
                            ).astype(np.complex64), np.complex64)
    dec = WlanDecoder(device=device)
    fg.connect(enc, chan, dec)

    rt = Runtime()
    running = rt.start(fg)
    sent = [f"hello wlan frame {i} ".encode() * 4 for i in range(frames)]
    for s in sent:
        running.handle.call_sync(enc, "tx", Pmt.blob(s))
    running.handle.call_sync(enc, "tx", Pmt.finished())
    running.wait_sync()
    return sent, list(dec.frames)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="WLAN loopback (PyTorch/CUDA port)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--mcs", default="qpsk_1_2")
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="torch device of the receiver (default: the card)")
    a = p.parse_args(argv)
    sent, got = run(a.frames, a.mcs, a.noise, a.device)
    ok = sum(1 for s, r in zip(sent, got) if s == r)
    print(f"{ok}/{a.frames} frames decoded correctly ({a.mcs}, noise={a.noise})")
    return 0 if ok == a.frames else 1


if __name__ == "__main__":
    raise SystemExit(main())
