"""Audio modem over a simulated acoustic channel; the port's counterpart of
``examples/modem_ota.py`` (reference: ``examples/rattlegram``).

One burst at 8 kHz, half its gain, between silences, with white noise. With
``--callsign`` the burst carries the polar FEC and the in-band metadata
(callsign and operation mode), so the receiver needs no payload size;
without it, the convolutional FEC at a 64-byte payload. Host numpy, as in the
reference.

Run: ``python -m futuresdr_tpu_torch.apps.modem_ota ["message"] [--noise 0.02]
[--callsign N0CALL]``.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..models.rattlegram import Modem, ModemParams, demodulate_auto

__all__ = ["run", "main"]


def run(message: str = "hello through the speaker", noise: float = 0.02,
        callsign: Optional[str] = None, seed: int = 0) -> tuple:
    """Send ``message`` over the channel; returns ``(burst_samples, callsign,
    payload)``: the burst's length, the callsign decoded from the metadata
    (None without ``callsign``) and the payload decoded (None if none was),
    its zero padding stripped."""
    rng = np.random.default_rng(seed)
    if callsign:
        m = Modem(payload_size=85, params=ModemParams(fec="polar"), callsign=callsign)
    else:
        m = Modem(payload_size=64)
    audio = m.tx(message.encode())
    channel = np.concatenate([np.zeros(1000, np.float32), 0.5 * audio,
                              np.zeros(500, np.float32)])
    channel += noise * rng.standard_normal(len(channel)).astype(np.float32)
    if callsign:
        got = demodulate_auto(channel, m.params)
        if got is None:
            return len(audio), None, None
        cs, payload = got
        return len(audio), cs, payload.rstrip(b"\x00")
    payload = m.rx(channel)
    return len(audio), None, None if payload is None else payload.rstrip(b"\x00")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("message", nargs="?", default="hello through the speaker")
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--callsign", default=None,
                   help="polar fec + in-band metadata: RX needs no payload size")
    a = p.parse_args(argv)
    n, cs, payload = run(a.message, a.noise, a.callsign)
    print(f"burst: {n} samples @8 kHz = {n / 8000:.2f} s")
    if a.callsign:
        print(f"decoded from {cs}:", payload)
    else:
        print("decoded:", payload)
    return 0 if payload == a.message.encode() else 1


if __name__ == "__main__":
    raise SystemExit(main())
