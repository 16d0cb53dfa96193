"""ADS-B receiver over a magnitude stream at 2 Msps; the port's counterpart of
``examples/adsb_rx.py`` (reference: the ``examples/adsb`` binaries).

With no input file it synthesizes a stream carrying the published Mode S test
frames (the 1090 MHz riddle's): an identification, an even and an odd
airborne position, a velocity, a DF11 all-call that acquires 4CA7E8, a DF4
altitude reply for it and a DF5 identity reply for an aircraft never
acquired, which the tracker's gate drops. ``--file`` reads a recorded
float32 magnitude stream through ``FileSource`` instead. Host numpy, as in the
reference.

Run: ``python -m futuresdr_tpu_torch.apps.adsb_rx [--file capture.f32]
[--ref-pos 52.25,3.92]``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from ..blocks import FileSource, VectorSource
from ..models.adsb import AdsbReceiver, modulate_frame
from ..models.adsb.decoder import crc24
from ..runtime import Flowgraph, Runtime

__all__ = ["synth_stream", "run", "main", "SYNTH_FRAMES"]

#: the synthesized stream's frames: hex strings, or the DF11 all-call's ICAO
SYNTH_FRAMES = ("8D4840D6202CC371C32CE0576098",      # KLM1023 ident
                "8D40621D58C382D690C8AC2863A7",      # position even
                "8D40621D58C386435CC412692AD6",      # position odd
                "8D485020994409940838175B284F",      # velocity
                0x4CA7E8,                            # all-call: acquire 4CA7E8
                "2000171806A983",                    # DF4 altitude (AP icao 4CA7E8)
                "2A00516D492B80")                    # DF5 squawk: foreign icao, gated


def _df11(icao: int) -> np.ndarray:
    """Parity-consistent DF11 all-call so the AP-overlay replies get through
    the tracker's acquisition gate."""
    head = np.zeros(32, dtype=np.uint8)
    head[0:5] = [0, 1, 0, 1, 1]
    head[8:32] = [(icao >> (23 - i)) & 1 for i in range(24)]
    rem = crc24(np.concatenate([head, np.zeros(24, np.uint8)]))
    return np.concatenate([head, np.array([(rem >> (23 - i)) & 1
                                           for i in range(24)], np.uint8)])


def synth_stream() -> np.ndarray:
    """The magnitude stream of ``SYNTH_FRAMES``, each after 1000 samples of
    seeded noise at 0.03."""
    rng = np.random.default_rng(0)
    parts = []
    for f in SYNTH_FRAMES:
        bits = (_df11(f) if isinstance(f, int) else
                np.unpackbits(np.frombuffer(bytes.fromhex(f), np.uint8)).astype(np.uint8))
        parts += [0.03 * rng.random(1000).astype(np.float32), modulate_frame(bits)]
    parts.append(0.03 * rng.random(500).astype(np.float32))
    return np.concatenate(parts)


def run(file: Optional[str] = None, ref_pos: Optional[tuple] = (52.25, 3.92)) -> tuple:
    """Receive the synthesized stream (or ``file``); returns ``(receiver,
    seconds)``: the ``AdsbReceiver`` with its frame count and tracker, and the
    seconds from the flowgraph's start to its end."""
    fg = Flowgraph()
    rx = AdsbReceiver(ref_pos=ref_pos)
    src = FileSource(file, np.float32) if file is not None else VectorSource(synth_stream())
    fg.connect_stream(src, "out", rx, "in")
    t0 = time.perf_counter()
    Runtime().run(fg)
    return rx, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--file", default=None, help="float32 magnitude stream @2 Msps")
    p.add_argument("--ref-pos", default="52.25,3.92",
                   help="receiver site lat,lon for single-message CPR "
                        "(empty string disables)")
    a = p.parse_args(argv)
    ref = tuple(float(v) for v in a.ref_pos.split(",")) if a.ref_pos else None
    if a.file is not None and not os.path.isfile(a.file):
        p.error(f"--file {a.file}: no such file")
    rx, _seconds = run(a.file, ref)
    print(f"decoded {rx.n_frames} frames; aircraft:")
    for ac in rx.tracker.aircraft.values():
        print(f"  {ac.icao:06X} callsign={ac.callsign} squawk={ac.squawk} "
              f"alt={ac.altitude_ft} pos=({ac.lat}, {ac.lon}) "
              f"gs={ac.ground_speed_kt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
