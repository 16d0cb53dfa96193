"""The 95th percentile over the window's frames of the time from a frame's
hand-off to the program to its output being ready on the card: CUDA events,
one recorded on an idle stream at the hand-off and one behind the call on
its stream. The K frames of a dispatch share their dispatch's time."""

import numpy as np


def read(run):
    lat = run.window["latency_ms"]
    if not lat or not run.on_card:
        return None
    return float(np.percentile(np.repeat(lat, run.k), 95))
