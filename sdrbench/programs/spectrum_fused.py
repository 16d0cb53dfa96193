"""The north-star spectrum chain on the port's fast path:
``fir_fft_stage(taps, n_fft)`` (the hand ``fir_fft`` kernel) then
``mag2_stage()``."""

from __future__ import annotations

import numpy as np


def stages(config: dict):
    """``(stages, input dtype)``."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import fir_fft_stage, mag2_stage
    f = config["chain"]["fir"]
    taps = firdes.lowpass(f["cutoff"], f["n_taps"])
    return [fir_fft_stage(taps, config["chain"]["n_fft"]), mag2_stage()], np.complex64
