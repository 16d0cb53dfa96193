"""The frozen counts of the least work a frame, against numbers worked by
hand."""

from __future__ import annotations

import json

from sdrbench import peaks
from sdrbench.cost import spectrum_fused

from .conftest import ROOT


def _config(name):
    return json.loads((ROOT / f"sdrbench/configs/{name}.json").read_text())


def test_spectrum_frame_of_2_20():
    # 64 real taps on complex samples: 4·64 = 256 a sample; FFT 5·log2(2048)
    # = 55 a sample; |x|² 3 a sample: 314·2^20. Bytes 8n in, 4n out, 64 taps.
    ops, nbytes = spectrum_fused.frame(_config("spectrum_fused"), 2**20)
    assert ops == 314 * 2**20 == 329_252_864
    assert nbytes == 12 * 2**20 + 256 == 12_583_168
    # FLOP-bound: 329,252,864 / 67e12 s = 4.914 µs against 3.756 µs of bytes
    assert abs(peaks.least_seconds(ops, nbytes) - 4.9142218e-6) < 1e-12
