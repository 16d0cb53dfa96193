"""The plain reference against the port on the CPU, at tiny frames, with
the carry chained across the capture's wrap; and the references' own
independence from the program."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch

from sdrbench import capture, run
from sdrbench.reference import _dsp, spectrum_fused

from .conftest import ROOT, TINY

torch.set_num_threads(1)


def test_port_matches_reference_across_wrap():
    res = run.run_cell(ROOT, "spectrum.capture", 2**31 + 5, 0.3, False,
                       device=torch.device("cpu"), overrides=TINY)
    assert res["attempted"] > 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert res["correct"] is True


def test_spectrum_reference_is_the_definition():
    """One block by hand: numpy's convolution, FFT and |X|²."""
    cfg = json.loads((ROOT / "sdrbench/configs/spectrum_fused.json").read_text())
    cap = capture.make(cfg["capture"], 9, "cpu", samples=8192)
    got = spectrum_fused.expected(cap, cfg, 2048, 2048).numpy()
    h = _dsp.design(cfg["chain"]["fir"])
    x = cap.numpy().astype(np.complex128)
    u = np.convolve(x, h)[2048:4096]
    want = np.abs(np.fft.fft(u)) ** 2
    assert np.allclose(got, want, rtol=1e-9, atol=1e-9 * want.max())


def _weak_bins_up(want, cfg, cap):
    """Every bin 60 dB or more under its block's peak 50% up."""
    p = want.clone().reshape(-1, 2048)
    weak = p < 1e-6 * p.amax(1, keepdim=True)
    p[weak] *= 1.5
    return p.reshape(-1)


def _other_stopband(want, cfg, cap):
    """The lowpass designed with 62 taps instead of 64."""
    other = json.loads(json.dumps(cfg))
    other["chain"]["fir"]["n_taps"] = 62
    return spectrum_fused.expected(cap, other, 8192, 16384)


def _tf32(want, cfg, cap):
    return spectrum_fused.expected(cap, cfg, 8192, 16384, precision="tf32")


@pytest.mark.parametrize("seed", [11, 2**31 + 9])
@pytest.mark.parametrize("fault", [_weak_bins_up, _other_stopband, _tf32])
def test_the_numbers_read_the_weak_bins(fault, seed):
    """A fault that leaves the strong bins as they are and moves the weak
    ones (the noise floor, the stopband) fails a limit."""
    cfg = json.loads((ROOT / "sdrbench/configs/spectrum_fused.json").read_text())
    cap = capture.make(cfg["capture"], seed, "cpu", samples=32768)
    want = spectrum_fused.expected(cap, cfg, 8192, 16384)
    numbers = spectrum_fused.compare([(fault(want, cfg, cap), want)], cfg)
    assert any(numbers[k] > v for k, v in spectrum_fused.LIMITS.items()), numbers


def test_tap_design_agrees_with_the_ports():
    """Designed apart, the reference's taps equal the port's firdes."""
    from futuresdr_tpu_torch.dsp import firdes
    spec = {"design": "hamming_lowpass", "cutoff": 0.2, "n_taps": 64}
    assert np.allclose(_dsp.design(spec), firdes.lowpass(0.2, 64), rtol=0, atol=1e-15)


def test_references_import_nothing_of_the_program():
    for path in sorted((ROOT / "sdrbench/reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {name.split(".")[0] for name in names}
        assert not tops & {"futuresdr_tpu_torch", "futuresdr_tpu", "jax", "jaxlib", "flax"}, path
