"""The output check's control and faults, at sizes the CPU holds: the
control (the reference with TF32 operands in its FIR) has to come out not
correct, and so has a run with its timed path broken underneath in each way
the cell can be: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced."""

from __future__ import annotations

import pytest
import torch

from sdrbench import control, run

from .conftest import TINY

torch.set_num_threads(1)


def test_control_fails_the_check():
    out = control.readings("spectrum.capture", [2**31 + 1, 6], 0.3,
                           device=torch.device("cpu"), overrides=TINY)
    for name, s in out["summary"].items():
        assert s["lower"] <= s["limit"] < s["upper"], (name, s)


def _state_unchanged(fn):
    def call(carry, x):
        return carry, fn(carry, x)[1]
    return call


def _half_left_out(fn):
    def call(carry, x):
        carry, y = fn(carry, x)
        y = y.clone()
        rows = y.reshape(y.shape[0], -1) if y.dim() > 1 else y.reshape(2, -1)
        rows[rows.shape[0] // 2:] = 0
        return carry, y
    return call


def _answer_altered(fn):
    """The largest power of each dispatch 1% off."""
    def call(carry, x):
        carry, y = fn(carry, x)
        y = y.clone()
        flat = y.reshape(-1)
        i = int(flat.abs().argmax())
        flat[i] = flat[i] * 1.01
        return carry, y
    return call


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    res = run.run_cell(run.ROOT, "spectrum.capture", 4242, 0.3, False,
                       device=torch.device("cpu"), overrides=TINY, wrap=fault)
    assert res["correct"] is False, res["checks"]
