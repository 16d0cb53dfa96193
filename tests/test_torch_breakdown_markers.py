"""The breakdown tool's table (``port_lanes.py``, ``KERNELS``): the source of
each kernel in it holds a marker (``#if``/``#ifdef FSDR_CUT_<PHASE>``) for
every phase its entry times alone, so that ``--breakdown`` can build each
phase alone with ``-DFSDR_CUT_<PHASE>``. These tests read the ``.cu`` text
only and need no ``nvcc``; the cut builds themselves are made on the card.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "futuresdr_tpu_torch" / "csrc"
_spec = importlib.util.spec_from_file_location("port_lanes", ROOT / "port_lanes.py")
port_lanes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(port_lanes)


@pytest.mark.parametrize("name", list(port_lanes.KERNELS))
def test_each_kernel_of_the_table_has_a_marker_for_each_phase(name):
    entry = port_lanes.KERNELS[name]
    text = (CSRC / f"{entry.source}.cu").read_text()
    assert port_lanes.missing_markers(text, entry.phases) == []


def test_the_table_holds_every_lane_kernel_the_tools_timed_and_their_phases():
    """``poly_fir`` (the one-stream calls and both lane walks), ``rotator_lanes``,
    ``pfb_lanes`` and ``quad_demod_lanes``, with the phases each is cut into."""
    phases = {k: v.phases for k, v in port_lanes.KERNELS.items()}
    assert phases == {"poly_fir": ("stage", "mac"), "rotator_lanes": (),
                      "pfb_lanes": ("stage", "mac", "idft", "store"),
                      "quad_demod_lanes": ("load", "math", "store")}
    assert port_lanes.QUAD_DEMOD_SHAPES == ((16, 8_000), (64, 8_000), (1, 128_000),
                                            (1, 1_024_000))


@pytest.mark.parametrize("phase", ["load", "math", "store"])
def test_a_missing_marker_is_found(phase):
    """A phase whose macro no preprocessor conditional tests is missing, also
    where the macro's name is left in a comment."""
    text = (CSRC / "quad_demod.cu").read_text()
    macro = port_lanes.marker(phase)
    gone = "\n".join(line.replace(macro, "FSDR_CUT_NONE") if line.lstrip().startswith("#")
                     else line for line in text.splitlines())
    assert macro in gone                                    # still in the comments
    assert port_lanes.missing_markers(gone, ("load", "math", "store")) == [phase]
