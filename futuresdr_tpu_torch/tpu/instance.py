"""TpuInstance: the device broker of the port's compute plane.

The counterpart of ``futuresdr_tpu/tpu/instance.py``: owns the
:class:`torch.device` the stage programs run on and the frame-size /
in-flight-depth defaults from config. ``TpuInstance()`` means ``cuda:0`` and
raises when CUDA is absent; the CPU is used only when the caller passes
``device="cpu"``. There is no silent switch to the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from ..config import config
from ..log import logger

__all__ = ["TpuInstance", "instance", "resolve_device"]

log = logger("tpu.instance")


class TpuInstance:
    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TpuInstance: no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the CPU")
            device = "cuda:0"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.frame_size = config().tpu_frame_size
        self.frames_in_flight = config().tpu_frames_in_flight
        log.info("TpuInstance on %s (frame=%d, in-flight=%d)",
                 self.device, self.frame_size, self.frames_in_flight)


_instance: Optional[TpuInstance] = None
_lock = threading.Lock()


def instance() -> TpuInstance:
    """Process-global default broker on ``cuda:0`` (raises without CUDA)."""
    global _instance
    with _lock:
        if _instance is None:
            _instance = TpuInstance()
        return _instance


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as a :class:`torch.device`; None means the broker's card
    (:func:`instance`, which raises without CUDA)."""
    return instance().device if device is None else torch.device(device)
