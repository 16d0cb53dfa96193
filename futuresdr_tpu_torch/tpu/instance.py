"""TpuInstance: the device broker of the port's compute plane.

The counterpart of ``futuresdr_tpu/tpu/instance.py``: owns the
:class:`torch.device` the stage programs run on and the frame-size /
in-flight-depth defaults from config. ``TpuInstance()`` means ``cuda:0`` and
raises when CUDA is absent; the CPU is used only when the caller passes
``device="cpu"``. There is no silent switch to the CPU.

A broker on ``cuda:d`` keeps everything it owns on card d: its copy streams
(:meth:`TpuInstance.copy_stream`, made on card d), the card it makes current
(:meth:`TpuInstance.card`) while a kernel or a graph capture runs, and so the
graph pools and pinned-buffer events of that work. :func:`instance` keeps one
broker a device.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

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

    def card(self):
        """A context making this broker's card the current one (nothing on
        the CPU): kernels, captures and events inside it belong to card d."""
        from ..parallel.mesh import on_device
        return on_device(self.device)

    def copy_stream(self, direction: str):
        """The broker's ``"h2d"`` or ``"d2h"`` copy stream, made on its card
        (``ops/xfer.py`` keeps one a device and direction)."""
        from ..ops.xfer import _copy_stream
        return _copy_stream(self.device, direction)


_instance: Optional[TpuInstance] = None
_instances: Dict[str, TpuInstance] = {}
_lock = threading.Lock()


def instance(device: Optional[Union[str, torch.device]] = None) -> TpuInstance:
    """The process's broker for ``device``, one a device; None is the
    default broker on ``cuda:0`` (raises without CUDA)."""
    global _instance
    with _lock:
        if device is None:
            if _instance is None:
                _instance = TpuInstance()
            return _instance
        key = str(torch.device(device))
        inst = _instances.get(key)
        if inst is None:
            inst = _instances[key] = TpuInstance(device)
        return inst


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as a :class:`torch.device`; None means the broker's card
    (:func:`instance`, which raises without CUDA)."""
    return instance().device if device is None else torch.device(device)
