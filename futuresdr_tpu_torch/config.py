"""Global configuration: the fields this package reads.

A reduced copy of ``futuresdr_tpu/config.py``: defaults, then a
``FUTURESDR_TPU_<FIELD>`` environment variable per field (the reference's
env layer; its TOML layers are not carried over), parsed by the field's
type, e.g. ``FUTURESDR_TPU_TPU_FRAMES_PER_DISPATCH=4``,
``FUTURESDR_TPU_CTRLPORT_ENABLE=true`` or
``FUTURESDR_TPU_CTRLPORT_BIND=127.0.0.1:0``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields
from typing import Optional

__all__ = ["Config", "config"]

_ENV_PREFIX = "FUTURESDR_TPU_"


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _parse(name: str, default, raw: str):
    """``raw`` as the type of the field's default."""
    if isinstance(default, bool):
        v = raw.strip().lower()
        if v not in _TRUE + _FALSE:
            raise ValueError(f"{_ENV_PREFIX}{name.upper()}={raw!r} is not a boolean")
        return v in _TRUE
    if isinstance(default, int):
        return int(raw)
    return raw


@dataclass
class Config:
    queue_size: int = 8192                 # message inbox capacity (try_send
    #   drops past it, send_async waits for room)
    buffer_size: int = 262144              # stream buffer size in bytes
    ctrlport_enable: bool = False          # Runtime() starts the REST control port
    ctrlport_bind: str = "127.0.0.1:1337"  # its address; port 0 takes a free port
    tpu_frame_size: int = 1 << 18          # samples per device frame
    tpu_frames_in_flight: int = 4          # dispatch groups staged or computing at once
    tpu_frames_per_dispatch: int = 0       # megabatch K: frames run through one
    #   compiled replay per dispatch (per-dispatch host cost paid once per K
    #   frames); 0 = 1 here (the autotuned pick is not ported)
    tpu_inflight: int = 0                  # in-flight credit budget: 0 = an
    #   adaptive credit controller (tpu/kernel_block.py CreditController)
    #   seeded from tpu_frames_in_flight; N > 0 pins the budget (as does an
    #   explicit per-kernel frames_in_flight)
    host_arena: int = 1                    # recycled pinned staging buffers
    #   (ops/arena.py); 0 = a fresh pinned buffer per transfer
    host_arena_mb: int = 256               # arena pool byte cap: past it a
    #   released buffer is dropped to the allocator instead of pooled

    @classmethod
    def from_env(cls) -> "Config":
        c = cls()
        for f in fields(cls):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is not None:
                setattr(c, f.name, _parse(f.name, f.default, raw))
        return c


_config: Optional[Config] = None
_lock = threading.Lock()


def config() -> Config:
    """The process configuration, read from the environment on first use."""
    global _config
    with _lock:
        if _config is None:
            _config = Config.from_env()
        return _config
