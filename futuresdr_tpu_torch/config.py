"""Global configuration: the fields this package reads.

A reduced copy of ``futuresdr_tpu/config.py``: defaults, then a
``FUTURESDR_TPU_<FIELD>`` environment variable per field (the reference's
env layer; its TOML layers are not carried over).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields
from typing import Optional

__all__ = ["Config", "config"]

_ENV_PREFIX = "FUTURESDR_TPU_"


@dataclass
class Config:
    buffer_size: int = 262144              # stream buffer size in bytes
    tpu_frame_size: int = 1 << 18          # samples per device frame
    tpu_frames_in_flight: int = 4          # frames staged or computing at once

    @classmethod
    def from_env(cls) -> "Config":
        c = cls()
        for f in fields(cls):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is not None:
                setattr(c, f.name, int(raw))
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
