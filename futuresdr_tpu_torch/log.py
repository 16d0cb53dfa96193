"""Logging: stdlib loggers under ``futuresdr_tpu_torch``, level from
``FUTURESDR_TPU_LOG``, else config ``log_level`` (default ``info``) — the
reference's ``log.py``."""

from __future__ import annotations

import logging
import os

from .config import config

__all__ = ["init", "logger"]

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL,
}

_ROOT = "futuresdr_tpu_torch"
_initialized = False


def init() -> None:
    """Give the package's root logger a stream handler (where it has none)
    and its level, once a process; :func:`logger` calls it."""
    global _initialized
    if _initialized:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s", datefmt="%H:%M:%S"))
        root.addHandler(h)
    level = os.environ.get("FUTURESDR_TPU_LOG", config().log_level).lower()
    root.setLevel(_LEVELS.get(level, logging.INFO))
    _initialized = True


def logger(name: str = "") -> logging.Logger:
    init()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
