"""Logging: stdlib loggers under ``futuresdr_tpu_torch``, level from
``FUTURESDR_TPU_LOG`` (default ``info``) — the reference's ``log.py``."""

from __future__ import annotations

import logging
import os

__all__ = ["logger"]

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


def _init() -> None:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s", datefmt="%H:%M:%S"))
        root.addHandler(h)
        level = os.environ.get("FUTURESDR_TPU_LOG", "info").lower()
        root.setLevel(_LEVELS.get(level, logging.INFO))


def logger(name: str = "") -> logging.Logger:
    _init()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
