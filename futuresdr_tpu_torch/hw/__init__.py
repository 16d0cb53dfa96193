"""Hardware abstraction layer — the `seify` crate equivalent.

A copy of ``futuresdr_tpu/hw/__init__.py``: the ``dummy`` and ``file``
drivers here, ``rtl_tcp`` in ``hw/rtl_tcp.py`` (imported on first use). The
reference's hardware blocks are generic over the external seify HAL
(RTL-SDR, HackRF, SoapySDR, Aaronia, dummy — ``src/blocks/seify/``). Here the HAL is a small driver registry;
the :class:`DummyDriver` plays the role of seify's ``driver=dummy`` (`tests/seify.rs:16-60`,
feature ``seify_dummy``): hardware-shaped tests with no hardware, producing a rate-limited
noise+tone IQ stream.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Dict, Optional, Type

import numpy as np

__all__ = ["Driver", "DummyDriver", "FileDriver", "Device", "register_driver",
           "parse_args"]


def parse_args(args: str) -> Dict[str, str]:
    """Parse 'driver=dummy,rate=1e6'-style device args (seify Args format)."""
    d: Dict[str, str] = {}
    for part in args.split(","):
        part = part.strip()
        if part:
            k, _, v = part.partition("=")
            d[k.strip()] = v.strip()
    return d


class Driver(ABC):
    """One hardware device: RX/TX streaming + tuning knobs."""

    def __init__(self, args: Dict[str, str]):
        self.args = args
        self.sample_rate = float(args.get("rate", 1e6))
        self.frequency = float(args.get("freq", 100e6))
        # None = "not set" (drivers fall back to AGC); 0.0 is a valid manual gain
        self.gain = float(args["gain"]) if "gain" in args else None

    # -- tuning ---------------------------------------------------------------
    def set_sample_rate(self, rate: float, channel: int = 0):
        self.sample_rate = float(rate)

    def set_frequency(self, freq: float, channel: int = 0):
        self.frequency = float(freq)

    def set_gain(self, gain: float, channel: int = 0):
        self.gain = float(gain)

    # -- streaming --------------------------------------------------------------
    @abstractmethod
    def activate_rx(self, channels=(0,)):
        ...

    @abstractmethod
    def read(self, n: int):
        """Blocking read of up to n complex64 samples (per activated channel).

        Returns an ndarray (possibly empty = no data yet) or ``None`` for
        end-of-stream (device gone) — the source block finishes on None."""

    def activate_tx(self, channels=(0,)):
        pass

    def write(self, samples: np.ndarray) -> int:
        return len(samples)

    def deactivate(self):
        pass


class DummyDriver(Driver):
    """Fake SDR: noise + a tone at 10% of the sample rate, wall-clock rate-limited."""

    def __init__(self, args: Dict[str, str]):
        super().__init__(args)
        self._t0: Optional[float] = None
        self._produced = 0
        self._phase = 0.0
        self._rng = np.random.default_rng(int(args.get("seed", 1)))
        self.tx_written = 0
        self.throttle = args.get("throttle", "true").lower() != "false"

    def activate_rx(self, channels=(0,)):
        self._t0 = None
        self._produced = 0

    def read(self, n: int) -> np.ndarray:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        if self.throttle:
            budget = int((now - self._t0) * self.sample_rate) - self._produced
            while budget <= 0:
                time.sleep(min(0.005, n / self.sample_rate))
                budget = int((time.monotonic() - self._t0) * self.sample_rate) - self._produced
            n = min(n, budget)
        inc = 2 * np.pi * 0.1
        ph = self._phase + inc * np.arange(n)
        self._phase = float((self._phase + inc * n) % (2 * np.pi))
        x = (np.exp(1j * ph) +
             0.1 * (self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n)))
        self._produced += n
        return x.astype(np.complex64)

    def activate_tx(self, channels=(0,)):
        self.tx_written = 0

    def write(self, samples: np.ndarray) -> int:
        self.tx_written += len(samples)
        return len(samples)


class FileDriver(Driver):
    """Replay a complex64 IQ recording as a device (`driver=file,path=...,repeat=true`),
    wall-clock throttled to the sample rate — the HAL-level file-trx analog."""

    def __init__(self, args: Dict[str, str]):
        super().__init__(args)
        self.path = args.get("path")
        if not self.path:
            raise ValueError("FileDriver needs path=<file>")
        self.repeat = args.get("repeat", "true").lower() != "false"
        self.throttle = args.get("throttle", "true").lower() != "false"
        self._f = None
        self._t0: Optional[float] = None
        self._produced = 0
        self.tx_written = 0

    def activate_rx(self, channels=(0,)):
        self._f = open(self.path, "rb")
        self._t0 = None
        self._produced = 0

    def read(self, n: int) -> np.ndarray:
        if self.throttle:
            now = time.monotonic()
            if self._t0 is None:
                self._t0 = now
            budget = int((now - self._t0) * self.sample_rate) - self._produced
            while budget <= 0:
                time.sleep(min(0.005, n / self.sample_rate))
                budget = int((time.monotonic() - self._t0) * self.sample_rate) \
                    - self._produced
            n = min(n, budget)
        data = self._f.read(n * 8)
        if len(data) < 8:
            if not self.repeat:
                # end-of-recording IS end-of-stream for a non-repeating
                # replay: the read contract reserves None for EOS — an empty
                # array means "no data yet" and would spin the source forever
                return None
            self._f.seek(0)
            data = self._f.read(n * 8)
        out = np.frombuffer(data[:(len(data) // 8) * 8], dtype=np.complex64)
        self._produced += len(out)
        return out

    def write(self, samples: np.ndarray) -> int:
        self.tx_written += len(samples)
        return len(samples)

    def deactivate(self):
        if self._f:
            self._f.close()
            self._f = None


_DRIVERS: Dict[str, Type[Driver]] = {"dummy": DummyDriver, "file": FileDriver}


def register_driver(name: str, cls: Type[Driver]) -> None:
    _DRIVERS[name] = cls


class Device:
    """Device factory from an args string (seify ``Device::from_args``)."""

    def __init__(self, args: str = "driver=dummy"):
        parsed = parse_args(args)
        name = parsed.get("driver", "dummy")
        if name not in _DRIVERS:
            # optional drivers live in sibling modules that register
            # themselves on import (hw/rtl_tcp.py)
            import importlib
            try:
                importlib.import_module(f".{name}", __package__)
            except ModuleNotFoundError as e:
                # only "no such driver module" is an unknown driver; a driver
                # module that fails to import raises its own error
                if e.name != f"{__package__}.{name}":
                    raise
        try:
            cls = _DRIVERS[name]
        except KeyError:
            raise ValueError(f"unknown driver {name!r}; registered: {list(_DRIVERS)}") from None
        self.driver = cls(parsed)
        self.driver_name = name
