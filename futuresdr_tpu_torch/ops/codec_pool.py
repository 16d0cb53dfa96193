"""Codec worker pool: the host wire encode and decode off the block's thread.

The port's copy of ``futuresdr_tpu/ops/codec_pool.py``. A streamed kernel
runs its host codec on its one block thread unless this pool takes it: numpy
releases the interpreter lock on large-array operations, so two small pools
turn the H2D ∥ compute ∥ D2H overlap into

    encode(t+1) ∥ H2D(t) ∥ compute(t) ∥ D2H(t−1) ∥ decode(t−2)

Two separate lanes: a decode task waits for its D2H to land, so one shared
executor would let waiting decodes starve the encodes. Order is the
caller's: the kernel joins its futures oldest first.

The spans a task records (``encode``, ``decode``, the D2H it lands;
``telemetry/spans.py``) land in the worker's own ring, so the doctor's lane
unions attribute the host codec to the thread that paid it, and the
recorder prunes a retired worker's ring once it has been drained.

Each worker thread takes its creator's ``torch.get_num_threads()`` (OpenMP
keeps the count a thread, and a worker that runs a torch operation must
round as the creating thread does; the scheduler's threads do the same).

Config: ``host_codec_workers`` (default 2 a lane; 0 = no pool, the codec
runs inline on the block's thread).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from ..config import config
from ..log import logger

__all__ = ["CodecPool", "pool", "reset_pool"]

log = logger("ops.codec_pool")


class CodecPool:
    """One encode executor and one decode executor of ``workers`` threads
    each."""

    def __init__(self, workers: int):
        self.workers = int(workers)
        n = torch.get_num_threads()

        def init():
            torch.set_num_threads(n)

        self._enc = ThreadPoolExecutor(max_workers=self.workers,
                                       thread_name_prefix="fsdr-codec-enc", initializer=init)
        self._dec = ThreadPoolExecutor(max_workers=self.workers,
                                       thread_name_prefix="fsdr-codec-dec", initializer=init)

    def submit_encode(self, fn, *args) -> Future:
        return self._enc.submit(fn, *args)

    def submit_decode(self, fn, *args) -> Future:
        return self._dec.submit(fn, *args)

    def shutdown(self) -> None:
        self._enc.shutdown(wait=True)
        self._dec.shutdown(wait=True)


_pool: Optional[CodecPool] = None
_pool_disabled = False
_pool_lock = threading.Lock()


def pool() -> Optional[CodecPool]:
    """The process-global pool, or None when ``host_codec_workers`` is 0
    (callers run the codec inline)."""
    global _pool, _pool_disabled
    with _pool_lock:
        if _pool is None and not _pool_disabled:
            n = int(config().host_codec_workers)
            if n <= 0:
                _pool_disabled = True
                return None
            _pool = CodecPool(n)
            log.debug("codec pool: %d encode + %d decode worker(s)", n, n)
        return _pool


def reset_pool() -> None:
    """Shut down and drop the process pool (tests, config re-reads)."""
    global _pool, _pool_disabled
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown()
        _pool = None
        _pool_disabled = False
