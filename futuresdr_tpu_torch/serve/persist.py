"""Durable per-session carry snapshots for the serving plane.

The port's copy of ``futuresdr_tpu/serve/persist.py``, over the port's
``utils/snapshot.py``.

The :class:`SessionStore` extends the ``checkpoint_dir`` disk contract
(``utils/snapshot.py`` — atomic rename + CRC, signature-keyed filenames) to
per-slot serving carries: one file per session, keyed by session id plus
the app's pipeline-signature hash, so

* a restarted (VIRGIN) :class:`~futuresdr_tpu_torch.serve.engine.ServeEngine`
  incarnation re-admits every persisted session **bit-identically** through
  the ``carry_matches``-validated readmit path;
* a DIFFERENT pipeline under a reused app name never reads the other's
  snapshots (the signature-hash separation pinned for ``checkpoint_dir``
  holds here too);
* a corrupted or mismatched file is skipped **per session** — one torn
  write never blocks the other sessions' recovery;
* a cleanly closed session purges its file (complete state — a later
  incarnation must not resurrect it).

Writes ride the process-wide single-worker persistence executor
(:func:`~futuresdr_tpu_torch.utils.snapshot.persist_executor`) and COALESCE
through a per-session latest box, so a persistence cadence faster than the
disk skips intermediate snapshots instead of backlogging — ``step()`` never
stalls on a write. Metadata (tenant, frame cursors) rides next to the
leaves so a resumed session knows exactly how many frames its restored
carry has consumed.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Dict, List

import numpy as np

from ..log import logger
from ..utils import snapshot as _snapshot

__all__ = ["SessionStore"]

log = logger("serve.persist")


class SessionStore:
    """Disk store of per-session carry snapshots for ONE serving app."""

    def __init__(self, directory: str, app: str, pipeline):
        self._dir = os.path.expanduser(str(directory))
        self.app = str(app)
        self._safe_app = _snapshot.sanitize_name(self.app)
        #: pipeline-signature hash (stage names + in dtype, keyed by app):
        #: load_all only globs THIS signature, so a pipeline change under a
        #: reused app name orphans the old files instead of restoring them
        self.signature = _snapshot.snapshot_signature(pipeline, self.app)
        self._lock = threading.Lock()
        self._box: Dict[str, tuple] = {}   # sid -> (fetch, meta) newest wins
        self._queued = False

    # -- paths -----------------------------------------------------------------
    def path(self, sid: str) -> str:
        # sanitized name for readability PLUS a hash of the RAW sid:
        # sanitization is lossy ("t:1" and "t_1" both render "t_1"), and
        # sids are caller-supplied over REST — two live sessions must never
        # share a snapshot file last-writer-wins
        import hashlib
        safe = _snapshot.sanitize_name(sid)
        h = hashlib.sha1(str(sid).encode()).hexdigest()[:8]
        return os.path.join(
            self._dir,
            f"{self._safe_app}--{safe}.{h}-{self.signature}.sess.npz")

    def _glob(self) -> List[str]:
        return sorted(glob.glob(os.path.join(
            self._dir, f"{self._safe_app}--*-{self.signature}.sess.npz")))

    # -- writes (coalesced, off the step thread) -------------------------------
    def save(self, sid: str, fetch, meta: Dict[str, Any],
             sync: bool = False) -> None:
        """Queue one session snapshot. ``fetch`` is a zero-arg thunk yielding
        the host leaf list (materialized in the writer thread — the engine's
        stacked carries are never donated, so a captured reference stays
        readable); ``meta`` must carry ``sid``/``tenant``/``frames_out``.
        ``sync=True`` WAITS for the write to land — still via the ONE-worker
        executor: a second writer thread would share the pid-keyed tmp file
        with a queued background write of the same session and tear it
        (exactly the hazard the single-writer pool exists to prevent), and
        the box keeps newest-wins ordering either way."""
        with self._lock:
            self._box[sid] = (fetch, meta)
            queued = self._queued
            self._queued = True
        if not queued:
            _snapshot.persist_executor().submit(self._drain_box)
        if sync:
            self.flush()

    def _drain_box(self) -> None:
        while True:
            with self._lock:
                if not self._box:
                    self._queued = False
                    return
                sid, (fetch, meta) = self._box.popitem()
            self._write(sid, fetch, meta)

    def _write(self, sid: str, fetch, meta: Dict[str, Any]) -> None:
        try:
            leaves = [np.asarray(l) for l in fetch()]
        except Exception as e:                         # noqa: BLE001 — a lost
            log.warning("%s: session %s snapshot fetch failed (%r) — "
                        "skipped", self.app, sid, e)   # write never raises
            return
        seq = int(meta.get("frames_out", 0))
        if not _snapshot.write_snapshot(self.path(sid), seq, leaves, meta):
            log.warning("%s: session %s snapshot persist failed",
                        self.app, sid)

    def purge(self, sid: str) -> None:
        """Remove a session's snapshot (clean close / retire). Queued after
        any pending write of the same session, so a close during a persist
        cadence can never leave a resurrected file behind."""
        with self._lock:
            self._box.pop(sid, None)
        path = self.path(sid)

        def unlink():
            try:
                os.unlink(path)
            except OSError:
                pass

        _snapshot.persist_executor().submit(unlink)

    def flush(self) -> None:
        """Barrier: every snapshot queued before this call is on disk after
        it (the one-worker executor is FIFO)."""
        _snapshot.persist_executor().submit(lambda: None).result()

    # -- restore ---------------------------------------------------------------
    def load_all(self) -> List[dict]:
        """Every readable persisted session of this app+signature:
        ``{"sid", "tenant", "frames_in", "frames_out", "leaves", "path"}``.
        Corrupted/unreadable files are skipped per-session (logged by the
        snapshot reader); files whose metadata is absent fall back to the
        filename-derived sid with a default tenant."""
        out: List[dict] = []
        for path in self._glob():
            got = _snapshot.read_snapshot(path)
            if got is None:
                continue
            seq, leaves, meta = got
            meta = meta or {}
            sid = str(meta.get("sid") or "")
            if not sid:
                # filename fallback (metadata is CRC-protected and always
                # written by the engine, so this is belt-and-braces): strip
                # the signature and the trailing ".<8-hex raw-sid hash>"
                stem = os.path.basename(path).split("--", 1)[-1] \
                    .rsplit("-", 1)[0]
                head, _, tail = stem.rpartition(".")
                sid = head if head and len(tail) == 8 else stem
            out.append({
                "sid": sid,
                "tenant": str(meta.get("tenant", "default")),
                "frames_in": int(meta.get("frames_in", seq)),
                "frames_out": int(meta.get("frames_out", seq)),
                "leaves": leaves,
                "path": path,
            })
        return out
