"""Remote control client (the ``futuresdr-remote`` crate equivalent); a copy
of ``futuresdr_tpu/ctrl/`` on the standard library."""

from .remote import Connection, Remote, RemoteBlock, RemoteError, RemoteFlowgraph

__all__ = ["Connection", "Remote", "RemoteBlock", "RemoteError", "RemoteFlowgraph"]
