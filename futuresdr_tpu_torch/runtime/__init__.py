"""The host runtime: actor blocks over stream buffers and message ports, run
by a scheduler.

A reduced copy of ``futuresdr_tpu/runtime``: stream and message ports, the
flowgraph handle, the REST control port, the double-mapped circular buffer
(the default) beside the pure-Python ring, and the ``Mocker`` harness. The
threaded schedulers, failure policies, telemetry, the circuit buffer and
device-chain fusion are later slices (ROADMAP).
"""

from .flowgraph import ConnectError, Flowgraph, default_buffer
from .kernel import BlockMeta, Kernel, message_handler
from .message_output import MessageOutputs
from .mocker import Mocker
from .runtime import (FlowgraphCancelled, FlowgraphError, FlowgraphHandle,
                      RunningFlowgraph, Runtime, RuntimeHandle)
from .scheduler import AsyncScheduler
from .tag import ItemTag, Tag
from .work_io import WorkIo

__all__ = ["Flowgraph", "ConnectError", "default_buffer", "Kernel", "BlockMeta",
           "message_handler", "MessageOutputs", "Mocker", "Runtime", "RuntimeHandle",
           "FlowgraphHandle", "RunningFlowgraph", "FlowgraphError",
           "FlowgraphCancelled", "AsyncScheduler", "Tag", "ItemTag", "WorkIo"]
