"""The host runtime: actor blocks over stream buffers and message ports, run
by a scheduler.

A copy of ``futuresdr_tpu/runtime``: stream, in-place (host-frame circuit and
device frame) and message ports, the flowgraph handle, the REST control port,
the double-mapped circular buffer (the default) beside the pure-Python ring,
the schedulers (async, threaded, thread-per-block), the native fast chain
(``fastchain.py``) and device-graph fusion (``devchain.py``), the failure
policies (``block.py`` :class:`BlockPolicy`), the ``Mocker`` harness and the
custom-block prelude (``dev.py``).
"""

from .block import BlockPolicy, WrappedKernel
from .flowgraph import ConnectError, Flowgraph, default_buffer
from .kernel import BlockMeta, Kernel, message_handler
from .message_output import MessageOutputs
from .mocker import Mocker
from .runtime import (FlowgraphCancelled, FlowgraphError, FlowgraphHandle,
                      RunningFlowgraph, Runtime, RuntimeHandle)
from .scheduler import AsyncScheduler, Scheduler, ThreadedScheduler, TpbScheduler
from .tag import ItemTag, Tag
from .work_io import WorkIo

__all__ = ["BlockPolicy", "WrappedKernel", "Flowgraph", "ConnectError", "default_buffer",
           "Kernel", "BlockMeta", "message_handler", "MessageOutputs", "Mocker", "Runtime",
           "RuntimeHandle", "FlowgraphHandle", "RunningFlowgraph", "FlowgraphError",
           "FlowgraphCancelled", "Scheduler", "AsyncScheduler", "ThreadedScheduler",
           "TpbScheduler", "Tag", "ItemTag", "WorkIo"]
