"""The host runtime: actor blocks over ring buffers, run by a scheduler.

A reduced copy of ``futuresdr_tpu/runtime`` that runs a linear chain of
stream blocks. Message ports and ``Pmt``, the control port, telemetry,
failure policies, device-chain fusion and the native buffers are later
slices (ROADMAP).
"""

from .flowgraph import ConnectError, Flowgraph
from .kernel import BlockMeta, Kernel
from .runtime import FlowgraphError, RunningFlowgraph, Runtime
from .scheduler import AsyncScheduler
from .tag import ItemTag, Tag
from .work_io import WorkIo

__all__ = ["Flowgraph", "ConnectError", "Kernel", "BlockMeta", "Runtime",
           "RunningFlowgraph", "FlowgraphError", "AsyncScheduler", "Tag",
           "ItemTag", "WorkIo"]
