"""Prelude for custom-block authors (a copy of ``futuresdr_tpu/runtime/dev.py``;
reference: ``src/runtime/dev.rs`` ``dev::prelude``).

``from futuresdr_tpu_torch.runtime.dev import *`` brings in everything a block
implementation needs: the kernel base, ports, WorkIo, tags, Pmt, and the
message-handler decorator.
"""

from ..types import Pmt, PmtKind, PortId
from .buffer import BufferReader, BufferWriter, StreamInput, StreamOutput
from .buffer.circuit import Circuit, InplaceInput, InplaceOutput
from .kernel import BlockMeta, Kernel, message_handler
from .message_output import MessageOutputs
from .tag import ItemTag, Tag
from .work_io import WorkIo

__all__ = [
    "Pmt", "PmtKind", "PortId",
    "BufferReader", "BufferWriter", "StreamInput", "StreamOutput",
    "Circuit", "InplaceInput", "InplaceOutput",
    "BlockMeta", "Kernel", "message_handler",
    "MessageOutputs", "ItemTag", "Tag", "WorkIo",
]
