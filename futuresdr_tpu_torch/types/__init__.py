"""Value types shared between the runtime, blocks, and external clients.

A copy of ``futuresdr_tpu/types`` (numpy only): the message-plane value
``Pmt``, port ids and the descriptions the control port serves.
"""

from .pmt import Pmt, PmtKind, PmtConversionError
from .ids import BlockId, FlowgraphId, PortId
from .description import BlockDescription, FlowgraphDescription

__all__ = [
    "Pmt",
    "PmtKind",
    "PmtConversionError",
    "BlockId",
    "FlowgraphId",
    "PortId",
    "BlockDescription",
    "FlowgraphDescription",
]
